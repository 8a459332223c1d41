"""Build and load the port's CUDA kernels, and count their launches.

All sources under ``yolov7_d2_tpu_torch/csrc/*.cu`` are compiled by ``nvcc``,
one process a source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``build/kernels/`` at the repository root, named by
a hash of the sources and flags, so that it is rebuilt when either changes.
Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # no contraction into FMA anywhere: the kernels round every step as
    # their plain PyTorch versions do (the NMS also says so explicitly)
    "-fmad=false",
)

# Launches of each kernel, counted by its wrapper where it launches it.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of the nvcc calls, when this process built


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.yolo_nms_launch.argtypes = [p, p, p, p, i, i, f, i, p]
    lib.yolo_nms_launch.restype = i
    lib.yolo_normalize_launch.argtypes = [p, p, i64, i, f, f, f, f, f, f, p]
    lib.yolo_normalize_launch.restype = i
    lib.yolo_grid_mask_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.yolo_grid_mask_launch.restype = i


def _run_all(cmds) -> None:
    """Run the commands at once and wait for every one; raise on the first
    that failed, once all have ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = [proc.communicate()[1] for proc in procs]
    for cmd, proc, err in zip(cmds, procs, errors):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")


def _build(sources, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                  for src, obj in zip(sources, objs)])
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)


def load_library() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed."""
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out = BUILD_DIR / f"libyolo_kernels_{_digest(sources)}.so"
        if not out.exists():
            t0 = time.perf_counter()
            _build(sources, out)
            BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
