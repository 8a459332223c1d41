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
import contextlib
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


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
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


def _build(sources, flags, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        _run_all([[nvcc, *flags, "-c", str(src), "-o", obj]
                  for src, obj in zip(sources, objs)])
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)


def build_library(sources, extra_flags=()) -> tuple[ctypes.CDLL, bool]:
    """Load the library of ``sources`` (paths of ``.cu`` files with the
    port's C entry points) built with ``extra_flags`` after the usual ones,
    building it first if needed; the flag says whether it was built."""
    flags = (*NVCC_FLAGS, *extra_flags)
    out = BUILD_DIR / f"libyolo_kernels_{_digest(sources, flags)}.so"
    built = not out.exists()
    if built:
        _build(sources, flags, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib, built


def load_library() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed."""
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            _lib, built = build_library(_sources())
            if built:
                BUILD_SECONDS = time.perf_counter() - t0
        return _lib


@contextlib.contextmanager
def use_library(lib: ctypes.CDLL):
    """Inside the block the wrappers launch the kernels of ``lib`` (another
    build, e.g. of an earlier commit's sources, timed beside this one)."""
    global _lib
    with _lock:
        before, _lib = _lib, lib
    try:
        yield lib
    finally:
        with _lock:
            _lib = before


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
