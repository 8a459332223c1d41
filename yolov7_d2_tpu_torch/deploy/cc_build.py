"""Build the native serving client (``deploy/cc/aoti_infer.cpp`` with the
op of ``deploy/cc/nms_op.cpp``), the counterpart of the JAX package's
``deploy/cc/Makefile``.

``build_client(device)`` compiles the ``.cpp`` files with the host C++
compiler (``$CXX``, else ``g++``) against the installed torch's headers,
with its C++ standard and ABI, and for ``device="cuda"`` also
``csrc/nms.cu`` with ``nvcc`` and ``kernels/build.NVCC_FLAGS``, all at
once, then links them with torch's libraries (``--no-as-needed``, so that
the CUDA runner and dispatch keys of ``libtorch_cuda`` register, and an
rpath to ``torch/lib``). The program goes into
``build/native/<hash of the sources and the commands>/aoti_infer`` at the
repository root, at first use; nothing runs at import time.
``device="cpu"`` builds the client without the op's CUDA body, which the
CPU tests use; ``device="cuda"`` without ``nvcc`` raises.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
from pathlib import Path
from typing import Dict

from yolov7_d2_tpu_torch.kernels import build as kbuild

CC_DIR = Path(__file__).resolve().parent / "cc"
BUILD_DIR = kbuild.BUILD_DIR.parent / "native"
CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-Wno-unused-variable")
EXE = "aoti_infer"

BUILD_SECONDS: Dict[str, float] = {}  # device -> wall time of its build


def _torch_paths():
    """(include dirs, library dir, C++ standard flag, ABI define) of the
    installed torch."""
    import torch

    root = Path(torch.__file__).resolve().parent
    includes = [root / "include", root / "include" / "torch" / "csrc" / "api"
                / "include"]
    # the standard torch's own extension builder compiles with
    ext = (root / "utils" / "cpp_extension.py").read_text()
    std = "-std=c++20" if "-std=c++20" in ext else "-std=c++17"
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    return includes, root / "lib", std, abi


def _cuda_home() -> Path:
    return Path(kbuild._nvcc()).resolve().parent.parent


def _commands(device: str, out: Path, tmp: Path):
    """(compile commands, link command) of the client for ``device``,
    objects under ``tmp``, the program at ``out``."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"build_client: device {device!r}: cuda or cpu")
    includes, libdir, std, abi = _torch_paths()
    cxx = os.environ.get("CXX", "g++")
    flags = [*CXXFLAGS, std, abi, *(f"-I{p}" for p in includes)]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    extra_objs, extra_libs, compile_cmds = [], [], []
    if device == "cuda":
        cuda = _cuda_home()
        flags += ["-DYOLO_CC_CUDA", f"-I{cuda / 'include'}"]
        libs += ["-ltorch_cuda", "-lc10_cuda"]
        nms = kbuild.SOURCE_DIR / "nms.cu"
        obj = tmp / "nms.o"
        compile_cmds.append([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-c",
                             str(nms), "-o", str(obj)])
        extra_objs.append(str(obj))
        # the kernel's runtime, static as nvcc links it into the kernels'
        # library
        extra_libs += [f"-L{cuda / 'lib64'}", "-lcudart_static", "-ldl",
                       "-lrt", "-lpthread"]
    objs = []
    for src in sorted(CC_DIR.glob("*.cpp")):
        obj = tmp / f"{src.stem}.o"
        compile_cmds.append([cxx, *flags, "-c", str(src), "-o", str(obj)])
        objs.append(str(obj))
    link = [cxx, "-o", str(out), *objs, *extra_objs, f"-L{libdir}",
            "-Wl,--no-as-needed", *libs, "-Wl,--as-needed",
            f"-Wl,-rpath,{libdir}", *extra_libs]
    return compile_cmds, link


def _digest(device: str) -> str:
    compile_cmds, link = _commands(device, Path("OUT"), Path("TMP"))
    h = hashlib.sha256(repr((compile_cmds, link)).encode())
    sources = sorted([*CC_DIR.glob("*.cpp"), *CC_DIR.glob("*.h")])
    if device == "cuda":
        sources.append(kbuild.SOURCE_DIR / "nms.cu")
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_client(device: str = "cuda") -> Path:
    """The client's path, building it first if needed (``BUILD_SECONDS``
    records the build's wall time)."""
    out = BUILD_DIR / _digest(device) / EXE
    if not out.exists():
        t0 = time.perf_counter()
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            tmp = Path(tmp)
            compile_cmds, link = _commands(device, tmp / EXE, tmp)
            kbuild._run_all(compile_cmds)
            kbuild._run_all([link])
            os.replace(tmp / EXE, out)
        BUILD_SECONDS[device] = time.perf_counter() - t0
    return out


def client_env() -> Dict[str, str]:
    """The environment to run the client in: ``TMPDIR`` under ``build/``,
    where libtorch's package loader unpacks a package while it runs."""
    tmp = BUILD_DIR / "tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    return {**os.environ, "TMPDIR": str(tmp)}
