"""ctypes binding of the port's host letterbox (``native/preprocess.cc``),
the counterpart of ``yolov7_d2_tpu/native/__init__.py``.

The library is compiled at first use by the host C++ compiler (``$CXX``,
else ``g++``) with the JAX package's flags (its ``native/Makefile``), into
``build/native/`` at the repository root, named by a hash of the source and
the command; never beside the sources. Where it does not build,
``load_library`` returns None and the mappers take the cv2 letterbox, as
the JAX package's do; ``BUILD_ERROR`` then says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "preprocess.cc"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
            "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
BUILD_ERROR: Optional[str] = None


def _build() -> Path:
    cmd = (os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared")
    digest = hashlib.sha256(" ".join(cmd).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libyolo_preprocess_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = Path(tmp) / out.name
            subprocess.run([*cmd, "-o", str(lib), str(SOURCE)], check=True,
                           capture_output=True, text=True, timeout=300)
            os.replace(lib, out)
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The built library, building it on the first call; None where it
    does not build."""
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(_build()))
            except (OSError, subprocess.SubprocessError) as e:
                BUILD_ERROR = f"{type(e).__name__}: " + (
                    getattr(e, "stderr", None) or str(e))[-2000:]
            else:
                lib.letterbox_u8.restype = ctypes.c_float
                lib.letterbox_u8.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
                ]
                lib.letterbox_batch_u8.restype = None
                lib.letterbox_batch_u8.argtypes = [
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                    ctypes.c_int, ctypes.c_uint8,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ]
                _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def letterbox_u8(
    img: np.ndarray, size: Tuple[int, int], pad_value: int = 114
) -> Tuple[np.ndarray, float]:
    """Native letterbox of one HWC uint8 image to (th, tw)."""
    lib = load_library()
    assert lib is not None, "native library unavailable"
    img = np.ascontiguousarray(img, np.uint8)
    th, tw = size
    out = np.empty((th, tw, 3), np.uint8)
    scale = lib.letterbox_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        th, tw, pad_value,
    )
    return out, float(scale)


def letterbox_batch_u8(
    images, size: Tuple[int, int], pad_value: int = 114,
    num_threads: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native letterbox of a list of HWC uint8 images on ``num_threads``
    host threads -> ([N, th, tw, 3] uint8, the scales [N] float32)."""
    lib = load_library()
    assert lib is not None, "native library unavailable"
    n = len(images)
    th, tw = size
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[im.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for im in images]
    )
    shapes = np.asarray(
        [[im.shape[0], im.shape[1]] for im in images], np.int32
    ).ravel()
    out = np.empty((n, th, tw, 3), np.uint8)
    scales = np.empty((n,), np.float32)
    lib.letterbox_batch_u8(
        ptrs,
        shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        th, tw, pad_value,
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    return out, scales
