"""Fused input normalize: the CUDA kernel (``csrc/preprocess.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``yolov7_d2_tpu/ops/pallas_preprocess.py:
_normalize_kernel`` (``fused_normalize``); the values are those of its
plain twin ``reference_normalize``. The output is ``[B, 3, H, W]`` in the
model's layout, channels_last (NHWC memory).
``normalize_images`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch

from yolov7_d2_tpu_torch.kernels import build

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_PIXELS_A_THREAD = 16  # csrc/preprocess.cu kPix


def normalize_images_plain(
    images: torch.Tensor, mean: Sequence[float], std: Sequence[float],
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> (x - mean[c]) / std[c] as ``out_dtype``
    channels_last [B, 3, H, W], f32 arithmetic and one rounding to
    ``out_dtype``."""
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    x = ((images.to(torch.float32) - m) / s).to(out_dtype)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def normalize_images(
    images: torch.Tensor, mean: Sequence[float], std: Sequence[float],
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Same contract as :func:`normalize_images_plain`; one kernel launch
    on a CUDA tensor."""
    if images.device.type == "cpu":
        return normalize_images_plain(images, mean, std, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"normalize_images: images on {images.device}")
    if images.dtype != torch.uint8:
        raise TypeError(f"normalize_images: uint8 input, got {images.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"normalize_images: out_dtype {out_dtype}")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"normalize_images: [B, H, W, 3], got "
                         f"{tuple(images.shape)}")
    if not images.is_contiguous() or images.data_ptr() % 16:
        raise ValueError("normalize_images: input must be contiguous and "
                         "16-byte aligned")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("normalize_images: 3 means and 3 stds")
    b, h, w, _ = images.shape
    if b * h * w == 0 or (b * h * w) % _PIXELS_A_THREAD:
        raise ValueError(f"normalize_images: B*H*W = {b * h * w} must be a "
                         f"positive multiple of {_PIXELS_A_THREAD}")
    lib = build.load_library()
    out = torch.empty((b, 3, h, w), dtype=out_dtype, device=images.device,
                      memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = lib.yolo_normalize_launch(
        images.data_ptr(), out.data_ptr(), b * h * w,
        int(out_dtype == torch.bfloat16),
        *(float(v) for v in mean), *(float(v) for v in std), stream)
    build.check(err, "normalize")
    build.LAUNCHES["normalize"] += 1
    return out
