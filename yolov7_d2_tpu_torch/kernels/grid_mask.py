"""GridMask: the CUDA kernel (``csrc/grid_mask.cu``) and its plain PyTorch
version.

Replaces the TPU kernel ``yolov7_d2_tpu/ops/pallas_preprocess.py:
_grid_mask_kernel`` (``pallas_grid_mask``). Per image b with int32
parameters ``params[b] = (d, keep, off_y, off_x, mode)``:

    drop = ((y + off_y) % d < d - keep) | ((x + off_x) % d < d - keep)
    mask = mode == 1 ? ~drop : drop
    out  = mask ? 0 : images

over ``[B, H, W, C]`` NHWC images, float32 or uint8, with ``d >= 1``.
``grid_mask`` launches the kernel for a CUDA tensor and takes the plain
version only for a CPU tensor. The output is a new tensor.
"""

from __future__ import annotations

import torch

from yolov7_d2_tpu_torch.kernels import build

_DTYPES = (torch.float32, torch.uint8)
_CHUNK_BYTES = 16  # csrc/grid_mask.cu kBytes


def grid_mask_plain(images: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C], params int [B, 5] -> images with the GridMask
    of each image zeroed."""
    _, h, w, _ = images.shape
    d, keep, off_y, off_x, mode = params.to(torch.int64).unbind(-1)  # [B]
    band = (d - keep)[:, None]
    ys = torch.arange(h, device=images.device)[None, :]
    xs = torch.arange(w, device=images.device)[None, :]
    drop_y = (ys + off_y[:, None]) % d[:, None] < band     # [B, H]
    drop_x = (xs + off_x[:, None]) % d[:, None] < band     # [B, W]
    drop = drop_y[:, :, None] | drop_x[:, None, :]         # [B, H, W]
    mask = torch.where((mode == 1)[:, None, None], ~drop, drop)
    return images.masked_fill(mask[..., None], 0)


def grid_mask(images: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`grid_mask_plain`; one kernel launch for the
    batch on a CUDA tensor."""
    if images.device.type == "cpu" and params.device.type == "cpu":
        return grid_mask_plain(images, params)
    if images.device.type != "cuda" or params.device != images.device:
        raise ValueError(f"grid_mask: images on {images.device}, params on "
                         f"{params.device}")
    if images.dtype not in _DTYPES:
        raise TypeError(f"grid_mask: float32 or uint8 images, got "
                        f"{images.dtype}")
    if params.dtype != torch.int32:
        raise TypeError(f"grid_mask: int32 params, got {params.dtype}")
    if images.dim() != 4 or params.shape != (images.shape[0], 5):
        raise ValueError(f"grid_mask: images [B, H, W, C] and params [B, 5], "
                         f"got {tuple(images.shape)}, {tuple(params.shape)}")
    if not (images.is_contiguous() and params.is_contiguous()) \
            or images.data_ptr() % _CHUNK_BYTES:
        raise ValueError("grid_mask: inputs must be contiguous, the images "
                         "16-byte aligned")
    b, h, w, c = images.shape
    image_bytes = h * w * c * images.element_size()
    if not 0 < b <= 65535 or image_bytes == 0 \
            or image_bytes % _CHUNK_BYTES or image_bytes >= 2 ** 31:
        raise ValueError(f"grid_mask: B = {b} must be 1..65535 and an "
                         f"image's {image_bytes} bytes a positive multiple "
                         f"of {_CHUNK_BYTES} below 2^31")
    lib = build.load_library()
    out = torch.empty_like(images)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = lib.yolo_grid_mask_launch(
        images.data_ptr(), out.data_ptr(), params.data_ptr(), b, h, w, c,
        images.element_size(), stream)
    build.check(err, "grid_mask")
    build.LAUNCHES["grid_mask"] += 1
    return out
