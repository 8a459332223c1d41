"""Box IoU (JAX ``ops/iou.py:19-40``), used by the plain NMS.

The operations and their order are those of the JAX functions, one rounding
each, so that the plain NMS and the NMS kernel take the same decisions at
the threshold.
"""

from __future__ import annotations

import torch

EPS = 1e-9


def elementwise_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of aligned xyxy boxes ``a[..., 4]`` and ``b[..., 4]``."""
    ax0, ay0, ax1, ay1 = a.unbind(-1)
    bx0, by0, bx1, by1 = b.unbind(-1)
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp(min=0.0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp(min=0.0)
    inter = iw * ih
    area_a = (ax1 - ax0).clamp(min=0.0) * (ay1 - ay0).clamp(min=0.0)
    area_b = (bx1 - bx0).clamp(min=0.0) * (by1 - by0).clamp(min=0.0)
    return inter / (area_a + area_b - inter + EPS)


def pairwise_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N, 4] x b [..., M, 4] -> [..., N, M]."""
    return elementwise_box_iou(a[..., :, None, :], b[..., None, :, :])
