"""Box IoU and the YOLOX IoU loss (JAX ``ops/iou.py:19-40, 76-157``).

The operations and their order are those of the JAX functions, one rounding
each, so that the plain NMS and the NMS kernel take the same decisions at
the threshold, and SimOTA and the losses see the JAX package's values.
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


def _iou_terms(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """IoU of aligned xyxy boxes as the JAX ``_iou_terms`` computes it:
    unlike :func:`elementwise_box_iou`, the areas are not clamped. (The
    enclosing box and centre terms of the other loss types come with the
    families that use them.)"""
    px0, py0, px1, py1 = pred.unbind(-1)
    tx0, ty0, tx1, ty1 = target.unbind(-1)
    iw = (torch.minimum(px1, tx1) - torch.maximum(px0, tx0)).clamp(min=0.0)
    ih = (torch.minimum(py1, ty1) - torch.maximum(py0, ty0)).clamp(min=0.0)
    inter = iw * ih
    pw, ph = px1 - px0, py1 - py0
    tw, th = tx1 - tx0, ty1 - ty0
    union = pw * ph + tw * th - inter + EPS
    return inter / union


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "iou") -> torch.Tensor:
    """Per-box loss of aligned xyxy boxes: ``iou`` is 1 - iou^2 (the YOLOX
    IOUloss squares the IoU). The other types of the JAX ``iou_loss`` come
    with the families that use them."""
    if loss_type == "iou":
        iou = _iou_terms(pred, target)
        return 1.0 - iou * iou
    raise NotImplementedError(
        f"iou loss {loss_type!r} is not ported yet (ROADMAP.md Queue A.7)")
