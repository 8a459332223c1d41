"""Box modes, conversions and the box helpers (JAX ``structures/boxes.py``).

``BoxMode`` keeps the original's quirk: ``XYWH_ABS`` is **center** xywh
(cx, cy, w, h), and the COCO corner convention is ``XYWH_CORNER_ABS``.
"""

from __future__ import annotations

import enum

import torch


class BoxMode(enum.IntEnum):
    XYXY_ABS = 0      # (x0, y0, x1, y1) absolute pixels
    XYWH_ABS = 1      # (cx, cy, w, h) — CENTER convention (reference quirk)
    XYXY_REL = 2      # (x0, y0, x1, y1) in [0, 1]
    XYWH_REL = 3      # (cx, cy, w, h) in [0, 1]
    XYWHA_ABS = 4     # rotated; (cx, cy, w, h, angle)
    XYWH_CORNER_ABS = 5  # (x0, y0, w, h) — COCO / detectron2 convention


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1
    )


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack(
        [(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1
    )


def xywh_corner_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, w, h = boxes.unbind(-1)
    return torch.stack([x0, y0, x0 + w, y0 + h], dim=-1)


def xyxy_to_xywh_corner(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


_CONVERTERS = {
    (BoxMode.XYWH_ABS, BoxMode.XYXY_ABS): cxcywh_to_xyxy,
    (BoxMode.XYXY_ABS, BoxMode.XYWH_ABS): xyxy_to_cxcywh,
    (BoxMode.XYWH_CORNER_ABS, BoxMode.XYXY_ABS): xywh_corner_to_xyxy,
    (BoxMode.XYXY_ABS, BoxMode.XYWH_CORNER_ABS): xyxy_to_xywh_corner,
}


def convert_box_mode(boxes: torch.Tensor, from_mode: BoxMode,
                     to_mode: BoxMode) -> torch.Tensor:
    """Between the absolute modes (JAX :60), through ``XYXY_ABS`` where no
    converter goes straight."""
    if from_mode == to_mode:
        return boxes
    if (from_mode, to_mode) in _CONVERTERS:
        return _CONVERTERS[(from_mode, to_mode)](boxes)
    mid = _CONVERTERS[(from_mode, BoxMode.XYXY_ABS)](boxes)
    return _CONVERTERS[(BoxMode.XYXY_ABS, to_mode)](mid)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, 0 for a degenerate box (JAX :74)."""
    wh = (boxes[..., 2:4] - boxes[..., 0:2]).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def clip_boxes(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """xyxy boxes clipped to an image of (h, w) (JAX :80)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0.clamp(0.0, w), y0.clamp(0.0, h),
                        x1.clamp(0.0, w), y1.clamp(0.0, h)], dim=-1)


def scale_boxes(boxes: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    """xyxy boxes times (sx, sy, sx, sy) (JAX :89)."""
    s = torch.as_tensor([scale_x, scale_y, scale_x, scale_y],
                        dtype=boxes.dtype, device=boxes.device)
    return boxes * s
