"""Box modes and conversions (JAX ``structures/boxes.py``).

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
