"""Class-aware batched NMS (JAX ``ops/nms.py:99-123``).

The greedy NMS itself is ``kernels/nms.py``: ``nms_batched`` launches
the NMS kernel on a CUDA tensor and runs the plain version
``nms_batched_plain`` (the port of the JAX ``nms_batched``) on a CPU one.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from yolov7_d2_tpu_torch.kernels.nms import nms_batched


def batched_nms_batched(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
    iou_threshold: float = 0.5, max_outputs: int = 100,
    nms: Callable = nms_batched,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS over [B, N, 4] boxes, [B, N] scores and classes."""
    return nms(_class_offset_boxes(boxes, classes), scores, iou_threshold,
               max_outputs)


def _class_offset_boxes(boxes: torch.Tensor,
                        classes: torch.Tensor) -> torch.Tensor:
    """Offset boxes per class so that boxes of two classes never overlap.
    The span is the maximum over the whole batch tensor, as in the JAX
    package (ops/nms.py:121)."""
    span = boxes.max() + 1.0
    return boxes + classes.to(boxes.dtype)[..., None] * span
