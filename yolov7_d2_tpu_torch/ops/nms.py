"""Class-aware batched NMS (JAX ``ops/nms.py:99-123``) and SOLOv2's matrix
NMS (JAX :230).

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


def matrix_nms_masks(mask_ious: torch.Tensor, labels: torch.Tensor,
                     scores: torch.Tensor, kernel: str = "gaussian",
                     sigma: float = 2.0) -> torch.Tensor:
    """SOLOv2's matrix NMS (JAX :230): every score decayed at once from the
    pairwise mask IoUs [N, N] of candidates sorted by descending score, by
    the same-class IoUs with higher-scored candidates, compensated by each
    suppressor's own largest such IoU; ``kernel`` "gaussian"
    (``exp(-sigma iou^2)``) or else linear. Returns the decayed scores
    [N]. Leading batch axes ([..., N, N], [..., N]) go through as they
    are."""
    n = scores.shape[-1]
    same_class = labels[..., :, None] == labels[..., None, :]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=scores.device).triu(1)
    decay_iou = torch.where(same_class & upper, mask_ious, 0.0)
    compensate = decay_iou.amax(-2)
    if kernel == "gaussian":
        decay = torch.exp(-sigma * decay_iou ** 2)
        comp = torch.exp(-sigma * compensate ** 2)
        coef = (decay / comp[..., :, None]).amin(-2)
    else:
        coef = ((1.0 - decay_iou)
                / (1.0 - compensate[..., :, None] + 1e-9)).amin(-2)
    return scores * coef
