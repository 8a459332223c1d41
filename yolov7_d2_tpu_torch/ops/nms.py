"""The NMS suite (JAX ``ops/nms.py``): greedy NMS of one image (``nms``
:30), class-aware (``batched_nms`` :126, ``batched_nms_batched`` :99),
soft-NMS (:144), cluster-NMS (:194), the ``MODEL.NMS_TYPE`` dispatch
``generalized_batched_nms`` (:260), weighted boxes fusion (:301) and
SOLOv2's matrix NMS (:230).

The greedy NMS itself is ``kernels/nms.py``: ``nms_batched`` launches the
NMS kernel on a CUDA tensor and runs the plain version
``nms_batched_plain`` (the port of the JAX ``nms_batched``) on a CPU one.
``nms``, ``batched_nms``, the ``normal`` branch of the dispatch and WBF's
clustering call it on a ``[1, N]`` batch; the kernel takes up to
``kernels.nms.MAX_BOXES`` candidates and no score threshold, so the scores
at or below ``score_threshold`` are zeroed before the call (the JAX
``scores > score_threshold`` for every threshold ``>= 0``; a negative one
raises). Soft-NMS, cluster-NMS and the fusion are XLA code in
JAX and plain PyTorch here: fixed trip counts, no host synchronisation
inside their loops.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from yolov7_d2_tpu_torch.kernels.nms import NEG_INF, nms_batched
from yolov7_d2_tpu_torch.ops.iou import pairwise_box_iou


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5, max_outputs: int = 100,
        score_threshold: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy hard NMS of one image (JAX :30): boxes [N, 4] xyxy, scores
    [N] (0 = a padded slot) -> (keep_idx [max_outputs] int32, -1 padded;
    keep_valid [max_outputs] bool). One launch of the NMS kernel on a CUDA
    tensor. The scores at or below ``score_threshold`` (at least 0) are
    zeroed, since the kernel keeps the positive ones."""
    if score_threshold < 0.0:
        raise ValueError(f"nms: score_threshold {score_threshold} < 0; the "
                         "NMS kernel keeps positive scores only")
    scores = scores.float()
    if score_threshold > 0.0:
        scores = torch.where(scores > score_threshold, scores, 0.0)
    idx, valid = nms_batched(boxes.float()[None].contiguous(),
                             scores[None].contiguous(), iou_threshold,
                             max_outputs)
    return idx[0], valid[0]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_threshold: float = 0.5,
                max_outputs: int = 100, score_threshold: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS of one image (JAX :126, torchvision's
    ``batched_nms``): :func:`nms` over the boxes offset by class, the span
    taken over this call's boxes."""
    return nms(_class_offset_boxes(boxes, classes), scores, iou_threshold,
               max_outputs, score_threshold)


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


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5, max_outputs: int = 100,
             sigma: float = 0.5, score_threshold: float = 0.001,
             method: str = "gaussian"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft-NMS (JAX :144): ``max_outputs`` steps, each keeping the best
    live box while its score is above ``score_threshold`` and decaying the
    others' by their IoU with it: ``method`` "linear" (``1 - iou`` above
    ``iou_threshold``) or else gaussian (``exp(-iou^2 / sigma)``). Returns
    (keep_idx, keep_valid, the kept boxes' decayed scores)."""
    n = boxes.shape[0]
    dev = boxes.device
    iou = pairwise_box_iou(boxes, boxes)
    ar = torch.arange(n, device=dev)
    live = torch.where(scores > 0, scores, torch.full_like(scores, NEG_INF))
    keep_idx = torch.full((max_outputs,), -1, dtype=torch.int32, device=dev)
    keep_valid = torch.zeros((max_outputs,), dtype=torch.bool, device=dev)
    kept = torch.zeros((max_outputs,), dtype=torch.float32, device=dev)
    for i in range(max_outputs):
        best = torch.argmax(live)
        best_score = live[best]
        ok = best_score > score_threshold
        keep_idx[i] = torch.where(ok, best, -1).to(torch.int32)
        keep_valid[i] = ok
        kept[i] = torch.where(ok, best_score, 0.0)
        ious = iou[best]
        if method == "linear":
            decay = torch.where(ious > iou_threshold, 1.0 - ious, 1.0)
        else:
            decay = torch.exp(-(ious * ious) / sigma)
        live = torch.where(ok, live * decay, live)
        live = torch.where(ar == best, NEG_INF, live)
    return keep_idx, keep_valid, kept


def cluster_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.5, max_outputs: int = 100,
                num_iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster-NMS (JAX :194): ``num_iters`` rounds of matrix suppression
    over the boxes sorted by score (stable, so tied scores keep their
    order, as JAX's sort does); a box is kept where no kept higher-scored
    box overlaps it above ``iou_threshold``. Returns the kept indices in
    score order, ``min(N, max_outputs)`` slots."""
    order = torch.argsort(-scores, stable=True)
    boxes_s, scores_s = boxes[order], scores[order]
    upper = torch.triu(pairwise_box_iou(boxes_s, boxes_s), diagonal=1)
    keep = torch.ones_like(scores_s)
    for _ in range(num_iters):
        max_iou = (upper * keep[:, None]).amax(0)
        keep = (max_iou <= iou_threshold).to(boxes.dtype)
    keep = keep.bool() & (scores_s > 0)
    priority = torch.where(keep, scores_s, NEG_INF)
    top = torch.argsort(-priority, stable=True)[:max_outputs]
    return order[top].to(torch.int32), keep[top]


def generalized_batched_nms(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
    iou_threshold: float = 0.5, max_outputs: int = 100,
    score_threshold: float = 0.0, nms_type: str = "normal",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``MODEL.NMS_TYPE`` (JAX :260): "normal" (:func:`batched_nms`),
    "softnms-linear" / "softnms-gaussian" (:func:`soft_nms` on the
    class-offset boxes at a score threshold of at least 1e-3) or
    "cluster" (:func:`cluster_nms`, which takes no score threshold).
    Returns (keep_idx, keep_valid, scores); the scores differ from the
    input's only for soft-NMS."""
    if nms_type == "normal":
        idx, valid = batched_nms(boxes, scores, classes, iou_threshold,
                                 max_outputs, score_threshold)
    elif nms_type in ("softnms-linear", "softnms-gaussian"):
        return soft_nms(
            _class_offset_boxes(boxes, classes), scores, iou_threshold,
            max_outputs,
            method="linear" if nms_type.endswith("linear") else "gaussian",
            score_threshold=max(score_threshold, 1e-3))
    elif nms_type == "cluster":
        idx, valid = cluster_nms(_class_offset_boxes(boxes, classes),
                                 scores, iou_threshold, max_outputs)
    else:
        raise ValueError(f"Unknown nms_type: {nms_type}")
    return idx, valid, torch.where(valid, scores[idx.clamp(min=0).long()],
                                   0.0)


def weighted_boxes_fusion(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.55,
    max_outputs: int = 100, weight_thresh: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted boxes fusion, one model (JAX :301): the clusters' heads
    from :func:`nms` at ``weight_thresh`` as its score threshold (as in
    JAX), then each head replaced by the score-weighted mean of every
    candidate above ``weight_thresh`` that overlaps it above
    ``iou_threshold``. Returns (fused boxes [max_outputs, 4], fused
    scores, valid)."""
    idx, valid = nms(boxes, scores, iou_threshold, max_outputs,
                     weight_thresh)
    iou = pairwise_box_iou(boxes[idx.clamp(min=0).long()], boxes)
    member = (iou > iou_threshold) & (scores[None, :] > weight_thresh)
    w = torch.where(member, scores[None, :], 0.0)
    wsum = w.sum(1, keepdim=True) + 1e-9
    fused = torch.einsum("kn,nc->kc", w, boxes) / wsum
    fused_scores = (w * scores[None, :]).sum(1) / wsum[:, 0]
    return (torch.where(valid[:, None], fused, 0.0),
            torch.where(valid, fused_scores, 0.0), valid)
