"""Classification and mask losses (JAX ``ops/losses.py``). Unreduced: the
caller reduces."""

from __future__ import annotations

import torch


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 targets: torch.Tensor) -> torch.Tensor:
    """BCE with logits, in the JAX package's stable form
    ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    return (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """RetinaNet's sigmoid focal loss, unreduced (JAX :30):
    ``alpha_t * bce * (1 - p_t) ** gamma``; no alpha weighting where
    ``alpha < 0``."""
    p = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy of integer ``labels`` against the last axis of
    ``logits``, unreduced over the leading axes (JAX :47)."""
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def weighted_softmax_cross_entropy(logits: torch.Tensor,
                                   labels: torch.Tensor,
                                   class_weights: torch.Tensor
                                   ) -> torch.Tensor:
    """:func:`softmax_cross_entropy` times the weight of each label's class
    (DETR's no-object down-weighting, JAX :56)."""
    return softmax_cross_entropy(logits, labels) * class_weights[
        labels.long()]


def dice_score(pred: torch.Tensor, target: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """Soft dice coefficient over the last axis (JAX :85):
    ``2 sum(p t) / (sum(p^2) + sum(t^2) + eps)``."""
    inter = 2.0 * torch.sum(pred * target, dim=-1)
    denom = (torch.sum(pred * pred, dim=-1)
             + torch.sum(target * target, dim=-1))
    return inter / (denom + eps)


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Dice loss over the last axis of probabilities (JAX :66):
    ``1 - (2 sum(p t) + smooth) / (sum(p^2) + sum(t^2) + smooth)``."""
    inter = torch.sum(pred * target, dim=-1)
    denom = (torch.sum(pred * pred, dim=-1)
             + torch.sum(target * target, dim=-1))
    return 1.0 - (2.0 * inter + smooth) / (denom + smooth)


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                min_count: float = 1.0) -> torch.Tensor:
    """The mean over the elements where ``mask`` holds, of at least
    ``min_count`` of them (JAX :153)."""
    m = mask.to(values.dtype)
    return torch.sum(values * m) / torch.clamp(torch.sum(m), min=min_count)
