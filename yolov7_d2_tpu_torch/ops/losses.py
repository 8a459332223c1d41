"""Classification losses (JAX ``ops/losses.py``). Unreduced: the caller
reduces."""

from __future__ import annotations

import torch


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 targets: torch.Tensor) -> torch.Tensor:
    """BCE with logits, in the JAX package's stable form
    ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    return (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
