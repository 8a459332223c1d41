"""Fixed-capacity detections (JAX ``structures/instances.py:25``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Detections:
    """boxes [..., K, 4] xyxy in network-input pixels, scores [..., K],
    classes [..., K] int32, valid [..., K] bool; ``masks`` [..., K, Hm, Wm]
    soft masks where the model segments (SparseInst), else None. Rows
    where ``valid`` is False are garbage by contract."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)
