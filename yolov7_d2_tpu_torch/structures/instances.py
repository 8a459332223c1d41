"""Fixed-capacity detections and dense ground truth (JAX
``structures/instances.py:25, 79``): dataclasses of tensors whose ``valid``
marks the live rows."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Detections:
    """boxes [..., K, 4] xyxy in network-input pixels, scores [..., K],
    classes [..., K] int32, valid [..., K] bool; ``masks`` [..., K, Hm, Wm]
    soft masks where the model segments (SparseInst), else None;
    ``keypoints`` [..., K, P, 3] (x, y, score) where the model finds
    keypoints (YOLOX-KPTS), else None. Rows
    where ``valid`` is False are garbage by contract."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None
    keypoints: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)

    def replace(self, **kw) -> "Detections":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(capacity: int, num_keypoints: int = 0,
              mask_shape: Optional[Tuple[int, int]] = None,
              device="cpu") -> "Detections":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return Detections(
            boxes=zeros(capacity, 4), scores=zeros(capacity),
            classes=zeros(capacity, dtype=torch.int32),
            valid=zeros(capacity, dtype=torch.bool),
            masks=zeros(capacity, *mask_shape) if mask_shape else None,
            keypoints=(zeros(capacity, num_keypoints, 3) if num_keypoints
                       else None))


@dataclasses.dataclass(frozen=True)
class GtInstances:
    """Dense ground truth of a batch (JAX :79): boxes [B, G, 4] xyxy in
    input pixels, classes [B, G] int32, valid [B, G] bool; ``masks`` [B, G,
    H, W] and ``keypoints`` [B, G, P, 3] (x, y, visibility) where the task
    has them."""

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None
    keypoints: Optional[torch.Tensor] = None

    @property
    def max_boxes(self) -> int:
        return self.boxes.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)

    def replace(self, **kw) -> "GtInstances":
        return dataclasses.replace(self, **kw)
