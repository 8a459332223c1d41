"""The semantic segmentation FPN head of Panoptic FPN (JAX
``models/heads/sem_seg_head.py:20``, ``SemSegFPNHead``).

Level i of the pyramid (strides 4, 8, 16, 32) goes through ``max(n, 1)``
3x3 conv -> GroupNorm(32) -> ReLU stacks, n the number of 2x upsamples to
the common stride 4, each stack but the last of a level followed by the 2x
bilinear resize; the levels are summed and a 1x1 ``predictor`` gives the
logits at a quarter of the input, float32, channels last [B, H/4, W/4, S].
Module names are the flax ones (``l{i}_conv{j}``, ``l{i}_gn{j}``,
``predictor``).

Dtypes as in the JAX head: the convs in the compute dtype (bf16 under
autocast), GroupNorm in float32 (autocast's own rule, the JAX
``GroupNorm(dtype=float32)``), the ReLU rounded to the compute dtype
(``AutocastReLU``), and the resize in the compute dtype: outside autocast,
which would run ``upsample_bilinear2d`` in float32 (SOLOv2's lesson,
PERF.md section 5). The resize is ``jax.image.resize``'s bilinear, half-pixel
centres; where it takes a gradient, its backward is SparseInst's
fixed-order one (``sparseinst._resize``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import AutocastReLU
from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import _resize


class SemSegFPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 54,
                 conv_dims: int = 128, common_stride: int = 4,
                 strides: Sequence[int] = (4, 8, 16, 32)):
        super().__init__()
        self.strides = tuple(strides)
        self.ups = []
        for i, s in enumerate(self.strides):
            n_ups = max((s // common_stride).bit_length() - 1, 0)
            self.ups.append(n_ups)
            for j in range(max(n_ups, 1)):
                self.add_module(f"l{i}_conv{j}", nn.Conv2d(
                    in_channels if j == 0 else conv_dims, conv_dims, 3, 1, 1))
                self.add_module(f"l{i}_gn{j}", nn.GroupNorm(
                    min(32, conv_dims), conv_dims, eps=1e-5))
        self.act = AutocastReLU()
        self.predictor = nn.Conv2d(conv_dims, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """feats: the levels shallow to deep, NCHW."""
        acc = None
        for i, x in enumerate(feats):
            n_ups = self.ups[i]
            for j in range(max(n_ups, 1)):
                x = getattr(self, f"l{i}_conv{j}")(x)
                x = self.act(getattr(self, f"l{i}_gn{j}")(x))
                if j < n_ups:
                    with torch.autocast(x.device.type, enabled=False):
                        x = _resize(x, (x.shape[2] * 2, x.shape[3] * 2))
            acc = x if acc is None else acc + x
        return self.predictor(acc).float().permute(0, 2, 3, 1)
