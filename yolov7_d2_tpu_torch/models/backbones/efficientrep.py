"""EfficientRep, YOLOv6's RepVGG backbone (JAX
``models/backbones/efficientrep.py``).

Module names are the original reference's (``stem``, ``ERBlock_{i}.0`` the
stride-2 RepVGG block, ``ERBlock_{i}.1`` the ``RepBlock`` with ``conv1`` and
``block.{j}``, ``ERBlock_5.2`` the SimSPPF with ``cv1`` / ``cv2``), so that
``utils/weight_port.py:map_efficientrep_torch_name`` applies.

BatchNorm eps 1e-3 and torch momentum 0.03, the assembled model's values
(the JAX module docstring says why).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import (
    BaseConv,
    RepVGGBlock,
)


def make_divisible(x: float, divisor: int = 8) -> int:
    """YOLOv6's channel rounding: ``x`` up to a multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


def scaled_repeats(repeats: Sequence[int], depth_mul: float) -> list:
    """The depth plan: each count above 1 times ``depth_mul``, rounded, at
    least 1 (JAX :67)."""
    return [max(round(r * depth_mul), 1) if r > 1 else r for r in repeats]


class RepBlock(nn.Module):
    """``n`` RepVGG blocks at ``out_channels``: ``conv1`` then ``block``."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1):
        super().__init__()
        self.conv1 = RepVGGBlock(in_channels, out_channels)
        self.block = nn.Sequential(*[RepVGGBlock(out_channels, out_channels)
                                     for _ in range(n - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(self.conv1(x))


class SimSPPF(nn.Module):
    """1x1 to half the channels, three cascaded 5x5 stride-1 maxpools (the
    5/9/13 pyramid), concat, 1x1; ReLU (the JAX ``SPPBottleneck`` with
    act relu)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        hidden = in_channels // 2
        self.cv1 = BaseConv(in_channels, hidden, 1, 1, act="relu")
        self.m = nn.MaxPool2d(5, stride=1, padding=2)
        self.cv2 = BaseConv(hidden * 4, out_channels, 1, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat([x, y1, y2, self.m(y2)], dim=1))


class EfficientRep(nn.Module):
    """Stem (RepVGG, stride 2), then four stages of a stride-2 RepVGG block
    and a RepBlock, SimSPPF after the last; returns the features
    ``erep3..5`` at strides 8, 16, 32 (``out_channels`` by name)."""

    channels_plan = (64, 128, 256, 512, 1024)
    repeats_plan = (1, 6, 12, 18, 6)

    def __init__(self, width_mul: float = 1.0, depth_mul: float = 1.0):
        super().__init__()
        chs = [make_divisible(c * width_mul) for c in self.channels_plan]
        reps = scaled_repeats(self.repeats_plan, depth_mul)
        self.stem = RepVGGBlock(3, chs[0], stride=2)
        for i in range(1, 5):
            parts = [RepVGGBlock(chs[i - 1], chs[i], stride=2),
                     RepBlock(chs[i], chs[i], reps[i])]
            if i == 4:
                parts.append(SimSPPF(chs[i], chs[i]))
            setattr(self, f"ERBlock_{i + 1}", nn.Sequential(*parts))
        self.out_channels = {f"erep{i + 1}": chs[i] for i in range(1, 5)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outputs = {}
        for i in range(2, 6):
            x = getattr(self, f"ERBlock_{i}")(x)
            if i > 2:
                outputs[f"erep{i}"] = x
        return outputs


def build_efficientrep_backbone(cfg) -> EfficientRep:
    """``MODEL.YOLO.WIDTH_MUL`` / ``DEPTH_MUL`` of a config (JAX :78)."""
    return EfficientRep(width_mul=cfg.width_mul, depth_mul=cfg.depth_mul)


def build_efficientrep_tiny_backbone(cfg) -> EfficientRep:
    """Fixed width 0.25 and depth 0.33 (JAX :86)."""
    return EfficientRep(width_mul=0.25, depth_mul=0.33)
