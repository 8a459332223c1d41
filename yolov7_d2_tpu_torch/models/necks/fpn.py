"""detectron2-style FPN (JAX ``models/necks/fpn.py:22``): SOLOv2's neck,
and ``ResNetFPN`` (JAX :59), the ResNet with it that Mask R-CNN and
Panoptic FPN build, with its registry builder ``build_resnet_fpn_backbone``
(:85).

A 1x1 lateral on each input level (shallow to deep), the top-down sum with
the nearest 2x upsample of the level above, a 3x3 output convolution a
level, and with ``top_block`` "maxpool" one more level: the coarsest
output subsampled by 2 (a 1x1 max-pool of stride 2). Module names are the
flax ones (``lateral_{i}``, ``output_{i}``); outputs are ``p{first_level
+ i}``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.backbones.resnet import (
    RESNET_CHANNELS,
    ResNet,
    ResNetSpec,
)
from yolov7_d2_tpu_torch.models.build import BACKBONE_REGISTRY


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 top_block: str = "maxpool", first_level: int = 2):
        super().__init__()
        self.top_block = top_block
        self.first_level = first_level
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"output_{i}",
                            nn.Conv2d(out_channels, out_channels, 3, 1, 1))
        self.num_levels = len(in_channels)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        n = self.num_levels
        laterals = [getattr(self, f"lateral_{i}")(f)
                    for i, f in enumerate(feats)]
        tops = [None] * n
        tops[-1] = laterals[-1]
        for i in range(n - 2, -1, -1):
            tops[i] = laterals[i] + F.interpolate(
                tops[i + 1], scale_factor=2, mode="nearest")
        outs = {f"p{self.first_level + i}": getattr(self, f"output_{i}")(t)
                for i, t in enumerate(tops)}
        if self.top_block == "maxpool":
            last = outs[f"p{self.first_level + n - 1}"]
            outs[f"p{self.first_level + n}"] = last[:, :, ::2, ::2]
        return outs


class ResNetFPN(nn.Module):
    """ResNet (res2-res5, ``bottom_up``) + FPN (p2-p6, ``fpn``):
    detectron2's ``build_resnet_fpn_backbone`` (JAX :59). The JAX module
    builds its ResNet with the stride in the 1x1 and FrozenBN unless
    ``frozen_bn`` is False, whatever else ``MODEL.RESNETS`` says."""

    FEATURES = ("res2", "res3", "res4", "res5")

    def __init__(self, depth: int = 50, out_channels: int = 256,
                 frozen_bn: bool = True):
        super().__init__()
        self.bottom_up = ResNet(ResNetSpec(depth=depth,
                                           out_features=self.FEATURES,
                                           frozen_bn=frozen_bn))
        self.fpn = FPN([RESNET_CHANNELS[f] for f in self.FEATURES],
                       out_channels, "maxpool")

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.bottom_up(x)
        return self.fpn([feats[f] for f in self.FEATURES])


@BACKBONE_REGISTRY.register()
def build_resnet_fpn_backbone(cfg) -> ResNetFPN:
    """From a merged ``CfgNode`` (JAX :85): ``RESNETS.DEPTH``,
    ``FPN.OUT_CHANNELS``, FrozenBN where ``RESNETS.NORM`` is "FrozenBN"."""
    return ResNetFPN(depth=int(cfg.MODEL.RESNETS.DEPTH),
                     out_channels=int(cfg.MODEL.FPN.OUT_CHANNELS),
                     frozen_bn=str(cfg.MODEL.RESNETS.NORM) == "FrozenBN")
