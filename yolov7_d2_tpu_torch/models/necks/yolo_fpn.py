"""YOLOv3's FPN neck with an optional SPP (JAX ``models/necks/yolo_fpn.py``).

Module names are those of the original reference (``out0``-``out2``, the
5-conv stacks of strides 32, 16, 8; ``out1_cbl`` / ``out2_cbl``, the
laterals; ``spp``), which ``map_yolofpn_torch_name`` maps to the JAX paths.
BatchNorm eps 1e-5 (torch's default): the YOLO archs never apply the YOLOX
BN reset; the SPP keeps its default SiLU inside the leaky-ReLU neck, as the
reference does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv, SPPBottleneck
from yolov7_d2_tpu_torch.models.necks.yolo_pafpn import upsample2x_nearest

BN_EPS = 1e-5
OUT_CHANNELS = (128, 256, 512)  # strides 8, 16, 32


def conv_block5(c_in: int, c: int, act: str = "lrelu") -> nn.Sequential:
    """The 1-3-1-3-1 conv stack of YOLOv3 (JAX ``_ConvBlock5``)."""
    return nn.Sequential(
        BaseConv(c_in, c, 1, 1, act=act, bn_eps=BN_EPS),
        BaseConv(c, 2 * c, 3, 1, act=act, bn_eps=BN_EPS),
        BaseConv(2 * c, c, 1, 1, act=act, bn_eps=BN_EPS),
        BaseConv(c, 2 * c, 3, 1, act=act, bn_eps=BN_EPS),
        BaseConv(2 * c, c, 1, 1, act=act, bn_eps=BN_EPS))


class YOLOFPN(nn.Module):
    """(dark3, dark4, dark5) of ``in_channels`` -> (P3, P4, P5) of
    :data:`OUT_CHANNELS` channels."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024),
                 with_spp: bool = False, act: str = "lrelu"):
        super().__init__()
        f0, f1, f2 = in_channels
        self.spp = (SPPBottleneck(f2, f2, act="silu", bn_eps=BN_EPS)
                    if with_spp else None)
        c3, c4, c5 = OUT_CHANNELS
        self.out0 = conv_block5(f2, c5, act)
        self.out1_cbl = BaseConv(c5, c4, 1, 1, act=act, bn_eps=BN_EPS)
        self.out1 = conv_block5(c4 + f1, c4, act)
        self.out2_cbl = BaseConv(c4, c3, 1, 1, act=act, bn_eps=BN_EPS)
        self.out2 = conv_block5(c3 + f0, c3, act)

    def forward(
        self, feats: Sequence[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x2, x1, x0 = feats  # strides 8, 16, 32
        if self.spp is not None:
            x0 = self.spp(x0)
        out0 = self.out0(x0)
        x1 = torch.cat([upsample2x_nearest(self.out1_cbl(out0)), x1], 1)
        out1 = self.out1(x1)
        x2 = torch.cat([upsample2x_nearest(self.out2_cbl(out1)), x2], 1)
        out2 = self.out2(x2)
        return out2, out1, out0
