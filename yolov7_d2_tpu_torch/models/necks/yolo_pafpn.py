"""YOLOPAFPN, the YOLOX PAN neck (JAX ``models/necks/yolo_pafpn.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import (
    BaseConv,
    CSPLayer,
    conv_class,
)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    """``in_channels`` times ``width`` are the widths of the neck's levels.
    ``feat_channels`` are the channels of the features it is given, by
    default those widths (YOLOX, whose backbone has the neck's width);
    the anchor-YOLO models feed CSP-Darknet53's fixed 256/512/1024 into a
    neck of any width, which flax infers and the port is told."""

    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu",
                 feat_channels: Optional[Sequence[int]] = None):
        super().__init__()
        n = max(round(3 * depth), 1)
        c0, c1, c2 = [int(c * width) for c in in_channels]
        f0, f1, f2 = feat_channels or (c0, c1, c2)
        conv = conv_class(depthwise)

        def csp(c_in, c_out):
            return CSPLayer(c_in, c_out, n=n, shortcut=False,
                            depthwise=depthwise, act=act)

        self.lateral_conv0 = BaseConv(f2, c1, 1, 1, act=act)
        self.C3_p4 = csp(c1 + f1, c1)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, act=act)
        self.C3_p3 = csp(c0 + f0, c0)
        self.bu_conv2 = conv(c0, c0, 3, 2, act=act)
        self.C3_n3 = csp(2 * c0, c1)
        self.bu_conv1 = conv(c1, c1, 3, 2, act=act)
        self.C3_n4 = csp(2 * c1, c2)

    def forward(
        self, feats: Sequence[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """feats: (dark3, dark4, dark5), strides 8, 16, 32."""
        x2, x1, x0 = feats
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4(torch.cat([upsample2x_nearest(fpn_out0), x1], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(
            torch.cat([upsample2x_nearest(fpn_out1), x2], 1))
        p_out1 = torch.cat([self.bu_conv2(pan_out2), fpn_out1], 1)
        pan_out1 = self.C3_n3(p_out1)
        p_out0 = torch.cat([self.bu_conv1(pan_out1), fpn_out0], 1)
        pan_out0 = self.C3_n4(p_out0)
        return pan_out2, pan_out1, pan_out0
