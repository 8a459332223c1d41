"""The YOLOv5 CSP backbone (JAX ``models/backbones/yolov5.py``): Focus stem,
Conv/CSP stages on the v5 depth plan (3, 9, 9, 3 scaled by the depth gain),
SPP after the stride-32 conv, a CSP without shortcuts and a 1x1 conv that
narrows C5 to 512 x the width gain.

Module names are the flax ones of the JAX package (``stage1``,
``stage2_1``, ``stage2_2``, ..., ``spp``, ``csp1``, ``conv1``) with the
CSP layers' inner names of YOLOX (``m.0.conv1``), so that
``utils/weight_port.py:map_yolov5_torch_name`` maps them.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import (
    BaseConv,
    CSPLayer,
    Focus,
    SPPBottleneck,
)

# (depth gain, width gain) of each size (JAX :30)
GAINS = {"s": (0.33, 0.5), "m": (0.67, 0.75), "l": (1.0, 1.0),
         "x": (1.33, 1.25)}


def _make_divisible(v: float, d: int = 8) -> int:
    """Round to the nearest multiple of ``d``, at least ``d`` (JAX :38)."""
    return max(int((v + d / 2) // d * d), d)


class YOLOv5Backbone(nn.Module):
    """Features ``c3``, ``c4``, ``c5`` at strides 8, 16, 32
    (``out_channels`` by name); SiLU."""

    def __init__(self, version: str = "s"):
        super().__init__()
        gd, gw = GAINS[version.lower()]
        act = "silu"

        def w(c):
            return _make_divisible(c * gw)

        def d(n):
            return max(round(n * gd), 1) if n > 1 else n

        self.stage1 = Focus(3, w(64), 3, act=act)
        self.stage2_1 = BaseConv(w(64), w(128), 3, 2, act=act)
        self.stage2_2 = CSPLayer(w(128), w(128), n=d(3), act=act)
        self.stage3_1 = BaseConv(w(128), w(256), 3, 2, act=act)
        self.stage3_2 = CSPLayer(w(256), w(256), n=d(9), act=act)
        self.stage4_1 = BaseConv(w(256), w(512), 3, 2, act=act)
        self.stage4_2 = CSPLayer(w(512), w(512), n=d(9), act=act)
        self.stage5 = BaseConv(w(512), w(1024), 3, 2, act=act)
        self.spp = SPPBottleneck(w(1024), w(1024), act=act)
        self.csp1 = CSPLayer(w(1024), w(1024), n=d(3), shortcut=False,
                             act=act)
        self.conv1 = BaseConv(w(1024), w(512), 1, 1, act=act)
        self.out_channels = {"c3": w(256), "c4": w(512), "c5": w(512)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stage2_2(self.stage2_1(self.stage1(x)))
        c3 = self.stage3_2(self.stage3_1(x))
        c4 = self.stage4_2(self.stage4_1(c3))
        x = self.csp1(self.spp(self.stage5(c4)))
        return {"c3": c3, "c4": c4, "c5": self.conv1(x)}


def build_yolov5_backbone(cfg) -> YOLOv5Backbone:
    """The size from ``width_mul`` by the JAX table (0.5 s, 0.75 m, 1.0 l,
    1.25 x, anything else s; JAX :90)."""
    version = {0.5: "s", 0.75: "m", 1.0: "l", 1.25: "x"}.get(
        cfg.width_mul, "s")
    return YOLOv5Backbone(version=version)
