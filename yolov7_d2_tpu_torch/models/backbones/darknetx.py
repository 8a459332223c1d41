"""CSPDarknet-X, the YOLOX backbone (JAX ``models/backbones/darknetx.py``).

Module names are those of the original reference (``stem``, ``dark2.0``,
``dark2.1``, ..., ``dark5.{0,1,2}``), which ``map_yolox_torch_name`` maps to
the JAX paths (``stem``, ``dark2_conv``, ``dark2_csp``, ..., ``dark5_spp``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import (
    CSPLayer,
    Focus,
    SPPBottleneck,
    conv_class,
)


class CSPDarknetX(nn.Module):
    def __init__(self, dep_mul: float = 1.0, wid_mul: float = 1.0,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        self.out_features = tuple(out_features)
        base_ch = int(wid_mul * 64)
        base_depth = max(round(dep_mul * 3), 1)
        conv = conv_class(depthwise)

        def stage(c_in, c_out, n):
            return nn.Sequential(
                conv(c_in, c_out, 3, 2, act=act),
                CSPLayer(c_out, c_out, n=n, depthwise=depthwise, act=act),
            )

        channels = {"stem": base_ch, "dark2": base_ch * 2,
                    "dark3": base_ch * 4, "dark4": base_ch * 8,
                    "dark5": base_ch * 16}
        self.out_channels = {k: v for k, v in channels.items()
                             if k in self.out_features}
        self.stem = Focus(3, base_ch, ksize=3, act=act)
        self.dark2 = stage(base_ch, base_ch * 2, base_depth)
        self.dark3 = stage(base_ch * 2, base_ch * 4, base_depth * 3)
        self.dark4 = stage(base_ch * 4, base_ch * 8, base_depth * 3)
        self.dark5 = nn.Sequential(
            conv(base_ch * 8, base_ch * 16, 3, 2, act=act),
            SPPBottleneck(base_ch * 16, base_ch * 16, act=act),
            CSPLayer(base_ch * 16, base_ch * 16, n=base_depth, shortcut=False,
                     depthwise=depthwise, act=act),
        )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        for name in ("stem", "dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
