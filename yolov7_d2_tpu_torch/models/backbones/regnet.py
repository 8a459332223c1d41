"""RegNetX / RegNetY (JAX ``models/backbones/regnet.py``): the backbone of
``configs/coco/regnetx_0.4g.yaml``, ``yolox_regnetx_s.yaml`` and
``canaries/regnetx_0.2g.yaml``.

A 3x3 stride-2 stem to 32 channels, then four stages of bottleneck blocks:
1x1, grouped 3x3 (``width // group_width`` groups) at the stage's stride
in its first block, the Y variant's squeeze-excitation, 1x1, and a 1x1
projection shortcut where the width or the stride changes. Module names
are the flax ones (``stem_conv``, ``s{stage}_b{i}.{a,b,c,proj}_{conv,bn}``,
``s{stage}_b{i}.se.fc{1,2}``), so that ``utils/weight_port.py`` maps them
by turning dots into slashes. The BatchNorms train on batch statistics
(momentum 0.1 = flax 0.9, eps 1e-5).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (depths, widths, group_width) a stage; a copy of the JAX REGNET_SPECS
REGNET_SPECS: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...], int]] = {
    "x_200mf": ((1, 1, 4, 7), (24, 56, 152, 368), 8),
    "x_400mf": ((1, 2, 7, 12), (32, 64, 160, 384), 16),
    "x_800mf": ((1, 3, 7, 5), (64, 128, 288, 672), 16),
    "x_1.6gf": ((2, 4, 10, 2), (72, 168, 408, 912), 24),
    "y_400mf": ((1, 3, 6, 6), (48, 104, 208, 440), 8),
    "y_800mf": ((1, 3, 8, 2), (64, 128, 320, 768), 16),
}
# the reference's short names (JAX :107-110)
_ALIASES = {"x_0.2g": "x_200mf", "x_0.4g": "x_400mf", "x_0.8g": "x_800mf",
            "x_1.6g": "x_1.6gf", "y_0.4g": "y_400mf", "y_0.8g": "y_800mf"}


def _conv_bn(block: nn.Module, name: str, c_in: int, c_out: int, k: int,
             stride: int = 1, groups: int = 1) -> None:
    setattr(block, f"{name}_conv",
            nn.Conv2d(c_in, c_out, k, stride, (k - 1) // 2, groups=groups,
                      bias=False))
    setattr(block, f"{name}_bn", nn.BatchNorm2d(c_out, eps=1e-5,
                                                momentum=0.1))


class SE(nn.Module):
    """Mean over the map, 1x1 to a quarter of the width, ReLU, 1x1,
    sigmoid gate, both 1x1s with biases (JAX :30)."""

    def __init__(self, channels: int, ratio: float = 0.25):
        super().__init__()
        mid = max(int(channels * ratio), 1)
        self.fc1 = nn.Conv2d(channels, mid, 1)
        self.fc2 = nn.Conv2d(mid, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class RegNetBlock(nn.Module):
    """1x1 -> BN ReLU -> grouped 3x3 (stride) -> BN ReLU -> [SE] -> 1x1 ->
    BN, plus the shortcut (a 1x1 + BN projection where the width or the
    stride changes), ReLU (JAX :46)."""

    def __init__(self, c_in: int, width: int, stride: int,
                 group_width: int, use_se: bool = False):
        super().__init__()
        groups = max(width // group_width, 1)
        _conv_bn(self, "a", c_in, width, 1)
        _conv_bn(self, "b", width, width, 3, stride, groups)
        self.se = SE(width) if use_se else None
        _conv_bn(self, "c", width, width, 1)
        self.has_proj = c_in != width or stride != 1
        if self.has_proj:
            _conv_bn(self, "proj", c_in, width, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.a_bn(self.a_conv(x)))
        y = F.relu(self.b_bn(self.b_conv(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.c_bn(self.c_conv(y))
        if self.has_proj:
            x = self.proj_bn(self.proj_conv(x))
        return F.relu(y + x)


class RegNet(nn.Module):
    """The stem and the four stages of ``variant`` (a key of
    :data:`REGNET_SPECS`; "y" variants with SE); returns ``{"s{i}":
    feature}`` for ``out_features`` and gives each one's width in
    ``out_channels`` (JAX :72)."""

    def __init__(self, variant: str = "x_400mf",
                 out_features: Sequence[str] = ("s2", "s3", "s4")):
        super().__init__()
        depths, widths, gw = REGNET_SPECS[variant]
        self.out_features = tuple(out_features)
        self.out_channels = {f"s{i + 1}": w for i, w in enumerate(widths)
                             if f"s{i + 1}" in self.out_features}
        self.stem_conv = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.stem_bn = nn.BatchNorm2d(32, eps=1e-5, momentum=0.1)
        self.depths = depths
        c_in = 32
        for stage, (n, w) in enumerate(zip(depths, widths)):
            for i in range(n):
                self.add_module(f"s{stage + 1}_b{i}", RegNetBlock(
                    c_in, w, 2 if i == 0 else 1, gw,
                    use_se=variant.startswith("y")))
                c_in = w

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        out = {}
        for stage, n in enumerate(self.depths):
            for i in range(n):
                x = getattr(self, f"s{stage + 1}_b{i}")(x)
            name = f"s{stage + 1}"
            if name in self.out_features:
                out[name] = x
        return out


def regnet_variant(regnet_type: str) -> str:
    """``MODEL.REGNETS.TYPE`` -> a key of :data:`REGNET_SPECS`, as the JAX
    builder reads it (:105-112): reference names ("RegNetX_400MF",
    "regnetx_0.4g", "regnetx_200mf") and spec keys; a name without a size
    ("x", the default) is its 400MF."""
    t = regnet_type.lower().replace("regnet", "").lstrip("_")
    t = _ALIASES.get(t, t)
    if "_" not in t:
        t = f"{t}_400mf"
    return t


def build_regnet_backbone(spec) -> RegNet:
    """RegNet from a ``ZooSpec`` (``MODEL.REGNETS``; JAX :103)."""
    return RegNet(regnet_variant(spec.regnet_type), spec.regnet_out_features)
