"""EfficientNet-b0..b7 (JAX ``models/backbones/efficientnet.py``): the
backbone of ``configs/wearmask/efficient_b2.yaml``.

A 3x3 stride-2 stem, then the MBConv plan (expand 1x1, depthwise k x k
at the stage's stride in its first block, squeeze-excitation, project
1x1, the residual where the stride is 1 and the width unchanged), its
widths and repeats scaled by the variant and rounded as the reference
rounds them. The taps are the outputs after the blocks of
``feature_indices``, named ``stride4`` .. ``stride32`` in order (the
reference's ``return_features_indices``; b0's [1, 4, 10, 15] is the
default on every variant, as in the JAX package).

Padding is the reference's "static same": the stem and the depthwise
convolutions are padded by ``max(k - s, 0)`` split ``(p // 2, p - p //
2)``, one more pixel after than before at stride 2 (``F.pad`` before the
convolution); the dense 1x1s get none. BatchNorm: eps 1e-3, momentum 0.01
(flax 0.99). The SE runs in float32 outside autocast (mean, 1x1 to a
quarter of the block's input width with bias, SiLU, 1x1 with bias,
sigmoid) and its gated output is cast back to the stream's dtype.

Module names are the reference's (``_conv_stem``, ``_bn0``,
``_blocks.{i}.{_expand_conv,_bn0,_depthwise_conv,_bn1,_se_reduce,
_se_expand,_project_conv,_bn2}``), so that ``utils/weight_port.py``
``map_efficientnet_torch_name`` (a copy of the JAX map) applies.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# width and depth multipliers a variant; a copy of the JAX EFFNET_SCALING
EFFNET_SCALING = {
    "efficientnet_b0": (1.0, 1.0), "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2), "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8), "efficientnet_b5": (1.6, 2.2),
    "efficientnet_b6": (1.8, 2.6), "efficientnet_b7": (2.0, 3.1),
}
# (expand, channels, repeats, stride, kernel) a stage; a copy of the JAX
# MBCONV_PLAN
MBCONV_PLAN = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
TAP_NAMES = ("stride4", "stride8", "stride16", "stride32")


def round_filters(c: int, mult: float, divisor: int = 8) -> int:
    c = c * mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def round_repeats(r: int, mult: float) -> int:
    return int(math.ceil(r * mult))


def static_same_pad(k: int, s: int):
    """(before, after) padding of a k x k stride-s "static same" conv."""
    p = max(k - s, 0)
    return (p // 2, p - p // 2)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-3, momentum=0.01)


class MBConvBlock(nn.Module):
    """[expand 1x1 BN SiLU] -> depthwise k x k BN SiLU -> SE -> project 1x1
    BN -> [+ input] (JAX :54)."""

    def __init__(self, c_in: int, expand: int, c_out: int, stride: int,
                 kernel: int):
        super().__init__()
        mid = c_in * expand
        self.expand = expand != 1
        if self.expand:
            self._expand_conv = nn.Conv2d(c_in, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self.pad = static_same_pad(kernel, stride) * 2
        self._depthwise_conv = nn.Conv2d(mid, mid, kernel, stride,
                                         groups=mid, bias=False)
        self._bn1 = _bn(mid)
        se_mid = max(1, int(c_in / 4))
        self._se_reduce = nn.Conv2d(mid, se_mid, 1)
        self._se_expand = nn.Conv2d(se_mid, mid, 1)
        self._project_conv = nn.Conv2d(mid, c_out, 1, bias=False)
        self._bn2 = _bn(c_out)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand:
            y = F.silu(self._bn0(self._expand_conv(y)))
        y = F.silu(self._bn1(self._depthwise_conv(F.pad(y, self.pad))))
        with torch.autocast(y.device.type, enabled=False):
            s = y.float().mean((2, 3), keepdim=True)
            s = self._se_expand(F.silu(self._se_reduce(s)))
            y = (y * torch.sigmoid(s)).to(y.dtype)
        y = self._bn2(self._project_conv(y))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """The stem and the MBConv blocks of ``variant``; returns the taps of
    ``feature_indices`` that ``out_features`` names and gives each one's
    width in ``out_channels`` (JAX :94)."""

    def __init__(self, variant: str = "efficientnet_b0",
                 out_features: Sequence[str] = TAP_NAMES,
                 feature_indices: Sequence[int] = (1, 4, 10, 15)):
        super().__init__()
        wm, dm = EFFNET_SCALING[variant]
        stem = round_filters(32, wm)
        self.stem_pad = static_same_pad(3, 2) * 2
        self._conv_stem = nn.Conv2d(3, stem, 3, 2, bias=False)
        self._bn0 = _bn(stem)
        self.out_features = tuple(out_features)
        self.taps = {b: TAP_NAMES[i]
                     for i, b in enumerate(sorted(feature_indices))}
        self.out_channels: Dict[str, int] = {}
        self._blocks = nn.ModuleList()
        c_in = stem
        for e, c, r, s, k in MBCONV_PLAN:
            c = round_filters(c, wm)
            for i in range(round_repeats(r, dm)):
                self._blocks.append(MBConvBlock(c_in, e, c, s if i == 0
                                                else 1, k))
                c_in = c
                tap = self.taps.get(len(self._blocks) - 1)
                if tap in self.out_features:
                    self.out_channels[tap] = c

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.silu(self._bn0(self._conv_stem(F.pad(x, self.stem_pad))))
        out = {}
        for i, block in enumerate(self._blocks):
            x = block(x)
            name = self.taps.get(i)
            if name in self.out_features:
                out[name] = x
        return out


def build_efficientnet_backbone(spec) -> EfficientNet:
    """EfficientNet from a ``ZooSpec`` (``MODEL.EFFICIENTNET``: ``NAME``,
    ``OUT_FEATURES``, ``FEATURE_INDICES``; JAX :137)."""
    return EfficientNet(spec.efficientnet_name,
                        spec.efficientnet_out_features,
                        spec.efficientnet_feature_indices)
