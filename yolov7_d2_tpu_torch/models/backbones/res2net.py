"""Res2Net-50/101 and Res2NeXt-50 (JAX ``models/backbones/res2net.py``):
the YOLOV7 backbone of ``configs/coco/r2_50.yaml`` and its kin.

Module names are the reference's (``res2net_v1b.py``, ``res2next.py``),
so that ``utils/weight_port.py`` ``map_res2net_torch_name`` applies: the
deep stem ``conv1.{0,1,3,4,6}`` with the outer ``bn1`` (v1b / v1d), or
the plain ``conv1`` / ``bn1`` (Res2NeXt); blocks ``layer{1..4}.{i}.{conv1,
bn1, convs.j, bns.j, conv3, bn3, downsample}``. The BatchNorms train on
batch statistics (``nn.BatchNorm2d``, momentum 0.1 = flax 0.9), and become
``SyncBatchNorm2d`` inside a process group.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.backbones.resnet import (
    BN_EPS,
    RESNET_CHANNELS,
    STAGE_BLOCKS,
)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=0.1)


def _conv(c_in: int, c_out: int, kernel: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                     groups=groups, bias=False)


class Bottle2neck(nn.Module):
    """1x1 to ``width * scale``, then the hierarchical 3x3s over the first
    ``scale - 1`` channel splits (split i takes split i plus the previous
    3x3's output, except in a ``stage`` block, the first of a layer), the
    last split passed through (average-pooled 3x3 at the block's stride in
    a ``stage`` block, the stride-1 one that opens ``layer1`` too, padding
    counted as flax ``avg_pool`` counts it), a 1x1 to ``c_out`` and the
    shortcut (JAX :19). ``vd``: the shortcut average-pools by the stride
    (ceil, padding not counted) before its 1x1, else the 1x1 takes the
    stride."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 scale: int = 4, base_width: int = 26, cardinality: int = 1,
                 vd: bool = False, stage: bool = False):
        super().__init__()
        w = int((c_out // 4) * base_width / 64.0) * cardinality
        self.width, self.scale, self.stage = w, scale, stage
        self.conv1 = _conv(c_in, w * scale, 1)
        self.bn1 = _bn(w * scale)
        nums = 1 if scale == 1 else scale - 1
        self.convs = nn.ModuleList(_conv(w, w, 3, stride, cardinality)
                                   for _ in range(nums))
        self.bns = nn.ModuleList(_bn(w) for _ in range(nums))
        self.pool = (nn.AvgPool2d(3, stride, 1) if scale > 1 and stage
                     else None)
        self.conv3 = _conv(w * scale, c_out, 1)
        self.bn3 = _bn(c_out)
        self.downsample = None
        if c_in != c_out or stride != 1:
            if vd:
                pool = (nn.AvgPool2d(stride, stride, ceil_mode=True,
                                     count_include_pad=False)
                        if stride != 1 else nn.Identity())
                self.downsample = nn.Sequential(pool, _conv(c_in, c_out, 1),
                                                _bn(c_out))
            else:
                self.downsample = nn.Sequential(
                    _conv(c_in, c_out, 1, stride), _bn(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        splits = torch.split(F.relu(self.bn1(self.conv1(x))), self.width, 1)
        outs = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            inp = splits[i] if i == 0 or self.stage else splits[i] + sp
            sp = F.relu(bn(conv(inp)))
            outs.append(sp)
        if self.scale > 1:
            outs.append(splits[-1] if self.pool is None
                        else self.pool(splits[-1]))
        y = self.bn3(self.conv3(torch.cat(outs, 1)))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(y + sc)


class Res2Net(nn.Module):
    """The stem (vd: 3x3 s2 to 32, 3x3 to 32, 3x3 to 64; else 7x7 s2),
    a 3x3 stride-2 max-pool and four layers of :class:`Bottle2neck`
    (JAX :88); returns ``{name: feature}`` (``res2``..``res5``) for
    ``out_features``, and gives each one's width in ``out_channels``."""

    def __init__(self, depth: int = 50, scale: int = 4, base_width: int = 26,
                 cardinality: int = 1, vd: bool = True,
                 out_features: Sequence[str] = ("res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.out_channels: Dict[str, int] = dict(RESNET_CHANNELS)
        if vd:
            self.conv1 = nn.Sequential(
                _conv(3, 32, 3, 2), _bn(32), nn.ReLU(),
                _conv(32, 32, 3), _bn(32), nn.ReLU(), _conv(32, 64, 3))
        else:
            self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        c_in = 64
        for stage, (n, c) in enumerate(zip(STAGE_BLOCKS[depth],
                                           RESNET_CHANNELS.values())):
            self.add_module(f"layer{stage + 1}", nn.Sequential(*(
                Bottle2neck(c_in if i == 0 else c, c,
                            stride=2 if i == 0 and stage > 0 else 1,
                            scale=scale, base_width=base_width,
                            cardinality=cardinality, vd=vd, stage=i == 0)
                for i in range(n))))
            c_in = c

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        out = {}
        for stage, name in enumerate(RESNET_CHANNELS):
            x = getattr(self, f"layer{stage + 1}")(x)
            if name in self.out_features:
                out[name] = x
        return out


def build_res2net_backbone(cfg) -> Res2Net:
    """``MODEL.RESNETS.R2TYPE`` of an ``AnchorYoloConfig`` (JAX :126):
    depth 101 where the name holds "101", else 50; "next" in the name is
    Res2NeXt (base width 4, cardinality 8, the plain stem and a strided
    1x1 shortcut); otherwise base width 26, and the deep stem with the
    pooled shortcut for "v1b" and "v1d" (the JAX builder's reading: both
    are vd), the plain ones for any other name."""
    r2type = cfg.r2type
    depth = 101 if "101" in r2type else 50
    if "next" in r2type:
        return Res2Net(depth=depth, base_width=4, cardinality=8, vd=False,
                       out_features=cfg.resnet.out_features)
    return Res2Net(depth=depth, vd="v1d" in r2type or "v1b" in r2type,
                   out_features=cfg.resnet.out_features)
