"""ResNet-50/101 in detectron2's layout, with the PP-YOLO "vd" variant (JAX
``models/backbones/resnet.py``): the SparseInst and YOLOV7P ``r50.yaml``
backbone.

Module names are detectron2's, so that ``utils/weight_port.py``
``map_d2_resnet_name`` applies: ``stem.conv1`` (the vd stem also
``stem.conv2`` and ``stem.conv3``), ``res{2..5}.{i}.{conv1,conv2,conv3,
shortcut}``, each a convolution with its norm as the child ``norm``
(``res2.0.conv1.norm``). The vd shortcut average-pools before its 1x1
convolution, as the JAX block does (``AvgPool2d(2, 2, ceil_mode=True,
count_include_pad=False)``).

``MODEL.RESNETS.NORM`` "FrozenBN" (the default) gives
:class:`FrozenBatchNorm2d`: the running statistics always, in train mode
too. Its scale and bias are parameters and train, as the JAX step trains
the flax ``params`` of those layers (nothing in its optimizer masks them);
detectron2's ``FrozenBatchNorm2d`` would keep them fixed. Any other norm
is a trainable ``nn.BatchNorm2d`` on batch statistics (torch's update
rule, momentum 0.1 = flax 0.9).

A stage of ``deform_on_per_stage`` runs deformable convolutions (DCNv2,
``ops/deform_conv.py``) in its blocks' 3x3 where it has stride 1 (JAX
:67): ``conv2_dcn`` (the JAX names: its ``offset_conv`` and the fuse's
``weight`` and ``bias``) and ``conv2_bn``, the norm of the block's kind
(FrozenBN on its running statistics, else trained). The JAX ResNet builds
DCNv2 whatever ``MODEL.RESNETS.DEFORM_MODULATED`` and
``DEFORM_NUM_GROUPS`` say, and so does the port (ROADMAP.md C.34).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.ops.deform_conv import DeformConv

BN_EPS = 1e-5
STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
RESNET_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}
RESNET_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    """What the JAX builders read from ``MODEL.RESNETS``."""

    depth: int = 50
    vd: bool = False
    out_features: Tuple[str, ...] = ("res3", "res4", "res5")
    frozen_bn: bool = True            # NORM == "FrozenBN"
    stride_in_1x1: bool = True
    deform_on_per_stage: Tuple[bool, ...] = (False, False, False, False)

    @classmethod
    def from_cfg(cls, cfg, vd_builder: bool = False) -> "ResNetSpec":
        """What the JAX builders read: ``build_resnet_backbone`` (:157)
        every field; ``build_resnet_vd_backbone`` (:170, ``vd_builder``)
        forces vd and the stride on the 3x3, and ignores DCN. The port
        builds ``ResNet(spec)``."""
        r = cfg.MODEL.RESNETS
        vd = vd_builder or bool(r.VD)
        return cls(
            depth=int(r.DEPTH), vd=vd,
            out_features=tuple(r.OUT_FEATURES),
            frozen_bn=str(r.NORM) == "FrozenBN",
            stride_in_1x1=False if vd_builder else bool(r.STRIDE_IN_1X1),
            deform_on_per_stage=((False,) * 4 if vd_builder else
                                 tuple(bool(d) for d in
                                       r.DEFORM_ON_PER_STAGE)))


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on its running statistics in every mode: ``train()``
    leaves the module in eval. ``weight`` and ``bias`` are parameters
    (they train, as in the JAX package); the statistics are buffers that
    nothing updates. Computes in float32 over any input dtype, one
    rounding to it."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def train(self, mode: bool = True) -> "FrozenBatchNorm2d":
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            momentum=0.0, eps=self.eps)


class ConvNorm(nn.Conv2d):
    """detectron2's ``Conv2d`` with its norm as the child ``norm``:
    convolution (no bias, "same" padding), norm, optional ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 stride: int = 1, act: bool = True, frozen_bn: bool = True):
        super().__init__(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                         bias=False)
        self.norm = norm2d(c_out, frozen_bn)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(super().forward(x))
        return F.relu(x) if self.act else x


def norm2d(channels: int, frozen_bn: bool) -> nn.Module:
    """FrozenBN (running statistics always) or a trained BatchNorm."""
    return (FrozenBatchNorm2d(channels) if frozen_bn else
            nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (no ReLU), plus the shortcut, ReLU (JAX :52).
    ``stride_in_1x1`` puts the stride on the first 1x1 (detectron2's
    MSRA default), else on the 3x3. With ``deform`` the 3x3 is a
    deformable convolution where its stride is 1 (``conv2_dcn`` and
    ``conv2_bn``); a strided 3x3 stays plain. The vd shortcut average-pools
    by 2 (``ceil_mode``, padding not counted) and then projects."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 vd: bool = False, stride_in_1x1: bool = True,
                 frozen_bn: bool = True, deform: bool = False):
        super().__init__()
        mid = c_out // 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(c_in, mid, 1, s1, frozen_bn=frozen_bn)
        if deform and s3 == 1:
            self.conv2_dcn = DeformConv(mid, mid)
            self.conv2_bn = norm2d(mid, frozen_bn)
        else:
            self.conv2 = ConvNorm(mid, mid, 3, s3, frozen_bn=frozen_bn)
        self.conv3 = ConvNorm(mid, c_out, 1, 1, act=False,
                              frozen_bn=frozen_bn)
        self.pool_shortcut = vd and stride != 1
        self.shortcut = None
        if c_in != c_out or stride != 1:
            self.shortcut = ConvNorm(
                c_in, c_out, 1, 1 if self.pool_shortcut else stride,
                act=False, frozen_bn=frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        if hasattr(self, "conv2_dcn"):
            y = F.relu(self.conv2_bn(self.conv2_dcn(y)))
        else:
            y = self.conv2(y)
        y = self.conv3(y)
        sc = x
        if self.shortcut is not None:
            if self.pool_shortcut:
                sc = F.avg_pool2d(sc, 2, 2, ceil_mode=True,
                                  count_include_pad=False)
            sc = self.shortcut(sc)
        return F.relu(y + sc)


class Stem(nn.Module):
    """7x7 stride 2 (vd: 3x3 s2 to 32, 3x3 to 32, 3x3 to 64), then a 3x3
    stride-2 max-pool."""

    def __init__(self, vd: bool = False, frozen_bn: bool = True):
        super().__init__()
        if vd:
            self.conv1 = ConvNorm(3, 32, 3, 2, frozen_bn=frozen_bn)
            self.conv2 = ConvNorm(32, 32, 3, 1, frozen_bn=frozen_bn)
            self.conv3 = ConvNorm(32, 64, 3, 1, frozen_bn=frozen_bn)
        else:
            self.conv1 = ConvNorm(3, 64, 7, 2, frozen_bn=frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = conv(x)
        return F.max_pool2d(x, 3, 2, 1)


class ResNet(nn.Module):
    """Stem and four stages; returns ``{name: feature}`` for
    ``spec.out_features`` (NCHW). ``out_channels`` gives each stage's
    width. Every depth of ``STAGE_BLOCKS`` builds bottleneck blocks, as
    the JAX ResNet does; a stage of ``deform_on_per_stage`` takes
    deformable 3x3s."""

    def __init__(self, spec: ResNetSpec = ResNetSpec()):
        super().__init__()
        self.out_features = tuple(spec.out_features)
        self.out_channels: Dict[str, int] = dict(RESNET_CHANNELS)
        self.stem = Stem(spec.vd, spec.frozen_bn)
        c_in = 64
        for stage, (n, c) in enumerate(zip(STAGE_BLOCKS[spec.depth],
                                           RESNET_CHANNELS.values())):
            blocks = []
            for i in range(n):
                blocks.append(Bottleneck(
                    c_in, c, stride=(1 if stage == 0 or i else 2),
                    vd=spec.vd, stride_in_1x1=spec.stride_in_1x1,
                    frozen_bn=spec.frozen_bn,
                    deform=bool(spec.deform_on_per_stage[stage])))
                c_in = c
            self.add_module(f"res{stage + 2}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        out = {}
        for name in RESNET_CHANNELS:
            x = getattr(self, name)(x)
            if name in self.out_features:
                out[name] = x
        return out


def frozen_bn_buffers(model: nn.Module) -> Sequence[torch.Tensor]:
    """The running statistics of every :class:`FrozenBatchNorm2d`."""
    return [b for m in model.modules() if isinstance(m, FrozenBatchNorm2d)
            for b in (m.running_mean, m.running_var)]
