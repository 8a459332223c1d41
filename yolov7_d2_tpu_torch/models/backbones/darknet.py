"""Darknet-53 and its PP-YOLO CSP variant, the trunks of YOLO v3 and YOLOV7
(JAX ``models/backbones/darknet.py``).

Module names are those of the original reference, so that the JAX
package's name maps apply (``utils/weight_port.py``): plain Darknet uses
``stem``, ``dark{i}.0`` (the stride-2 conv) and ``dark{i}.{j}.layer{k}``
(``map_darknet_torch_name``); CSP uses ``conv1`` / ``bn1`` (the stem),
``layer{i}.{base_layer,partial_transition1,partial_transition2,
fuse_transition}.{0,1}`` and ``layer{i}.stage_layers.{j}.{downsample.{0,1},
conv{k},bn{k}}`` (``map_cspdarknet_torch_name``).

BatchNorm eps as in the JAX package: ``bn_eps`` (1e-5, torch's default)
for plain Darknet and for the stem; 1e-4 for the CSP stages, whose
activation is mish. ``build_cspdarknet_backbone`` builds the stem with
1e-4 too; the ``AnchorYOLO`` models build it with 1e-5.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import (
    BN_MOMENTUM,
    BaseConv,
    get_activation,
)

DARKNET53_CHANNELS = {"dark3": 256, "dark4": 512, "dark5": 1024}
CSP_EPS = 1e-4


def _conv_bn_mish(c_in: int, c_out: int, ksize: int,
                  stride: int = 1) -> nn.Sequential:
    """conv (no bias), BatchNorm eps 1e-4, mish: indices 0, 1, 2 as the
    reference's ``ConvNormActivation``."""
    return nn.Sequential(
        nn.Conv2d(c_in, c_out, ksize, stride, (ksize - 1) // 2, bias=False),
        nn.BatchNorm2d(c_out, eps=CSP_EPS, momentum=BN_MOMENTUM),
        nn.Mish())


class DarkResidual(nn.Module):
    """1x1 squeeze, 3x3 expand, residual (JAX ``DarkResidual``)."""

    def __init__(self, channels: int, act: str = "lrelu",
                 bn_eps: float = 1e-5):
        super().__init__()
        self.layer1 = BaseConv(channels, channels // 2, 1, 1, act=act,
                               bn_eps=bn_eps)
        self.layer2 = BaseConv(channels // 2, channels, 3, 1, act=act,
                               bn_eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer2(self.layer1(x))


class PPDarkBlock(nn.Module):
    """The PP-YOLO CSP DarkBlock (JAX ``PPDarkBlock``): an optional 1x1
    downsample, then 1x1 (width -> squeeze) and 3x3 (squeeze -> width),
    mish, the residual after the downsample."""

    def __init__(self, c_in: int, squeeze: int, width: int,
                 use_down: bool = False):
        super().__init__()
        self.downsample = _conv_bn_mish(c_in, width, 1) if use_down else None
        self.conv1 = nn.Conv2d(width, squeeze, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(squeeze, eps=CSP_EPS, momentum=BN_MOMENTUM)
        self.conv2 = nn.Conv2d(squeeze, width, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=CSP_EPS, momentum=BN_MOMENTUM)
        self.act = nn.Mish()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        y = self.act(self.bn1(self.conv1(x)))
        return x + self.act(self.bn2(self.conv2(y)))


class CSPDarkStage(nn.Module):
    """CrossStagePartialBlock (JAX ``CSPDarkStage``): a stride-2 base conv,
    two partial transitions, DarkBlocks on the second, concat [blocks,
    transition 1], 1x1 fuse. The first stage keeps full width in its
    blocks, the later ones run them at half width."""

    def __init__(self, inplanes: int, planes: int, num_blocks: int,
                 first: bool = False):
        super().__init__()
        inner = planes if first else inplanes
        out1 = planes if first else inplanes
        self.base_layer = _conv_bn_mish(inplanes, planes, 3, 2)
        self.partial_transition1 = _conv_bn_mish(planes, out1, 1)
        self.stage_layers = nn.Sequential(*[
            PPDarkBlock(planes if j == 0 else inner, inplanes, inner,
                        use_down=(j == 0))
            for j in range(num_blocks)])
        self.partial_transition2 = _conv_bn_mish(inner, inner, 1)
        self.fuse_transition = _conv_bn_mish(inner + out1, planes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.base_layer(x)
        out1 = self.partial_transition1(x)
        out2 = self.partial_transition2(self.stage_layers(x))
        return self.fuse_transition(torch.cat([out2, out1], dim=1))


class Darknet53(nn.Module):
    """Darknet-53 (``with_csp=False``: residual stages, ``act``) or the
    PP-YOLO CSP-Darknet53 (``with_csp=True``: CSP stages with mish and a
    mish stem). Returns the features named in ``out_features``;
    ``out_channels`` gives each feature's channels."""

    def __init__(self, stem_out_channels: int = 32,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 with_csp: bool = False, act: str = "lrelu",
                 stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 bn_eps: float = 1e-5):
        super().__init__()
        self.out_features = tuple(out_features)
        self.with_csp = with_csp
        c = stem_out_channels
        channels = {}
        if with_csp:
            self.conv1 = nn.Conv2d(3, c, 3, 1, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(c, eps=bn_eps, momentum=BN_MOMENTUM)
            self.stem_act = get_activation("mish")
            inplanes = c
            for i, nblocks in enumerate(stage_blocks):
                planes = 64 * 2 ** i
                setattr(self, f"layer{i + 1}",
                        CSPDarkStage(inplanes, planes, nblocks, i == 0))
                channels[f"dark{i + 1}"] = inplanes = planes
        else:
            self.stem = BaseConv(3, c, 3, 1, act=act, bn_eps=bn_eps)
            for i, nblocks in enumerate(stage_blocks):
                setattr(self, f"dark{i + 1}", nn.Sequential(
                    BaseConv(c, 2 * c, 3, 2, act=act, bn_eps=bn_eps),
                    *[DarkResidual(2 * c, act, bn_eps)
                      for _ in range(nblocks)]))
                c *= 2
                channels[f"dark{i + 1}"] = c
        self.num_stages = len(stage_blocks)
        self.out_channels = {k: v for k, v in channels.items()
                             if k in self.out_features}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.with_csp:
            x = self.stem_act(self.bn1(self.conv1(x)))
            stages = (f"layer{i + 1}" for i in range(self.num_stages))
        else:
            x = self.stem(x)
            stages = (f"dark{i + 1}" for i in range(self.num_stages))
        outputs = {}
        for i, name in enumerate(stages):
            x = getattr(self, name)(x)
            if f"dark{i + 1}" in self.out_features:
                outputs[f"dark{i + 1}"] = x
        return outputs


def build_darknet_backbone(cfg) -> Darknet53:
    """Darknet-53 from an ``AnchorYoloConfig`` (JAX
    ``build_darknet_backbone``): CSP if ``darknet_with_csp``."""
    return Darknet53(stem_out_channels=cfg.stem_out_channels,
                     out_features=cfg.darknet_out_features,
                     with_csp=cfg.darknet_with_csp)


def build_cspdarknet_backbone(cfg) -> Darknet53:
    """The PP-YOLO CSP-Darknet53 (JAX ``build_cspdarknet_backbone``), its
    stem at eps 1e-4 too."""
    return Darknet53(stem_out_channels=cfg.stem_out_channels,
                     out_features=cfg.darknet_out_features,
                     with_csp=True, act="silu", bn_eps=CSP_EPS)
