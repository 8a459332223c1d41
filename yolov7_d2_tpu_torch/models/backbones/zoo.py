"""The backbone zoo under the ported heads: RegNet, ConvNeXt, EfficientNet,
FBNet and DLA, by the registry names the yamls give
``MODEL.BACKBONE.NAME`` (the JAX ``BACKBONE_REGISTRY`` entries of those
modules). YOLOX, YOLOV7 and the d2go DETR take any of them, as their JAX
builders take any registered backbone.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from yolov7_d2_tpu_torch.models.backbones.convnext import (
    build_convnext_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.dla import (
    build_dla_backbone,
    build_dla_fpn3_backbone,
    build_dlaup_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.efficientnet import (
    build_efficientnet_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.mobile import build_fbnet_backbone
from yolov7_d2_tpu_torch.models.backbones.regnet import build_regnet_backbone

# registry name -> (the weight carrier's backbone type, builder of a ZooSpec)
ZOO_BACKBONES = {
    "build_regnet_backbone": ("regnet", build_regnet_backbone),
    "build_convnext_backbone": ("convnext", build_convnext_backbone),
    "build_efficientnet_backbone": ("efficientnet",
                                    build_efficientnet_backbone),
    "build_fbnet_backbone": ("fbnet", build_fbnet_backbone),
    # the reference's registry name of the plain FBNet trunk (JAX :526)
    "FBNetV2C4Backbone": ("fbnet", build_fbnet_backbone),
    # DLA (JAX models/backbones/dla.py:375-407): the trunk, DLASeg, DLAUp
    "build_dla_backbone": ("dla", build_dla_backbone),
    "build_dla_fpn3_backbone": ("dla", build_dla_fpn3_backbone),
    "build_dlaup_backbone": ("dla", build_dlaup_backbone),
}


def zoo_backbone_type(name: str) -> Optional[str]:
    """The backbone type of the registry name ``name``, None outside the
    zoo."""
    entry = ZOO_BACKBONES.get(name)
    return None if entry is None else entry[0]


def build_zoo_backbone(cfg) -> nn.Module:
    """The zoo backbone ``cfg.backbone`` names, from ``cfg.zoo``; it has
    ``out_channels`` ({feature: width})."""
    return ZOO_BACKBONES[cfg.backbone][1](cfg.zoo)
