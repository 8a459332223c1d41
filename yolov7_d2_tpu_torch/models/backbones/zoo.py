"""The backbone zoo under the ported heads: RegNet, ConvNeXt, EfficientNet,
FBNet and DLA, by the registry names the yamls give
``MODEL.BACKBONE.NAME`` (the JAX ``BACKBONE_REGISTRY`` entries of those
modules). YOLOX, YOLOV7 and the d2go DETR take any of them, as their JAX
builders take any registered backbone.

The names live in ``models.build.BACKBONE_REGISTRY``, as the registry's
other backbones do: each entry builds from a merged ``CfgNode`` and
carries the weight carrier's backbone type (``kind``) and the builder of
a ``ZooSpec`` (``from_spec``), which ``models/registries.build_backbone``
calls with a model config's ``zoo``. :data:`ZOO_BACKBONES` is the
registry's view of those entries.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from torch import nn

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig, ZooSpec
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
from yolov7_d2_tpu_torch.models.build import BACKBONE_REGISTRY


def _register(name: str, kind: str, from_spec: Callable) -> None:
    def build(cfg) -> nn.Module:
        """The zoo backbone from a merged ``CfgNode``."""
        return from_spec(ZooSpec.from_cfg(cfg))

    build.kind, build.from_spec = kind, from_spec
    # a model config carries its zoo options (``cfg.zoo``)
    build.from_fields, build.fields_type = (lambda c: from_spec(c.zoo),
                                            YoloxConfig)
    BACKBONE_REGISTRY.register(build, name=name)


for _name, _kind, _from_spec in (
        ("build_regnet_backbone", "regnet", build_regnet_backbone),
        ("build_convnext_backbone", "convnext", build_convnext_backbone),
        ("build_efficientnet_backbone", "efficientnet",
         build_efficientnet_backbone),
        ("build_fbnet_backbone", "fbnet", build_fbnet_backbone),
        # the reference's registry name of the plain FBNet trunk (JAX :526)
        ("FBNetV2C4Backbone", "fbnet", build_fbnet_backbone),
        # DLA (JAX models/backbones/dla.py:375-407): the trunk, DLASeg, DLAUp
        ("build_dla_backbone", "dla", build_dla_backbone),
        ("build_dla_fpn3_backbone", "dla", build_dla_fpn3_backbone),
        ("build_dlaup_backbone", "dla", build_dlaup_backbone)):
    _register(_name, _kind, _from_spec)

# registry name -> (the weight carrier's backbone type, builder of a ZooSpec)
ZOO_BACKBONES: Dict[str, Tuple[str, Callable]] = {
    name: (build.kind, build.from_spec) for name, build in BACKBONE_REGISTRY
    if hasattr(build, "from_spec")}


def build_zoo_backbone(cfg) -> nn.Module:
    """The zoo backbone ``cfg.backbone`` names, from ``cfg.zoo``; it has
    ``out_channels`` ({feature: width})."""
    return ZOO_BACKBONES[cfg.backbone][1](cfg.zoo)
