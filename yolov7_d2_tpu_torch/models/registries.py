"""The backbone, neck and head registries filled (the JAX
``BACKBONE_REGISTRY``, ``NECK_REGISTRY`` and ``HEAD_REGISTRY`` of
``core/registry.py:79-81``, under the JAX builders' names). Importing this
module registers every builder; the registries are ``models.build``'s.

Each builder takes a merged ``CfgNode``, reads what the JAX builder of its
name reads, and returns the port module that the JAX builder's flax module
corresponds to, with the same output features. flax infers a neck's input
widths at its first call; the port's necks are told them:
``feat_channels`` (or ``in_channels``) are the backbone's, shallow to
deep, and the semantic head's ``in_channels`` the FPN's width.

:func:`build_backbone` is the one backbone table of the builders that
take any registered name (YOLOX, YOLOV7 / YOLOV7P, the d2go DETR), as
their JAX builders resolve any name through ``BACKBONE_REGISTRY``: every
backbone it gives has ``out_channels`` ({feature: width}).
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from yolov7_d2_tpu_torch.config.anchor_yolo import AnchorYoloConfig
from yolov7_d2_tpu_torch.config.yolox import YoloxConfig
from yolov7_d2_tpu_torch.models.backbones import zoo  # noqa: F401
from yolov7_d2_tpu_torch.models.backbones.darknet import (
    build_cspdarknet_backbone,
    build_darknet_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.darknetx import CSPDarknetX
from yolov7_d2_tpu_torch.models.backbones.efficientrep import (
    build_efficientrep_backbone,
    build_efficientrep_tiny_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.mobile import (
    build_cspresnet50d_backbone,
    build_fbnet_fpn_backbone,
    build_mobilevit_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.pvt_v2 import build_pvt_v2_backbone
from yolov7_d2_tpu_torch.models.backbones.res2net import (
    build_res2net_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.resnet import ResNet, ResNetSpec
from yolov7_d2_tpu_torch.models.backbones.swin import (
    build_swin_transformer_backbone,
)
from yolov7_d2_tpu_torch.models.backbones.yolov5 import (
    build_yolov5_backbone,
)
from yolov7_d2_tpu_torch.models.build import (
    BACKBONE_REGISTRY,
    HEAD_REGISTRY,
    META_ARCH_REGISTRY,
    NECK_REGISTRY,
)
from yolov7_d2_tpu_torch.models.heads.sem_seg_head import SemSegFPNHead
from yolov7_d2_tpu_torch.models.necks import fpn  # noqa: F401
from yolov7_d2_tpu_torch.models.necks.bifpn import BiFPN
from yolov7_d2_tpu_torch.models.necks.reppan import PPYOLOPAN, RepPANNeck
from yolov7_d2_tpu_torch.models.necks.yolo_fpn import YOLOFPN
from yolov7_d2_tpu_torch.models.necks.yolo_pafpn import YOLOPAFPN

__all__ = ["BACKBONE_REGISTRY", "HEAD_REGISTRY", "META_ARCH_REGISTRY",
           "NECK_REGISTRY", "build_backbone"]


def _register_from_fields(name: str, builder, fields_type=AnchorYoloConfig
                          ) -> None:
    """``builder`` takes the fields of a ``fields_type`` config (the
    port's builders of the anchor family's backbones take an
    ``AnchorYoloConfig``); its registry entry reads them from the merged
    ``CfgNode``, and :func:`build_backbone` hands a config of that type
    straight to ``builder`` (``from_fields``)."""
    def build(cfg):
        return builder(fields_type.from_cfg(cfg))

    build.__doc__ = builder.__doc__
    build.from_fields, build.fields_type = builder, fields_type
    BACKBONE_REGISTRY.register(build, name=name)


for _builder in (build_darknet_backbone, build_cspdarknet_backbone,
                 build_efficientrep_backbone,
                 build_efficientrep_tiny_backbone, build_yolov5_backbone,
                 build_res2net_backbone, build_swin_transformer_backbone,
                 build_pvt_v2_backbone):
    _register_from_fields(_builder.__name__, _builder)


def _cspdarknetx(cfg: YoloxConfig) -> CSPDarknetX:
    """JAX ``darknetx.py:96``: at ``MODEL.YOLO``'s multipliers."""
    return CSPDarknetX(cfg.depth_mul, cfg.width_mul, cfg.in_features,
                       cfg.depthwise)


_register_from_fields("build_cspdarknetx_backbone", _cspdarknetx,
                      YoloxConfig)


@BACKBONE_REGISTRY.register(name="build_resnet_backbone")
def _resnet(cfg) -> ResNet:
    """JAX ``resnet.py:158``."""
    return ResNet(ResNetSpec.from_cfg(cfg))


@BACKBONE_REGISTRY.register(name="build_resnet_vd_backbone")
def _resnet_vd(cfg) -> ResNet:
    """JAX ``resnet.py:171``: vd, the stride in the 3x3, no DCN."""
    return ResNet(ResNetSpec.from_cfg(cfg, vd_builder=True))


# an AnchorYoloConfig carries the ResNet it reads (``resnet``, vd by the
# registry name)
for _entry in (_resnet, _resnet_vd):
    _entry.from_fields = lambda cfg: ResNet(cfg.resnet)
    _entry.fields_type = AnchorYoloConfig


BACKBONE_REGISTRY.register(build_fbnet_fpn_backbone, name="FBNetV2FpnBackbone")
BACKBONE_REGISTRY.register(build_mobilevit_backbone)
BACKBONE_REGISTRY.register(build_cspresnet50d_backbone)


def _cfg_node(cfg: YoloxConfig):
    """The merged ``CfgNode`` ``cfg`` was read from; for a config made
    without one, ``get_cfg``'s defaults with the config's backbone name
    and YOLO fields."""
    if cfg.cfg_node is not None:
        return cfg.cfg_node
    from yolov7_d2_tpu_torch.config.defaults import get_cfg

    node = get_cfg()
    node.MODEL.BACKBONE.NAME = cfg.backbone
    node.MODEL.YOLO.DEPTH_MUL = cfg.depth_mul
    node.MODEL.YOLO.WIDTH_MUL = cfg.width_mul
    node.MODEL.YOLO.IN_FEATURES = list(cfg.in_features)
    node.MODEL.DARKNET.DEPTH_WISE = cfg.depthwise
    return node


def build_backbone(cfg: YoloxConfig) -> nn.Module:
    """The registered backbone ``cfg.backbone`` names, for a model config
    (``YoloxConfig`` or a subclass), as the JAX builders take it from
    ``BACKBONE_REGISTRY``: the zoo from ``cfg.zoo``, a builder of
    dataclass fields from ``cfg`` where it is of the entry's type (the
    anchor family's backbones from an ``AnchorYoloConfig``, CSPDarknet-X
    from any config), every other one from the merged ``CfgNode`` of
    ``cfg`` (:func:`_cfg_node`). An unregistered name raises, naming it."""
    name = cfg.backbone
    if name not in BACKBONE_REGISTRY:
        raise NotImplementedError(
            f"backbone {name!r} is not a registered backbone; the registry "
            f"has {sorted(BACKBONE_REGISTRY.keys())}")
    entry = BACKBONE_REGISTRY.get(name)
    if isinstance(cfg, getattr(entry, "fields_type", ())):
        return entry.from_fields(cfg)
    return entry(_cfg_node(cfg))


@NECK_REGISTRY.register()
def build_yolo_pafpn(cfg, feat_channels: Optional[Sequence[int]] = None
                     ) -> YOLOPAFPN:
    """JAX ``yolo_pafpn.py:84``; ``feat_channels`` default to the neck's
    own widths (YOLOX's CSPDarknet-X)."""
    return YOLOPAFPN(depth=float(cfg.MODEL.YOLO.DEPTH_MUL),
                     width=float(cfg.MODEL.YOLO.WIDTH_MUL),
                     depthwise=bool(cfg.MODEL.DARKNET.DEPTH_WISE),
                     feat_channels=feat_channels)


@NECK_REGISTRY.register()
def build_yolo_fpn(cfg, in_channels: Sequence[int] = (256, 512, 1024)
                   ) -> YOLOFPN:
    """JAX ``yolo_fpn.py:84``; ``in_channels`` default to Darknet-53's."""
    return YOLOFPN(tuple(in_channels),
                   with_spp=bool(cfg.MODEL.YOLO.NECK.WITH_SPP))


@NECK_REGISTRY.register()
def build_bifpn(cfg, feat_channels: Sequence[int]) -> BiFPN:
    """JAX ``bifpn.py:180``."""
    b = cfg.MODEL.BIFPN
    return BiFPN(tuple(feat_channels), int(b.OUT_CHANNELS),
                 int(b.NUM_BIFPN), int(b.NUM_LEVELS), str(b.NORM),
                 bool(b.SEPARABLE_CONV))


@NECK_REGISTRY.register()
def build_reppan(cfg, feat_channels: Sequence[int]) -> RepPANNeck:
    """JAX ``reppan.py:190``."""
    return RepPANNeck(tuple(feat_channels),
                      width_mul=float(cfg.MODEL.YOLO.WIDTH_MUL),
                      depth_mul=float(cfg.MODEL.YOLO.DEPTH_MUL))


@NECK_REGISTRY.register()
def build_ppyolo_pan(cfg, feat_channels: Sequence[int]) -> PPYOLOPAN:
    """JAX ``reppan.py:199``."""
    return PPYOLOPAN(tuple(feat_channels),
                     with_spp=bool(cfg.MODEL.YOLO.NECK.WITH_SPP))


@HEAD_REGISTRY.register()
def build_sem_seg_head(cfg, in_channels: int = 256) -> SemSegFPNHead:
    """JAX ``sem_seg_head.py:58``: the head at its defaults (54 stuff
    classes, 128 channels, common stride 4)."""
    return SemSegFPNHead(in_channels)
