"""The configuration of the anchor-based YOLO family (``YOLO``, ``YOLOV7``,
``YOLOV7P``).

``AnchorYoloConfig`` subclasses ``YoloxConfig``, so that the optimizer, the
schedule and the device photometric stage read the shared fields
unchanged. Its defaults are ``configs/Base-YOLOv7.yaml`` merged with
``configs/coco/yolov7.yaml``; ``from_cfg`` reads a merged ``CfgNode``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig
from yolov7_d2_tpu_torch.models.backbones.resnet import ResNetSpec

Anchors = Tuple[Tuple[Tuple[float, float], ...], ...]


def anchors_from_cfg(cfg) -> Anchors:
    """``MODEL.YOLO.ANCHORS`` is deep-to-shallow in the reference; the
    models' level order is shallow-to-deep (strides 8, 16, 32) (JAX
    ``models/meta_arch/yolov7.py:232``)."""
    return tuple(tuple(tuple(a) for a in lvl)
                 for lvl in reversed(cfg.MODEL.YOLO.ANCHORS))


@dataclasses.dataclass(frozen=True)
class AnchorYoloConfig(YoloxConfig):
    """Defaults are YOLOV7 at 640: CSP-Darknet53, YOLOPAFPN at width and
    depth 1.0, the 3x3-tower anchor head, the v7 decode, max-IoU targets
    and the CIoU loss."""

    meta_architecture: str = "YOLOV7"
    backbone: str = "build_cspdarknet_backbone"
    depth_mul: float = 1.0
    width_mul: float = 1.0
    nms_threshold: float = 0.5
    base_lr: float = 0.01
    max_iter: int = 300000
    ema: bool = False

    # level order, strides 8, 16, 32: 3 (w, h) pairs each, input pixels
    anchors: Anchors = (
        ((10, 13), (16, 30), (33, 23)),
        ((30, 61), (62, 45), (42, 119)),
        ((116, 90), (156, 198), (373, 326)),
    )
    variant: str = "yolov7"          # MODEL.YOLO.VARIANT: yolov3 | yolov7
    iou_type: str = "ciou"
    loss_type: str = "v7"            # v4: BCE xy + MSE wh; else IoU loss
    ignore_threshold: float = 0.07   # as configured; the loss takes >= 0.5
    lambda_iou: float = 1.1
    lambda_conf: float = 1.0
    lambda_cls: float = 1.0
    lambda_xy: float = 1.0
    lambda_wh: float = 1.0
    build_target_type: str = "default"  # default (max IoU) | yolov5 (ratio)
    neck_type: str = "pafpn"         # MODEL.YOLO.NECK.TYPE
    with_spp: bool = False
    darknet_with_csp: bool = True
    stem_out_channels: int = 32
    darknet_out_features: Tuple[str, ...] = ("dark3", "dark4", "dark5")
    pixel_mean: Tuple[float, float, float] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    resnet: ResNetSpec = ResNetSpec()  # MODEL.RESNETS, for a ResNet trunk
    # MODEL.SWIN and MODEL.PVT, for a transformer trunk
    swin_type: str = "tiny"
    swin_patch: int = 4
    swin_window: int = 7
    swin_out_features: Tuple[int, ...] = (1, 2, 3)
    pvt_type: str = "b1"
    pvt_out_features: Tuple[int, ...] = (1, 2, 3)

    @classmethod
    def from_cfg(cls, cfg) -> "AnchorYoloConfig":
        """Read the fields from a merged ``CfgNode``."""
        base = YoloxConfig.from_cfg(cfg)
        yolo = cfg.MODEL.YOLO
        loss = yolo.LOSS
        darknet = cfg.MODEL.DARKNET
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(YoloxConfig)},
            anchors=anchors_from_cfg(cfg),
            variant=str(yolo.VARIANT),
            iou_type=str(yolo.IOU_TYPE),
            loss_type=str(yolo.LOSS_TYPE),
            ignore_threshold=float(yolo.IGNORE_THRESHOLD),
            lambda_iou=float(loss.LAMBDA_IOU),
            lambda_conf=float(loss.LAMBDA_CONF),
            lambda_cls=float(loss.LAMBDA_CLS),
            lambda_xy=float(loss.LAMBDA_XY),
            lambda_wh=float(loss.LAMBDA_WH),
            build_target_type=str(loss.BUILD_TARGET_TYPE),
            neck_type=str(yolo.NECK.TYPE),
            with_spp=bool(yolo.NECK.WITH_SPP),
            darknet_with_csp=bool(darknet.WITH_CSP),
            stem_out_channels=int(darknet.STEM_OUT_CHANNELS),
            darknet_out_features=tuple(darknet.OUT_FEATURES),
            pixel_mean=tuple(float(v) for v in cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(float(v) for v in cfg.MODEL.PIXEL_STD),
            resnet=ResNetSpec.from_cfg(
                cfg, vd_builder=(cfg.MODEL.BACKBONE.NAME
                                 == "build_resnet_vd_backbone")),
            swin_type=str(cfg.MODEL.SWIN.TYPE),
            swin_patch=int(cfg.MODEL.SWIN.PATCH),
            swin_window=int(cfg.MODEL.SWIN.WINDOW),
            swin_out_features=tuple(int(s)
                                    for s in cfg.MODEL.SWIN.OUT_FEATURES),
            pvt_type=str(cfg.MODEL.PVT.TYPE),
            pvt_out_features=tuple(int(s)
                                   for s in cfg.MODEL.PVT.OUT_FEATURES),
        )
