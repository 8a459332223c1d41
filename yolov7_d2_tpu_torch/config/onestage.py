"""The configurations of YOLOv6 and YOLOF.

Both subclass ``YoloxConfig``, so that the optimizer, the schedule and the
device photometric stage read the shared fields unchanged; ``from_cfg``
reads a merged ``CfgNode`` the way the JAX builders do.
``Yolov6Config``'s defaults are ``configs/coco/yolov6_s.yaml``,
``YolofConfig``'s ``configs/coco/yolof/yolof_R_50_DC5_1x.yaml``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig


@dataclasses.dataclass(frozen=True)
class Yolov6Config(YoloxConfig):
    """YOLOv6-s at 640: EfficientRep and RepPAN at width 0.5 and depth
    0.33, EffiDeHead; the JAX ``build_yolov6`` reads ``MODEL.YOLO.CLASSES``,
    ``WIDTH_MUL``, ``DEPTH_MUL`` and ``SOLVER.AMP.ENABLED``."""

    meta_architecture: str = "YOLOV6"
    backbone: str = "build_efficientrep_backbone"  # unread, as in JAX
    nms_threshold: float = 0.5
    base_lr: float = 0.01
    max_iter: int = 300000
    ema: bool = False


@dataclasses.dataclass(frozen=True)
class YolofConfig(YoloxConfig):
    """YOLOF R-50 at 800. The JAX ``build_yolof`` reads
    ``MODEL.RESNETS.DEPTH``, ``NORM`` and ``STRIDE_IN_1X1`` and nothing
    else of the backbone: not ``RES5_DILATION`` (res5 stays at stride 32)
    and not ``MODEL.BACKBONE.NAME``."""

    meta_architecture: str = "YOLOF"
    backbone: str = "build_resnet_backbone"
    depth_mul: float = 1.0
    width_mul: float = 1.0
    input_size: Tuple[int, int] = (800, 800)
    nms_threshold: float = 0.5
    lr_scheduler: str = "WarmupMultiStepLR"
    base_lr: float = 0.12
    max_iter: int = 22500
    lr_steps: Tuple[int, ...] = (15000, 20000)
    warmup_iters: int = 1500
    ema: bool = False
    resnet_depth: int = 50
    resnet_norm: str = "FrozenBN"
    stride_in_1x1: bool = True

    @classmethod
    def from_cfg(cls, cfg) -> "YolofConfig":
        """Read the fields from a merged ``CfgNode``."""
        base = YoloxConfig.from_cfg(cfg)
        r = cfg.MODEL.RESNETS
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(YoloxConfig)},
            resnet_depth=int(r.DEPTH), resnet_norm=str(r.NORM),
            stride_in_1x1=bool(r.STRIDE_IN_1X1))
