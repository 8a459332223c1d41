"""The YOLOX serving configuration of the port.

Counterpart of ``yolov7_d2_tpu/config/defaults.py:175-188`` merged with
``configs/coco/yolox_s.yaml``. The JAX package reads its settings from a
``CfgNode``, whose module imports PyYAML at the top; the port's main path
keeps to a frozen dataclass instead, so that it needs neither PyYAML nor
OpenCV. ``YoloxConfig.from_cfg`` reads a merged ``CfgNode`` where one exists.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class YoloxConfig:
    """Defaults are YOLOX-s at 640 (configs/coco/yolox_s.yaml)."""

    meta_architecture: str = "YOLOX"
    backbone: str = "build_cspdarknetx_backbone"
    num_classes: int = 80
    depth_mul: float = 0.33
    width_mul: float = 0.50
    in_features: Tuple[str, ...] = ("dark3", "dark4", "dark5")
    depthwise: bool = False
    normalize_input: bool = False
    input_size: Tuple[int, int] = (640, 640)  # (h, w)
    padded_value: int = 114
    conf_threshold: float = 0.01
    nms_threshold: float = 0.65
    max_detections: int = 100
    pre_nms_topk: int = 1024
    amp: bool = True  # SOLVER.AMP.ENABLED: bf16 compute, f32 parameters

    @classmethod
    def from_cfg(cls, cfg) -> "YoloxConfig":
        """Read the fields from a merged ``CfgNode`` of the JAX package."""
        yolo = cfg.MODEL.YOLO
        return cls(
            meta_architecture=cfg.MODEL.META_ARCHITECTURE,
            backbone=cfg.MODEL.BACKBONE.NAME,
            num_classes=int(yolo.CLASSES),
            depth_mul=float(yolo.DEPTH_MUL),
            width_mul=float(yolo.WIDTH_MUL),
            in_features=tuple(yolo.IN_FEATURES),
            depthwise=bool(cfg.MODEL.DARKNET.DEPTH_WISE),
            normalize_input=bool(yolo.NORMALIZE_INPUT),
            input_size=tuple(int(s) for s in cfg.INPUT.INPUT_SIZE),
            padded_value=int(cfg.MODEL.PADDED_VALUE),
            conf_threshold=float(yolo.CONF_THRESHOLD),
            nms_threshold=float(yolo.NMS_THRESHOLD),
            max_detections=int(yolo.MAX_DETECTIONS),
            pre_nms_topk=int(yolo.NMS_PRE_TOPK),
            amp=bool(cfg.SOLVER.AMP.ENABLED),
        )
