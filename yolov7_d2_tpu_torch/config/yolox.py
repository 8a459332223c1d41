"""The YOLOX configuration of the port: serving and the training step.

Counterpart of ``yolov7_d2_tpu/config/defaults.py`` (``MODEL.YOLO``,
``INPUT``, ``SOLVER``) merged with ``configs/coco/yolox_s.yaml``. The
config tree (``config/defaults.get_cfg``, a ``CfgNode``) imports PyYAML;
the model, the training step and serving read this frozen dataclass
instead, so that they need neither PyYAML nor OpenCV.
``YoloxConfig.from_cfg`` reads a merged ``CfgNode``, as the entry points
(``train_det``, ``demo``) do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ZooSpec:
    """What the backbone zoo's builders read (``models/backbones/zoo.py``):
    ``MODEL.REGNETS``, ``MODEL.CONVNEXT`` (``LAYER_SCALE_INIT_VALUE`` is
    read by no JAX builder), ``MODEL.EFFICIENTNET``, ``MODEL.FBNET_V2``
    (``ARCH_DEF`` a tuple of the yaml's dicts) and ``MODEL.DLA``."""

    regnet_type: str = "x"
    regnet_out_features: Tuple[str, ...] = ("s2", "s3", "s4")
    convnext_type: str = "tiny"
    convnext_drop_path_rate: float = 0.2
    convnext_out_features: Tuple[int, ...] = (1, 2, 3)
    efficientnet_name: str = "efficientnet_b0"
    efficientnet_out_features: Tuple[str, ...] = (
        "stride4", "stride8", "stride16", "stride32")
    efficientnet_feature_indices: Tuple[int, ...] = (1, 4, 10, 15)
    fbnet_arch: str = "default"
    fbnet_arch_def: Tuple[dict, ...] = ()
    fbnet_out_features: Tuple[str, ...] = ("trunk3",)
    fbnet_scale_factor: float = 1.0
    dla_num_layers: int = 34
    dla_out_features: Tuple[str, ...] = ("dla2",)
    dla_use_dla_up: bool = True
    dla_ms_output: bool = False
    dla_norm: str = "BN"

    @classmethod
    def from_cfg(cls, cfg) -> "ZooSpec":
        m = cfg.MODEL
        return cls(
            regnet_type=str(m.REGNETS.TYPE),
            regnet_out_features=tuple(m.REGNETS.OUT_FEATURES),
            convnext_type=str(m.CONVNEXT.TYPE),
            convnext_drop_path_rate=float(m.CONVNEXT.DROP_PATH_RATE),
            convnext_out_features=tuple(int(s)
                                        for s in m.CONVNEXT.OUT_FEATURES),
            efficientnet_name=str(m.EFFICIENTNET.NAME),
            efficientnet_out_features=tuple(m.EFFICIENTNET.OUT_FEATURES),
            efficientnet_feature_indices=tuple(
                int(i) for i in m.EFFICIENTNET.FEATURE_INDICES),
            fbnet_arch=str(m.FBNET_V2.ARCH),
            fbnet_arch_def=tuple(dict(d) for d in m.FBNET_V2.ARCH_DEF),
            fbnet_out_features=tuple(m.FBNET_V2.OUT_FEATURES),
            fbnet_scale_factor=float(m.FBNET_V2.SCALE_FACTOR),
            dla_num_layers=int(m.DLA.NUM_LAYERS),
            dla_out_features=tuple(m.DLA.OUT_FEATURES),
            dla_use_dla_up=bool(m.DLA.USE_DLA_UP),
            dla_ms_output=bool(m.DLA.MS_OUTPUT),
            dla_norm=str(m.DLA.NORM),
        )


@dataclasses.dataclass(frozen=True)
class YoloxConfig:
    """Defaults are YOLOX-s at 640 (configs/coco/yolox_s.yaml)."""

    meta_architecture: str = "YOLOX"
    backbone: str = "build_cspdarknetx_backbone"
    num_classes: int = 80
    depth_mul: float = 0.33
    width_mul: float = 0.50
    in_features: Tuple[str, ...] = ("dark3", "dark4", "dark5")
    zoo: ZooSpec = ZooSpec()  # the zoo backbones' options
    depthwise: bool = False
    normalize_input: bool = False
    input_size: Tuple[int, int] = (640, 640)  # (h, w)
    padded_value: int = 114
    conf_threshold: float = 0.01
    nms_threshold: float = 0.65
    max_detections: int = 100
    pre_nms_topk: int = 1024
    amp: bool = True  # SOLVER.AMP.ENABLED: bf16 compute, f32 parameters

    # training: targets and assignment (MODEL.YOLO)
    max_boxes: int = 100
    simota_prefilter_topk: int = 0  # 0 auto, < 0 off (engine.py)
    # training: the device photometric stage (INPUT)
    mixup: bool = True
    aug_disable_at_iter: int = 120000  # also where the L1 term turns on
    flip_prob: float = 0.5  # 0 when RANDOM_FLIP_HORIZONTAL is off
    distortion: bool = False
    # the HSV draws' ranges (INPUT.DISTORTION)
    distortion_hue: float = 0.1
    distortion_saturation: float = 1.5
    distortion_exposure: float = 1.5
    grid_mask: bool = False
    grid_mask_mode: int = 1
    grid_mask_prob: float = 0.3
    grid_mask_use_height: bool = True
    grid_mask_use_width: bool = True
    # training: optimizer and schedule (SOLVER)
    optimizer: str = "sgd"          # or "adamw"
    adam_bf16_state: bool = False   # AdamW's first moment in bfloat16
    base_lr: float = 0.02
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 5e-4
    # d2's rule: a decay of None in the CfgNode is weight_decay
    weight_decay_norm: float = 0.0
    weight_decay_bias: float = 5e-4
    bias_lr_factor: float = 1.0
    lr_multiplier_overwrite: Tuple[Tuple[str, float], ...] = ()
    backbone_multiplier: float = 1.0
    lr_scheduler: str = "WarmupCosineLR"
    max_iter: int = 150000
    lr_steps: Tuple[int, ...] = (60000, 80000)
    lr_gamma: float = 0.1
    warmup_iters: int = 1000
    warmup_factor: float = 0.001
    warmup_method: str = "linear"
    clip_gradients: bool = False
    clip_type: str = "full_model"  # or "value"
    clip_value: float = 1.0
    ema: bool = True
    ema_decay: float = 0.9998
    # the merged CfgNode the fields were read from (``from_cfg``): a
    # registered backbone that the fields above do not describe builds
    # from it (``models/registries.build_backbone``)
    cfg_node: Optional[Any] = dataclasses.field(default=None, compare=False,
                                                repr=False)

    @classmethod
    def from_cfg(cls, cfg) -> "YoloxConfig":
        """Read the fields from a merged ``CfgNode`` of the JAX package."""
        yolo = cfg.MODEL.YOLO
        inp = cfg.INPUT
        solver = cfg.SOLVER
        grid = inp.GRID_MASK
        flip = inp.RANDOM_FLIP_HORIZONTAL
        wd = float(solver.WEIGHT_DECAY or 0.0)

        def decay(v):
            return wd if v is None else float(v)

        return cls(
            meta_architecture=cfg.MODEL.META_ARCHITECTURE,
            backbone=cfg.MODEL.BACKBONE.NAME,
            num_classes=int(yolo.CLASSES),
            depth_mul=float(yolo.DEPTH_MUL),
            width_mul=float(yolo.WIDTH_MUL),
            in_features=tuple(yolo.IN_FEATURES),
            zoo=ZooSpec.from_cfg(cfg),
            depthwise=bool(cfg.MODEL.DARKNET.DEPTH_WISE),
            normalize_input=bool(yolo.NORMALIZE_INPUT),
            input_size=tuple(int(s) for s in cfg.INPUT.INPUT_SIZE),
            padded_value=int(cfg.MODEL.PADDED_VALUE),
            conf_threshold=float(yolo.CONF_THRESHOLD),
            nms_threshold=float(yolo.NMS_THRESHOLD),
            max_detections=int(yolo.MAX_DETECTIONS),
            pre_nms_topk=int(yolo.NMS_PRE_TOPK),
            amp=bool(solver.AMP.ENABLED),
            max_boxes=int(yolo.MAX_BOXES_NUM),
            simota_prefilter_topk=int(yolo.SIMOTA_PREFILTER_TOPK),
            mixup=bool(inp.MOSAIC_AND_MIXUP.ENABLE_MIXUP),
            aug_disable_at_iter=int(inp.MOSAIC_AND_MIXUP.DISABLE_AT_ITER),
            flip_prob=float(flip.PROB) if flip.ENABLED else 0.0,
            distortion=bool(inp.DISTORTION.ENABLED),
            distortion_hue=float(inp.DISTORTION.HUE),
            distortion_saturation=float(inp.DISTORTION.SATURATION),
            distortion_exposure=float(inp.DISTORTION.EXPOSURE),
            grid_mask=bool(grid.ENABLED),
            grid_mask_mode=int(grid.MODE),
            grid_mask_prob=float(grid.PROB),
            grid_mask_use_height=bool(grid.USE_HEIGHT),
            grid_mask_use_width=bool(grid.USE_WIDTH),
            optimizer=str(solver.OPTIMIZER).lower(),
            adam_bf16_state=bool(solver.ADAM_BF16_STATE),
            base_lr=float(solver.BASE_LR),
            momentum=float(solver.MOMENTUM),
            nesterov=bool(solver.NESTEROV),
            weight_decay=wd,
            weight_decay_norm=decay(solver.WEIGHT_DECAY_NORM),
            weight_decay_bias=decay(solver.WEIGHT_DECAY_BIAS),
            bias_lr_factor=float(solver.BIAS_LR_FACTOR),
            lr_multiplier_overwrite=tuple(
                (str(k), float(v)) for entry in solver.LR_MULTIPLIER_OVERWRITE
                for k, v in dict(entry).items()),
            backbone_multiplier=float(solver.BACKBONE_MULTIPLIER),
            lr_scheduler=str(solver.LR_SCHEDULER_NAME),
            max_iter=int(solver.MAX_ITER),
            lr_steps=tuple(int(s) for s in solver.STEPS),
            lr_gamma=float(solver.GAMMA),
            warmup_iters=int(solver.WARMUP_ITERS),
            warmup_factor=float(solver.WARMUP_FACTOR),
            warmup_method=str(solver.WARMUP_METHOD),
            clip_gradients=bool(solver.CLIP_GRADIENTS.ENABLED),
            clip_type=str(solver.CLIP_GRADIENTS.CLIP_TYPE),
            clip_value=float(solver.CLIP_GRADIENTS.CLIP_VALUE),
            ema=bool(solver.EMA.ENABLED),
            ema_decay=float(solver.EMA.DECAY),
            cfg_node=cfg.clone(),
        )
