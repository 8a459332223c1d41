"""The configuration of SparseInst (``MODEL.SPARSE_INST``, ``MODEL.RESNETS``).

``SparseInstConfig`` subclasses ``YoloxConfig``, so that the optimizer, the
schedule and the trainer read the shared fields unchanged. Its defaults are
``configs/coco/sparseinst/sparse_inst_r50_base.yaml`` merged into the
default tree: that file has no ``_BASE_``, so ``STRIDE_IN_1X1`` resolves to
the tree's True, while ``Base-SparseInst.yaml`` and the files built on it
give False. ``from_cfg`` reads what the JAX ``build_sparseinst``
(``models/meta_arch/sparseinst.py:491``) and ``engine.build_system`` read;
like them it ignores ``DECODER.INST``, ``DECODER.MASK``, ``ENCODER.NORM``
and ``MATCHER.ALPHA/BETA``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig
from yolov7_d2_tpu_torch.models.backbones.resnet import ResNetSpec


@dataclasses.dataclass(frozen=True)
class SparseInstConfig(YoloxConfig):
    """Defaults: SparseInst R-50 at 640 with ``BaseIAMDecoder`` (100 masks,
    80 classes, kernel dim 128, scale factor 2), bf16 over f32 weights,
    AdamW at lr 5e-5 and weight decay 5e-4, no EMA."""

    meta_architecture: str = "SparseInst"
    backbone: str = "build_resnet_backbone"
    in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    resnet: ResNetSpec = ResNetSpec()
    encoder_channels: int = 256
    groups: int = 1   # GroupIAMDecoder's DECODER.GROUPS; 1: BaseIAMDecoder
    num_masks: int = 100
    kernel_dim: int = 128
    scale_factor: float = 2.0
    cls_threshold: float = 0.005
    mask_threshold: float = 0.45
    class_weight: float = 2.0
    mask_pixel_weight: float = 5.0
    mask_dice_weight: float = 2.0
    objectness_weight: float = 1.0
    optimizer: str = "adamw"
    base_lr: float = 5e-5
    max_iter: int = 270000
    ema: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "SparseInstConfig":
        """Read the fields from a merged ``CfgNode``. The vd ResNet puts the
        stride on the 3x3 whatever ``STRIDE_IN_1X1`` says (JAX :505), and
        DCN is read as the JAX builder reads it (:508, :269-272): any stage
        of ``DEFORM_ON_PER_STAGE`` turns on deformable convolutions in
        res4 and res5, the vd ResNet too."""
        base = YoloxConfig.from_cfg(cfg)
        si = cfg.MODEL.SPARSE_INST
        dec = si.DECODER
        loss = si.LOSS
        spec = ResNetSpec.from_cfg(cfg)
        dcn = any(bool(d) for d in cfg.MODEL.RESNETS.DEFORM_ON_PER_STAGE)
        spec = dataclasses.replace(
            spec, stride_in_1x1=spec.stride_in_1x1 and not spec.vd,
            deform_on_per_stage=(False, False, dcn, dcn))
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(YoloxConfig)
               if f.name not in ("in_features", "num_classes",
                                 "max_detections")},
            in_features=tuple(si.ENCODER.IN_FEATURES),
            resnet=spec,
            encoder_channels=int(si.ENCODER.NUM_CHANNELS),
            groups=int(dec.GROUPS) if dec.NAME == "GroupIAMDecoder" else 1,
            num_classes=int(dec.NUM_CLASSES),
            num_masks=int(dec.NUM_MASKS),
            kernel_dim=int(dec.KERNEL_DIM),
            scale_factor=float(dec.SCALE_FACTOR),
            cls_threshold=float(si.CLS_THRESHOLD),
            mask_threshold=float(si.MASK_THRESHOLD),
            max_detections=int(si.MAX_DETECTIONS),
            class_weight=float(loss.CLASS_WEIGHT),
            mask_pixel_weight=float(loss.MASK_PIXEL_WEIGHT),
            mask_dice_weight=float(loss.MASK_DICE_WEIGHT),
            objectness_weight=float(loss.OBJECTNESS_WEIGHT),
        )
