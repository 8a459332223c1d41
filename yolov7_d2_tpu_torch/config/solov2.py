"""The configuration of SOLOv2 (``MODEL.SOLOV2``, ``MODEL.RESNETS.DEPTH``).

``Solov2Config`` subclasses ``YoloxConfig``, so that the optimizer, the
schedule and the trainer read the shared fields unchanged. Its defaults are
``configs/coco/solov2/solov2_r50.yaml`` merged into the default tree.
``from_cfg`` reads what the JAX ``build_solov2``
(``models/meta_arch/solov2.py:517``) and ``engine.build_system``
(:250-259) read: the classes, grids, kernel and tower widths, the
instance head's DCN and the ResNet's depth (FrozenBN, the stride in the
1x1, whatever ``MODEL.RESNETS`` says besides); ``FPN_SCALE_RANGES`` and the
tail's thresholds are read by neither (ROADMAP.md C.35).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig


@dataclasses.dataclass(frozen=True)
class Solov2Config(YoloxConfig):
    """Defaults: SOLOv2 R-50 at 640 (grids 40/36/24/16/12, 256 kernels,
    instance towers of 512, mask features of 128, 80 classes), bf16 over
    f32 weights, SGD at lr 0.01."""

    meta_architecture: str = "SOLOv2"
    backbone: str = "build_resnet_backbone"
    num_grids: Tuple[int, ...] = (40, 36, 24, 16, 12)
    num_kernels: int = 256
    instance_channels: int = 512
    mask_channels: int = 128
    resnet_depth: int = 50
    use_dcn_in_instance: bool = False
    base_lr: float = 0.01
    max_iter: int = 270000
    ema: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "Solov2Config":
        """Read the fields from a merged ``CfgNode``."""
        base = YoloxConfig.from_cfg(cfg)
        s = cfg.MODEL.SOLOV2
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(YoloxConfig)
               if f.name != "num_classes"},
            num_classes=int(s.NUM_CLASSES),
            num_grids=tuple(int(g) for g in s.NUM_GRIDS),
            num_kernels=int(s.NUM_KERNELS),
            instance_channels=int(s.INSTANCE_CHANNELS),
            mask_channels=int(s.MASK_CHANNELS),
            resnet_depth=int(cfg.MODEL.RESNETS.DEPTH),
            use_dcn_in_instance=bool(s.USE_DCN_IN_INSTANCE),
        )
