"""The configuration of YOLOX-KPTS, YOLOX with a keypoint head
(``configs/coco/yolox_kpts.yaml``, ``yolox_kpts_swin.yaml``).

``YoloxKptsConfig`` subclasses ``YoloxConfig``: the optimizer, the schedule
and the tail read the shared fields. ``from_cfg`` reads a merged
``CfgNode`` as the JAX ``build_yolox_kpts`` does
(``models/meta_arch/yolox_kpts.py:305-318``): ``MODEL.YOLO.KEYPOINTS_NUM``,
one class, and the backbone by name: Swin for
``build_swin_transformer_backbone``, PVTv2 for ``build_pvt_v2_backbone``,
CSPDarknet-X for any other.
"""

from __future__ import annotations

import dataclasses

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig

# MODEL.BACKBONE.NAME -> the model's backbone; anything else is CSPDarknet-X
KPTS_BACKBONES = {
    "build_swin_transformer_backbone": "swin",
    "build_pvt_v2_backbone": "pvt_v2",
}


@dataclasses.dataclass(frozen=True)
class YoloxKptsConfig(YoloxConfig):
    """Defaults are ``configs/coco/yolox_kpts.yaml`` at 640 (CSPDarknet-X
    at depth 0.33 and width 0.50, one class, 17 keypoints)."""

    meta_architecture: str = "YOLOX_KPTS"
    num_classes: int = 1
    num_keypoints: int = 17
    base_lr: float = 0.01
    max_iter: int = 300000
    ema: bool = False

    @property
    def backbone_type(self) -> str:
        """"swin", "pvt_v2" or "cspdarknetx"."""
        return KPTS_BACKBONES.get(self.backbone, "cspdarknetx")

    @classmethod
    def from_cfg(cls, cfg) -> "YoloxKptsConfig":
        """Read the fields from a merged ``CfgNode``. The model has one
        class whatever ``MODEL.YOLO.CLASSES`` says, as in the JAX builder."""
        base = YoloxConfig.from_cfg(cfg)
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(YoloxConfig)}
        fields["num_classes"] = 1
        return cls(**fields,
                   num_keypoints=int(cfg.MODEL.YOLO.KEYPOINTS_NUM))
