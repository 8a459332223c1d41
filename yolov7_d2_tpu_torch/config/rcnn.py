"""The configuration of Mask R-CNN, Faster R-CNN and Panoptic FPN
(``MODEL.RPN``, ``MODEL.ROI_HEADS``, ``MODEL.ROI_BOX_HEAD``, ``MODEL.FPN``,
``MODEL.SEM_SEG_HEAD``, ``MODEL.MASK_ON``).

``RcnnConfig`` subclasses ``YoloxConfig``, so that the optimizer, the
schedule and the trainer read the shared fields unchanged. ``from_cfg``
reads what the JAX builders (``models/meta_arch/mask_rcnn.py:503, :518``,
``panoptic_fpn.py:144``) and ``engine.build_system`` (:281-315) read:
the classes, ``RESNETS.DEPTH``, ``FPN.OUT_CHANNELS``, ``MASK_ON`` (Faster
R-CNN never has the mask head, Panoptic FPN always), ``RPN.PRE_NMS_TOPK``
and ``POST_NMS_TOPK``, ``CLS_AGNOSTIC_BBOX_REG`` (Panoptic FPN's R-CNN keeps
the per-class default), the sampling batch sizes and fractions and
``ROI_HEADS.SAMPLE_MODE`` (Panoptic FPN's loss takes the JAX defaults of
the sizes and fractions, :83), and ``SEM_SEG_HEAD.NUM_CLASSES``. The JAX
builders read neither ``RESNETS.NORM`` (the R-CNN ResNet is FrozenBN) nor
the thresholds ``RPN.NMS_THRESH`` and ``ROI_HEADS.*_TEST`` (0.7, and the
tail's 0.05 and 0.5), and the port reads them nowhere either.
"""

from __future__ import annotations

import dataclasses

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig

RCNN_ARCHS = ("MaskRCNN", "FasterRCNN", "PanopticFPN")


@dataclasses.dataclass(frozen=True)
class RcnnConfig(YoloxConfig):
    """Defaults: Mask R-CNN R-50-FPN (256 channels, 80 classes, masks on)
    at 1024, 256 candidates a level and 128 proposals an image, sampled
    training (RPN 256 an image at half positives, ROI 512 at a quarter),
    bf16 over f32 weights, SGD at lr 0.02."""

    meta_architecture: str = "MaskRCNN"
    backbone: str = "build_resnet_fpn_backbone"
    input_size: tuple = (1024, 1024)
    resnet_depth: int = 50
    fpn_channels: int = 256
    mask_on: bool = True
    num_proposals: int = 128
    rcnn_pre_nms_topk: int = 256
    cls_agnostic_bbox_reg: bool = False
    sem_seg_classes: int = 54
    sample_mode: str = "sampled"
    rpn_batch: int = 256
    rpn_pos_frac: float = 0.5
    roi_batch: int = 512
    roi_pos_frac: float = 0.25
    ema: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "RcnnConfig":
        """Read the fields from a merged ``CfgNode``."""
        base = YoloxConfig.from_cfg(cfg)
        m = cfg.MODEL
        arch = m.META_ARCHITECTURE
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(YoloxConfig)
               if f.name != "num_classes"},
            num_classes=int(m.ROI_HEADS.NUM_CLASSES),
            resnet_depth=int(m.RESNETS.DEPTH),
            fpn_channels=int(m.FPN.OUT_CHANNELS),
            mask_on={"MaskRCNN": bool(m.MASK_ON), "FasterRCNN": False,
                     "PanopticFPN": True}[arch],
            num_proposals=int(m.RPN.POST_NMS_TOPK),
            rcnn_pre_nms_topk=int(m.RPN.PRE_NMS_TOPK),
            cls_agnostic_bbox_reg=(arch != "PanopticFPN" and bool(
                m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG)),
            sem_seg_classes=int(m.SEM_SEG_HEAD.NUM_CLASSES),
            sample_mode=str(m.ROI_HEADS.SAMPLE_MODE),
            rpn_batch=int(m.RPN.BATCH_SIZE_PER_IMAGE),
            rpn_pos_frac=float(m.RPN.POSITIVE_FRACTION),
            roi_batch=int(m.ROI_HEADS.BATCH_SIZE_PER_IMAGE),
            roi_pos_frac=float(m.ROI_HEADS.POSITIVE_FRACTION),
        )
