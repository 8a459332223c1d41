"""Panoptic FPN (JAX ``models/meta_arch/panoptic_fpn.py``): Mask R-CNN and
the semantic head on one FPN, their losses, and the host panoptic fusion.

``PanopticFPNShared`` (JAX :26) normalizes as Mask R-CNN does (the
normalize kernel on a uint8 batch, detectron2's BGR statistics), runs one
``ResNetFPN`` named ``backbone``, the ``SemSegFPNHead`` (``sem_seg_head``)
on p2-p5, and the R-CNN (``rcnn``, masks on, per-class box deltas, no
backbone of its own) on the same pyramid through ``feats=``. The output is
Mask R-CNN's with ``sem_seg_logits`` [B, H/4, W/4, S] float32.

``panoptic_losses`` (:72) adds the semantic term to Mask R-CNN's losses,
which take the JAX defaults of the sampling sizes and fractions there:
the target resized to the logits by ``jax.image.resize``'s "nearest",
which samples at half-pixel centres (``F.interpolate``'s "nearest-exact",
not its "nearest"), the label S ignored, the softmax cross entropy's mean
over the rest, times 0.5. ``combine_semantic_and_instance`` (:105) is the
host fusion, on numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.rcnn import RcnnConfig
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.heads.sem_seg_head import SemSegFPNHead
from yolov7_d2_tpu_torch.models.meta_arch.mask_rcnn import (
    MaskRCNN,
    check_rcnn_config,
    mask_rcnn_losses,
    rcnn_dtype,
)
from yolov7_d2_tpu_torch.models.necks.fpn import ResNetFPN
from yolov7_d2_tpu_torch.ops.losses import softmax_cross_entropy

SEM_LEVELS = ("p2", "p3", "p4", "p5")


class PanopticFPNShared(nn.Module):
    def __init__(self, num_classes: int = 80, sem_seg_classes: int = 54,
                 resnet_depth: int = 50, fpn_channels: int = 256,
                 num_proposals: int = 128, pre_nms_topk: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.sem_seg_classes = sem_seg_classes
        self.dtype = dtype
        self.backbone = ResNetFPN(resnet_depth, fpn_channels)
        self.sem_seg_head = SemSegFPNHead(fpn_channels, sem_seg_classes)
        self.rcnn = MaskRCNN(
            num_classes=num_classes, resnet_depth=resnet_depth,
            fpn_channels=fpn_channels, mask_on=True,
            num_proposals=num_proposals, pre_nms_topk=pre_nms_topk,
            with_backbone=False, dtype=dtype)

    @property
    def generator(self) -> Optional[torch.Generator]:
        return self.rcnn.generator

    @generator.setter
    def generator(self, gen: Optional[torch.Generator]) -> None:
        self.rcnn.generator = gen

    def forward(self, images: torch.Tensor) -> Dict[str, object]:
        amp = self.dtype == torch.bfloat16
        with torch.autocast(images.device.type, dtype=self.dtype,
                            enabled=amp):
            feats = self.backbone(self.rcnn._normalized(images))
            sem = self.sem_seg_head([feats[k] for k in SEM_LEVELS])
        out = self.rcnn(images, feats=feats)
        out["sem_seg_logits"] = sem
        return out


def panoptic_losses(out: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], num_classes: int,
                    sem_seg_classes: int, sem_weight: float = 0.5,
                    sample_mode: str = "expectation",
                    generator: Optional[torch.Generator] = None,
                    uniforms: Optional[Sequence[torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Mask R-CNN's losses plus ``loss_sem_seg`` (JAX :72)."""
    losses = mask_rcnn_losses(out, batch, num_classes,
                              sample_mode=sample_mode, generator=generator,
                              uniforms=uniforms)
    if "gt_sem_seg" in batch and "sem_seg_logits" in out:
        logits = out["sem_seg_logits"]
        hs, ws = logits.shape[1:3]
        tgt = F.interpolate(batch["gt_sem_seg"].float()[:, None],
                            size=(hs, ws), mode="nearest-exact")[:, 0].long()
        valid = tgt < sem_seg_classes
        ce = softmax_cross_entropy(logits,
                                   tgt.clamp(0, sem_seg_classes - 1))
        l_sem = (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        losses["loss_sem_seg"] = sem_weight * l_sem
        losses["total_loss"] = losses["total_loss"] + losses["loss_sem_seg"]
    return losses


def combine_semantic_and_instance(
    sem_logits: np.ndarray, dets, overlap_threshold: float = 0.5,
    stuff_area_limit: int = 4096, instances_score_thresh: float = 0.5,
) -> np.ndarray:
    """Host panoptic fusion (JAX :105, detectron2's
    ``combine_semantic_and_instance_outputs``): confident instance masks
    painted by descending score, then the large stuff regions. Returns an
    id map [H, W] (0 void). ``dets`` of one image; without masks no
    instance is painted (Mask R-CNN serves none, ROADMAP.md C.41)."""
    sem_logits = np.asarray(sem_logits)
    scores = np.asarray(dets.scores)
    valid = np.asarray(dets.valid)
    masks = None if dets.masks is None else np.asarray(dets.masks)
    h, w = sem_logits.shape[:2]
    panoptic = np.zeros((h, w), np.int32)
    next_id = 1
    for i in np.argsort(-scores):
        if float(scores[i]) < instances_score_thresh or not bool(valid[i]):
            continue
        if masks is None:
            continue
        mask = masks[i] > 0.5
        area = mask.sum()
        if area == 0:
            continue
        if (mask & (panoptic > 0)).sum() / area > overlap_threshold:
            continue
        panoptic[mask & (panoptic == 0)] = next_id
        next_id += 1
    sem = sem_logits.argmax(-1)
    for s in np.unique(sem):
        region = (sem == s) & (panoptic == 0)
        if region.sum() >= stuff_area_limit:
            panoptic[region] = next_id
            next_id += 1
    return panoptic


@META_ARCH_REGISTRY.register(name="PanopticFPN")
def build_panoptic_fpn(cfg: RcnnConfig, device="cuda", seed: int = 0
                       ) -> PanopticFPNShared:
    """Panoptic FPN from an ``RcnnConfig`` (JAX :144) with weights from
    ``seed`` (drawn on the CPU), on ``device``, channels_last, eval
    mode."""
    check_rcnn_config(cfg)
    model = PanopticFPNShared(
        num_classes=cfg.num_classes, sem_seg_classes=cfg.sem_seg_classes,
        resnet_depth=cfg.resnet_depth, fpn_channels=cfg.fpn_channels,
        num_proposals=cfg.num_proposals, pre_nms_topk=cfg.rcnn_pre_nms_topk,
        dtype=rcnn_dtype(cfg))
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()


def panoptic_loss_fn(cfg: RcnnConfig, generator: torch.Generator):
    """The training loss of ``cfg`` (JAX ``engine.py:300-315``) in the
    train step's form; sampled mode draws from ``generator``."""

    def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return panoptic_losses(out, batch, cfg.num_classes,
                               cfg.sem_seg_classes,
                               sample_mode=cfg.sample_mode,
                               generator=generator)

    return loss_fn
