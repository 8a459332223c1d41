"""Model registry and builder (JAX ``models/build.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn

from yolov7_d2_tpu_torch.core.registry import Registry

META_ARCH_REGISTRY = Registry("META_ARCH")
# the JAX ``core/registry.py:79-81``: every builder takes a merged
# ``CfgNode``; ``models/registries.py`` fills them (the zoo's backbones in
# ``models/backbones/zoo.py``, ``build_resnet_fpn_backbone`` in
# ``models/necks/fpn.py``)
BACKBONE_REGISTRY = Registry("BACKBONE")
NECK_REGISTRY = Registry("NECK")
HEAD_REGISTRY = Registry("HEAD")


def build_model(cfg, device="cuda", seed: int = 0) -> nn.Module:
    """Build ``cfg.meta_architecture`` on ``device``: a ``YoloxConfig``
    for YOLOX, an ``AnchorYoloConfig`` for YOLO, YOLOV7 and YOLOV7P, a
    ``SparseInstConfig`` for SparseInst, a ``DetrConfig`` for Detr and
    AnchorDetr, a ``YoloxKptsConfig`` for YOLOX_KPTS, a ``Yolov6Config``
    for YOLOV6, a ``YolofConfig`` for YOLOF (YOLOV5 is of the anchor
    family)."""
    from yolov7_d2_tpu_torch.models.meta_arch import (  # noqa: F401
        detr,
        detr_seg,
        detr_variants,
        mask_rcnn,
        panoptic_fpn,
        solov2,
        sparseinst,
        yolof,
        yolov6,
        yolomask,
        yolov7,
        yolox,
        yolox_kpts,
    )

    if cfg.meta_architecture not in META_ARCH_REGISTRY:
        raise NotImplementedError(
            f"meta architecture {cfg.meta_architecture!r} is not ported yet; "
            f"the port has {sorted(META_ARCH_REGISTRY.keys())} (ROADMAP.md "
            "Queue A)")
    return META_ARCH_REGISTRY.get(cfg.meta_architecture)(cfg, device, seed)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every convolution (transposed too) and linear kernel from
    N(0, 1/fan_in) (flax's lecun-normal scale) and every relative position
    bias table (Swin) from flax's truncated N(0, 0.02) with ``generator``;
    biases and BatchNorm keep their identity initialisation (zero bias,
    unit scale, zero mean, unit var). Then every module with an
    ``init_fixed_`` method (a deformable convolution's zero offsets, DLA's
    bilinear upsampling taps) sets its fixed initialisation, as its flax
    initialiser does."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            # a transposed convolution's weight is [I, O, kH, kW]
            fan_in = (m.weight[:, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        table = getattr(m, "relative_position_bias_table", None)
        if table is not None:
            nn.init.trunc_normal_(table, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
    for m in model.modules():
        if hasattr(m, "init_fixed_"):
            m.init_fixed_()
