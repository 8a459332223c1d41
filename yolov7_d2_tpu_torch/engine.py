"""High-level assembly of the training step (JAX ``engine.py``): config ->
(model, state, train_step), for YOLOX (``build_yolox_system``) and, through
``build_system``, for the anchor-based YOLO family, SparseInst, DETR,
AnchorDETR and YOLOX-KPTS.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.config import (
    AnchorYoloConfig,
    DetrConfig,
    SparseInstConfig,
    YoloxConfig,
    YoloxKptsConfig,
)
from yolov7_d2_tpu_torch.config.detr import DETR_ARCHS
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch.detr import detr_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import sparseinst_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import anchor_yolo_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolox_kpts import yolox_kpts_loss_fn
from yolov7_d2_tpu_torch.parallel.dist import is_initialized
from yolov7_d2_tpu_torch.parallel.norm_sync import convert_sync_batchnorm
from yolov7_d2_tpu_torch.train.optimizer import build_optimizer
from yolov7_d2_tpu_torch.train.schedules import build_lr_schedule
from yolov7_d2_tpu_torch.train.train_state import TrainState, make_train_step


def resolve_simota_prefilter(cfg) -> Optional[int]:
    """``cfg.simota_prefilter_topk`` -> the top-K of the SimOTA prefilter
    (None: off). 0 is auto: max(1024, A // 4) for the A anchors of
    ``cfg.input_size`` at strides 8/16/32, 2100 at 640 px."""
    v = cfg.simota_prefilter_topk
    if v < 0:
        return None
    if v > 0:
        return int(v)
    h, w = cfg.input_size
    a_total = sum((h // s) * (w // s) for s in (8, 16, 32))
    return max(1024, a_total // 4)


def make_yolox_loss_adapter(num_classes: int,
                            prefilter_topk: Optional[int] = 2048):
    """Loss fn whose L1 term is always computed and multiplied by the
    ``use_l1`` flag, as the JAX adapter does."""

    def loss_fn(head_out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        losses = yolox_loss_fn(head_out, batch, num_classes, use_l1=True,
                               prefilter_topk=prefilter_topk)
        l1 = losses["loss_l1"] * float(use_l1)
        return {
            "loss_iou": losses["loss_iou"],
            "loss_obj": losses["loss_obj"],
            "loss_cls": losses["loss_cls"],
            "loss_l1": l1,
            "num_fg": losses["num_fg"],
            "total_loss": (losses["loss_iou"] + losses["loss_obj"]
                           + losses["loss_cls"] + l1),
        }

    return loss_fn


def dummy_batch(cfg, batch_size: int = 2,
                input_size: Optional[Tuple[int, int]] = None,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A gray batch with one 40 px box an image, in the layout of a
    training batch."""
    h, w = input_size or cfg.input_size
    g = cfg.max_boxes
    valid = torch.zeros((batch_size, g), dtype=torch.bool, device=device)
    valid[:, 0] = True
    return {
        "image": torch.full((batch_size, h, w, 3), 114.0, device=device),
        "gt_boxes": torch.tensor([10.0, 10.0, 50.0, 50.0],
                                 device=device).expand(batch_size, g, 4)
                                 .contiguous(),
        "gt_classes": torch.zeros((batch_size, g), dtype=torch.int32,
                                  device=device),
        "gt_valid": valid,
    }


def _train_state(cfg, model: nn.Module, device) -> TrainState:
    """The model in train mode, SGD over the decay classes and the EMA.
    Inside a process group (``parallel.launch``) the BatchNorms become
    ``SyncBatchNorm2d`` and the forward runs through
    ``DistributedDataParallel``, whose construction broadcasts rank 0's
    weights (every rank draws the same from the seed anyway, but an init
    that depends on the device cannot split the ranks); the EMA starts from
    the broadcast weights. Without a group: plain BatchNorm, no wrapper."""
    model.train()
    ddp = None
    if is_initialized():
        # imported here: the import takes seconds, and one process needs none
        from torch.nn.parallel import DistributedDataParallel

        model = convert_sync_batchnorm(model)
        device = torch.device(device)
        ddp = DistributedDataParallel(
            model, device_ids=None if device.type == "cpu" else [device],
            broadcast_buffers=False, gradient_as_bucket_view=True)
    return TrainState(
        step=0, model=model, optimizer=build_optimizer(cfg, model),
        ema_params=({n: p.detach().clone()
                     for n, p in model.named_parameters()}
                    if cfg.ema else None),
        ddp=ddp)


def build_yolox_system(cfg, device="cuda", seed: int = 0):
    """(model, state, train_step) for YOLOX from a ``YoloxConfig``: the
    model in train mode with weights from ``seed``, SGD over the decay
    classes, the schedule, the EMA and the L1 switch at
    ``aug_disable_at_iter`` (the reference turns L1 on when the strong
    augmentation turns off). The JAX builder's sample batch only traces
    the flax init, so no batch size is needed here. Inside a process group,
    SyncBatchNorm and DDP (:func:`_train_state`)."""
    state = _train_state(cfg, build_model(cfg, device, seed), device)
    train_step = make_train_step(
        make_yolox_loss_adapter(cfg.num_classes,
                                resolve_simota_prefilter(cfg)),
        build_lr_schedule(cfg),
        ema_decay=cfg.ema_decay if cfg.ema else 0.0,
        use_l1_after=cfg.aug_disable_at_iter,
        clip_cfg=cfg if cfg.clip_gradients else None,
    )
    return state.model, state, train_step


BATCH_FIELDS = ("image", "gt_boxes", "gt_classes", "gt_valid")
MASK_FIELDS = ("image", "gt_masks", "gt_classes", "gt_valid")
KPTS_FIELDS = BATCH_FIELDS + ("gt_keypoints",)
ANCHOR_YOLO_ARCHS = ("YOLO", "YOLOV7", "YOLOV7P")
# where each architecture the JAX build_system trains comes in the port
_ROADMAP_ITEM = {
    "YOLOV5": "A.8", "YOLOV6": "A.8", "YOLOF": "A.8", "SOLOv2": "A.8",
    "MaskRCNN": "A.8", "FasterRCNN": "A.8", "PanopticFPN": "A.8",
    "YOLOMask": "A.8", "DetrSegm": "A.8",
    "DetrD2go": "A.7c′", "SMCADetr": "A.7c′", "DABDetr": "A.7c′",
}


def make_anchor_yolo_loss(cfg: AnchorYoloConfig) -> Callable:
    """The training loss of ``cfg``'s architecture (JAX ``engine.py:
    176-209``): the v7 decode (``variant`` for YOLO), the configured target
    builder, the v4 or v7 box loss, the ``LAMBDA_*`` and an ignore
    threshold of at least 0.5. The loss takes no L1 switch."""
    variant = (cfg.variant if cfg.meta_architecture == "YOLO"
               else "yolov7")
    lambdas = dict(lambda_iou=cfg.lambda_iou, lambda_conf=cfg.lambda_conf,
                   lambda_cls=cfg.lambda_cls, lambda_xy=cfg.lambda_xy,
                   lambda_wh=cfg.lambda_wh)
    loss_type = "v4" if cfg.loss_type == "v4" else "v7"

    def loss_fn(head_out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return anchor_yolo_loss_fn(
            head_out, batch, cfg.anchors, cfg.num_classes, variant=variant,
            build_target_type=cfg.build_target_type, iou_type=cfg.iou_type,
            loss_type=loss_type,
            ignore_threshold=max(cfg.ignore_threshold, 0.5),
            lambdas=lambdas)

    return loss_fn


def build_system(cfg, device="cuda", seed: int = 0):
    """cfg -> (model, state, train_step, batch fields) for every
    architecture the port trains (JAX ``engine.py:155``). ``cfg`` is a
    merged ``CfgNode`` or a config dataclass (``YoloxConfig``,
    ``AnchorYoloConfig``, ``SparseInstConfig``, ``DetrConfig``,
    ``YoloxKptsConfig``). YOLOX goes to :func:`build_yolox_system`; YOLO, YOLOV7 and YOLOV7P train the
    anchor losses of :func:`make_anchor_yolo_loss` without an L1 switch;
    SparseInst trains its mask losses (``sparseinst_loss_fn``) on the
    fields ``image`` (uint8 through the normalize kernel), ``gt_masks``,
    ``gt_classes`` and ``gt_valid``; Detr and AnchorDetr train the set
    criterion (``detr_loss_fn``: focal for AnchorDetr or
    ``USE_FOCAL_LOSS``) on ``image`` (uint8 through the normalize
    kernel), ``gt_boxes``, ``gt_classes`` and ``gt_valid``, with the
    dropout masks of a step drawn from the seed and the step
    (:func:`seed_dropout_by_step`); YOLOX_KPTS trains
    ``yolox_kpts_losses`` on the box fields and ``gt_keypoints`` [B, G,
    P, 3] (``image`` uint8 through the normalize kernel); any other
    architecture raises, naming the ROADMAP.md item that brings it."""
    if hasattr(cfg, "MODEL"):
        arch = cfg.MODEL.META_ARCHITECTURE
        if arch == "YOLOX":
            cfg = YoloxConfig.from_cfg(cfg)
        elif arch in ANCHOR_YOLO_ARCHS:
            cfg = AnchorYoloConfig.from_cfg(cfg)
        elif arch == "SparseInst":
            cfg = SparseInstConfig.from_cfg(cfg)
        elif arch in DETR_ARCHS:
            cfg = DetrConfig.from_cfg(cfg)
        elif arch == "YOLOX_KPTS":
            cfg = YoloxKptsConfig.from_cfg(cfg)
    else:
        arch = cfg.meta_architecture
    if arch == "YOLOX":
        model, state, train_step = build_yolox_system(cfg, device, seed)
        return model, state, train_step, BATCH_FIELDS
    if arch == "SparseInst":
        loss_fn, fields = sparseinst_loss_fn(cfg), MASK_FIELDS
    elif arch in ANCHOR_YOLO_ARCHS:
        loss_fn, fields = make_anchor_yolo_loss(cfg), BATCH_FIELDS
    elif arch in DETR_ARCHS:
        loss_fn, fields = detr_loss_fn(cfg), BATCH_FIELDS
    elif arch == "YOLOX_KPTS":
        loss_fn, fields = yolox_kpts_loss_fn(cfg), KPTS_FIELDS
    else:
        item = _ROADMAP_ITEM.get(arch, "A.8")
        raise NotImplementedError(
            f"training {arch!r} is not ported yet (ROADMAP.md Queue {item})")
    state = _train_state(cfg, build_model(cfg, device, seed), device)
    train_step = make_train_step(
        loss_fn, build_lr_schedule(cfg),
        ema_decay=cfg.ema_decay if cfg.ema else 0.0,
        clip_cfg=cfg if cfg.clip_gradients else None)
    if arch in DETR_ARCHS:
        train_step = seed_dropout_by_step(train_step, seed)
    return state.model, state, train_step, fields


def seed_dropout_by_step(train_step: Callable, seed: int) -> Callable:
    """Reseed the model's dropout generator (``model.generator``) before
    each step from ``seed`` and the step, as the JAX step folds the step
    into its seed's key: a step's masks do not depend on the steps before
    it, so a resumed run draws what an unbroken one would."""

    def step(state, batch):
        gen = state.model.generator
        if gen is not None:
            gen.manual_seed(seed * 1_000_003 + state.step)
        return train_step(state, batch)

    return step


def resolve_device(name: str) -> torch.device:
    """The device a config names (``MODEL.DEVICE``). A CUDA device where no
    card is visible raises: the entry points never fall back to the CPU
    unless the config asks for it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"MODEL.DEVICE is {name!r} but no CUDA card is visible; set "
            "MODEL.DEVICE cpu to run on the CPU")
    return device
