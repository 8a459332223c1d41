"""High-level assembly of the training step (JAX ``engine.py``): config ->
(model, state, train_step), for YOLOX (``build_yolox_system``) and, through
``build_system``, for the anchor-based YOLO family (YOLOv5 among them),
YOLOv6, YOLOF, SparseInst, the DETR family (DETR, AnchorDETR, SMCA-DETR,
DAB-DETR, the d2go DETR, DetrSegm), YOLOX-KPTS, SOLOv2, YOLOMask, Mask
R-CNN, Faster R-CNN and Panoptic FPN.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.config import (
    AnchorYoloConfig,
    DetrConfig,
    RcnnConfig,
    Solov2Config,
    SparseInstConfig,
    YolofConfig,
    Yolov6Config,
    YoloxConfig,
    YoloxKptsConfig,
)
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.config.detr import DETR_ARCHS
from yolov7_d2_tpu_torch.config.rcnn import RCNN_ARCHS
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch.detr import detr_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.mask_rcnn import rcnn_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.panoptic_fpn import panoptic_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.solov2 import solov2_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import sparseinst_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolof import yolof_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolomask import yolomask_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolov6 import yolov6_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import anchor_yolo_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_loss_fn
from yolov7_d2_tpu_torch.models.meta_arch.yolox_kpts import yolox_kpts_loss_fn
from yolov7_d2_tpu_torch.parallel.dist import (
    data_group,
    get_data_rank,
    get_data_size,
    get_model_size,
    is_initialized,
)
from yolov7_d2_tpu_torch.parallel.mesh import shard_model
from yolov7_d2_tpu_torch.parallel.norm_sync import convert_sync_batchnorm
from yolov7_d2_tpu_torch.train.optimizer import build_optimizer
from yolov7_d2_tpu_torch.train.schedules import build_lr_schedule
from yolov7_d2_tpu_torch.train.train_state import TrainState, make_train_step
from yolov7_d2_tpu_torch.utils.remat import Remat


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


def _train_state(cfg, model: nn.Module, device,
                 tp_min_features: int = 0) -> TrainState:
    """The model in train mode, SGD over the decay classes and the EMA.
    Inside a process group (``parallel.launch``) the BatchNorms become
    ``SyncBatchNorm2d``; on a model axis above 1 with ``tp_min_features``
    the rule's parameters are sharded over it (``parallel.mesh.
    shard_model``, before the optimizer, the EMA and DDP take the
    parameters); the forward runs through ``DistributedDataParallel`` over
    the data group (where the data axis has more than one rank, or the
    grid has no model axis: a group of 1 keeps its wrapper), whose
    construction broadcasts each data group's first rank's weights, which
    are the same shard (every rank draws the same from the seed anyway,
    but an init that depends on the device cannot split the ranks); the
    EMA starts from the broadcast weights; with ``cfg.remat`` DDP wraps the
    model's ``utils.remat.Remat``. Without a group: plain BatchNorm, no
    wrapper."""
    model.train()
    ddp = None
    if is_initialized():
        model = convert_sync_batchnorm(model)
        if get_model_size() > 1 and tp_min_features > 0:
            shard_model(model, tp_min_features)
        if get_data_size() > 1 or get_model_size() == 1:
            # imported here: the import takes seconds, and one process
            # needs none
            from torch.nn.parallel import DistributedDataParallel

            device = torch.device(device)
            ddp = DistributedDataParallel(
                Remat(model) if cfg.remat else model,
                device_ids=None if device.type == "cpu" else [device],
                process_group=data_group(), broadcast_buffers=False,
                gradient_as_bucket_view=True)
    return TrainState(
        step=0, model=model, optimizer=build_optimizer(cfg, model),
        ema_params=({n: p.detach().clone()
                     for n, p in model.named_parameters()}
                    if cfg.ema else None),
        ddp=ddp)


def build_yolox_system(cfg, device="cuda", seed: int = 0,
                       tp_min_features: int = 0):
    """(model, state, train_step) for YOLOX from a ``YoloxConfig``: the
    model in train mode with weights from ``seed``, SGD over the decay
    classes, the schedule, the EMA and the L1 switch at
    ``aug_disable_at_iter`` (the reference turns L1 on when the strong
    augmentation turns off). The JAX builder's sample batch only traces
    the flax init, so no batch size is needed here. Inside a process group,
    SyncBatchNorm, the model axis's shards at ``tp_min_features`` and DDP
    (:func:`_train_state`). On ConvNeXt the drop-path masks of a step come
    from the seed and the step (:func:`seed_dropout_by_step`)."""
    state = _train_state(cfg, build_model(cfg, device, seed), device,
                         tp_min_features)
    train_step = make_train_step(
        make_yolox_loss_adapter(cfg.num_classes,
                                resolve_simota_prefilter(cfg)),
        build_lr_schedule(cfg),
        ema_decay=cfg.ema_decay if cfg.ema else 0.0,
        use_l1_after=cfg.aug_disable_at_iter,
        clip_cfg=cfg if cfg.clip_gradients else None,
        remat=cfg.remat,
    )
    if state.model.generator is not None:
        train_step = seed_dropout_by_step(train_step, seed)
    return state.model, state, train_step


BATCH_FIELDS = ("image", "gt_boxes", "gt_classes", "gt_valid")
MASK_FIELDS = ("image", "gt_masks", "gt_classes", "gt_valid")
KPTS_FIELDS = BATCH_FIELDS + ("gt_keypoints",)
# SOLOv2's masks with their boxes (JAX engine.py:253); YOLOMask's and
# DetrSegm's box fields with the masks (:273, :331)
SOLOV2_FIELDS = ("image", "gt_masks", "gt_boxes", "gt_classes", "gt_valid")
BOX_MASK_FIELDS = BATCH_FIELDS + ("gt_masks",)
# Mask R-CNN's masks with their boxes, Panoptic FPN's with the semantic
# target (JAX engine.py:285, :303-306)
RCNN_MASK_FIELDS = ("image", "gt_masks", "gt_boxes", "gt_classes",
                    "gt_valid")
PANOPTIC_FIELDS = RCNN_MASK_FIELDS + ("gt_sem_seg",)
ANCHOR_YOLO_ARCHS = ("YOLO", "YOLOV5", "YOLOV7", "YOLOV7P")


# the config dataclass each architecture the port builds reads
CONFIG_OF = {
    "YOLOX": YoloxConfig, "SparseInst": SparseInstConfig,
    "YOLOX_KPTS": YoloxKptsConfig, "YOLOV6": Yolov6Config,
    "YOLOF": YolofConfig, "SOLOv2": Solov2Config,
    "YOLOMask": AnchorYoloConfig, "DetrSegm": DetrConfig,
    **{arch: RcnnConfig for arch in RCNN_ARCHS},
    **{arch: AnchorYoloConfig for arch in ANCHOR_YOLO_ARCHS},
    **{arch: DetrConfig for arch in DETR_ARCHS},
}


def config_from_cfg(cfg):
    """A merged ``CfgNode`` -> the config dataclass its architecture reads
    (:data:`CONFIG_OF`); an architecture the port does not build raises,
    naming ROADMAP.md's Queue A."""
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch not in CONFIG_OF:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ROADMAP.md Queue A)")
    return CONFIG_OF[arch].from_cfg(cfg)


def config_from_yaml(path, **replace):
    """A yaml file merged into ``get_cfg`` as the entry points merge it ->
    its :func:`config_from_cfg` dataclass, with fields replaced."""
    cfg = get_cfg()
    cfg.merge_from_file(str(path))
    return dataclasses.replace(config_from_cfg(cfg), **replace)


def make_anchor_yolo_loss(cfg: AnchorYoloConfig) -> Callable:
    """The training loss of ``cfg``'s architecture (JAX ``engine.py:
    176-209``): the v7 decode (``variant`` for YOLO, the v5 decode and the
    ratio target builder for YOLOV5 whatever the config says), the
    configured target builder, the v4 or v7 box loss, the ``LAMBDA_*`` and
    an ignore threshold of at least 0.5. The loss takes no L1 switch."""
    arch = cfg.meta_architecture
    variant = {"YOLO": cfg.variant, "YOLOV5": "yolov5"}.get(arch, "yolov7")
    build_target_type = ("yolov5" if arch == "YOLOV5"
                         else cfg.build_target_type)
    lambdas = dict(lambda_iou=cfg.lambda_iou, lambda_conf=cfg.lambda_conf,
                   lambda_cls=cfg.lambda_cls, lambda_xy=cfg.lambda_xy,
                   lambda_wh=cfg.lambda_wh)
    loss_type = "v4" if cfg.loss_type == "v4" else "v7"

    def loss_fn(head_out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return anchor_yolo_loss_fn(
            head_out, batch, cfg.anchors, cfg.num_classes, variant=variant,
            build_target_type=build_target_type, iou_type=cfg.iou_type,
            loss_type=loss_type,
            ignore_threshold=max(cfg.ignore_threshold, 0.5),
            lambdas=lambdas)

    return loss_fn


def build_system(cfg, device="cuda", seed: int = 0,
                 tp_min_features: int = 0):
    """cfg -> (model, state, train_step, batch fields) for every
    architecture the port trains (JAX ``engine.py:155``). ``cfg`` is a
    merged ``CfgNode`` or a config dataclass (``YoloxConfig``,
    ``AnchorYoloConfig``, ``SparseInstConfig``, ``DetrConfig``,
    ``YoloxKptsConfig``, ``Yolov6Config``, ``YolofConfig``). YOLOX goes to
    :func:`build_yolox_system`; YOLO, YOLOV5, YOLOV7 and YOLOV7P train the
    anchor losses of :func:`make_anchor_yolo_loss` without an L1 switch
    (with PP-YOLO's PAN neck, the DropBlock masks of a step drawn from the
    seed and the step, :func:`seed_dropout_by_step`); YOLOV6 trains
    ``yolov6_losses`` and YOLOF ``yolof_losses`` on the box fields;
    SparseInst trains its mask losses (``sparseinst_loss_fn``) on the
    fields ``image`` (uint8 through the normalize kernel), ``gt_masks``,
    ``gt_classes`` and ``gt_valid``; Detr, AnchorDetr, SMCADetr, DABDetr
    and DetrD2go train the set criterion (``detr_loss_fn``: focal for
    AnchorDetr or ``USE_FOCAL_LOSS``) on ``image`` (uint8 through the
    normalize kernel), ``gt_boxes``, ``gt_classes`` and ``gt_valid``, with
    the dropout (and drop-path) masks of a step drawn from the seed and the
    step (:func:`seed_dropout_by_step`); YOLOX_KPTS trains
    ``yolox_kpts_losses`` on the box fields and ``gt_keypoints`` [B, G,
    P, 3] (``image`` uint8 through the normalize kernel); SOLOv2 trains
    ``solov2_losses`` on ``image``, ``gt_masks`` [B, G, H, W] uint8,
    ``gt_boxes``, ``gt_classes`` and ``gt_valid``; YOLOMask
    ``yolomask_losses`` and DetrSegm the set criterion with its mask terms
    on the box fields and ``gt_masks``; MaskRCNN and FasterRCNN
    ``mask_rcnn_losses`` on the box fields (``gt_masks`` too where the
    masks are on) and PanopticFPN ``panoptic_losses`` on those and
    ``gt_sem_seg`` [B, H, W] (the label S ignored), in the configured
    ``sample_mode``, drawing the sampled subsets from ``model.generator``,
    which :func:`seed_dropout_by_step` reseeds a step; any other
    architecture raises, naming ROADMAP.md's Queue A. Inside a process
    group with a model axis above 1, ``tp_min_features`` > 0 shards the
    JAX rule's parameters over it (:func:`_train_state`)."""
    if hasattr(cfg, "MODEL"):
        arch = cfg.MODEL.META_ARCHITECTURE
        if arch in CONFIG_OF:
            cfg = config_from_cfg(cfg)
    else:
        arch = cfg.meta_architecture
    if arch == "YOLOX":
        model, state, train_step = build_yolox_system(cfg, device, seed,
                                                      tp_min_features)
        return model, state, train_step, BATCH_FIELDS
    if arch == "SparseInst":
        loss_fn, fields = sparseinst_loss_fn(cfg), MASK_FIELDS
    elif arch in ANCHOR_YOLO_ARCHS:
        loss_fn, fields = make_anchor_yolo_loss(cfg), BATCH_FIELDS
    elif arch in DETR_ARCHS:
        loss_fn, fields = detr_loss_fn(cfg), BATCH_FIELDS
    elif arch == "DetrSegm":
        loss_fn, fields = detr_loss_fn(cfg), BOX_MASK_FIELDS
    elif arch == "SOLOv2":
        loss_fn, fields = solov2_loss_fn(cfg), SOLOV2_FIELDS
    elif arch == "YOLOMask":
        loss_fn, fields = yolomask_loss_fn(cfg), BOX_MASK_FIELDS
    elif arch == "YOLOX_KPTS":
        loss_fn, fields = yolox_kpts_loss_fn(cfg), KPTS_FIELDS
    elif arch == "YOLOV6":
        loss_fn, fields = yolov6_loss_fn(cfg), BATCH_FIELDS
    elif arch == "YOLOF":
        loss_fn, fields = yolof_loss_fn(cfg), BATCH_FIELDS
    elif arch in RCNN_ARCHS:
        generator = torch.Generator(device=device)
        if arch == "PanopticFPN":
            loss_fn = panoptic_loss_fn(cfg, generator)
            fields = PANOPTIC_FIELDS
        else:
            loss_fn = rcnn_loss_fn(cfg, generator)
            fields = RCNN_MASK_FIELDS if cfg.mask_on else BATCH_FIELDS
    else:
        raise NotImplementedError(
            f"training {arch!r} is not ported yet (ROADMAP.md Queue A)")
    model = build_model(cfg, device, seed)
    if arch in RCNN_ARCHS:
        model.generator = generator
    state = _train_state(cfg, model, device, tp_min_features)
    train_step = make_train_step(
        loss_fn, build_lr_schedule(cfg),
        ema_decay=cfg.ema_decay if cfg.ema else 0.0,
        clip_cfg=cfg if cfg.clip_gradients else None, remat=cfg.remat)
    if getattr(state.model, "generator", None) is not None:
        train_step = seed_dropout_by_step(train_step, seed)
    return state.model, state, train_step, fields


def seed_dropout_by_step(train_step: Callable, seed: int) -> Callable:
    """Reseed the model's dropout generator (``model.generator``) before
    each step from ``seed``, the step and the data rank in a process group,
    as the JAX step folds the step into its seed's key: a step's masks do
    not depend on the steps before it, so a resumed run draws what an
    unbroken one would, and each data rank draws its own masks (as it draws
    its own MixUp pairs), while the model ranks of a data slice draw
    alike, so that their replicated activations stay equal."""

    def step(state, batch):
        gen = state.model.generator
        if gen is not None:
            # the rank's offset is a multiple of the golden-ratio constant:
            # far apart from every other rank's modulo 2**32 too, where a
            # CPU generator cuts its seed
            gen.manual_seed(seed * 1_000_003 + state.step
                            + get_data_rank() * 0x9E3779B1)
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
