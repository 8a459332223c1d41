"""High-level assembly of the YOLOX training step (JAX ``engine.py:26-130``):
config -> (model, state, train_step).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_loss_fn
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


def build_yolox_system(cfg, device="cuda", seed: int = 0):
    """(model, state, train_step) for YOLOX from a ``YoloxConfig``: the
    model in train mode with weights from ``seed``, SGD over the decay
    classes, the schedule, the EMA and the L1 switch at
    ``aug_disable_at_iter`` (the reference turns L1 on when the strong
    augmentation turns off). The JAX builder's sample batch only traces
    the flax init, so no batch size is needed here."""
    model = build_model(cfg, device, seed).train()
    state = TrainState(
        step=0, model=model, optimizer=build_optimizer(cfg, model),
        ema_params=({n: p.detach().clone()
                     for n, p in model.named_parameters()}
                    if cfg.ema else None))
    train_step = make_train_step(
        make_yolox_loss_adapter(cfg.num_classes,
                                resolve_simota_prefilter(cfg)),
        build_lr_schedule(cfg),
        ema_decay=cfg.ema_decay if cfg.ema else 0.0,
        use_l1_after=cfg.aug_disable_at_iter,
        clip_cfg=cfg if cfg.clip_gradients else None,
    )
    return model, state, train_step


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
