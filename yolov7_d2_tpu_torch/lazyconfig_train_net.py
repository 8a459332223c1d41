"""Training from a LazyConfig python file (JAX
``tools/lazyconfig_train_net.py``).

    python -m yolov7_d2_tpu_torch.lazyconfig_train_net --config-file \\
        configs/common/yolox_s_lazy.py [--resume] [--device cpu] \\
        [train.max_iter=4 train.ims_per_batch=16 ...]

The entry point owns the loop (:func:`do_train`, JAX :69): it instantiates
``cfg["model"]`` (weights from ``train.seed``, on the card unless
``--device`` says otherwise), builds the optimizer and the schedule from
``cfg["optimizer"]`` and ``cfg["train"]``, and runs the trainer with the
timer, the periodic checkpointer and the writers. The schedule is a linear
warm-up from 0 over ``min(train.warmup_iters, max_iter // 2)`` steps, then
a cosine decay to 0 at ``max_iter`` (``optax.warmup_cosine_decay_schedule``).
SGD adds ``weight_decay`` times the weights to every parameter's gradient
before the momentum (``add_decayed_weights`` then ``sgd``: no decay
classes, unlike the yaml path); AdamW is ``optax.adamw``'s, decoupled decay
on every parameter. The loss is ``cfg["loss_fn"]`` (a LazyCall) or, for
YOLOX only, the IoU, objectness and class terms (:27, L1 off); any other
model needs a ``loss_fn`` or a ``run``. The data is ``cfg["dataloader"]``
(a LazyCall giving batches) or else a synthetic loader (:47) of gray
images with one box. A config with a callable ``run(model, train_cfg,
resume=...)`` replaces the loop.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from yolov7_d2_tpu_torch.config.lazy import LazyConfig, instantiate
from yolov7_d2_tpu_torch.engine import resolve_device
from yolov7_d2_tpu_torch.models.build import init_weights_
from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
from yolov7_d2_tpu_torch.train.train_state import TrainState, make_train_step
from yolov7_d2_tpu_torch.train.trainer import (
    IterationTimer,
    PeriodicCheckpointer,
    PeriodicWriter,
    Trainer,
)

logger = logging.getLogger("yolov7_d2_tpu_torch")


def _build_loss_fn(model) -> Callable:
    """YOLOX's loss without L1 (JAX :27); any other model raises."""
    from yolov7_d2_tpu_torch.models.meta_arch.yolox import (
        YOLOX,
        yolox_loss_fn,
    )

    if isinstance(model, YOLOX):
        def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
            losses = yolox_loss_fn(out, batch, model.num_classes,
                                   use_l1=False)
            losses["total_loss"] = (losses["loss_iou"] + losses["loss_obj"]
                                    + losses["loss_cls"])
            return losses

        return loss_fn
    raise SystemExit(f"No builtin loss wiring for {type(model).__name__}; "
                     "define `loss_fn` or `run` in the LazyConfig file.")


def _synthetic_loader(batch_size: int, input_size, device,
                      max_boxes: int = 8) -> Iterator[Dict[str, torch.Tensor]]:
    """Gray float images with one box [8, 8, 48, 48] of class 0 (JAX
    :47), on ``device``."""
    h, w = input_size
    valid = np.zeros((batch_size, max_boxes), bool)
    valid[:, 0] = True
    batch = {
        "image": np.full((batch_size, h, w, 3), 114.0, np.float32),
        "gt_boxes": np.tile(np.asarray([[8.0, 8.0, 48.0, 48.0]],
                                       np.float32), (batch_size, max_boxes,
                                                     1)),
        "gt_classes": np.zeros((batch_size, max_boxes), np.int32),
        "gt_valid": valid,
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    while True:
        yield batch


def warmup_cosine(base_lr: float, warmup: int,
                  decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, base_lr, warmup,
    decay_steps)`` of the step count."""

    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        t = min(step - warmup, decay_steps - warmup)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t
                                               / (decay_steps - warmup)))

    return lr


def build_lazy_optimizer(ocfg: Dict, model: torch.nn.Module
                         ) -> torch.optim.Optimizer:
    """SGD with the decay on every parameter, or AdamW (JAX :106-114); one
    group of ``lr_mult`` 1."""
    params = [p for p in model.parameters() if p.requires_grad]
    adamw = ocfg.get("name", "sgd") == "adamw"
    wd = float(ocfg.get("weight_decay", 1e-4 if adamw else 0.0))
    if adamw:
        opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=wd)
    else:
        opt = torch.optim.SGD(params, lr=0.0,
                              momentum=float(ocfg.get("momentum", 0.9)),
                              weight_decay=wd)
    for group in opt.param_groups:
        group["lr_mult"] = 1.0
    return opt


def do_train(cfg: Dict, resume: bool = False, device="cuda") -> Trainer:
    """The loop of a loaded config (JAX :69)."""
    device = resolve_device(str(device))
    tcfg = dict(cfg.get("train", {}))
    ocfg = dict(cfg.get("optimizer", {}))
    max_iter = int(tcfg.get("max_iter", 90000))
    out_dir = tcfg.get("output_dir", "./output/lazy")
    input_size = tuple(tcfg.get("input_size", (640, 640)))
    batch_size = int(tcfg.get("ims_per_batch", 8))
    seed = int(tcfg.get("seed", 0))
    os.makedirs(out_dir, exist_ok=True)

    model = instantiate(cfg["model"])
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    model.train()

    base_lr = float(ocfg.get("base_lr", 0.01))
    warmup = min(int(tcfg.get("warmup_iters", 1000)), max(max_iter // 2, 1))
    schedule = warmup_cosine(base_lr, warmup, max(max_iter, warmup + 1))
    state = TrainState(step=0, model=model,
                       optimizer=build_lazy_optimizer(ocfg, model))
    ckpt_cfg = dict(tcfg.get("checkpointer", {}))
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"))
    state, start_iter = ckpt.resume_or_load(state, resume=resume)

    loss_fn = (instantiate(cfg["loss_fn"]) if "loss_fn" in cfg
               else _build_loss_fn(model))
    train_step = make_train_step(loss_fn, schedule)
    if "dataloader" in cfg:
        loader = instantiate(cfg["dataloader"])
    else:
        logger.warning("no cfg.dataloader: the synthetic smoke loader")
        loader = _synthetic_loader(batch_size, input_size, device)
    trainer = Trainer(
        train_step, state, loader, max_iter,
        hooks=[IterationTimer(),
               PeriodicCheckpointer(ckpt, int(ckpt_cfg.get("period", 5000))),
               PeriodicWriter(Trainer.default_writers(
                   out_dir, max_iter, int(tcfg.get("log_period", 20))))],
        start_iter=start_iter,
        metrics_period=int(tcfg.get("log_period", 20)))
    trainer.train()
    return trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = LazyConfig.load(args.config_file)
    if args.opts:
        cfg = LazyConfig.apply_overrides(cfg, args.opts)
    run = cfg.get("run")
    if callable(run):
        model = instantiate(cfg["model"])
        return run(model, cfg.get("train", {}), resume=args.resume)
    return do_train(cfg, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
