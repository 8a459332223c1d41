"""Learning-rate schedules: WarmupMultiStepLR and WarmupCosineLR (JAX
``train/schedules.py:16-83``), and ``auto_scale_config``, which rescales a
``CfgNode``'s solver to the world size.

A schedule is a plain ``step -> lr`` function. The learning rate of the
optimizer's update s is ``schedule(s)``, counting updates from 0, as optax's
``scale_by_schedule`` counts them in the JAX package.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence


def _warmup_factor(step: int, warmup_iters: int, warmup_factor: float,
                   method: str) -> float:
    if warmup_iters <= 0 or step >= warmup_iters:
        return 1.0
    if method == "constant":
        return warmup_factor
    alpha = step / warmup_iters  # linear
    return warmup_factor * (1.0 - alpha) + alpha


def warmup_multistep_lr(
    base_lr: float, steps: Sequence[int], gamma: float = 0.1,
    warmup_iters: int = 1000, warmup_factor: float = 0.001,
    warmup_method: str = "linear",
) -> Callable[[int], float]:
    milestones = sorted(int(s) for s in steps)

    def schedule(step: int) -> float:
        decays = bisect.bisect_right(milestones, step)
        return base_lr * gamma ** decays * _warmup_factor(
            step, warmup_iters, warmup_factor, warmup_method)

    return schedule


def warmup_cosine_lr(
    base_lr: float, max_iters: int, warmup_iters: int = 1000,
    warmup_factor: float = 0.001, warmup_method: str = "linear",
    min_lr_ratio: float = 0.0,
) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        progress = min(max(step / max(max_iters, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * progress))
        lr = base_lr * (min_lr_ratio + (1.0 - min_lr_ratio) * cos)
        return lr * _warmup_factor(step, warmup_iters, warmup_factor,
                                   warmup_method)

    return schedule


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """The schedule that ``cfg.lr_scheduler`` names (a ``YoloxConfig``)."""
    if cfg.lr_scheduler == "WarmupMultiStepLR":
        return warmup_multistep_lr(cfg.base_lr, cfg.lr_steps, cfg.lr_gamma,
                                   cfg.warmup_iters, cfg.warmup_factor,
                                   cfg.warmup_method)
    if cfg.lr_scheduler == "WarmupCosineLR":
        return warmup_cosine_lr(cfg.base_lr, cfg.max_iter, cfg.warmup_iters,
                                cfg.warmup_factor, cfg.warmup_method)
    raise ValueError(f"Unknown LR scheduler: {cfg.lr_scheduler}")


def auto_scale_config(cfg, world_size: int):
    """d2's REFERENCE_WORLD_SIZE auto-scaling (JAX ``train/schedules.py:86``,
    reference utils/get_default_cfg.py:14-23) of a ``CfgNode``: linearly
    scale LR and shrink iteration counts when the actual world size differs
    from the reference one."""
    ref = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if ref in (0, world_size):
        return cfg
    scale = world_size / ref
    frozen = cfg.is_frozen()
    if frozen:
        cfg.defrost()
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.STEPS = [int(round(s / scale)) for s in cfg.SOLVER.STEPS]
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = world_size
    if frozen:
        cfg.freeze()
    return cfg
