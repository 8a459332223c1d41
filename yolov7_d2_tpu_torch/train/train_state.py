"""Train state and the train step (JAX ``train/train_state.py:21-138``).

``train_step(state, batch) -> (state, metrics)`` runs the forward in train
mode (BatchNorm on batch statistics, running statistics updated by torch's
rule), the loss, the backward, optional gradient clipping and one SGD
update at the scheduled learning rate, then the EMA of the parameters. It
updates ``state`` in place, where the JAX step returns a new one, and
returns it too.

Inside a process group (``parallel/``) the forward runs through the
state's ``DistributedDataParallel`` wrapper. Each rank's loss is its share
of the global loss (the YOLOX losses divide by the global foreground
count); DDP averages the gradients over the ranks, so the share is scaled
by the world size before the backward, and the reduced gradient is that of
the global loss, as under the JAX mesh. The gradient norm and the clipping
read the reduced gradients, so every rank takes the same update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from yolov7_d2_tpu_torch.parallel.dist import get_world_size
from yolov7_d2_tpu_torch.train.optimizer import clip_gradients_, global_norm


# the step's metrics that are global already, equal on every rank of a
# group (the foreground count is reduced in the loss, the gradient norm read
# from reduced gradients); every other metric is the rank's share
GLOBAL_METRICS = ("num_fg", "grad_norm")


@dataclasses.dataclass
class TrainState:
    step: int                       # updates done so far
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None  # name -> tensor
    # the DistributedDataParallel wrapper of ``model`` inside a process
    # group, else None; ``model`` stays the bare module, so that names, the
    # EMA, the optimizer's groups and checkpoints have no ``module.`` prefix
    ddp: Optional[nn.Module] = None


def make_train_step(
    loss_fn: Callable,
    lr_schedule: Callable[[int], float],
    ema_decay: float = 0.0,
    use_l1_after: Optional[int] = None,
    clip_cfg=None,
) -> Callable:
    """``loss_fn(head_out, batch, use_l1) -> dict with "total_loss"``.
    ``use_l1`` is ``state.step >= use_l1_after`` (the reference's L1
    switch). ``clip_cfg``: a config whose ``clip_gradients`` is on, else
    None. The EMA covers the parameters only, not the BatchNorm buffers:
    ``ema = ema * decay + param * (1 - decay)`` after each update."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model, opt = state.model, state.optimizer
        use_l1 = use_l1_after is not None and state.step >= use_l1_after
        model.train()
        forward = model if state.ddp is None else state.ddp
        losses = loss_fn(forward(batch["image"]), batch, use_l1)
        opt.zero_grad(set_to_none=True)
        if state.ddp is None:
            losses["total_loss"].backward()
        else:
            (losses["total_loss"] * get_world_size()).backward()

        grads = [p.grad for group in opt.param_groups
                 for p in group["params"] if p.grad is not None]
        grad_norm = global_norm(grads)
        if clip_cfg is not None:
            clip_gradients_(grads, grad_norm, clip_cfg)
        lr = lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        opt.step()

        if state.ema_params is not None and ema_decay > 0:
            names, params = zip(*model.named_parameters())
            ema = [state.ema_params[n] for n in names]
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm.detach()
        return state, metrics

    return train_step
