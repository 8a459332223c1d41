"""Train state and the train step (JAX ``train/train_state.py:21-138``).

``train_step(state, batch) -> (state, metrics)`` runs the forward in train
mode (BatchNorm on batch statistics, running statistics updated by torch's
rule), the loss, the backward, optional gradient clipping and one SGD
update at the scheduled learning rate, then the EMA of the parameters. It
updates ``state`` in place, where the JAX step returns a new one, and
returns it too.

Inside a process group (``parallel/``) the forward runs through the
state's ``DistributedDataParallel`` wrapper over the data axis of the grid
(``parallel/mesh.py``). Each rank's loss is its share of the global loss
(the YOLOX losses divide by the global foreground count); DDP averages the
gradients over the data ranks, so the share is scaled by the data axis's
size before the backward, and the reduced gradient is that of the global
loss, as under the JAX mesh. On a model axis above 1 the replicated
parameters take model rank 0's gradients and the norm sums the sharded
parameters' squares over the model group
(``mesh.replicate_grads_over_model``, ``mesh.grid_global_norm``). The
gradient norm and the clipping read the reduced gradients, so every rank
takes the same update.

With ``remat`` (``TPU.REMAT``, JAX :102-103) the forward's activations are
recomputed in the backward (``utils/remat.Remat``: the model's dropout
generator replayed, its BatchNorm statistics updated once); inside a group
the DDP wrapper holds the ``Remat`` wrapper (``engine._train_state``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from yolov7_d2_tpu_torch.parallel.dist import (
    all_reduce_scalars,
    get_data_size,
    get_model_size,
)
from yolov7_d2_tpu_torch.parallel.mesh import (
    grid_global_norm,
    replicate_grads_over_model,
)
from yolov7_d2_tpu_torch.train.optimizer import clip_gradients_, global_norm
from yolov7_d2_tpu_torch.utils.remat import Remat


# How each metric of a step goes over the ranks of a group, by its name
# without a decoder level's ``aux{i}_`` prefix:
# * "global": equal on every rank already (the foreground, instance and
#   box counts are all-reduced in the losses, the gradient norm is read
#   from reduced gradients);
# * "max": the global batch's value is the slowest rank's (the auction's
#   rounds are its slowest image's);
# * "mean": a mean over the rank's images, so the global one is the mean
#   over the ranks (DETR's cardinality error);
# * any other metric is the rank's share of a global sum (the losses, the
#   matched counts): summed.
METRIC_KINDS = {"num_fg": "global", "num_inst": "global",
                "num_boxes": "global", "grad_norm": "global",
                "match_iters": "max",
                "cardinality_error": "mean"}


def metric_kind(name: str) -> str:
    return METRIC_KINDS.get(re.sub(r"^aux\d+_", "", name), "share")


def reduce_metrics(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The global value of each metric of a step (:data:`METRIC_KINDS`),
    as floats: one all-reduce of the sums and one of the maxima over the
    data ranks of a group (the model ranks of a data slice hold the same
    values); without a group, each value as it is."""
    kinds = {k: metric_kind(k) for k in metrics}
    sums = all_reduce_scalars({k: v for k, v in metrics.items()
                               if kinds[k] in ("share", "mean")})
    maxima = all_reduce_scalars({k: v for k, v in metrics.items()
                                 if kinds[k] == "max"},
                                op=dist.ReduceOp.MAX)
    world = get_data_size()
    return {k: (float(v) if kinds[k] == "global" else maxima[k]
                if kinds[k] == "max" else sums[k] / world
                if kinds[k] == "mean" else sums[k])
            for k, v in metrics.items()}


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
    # the assignment the last step's loss used, ``(pred_of_gt, ok)``, where
    # the loss returns one (SparseInst, DETR: its ``match``), else None
    match: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def make_train_step(
    loss_fn: Callable,
    lr_schedule: Callable[[int], float],
    ema_decay: float = 0.0,
    use_l1_after: Optional[int] = None,
    clip_cfg=None,
    remat: bool = False,
) -> Callable:
    """``loss_fn(head_out, batch, use_l1) -> dict with "total_loss"``
    (its ``match``, where it has one, goes to ``state.match`` and not into
    the metrics). ``use_l1`` is ``state.step >= use_l1_after`` (the reference's L1
    switch). ``clip_cfg``: a config whose ``clip_gradients`` is on, else
    None. ``remat``: the forward recomputed in the backward; a state whose
    DDP wrapper holds no ``Remat`` then raises. The EMA covers the
    parameters only, not the BatchNorm buffers: ``ema = ema * decay +
    param * (1 - decay)`` after each update."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model, opt = state.model, state.optimizer
        use_l1 = use_l1_after is not None and state.step >= use_l1_after
        model.train()
        if state.ddp is None:
            forward = Remat(model) if remat else model
        else:
            if remat != isinstance(state.ddp.module, Remat):
                raise ValueError(
                    f"a step with remat={remat} on a DDP wrapper of "
                    f"{type(state.ddp.module).__name__}: build the state "
                    "and the step from one config")
            forward = state.ddp
        losses = loss_fn(forward(batch["image"]), batch, use_l1)
        state.match = losses.pop("match", None)
        opt.zero_grad(set_to_none=True)
        if state.ddp is None:
            losses["total_loss"].backward()
        else:
            (losses["total_loss"] * get_data_size()).backward()

        params = [p for group in opt.param_groups for p in group["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if get_model_size() > 1:
            replicate_grads_over_model(params)
            grad_norm = grid_global_norm(params)
        else:
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
