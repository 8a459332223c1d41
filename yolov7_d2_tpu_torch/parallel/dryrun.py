"""Runs of the bare train step on a (data, model) grid of processes: the
port's counterpart of ``__graft_entry__._dryrun_multichip_impl``
(:func:`dryrun_multigpu`, YOLOX, the batch over ``data`` and the widest
parameters over ``model``), and the rank function behind it
(:func:`train_steps`, any configuration ``engine.build_system`` takes),
which the tests and ``chip_smoke.py`` also use to hold N processes against
one. Both live in the package because ``spawn`` imports a rank's function
by its module's name.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from yolov7_d2_tpu_torch.parallel.dist import (
    get_data_rank,
    get_data_size,
    get_model_size,
    get_rank,
)
from yolov7_d2_tpu_torch.parallel.launch import launch
from yolov7_d2_tpu_torch.parallel.mesh import (
    build_grid,
    gather_state_dict,
    gather_tensors,
    shard_state_dict,
    sharded_specs,
)
from yolov7_d2_tpu_torch.utils.profiling import count_cuda_launches


def rank_slice(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's share of a global batch: rows ``rank * b / data`` up to
    the next data rank's, for the data rank (``local_process_batch_slice``;
    the model ranks of a data slice take the same rows)."""
    world, rank = get_data_size(), get_data_rank()
    per = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def rank_device(device: str = "cuda") -> torch.device:
    """``device`` with the rank's card made explicit: ``"cuda"`` is the
    current card (NCCL ranks have theirs set by ``launch``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def merge_matches(per_rank: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  levels: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ranks' assignments of one step (``(pred_of_gt, ok)`` [levels x
    b, G] each, level-major as DETR stacks them) as one process's on the
    global batch [levels x B, G], in rank order within each level: the
    ``match`` a one-process step takes to use the ranks' assignments."""
    return tuple(
        torch.cat([t.reshape(levels, -1, t.shape[-1]) for t in ts], 1)
        .flatten(0, 1) for ts in zip(*per_rank))


def train_steps(out_dir: str, cfg,
                batches: Sequence[Dict[str, torch.Tensor]],
                device: str = "cuda", seed: int = 0,
                state_dict: Optional[Dict[str, torch.Tensor]] = None,
                count_launches_at: Optional[int] = None,
                keep_outputs: bool = False,
                keep_weights: bool = False,
                grid_shape: Sequence[int] = (-1, 1),
                tp_min_features: int = 0,
                packed_photo: bool = False, tag: str = "rank") -> None:
    """One rank of a grid of ``grid_shape`` (data, model; ``mesh.
    build_grid``): ``engine.build_system(cfg)`` (a ``YoloxConfig``,
    ``SparseInstConfig``, ``DetrConfig`` or any other config it takes) on
    ``device`` (inside the group: synchronized BatchNorm over the data
    axis, the rule's parameters sharded over the model axis at
    ``tp_min_features``, DDP over the data axis) with the weights of
    ``seed``, or ``state_dict`` where given (whole: the rank loads its
    shard of it; the EMA then starts from it), then one step on this data
    rank's share of each global batch (host tensors). Writes
    ``out_dir/rank<r>.pt``: each step's metrics as floats, the assignment
    its loss used (``matches``: each step's ``state.match``, for SparseInst
    and DETR; :func:`merge_matches` makes the global batch's), the final
    state dict, EMA (both gathered whole from the model ranks) and step
    count on the CPU, the grid (``grid``: shape, data and model rank), and
    the rank's own shards of the sharded parameters (``shards``: {name:
    tensor}), of their EMA (``ema_shards``) and the shapes of their
    optimizer state (``opt_shapes``: {name: [shape of each tensor]}). With
    ``count_launches_at`` (a CUDA device), the metrics of that step gain
    ``launches``, the CUDA kernels it launched. With ``keep_outputs``,
    ``outputs`` holds each step's raw head outputs [b, A, 5 + C] (float32,
    on the CPU), from which the caller can recompute the step's SimOTA
    assignment; with ``keep_weights``, rank 0's ``weights`` holds the whole
    state dict before each step (on the CPU), so that one process can take
    each step from the ranks' weights. With ``packed_photo`` the step is
    ``make_packed_photo_step``'s on uint8 batches (MixUp, GridMask, flip
    drawn by the data rank). Also written: ``inputs``, a fingerprint of the
    images each step's model took (:func:`fingerprint`: equal on the model
    ranks of a data slice where they drew alike), ``kernel_launches``, the
    port's kernels this rank launched in its steps (``kernels.build.
    LAUNCHES``), and ``param_elements``, the parameter elements this rank
    holds and those of the whole model. The file is
    ``out_dir/<tag><r>.pt``."""
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build

    grid = build_grid(grid_shape)
    device = rank_device(device)
    _, state, step, _ = build_system(cfg, device=device, seed=seed,
                                     tp_min_features=tp_min_features)
    if packed_photo:
        step = make_packed_photo_step(cfg, step, seed=seed)
    inputs: List[int] = []
    state.model.register_forward_pre_hook(
        lambda module, args: inputs.append(fingerprint(args[0])))
    specs = sharded_specs(state.model)
    if state_dict is not None:
        state.model.load_state_dict(shard_state_dict(state_dict, specs))
        if state.ema_params is not None:
            state.ema_params = {n: p.detach().clone()
                                for n, p in state.model.named_parameters()}
    outputs: List = []
    if keep_outputs:
        state.model.register_forward_hook(
            lambda module, args, out: outputs.append(
                out["outputs"].detach().float().cpu()))
    history: List[Dict[str, float]] = []
    weights: List[Dict[str, torch.Tensor]] = []
    matches: List[Tuple[torch.Tensor, torch.Tensor]] = []
    build.reset_launches()
    for i, batch in enumerate(batches):
        if keep_weights:
            whole = gather_state_dict(state.model)
            if get_rank() == 0:
                weights.append({k: v.cpu().clone() for k, v in whole.items()})
        local = {k: v.to(device) for k, v in rank_slice(batch).items()}
        if i == count_launches_at:
            (state, metrics), launches = count_cuda_launches(
                lambda: step(state, local))
        else:
            state, metrics = step(state, local)
        history.append({k: float(v) for k, v in metrics.items()})
        if i == count_launches_at:
            history[-1]["launches"] = launches
        if state.match is not None:
            matches.append(tuple(t.cpu() for t in state.match))
    kernel_launches = dict(build.LAUNCHES)
    params = dict(state.model.named_parameters())
    ema = state.ema_params
    whole = sum(p.numel() for p in params.values()) + sum(
        (get_model_size() - 1) * params[k].numel() for k in specs)
    torch.save({
        "metrics": history,
        "step": state.step,
        "model": {k: v.cpu()
                  for k, v in gather_state_dict(state.model).items()},
        "ema": ({k: v.cpu() for k, v in gather_tensors(ema, specs).items()}
                if ema is not None else None),
        "grid": {"shape": tuple(grid.shape), "data_rank": grid.data_rank,
                 "model_rank": grid.model_rank},
        "shards": {k: params[k].detach().cpu() for k in specs},
        "ema_shards": ({k: ema[k].cpu() for k in specs}
                       if ema is not None else {}),
        "opt_shapes": {k: [tuple(v.shape) for v in
                           state.optimizer.state[params[k]].values()
                           if isinstance(v, torch.Tensor)] for k in specs},
        "outputs": outputs,
        "weights": weights,
        "matches": matches,
        "inputs": inputs,
        "kernel_launches": kernel_launches,
        "param_elements": (sum(p.numel() for p in params.values()), whole),
    }, os.path.join(out_dir, f"{tag}{get_rank()}.pt"))


def fingerprint(t: torch.Tensor) -> int:
    """An exact fingerprint of a tensor's bits: each element's bits as an
    integer, weighted by position, summed in int64 (wrapping, so the sum
    order does not matter): equal bits give equal fingerprints."""
    t = t.detach().contiguous()
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[t.element_size()]
    words = t.view(as_int).reshape(-1).to(torch.int64)
    weights = torch.arange(words.numel(), device=t.device) % 1_000_003 + 1
    return int((words * weights).sum())


def in_turn(calls: Sequence[Tuple]) -> None:
    """A rank function that runs each ``(fn, args)`` of ``calls`` as
    ``fn(*args)`` in turn: several rank functions in one spawn (each rank
    starts once)."""
    for fn, args in calls:
        fn(*args)


def tiny_config():
    """The dryrun's YOLOX (``__graft_entry__._tiny_cfg``): 64 px, 8
    classes, 8 boxes, depth 0.33, width 0.25, float32, EMA on."""
    from yolov7_d2_tpu_torch.config import YoloxConfig

    return YoloxConfig(input_size=(64, 64), num_classes=8, max_boxes=8,
                       depth_mul=0.33, width_mul=0.25, amp=False, ema=True)


def dryrun_multigpu(n: int, device: str = "cuda",
                    timeout: float = 300.0) -> List[Dict]:
    """The counterpart of ``_dryrun_multichip_impl``: n processes as an
    ``(n // 2, 2)`` grid where n is even and above 1, else ``(n, 1)``,
    each one step of the tiny YOLOX system on its data rank's share of
    ``dummy_batch(cfg, 2 x data)``, the parameters with 128 or more output
    features sharded over the model axis: over NCCL, one card each
    (``device`` "cuda"; fewer visible cards than n raise), or over gloo on
    the CPU ("cpu"). Asserts that the loss is finite and positive, that
    every rank ends with the same gathered parameters, BatchNorm buffers
    and EMA, and that on a model axis of 2 the shards differ between the
    model ranks; returns each rank's record of :func:`train_steps`."""
    import math

    from yolov7_d2_tpu_torch.engine import dummy_batch

    model = 2 if n % 2 == 0 and n > 1 else 1
    cfg = tiny_config()
    batch = dummy_batch(cfg, 2 * (n // model), device="cpu")
    with tempfile.TemporaryDirectory() as out:
        launch(train_steps, n, args=(out, cfg, [batch], device, 0, None,
                                     None, False, False, (-1, model), 128),
               backend="gloo" if device == "cpu" else "nccl",
               timeout=timeout)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=True) for r in range(n)]
    for r, rec in enumerate(ranks):
        loss = rec["metrics"][0]["total_loss"]
        if not (math.isfinite(loss) and loss > 0):
            raise AssertionError(f"rank {r}: total loss {loss}")
        for key in ("model", "ema"):
            for name, v in rec[key].items():
                if not torch.equal(v, ranks[0][key][name]):
                    raise AssertionError(f"rank {r}: {key} {name} differs "
                                         "from rank 0's")
    if model > 1:
        if not ranks[0]["shards"]:
            raise AssertionError("no parameter is sharded over the model "
                                 "axis")
        for name, shard in ranks[0]["shards"].items():
            if torch.equal(shard, ranks[1]["shards"][name]):
                raise AssertionError(f"{name}: model ranks 0 and 1 hold "
                                     "the same shard")
    return ranks


def norm_sync_ranks(out_dir: str, bn_params: Dict[str, torch.Tensor],
                    x: torch.Tensor, grad_out: torch.Tensor,
                    running: torch.Tensor, batches: torch.Tensor,
                    device: str = "cuda") -> None:
    """One rank of the checks of ``parallel/norm_sync.py``, on this rank's
    share (:func:`rank_slice`) of each global input (host tensors, moved to
    ``device`` in their dtype and memory format, the module in float32);
    writes ``out_dir/rank<r>.pt`` (on the CPU):

    * ``SyncBatchNorm2d`` (``bn_params``: weight, bias, eps, momentum) in
      train mode on ``x`` [N, C, H, W], backward of ``sum(y * grad_out)``:
      output, input gradient, this rank's weight and bias gradients, the
      running statistics after;
    * ``all_reduce_norm`` of running statistics that differ by rank
      (``running[rank]``: mean, var);
    * ``precise_bn`` over ``batches`` [K, N, C, H, W] from the module's
      initial statistics."""
    from yolov7_d2_tpu_torch.parallel.norm_sync import (
        SyncBatchNorm2d,
        all_reduce_norm,
        precise_bn,
    )

    device = rank_device(device)

    def module():
        bn = SyncBatchNorm2d(x.shape[1], eps=float(bn_params["eps"]),
                             momentum=float(bn_params["momentum"]))
        with torch.no_grad():
            bn.weight.copy_(bn_params["weight"])
            bn.bias.copy_(bn_params["bias"])
        return bn.to(device)

    def here(t):
        return t.to(device, memory_format=torch.preserve_format)

    bn = module().train()
    xs = rank_slice({"x": x, "g": grad_out})
    xr = here(xs["x"]).clone().requires_grad_(True)
    y = bn(xr)
    y.backward(here(xs["g"]))
    out = {"y": y.detach(), "x_grad": xr.grad, "weight_grad": bn.weight.grad,
           "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
           "running_var": bn.running_var}

    avg = module()
    avg.running_mean.copy_(running[get_rank()][0])
    avg.running_var.copy_(running[get_rank()][1])
    all_reduce_norm(avg)
    out["reduced_mean"], out["reduced_var"] = avg.running_mean, avg.running_var

    pbn = module()
    precise_bn(pbn, [here(rank_slice({"image": b})["image"])
                     for b in batches])
    out["precise_mean"], out["precise_var"] = (pbn.running_mean,
                                               pbn.running_var)
    torch.save({k: v.detach().cpu() for k, v in out.items()},
               os.path.join(out_dir, f"rank{get_rank()}.pt"))


def reduce_metrics_ranks(out_dir: str,
                         per_rank: Sequence[Dict[str, float]]) -> None:
    """One rank of the check of the trainer's reduction of a step's metrics
    (``train_state.reduce_metrics``) on ``per_rank[rank]``; writes the
    reduced values to ``out_dir/rank<r>.pt``."""
    from yolov7_d2_tpu_torch.train.train_state import reduce_metrics

    metrics = {k: torch.tensor(v) for k, v in per_rank[get_rank()].items()}
    torch.save(reduce_metrics(metrics),
               os.path.join(out_dir, f"rank{get_rank()}.pt"))
