"""The rank functions of the 2-rank spawns of
``tests/test_torch_port_tensor_parallel.py`` and
``tests/test_torch_port_dist.py``, in a module that imports no JAX, since
``spawn`` imports a rank's function by its module's name."""

import copy
import dataclasses
import os

import torch

from yolov7_d2_tpu_torch.parallel import mesh
from yolov7_d2_tpu_torch.parallel.dist import get_rank
from yolov7_d2_tpu_torch.parallel.dryrun import train_steps


def modules_then_steps(out_dir: str, cases: dict, steps_args: tuple) -> None:
    """On a (1, 2) grid: each of ``cases`` ({name: (module, x, grad_out)})
    sharded at ``tp_min_features`` 1, forward on ``x`` and backward of
    ``grad_out``, once with the gathers as all_gathers and once as
    all_reduces of zero-filled buffers; writes ``out_dir/modules<r>.pt``
    ({"<name>/<all_gather|all_reduce>": output, input gradient, the
    weight's and bias's gradients (the weight's gathered whole), the rows
    of the rank's shard}). Then :func:`train_steps` ``(out_dir,
    *steps_args)``."""
    mesh.build_grid((1, 2))
    out = {}
    try:
        for how in ("all_gather", "all_reduce"):
            mesh.GATHER_BY_ALL_REDUCE = how == "all_reduce"
            for name, (module, x, grad_out) in cases.items():
                m = copy.deepcopy(module)
                specs = mesh.shard_model(m, 1)
                xr = x.clone().requires_grad_(True)
                y = m(xr)
                y.backward(grad_out)
                shard = m._parameters["weight"]
                with torch.no_grad():
                    w_grad = mesh.gather_param(shard.grad, specs["weight"])
                out[f"{name}/{how}"] = {
                    "y": y.detach(), "x_grad": xr.grad, "weight_grad": w_grad,
                    "bias_grad": m.bias.grad, "rows": shard.shape[0],
                    "type": type(m).__name__}
    finally:
        mesh.GATHER_BY_ALL_REDUCE = None
    torch.save(out, os.path.join(out_dir, f"modules{get_rank()}.pt"))
    train_steps(out_dir, *steps_args)


def steps_with_and_without_remat(out_dir: str, cfg, *args) -> None:
    """:func:`train_steps` ``(out_dir, cfg, *args)``, then the same with
    ``cfg.remat`` on (the forward recomputed in the backward, inside the
    DDP wrapper), written as ``out_dir/remat<r>.pt``."""
    train_steps(out_dir, cfg, *args)
    train_steps(out_dir, dataclasses.replace(cfg, remat=True), *args,
                tag="remat")
