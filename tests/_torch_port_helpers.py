"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: flax variables with non-trivial BatchNorm, moved into a torch
module through ``jax_to_torch_state_dict``. Inputs and noise are made with
numpy and handed to both sides."""

from __future__ import annotations

import re

import numpy as np
import torch

from yolov7_d2_tpu_torch.utils.weight_port import jax_to_torch_state_dict


def block_name_mapper(name: str):
    """Torch names inside one block -> flax path ('m.0.conv1' -> m_0/conv1)."""
    return tuple(re.sub(r"(^|\.)m\.(\d+)(?=\.|$)", r"\1m_\2", name).split("."))


def _map_tree(tree, fn, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, np.asarray(tree))


def randomize_bn(variables, rng: np.random.Generator):
    """Give every BatchNorm random statistics and affine parameters, and every
    bias a random value, so that no layer is the identity."""
    def params_fn(path, v):
        if path[-1] == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if path[-1] == "bias":
            return rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        return v

    def stats_fn(path, v):
        if path[-1] == "mean":
            return rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    out = {"params": _map_tree(variables["params"], params_fn)}
    if "batch_stats" in variables:
        out["batch_stats"] = _map_tree(variables["batch_stats"], stats_fn)
    return out


def numpy_variables(variables):
    return _map_tree(variables, lambda p, v: v)


def load_into(module: torch.nn.Module, variables, name_mapper=None):
    """Move flax ``variables`` into ``module`` (strict) and return it."""
    kw = {} if name_mapper is None else {"name_mapper": name_mapper}
    sd = jax_to_torch_state_dict(numpy_variables(variables),
                                 module.state_dict(), **kw)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def nhwc_to_nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()
