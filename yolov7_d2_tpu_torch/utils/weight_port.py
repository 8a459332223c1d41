"""JAX variables -> the port's ``state_dict``.

The inverse of ``yolov7_d2_tpu/utils/weight_port.py:port_torch_state_dict``
for YOLOX: for every key of the port's ``state_dict()`` the flax path comes
from ``map_yolox_torch_name``, conv kernels go ``[kH, kW, I, O] ->
[O, I, kH, kW]``, and BatchNorm ``scale/bias`` (params) and ``mean/var``
(batch_stats) become ``weight/bias/running_mean/running_var``. The flax tree
is nested dicts of numpy arrays, so no JAX is needed here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np

from yolov7_d2_tpu.utils.weight_port import map_yolox_torch_name

_STATS_LEAF = {"running_mean": "mean", "running_var": "var"}


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def jax_to_torch_state_dict(
    variables: Mapping[str, Any], template: Mapping[str, Any],
    name_mapper: Callable[[str], Tuple[str, ...]] = map_yolox_torch_name,
) -> Dict[str, np.ndarray]:
    """Map flax ``{"params", "batch_stats"}`` onto the keys and shapes of
    ``template`` (the port's ``state_dict()``, or any mapping of key ->
    array with a ``shape``). ``name_mapper`` turns a torch module name into
    the flax path, as in ``port_torch_state_dict``. Raises ``KeyError`` on a
    key with no flax leaf or a flax leaf that no key took, ``ValueError`` on
    a shape mismatch."""
    trees = {
        "params": _flatten(variables["params"]),
        "batch_stats": _flatten(variables.get("batch_stats", {})),
    }
    taken = set()
    out: Dict[str, np.ndarray] = {}
    for key, ref in template.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            out[key] = np.zeros((), np.int64)
            continue
        path = name_mapper(module)
        if leaf in _STATS_LEAF:
            coll, candidates = "batch_stats", (_STATS_LEAF[leaf],)
        elif leaf == "weight":
            coll, candidates = "params", ("kernel", "scale")
        elif leaf == "bias":
            coll, candidates = "params", ("bias",)
        else:
            raise KeyError(f"{key}: no flax counterpart for leaf {leaf!r}")
        found = [path + (c,) for c in candidates
                 if path + (c,) in trees[coll]]
        if not found:
            raise KeyError(f"{key}: no flax leaf at {'/'.join(path)} "
                           f"among {candidates}")
        fpath = found[0]
        value = np.asarray(trees[coll][fpath])
        if fpath[-1] == "kernel":
            value = np.transpose(value, (3, 2, 0, 1))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax {'/'.join(fpath)} has shape "
                             f"{value.shape}, the port {tuple(ref.shape)}")
        out[key] = np.array(value, order="C")  # a writable copy
        taken.add((coll, fpath))
    left = [f"{coll}/{'/'.join(p)}" for coll, tree in trees.items()
            for p in tree if (coll, p) not in taken]
    if left:
        raise KeyError(f"flax leaves with no port key: {left[:20]}")
    return out
