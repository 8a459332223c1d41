"""JAX variables -> the port's ``state_dict``.

The inverse of ``yolov7_d2_tpu/utils/weight_port.py:port_torch_state_dict``
for YOLOX: for every key of the port's ``state_dict()`` the flax path comes
from ``map_yolox_torch_name`` (a copy of the JAX package's map of the
same name, ``yolov7_d2_tpu/utils/weight_port.py:44``), conv kernels go
``[kH, kW, I, O] -> [O, I, kH, kW]``, and BatchNorm ``scale/bias``
(params) and ``mean/var`` (batch_stats) become
``weight/bias/running_mean/running_var``. The flax tree is nested dicts of
numpy arrays, so no JAX is needed here.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np

_STATS_LEAF = {"running_mean": "mean", "running_var": "var"}


def _csp_inner(rest: str) -> str:
    """CSPLayer inner names: 'm.0.conv1.conv' -> 'm_0/conv1/conv'."""
    rest = re.sub(r"^m\.(\d+)\.", r"m_\1/", rest)
    return rest.replace(".", "/")


def map_yolox_torch_name(name: str) -> Tuple[str, ...]:
    """Translate a YOLOX state-dict key of the original reference (and of
    the port, which keeps its names), without the trailing parameter name,
    into the JAX package's flax module path parts.

    Examples:
      backbone.stem.conv.conv        -> backbone/stem/conv/conv
      backbone.dark2.0.conv          -> backbone/dark2_conv/conv
      backbone.dark2.1.conv1.conv    -> backbone/dark2_csp/conv1/conv
      backbone.dark5.1.conv1.conv    -> backbone/dark5_spp/conv1/conv
      neck.C3_p4.m.0.conv1.conv      -> neck/C3_p4/m_0/conv1/conv
      head.cls_convs.0.1.conv        -> head/cls_conv_0_1/conv
      head.cls_preds.0               -> head/cls_pred_0
      head.stems.0.conv              -> head/stem_0/conv
    """
    # backbone.stem.conv.X -> backbone/stem/conv/X
    m = re.match(r"^backbone\.stem\.(.*)$", name)
    if m:
        return tuple(f"backbone/stem/{m.group(1)}".replace(".", "/").split("/"))

    # backbone.darkN.<idx>...
    m = re.match(r"^backbone\.dark(\d)\.(\d+)\.(.*)$", name)
    if m:
        lvl, idx, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        if lvl == 5:
            part = {0: "dark5_conv", 1: "dark5_spp", 2: "dark5_csp"}[idx]
        else:
            part = {0: f"dark{lvl}_conv", 1: f"dark{lvl}_csp"}[idx]
        return tuple(f"backbone/{part}/{_csp_inner(rest)}".split("/"))

    # neck.<name>.rest — module names match the flax ones 1:1
    m = re.match(
        r"^neck\.(lateral_conv0|reduce_conv1|bu_conv1|bu_conv2|"
        r"C3_p4|C3_p3|C3_n3|C3_n4)\.(.*)$",
        name,
    )
    if m:
        return tuple(f"neck/{m.group(1)}/{_csp_inner(m.group(2))}".split("/"))

    # head towers: lists indexed by level
    m = re.match(r"^head\.stems\.(\d+)\.(.*)$", name)
    if m:
        return tuple(
            f"head/stem_{m.group(1)}/{m.group(2)}".replace(".", "/").split("/")
        )
    m = re.match(r"^head\.(cls|reg)_convs\.(\d+)\.(\d+)\.(.*)$", name)
    if m:
        kind, lvl, j, rest = m.groups()
        return tuple(
            f"head/{kind}_conv_{lvl}_{j}/{rest}".replace(".", "/").split("/")
        )
    m = re.match(r"^head\.(cls|reg|obj)_preds\.(\d+)$", name)
    if m:
        return ("head", f"{m.group(1)}_pred_{m.group(2)}")

    # fallthrough: dots to slashes
    return tuple(name.replace(".", "/").split("/"))


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
