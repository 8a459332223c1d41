"""Hierarchical config node with YAML ``_BASE_`` inheritance: attribute
access, deep merge from YAML files with recursive ``_BASE_`` resolution,
dotted-key override lists (``KEY VALUE`` pairs), freeze/defrost, clone and
dump, on plain dicts and PyYAML.

A copy of ``yolov7_d2_tpu/config/cfg_node.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_port_feed.py`` holds the two against
each other on every YOLOX config.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

import yaml


_FROZEN = "__frozen__"


BASE_KEY = "_BASE_"


class CfgNode(dict):
    """dict subclass with attribute access and freeze semantics."""

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if _is_plain_dict(v) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(
            f"Config key '{name}' not found. Available: {sorted(self.keys())}"
        )

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set '{name}' on a frozen CfgNode")
        self[name] = CfgNode(value) if _is_plain_dict(value) else value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set '{name}' on a frozen CfgNode")
        super().__setitem__(name, value)

    # -- freeze -------------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    # -- merge --------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(dict(other), self)

    def merge_from_file(self, filename: str, allow_unsafe: bool = False) -> None:
        loaded = load_yaml_with_base(filename)
        _merge_into(loaded, self)

    def merge_from_list(self, opts: List[Any]) -> None:
        """``["SOLVER.BASE_LR", 0.01, "MODEL.YOLO.CLASSES", 80]``."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    raise KeyError(f"Non-existent config section: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf])

    # -- pickling (spawn dataloader workers ship their cfg) -----------------
    def __reduce__(self):
        # dict-subclass default unpickling calls __setitem__ before __init__
        # has set __frozen__; rebuild through the constructor instead
        return (_unpickle_cfg, (self.to_dict(), self.is_frozen()))

    # -- misc ---------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return CfgNode(self.to_dict())

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node


def _is_plain_dict(v: Any) -> bool:
    return isinstance(v, dict) and not isinstance(v, CfgNode)


def _unpickle_cfg(plain: Dict[str, Any], frozen: bool) -> "CfgNode":
    node = CfgNode(plain)
    if frozen:
        node.freeze()
    return node


def _coerce(value: Any, old: Any) -> Any:
    """Coerce a CLI-string override to the type of the existing value.

    Python literals are evaluated first (yacs semantics), so tuple/list
    syntax like ``DATASETS.TRAIN '("mini",)'`` works from the CLI."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if isinstance(value, str):
        if isinstance(old, bool):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
            raise ValueError(f"Cannot coerce '{value}' to bool")
        if isinstance(old, int) and not isinstance(old, bool):
            try:
                return int(value)
            except ValueError:
                return float(value)  # allow widening int defaults to float
        if isinstance(old, float):
            return float(value)
        if isinstance(old, (list, tuple)):
            parsed = yaml.safe_load(value)
            return type(old)(parsed) if isinstance(parsed, (list, tuple)) else parsed
        if old is None:
            return yaml.safe_load(value)
        return value
    # literal-evaluated (or already-typed) value: reconcile container/num types
    if isinstance(old, bool) and isinstance(value, int):
        return bool(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    return value


def _merge_into(src: Dict[str, Any], dst: CfgNode) -> None:
    for k, v in src.items():
        if k == BASE_KEY:
            continue
        if isinstance(v, dict):
            if k not in dst or not isinstance(dst[k], CfgNode):
                dst[k] = CfgNode()
            _merge_into(v, dst[k])
        else:
            dst[k] = copy.deepcopy(v)


def load_yaml_with_base(filename: str) -> Dict[str, Any]:
    """Load YAML resolving ``_BASE_`` recursively (relative to the file)."""
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop(BASE_KEY, None)
    if base is None:
        return cfg
    if not os.path.isabs(base):
        base = os.path.join(os.path.dirname(filename), base)
    merged = load_yaml_with_base(base)
    _deep_update(merged, cfg)
    return merged


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v

