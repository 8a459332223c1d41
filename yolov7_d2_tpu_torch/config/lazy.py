"""LazyConfig, the python-file configs of ``configs/common/`` and
``configs/new_baselines/`` (JAX ``config/lazy.py``): ``LazyCall`` (:21),
``instantiate`` (:39) and ``LazyConfig.load`` / ``apply_overrides`` (:55).

The config files import the JAX package (``from yolov7_d2_tpu.config.lazy
import LazyCall``, ``from yolov7_d2_tpu.models.meta_arch.mask_rcnn import
MaskRCNN``), and the ``new_baselines`` files put ``configs/`` on
``sys.path`` and import their model fragment as ``common.models.*``.
:meth:`LazyConfig.load` runs a file, unchanged, as a fresh module whose
imports go through its own ``__import__``:

* ``yolov7_d2_tpu`` and ``yolov7_d2_tpu.X`` import ``yolov7_d2_tpu_torch``
  and ``yolov7_d2_tpu_torch.X`` (an ordinary import of the port's module);
* a module found under a directory that the file (or a fragment) put on
  ``sys.path`` during the load (whether or not it was there before) is run
  afresh from its file, once a load, with the same ``__import__``, and is
  never entered in ``sys.modules``;
* anything else is an ordinary import.

So every load gets its own copy of the fragments: the JAX loader's
fragments live in ``sys.modules`` across loads, and
``panoptic_fpn_regnetx_0.4g_s.py``'s ``model["fpn_channels"] = 128`` then
changes what later loads of ``panoptic_fpn_regnetx_0.4g.py`` read
(ROADMAP.md C.38); a ``common.models.*`` that another loader left in
``sys.modules`` is never read here. When the load returns, ``sys.path`` is
as it found it, and ``sys.modules`` holds no module of the config tree
and no name of the JAX package (only the port's modules that the config
imported, as any import leaves them). The result keeps the JAX loader's
key filter: the globals not starting with ``_`` that are not callable, and
classes.
"""

from __future__ import annotations

import ast
import builtins
import collections
import importlib
import importlib.util
import os
import sys
import types
from typing import Any, Callable, Dict, List, Optional

_TARGET_KEY = "_target_"
_JAX_PACKAGE = "yolov7_d2_tpu"
_PORT_PACKAGE = "yolov7_d2_tpu_torch"


def port_module_name(name: str) -> str:
    """``yolov7_d2_tpu[.X]`` -> ``yolov7_d2_tpu_torch[.X]``; any other
    name as it is."""
    if name == _JAX_PACKAGE or name.startswith(_JAX_PACKAGE + "."):
        return _PORT_PACKAGE + name[len(_JAX_PACKAGE):]
    return name


class LazyCall:
    """Defer a call: ``LazyCall(MyModule)(channels=64)`` -> a config dict
    whose ``_target_`` holds the callable."""

    def __init__(self, target: Callable) -> None:
        if not callable(target):
            raise TypeError(f"LazyCall target must be callable, got "
                            f"{target!r}")
        self._target = target

    def __call__(self, **kwargs: Any) -> Dict[str, Any]:
        out: Dict[str, Any] = {_TARGET_KEY: self._target}
        out.update(kwargs)
        return out


def instantiate(node: Any) -> Any:
    """Recursively build objects from LazyCall dicts; a string target
    ``"module.attr"`` is imported (a JAX package module name maps to the
    port's)."""
    if isinstance(node, dict):
        built = {k: instantiate(v) for k, v in node.items()
                 if k != _TARGET_KEY}
        if _TARGET_KEY in node:
            target = node[_TARGET_KEY]
            if isinstance(target, str):
                mod, _, attr = target.rpartition(".")
                target = getattr(importlib.import_module(
                    port_module_name(mod)), attr)
            return target(**built)
        return built
    if isinstance(node, (list, tuple)):
        return type(node)(instantiate(v) for v in node)
    return node


class _Load:
    """One load: the file's ``__import__`` and the config modules it ran."""

    def __init__(self, path_before: List[str]):
        self.path_before = list(path_before)
        self.modules: Dict[str, types.ModuleType] = {}
        self.builtins = dict(vars(builtins))
        self.builtins["__import__"] = self.import_

    def _config_file(self, name: str) -> Optional[str]:
        """The file of module ``name`` under a directory put on
        ``sys.path`` during this load (a package's ``__init__.py``, or
        the package directory itself, "" where it has none)."""
        parts = name.split(".")
        # the entries put on sys.path during the load, an entry that was
        # there already too (counted)
        added = collections.Counter(
            d for d in sys.path if isinstance(d, str))
        added.subtract(d for d in self.path_before if isinstance(d, str))
        for d in sys.path:
            if not isinstance(d, str) or added[d] <= 0:
                continue
            base = os.path.join(d, *parts)
            if os.path.isfile(base + ".py"):
                return base + ".py"
            if os.path.isdir(base):
                init = os.path.join(base, "__init__.py")
                return init if os.path.isfile(init) else ""
        return None

    def module(self, name: str) -> Optional[types.ModuleType]:
        """The config module ``name`` of this load, run once; None where
        ``name`` is no module of the config tree."""
        if name in self.modules:
            return self.modules[name]
        path = self._config_file(name)
        if path is None:
            return None
        if "." in name:
            self.module(name.rpartition(".")[0])
        mod = types.ModuleType(name)
        mod.__file__ = path or None
        if not path or path.endswith("__init__.py"):
            mod.__path__ = [os.path.dirname(path)] if path else []
        self.modules[name] = mod
        if "." in name:
            parent, _, leaf = name.rpartition(".")
            setattr(self.modules[parent], leaf, mod)
        if path:
            self.run(mod, path)
        return mod

    def run(self, mod: types.ModuleType, path: str) -> None:
        mod.__builtins__ = self.builtins
        with open(path, "rb") as f:
            code = compile(f.read(), path, "exec")
        exec(code, mod.__dict__)

    def import_(self, name, globals=None, locals=None, fromlist=(),
                level=0):
        if level == 0:
            top = name.partition(".")[0]
            if top == _JAX_PACKAGE:
                return builtins.__import__(port_module_name(name), globals,
                                           locals, fromlist, level)
            if self.module(top) is not None:
                mod = self.module(name)
                if mod is None:
                    raise ModuleNotFoundError(
                        f"no module {name!r} in the config tree")
                for attr in fromlist or ():
                    if attr != "*" and not hasattr(mod, attr):
                        self.module(f"{name}.{attr}")
                return mod if fromlist else self.modules[top]
        return builtins.__import__(name, globals, locals, fromlist, level)


class LazyConfig:
    """Load python-file configs (module globals become the config)."""

    @staticmethod
    def load(filename: str) -> Dict[str, Any]:
        filename = os.path.abspath(filename)
        saved_path = list(sys.path)
        load = _Load(saved_path)
        module = types.ModuleType(
            "_lazycfg_" + os.path.splitext(os.path.basename(filename))[0]
            .replace(".", "_"))
        module.__file__ = filename
        try:
            load.run(module, filename)
        finally:
            sys.path[:] = saved_path
        return {k: v for k, v in vars(module).items()
                if not k.startswith("_") and not callable(v)
                or isinstance(v, type)}

    @staticmethod
    def apply_overrides(cfg: Dict[str, Any],
                        overrides: List[str]) -> Dict[str, Any]:
        """``["model.backbone.depth=50", "train.max_iter=1000"]``: each
        value a python literal where it parses as one, else the string."""
        for ov in overrides:
            key, _, raw = ov.partition("=")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node: Any = cfg
            parts = key.strip().split(".")
            for p in parts[:-1]:
                node = node[p] if isinstance(node, dict) else getattr(node, p)
            if isinstance(node, dict):
                node[parts[-1]] = value
            else:
                setattr(node, parts[-1], value)
        return cfg
