"""Name -> builder registries (the port's copy of
``yolov7_d2_tpu/core/registry.py``).

A config names a component and the registry resolves it, as detectron2's
registries do in the original reference. The class has no dependency.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class Registry:
    """A string -> object registry supporting decorator or call registration.

    >>> META_ARCH_REGISTRY = Registry("META_ARCH")
    >>> @META_ARCH_REGISTRY.register(name="YOLOX")
    ... def build_yolox(cfg, device, seed):
    ...     ...
    >>> builder = META_ARCH_REGISTRY.get("YOLOX")
    """

    def __init__(self, name: str) -> None:
        self._name = name
        self._map: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._map:
            raise KeyError(
                f"'{name}' already registered in {self._name} registry"
            )
        self._map[name] = obj

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None):
        if obj is None:
            # Decorator usage: @registry.register() or @registry.register(name="X")
            def deco(fn_or_class: Any) -> Any:
                self._do_register(name or fn_or_class.__name__, fn_or_class)
                return fn_or_class

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(
                f"'{name}' not found in {self._name} registry. "
                f"Available: {sorted(self._map)}"
            )
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._map.items())

    def keys(self):
        return self._map.keys()

    def __len__(self) -> int:
        return len(self._map)

    def __repr__(self) -> str:
        return f"Registry({self._name}, {sorted(self._map)})"
