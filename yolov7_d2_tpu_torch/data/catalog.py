"""Dataset and metadata catalogs (a copy of
``yolov7_d2_tpu/data/catalog.py``), and ``register_custom_datasets`` (from
the JAX package's ``train_custom_datasets.py``)."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self) -> None:
        self._loaders: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, loader: Callable[[], List[dict]]) -> None:
        if name in self._loaders:
            raise KeyError(f"Dataset '{name}' already registered")
        self._loaders[name] = loader

    def get(self, name: str) -> List[dict]:
        if name not in self._loaders:
            raise KeyError(
                f"Dataset '{name}' not registered. Available: {sorted(self._loaders)}"
            )
        return self._loaders[name]()

    def list(self) -> List[str]:
        return sorted(self._loaders)

    def remove(self, name: str) -> None:
        self._loaders.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._loaders


class _Metadata:
    def __init__(self, name: str) -> None:
        self.name = name

    def set(self, **kwargs: Any) -> "_Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)


class _MetadataCatalog:
    def __init__(self) -> None:
        self._meta: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._meta:
            self._meta[name] = _Metadata(name)
        return self._meta[name]


DatasetCatalog = _DatasetCatalog()


MetadataCatalog = _MetadataCatalog()


def register_coco_instances(
    name: str, metadata: dict, json_file: str, image_root: str
) -> None:
    """Register a COCO-format dataset (reference uses d2's function of the
    same name for facemask/tl/visdrone/wearmask/voc)."""
    from yolov7_d2_tpu_torch.data.coco import load_coco_json

    DatasetCatalog.register(
        name, lambda: load_coco_json(json_file, image_root, name)
    )
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco",
        **metadata,
    )


def register_custom_datasets(extra=()):
    """Registers datasets whose files exist locally (same names as the
    reference: facemask, tl, visdrone, wearmask, voc), then every
    ``(name, json, image_root)`` of ``extra`` (from the JAX package's
    ``train_custom_datasets.py``)."""
    conventional = {
        "facemask": (
            "./datasets/facemask/annotations/instances_train2017.json",
            "./datasets/facemask/train2017",
        ),
        "tl": (
            "./datasets/tl/annotations/annotations_coco_tls_train.json",
            "./datasets/tl/JPEGImages",
        ),
        "visdrone": (
            "./datasets/visdrone/visdrone_coco/annotations/instances_VisDrone_train.json",
            "./datasets/visdrone/visdrone_coco/images",
        ),
        "wearmask": (
            "./datasets/wearmask/annotations/train.json",
            "./datasets/wearmask/images",
        ),
        "voc": (
            "./datasets/voc/annotations/train.json",
            "./datasets/voc/images",
        ),
    }
    for name, (js, root) in conventional.items():
        if os.path.exists(js) and name not in DatasetCatalog:
            register_coco_instances(name, {}, js, root)
    for name, js, root in extra:
        if name not in DatasetCatalog:
            register_coco_instances(name, {}, js, root)
