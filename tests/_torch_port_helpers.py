"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: flax variables with non-trivial BatchNorm, moved into a torch
module through ``jax_to_torch_state_dict``. Inputs and noise are made with
numpy and handed to both sides."""

from __future__ import annotations

import json
import re
from pathlib import Path

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


# ---------------------------------------------------------------------------
# a synthetic mini-COCO for the feed, eval and CLI tests
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
YOLOX_S_YAML = str(REPO / "configs" / "coco" / "yolox_s.yaml")

# YOLOX-s cut to 64 px, width 0.125 and 2 classes, f32, one loader thread
TINY_OPTS = {
    "MODEL.YOLO.CLASSES": 2,
    "MODEL.YOLO.WIDTH_MUL": 0.125,
    "MODEL.YOLO.MAX_BOXES_NUM": 8,
    "INPUT.INPUT_SIZE": [64, 64],
    "INPUT.MIN_SIZE_TRAIN": [64],
    "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64,
    "INPUT.MAX_SIZE_TEST": 128,
    "INPUT.MOSAIC_AND_MIXUP.MOSAIC_WIDTH_RANGE": [48, 80],
    "INPUT.MOSAIC_AND_MIXUP.MOSAIC_HEIGHT_RANGE": [48, 80],
    "SOLVER.IMS_PER_BATCH": 4,
    "SOLVER.BASE_LR": 0.01,
    "SOLVER.WARMUP_ITERS": 2,
    "SOLVER.AMP.ENABLED": False,
    "DATALOADER.NUM_WORKERS": 1,
    "MODEL.DEVICE": "cpu",
}


def opts_list(opts):
    """{KEY: value} -> the ``KEY VALUE`` strings of a command line."""
    out = []
    for k, v in opts.items():
        out += [k, v if isinstance(v, str) else repr(v)]
    return out


def tiny_cfg(get_cfg, **extra):
    """A merged, unfrozen ``CfgNode`` of ``get_cfg`` (either package's):
    ``configs/coco/yolox_s.yaml`` with :data:`TINY_OPTS` and ``extra``
    (keys with ``__`` for ``.``)."""
    cfg = get_cfg()
    cfg.merge_from_file(YOLOX_S_YAML)
    opts = dict(TINY_OPTS, **{k.replace("__", "."): v
                              for k, v in extra.items()})
    if cfg.MODEL.DEVICE == "tpu":  # the JAX package's config
        opts.pop("MODEL.DEVICE")
    cfg.merge_from_list(opts_list(opts))
    return cfg


def write_mini_coco(root, n: int = 8, seed: int = 7):
    """``n`` JPEGs of 40-80 px a side, each with 1-3 flat boxes of two
    categories (ids 1 and 3, so that the ids are remapped), plus one crowd
    box; returns (json path, image dir)."""
    import cv2

    img_dir = root / "imgs"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(40, 81, 2))
        img = (40 + rng.integers(0, 30, (h, w, 3))).astype(np.uint8)
        for j in range(int(rng.integers(1, 4))):
            bw = int(rng.integers(8, w // 2))
            bh = int(rng.integers(8, h // 2))
            x = int(rng.integers(0, w - bw))
            y = int(rng.integers(0, h - bh))
            cat = (1, 3)[j % 2]
            img[y:y + bh, x:x + bw] = 210 if cat == 1 else 130
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": cat, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0})
        if i == 0:
            anns.append({"id": len(anns) + 1, "image_id": 1,
                         "category_id": 1, "bbox": [0, 0, 10, 10],
                         "area": 100, "iscrowd": 1})
        name = f"im{i}.jpg"
        cv2.imwrite(str(img_dir / name), img)
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
    js = root / "ann.json"
    js.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "light"},
                       {"id": 3, "name": "dark"}]}))
    return str(js), str(img_dir)


def assert_batches_equal(a, b):
    """Two dicts of arrays: the same keys, dtypes and values, exactly."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)
