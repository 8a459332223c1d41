"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: flax variables with non-trivial BatchNorm, moved into a torch
module through ``jax_to_torch_state_dict``. Inputs and noise are made with
numpy and handed to both sides.

Importing this module inside a pytest-xdist worker gives the worker's
torch its share of the CPU's cores (:func:`share_cores_among_workers`)."""

from __future__ import annotations

import functools
import json
import os
import re
from pathlib import Path

import numpy as np
import torch


def share_cores_among_workers() -> None:
    """Each pytest-xdist worker is a process with its own torch, whose
    intra-op pool defaults to one thread a core: six workers on eight cores
    then run 48 threads, and the spinning threads slowed the port's CPU
    train steps 5-40x (on an 8-core host, a full-size Swin-S step of 2
    images at 64 px took 1.2 s alone and 50 s among four workers). In a
    worker, torch gets the cores over the workers (at least one); a run
    without xdist keeps torch's default."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // int(workers)))


share_cores_among_workers()

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


def write_mini_coco_keypoints(root, n: int = 6, seed: int = 5):
    """``n`` JPEGs of 40-80 px a side, each with 1-3 persons (category id
    1) carrying 17 COCO keypoints: visible (v 2), occluded (v 1) and
    unlabelled ones (0, 0, 0); image 0 also holds a keypoint beyond its
    right edge (v 2), a box 0.5 px wide (dropped by the mapper, its
    keypoints with it) and a crowd person. Returns (json path, image
    dir)."""
    import cv2

    img_dir = root / "imgs"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, anns = [], []

    def person(i, box, kp, crowd=0):
        anns.append({"id": len(anns) + 1, "image_id": i + 1,
                     "category_id": 1, "bbox": [float(v) for v in box],
                     "area": float(box[2] * box[3]), "iscrowd": crowd,
                     "keypoints": [float(v) for v in kp.reshape(-1)],
                     "num_keypoints": int((kp[:, 2] > 0).sum())})

    for i in range(n):
        h, w = (int(v) for v in rng.integers(40, 81, 2))
        img = (40 + rng.integers(0, 30, (h, w, 3))).astype(np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = int(rng.integers(10, w // 2)), int(rng.integers(12, h // 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y:y + bh, x:x + bw] = 200
            v = rng.integers(0, 3, 17).astype(np.float32)
            pts = np.stack([x + rng.uniform(0, bw, 17),
                            y + rng.uniform(0, bh, 17)], -1)
            kp = np.concatenate([np.where(v[:, None] > 0, pts, 0.0),
                                 v[:, None]], -1)
            if i == 0 and not anns:
                kp[5] = [w + 3.0, y + 1.0, 2.0]
            person(i, (x, y, bw, bh), kp)
        if i == 0:
            kp = np.zeros((17, 3))
            kp[0] = [5.0, 5.0, 2.0]
            person(i, (4, 4, 0.5, 10), kp)
            person(i, (0, 0, 12, 12), kp, crowd=1)
        name = f"p{i}.jpg"
        cv2.imwrite(str(img_dir / name), img)
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
    js = root / "person_keypoints.json"
    js.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person"}]}))
    return str(js), str(img_dir)


def tied_kpts_head(rng, a: int = 2100, p: int = 17, size: int = 64):
    """YOLOX-KPTS head outputs (``outputs`` [2, a, 6] of one class,
    ``kpts`` [2, a, p, 3], ``grids``, ``strides``) over ``a`` anchors in a
    ``size`` px frame, whose scores tie in runs of 3 and, in image 0, in a
    run of 20 straddling the 1024th place."""
    out = rng.normal(0, 1, (2, a, 6)).astype(np.float32)
    out[..., 4] = np.repeat(rng.normal(0, 2, (2, a // 3 + 1)), 3,
                            axis=1)[:, :a]
    out[..., 5] = 3.0
    order = np.argsort(-out[0, :, 4], kind="stable")
    out[0, order[1015:1035], 4] = out[0, order[1020], 4]
    kpts = rng.normal(0, 1, (2, a, p, 3)).astype(np.float32)
    cells = rng.integers(0, size // 8, (a, 2)).astype(np.float32)
    strides = rng.choice([8.0, 16.0, 32.0], a).astype(np.float32)
    return {"outputs": out, "kpts": kpts, "grids": cells, "strides": strides}


def assert_trajectory_close(name, final, init, want):
    """Each leaf's change over a trajectory, the port's against the JAX
    package's (flax trees of the final, initial and JAX final values): 3e-2
    relative, plus 5e-3 of the leaf's largest change and a noise floor
    (per-step gradient noise couples across parameters over steps)."""
    import jax

    flat_f = jax.tree_util.tree_leaves_with_path(final)
    flat_i = dict(jax.tree_util.tree_leaves_with_path(init))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    global_delta = max(
        float(np.abs(np.asarray(f, np.float64)
                     - np.asarray(flat_i[p], np.float64)).max())
        for p, f in flat_f)
    assert global_delta > 0
    for path, f in flat_f:
        i = np.asarray(flat_i[path], np.float64)
        d_port = np.asarray(f, np.float64) - i
        d_jax = np.asarray(flat_w[path], np.float64) - i
        scale = max(float(np.abs(d_jax).max()), 1e-10)
        noise = 4e-6 * max(float(np.abs(i).max()), 1e-3) + 3e-4 * global_delta
        np.testing.assert_allclose(
            d_port, d_jax, rtol=3e-2, atol=scale * 5e-3 + noise,
            err_msg=f"{name}{jax.tree_util.keystr(path)}")


def colliding_gts(classes: int = 5):
    """Scenes built to collide: gts of one shape around one centre (every
    builder puts them on the same anchors), near-copies in neighbour cells
    (the ratio builder's neighbour cells overlap), and invalid slots."""
    boxes = np.zeros((2, 10, 4), np.float32)
    base = np.array([20.0, 18.0, 52.0, 42.0], np.float32)   # wh (32, 24)
    for j in range(6):          # centres stay in cell (4, 3) at stride 8
        boxes[0, j] = base + np.float32(0.25 * j)
    boxes[0, 6] = [0.0, 0.0, 30.0, 60.0]
    boxes[0, 7] = [1.0, 2.0, 31.0, 62.0]
    boxes[1, :4] = [[40, 40, 56, 70], [41, 40, 57, 70], [36, 44, 52, 74],
                    [8, 8, 14, 20]]
    boxes[1, 4] = [9.0, 7.0, 15.0, 19.0]
    valid = np.zeros((2, 10), bool)
    valid[0, :8] = True
    valid[0, 3] = False                           # a hole among the copies
    valid[1, :5] = True
    classes = (np.arange(20).reshape(2, 10) % classes).astype(np.int32)
    return boxes, classes, valid


def decoded_candidates(rng, b, a, classes, size, cut=None):
    """Decoded candidates of an anchor head: xyxy boxes [b, a, 4] in a
    ``size`` frame, objectness [b, a] and class probabilities [b, a,
    classes]. With ``cut`` (a pre-NMS top-k), ties: runs of equal scores,
    classes tied inside a row, overlapping boxes among the tied ones, and
    20 more anchors at the score of rank ``cut - 10``, which the cut
    splits."""
    c = rng.uniform(0, size, (b, a, 2))
    wh = rng.uniform(4, 40, (b, a, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    obj = rng.uniform(0, 1, (b, a)).astype(np.float32)
    cls = rng.uniform(0, 1, (b, a, classes)).astype(np.float32)
    if cut is not None:
        n = obj[:, 1::3].shape[1]
        obj[:, 1::3] = obj[:, 0:-1:3][:, :n]
        cls[:, 1::3] = cls[:, 0:-1:3][:, :n]
        cls[:, ::5, 1] = cls[:, ::5, 0]
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, :n] + 1.0
        kth = np.sort(obj * cls.max(-1), -1)[:, ::-1][:, cut - 11]
        for i in range(b):
            run = rng.choice(np.flatnonzero(obj[i] * cls[i].max(-1) < kth[i]),
                             20, replace=False)
            obj[i, run] = 1.0
            cls[i, run] = np.minimum(cls[i, run], kth[i])
            cls[i, run, 2] = kth[i]
    return boxes, obj, cls


def assert_batches_equal(a, b):
    """Two dicts of arrays: the same keys, dtypes and values, exactly."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# the anchor-YOLO family at reduced depth, the same model on both sides
# ---------------------------------------------------------------------------

# AnchorYOLO keyword arguments of each architecture as its builder sets
# them, with a pre-built Darknet53 of one block a stage (the full depth is
# only for the card) and PAFPN at width 0.25 (CSP-Darknet53's fixed
# 256/512/1024 channels into a narrower neck; YOLOV7P's builder keeps 1.0,
# which the builder tests hold at full size): YOLOV7, YOLO with the SPP of
# YOLOFPN, YOLOV7P with the direct head and a unit-scale pixel mean and std
ANCHOR_ARCHS = {
    "YOLOV7": (dict(with_csp=True),
               dict(neck_type="pafpn", width_mul=0.25, depth_mul=0.33,
                    act="silu"), "cspdarknet53"),
    "YOLO": (dict(with_csp=False),
             dict(neck_type="yolov3", with_spp=True), "darknet53"),
    "YOLOV7P": (dict(with_csp=True),
                dict(neck_type="pafpn", width_mul=0.25, depth_mul=0.33,
                     act="silu", head_style="direct",
                     pixel_mean=(0.406, 0.456, 0.485),
                     pixel_std=(0.225, 0.224, 0.229)), "cspdarknet53"),
}
ANCHOR_CLASSES = 6
REDUCED_STAGES = (1, 1, 1, 1, 1)


def anchor_yolo_name_mapper(arch: str):
    import functools

    from yolov7_d2_tpu_torch.utils.weight_port import (
        map_anchor_yolo_torch_name,
    )

    return functools.partial(map_anchor_yolo_torch_name,
                             backbone_type=ANCHOR_ARCHS[arch][2])


def anchor_yolo_modules(arch: str, dtype=torch.float32):
    """(flax AnchorYOLO, port AnchorYOLO) of ``arch`` at reduced depth, the
    port's with its own random weights."""
    from yolov7_d2_tpu.models.backbones.darknet import Darknet53 as JaxDark
    from yolov7_d2_tpu.models.meta_arch.yolov7 import AnchorYOLO as JaxYOLO
    from yolov7_d2_tpu_torch.models.backbones.darknet import Darknet53
    from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import AnchorYOLO

    bb, kw, _ = ANCHOR_ARCHS[arch]
    jmodel = JaxYOLO(num_classes=ANCHOR_CLASSES,
                     backbone=JaxDark(stage_blocks=REDUCED_STAGES, **bb),
                     **kw)
    tmodel = AnchorYOLO(num_classes=ANCHOR_CLASSES,
                        backbone=Darknet53(stage_blocks=REDUCED_STAGES, **bb),
                        dtype=dtype, **kw)
    return jmodel, tmodel


def flax_variables_like(jmodel, images, rng: np.random.Generator):
    """Variables of the flax ``jmodel`` (whose input is ``images``, an
    array or a list of them) drawn with numpy, without running
    the flax init (its XLA compile costs seconds a model): conv kernels
    from N(0, 1/fan_in) (flax's lecun-normal scale), Swin's relative
    position bias tables from N(0, 1), then every BatchNorm and
    LayerNorm and every bias random (:func:`randomize_bn`)."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x),
        jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), images))

    def draw(path, leaf):
        if path[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        if path[-1] == "rel_pos_bias":
            return rng.normal(0.0, 1.0, leaf.shape).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)

    return randomize_bn({
        coll: jax.tree_util.tree_map_with_path(
            lambda path, leaf: draw(tuple(str(getattr(k, "key", k))
                                          for k in path), leaf),
            shapes[coll]) for coll in ("params", "batch_stats")
        if coll in shapes}, rng)


def anchor_yolo_pair(arch: str, size: int = 64, seed: int = 0):
    """(flax model, random variables (:func:`flax_variables_like`), port
    model holding the same weights in eval mode, uint8 NHWC images
    [2, size, size, 3])."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    jmodel, tmodel = anchor_yolo_modules(arch)
    variables = flax_variables_like(jmodel, images, rng)
    load_into(tmodel, variables, anchor_yolo_name_mapper(arch))
    return jmodel, variables, tmodel, images


# ---------------------------------------------------------------------------
# DETR and AnchorDETR at tiny size, the same model on both sides
# ---------------------------------------------------------------------------

DETR_DIR = REPO / "configs" / "coco" / "detr"
DETR_SIZE = 64
# ResNet-50 at 64 px, hidden 32, 4 heads, 2 + 2 layers, FFN 64, 3 classes
DETR_DIMS = dict(num_classes=3, hidden_dim=32, nheads=4, enc_layers=2,
                 dec_layers=2, dim_feedforward=64)
# the same models as config options (both packages' keys); 10 queries,
# AnchorDETR 4 positions x 2 patterns
DETR_TINY_OPTS = {
    "MODEL.DETR.NUM_CLASSES": 3, "MODEL.DETR.HIDDEN_DIM": 32,
    "MODEL.DETR.NHEADS": 4, "MODEL.DETR.ENC_LAYERS": 2,
    "MODEL.DETR.DEC_LAYERS": 2, "MODEL.DETR.DIM_FEEDFORWARD": 64,
    "MODEL.DETR.NUM_OBJECT_QUERIES": 10,
    "MODEL.DETR.NUM_QUERY_POSITION": 4, "MODEL.DETR.NUM_QUERY_PATTERN": 2,
    "INPUT.INPUT_SIZE": [DETR_SIZE, DETR_SIZE], "SOLVER.AMP.ENABLED": False,
}
# the gts of the gradient and train-step checks
DETR_GRAD_GT_SEED = 40


def merged_detr_cfg(get_cfg, yaml: str, **opts):
    """``configs/coco/detr/<yaml>`` merged into ``get_cfg()`` (either
    package's), then ``opts`` ({KEY: value})."""
    cfg = get_cfg()
    cfg.merge_from_file(str(DETR_DIR / yaml))
    cfg.merge_from_list(opts_list(opts))
    return cfg


def detr_variables_like(jmodel, shape, rng: np.random.Generator):
    """Variables of the flax ``jmodel`` drawn with numpy (no flax init):
    kernels N(0, 1/fan_in) (attention kernels [E, H, hd] by their E,
    ``out`` kernels [H, hd, E] by H hd), norm scales U(0.5, 1.5), biases
    N(0, 0.3), BN statistics random, query embeddings and patterns N(0,
    1), anchor points U(-2, 2) (their sigmoid spans (0.12, 0.88))."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x),
        jnp.zeros(shape, jnp.float32))

    def draw(path, leaf):
        p = tuple(str(getattr(k, "key", k)) for k in path)
        s = leaf.shape
        if p[-1] == "kernel":
            fan = (s[0] * s[1] if len(s) == 3 and p[-2] == "out"
                   else s[0] if len(s) == 3 else int(np.prod(s[:-1])))
            return rng.normal(0.0, fan ** -0.5, s)
        if p[-1] == "scale" or p[-1] == "var":
            return rng.uniform(0.5, 1.5 if p[-1] == "scale" else 2.0, s)
        if p[-1] in ("bias", "mean"):
            return rng.normal(0.0, 0.3 if p[-1] == "bias" else 0.5, s)
        if p[-1] == "anchor_points":
            return rng.uniform(-2.0, 2.0, s)
        return rng.normal(0.0, 1.0, s)

    return {coll: jax.tree_util.tree_map_with_path(
        lambda path, leaf: draw(path, leaf).astype(np.float32), tree)
        for coll, tree in shapes.items()}


@functools.lru_cache(maxsize=None)
def detr_pair(kind: str, attention_type: str = "RCDA",
              spatial_prior: str = "learned"):
    """(flax model, variables, port model holding them in eval mode,
    integer-valued float32 images [2, 64, 64, 3], name map) of the tiny
    DETR ("detr", dropout 0) or AnchorDETR ("anchor"), built once a
    process."""
    from yolov7_d2_tpu.models.meta_arch import detr as jd
    from yolov7_d2_tpu.models.meta_arch import detr_variants as jdv
    from yolov7_d2_tpu_torch.models.meta_arch import detr as td
    from yolov7_d2_tpu_torch.models.meta_arch import detr_variants as tdv
    from yolov7_d2_tpu_torch.utils import weight_port as twp

    rng = np.random.default_rng(
        {"detr": 0, "anchor": 1}[kind] + 10 * (spatial_prior == "grid"))
    images = rng.integers(0, 256, (2, DETR_SIZE, DETR_SIZE, 3)).astype(
        np.float32)
    if kind == "detr":
        kw = dict(DETR_DIMS, num_queries=10, dropout=0.0)
        jmodel, tmodel = jd.DETR(**kw), td.DETR(**kw)
        mapper = twp.map_detr_torch_name
    else:
        kw = dict(DETR_DIMS, num_query_position=4, num_query_pattern=2,
                  attention_type=attention_type, spatial_prior=spatial_prior)
        jmodel, tmodel = jdv.AnchorDETR(**kw), tdv.AnchorDETR(**kw)
        mapper = functools.partial(twp.map_anchor_detr_torch_name,
                                   attention_type=attention_type)
    variables = detr_variables_like(jmodel, images.shape, rng)
    load_into(tmodel, variables, mapper)
    return jmodel, variables, tmodel, images, mapper


def detr_gt(rng, b=2, g=6, counts=(4, 6), classes=3, size=DETR_SIZE,
            ties=False):
    """A DETR batch's gts: xyxy boxes in pixels [b, g, 4], classes,
    validity (``counts`` valid slots first); with ``ties`` gts 1-2 copy gt
    0 in image 0."""
    boxes = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(counts):
        xy = rng.uniform(0, size * 0.6, (n, 2))
        wh = rng.uniform(4, size * 0.4, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + wh], -1)
        cls[i, :n] = rng.integers(0, classes, n)
        valid[i, :n] = True
    if ties:
        boxes[0, 1:3] = boxes[0, 0]
        cls[0, 1:3] = cls[0, 0]
    return {"gt_boxes": boxes, "gt_classes": cls, "gt_valid": valid}


def check_detr_gradients(kind, jgrads, jlosses, monkeypatch,
                         grad_tol: float = 1e-4, loss_rtol: float = 1e-4):
    """One train-mode forward, ``detr_losses`` (softmax CE for "detr",
    focal for "anchor") and backward of the port's pair model on the gts
    of ``DETR_GRAD_GT_SEED``, in NCHW (the normalize's plain version made
    contiguous; ROADMAP.md C.20), against the JAX ``jgrads`` and
    ``jlosses``: every loss term within ``loss_rtol``, every parameter's
    gradient within ``grad_tol`` of the larger of its norm and 1e-2 of the
    whole gradient's (a gradient that is 0 in exact arithmetic, as the
    first decoder self-attention's query and key weights', which read
    zeros, is float32 noise)."""
    from yolov7_d2_tpu_torch.models.meta_arch import detr as td

    _, variables, tmodel, images, mapper = detr_pair(kind)
    gt = detr_gt(np.random.default_rng(DETR_GRAD_GT_SEED))
    plain = td.normalize_images_plain
    monkeypatch.setattr(td, "normalize_images_plain",
                        lambda *a: plain(*a).contiguous())
    tmodel.train()
    tmodel.zero_grad()
    try:
        losses = td.detr_losses(
            tmodel(torch.from_numpy(images)),
            {k: torch.from_numpy(v) for k, v in gt.items()}, 3,
            (DETR_SIZE, DETR_SIZE), use_focal=kind == "anchor")
        losses["total_loss"].backward()
    finally:
        tmodel.eval()
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=loss_rtol,
                                   err_msg=k)
    grads = jax_to_torch_state_dict(
        numpy_variables({"params": jgrads,
                         "batch_stats": variables["batch_stats"]}),
        tmodel.state_dict(), mapper)
    names = [n for n, _ in tmodel.named_parameters()]
    whole = float(np.sqrt(sum(np.sum(np.square(grads[n], dtype=np.float64))
                              for n in names)))
    checked = 0
    for name, p in tmodel.named_parameters():
        want_g = grads[name]
        err = float(np.abs(p.grad.numpy() - want_g).max())
        floor = max(float(np.linalg.norm(want_g)), 1e-2 * whole)
        assert err <= grad_tol * floor, (name, err)
        checked += float(np.abs(want_g).max()) > 0
    assert checked > 150


def jit_o0(fn):
    """``jax.jit(fn)`` compiled at XLA's backend optimization level 0, for
    a JAX reference that a test runs once or twice: on the CPU, LLVM's
    optimization of a whole model's step costs more than it saves (a
    YOLOMask step: 26 s to compile and 1 s to run at the default level,
    12 s and 3 s at level 0; the results agree within 1e-6 relative).
    Positional arguments only."""
    import jax

    jitted = jax.jit(fn)
    compiled = {}

    def call(*args):
        key = jax.tree_util.tree_structure(args), tuple(
            (getattr(a, "shape", None), str(getattr(a, "dtype", type(a))))
            for a in jax.tree_util.tree_leaves(args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[key](*args)

    return call


def assert_leaves_match_jax(model, jax_model, mapper, size=128):
    """Every key of ``model.state_dict()`` takes one leaf of the JAX
    model's init (shapes by ``jax.eval_shape``) and no leaf is left
    over (``jax_to_torch_state_dict`` raises otherwise); the parameter
    and BatchNorm-statistic counts are the JAX model's."""
    import jax
    import jax.numpy as jnp

    from yolov7_d2_tpu_torch.utils.weight_port import (
        jax_to_torch_state_dict as to_torch,
    )

    shapes = jax.eval_shape(
        lambda x: jax_model.init(jax.random.PRNGKey(0), x),
        jnp.zeros((1, size, size, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    leaves = to_torch(zeros, model.state_dict(), mapper)
    assert sorted(leaves) == sorted(model.state_dict())
    count = {coll: sum(int(np.prod(s.shape))
                       for s in jax.tree_util.tree_leaves(shapes.get(coll,
                                                                     {})))
             for coll in ("params", "batch_stats")}
    stats = sum(v.numel() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var")))
    assert sum(p.numel() for p in model.parameters()) == count["params"]
    assert stats == count["batch_stats"]
    return count


def rcnn_mini_cfg(get_cfg, arch: str = "MaskRCNN", mask_on: bool = True,
                  **extra):
    """The JAX ``tests/test_mask_rcnn.py`` ``_mini_cfg`` (ResNet-18, 64 px,
    5 classes, 6 stuff classes, 32 candidates a level, 16 proposals) in
    either package's CfgNode (``get_cfg``); ``extra`` keys with dots,
    string values."""
    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.MASK_ON = mask_on
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 6
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.RPN.PRE_NMS_TOPK = 32
    cfg.MODEL.RPN.POST_NMS_TOPK = 16
    cfg.MODEL.YOLO.MAX_BOXES_NUM = 4
    cfg.INPUT.INPUT_SIZE = [64, 64]
    cfg.SOLVER.AMP.ENABLED = False
    cfg.SOLVER.EMA.ENABLED = False
    for k, v in extra.items():
        cfg.merge_from_list([k, v])
    return cfg
