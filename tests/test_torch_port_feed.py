"""The port's data feed against the JAX package's, on the CPU: the config
tree, ``BoxMode``, the COCO records, the seeded augmentations, the mapper
sample streams (native and cv2 letterbox), the ``DataLoader`` batches, the
packed shards and their loaders. The port keeps its own copies of these
modules; every comparison here is exact (same dtypes, same values), since
both sides run the same numpy and OpenCV code on the same inputs.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    REPO,
    assert_batches_equal,
    tiny_cfg,
    write_mini_coco,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.data import coco as jax_coco
from yolov7_d2_tpu.data import loader as jax_loader
from yolov7_d2_tpu.data import mappers as jax_mappers
from yolov7_d2_tpu.data import packed_cache as jax_packed
from yolov7_d2_tpu.data.transforms import augment as jax_aug
from yolov7_d2_tpu.structures.boxes import BoxMode as JaxBoxMode
from yolov7_d2_tpu_torch import native
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data import coco, loader, mappers, packed_cache
from yolov7_d2_tpu_torch.data.transforms import augment
from yolov7_d2_tpu_torch.structures.boxes import BoxMode

YOLOX_YAMLS = sorted(p.name for p in (REPO / "configs" / "coco").glob(
    "yolox*.yaml"))


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """12 records of the synthetic mini-COCO, as each package loads them."""
    js, root = write_mini_coco(tmp_path_factory.mktemp("mini"), n=12)
    return js, root


@pytest.mark.parametrize("name", YOLOX_YAMLS)
def test_config_merges_like_jax(name):
    path = str(REPO / "configs" / "coco" / name)
    ours, theirs = get_cfg(), jax_get_cfg()
    ours.merge_from_file(path)
    theirs.merge_from_file(path)
    assert (ours.MODEL.DEVICE, theirs.MODEL.DEVICE) == ("cuda", "tpu")
    ours.MODEL.DEVICE = "tpu"
    assert ours.dump() == theirs.dump()


def test_box_mode_matches_jax():
    assert {m.name: int(m) for m in BoxMode} == \
        {m.name: int(m) for m in JaxBoxMode}
    # the conversions the feed makes: COCO corner xywh, the center-xywh
    # quirk of XYWH_ABS, and xyxy as it is; crowd boxes dropped
    anns = [{"bbox": [3.5, 4.0, 10.0, 6.0], "bbox_mode": int(mode),
             "category_id": i, "iscrowd": 0}
            for i, mode in enumerate(BoxMode)]
    anns.append({"bbox": [1, 2, 3, 4], "category_id": 9, "iscrowd": 1})
    record = {"annotations": anns}
    for got, want in zip(mappers.annotations_to_arrays(record),
                         jax_mappers.annotations_to_arrays(record)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_load_coco_json_matches_jax(mini):
    js, root = mini
    got = coco.load_coco_json(js, root, "port_mini_records")
    want = jax_coco.load_coco_json(js, root, "jax_mini_records")
    assert got == want
    # category ids 1 and 3 remapped to contiguous classes
    assert {a["category_id"] for r in got for a in r["annotations"]} \
        == {0, 1}


def _scene(seed, h=70, w=90, n=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, min(h, w) / 2, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (n, 2))],
                           1).astype(np.float32)
    return img, boxes, rng.integers(0, 2, n).astype(np.int64)


def _augment_case(mod, case):
    img, boxes, classes = _scene(1)
    img_b, boxes_b, classes_b = _scene(2, 50, 40)
    rng = np.random.default_rng(11)
    if case == "letterbox":
        return (mod.letterbox(img, boxes, (64, 64), 114)
                + mod.letterbox(img, boxes, (64, 64), 114, scaleup=False))
    if case == "hflip":
        return mod.hflip(img, boxes)
    if case == "random_perspective":
        return mod.random_perspective(img, boxes, classes, rng,
                                      target_size=(64, 64))
    if case == "mosaic4":
        tiles = [_scene(s, 40 + 9 * s, 70 - 7 * s) for s in range(4)]
        return mod.mosaic4([t[0] for t in tiles], [t[1] for t in tiles],
                           [t[2] for t in tiles], (32, 40), rng)
    if case == "mixup":
        return mod.mixup(img, boxes, classes, img_b, boxes_b, classes_b, rng)
    if case == "hsv_distort":
        return (mod.hsv_distort(img, rng),)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["letterbox", "hflip", "random_perspective",
                                  "mosaic4", "mixup", "hsv_distort"])
def test_augment_matches_jax(case):
    got, want = _augment_case(augment, case), _augment_case(jax_aug, case)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        if isinstance(g, np.ndarray):
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(params=["native", "cv2"])
def letterbox_kind(request, monkeypatch):
    """Both packages' ``SimpleDatasetMapper`` letterbox: the native one
    (both libraries built) or cv2's on both sides."""
    if request.param == "native":
        assert native.native_available(), native.BUILD_ERROR
        assert jax_mappers._NATIVE
        monkeypatch.setattr(mappers, "_NATIVE", True)
    else:
        monkeypatch.setattr(mappers, "_NATIVE", False)
        monkeypatch.setattr(jax_mappers, "_NATIVE", False)
    return request.param


def _stream(mapper, records, disable_after=None):
    out = []
    for i, r in enumerate(records):
        if disable_after is not None and i == disable_after:
            mapper.enable_aug = False
        out.append(mapper(r))
    return out


@pytest.mark.parametrize("kind", ["simple_train", "simple_eval", "yolox"])
def test_mapper_stream_matches_jax(mini, letterbox_kind, kind):
    js, root = mini
    records = coco.load_coco_json(js, root)
    if kind == "yolox":
        # mosaic from the 4th record, mixup and HSV on, then the aug
        # switch off for the last 4 (the plain path with its letterbox)
        make = [m.YOLOXDatasetMapper(tiny_cfg(g, INPUT__DISTORTION__ENABLED=
                                              True), seed=3)
                for m, g in ((mappers, get_cfg),
                             (jax_mappers, jax_get_cfg))]
        streams = [_stream(m, records, disable_after=8) for m in make]
    else:
        is_train = kind == "simple_train"
        streams = [_stream(m.SimpleDatasetMapper(
            tiny_cfg(g, INPUT__GRID_MASK__ENABLED=True), is_train=is_train,
            seed=3), records)
            for m, g in ((mappers, get_cfg), (jax_mappers, jax_get_cfg))]
    for got, want in zip(*streams):
        assert_batches_equal(got, want)


def test_simple_mapper_takes_the_native_letterbox(mini, monkeypatch):
    records = coco.load_coco_json(*mini)
    mapper = mappers.SimpleDatasetMapper(tiny_cfg(get_cfg), is_train=False)
    out = {}
    for flag in (True, False):
        monkeypatch.setattr(mappers, "_NATIVE", flag)
        out[flag] = [mapper(r)["image"] for r in records]
    assert any(not np.array_equal(a, b) for a, b in zip(out[True],
                                                         out[False]))


def test_native_letterbox_differs_from_cv2_by_one_level_at_most():
    img = np.random.default_rng(5).integers(0, 256, (50, 100, 3),
                                            dtype=np.uint8)
    nat, scale = native.letterbox_u8(img, (64, 64), 114)
    ref, _, ref_scale = augment.letterbox(img, np.zeros((0, 4)), (64, 64),
                                          114)
    assert abs(scale - ref_scale) < 1e-6
    assert np.abs(nat.astype(int) - ref.astype(int)).max() <= 1


def test_native_builds_under_build_not_beside_the_sources():
    assert native.native_available(), native.BUILD_ERROR
    built = list((REPO / "build" / "native").glob("libyolo_preprocess_*.so"))
    assert built
    pkg = Path(native.__file__).parent
    assert sorted(p.name for p in pkg.iterdir()
                  if p.suffix in (".so", ".o")) == []


def _loader_batches(mod, get, records, n, **kw):
    cfg = tiny_cfg(get)
    mapper = mod[0].YOLOXDatasetMapper(cfg, seed=1)
    ld = mod[1].build_detection_train_loader(cfg, records, mapper, **kw)
    it = iter(ld)
    return [next(it) for _ in range(n)]


def test_data_loader_batches_match_jax(mini):
    js, root = mini
    records = coco.load_coco_json(js, root)
    got = _loader_batches((mappers, loader), get_cfg, records, 5, seed=2)
    want = _loader_batches((jax_mappers, jax_loader), jax_get_cfg, records,
                           5, seed=2)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    # the eval loader: one pass, in order, the last batch partial
    evals = []
    for m, ld, g in ((mappers, loader, get_cfg),
                     (jax_mappers, jax_loader, jax_get_cfg)):
        cfg = tiny_cfg(g, SOLVER__IMS_PER_BATCH=5)
        evals.append(list(ld.build_detection_test_loader(
            cfg, records, m.SimpleDatasetMapper(cfg, is_train=False))))
    assert [len(b["image"]) for b in evals[0]] == [5, 5, 2]
    for g, w in zip(*evals):
        assert_batches_equal(g, w)


def test_packed_shards_and_loaders_match_jax(mini, tmp_path):
    js, root = mini
    records = coco.load_coco_json(js, root)
    dirs = {}
    for name, mod, get in (("port", packed_cache, get_cfg),
                           ("jax", jax_packed, jax_get_cfg)):
        cfg = tiny_cfg(get)
        cfg.freeze()
        geo, plain = tmp_path / name / "geo", tmp_path / name / "plain"
        assert mod.write_geometry_shards(records, cfg, str(geo), epochs=2,
                                         shard_size=5, seed=4,
                                         mapper_seed=6) == 24
        assert mod.write_plain_shards(records, cfg, str(plain),
                                      shard_size=5, seed=4) == 12
        dirs[name] = (geo, plain)
    for got_dir, want_dir in zip(dirs["port"], dirs["jax"]):
        files = sorted(p.name for p in got_dir.iterdir())
        assert files == sorted(p.name for p in want_dir.iterdir())
        for f in files:
            if f.endswith(".npz"):
                with np.load(got_dir / f) as a, np.load(want_dir / f) as b:
                    assert_batches_equal(dict(a), dict(b))
            else:
                assert (got_dir / f).read_text() == (want_dir / f).read_text()

    def batches(mod, geo, plain, n=9):
        aug = mod.PackedShardLoader(str(geo), 4, image_dtype=np.uint8,
                                    seed=1)
        rest = mod.PackedShardLoader(str(plain), 4, image_dtype=np.uint8,
                                     seed=8)
        it = iter(mod.SwitchingPackedLoader(aug, rest, switch_after=5))
        return [next(it) for _ in range(n)]

    for g, w in zip(batches(packed_cache, *dirs["port"]),
                    batches(jax_packed, *dirs["jax"])):
        assert_batches_equal(g, w)
    once = packed_cache.PackedShardLoader(str(dirs["port"][1]), 5,
                                          shuffle=False, infinite=False)
    assert [len(b["image"]) for b in once] == [5, 5, 2]


def test_cuda_prefetcher_on_the_cpu_wraps_and_filters():
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
                "gt_valid": rng.random((2, 4)) < 0.5,
                "image_id": np.arange(2)} for _ in range(3)]
    got = list(loader.CudaPrefetcher(batches, "cpu",
                                     fields=("image", "gt_valid")))
    assert len(got) == 3
    for g, b in zip(got, batches):
        assert sorted(g) == ["gt_valid", "image"]
        for k, v in g.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), b[k])
