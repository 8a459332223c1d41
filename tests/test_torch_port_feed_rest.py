"""The rest of the feed against the JAX package, on the CPU at tiny size:

* ``data/multiscale.py``: ``size_for_step`` over 200 steps,
  ``default_size_set``, ``MultiScaleMapperWrapper`` and
  ``train/trainer.MultiScaleHook``, equal to JAX's;
* ``data/mp_loader.py`` with ``data/mappers.MapperFactory`` (the YOLOX
  mosaic mapper on the synthetic mini-COCO, a finite pass): with one
  worker, batch for batch equal to the JAX loader's; with two, the same
  multiset of ``image_id``s as the JAX loader's with two, and no worker
  imported ``jax`` or created a CUDA context; a worker's error reaches
  the parent;
* ``hsv_distort`` within 2e-3 on 0..255 of the JAX function (a pixel
  beyond it fails the test, and the message says how many sit at a hue
  sector's boundary), on integer and fractional pixels, grays and ties;
* ``DevicePhotometric.apply`` with the draws the JAX ``DevicePhotometric``
  makes from its key (MixUp on and off, the distortion on): the image
  within 2e-3, the boxes, classes and validity exactly; with MixUp off
  and GridMask on, the distorted image goes through GridMask's float32
  instance.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _feed_worker_probe import ProbeFactory
from _torch_port_helpers import assert_batches_equal, tiny_cfg, write_mini_coco
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.data import coco as jax_coco
from yolov7_d2_tpu.data import device_aug as jax_aug
from yolov7_d2_tpu.data import mappers as jax_mappers
from yolov7_d2_tpu.data import mp_loader as jax_mp
from yolov7_d2_tpu.data import multiscale as jax_ms
from yolov7_d2_tpu.train.trainer import MultiScaleHook as JaxHook
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data import coco, device_aug, mappers, mp_loader
from yolov7_d2_tpu_torch.data import multiscale
from yolov7_d2_tpu_torch.kernels.grid_mask import grid_mask_plain
from yolov7_d2_tpu_torch.train.trainer import MultiScaleHook

TOL = 2e-3


# ---------------------------------------------------------------------------
# the multi-scale schedule
# ---------------------------------------------------------------------------

def test_size_schedule_matches_jax():
    sizes = multiscale.default_size_set(416, 3)
    assert sizes == jax_ms.default_size_set(416, 3)
    assert multiscale.default_size_set() == jax_ms.default_size_set()
    for seed, interval in ((0, 10), (5, 3)):
        assert [multiscale.size_for_step(s, sizes, interval, seed)
                for s in range(200)] == [
            jax_ms.size_for_step(s, sizes, interval, seed)
            for s in range(200)]


def test_wrapper_and_hook_follow_the_steps_as_in_jax():
    sizes = [(320, 320), (416, 416), (512, 512)]
    wrappers = [m.MultiScaleMapperWrapper(_Recorder(), sizes, interval=2,
                                          seed=1) for m in (multiscale,
                                                            jax_ms)]
    hooks = (MultiScaleHook(wrappers[0]), JaxHook(wrappers[1]))
    got, want = [], []
    for step in range(12):
        trainer = types.SimpleNamespace(storage=types.SimpleNamespace(
            iter=step))
        for hook, wrapper, out in zip(hooks, wrappers, (got, want)):
            hook.after_step(trainer)
            assert wrapper({"image_id": step}) == {"image_id": step}
            out.append(wrapper.mapper.input_size)
    assert got == want and len(set(got)) > 1


class _Recorder:
    input_size = None

    def __call__(self, record):
        return record


# ---------------------------------------------------------------------------
# the process-worker loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    js, root = write_mini_coco(tmp_path_factory.mktemp("mini"), n=12)
    recs = coco.load_coco_json(js, root)
    assert recs == jax_coco.load_coco_json(js, root)
    return recs


def _loader(pkg, mp, cfg, records, workers, factory=None):
    factory = factory or pkg.MapperFactory(pkg.YOLOXDatasetMapper, cfg)
    return mp.MultiProcessDataLoader(records, factory, batch_size=4,
                                     num_workers=workers, infinite=False,
                                     seed=3)


def test_mp_loader_matches_jax(records):
    want = list(_loader(jax_mappers, jax_mp, tiny_cfg(jax_get_cfg),
                        records, 1))
    got = list(_loader(mappers, mp_loader, tiny_cfg(get_cfg), records, 1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    # two workers: each permutes with its own seed and takes every second
    # record from its id on, as in JAX (so an epoch may see a record twice
    # and miss another: ROADMAP.md C.46)
    cfg = tiny_cfg(get_cfg)
    two = list(_loader(mappers, mp_loader, cfg, records, 2, ProbeFactory(
        mappers.MapperFactory(mappers.YOLOXDatasetMapper, cfg))))
    jax_two = list(_loader(jax_mappers, jax_mp, tiny_cfg(jax_get_cfg),
                           records, 2))
    ids = sorted(int(i) for b in two for i in b["image_id"])
    assert len(ids) == len(records)
    assert ids == sorted(int(i) for b in jax_two for i in b["image_id"])
    assert not any(b["worker_jax"].any() or b["worker_cuda"].any()
                   for b in two)


def test_mp_loader_reports_a_worker_error(records):
    cfg = tiny_cfg(get_cfg)
    broken = [dict(r, annotations=None) for r in records]
    with pytest.raises(RuntimeError, match="worker 0"):
        list(_loader(mappers, mp_loader, cfg, broken, 1))


# ---------------------------------------------------------------------------
# HSV on the card
# ---------------------------------------------------------------------------

def _hsv_images(rng, b=3, s=16):
    img = rng.integers(0, 256, (b, s, s, 3)).astype(np.float32)
    img[0, :4] = rng.uniform(0, 255, (4, s, 3))         # fractional
    img[1, :2] = rng.integers(0, 256, (2, s, 1))        # grays
    img[1, 2:4, :, :2] = rng.integers(0, 256, (2, s, 1))  # b == g ties
    img[2, :2, :, 1:] = rng.integers(0, 256, (2, s, 1))   # g == r ties
    img[2, 2, :4] = 0.0                                   # black
    return img


def _assert_hsv_close(got, want, img):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bad = err.max(-1) > TOL
    # a pixel whose hue sector flips at a boundary is off by far more
    assert not bad.any(), (
        f"{int(bad.sum())} pixels off by more than {TOL} (max "
        f"{err.max():.3g}), a sector flip where the gap is large; inputs "
        f"{img[bad][:4].tolist()}")


def test_hsv_distort_matches_jax():
    rng = np.random.default_rng(11)
    img = _hsv_images(rng)
    dhue = np.asarray([-0.1, 0.07, 0.0], np.float32)
    dsat = np.asarray([1.4, 1 / 1.3, 1.0], np.float32)
    dexp = np.asarray([1 / 1.45, 1.2, 1.5], np.float32)
    want = jax.vmap(jax_aug.hsv_distort)(jnp.asarray(img), dhue, dsat,
                                        dexp)
    got = device_aug.hsv_distort(torch.from_numpy(img),
                                 torch.from_numpy(dhue),
                                 torch.from_numpy(dsat),
                                 torch.from_numpy(dexp))
    assert got.dtype == torch.float32
    _assert_hsv_close(got.numpy(), want, img)


def _jax_draws(key, b, aug):
    """The draws of the JAX ``DevicePhotometric.__call__`` (:672-716) from
    ``key``, as the port's ``PhotoDraws``."""
    k = jax.random.split(key, 8)
    sat = jax.random.uniform(k[3], (b,), minval=1.0, maxval=aug.saturation)
    exp = jax.random.uniform(k[5], (b,), minval=1.0, maxval=aug.exposure)

    def t(x):
        return torch.from_numpy(np.array(x))

    return device_aug.PhotoDraws(
        perm=t(jax.random.permutation(k[0], b)).long(),
        do_mix=t(jax.random.uniform(k[1], (b,)) < 0.5),
        grid_params=torch.tensor(device_aug.IDENTITY_GRID,
                                 dtype=torch.int32).expand(b, 5),
        do_flip=t(jax.random.uniform(k[7], (b,)) < aug.flip_prob),
        dhue=t(jax.random.uniform(k[2], (b,), minval=-aug.hue,
                                  maxval=aug.hue)),
        dsat=t(jnp.where(jax.random.uniform(k[4], (b,)) < 0.5, sat,
                         1.0 / sat)),
        dexp=t(jnp.where(jax.random.uniform(k[6], (b,)) < 0.5, exp,
                         1.0 / exp)))


def _photo_batch(rng, b=4, s=32, g=5):
    boxes = np.sort(rng.uniform(0, s, (b, g, 2, 2)), axis=2).reshape(
        b, g, 4)[..., [0, 2, 1, 3]].astype(np.float32)
    valid = rng.uniform(size=(b, g)) < 0.7
    return {"image": rng.integers(0, 256, (b, s, s, 3)).astype(np.uint8),
            "gt_boxes": np.where(valid[..., None], boxes, 0.0).astype(
                np.float32),
            "gt_classes": rng.integers(0, 2, (b, g)).astype(np.int32),
            "gt_valid": valid}


@pytest.mark.parametrize("mixup", [True, False])
def test_device_photometric_with_hsv_matches_jax(mixup):
    opts = dict(INPUT__DISTORTION__ENABLED=True,
                INPUT__MOSAIC_AND_MIXUP__ENABLE_MIXUP=mixup,
                MODEL__YOLO__MAX_BOXES_NUM=6)
    jaug = jax_aug.DevicePhotometric(tiny_cfg(jax_get_cfg, **opts))
    aug = device_aug.DevicePhotometric(YoloxConfig.from_cfg(
        tiny_cfg(get_cfg, **opts)))
    assert (aug.hue, aug.saturation, aug.exposure) == (
        jaug.hue, jaug.saturation, jaug.exposure)
    rng = np.random.default_rng(12 + mixup)
    batch = _photo_batch(rng)
    key = jax.random.PRNGKey(21 + mixup)
    want = jaug(key, {k: jnp.asarray(v) for k, v in batch.items()})
    draws = _jax_draws(key, 4, jaug)
    got = aug.apply({k: torch.from_numpy(v) for k, v in batch.items()},
                    draws)
    assert got["image"].dtype == torch.float32
    _assert_hsv_close(got["image"].numpy(), want["image"],
                      batch["image"].astype(np.float32))
    for k in ("gt_boxes", "gt_classes", "gt_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the draws the port makes itself: U(-hue, hue), a gain or its
    # reciprocal in [1/S, S]
    own = aug.draw(torch.Generator().manual_seed(0), 64, 32, 32)
    assert float(own.dhue.abs().max()) <= aug.hue
    for gain, top in ((own.dsat, aug.saturation), (own.dexp, aug.exposure)):
        assert float(gain.min()) >= 1 / top and float(gain.max()) <= top
        assert 0 < int((gain < 1).sum()) < 64


def test_hsv_then_float32_grid_mask_with_mixup_off():
    cfg = YoloxConfig.from_cfg(tiny_cfg(
        get_cfg, INPUT__DISTORTION__ENABLED=True,
        INPUT__MOSAIC_AND_MIXUP__ENABLE_MIXUP=False,
        INPUT__GRID_MASK__ENABLED=True, INPUT__GRID_MASK__PROB=1.0))
    aug = device_aug.DevicePhotometric(cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in _photo_batch(np.random.default_rng(3)).items()}
    draws = aug.draw(torch.Generator().manual_seed(1), 4, 32, 32)
    draws.do_flip = torch.zeros(4, dtype=torch.bool)
    got = aug.apply(batch, draws)
    want = grid_mask_plain(device_aug.hsv_distort(
        batch["image"].float(), draws.dhue, draws.dsat, draws.dexp),
        draws.grid_params)
    assert got["image"].dtype == torch.float32
    assert torch.equal(got["image"], want)
    assert int((draws.grid_params[:, 0] > 1).sum()) == 4
