"""The port's copies of the JAX package's host-side library, held exactly
against the originals on the same inputs: the last augments
(``data/transforms/augment.py`` ``vflip``, ``random_shift``,
``jitter_crop``, from generators of the same seed), the native batch
letterbox (``native.letterbox_batch_u8`` against the JAX native library,
or against cv2 where that does not build), ``evaluation/testing.py``, the
visualizer, and the loggers: ``TensorboardWriter``, the torch.profiler
tracing and timing (``utils/profiling.py``) and the wandb writers (no-ops
without wandb; their calls checked on a stand-in module).
"""

import json
import logging
import sys
import types

import numpy as np
import pytest
import torch

import _torch_port_helpers  # noqa: F401  (the worker's share of the cores)
from yolov7_d2_tpu import native as jnative
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.data.transforms import augment as jaug
from yolov7_d2_tpu.evaluation import testing as jtesting
from yolov7_d2_tpu.utils import visualizer as jvis
from yolov7_d2_tpu_torch import native as tnative
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data.transforms import augment as taug
from yolov7_d2_tpu_torch.evaluation import testing as ttesting
from yolov7_d2_tpu_torch.utils import events, profiling, wandb_logger
from yolov7_d2_tpu_torch.utils import visualizer as tvis


def _sample(rng, h=48, w=64, n=5):
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    xy = rng.uniform(0, [w - 12, h - 12], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 12, (n, 2))],
                           1).astype(np.float32)
    return img, boxes, np.arange(n, dtype=np.int32)


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_augments_are_exact(seed):
    img, boxes, classes = _sample(np.random.default_rng(seed))
    _equal(taug.vflip(img, boxes), jaug.vflip(img, boxes))
    _equal(taug.vflip(img, boxes[:0]), jaug.vflip(img, boxes[:0]))
    draws = [np.random.default_rng(100 + seed) for _ in range(2)]
    _equal(taug.random_shift(img, boxes, 9, draws[0]),
           jaug.random_shift(img, boxes, 9, draws[1]))
    for ratio in (0.1, 0.3, 0.6):
        _equal(taug.jitter_crop(img, boxes, classes, ratio, draws[0]),
               jaug.jitter_crop(img, boxes, classes, ratio, draws[1]))
    # the generators drew the same numbers
    assert draws[0].integers(1 << 30) == draws[1].integers(1 << 30)


def _images(rng):
    return [rng.integers(0, 256, (40 + 9 * i, 70 - 6 * i, 3), np.uint8)
            for i in range(6)]


def test_batch_letterbox_matches_the_jax_native_library():
    assert tnative.native_available(), tnative.BUILD_ERROR
    imgs = _images(np.random.default_rng(5))
    got, scales = tnative.letterbox_batch_u8(imgs, (64, 80), num_threads=3)
    assert got.shape == (6, 64, 80, 3) and scales.dtype == np.float32
    for i, im in enumerate(imgs):
        one, s = tnative.letterbox_u8(im, (64, 80))
        np.testing.assert_array_equal(got[i], one)
        assert scales[i] == np.float32(s)
    if jnative.native_available():
        want, want_scales = jnative.letterbox_batch_u8(imgs, (64, 80),
                                                       num_threads=2)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(scales, want_scales)
    else:
        # the cv2 path the mappers take where no library builds: the same
        # scale, the pixels within the rounding of two bilinear resizes
        for i, im in enumerate(imgs):
            ref, _, r = taug.letterbox(im, np.zeros((0, 4)), (64, 80))
            assert scales[i] == pytest.approx(r)
            assert np.abs(got[i].astype(int) - ref.astype(int)).max() <= 3


def test_verify_results_and_flatten_are_the_jax_functions(caplog):
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.TEST.EXPECTED_RESULTS = [["AP", 0.40, 0.02],
                                     ["bbox/AP50", 0.6, 0.1]]
    for results in ({"AP": 0.41, "bbox/AP50": 0.65}, {"AP": 0.30},
                    {"AP": 0.39, "bbox/AP50": 0.2}, {"other": 1.0}):
        with caplog.at_level(logging.INFO):
            caplog.clear()
            got = ttesting.verify_results(tcfg, results)
            port_lines = [r.getMessage() for r in caplog.records]
            caplog.clear()
            want = jtesting.verify_results(jcfg, results)
            jax_lines = [r.getMessage() for r in caplog.records]
        assert got == want and port_lines == jax_lines
    tcfg.TEST.EXPECTED_RESULTS = []
    assert ttesting.verify_results(tcfg, {})
    nested = {"bbox": {"AP": 1.0, "AP50": np.float32(2.0)},
              "segm": {"AP": 3}}
    assert ttesting.flatten_results(nested) == jtesting.flatten_results(
        nested)


def _draw_inputs(rng):
    img = rng.integers(0, 256, (64, 80, 3), np.uint8)
    boxes = rng.uniform(0, 60, (4, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    scores = rng.uniform(0, 1, 4).astype(np.float32)
    classes = np.array([0, 3, 300, 7])
    masks = rng.uniform(0, 1, (3, 32, 40)).astype(np.float32)
    kpts = np.concatenate([rng.uniform(0, 64, (2, 17, 2)),
                           rng.uniform(0, 1, (2, 17, 1))], -1)
    return img, boxes, scores, classes, masks, kpts.astype(np.float32)


@pytest.mark.parametrize("what", ["detections", "named", "masks",
                                  "keypoints", "annos"])
def test_the_visualizer_draws_the_jax_pixels(what):
    img, boxes, scores, classes, masks, kpts = _draw_inputs(
        np.random.default_rng(len(what)))
    names = [f"c{i}" for i in range(301)]
    calls = {
        "detections": lambda v: v.draw_detections(img, boxes, scores,
                                                  classes),
        "named": lambda v: v.draw_detections(img, boxes, None, classes,
                                             names, thickness=1),
        "masks": lambda v: v.draw_masks(img, masks, alpha=0.3),
        "keypoints": lambda v: v.draw_keypoints(img, kpts, 0.5),
        "annos": lambda v: v.vis_annos({
            "image": img.astype(np.float32), "gt_boxes": boxes,
            "gt_classes": classes, "gt_valid": np.array([1, 0, 1, 1], bool),
            "gt_masks": _rect_masks(img)}),
    }
    got, want = calls[what](tvis), calls[what](jvis)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


def _rect_masks(img):
    m = np.zeros((4,) + img.shape[:2], np.float32)
    m[:, 10:30, 20:50] = 1.0
    return m


class _Storage:
    def __init__(self, it, scalars):
        self.iter = it
        self._scalars = scalars

    def latest(self):
        return dict(self._scalars)


def test_tensorboard_writer_writes_on_its_period(tmp_path, monkeypatch):
    added = []

    class Fake:
        def __init__(self, log_dir):
            self.log_dir = log_dir

        def add_scalar(self, k, v, it):
            added.append((k, v, it))

        def close(self):
            added.append("closed")

    # a stand-in for torch.utils.tensorboard, whose import costs seconds
    tb = types.ModuleType("torch.utils.tensorboard")
    tb.SummaryWriter = Fake
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tb)
    writer = events.TensorboardWriter(str(tmp_path), period=5)
    writer.write(_Storage(3, {"loss": 1.0}))
    writer.write(_Storage(10, {"loss": 2.0, "lr": 0.1}))
    writer.write(_Storage(11, {"loss": 3.0}), force=True)
    writer.close()
    assert added == [("loss", 2.0, 10), ("lr", 0.1, 10), ("loss", 3.0, 11),
                     "closed"]
    del tb.SummaryWriter  # the import fails, as without tensorboard
    quiet = events.TensorboardWriter(str(tmp_path))
    quiet.write(_Storage(20, {"loss": 1.0}))
    quiet.close()
    assert quiet._writer is None


def test_profiler_trace_hook_and_timed(tmp_path):
    with profiling.trace(str(tmp_path / "a")):
        torch.ones(8).add_(1)
    trace = json.loads((tmp_path / "a" / "trace.json").read_text())
    assert trace["traceEvents"]

    class Trainer:
        storage = _Storage(0, {})

    hook = profiling.ProfilerHook(str(tmp_path / "b"), start_iter=2,
                                  num_iters=2)
    trainer = Trainer()
    for it in range(1, 6):
        trainer.storage.iter = it
        torch.ones(4).mul_(2)
        hook.after_step(trainer)
        assert (hook._prof is not None) == (2 <= it < 4)
    hook.after_train(trainer)
    assert (tmp_path / "b" / "trace.json").exists()

    out, seconds = profiling.timed(lambda x: {"y": [x * 2]},
                                   torch.ones(3))
    assert out["y"][0].tolist() == [2.0] * 3 and seconds >= 0.0


def test_wandb_writers_are_no_ops_without_wandb_and_call_it_with(
        monkeypatch):
    assert wandb_logger._try_import_wandb() is None  # not installed here
    writer = wandb_logger.WandbWriter(period=2)
    writer.write(_Storage(4, {"loss": 1.0}))
    inference = wandb_logger.WandbInferenceLogger(class_names=["a"])
    inference.log_image(np.zeros((4, 4, 3), np.uint8), [[0, 0, 2, 2]],
                        [0.5], [0])

    calls = []

    class FakeWandb:
        @staticmethod
        def init(**kw):
            calls.append(("init", kw))

        @staticmethod
        def log(data, step=None):
            calls.append(("log", data, step))

        class Image:
            def __init__(self, image, boxes):
                self.shape, self.boxes = image.shape, boxes

    monkeypatch.setattr(wandb_logger, "_try_import_wandb",
                        lambda: FakeWandb)
    writer = wandb_logger.WandbWriter(project="p", period=2, config={"a": 1})
    writer.write(_Storage(3, {"loss": 1.0}))
    writer.write(_Storage(4, {"loss": 2.0}))
    inference = wandb_logger.WandbInferenceLogger(project="q")
    inference.log_image(np.zeros((4, 4, 3), np.uint8),
                        [[0.0, 1.0, 2.0, 3.0]], [0.5], [2])
    assert calls[0] == ("init", {"project": "p", "config": {"a": 1}})
    assert calls[1] == ("log", {"loss": 2.0}, 4)
    assert calls[2] == ("init", {"project": "q"})
    image = calls[3][1]["inference"]
    (box,) = image.boxes["predictions"]["box_data"]
    assert box["position"] == {"minX": 0.0, "minY": 1.0, "maxX": 2.0,
                               "maxY": 3.0} and box["class_id"] == 2
