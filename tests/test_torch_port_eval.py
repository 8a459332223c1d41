"""The port's COCO evaluation and weight loading against the JAX package,
in float32 on the CPU.

* ``COCOEvaluator`` (a copy): the same dict on seeded predictions, exactly
  (NaN where both are NaN).
* ``train_det.build_eval_fn``: the JAX one feeds the mapper's float32
  images to the flax model; the port's feeds them as uint8 to
  ``Predictor.predict_batch`` (the normalize kernel's plain version here),
  on a copy of the model with the EMA weights. Same weights on both sides
  (the flax init moved into the port, BatchNorm calibrated on the eval
  images so that activations are of order 1, and moved back with the JAX
  package's ``port_torch_state_dict``), EMA weights unlike the trained
  ones. Required: equal detection counts and classes, boxes within 1e-4 of
  their magnitude and scores within 1e-4 (XLA-CPU and oneDNN sum each
  convolution in another order, and the calibrated BatchNorm layers carry
  that rounding to about 3e-5 of the head outputs, within the 1e-4 of
  ``test_torch_port_yolox.py``), and every AP within 1e-3.
* A reference-format ``{"model": state_dict}`` ``.pth`` of a random port
  model, read by the JAX ``demo.DefaultPredictor`` and the port's
  ``demo.build_predictor``: the same detections on one BGR image, boxes
  within 1e-4 of their magnitude, scores within 1e-4.
"""

import importlib.util
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import REPO, tiny_cfg, write_mini_coco
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.evaluation import coco_eval as jax_coco_eval
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.train.train_state import TrainState as JaxTrainState
from yolov7_d2_tpu.utils.weight_port import port_torch_state_dict
from yolov7_d2_tpu_torch import demo, train_det
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data import coco
from yolov7_d2_tpu_torch.data.mappers import SimpleDatasetMapper
from yolov7_d2_tpu_torch.engine import build_yolox_system
from yolov7_d2_tpu_torch.evaluation import coco_eval
from yolov7_d2_tpu_torch.utils.weight_port import load_torch_checkpoint

BOX_TOL = 1e-4
SCORE_TOL = 1e-4
AP_TOL = 1e-3
VAR_FLOOR = 0.3


def _root_script(name: str):
    """The JAX package's entry script ``<repo>/<name>.py``, loaded from its
    path (under a name of its own, whatever else ``sys.path`` holds)."""
    spec = importlib.util.spec_from_file_location(f"jax_root_{name}",
                                                  REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_demo = _root_script("demo")
jax_train_det = _root_script("train_det")


def _seeded_eval(mod):
    rng = np.random.default_rng(3)
    ev = mod.COCOEvaluator(3)
    for img in range(6):
        g = int(rng.integers(1, 6))
        xy = rng.uniform(0, 200, (g, 2))
        gt = np.concatenate([xy, xy + rng.uniform(4, 150, (g, 2))], 1)
        gcls = rng.integers(0, 3, g)
        crowd = rng.random(g) < 0.15
        ev.add_gt(img, gt, gcls, iscrowd=crowd)
        d = int(rng.integers(0, 12))
        pick = rng.integers(0, g, d)
        det = gt[pick] + rng.normal(0, 6, (d, 4))
        ev.add_predictions(img, det, rng.random(d),
                           np.where(rng.random(d) < 0.8, gcls[pick],
                                    rng.integers(0, 3, d)))
    ev.add_predictions(7, np.array([[1.0, 1, 5, 5]]), np.array([0.9]),
                       np.array([2]))
    return ev.evaluate()


def test_coco_evaluator_matches_jax():
    got, want = _seeded_eval(coco_eval), _seeded_eval(jax_coco_eval)
    assert list(got) == list(want)
    np.testing.assert_array_equal(np.array(list(got.values())),
                                  np.array(list(want.values())))
    assert np.isfinite(got["AP"]) and 0 < got["AP"] < 1


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """The mini-COCO, both configs, and one set of weights on both sides:
    (records, port cfg, port state, JAX cfg, flax model, JAX state)."""
    js, root = write_mini_coco(tmp_path_factory.mktemp("evalcoco"), n=7)
    records = coco.load_coco_json(js, root)
    # 3 a batch: the last eval batch is partial
    cfg = tiny_cfg(get_cfg, SOLVER__IMS_PER_BATCH=3)
    jcfg = tiny_cfg(jax_get_cfg, SOLVER__IMS_PER_BATCH=3)
    jmodel = jax_build_model(jcfg)
    # the flax variables' tree by tracing alone (a compiled flax init takes
    # some 15 s on a CPU); the port's seeded weights fill every leaf
    template = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                             train=False),
                       jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)))
    _, state, _ = build_yolox_system(YoloxConfig.from_cfg(cfg), "cpu", 0)
    model = state.model.eval()
    images = np.stack([SimpleDatasetMapper(cfg, is_train=False)(r)["image"]
                       for r in records])

    def calibrate(bn, inputs):
        bn.running_mean.copy_(inputs[0].mean((0, 2, 3)))
        bn.running_var.copy_(
            inputs[0].var((0, 2, 3), unbiased=False).clamp(min=VAR_FLOOR))

    hooks = [m.register_forward_pre_hook(calibrate)
             for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        model(torch.from_numpy(images))
    for h in hooks:
        h.remove()
    rng = np.random.default_rng(1)

    def noise(p):
        return torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32))

    with torch.no_grad():
        state.ema_params = {n: p * (1 + 0.05 * noise(p)) + 0.01 * noise(p)
                            for n, p in model.named_parameters()}

    def to_flax(sd):
        out, report = port_torch_state_dict(
            {k: v.numpy() for k, v in sd.items()}, template, strict=True)
        assert not report["unused"]
        return out

    trained = to_flax(model.state_dict())
    ema = to_flax({**model.state_dict(), **state.ema_params})
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=trained["params"],
                           batch_stats=trained["batch_stats"],
                           opt_state=None, ema_params=ema["params"])
    return records, cfg, state, jcfg, jmodel, jstate, template


def _recorded_eval(monkeypatch, mod, eval_fn, trainer):
    seen = {}
    add = mod.COCOEvaluator.add_predictions

    def record(self, image_id, boxes, scores, classes, *a, **kw):
        seen[image_id] = (np.asarray(boxes), np.asarray(scores),
                          np.asarray(classes))
        return add(self, image_id, boxes, scores, classes, *a, **kw)

    monkeypatch.setattr(mod.COCOEvaluator, "add_predictions", record)
    return eval_fn(trainer), seen


def test_eval_fn_matches_jax(eval_pair, monkeypatch):
    records, cfg, state, jcfg, jmodel, jstate, _ = eval_pair
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got, got_dets = _recorded_eval(
        monkeypatch, coco_eval, train_det.build_eval_fn(cfg, records),
        types.SimpleNamespace(state=state))
    want, want_dets = _recorded_eval(
        monkeypatch, jax_coco_eval,
        jax_train_det.build_eval_fn(jcfg, records, jmodel),
        types.SimpleNamespace(state=jstate))
    # the training model is left as it was (weights, BN buffers, mode)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert sorted(got_dets) == sorted(want_dets) == [r["image_id"]
                                                     for r in records]
    total = 0
    for img in want_dets:
        (gb, gs, gc), (wb, ws, wc) = got_dets[img], want_dets[img]
        np.testing.assert_array_equal(gc, wc)
        assert gb.shape == wb.shape
        total += len(wc)
        tol = BOX_TOL * max(1.0, float(np.abs(wb).max(initial=0.0)))
        np.testing.assert_allclose(gb, wb, rtol=0, atol=tol)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_TOL)
    assert total > 0
    assert sorted(got) == sorted(want) and "AP" in got
    for k in want:
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])


def test_eval_uses_the_ema_weights(eval_pair, monkeypatch):
    records, cfg, state, *_ = eval_pair
    copy = train_det.eval_model(state)
    assert not copy.training and state.model is not copy
    for name, p in copy.named_parameters():
        assert torch.equal(p, state.ema_params[name])
        assert not torch.equal(p, dict(state.model.named_parameters())[name])
    for (name, b), (_, want) in zip(copy.named_buffers(),
                                    state.model.named_buffers()):
        assert torch.equal(b, want), name


def test_exact_uint8_raises_where_the_cast_would_change_a_value():
    ok = np.array([[0.0, 114.0, 255.0]], np.float32)
    np.testing.assert_array_equal(train_det.exact_uint8(ok),
                                  ok.astype(np.uint8))
    for bad in (0.5, 256.0, -1.0, np.nan):
        with pytest.raises(ValueError):
            train_det.exact_uint8(np.array([1.0, bad], np.float32))


def test_load_torch_checkpoint_unwraps_model_and_state_dict(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3)}
    for i, obj in enumerate((sd, {"model": sd}, {"state_dict": sd},
                             {"model": {"state_dict": sd}})):
        torch.save(obj, tmp_path / f"w{i}.pth")
        got = load_torch_checkpoint(str(tmp_path / f"w{i}.pth"))
        assert list(got) == ["a.weight"]
        assert torch.equal(got["a.weight"], sd["a.weight"])


class _FlaxTemplate:
    """A flax module whose ``init`` returns a given variable tree."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, *args, **kw):
        return self.variables

    def apply(self, *args, **kw):
        return self.module.apply(*args, **kw)


def test_demo_predictors_agree_on_reference_weights(eval_pair, tmp_path,
                                                    monkeypatch):
    _, cfg, state, jcfg, jmodel, _, template = eval_pair
    # the JAX predictor's random init (eager, some 25 s on a CPU) gives
    # only the tree that the .pth then fills leaf by leaf: hand it the tree
    monkeypatch.setattr("yolov7_d2_tpu.models.build.build_model",
                        lambda cfg: _FlaxTemplate(jmodel, template))
    path = tmp_path / "weights.pth"
    torch.save({"model": state.model.state_dict()}, path)
    for c in (cfg, jcfg):
        c.MODEL.YOLO.CONF_THRESHOLD = 0.25
    bgr = np.random.default_rng(9).integers(0, 256, (48, 80, 3),
                                            dtype=np.uint8)
    bgr[10:40, 20:60] = 220
    got = demo.build_predictor(cfg, str(path))(bgr)
    want = jax_demo.DefaultPredictor(jcfg, str(path))(bgr)
    assert len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["classes"], want["classes"])
    tol = BOX_TOL * max(1.0, float(np.abs(want["boxes"]).max()))
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=SCORE_TOL)
