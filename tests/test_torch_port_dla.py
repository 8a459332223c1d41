"""The port's DLA (``models/backbones/dla.py``) and YOLOX on it
(``configs/coco/dla34_yolox.yaml``) against the JAX package, in float32 on
the CPU.

* the copied tables: ``DLA_SPECS`` and the bilinear taps of
  ``fill_up_weights`` equal the JAX package's;
* the DLA-34 trunk in train mode (batch statistics, 128 px): outputs and
  every running statistic after the step;
* ``DLASeg`` (DLAUp and the final IDAUp, their DCNv2 blocks with the
  offset convolutions drawn non-zero and the ``up_*`` kernels drawn
  random, so that the carrier's spatial flip shows) in eval mode;
* the weight carrier both ways: flax -> port (``jax_to_torch_state_dict``
  through ``map_dla_torch_name``) -> flax through the JAX
  ``port_dla_state_dict`` (the reference's DCN layout and the flipped
  transposed-convolution kernels), exact; the port's copy of the JAX map
  equals it on every key, DLA-60's bottleneck blocks too;
* YOLOX on DLA-34 (the yaml, 64 px): the head outputs against the JAX
  model's, ``Predictor`` serving on the CPU (its tail equals the port's
  ``yolox_postprocess`` with the plain NMS), the registry builders' leaves
  and counts against ``jax.eval_shape`` of the JAX models, and one
  ``build_system`` step against the JAX ``build_system``'s at width 0.25.

Tolerances: outputs 1e-4 of each tensor's largest magnitude (the DCN
sampling goes through ``F.grid_sample``'s normalized coordinates; XLA-CPU
and oneDNN sum convolutions in another order), 3e-4 for the trunk's
train-mode outputs and statistics (float32's own spread there, measured
against float64 in the test's docstring); loss
terms 1e-4 relative, the foreground count exact, the gradient norm 1e-3
relative; tables and the carrier exact.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    REPO,
    assert_leaves_match_jax,
    flax_variables_like,
    jit_o0,
    load_into,
    numpy_variables,
)
from yolov7_d2_tpu import engine as jax_engine
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.backbones import dla as jdla
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
from yolov7_d2_tpu_torch.models.backbones import dla as tdla
from yolov7_d2_tpu_torch.models.backbones.zoo import build_zoo_backbone
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import yolox as tyolox
from yolov7_d2_tpu_torch.predictor import Predictor
from yolov7_d2_tpu_torch.utils import weight_port as twp

TOL = 1e-4
TRAIN_TOL = 3e-4
SIZE = 64
YAML = REPO / "configs" / "coco" / "dla34_yolox.yaml"


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _dcn_drawn(variables, rng):
    """The DCN blocks' offset convolutions drawn N(0, 2.5 / fan_in) with
    biases N(0, 1): offsets of a few pixels, modulation away from 0.5."""
    def draw(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        if "offset_conv" not in keys:
            return leaf
        if keys[-1] == "kernel":
            fan = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, 2.5 * fan ** -0.5, leaf.shape).astype(
                np.float32)
        return rng.normal(0.0, 1.0, leaf.shape).astype(np.float32)

    return dict(variables, params=jax.tree_util.tree_map_with_path(
        draw, variables["params"]))


def test_copied_tables_equal_jax():
    assert tdla.DLA_SPECS == jdla.DLA_SPECS
    for k in (2, 4, 8, 16):
        np.testing.assert_array_equal(tdla.bilinear_kernel(k),
                                      jdla._bilinear_kernel(k))


def test_dla_trunk_train_mode_matches_jax():
    """DLA-34 in train mode, 128 px: every level's output and, after the
    step, every BatchNorm's running statistics (torch's update rule in both
    packages), within ``TRAIN_TOL``: 35 train-mode BatchNorms in float32
    put level5 1.03e-4 (the port) and 7.3e-5 (JAX) of its largest
    magnitude from a float64 run of the port (measured on this input), so
    the two packages part by up to twice that."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 2 * SIZE, 2 * SIZE, 3)).astype(np.float32)
    levels = tuple(f"level{i}" for i in range(6))
    jm = jdla.DLA(34, out_features=levels)
    variables = flax_variables_like(jm, x, rng)
    tm = load_into(tdla.DLA(34, levels), variables, twp.map_dla_torch_name)
    want, updated = jit_o0(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in levels:
        _close(_nhwc(got[k]), want[k], TRAIN_TOL, what=k)
    stats = twp.jax_to_torch_state_dict(
        numpy_variables({"params": variables["params"],
                         "batch_stats": updated["batch_stats"]}),
        tm.state_dict(), twp.map_dla_torch_name)
    n = 0
    for key, value in tm.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            _close(value.numpy(), stats[key], TRAIN_TOL, what=key)
            n += 1
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                        for m in tm.modules()) > 70


@functools.lru_cache(maxsize=None)
def _seg_pair():
    """(flax DLASeg, variables, port DLASeg, input) with dla0..dla2 out."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    feats = ("dla0", "dla1", "dla2")
    jm = jdla.DLASeg(34, out_features=feats)
    variables = _dcn_drawn(flax_variables_like(jm, x, rng), rng)
    tm = load_into(tdla.DLASeg(34, feats), variables, twp.map_dla_torch_name)
    return jm, variables, tm, x


def test_dlaseg_matches_jax():
    """DLASeg (DLAUp + IDAUp, 16 DCNv2 blocks, random upsampling kernels)
    in eval mode: the three stride-4 outputs."""
    jm, variables, tm, x = _seg_pair()
    want = jit_o0(jm.apply)(variables, jnp.asarray(x))
    assert sum(isinstance(m, tdla.DeformConvBlock)
               for m in tm.modules()) == 16
    up = tm.ida_up.up_1.weight.detach().numpy()
    assert not np.array_equal(up, up[:, :, ::-1, ::-1])
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in want:
        _close(_nhwc(got[k]), want[k], what=k)


def test_weight_carrier_both_ways_and_the_name_map():
    """flax -> port -> flax through the JAX ``port_dla_state_dict``: every
    leaf back, exactly; the port's map is the JAX map on every key (the
    bottleneck blocks of DLA-60 too)."""
    _, variables, tm, _ = _seg_pair()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    zero = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        numpy_variables(variables))
    back, report = jwp.port_dla_state_dict(sd, zero)
    assert not report["unused"], report["unused"][:5]
    want = jax.tree_util.tree_leaves_with_path(numpy_variables(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))
    for model, block in ((tm, "basic"), (tdla.DLA(60), "bottleneck")):
        modules = {k.rpartition(".")[0] for k in model.state_dict()}
        assert len(modules) > 60
        for m in modules:
            assert twp.map_dla_torch_name(m, block) == \
                jwp.map_dla_torch_name(m, block), m


def _cfgs(**opts):
    out = []
    for fn in (get_cfg, jax_get_cfg):
        cfg = fn()
        cfg.merge_from_file(str(YAML))
        for k, v in dict({"SOLVER.AMP.ENABLED": False,
                          "INPUT.INPUT_SIZE": [SIZE, SIZE]}, **opts).items():
            cfg.merge_from_list([k, repr(v)])
        out.append(cfg)
    return out


def _mapper():
    return functools.partial(twp.map_yolox_kpts_torch_name,
                             backbone_type="dla")


def test_yolox_dla_serves_like_jax_through_the_predictor():
    """YOLOX on the DLA-34 trunk from the yaml (the neck on 128/256/512
    channels, width and depth 1.0), 64 px: the head outputs of the uint8
    path against the JAX model's; ``Predictor`` on the CPU gives the
    port's tail of them."""
    cfg, jcfg = _cfgs()
    tcfg = YoloxConfig.from_cfg(cfg)
    assert tcfg.backbone == "build_dla_fpn3_backbone"
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    jm = jax_build_model(jcfg)
    variables = flax_variables_like(jm, images.astype(np.float32), rng)
    tm = load_into(build_model(tcfg, "cpu"), variables, _mapper())
    assert tm.neck.lateral_conv0.conv.in_channels == 512
    want = jit_o0(jm.apply)(variables, jnp.asarray(images, jnp.float32))
    predictor = Predictor(tcfg, device="cpu", model=tm)
    got = predictor.forward(torch.from_numpy(images))
    _close(got["outputs"], want["outputs"], what="outputs")
    dets = predictor.predict_batch(torch.from_numpy(images))
    plain = tyolox.yolox_postprocess(
        got, tcfg.conf_threshold, tcfg.nms_threshold, tcfg.max_detections,
        tcfg.pre_nms_topk, nms=nms_batched_plain)
    for field in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(dets, field), getattr(plain, field))
    assert int(dets.valid.sum()) > 0


@pytest.mark.parametrize("name,features", [
    ("build_dla_fpn3_backbone", ("level3", "level4", "level5")),
    ("build_dla_backbone", ("dla2",)),
    ("build_dlaup_backbone", ("dla2", "dla3", "dla4", "dla5"))])
def test_registry_builders_hold_the_jax_leaves(name, features, monkeypatch):
    """The three registry builders from the default ``MODEL.DLA``: their
    features and widths, and every key on a leaf of the JAX modules'
    variables, none left over: the yaml's whole YOLOX on the trunk against
    ``jax.eval_shape`` of the JAX model's init (the same counts), DLASeg
    against the variables of the DLASeg above (its features do not change
    its parameters), the DLAUp pyramid against them without ``ida_up``
    (the JAX ``DLASeg`` builds no final IDAUp with ``ms_output``)."""
    cfg, jcfg = _cfgs(**{"MODEL.BACKBONE.NAME": name})
    tcfg = YoloxConfig.from_cfg(cfg)
    backbone = build_zoo_backbone(tcfg)
    assert tuple(backbone.out_channels) == features
    if name == "build_dla_fpn3_backbone":
        assert backbone.out_channels == {"level3": 128, "level4": 256,
                                         "level5": 512}
        monkeypatch.setattr(tyolox, "init_weights_", lambda *a: None)
        count = assert_leaves_match_jax(
            build_model(tcfg, "cpu"), jax_build_model(jcfg), _mapper(),
            size=SIZE)
        assert count["params"] > 4e7 and count["batch_stats"] > 0
        return
    _, variables, _, x = _seg_pair()
    variables = numpy_variables(variables)
    if name == "build_dlaup_backbone":
        variables = {coll: {k: v for k, v in tree.items() if k != "ida_up"}
                     for coll, tree in variables.items()}
        assert backbone.out_channels == {"dla2": 64, "dla3": 128,
                                         "dla4": 256, "dla5": 512}
    leaves = twp.jax_to_torch_state_dict(variables, backbone.state_dict(),
                                         twp.map_dla_torch_name)
    assert sorted(leaves) == sorted(backbone.state_dict())
    with torch.no_grad():
        out = backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert {k: v.shape[1] for k, v in out.items()} == backbone.out_channels


def test_yolox_dla_build_system_step_matches_jax(monkeypatch):
    """One step of the JAX ``build_system`` (``build_yolox_system``) on the
    yaml at width 0.25 and depth 0.33, 64 px, float32, against the port's
    ``build_system``, the same numpy-drawn weights: SimOTA's foreground
    count, every loss term and the gradient norm."""
    opts = {"MODEL.YOLO.WIDTH_MUL": 0.25, "MODEL.YOLO.DEPTH_MUL": 0.33,
            "MODEL.YOLO.CLASSES": 4, "MODEL.YOLO.MAX_BOXES_NUM": 6,
            "SOLVER.WARMUP_ITERS": 0}
    cfg, jcfg = _cfgs(**opts)
    rng = np.random.default_rng(3)
    jm = jax_build_model(jcfg)
    init = flax_variables_like(jm, np.zeros((2, SIZE, SIZE, 3)), rng)
    monkeypatch.setattr(jax_engine, "build_model", lambda c: types.
                        SimpleNamespace(init=lambda *a, **k: init,
                                        apply=jm.apply))
    _, jstate, jstep, jfields = jax_engine.build_system(
        jcfg, jax.random.PRNGKey(0), 2)
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    assert fields == jfields
    load_into(model, init, _mapper()).train()
    boxes = np.zeros((2, 6, 4), np.float32)
    valid = np.zeros((2, 6), bool)
    for i, n in enumerate((4, 2)):
        wh = rng.uniform(12, 40, (n, 2))
        c = rng.uniform(wh / 2, SIZE - wh / 2)
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :n] = True
    batch = dict(zip(fields, (
        rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32), boxes,
        (rng.integers(0, 4, (2, 6)) * valid).astype(np.int32), valid)))
    jstate, jm_ = jit_o0(jstep)(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    state, tm_ = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert float(tm_["num_fg"]) == float(jm_["num_fg"]) > 2
    for k in ("loss_iou", "loss_obj", "loss_cls", "total_loss"):
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(tm_["grad_norm"]),
                               float(jm_["grad_norm"]), rtol=1e-3)
