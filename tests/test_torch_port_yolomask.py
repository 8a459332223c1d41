"""The port's YOLOMask (``models/meta_arch/yolomask.py``) against the JAX
package, in float32 on the CPU.

* ``OrienHead`` on a random pyramid: the offset field of every level and
  anchor;
* ``yolomask_losses`` on random head outputs and fields against random gts
  with masks (overlapping boxes on one cell, gts matched to each scale):
  every term, the first scale's targets (box maps, the ignore mask, the
  orientation counts and targets), and the gradients with respect to the
  outputs and the field; ``orien_loss``; ``yolomask_recover_masks``;
* the whole model with the detector's Darknet cut to one block a stage
  and its neck to depth 0.33 in both packages (64 px, 4 classes), in
  train mode: the flattened outputs and the field, and one
  ``build_system`` step against the JAX step's loss and gradient (one JAX
  compile for both);
* the weight carrier's map on every key and both ways (flax -> port ->
  flax through the JAX ``port_torch_state_dict``, exact);
* the four yamls: what ``AnchorYoloConfig`` reads for YOLOMask, and every
  parameter and BN statistic of the full model on a leaf of the JAX
  init's (``jax.eval_shape``), the same counts.

Tolerances: outputs and targets' float maps 1e-4 of each tensor's
largest magnitude (XLA-CPU and oneDNN sum convolutions in another order),
the train-mode model outputs 3e-4 (float32's spread there, measured
against float64 in the test's docstring),
the targets' masks and counts exact; loss terms 1e-4 relative; gradients
1e-4 of each tensor's norm; the gradient norm of a step 1e-3 relative; the
carrier exact.
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
from yolov7_d2_tpu.models.backbones.darknet import Darknet53 as JaxDarknet
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import yolomask as jym
from yolov7_d2_tpu.models.meta_arch import yolov7 as jy7
from yolov7_d2_tpu.structures.instances import Detections as JaxDetections
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config import AnchorYoloConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones.darknet import Darknet53
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import yolomask as tym
from yolov7_d2_tpu_torch.models.meta_arch import yolov7 as ty7
from yolov7_d2_tpu_torch.structures.instances import Detections
from yolov7_d2_tpu_torch.utils import weight_port as twp

TOL = 1e-4
TRAIN_TOL = 3e-4
SIZE = 64
CLASSES = 4
ANCHORS = np.asarray(AnchorYoloConfig.anchors, np.float32)
LEVEL_HW = ((8, 8), (4, 4), (2, 2))
YAMLS = ("coco-instance/yolomask.yaml", "coco-instance/yolomask_8gpu.yaml",
         "canaries/yolomask_2gpu.yaml", "canaries/yolomask_m_8gpu.yaml")
CUT = (1, 1, 1, 1, 1)


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture
def cut_darknet(monkeypatch):
    """The detector's Darknet53 at one block a stage and its YOLOPAFPN at
    depth 0.33 (one bottleneck a CSP layer; the widths stay 1.0, which the
    orientation head reads), in both packages."""
    monkeypatch.setattr(jy7, "Darknet53",
                        functools.partial(JaxDarknet, stage_blocks=CUT))
    monkeypatch.setattr(ty7, "Darknet53",
                        functools.partial(Darknet53, stage_blocks=CUT))
    monkeypatch.setattr(jym, "AnchorYOLO",
                        functools.partial(jy7.AnchorYOLO, depth_mul=0.33))
    monkeypatch.setattr(tym, "AnchorYOLO",
                        functools.partial(ty7.AnchorYOLO, depth_mul=0.33))


def _gts(rng, b=2, g=6, counts=(5, 3)):
    """Boxes of every scale with filled elliptic masks; in image 0 two
    boxes of one shape on one cell (the last gt wins its slot)."""
    boxes = np.zeros((b, g, 4), np.float32)
    masks = np.zeros((b, g, SIZE, SIZE), np.uint8)
    valid = np.zeros((b, g), bool)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    for i, n in enumerate(counts):
        for j in range(n):
            wh = rng.uniform(6, 50, 2)
            c = rng.uniform(wh / 2, SIZE - wh / 2)
            if i == 0 and j == 1:
                c, wh = boxes[0, 0, :2] + wh0 / 2 + 0.5, wh0
            boxes[i, j] = np.concatenate([c - wh / 2, c + wh / 2])
            masks[i, j] = (((xx - c[0]) / (wh[0] / 2)) ** 2
                           + ((yy - c[1]) / (wh[1] / 2)) ** 2) <= 1.0
            if i == 0 and j == 0:
                wh0 = wh
        valid[i, :n] = True
    cls = (rng.integers(0, CLASSES, (b, g)) * valid).astype(np.int32)
    return {"gt_boxes": boxes, "gt_classes": cls, "gt_valid": valid,
            "gt_masks": masks}


def _flat(rng, b=2):
    a = sum(h * w * 3 for h, w in LEVEL_HW)
    return {"outputs": rng.normal(0, 1.5, (b, a, 5 + CLASSES)).astype(
                np.float32),
            "orien": rng.normal(0, 1, (b, SIZE // 4, SIZE // 4, 3, 3, 2))
            .astype(np.float32)}


def test_orien_head_matches_jax():
    rng = np.random.default_rng(0)
    feats = [rng.normal(0, 1, (2, SIZE // s, SIZE // s, c)).astype(
        np.float32) for s, c in ((8, 32), (16, 48), (32, 64))]
    jm = jym.OrienHead(up_channels=16)
    variables = flax_variables_like(jm, feats, rng)
    tm = load_into(tym.OrienHead((32, 48, 64), 16), variables,
                   lambda n: tuple(n.split(".")))
    want = jit_o0(jm.apply)(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    _close(got.numpy(), want)
    assert got.shape == (2, SIZE // 4, SIZE // 4, 3, 3, 2)


def test_losses_targets_and_gradients_match_jax():
    """Every loss term (ignore threshold 0.5), the first scale's targets,
    and the gradients of the total with respect to the raw outputs and the
    field."""
    rng = np.random.default_rng(1)
    flat = _flat(rng)
    batch = _gts(rng)
    anchors_flat = jnp.asarray(ANCHORS.reshape(-1, 2))

    @jit_o0
    def jfn(outputs, orien, batch):
        def total(outputs, orien):
            losses = jym.yolomask_losses(
                {"outputs": outputs, "orien": orien, "level_hw": LEVEL_HW},
                batch, CLASSES, ANCHORS, (SIZE, SIZE))
            return losses["total_loss"], losses

        (_, losses), grads = jax.value_and_grad(
            total, argnums=(0, 1), has_aux=True)(outputs, orien)
        gc = (batch["gt_boxes"][..., 0:2] + batch["gt_boxes"][..., 2:4]) / 2
        gwh = batch["gt_boxes"][..., 2:4] - batch["gt_boxes"][..., 0:2]
        raw = outputs[:, :192].reshape(2, 8, 8, 3, -1).transpose(0, 3, 1, 2,
                                                                 4)
        targets = jax.vmap(lambda r, gb, gcl, gv, gm: jym.
                           _yolomask_level_targets(
                               r, gb, gcl, gv, gm, anchors_flat,
                               jnp.arange(3), (SIZE, SIZE), 0.6, 0.6, 0.5,
                               0.0, CLASSES))(
            raw, jnp.concatenate([gc, gwh], -1), batch["gt_classes"],
            batch["gt_valid"], batch["gt_masks"])
        return losses, grads, targets

    jlosses, jgrads, jt = jfn(jnp.asarray(flat["outputs"]),
                              jnp.asarray(flat["orien"]),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    outputs = torch.from_numpy(flat["outputs"]).requires_grad_()
    orien = torch.from_numpy(flat["orien"]).requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = tym.yolomask_losses(
        {"outputs": outputs, "orien": orien, "level_hw": LEVEL_HW}, tb,
        CLASSES, ANCHORS, (SIZE, SIZE))
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=TOL, atol=1e-7,
                                   err_msg=k)
    assert float(losses["loss_orien_pos"].detach()) > 0
    assert float(losses["loss_orien_neg"].detach()) > 0
    losses["total_loss"].backward()
    for what, t, g in (("outputs", outputs, jgrads[0]),
                       ("orien", orien, jgrads[1])):
        err = float(np.abs(t.grad.numpy() - np.asarray(g)).max())
        assert err <= TOL * float(np.linalg.norm(np.asarray(g))), (what, err)

    gt_boxes = tb["gt_boxes"]
    gt = torch.cat([(gt_boxes[..., 0:2] + gt_boxes[..., 2:4]) / 2,
                    gt_boxes[..., 2:4] - gt_boxes[..., 0:2]], -1)
    raw = outputs.detach()[:, :192].reshape(2, 8, 8, 3, -1).permute(
        0, 3, 1, 2, 4)
    t = tym.yolomask_level_targets(
        raw, gt, tb["gt_classes"], tb["gt_valid"], tb["gt_masks"],
        torch.from_numpy(ANCHORS.reshape(-1, 2)), range(3), (SIZE, SIZE),
        0.6, 0.6, 0.5, 0.0, CLASSES)
    for k in ("pos", "neg", "orien_pos", "orien_neg"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    for k in ("txy", "twh", "tscale", "tcls", "torien"):
        _close(t[k].numpy(), jt[k], what=k)
    assert int(t["pos"].sum()) >= 2 and int(t["orien_pos"].sum()) > 50


def test_orien_loss_and_mask_recovery_match_jax():
    rng = np.random.default_rng(2)
    batch = _gts(rng)
    field = rng.normal(0, 2, (2, SIZE // 4, SIZE // 4, 2)).astype(np.float32)
    want = jym.orien_loss(jnp.asarray(field), jnp.asarray(batch["gt_masks"]),
                          jnp.asarray(batch["gt_boxes"]),
                          jnp.asarray(batch["gt_valid"]))
    got = tym.orien_loss(torch.from_numpy(field),
                         torch.from_numpy(batch["gt_masks"]),
                         torch.from_numpy(batch["gt_boxes"]),
                         torch.from_numpy(batch["gt_valid"]))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    boxes = batch["gt_boxes"]
    valid = batch["gt_valid"]
    want = jym.yolomask_recover_masks(JaxDetections(
        boxes=jnp.asarray(boxes), scores=jnp.ones(valid.shape),
        classes=jnp.zeros(valid.shape, jnp.int32),
        valid=jnp.asarray(valid)), jnp.asarray(field))
    got = tym.yolomask_recover_masks(Detections(
        boxes=torch.from_numpy(boxes), scores=torch.ones(valid.shape),
        classes=torch.zeros(valid.shape, dtype=torch.int32),
        valid=torch.from_numpy(valid)), torch.from_numpy(field))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.mean()) < 1


@functools.lru_cache(maxsize=None)
def _reference():
    """(flax YOLOMask of the cut detector, variables, images, a batch, and
    the JAX train-mode outputs, losses and parameter gradients of one
    compile: ``yolomask_losses`` as the JAX ``build_system`` wires it, the
    default anchors, ignore threshold 0.5); the cut's patches must be in
    place."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = jym.YOLOMask(num_classes=CLASSES, up_channels=16)
    variables = flax_variables_like(jm, images, rng)
    batch = _gts(np.random.default_rng(4))

    @jit_o0
    def jfn(params, x, batch):
        def total(params):
            out, _ = jm.apply({"params": params,
                               "batch_stats": variables["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
            losses = jym.yolomask_losses(out, batch, CLASSES, ANCHORS,
                                         (SIZE, SIZE),
                                         obj_ignore_threshold=0.5)
            return losses["total_loss"], (out, losses)

        (_, aux), grads = jax.value_and_grad(total, has_aux=True)(params)
        return aux, grads

    (out, losses), grads = jfn(variables["params"], jnp.asarray(images),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    return jm, variables, images, batch, out, losses, grads


def _pair():
    """(flax model, variables, a fresh port model holding them, images)."""
    jm, variables, images = _reference()[:3]
    tm = load_into(tym.YOLOMask(CLASSES, 16), variables,
                   twp.map_yolomask_torch_name)
    return jm, variables, tm, images


def _jax_map(name):
    """The port's key -> the flax path by the JAX package's own maps."""
    prefix, _, rest = name.partition(".")
    if prefix == "orien":
        return tuple(name.split("."))
    part, _, inner = rest.partition(".")
    if part == "backbone":
        return ("detector", "backbone") + jwp.map_cspdarknet_torch_name(
            inner)
    if part == "head":
        return ("detector",) + twp.map_anchor_yolo_torch_name(rest)
    return ("detector",) + jwp.map_yolox_torch_name(rest)


def test_model_and_carrier_match_jax(cut_darknet):
    """The model (uint8 path) in train mode (the detector's BatchNorms on
    batch statistics), against the JAX train-mode outputs of
    :func:`_reference`'s compile, within ``TRAIN_TOL``: at 64 px the
    stride-32 BatchNorms see 8 values a channel, and the outputs and the
    field sit 1.0e-4 / 1.2e-4 (JAX, whose variance is E[x^2] - E[x]^2 in
    float32, ROADMAP.md C.7) and 4.5e-5 / 6.9e-5 (the port) of their
    largest magnitude from a float64 run of the port (measured on this
    input). Then ``level_hw``; the carrier's map against the JAX maps on
    every key, and flax -> port -> flax, exact."""
    jm, variables, tm, images = _pair()
    want = _reference()[4]
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(images.astype(np.uint8)))
    load_into(tm, variables, twp.map_yolomask_torch_name)  # statistics back
    assert got["level_hw"] == LEVEL_HW == tuple(want["level_hw"])
    for k in ("outputs", "orien"):
        _close(got[k].numpy(), want[k], TRAIN_TOL, what=k)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    modules = {k.rpartition(".")[0] for k in sd}
    for m in modules:
        assert twp.map_yolomask_torch_name(m) == _jax_map(m), m
    zero = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        numpy_variables(variables))
    back, report = jwp.port_torch_state_dict(sd, zero, name_mapper=_jax_map)
    assert not report["unused"], report["unused"][:5]
    for path, w in jax.tree_util.tree_leaves_with_path(
            numpy_variables(variables)):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[path], w,
            err_msg=jax.tree_util.keystr(path))


def _yaml_cfg(fn, yaml, **opts):
    cfg = fn()
    cfg.merge_from_file(str(REPO / "configs" / yaml))
    for k, v in opts.items():
        cfg.merge_from_list([k, repr(v)])
    return cfg


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_config_and_leaves_match_jax(yaml, monkeypatch):
    cfg = _yaml_cfg(get_cfg, yaml)
    acfg = AnchorYoloConfig.from_cfg(cfg)
    assert acfg.meta_architecture == "YOLOMask"
    # the yaml's anchors are the model's fixed ones, the port's copy of the
    # JAX AnchorYOLO default
    assert acfg.anchors == AnchorYoloConfig.anchors == jy7.AnchorYOLO.anchors
    assert acfg.orien_up_channels == 64 and acfg.num_classes == 80
    assert acfg.input_size == ((320, 320) if "canaries" in yaml
                               else (640, 640))
    monkeypatch.setattr(tym, "init_weights_", lambda *a: None)
    count = assert_leaves_match_jax(
        build_model(acfg, "cpu"), jax_build_model(_yaml_cfg(jax_get_cfg,
                                                            yaml)),
        twp.map_yolomask_torch_name, size=SIZE)
    assert count["params"] > 6e7 and count["batch_stats"] > 0


def test_build_system_step_matches_jax(cut_darknet, monkeypatch):
    """One step of the port's ``build_system`` on ``yolomask.yaml`` (64 px,
    float32, SGD) against the JAX ``build_system``'s: both build the cut
    model (a fresh port model holding the weights of
    :func:`_reference`) and give the same batch fields; every loss term
    of the step and its gradient norm against the loss and gradient of the
    JAX step's computation (:func:`_reference`)."""
    jm, init, tm, images = _pair()
    *_, batch, _, jlosses, jgrads = _reference()
    opts = {"SOLVER.AMP.ENABLED": False, "INPUT.INPUT_SIZE": [SIZE, SIZE],
            "MODEL.YOLO.CLASSES": CLASSES, "SOLVER.WARMUP_ITERS": 0}
    jcfg = _yaml_cfg(jax_get_cfg, YAMLS[0], **opts)
    cfg = _yaml_cfg(get_cfg, YAMLS[0], **opts)
    monkeypatch.setattr(jax_engine, "build_model", lambda c: jm)
    make_state = jax_engine._make_state
    monkeypatch.setattr(
        jax_engine, "_make_state", lambda model, *a: make_state(
            types.SimpleNamespace(init=lambda *_, **__: init), *a))
    monkeypatch.setattr(engine, "build_model", lambda c, device, seed: tm)
    _, _, _, jfields = jax_engine.build_system(jcfg, jax.random.PRNGKey(0), 2)
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    assert fields == jfields == ("image", "gt_boxes", "gt_classes",
                                 "gt_valid", "gt_masks")
    assert engine.config_from_cfg(cfg).ignore_threshold < 0.5
    batch = dict(batch, image=images)
    _, tm_ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss_box", "loss_obj_pos", "loss_obj_neg", "loss_cls",
              "loss_orien_pos", "loss_orien_neg", "total_loss"):
        np.testing.assert_allclose(float(tm_[k]), float(jlosses[k]),
                                   rtol=TOL, err_msg=k)
    np.testing.assert_allclose(
        float(tm_["grad_norm"]),
        float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                          for g in jax.tree_util.tree_leaves(jgrads)))),
        rtol=1e-3)
