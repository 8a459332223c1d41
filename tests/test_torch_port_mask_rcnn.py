"""The port's Mask R-CNN and Faster R-CNN (``models/meta_arch/mask_rcnn.py``,
``necks/fpn.ResNetFPN``, ``config/rcnn.py``) against the JAX package, in
float32 on the CPU.

* the model at narrow widths (ResNet of one bottleneck a stage in both
  packages, FPN 32 channels, FC 64, 5 classes, 32 candidates a level, 16
  proposals, 128 px) with carried weights: the RPN outputs, the proposals,
  ``cls_logits``, ``box_deltas`` and ``mask_logits``;
* ``mask_rcnn_losses`` in expectation and sampled mode (the sampled mode on
  the uniforms the JAX loss draws: ``split(rng, B)``, then ``split(rng_i,
  4)``), with the parameter gradients, on GTs two of which sit on
  proposals (foreground proposals, a mask term); the same without the mask
  head (Faster R-CNN's losses and gradients);
* ``mask_rcnn_postprocess`` on both packages' outputs;
* one ``build_system`` step against the JAX step's loss and gradient
  (the R-CNN configs and builders: ``tests/test_torch_port_panoptic.py``).

One JAX compile of the model's forward and backward serves the file; the
losses' gradients with respect to the model's outputs (each mode) compile
on their own, without the model.

Tolerances: outputs 1e-4 of each tensor's largest magnitude (XLA-CPU and
oneDNN sum convolutions in another order); loss terms 1e-4 relative;
gradients 2e-4 of each tensor's norm (at least 1e-3 of the whole); the
tail's scores and boxes 1e-4 of their largest, its classes and validity
exact; the carrier exact. The anchors, the box deltas and the subset draw:
``tests/test_torch_port_roi_align.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    flax_variables_like,
    jit_o0,
    load_into,
    rcnn_mini_cfg,
)
from yolov7_d2_tpu.models.backbones import resnet as jresnet
from yolov7_d2_tpu.models.meta_arch import mask_rcnn as jm
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones import resnet as tresnet
from yolov7_d2_tpu_torch.models.meta_arch import mask_rcnn as tm
from yolov7_d2_tpu_torch.utils import weight_port as twp
from yolov7_d2_tpu_torch.utils.weight_port import jax_to_torch_state_dict

TOL = 1e-4
SIZE = 128
B, G = 2, 4
CUT_DEPTH, CUT_BLOCKS = 10, (1, 1, 1, 1)
DIMS = dict(num_classes=5, resnet_depth=CUT_DEPTH, fpn_channels=32,
            num_proposals=16, pre_nms_topk=32, fc_dim=64)
KEYS = ("rpn_obj", "rpn_deltas", "anchors", "proposals", "proposal_scores",
        "cls_logits", "box_deltas", "mask_logits")
# the outputs the losses differentiate
DIFF = ("rpn_obj", "rpn_deltas", "cls_logits", "box_deltas", "mask_logits")
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
          "loss_mask", "total_loss")


@pytest.fixture(autouse=True, scope="module")
def _cut_resnet():
    """One bottleneck a stage in both packages: the JAX compile costs the
    file's time."""
    with pytest.MonkeyPatch.context() as mp:
        for blocks in (jresnet.STAGE_BLOCKS, tresnet.STAGE_BLOCKS):
            mp.setitem(blocks, CUT_DEPTH, CUT_BLOCKS)
            mp.setitem(blocks, 18, CUT_BLOCKS)  # the mini config's depth
        yield


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _gts(rng, proposals):
    """G slots an image: two boxes a pixel off proposals 0 and 3 (their
    IoU with them > 0.5), one random box, one invalid slot; each mask the
    box with a notch."""
    boxes = np.zeros((B, G, 4), np.float32)
    masks = np.zeros((B, G, SIZE, SIZE), np.uint8)
    for i in range(B):
        for j, p in enumerate((0, 3)):
            boxes[i, j] = np.clip(proposals[i, p] + rng.uniform(
                -1, 1, 4), 0, SIZE)
        x0, y0 = rng.uniform(0, SIZE / 2, 2)
        boxes[i, 2] = [x0, y0, x0 + rng.uniform(20, 60),
                       y0 + rng.uniform(20, 60)]
        for j in range(3):
            x0, y0, x1, y1 = np.round(boxes[i, j]).astype(int)
            masks[i, j, y0:y1, x0:x1] = 1
            masks[i, j, y0:(y0 + y1) // 2, x0:(x0 + x1) // 2] = 0
    cls = rng.integers(0, 5, (B, G)).astype(np.int32)
    valid = np.zeros((B, G), bool)
    valid[:, :3] = True
    return boxes, cls, valid, masks


def _uniforms(rng_key, a: int, p: int):
    """The JAX loss's sampled-mode uniforms: ``split(rng, B)``, then four
    keys an image (RPN fg / bg over A anchors, ROI fg / bg over P)."""
    out = [[], [], [], []]
    for key in jax.random.split(rng_key, B):
        for k, (sub, n) in enumerate(zip(jax.random.split(key, 4),
                                         (a, a, p, p))):
            out[k].append(np.asarray(jax.random.uniform(sub, (n,))))
    return [torch.from_numpy(np.stack(u)) for u in out]


def _batch_jax(gts, masks_on=True):
    boxes, cls, valid, masks = gts
    batch = {"gt_boxes": jnp.asarray(boxes), "gt_classes": jnp.asarray(cls),
             "gt_valid": jnp.asarray(valid)}
    if masks_on:
        batch["gt_masks"] = jnp.asarray(masks)
    return batch


def _batch_torch(gts, masks_on=True):
    boxes, cls, valid, masks = gts
    batch = {"gt_boxes": torch.from_numpy(boxes),
             "gt_classes": torch.from_numpy(cls),
             "gt_valid": torch.from_numpy(valid)}
    if masks_on:
        batch["gt_masks"] = torch.from_numpy(masks)
    return batch


def _no_mask_head(variables):
    return dict(variables, params={k: v for k, v in
                                   variables["params"].items()
                                   if not k.startswith("mask_")})


MODES = {"expectation": ("expectation", True), "sampled": ("sampled", True),
         "nomask": ("expectation", False)}


@functools.lru_cache(maxsize=None)
def _pair():
    """(variables, port model with them, images, gts, the port's eval
    outputs, the JAX outputs, the JAX expectation-mode loss and parameter
    gradients, and the JAX loss key). One JAX compile of the model's
    forward and backward."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    jmodel = jm.MaskRCNN(**DIMS)
    variables = flax_variables_like(jmodel, images.astype(np.float32), rng)
    tmodel = load_into(tm.MaskRCNN(**DIMS), variables,
                       twp.map_mask_rcnn_torch_name)
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images))
    gts = _gts(rng, tout["proposals"].numpy())

    @jit_o0
    def jfn(params, x, boxes, cls, valid, masks):
        def total(params):
            out = jmodel.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True)
            losses = jm.mask_rcnn_losses(
                out, {"gt_boxes": boxes, "gt_classes": cls,
                      "gt_valid": valid, "gt_masks": masks}, 5)
            return losses["total_loss"], (out, losses)

        (_, aux), grads = jax.value_and_grad(total, has_aux=True)(params)
        return aux, grads

    (jout, jlosses), jgrads = jfn(variables["params"],
                                  jnp.asarray(images, jnp.float32),
                                  *(jnp.asarray(a) for a in gts))
    return (variables, tmodel, images, gts, tout, jout, jlosses, jgrads,
            jax.random.PRNGKey(7))


@functools.lru_cache(maxsize=None)
def _loss_cotangents(name):
    """The JAX loss terms of mode ``name`` on the JAX outputs and their
    gradients with respect to the differentiated outputs (the losses'
    compile alone). Without the mask term ("nomask"): the expectation
    mode's, less ``loss_mask`` and its gradient (the other terms do not
    read the masks)."""
    _, _, _, gts, _, jout, _, _, key = _pair()
    if name == "nomask":
        losses, cot = _loss_cotangents("expectation")
        losses = {k: v for k, v in losses.items() if k != "loss_mask"}
        losses["total_loss"] = sum(v for k, v in losses.items()
                                   if k != "total_loss")
        return losses, dict(cot, mask_logits=jnp.zeros_like(
            cot["mask_logits"]))
    mode = MODES[name][0]
    rest = {k: v for k, v in jout.items() if k not in DIFF + ("image_hw",)}

    @jit_o0
    def jfn(diff, rest, batch, key):
        def total(d):
            losses = jm.mask_rcnn_losses({**d, **rest}, batch, 5,
                                         sample_mode=mode, rng=key)
            return losses["total_loss"], losses

        cot, losses = jax.grad(total, has_aux=True)(diff)
        return losses, cot

    return jfn({k: jout[k] for k in DIFF}, rest, _batch_jax(gts), key)


def _grads_like(model, grads):
    """The JAX gradient tree on the port's keys and layouts."""
    sd = model.state_dict()
    zeros = {k: np.zeros(v.shape, np.float32) for k, v in sd.items()}
    if not model.mask_on:
        grads = _no_mask_head({"params": grads})["params"]
    tree = {"params": jax.tree.map(np.asarray, grads),
            "batch_stats": jax.tree.map(np.asarray, _pair()[0].get(
                "batch_stats", {}))}
    return jax_to_torch_state_dict(tree, zeros, twp.map_mask_rcnn_torch_name)


def _check_grads(model, jgrads):
    want = _grads_like(model, jgrads)
    named = dict(model.named_parameters())
    whole = np.sqrt(sum(float(np.sum(np.square(want[k].astype(np.float64))))
                        for k in named))
    checked = 0
    for name, p in named.items():
        w = want[name].astype(np.float64)
        g = p.grad.numpy().astype(np.float64) if p.grad is not None else \
            np.zeros_like(w)
        floor = max(float(np.linalg.norm(w)), 1e-3 * whole)
        err = float(np.abs(g - w).max())
        assert err <= 2e-4 * floor, (name, err, floor)
        checked += float(np.abs(w).max()) > 0
    return checked


def test_forward_matches_jax():
    """The uint8 path's outputs: the RPN's, the proposals (the NMS over 5
    levels of 32 candidates), their scores and validity, the box head's
    and the mask head's."""
    tout, jout = _pair()[4], _pair()[5]
    for k in KEYS:
        _close(tout[k].numpy(), jout[k], what=k)
    np.testing.assert_array_equal(tout["proposal_valid"].numpy(),
                                  np.asarray(jout["proposal_valid"]))
    assert tout["image_hw"] == (SIZE, SIZE)


def _port_losses(model, name):
    """The port model's train-mode outputs (the differentiated ones
    keeping their gradients) and its loss terms of mode ``name``."""
    _, _, images, gts, _, _, _, _, key = _pair()
    mode, masks_on = MODES[name]
    model.train()
    out = model(torch.from_numpy(images))
    for k in DIFF:
        if k in out:
            out[k].retain_grad()
    uniforms = (_uniforms(key, out["anchors"].shape[0],
                          DIMS["num_proposals"])
                if mode == "sampled" else None)
    return out, tm.mask_rcnn_losses(out, _batch_torch(gts, masks_on), 5,
                                    sample_mode=mode, uniforms=uniforms)


@pytest.mark.parametrize("name", list(MODES))
def test_losses_and_output_gradients_match_jax(name):
    """Every loss term and its gradient with respect to each output of the
    model, in expectation and sampled mode (the sampled mode on the JAX
    loss's own uniforms) and without the mask term; foreground proposals
    and a mask term where on."""
    variables = _pair()[0]
    jlosses, jcot = _loss_cotangents(name)
    model = load_into(tm.MaskRCNN(**DIMS), variables,
                      twp.map_mask_rcnn_torch_name)
    out, losses = _port_losses(model, name)
    assert ("loss_mask" in losses) == MODES[name][1]
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=TOL, err_msg=k)
    assert float(losses["loss_box_reg"].detach()) > 0
    losses["total_loss"].backward()
    for k in DIFF:
        want = np.asarray(jcot[k])
        got = (out[k].grad if out[k].grad is not None
               else torch.zeros(want.shape)).numpy()
        _close(got, want, what=k)
    assert float(np.abs(np.asarray(jcot["mask_logits"])).max() > 0) == \
        MODES[name][1]


def test_parameter_gradients_match_jax():
    """Every parameter's gradient of the expectation-mode total loss
    against the JAX gradient (one model backward in each package)."""
    variables, _, _, _, _, _, jlosses, jgrads, _ = _pair()
    model = load_into(tm.MaskRCNN(**DIMS), variables,
                      twp.map_mask_rcnn_torch_name)
    _, losses = _port_losses(model, "expectation")
    np.testing.assert_allclose(float(losses["total_loss"].detach()),
                               float(jlosses["total_loss"]), rtol=TOL)
    losses["total_loss"].backward()
    assert _check_grads(model, jgrads) > 40


def test_mask_off_model_matches_jax():
    """Faster R-CNN's model (no mask head) on the same weights: its
    outputs and loss terms against the JAX loss without ``gt_masks``, and
    its parameter gradients against the mask-on model's backward of the
    JAX loss's output gradients (the backward that
    :func:`test_parameter_gradients_match_jax` holds against JAX)."""
    variables = _pair()[0]
    jlosses, jcot = _loss_cotangents("nomask")
    off = load_into(tm.MaskRCNN(**DIMS, mask_on=False),
                    _no_mask_head(variables), twp.map_mask_rcnn_torch_name)
    out, losses = _port_losses(off, "nomask")
    assert "mask_logits" not in out and "loss_mask" not in losses
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=TOL, err_msg=k)
    losses["total_loss"].backward()
    on = load_into(tm.MaskRCNN(**DIMS), variables,
                   twp.map_mask_rcnn_torch_name).train()
    on_out = on(torch.from_numpy(_pair()[2]))
    keys = DIFF[:-1]
    torch.autograd.backward([on_out[k] for k in keys],
                            [torch.from_numpy(np.array(jcot[k]))
                             for k in keys])
    on_grads = dict(on.named_parameters())
    checked = 0
    for name, p in off.named_parameters():
        want = on_grads[name].grad
        assert want is not None, name
        err = float((p.grad - want).abs().max())
        assert err <= 1e-4 * max(float(want.norm()), 1e-6), (name, err)
        checked += 1
    assert checked > 30


def test_postprocess_matches_jax():
    """``mask_rcnn_postprocess`` at score threshold 0 (random weights),
    10 kept: the port's tail on the port's outputs against the JAX tail on
    the JAX outputs."""
    tout, jout = _pair()[4], _pair()[5]
    want = jit_o0(functools.partial(
        jm.mask_rcnn_postprocess, score_threshold=0.0, max_detections=10))(
        {k: v for k, v in jout.items() if k != "image_hw"})
    got = tm.mask_rcnn_postprocess(tout, score_threshold=0.0,
                                   max_detections=10)
    for f in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    _close(got.scores.numpy(), want.scores, what="scores")
    _close(got.boxes.numpy(), want.boxes, what="boxes")
    assert int(got.valid.sum()) > 5 and got.boxes.shape == (B, 10, 4)


def test_build_system_step_matches_jax(monkeypatch):
    """One step of the port's ``build_system`` on the mini config in
    expectation mode (SGD, float32) against the loss and gradient of the
    JAX step's computation (:func:`_pair`'s compile: ``mask_rcnn_losses``
    as ``engine.py:281-298`` wires it): both build the narrow model; then
    the sampled mode's step draws from the model's generator, reseeded a
    step: two builds give the same step."""
    variables, _, images, gts, _, _, jlosses, jgrads, _ = _pair()
    monkeypatch.setattr(engine, "build_model", lambda cfg, device, seed: (
        load_into(tm.MaskRCNN(**DIMS), variables,
                  twp.map_mask_rcnn_torch_name)))
    cfg = rcnn_mini_cfg(get_cfg, **{"MODEL.ROI_HEADS.SAMPLE_MODE": "expectation",
                            "SOLVER.WARMUP_ITERS": "0"})
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    # the JAX fields with the masks on (engine.py:285)
    assert fields == ("image", "gt_masks", "gt_boxes", "gt_classes",
                      "gt_valid")
    assert model.generator is not None
    batch = {"image": torch.from_numpy(images), **_batch_torch(gts)}
    state, metrics = step(state, batch)
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(jlosses[k]),
                                   rtol=TOL, err_msg=k)
    want = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                       for g in jax.tree_util.tree_leaves(jgrads)))
    np.testing.assert_allclose(float(metrics["grad_norm"]), want, rtol=1e-3)
    model, st, sstep, _ = engine.build_system(rcnn_mini_cfg(get_cfg),
                                              device="cpu")
    st, sampled = sstep(st, batch)
    for k in LOSSES:
        assert np.isfinite(float(sampled[k])), k
    # the step reseeded the draws' generator from the seed and the step
    assert model.generator.initial_seed() == 0
