"""The port's SparseInst (ResNet, FPN-PPM encoder, IAM decoders, the auction
matcher, the mask losses, the serving tail, AdamW, ``build_system``) and
YOLOV7P on ResNet-50 against the JAX package, in float32 on the CPU.

Weights: flax variables drawn with numpy at the flax init's scale, with
random BatchNorm statistics and affine parameters
(``_torch_port_helpers.flax_variables_like``), moved into the port by
``jax_to_torch_state_dict`` through ``map_sparseinst_torch_name``.

Tolerances, each with its reason:

* forward outputs: 1e-4 of each output's largest magnitude (XLA-CPU and
  oneDNN sum each convolution in another order; measured 1e-6 to 5e-6);
* assignments of the auction: exact, on the same cost (the port keeps the
  JAX tie rules); its total cost within ``G * eps * scale`` of scipy's
  optimum (the auction's guarantee);
* loss terms: 1e-5 relative, assignments exact;
* gradients of one train step: each parameter's within 1e-4 of its norm.
  The port runs in NCHW here: in channels_last (the card's layout)
  oneDNN's CPU convolutions sum in an order 5-10x less precise (1e-6
  against 2.5e-7 of the max on a 3x3 at 256 channels), enough to flip a
  ReLU whose input sits at 0; on one of three weight draws that moved a
  frozen-BN bias gradient by 3.9e-3 of its norm, while the JAX float32
  gradient stayed 1.2e-6 from a float64 run of the port;
* AdamW: 3 steps against optax's ``adamw_with_groups``, parameters within
  1e-6 of each tensor's largest magnitude before or after the step, or of
  10 lr (an Adam step's size) where the tensor is smaller.
"""

import dataclasses
import functools
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from _torch_port_helpers import (
    flax_variables_like,
    load_into,
    numpy_variables,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.backbones import resnet as jresnet
from yolov7_d2_tpu.models.meta_arch import sparseinst as jsi
from yolov7_d2_tpu.ops import matchers as jmatchers
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import SparseInstConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system
from yolov7_d2_tpu_torch.models.backbones.resnet import (
    FrozenBatchNorm2d,
    ResNet,
    ResNetSpec,
)
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as tsi
from yolov7_d2_tpu_torch.ops.matchers import auction_lap, hungarian_match
from yolov7_d2_tpu_torch.train.optimizer import AdamW, build_optimizer
from yolov7_d2_tpu_torch.utils import weight_port as twp

REPO = Path(__file__).resolve().parent.parent
SI_DIR = REPO / "configs" / "coco" / "sparseinst"
FWD_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
SIZE = 64


def _close(got, want, tol=FWD_TOL, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _cfg(name, **opts):
    cfg = get_cfg()
    cfg.merge_from_file(str(SI_DIR / name))
    for k, v in opts.items():
        cfg.merge_from_list([k.replace("__", "."), repr(v)])
    return cfg


def _images(rng, b=2, size=SIZE):
    """Integer-valued float32 images, so that the uint8 path (the
    normalize kernel's plain version on the CPU) sees the same pixels."""
    return rng.integers(0, 256, (b, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model_pair(groups: int, seed: int = 0):
    """(flax SparseInst, variables, port SparseInst with them, images)."""
    rng = np.random.default_rng(seed)
    images = _images(rng)
    jmodel = jsi.SparseInst(groups=groups, resnet_stride_in_1x1=True)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = tsi.SparseInst(groups=groups)
    load_into(tmodel, variables, twp.map_sparseinst_torch_name)
    return jmodel, variables, tmodel, images


# ---------------------------------------------------------------------------
# name maps and the full-width parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("yaml", ["sparse_inst_r50_base.yaml",
                                  "sparse_inst_r50_giam.yaml"])
def test_full_width_variables_carry_over(yaml):
    """Every leaf of the JAX builder's full-width variables (shapes by
    ``jax.eval_shape``, no compile) lands on exactly one key of the
    port's model of the same config, with its shape; the port's copies of
    the JAX name maps agree with the originals on every key. (The vd
    stem's keys are held by the vd ResNet's test below.)"""
    tcfg = _cfg(yaml, SOLVER__AMP__ENABLED=False)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(SI_DIR / yaml))
    jcfg.merge_from_list(["SOLVER.AMP.ENABLED", "False"])
    jmodel = jsi.build_sparseinst(jcfg)
    h, w = tcfg.INPUT.INPUT_SIZE
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, h, w, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    scfg = SparseInstConfig.from_cfg(tcfg)
    model = tsi.SparseInst(
        num_classes=scfg.num_classes, groups=scfg.groups,
        resnet=scfg.resnet, in_features=scfg.in_features)
    vd = scfg.resnet.vd
    sd = twp.jax_to_torch_state_dict(
        variables, model.state_dict(),
        functools.partial(twp.map_sparseinst_torch_name, vd=vd))
    assert sd.keys() == model.state_dict().keys()
    for key in model.state_dict():
        module = key.rpartition(".")[0]
        prefix, _, rest = module.partition(".")
        if prefix == "encoder":
            assert twp.map_sparseinst_encoder_torch_name(rest) == \
                jwp.map_sparseinst_encoder_torch_name(rest)
        elif prefix == "decoder":
            assert twp.map_sparseinst_decoder_torch_name(rest) == \
                jwp.map_sparseinst_decoder_torch_name(rest)
        else:
            assert twp.map_d2_resnet_name(module) == \
                jwp.map_d2_resnet_name(module), module
    groups = 4 if "giam" in yaml else 1
    assert model.decoder.inst_branch.iam_conv.groups == groups
    assert hasattr(model.decoder.inst_branch, "fc") == (groups > 1)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vd,stride_in_1x1", [(False, False), (True, False)])
def test_resnet50_matches_jax(vd, stride_in_1x1):
    """ResNet-50 with the stride on the 3x3 (``Base-SparseInst.yaml``) and
    the vd variant; the stride on the 1x1 (``sparse_inst_r50_base.yaml``)
    runs inside the whole model's test."""
    rng = np.random.default_rng(3)
    x = (_images(rng) - 110.0) / 60.0
    jmodel = jresnet.ResNet(depth=50, vd=vd, stride_in_1x1=stride_in_1x1)
    variables = flax_variables_like(jmodel, x, rng)
    tmodel = ResNet(ResNetSpec(vd=vd, stride_in_1x1=stride_in_1x1))
    nested = {c: {"backbone": v} for c, v in variables.items()}
    load_into(tmodel, nested,
              lambda n: twp.map_resnet_torch_name("backbone." + n, vd))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["res3", "res4", "res5"]
    for k in want:
        _close(got[k].permute(0, 2, 3, 1), want[k], what=k)


def test_encoder_matches_jax():
    rng = np.random.default_rng(4)
    chans, c = (48, 96, 192), 64
    feats = [rng.normal(0, 1, (2, 16 // 2 ** i, 16 // 2 ** i, ch)).astype(
        np.float32) for i, ch in enumerate(chans)]
    jmodel = jsi.InstanceContextEncoder(c)
    shapes = jax.eval_shape(
        lambda f: jmodel.init(jax.random.PRNGKey(0), f),
        [jnp.asarray(f) for f in feats])
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: rng.normal(0, (np.prod(s.shape[:-1]) ** -0.5
                                    if p[-1].key == "kernel" else 0.3),
                                s.shape).astype(np.float32), shapes)
    tmodel = tsi.InstanceContextEncoder(chans, c)
    load_into(tmodel, params, twp.map_sparseinst_encoder_torch_name)
    want = jmodel.apply(params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tmodel([torch.from_numpy(f).permute(0, 3, 1, 2)
                      for f in feats])
    _close(got.permute(0, 2, 3, 1), want, what="fused")


@pytest.mark.parametrize("groups", [1, 4])
def test_decoder_matches_jax(groups):
    rng = np.random.default_rng(5 + groups)
    dims = dict(num_masks=10, num_classes=5, kernel_dim=16, inst_dim=32,
                mask_dim=32, groups=groups)
    feats = rng.normal(0, 1, (2, 12, 12, 24)).astype(np.float32)
    jmodel = jsi.IAMDecoder(**dims)
    shapes = jax.eval_shape(
        lambda f: jmodel.init(jax.random.PRNGKey(0), f), jnp.asarray(feats))
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: rng.normal(0, (np.prod(s.shape[:-1]) ** -0.5
                                    if p[-1].key == "kernel" else 0.3),
                                s.shape).astype(np.float32), shapes)
    tmodel = tsi.IAMDecoder(24, **dims)
    load_into(tmodel, params, twp.map_sparseinst_decoder_torch_name)
    want = jmodel.apply(params, jnp.asarray(feats))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(feats).permute(0, 3, 1, 2))
    for k in ("cls_logits", "obj_logits", "mask_logits"):
        _close(got[k], want[k], what=k)
    _close(got["iam"], np.asarray(want["iam"]).transpose(0, 3, 1, 2),
           what="iam")


# ---------------------------------------------------------------------------
# the auction matcher
# ---------------------------------------------------------------------------

def _tied_costs(n_cases=24, n=100, seed=0):
    rng = np.random.default_rng(seed)
    costs, valid = [], []
    for t in range(n_cases):
        g = [1, 7, 50, 99, 100][t % 5] if t < 10 else int(rng.integers(1, 101))
        c = rng.random((100, n)).astype(np.float32)
        # quantized costs: many ties within and across rows
        c = np.round(c * [20, 5, 100][t % 3]) / [20, 5, 100][t % 3]
        c = (c * [1.0, 3.0, 0.4][t % 3]).astype(np.float32)
        costs.append(c)
        valid.append(np.arange(100) < g)
    return np.stack(costs), np.stack(valid)


def test_auction_matches_jax_and_scipy():
    """24 tied costs, G 1..100 valid rows of 100 against N = 100 columns,
    all in one batched call: assignments equal to the JAX matcher's, run
    one cost at a time; totals within G * eps * scale of scipy's."""
    costs, valid = _tied_costs()
    col_of, row_of, iters = hungarian_match(
        torch.from_numpy(costs), torch.from_numpy(valid),
        torch.ones(costs.shape[:1] + costs.shape[2:], dtype=torch.bool))
    jmatch = jax.jit(jmatchers.hungarian_match)
    for i, (c, v) in enumerate(zip(costs, valid)):
        jc, jr = jmatch(jnp.asarray(c), jnp.asarray(v),
                        jnp.ones(c.shape[1], bool))
        np.testing.assert_array_equal(col_of[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(row_of[i].numpy(), np.asarray(jr))
        g = int(v.sum())
        rows, cols = linear_sum_assignment(c[:g])
        got = float(c[np.arange(g), col_of[i].numpy()[:g]].sum())
        scale = max(float(np.abs(c).max()), 1.0)
        assert got <= float(c[rows, cols].sum()) + g * 1e-3 * scale + 1e-5
        assert len(set(col_of[i].numpy()[:g])) == g
        assert (col_of[i].numpy()[g:] == -1).all()
    assert int(iters.max()) > 8  # the batch ran past a host check


def test_auction_images_do_not_interact():
    costs, valid = _tied_costs(6, seed=1)
    t = torch.from_numpy
    both, _, _ = auction_lap(-t(costs), t(valid), torch.ones(6, 100,
                                                             dtype=torch.bool))
    for i in range(6):
        one, _, _ = auction_lap(-t(costs[i:i + 1]), t(valid[i:i + 1]),
                                torch.ones(1, 100, dtype=torch.bool))
        assert torch.equal(one[0], both[i])


# ---------------------------------------------------------------------------
# losses, gradients, tail
# ---------------------------------------------------------------------------

def _gt(rng, b=2, g=8, size=SIZE, counts=(5, 8), classes=80):
    masks = np.zeros((b, g, size, size), np.uint8)
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(counts):
        for j in range(n):
            y0, x0 = rng.integers(0, size - 20, 2)
            h, w = rng.integers(6, 20, 2)
            masks[i, j, y0:y0 + h, x0:x0 + w] = 1
            masks[i, j, y0, x0] = 0
        cls[i, :n] = rng.integers(0, classes, n)
        valid[i, :n] = True
    return masks, cls, valid


def _random_out(rng, b=2, n=100, c=80, hm=SIZE // 4):
    return {"cls_logits": rng.normal(-2, 1.5, (b, n, c)).astype(np.float32),
            "obj_logits": rng.normal(0, 1, (b, n)).astype(np.float32),
            "mask_logits": rng.normal(0, 2, (b, n, hm, hm)).astype(
                np.float32)}


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def test_focal_loss_and_dice_score_match_jax():
    from yolov7_d2_tpu.ops import losses as jlosses
    from yolov7_d2_tpu_torch.ops import losses as tlosses

    rng = np.random.default_rng(8)
    logits = rng.normal(0, 3, (4, 50)).astype(np.float32)
    targets = (rng.random((4, 50)) > 0.7).astype(np.float32)
    for alpha in (0.25, -1.0):
        np.testing.assert_allclose(
            tlosses.sigmoid_focal_loss(torch.from_numpy(logits),
                                       torch.from_numpy(targets),
                                       alpha=alpha).numpy(),
            np.asarray(jlosses.sigmoid_focal_loss(logits, targets,
                                                  alpha=alpha)),
            rtol=1e-6, atol=1e-7)
    pred = rng.random((3, 5, 64)).astype(np.float32)
    masks = (rng.random((3, 5, 64)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.dice_score(torch.from_numpy(pred),
                           torch.from_numpy(masks)).numpy(),
        np.asarray(jlosses.dice_score(pred, masks)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_and_assignments_match_jax(seed):
    rng = np.random.default_rng(seed)
    out = _random_out(rng)
    masks, cls, valid = _gt(rng)
    want = jax.jit(jsi.sparseinst_losses, static_argnums=4)(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(masks),
        jnp.asarray(cls), jnp.asarray(valid), 80)
    got = tsi.sparseinst_losses(_torch(out), torch.from_numpy(masks),
                                torch.from_numpy(cls),
                                torch.from_numpy(valid), 80)
    for k in ("loss_ce", "loss_dice", "loss_mask", "loss_objectness",
              "num_inst", "total_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    gt_small = jax.image.resize(jnp.asarray(masks, jnp.float32),
                                (2, 8, SIZE // 4, SIZE // 4), "bilinear",
                                antialias=False)
    jp, jok = jax.jit(jsi.sparseinst_match)(
        {k: jnp.asarray(v) for k, v in out.items()}, gt_small,
        jnp.asarray(cls), jnp.asarray(valid))
    tp, tok, _ = tsi.sparseinst_match(
        _torch(out), tsi._resize(torch.from_numpy(masks).float(),
                                 (SIZE // 4, SIZE // 4)),
        torch.from_numpy(cls), torch.from_numpy(valid))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_forward_and_train_step_gradients_match_jax(monkeypatch):
    """The whole model at full width (``BaseIAMDecoder``, ResNet-50 with
    the stride on the 1x1), 64 px: its outputs (channels_last, uint8 and
    float input), then one train step's loss terms and parameter
    gradients (NCHW, see the module docstring). The group decoder is held
    at reduced width above."""
    jmodel, variables, tmodel, images = _model_pair(1)
    rng = np.random.default_rng(11)
    masks, cls, valid = _gt(rng, counts=(4, 6))

    def loss(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           jnp.asarray(images), train=True)
        losses = jsi.sparseinst_losses(out, jnp.asarray(masks),
                                       jnp.asarray(cls), jnp.asarray(valid),
                                       80)
        return losses["total_loss"], (losses, out)

    jgrads, (jlosses, want) = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"])
    with torch.no_grad():
        for x in (images, images.astype(np.uint8)):
            got = tmodel(torch.from_numpy(x))
            for k in ("cls_logits", "obj_logits", "mask_logits"):
                _close(got[k], want[k], what=k)
            _close(got["iam"], np.asarray(want["iam"]).transpose(0, 3, 1, 2))
    assert got["mask_logits"].shape == (2, 100, SIZE // 4, SIZE // 4)

    plain = tsi.normalize_images_plain
    monkeypatch.setattr(tsi, "normalize_images_plain",
                        lambda *a: plain(*a).contiguous())
    tmodel.train()
    tmodel.zero_grad()
    losses = tsi.sparseinst_losses(
        tmodel(torch.from_numpy(images)), torch.from_numpy(masks),
        torch.from_numpy(cls), torch.from_numpy(valid), 80)
    losses["total_loss"].backward()
    tmodel.eval()
    for k in ("loss_ce", "loss_dice", "loss_mask", "loss_objectness",
              "total_loss"):
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=FWD_TOL,
                                   err_msg=k)
    grads = twp.jax_to_torch_state_dict(
        numpy_variables({"params": jgrads,
                         "batch_stats": variables["batch_stats"]}),
        tmodel.state_dict(), twp.map_sparseinst_torch_name)
    frozen = 0
    for name, p in tmodel.named_parameters():
        want_g = grads[name]
        err = float(np.abs(p.grad.numpy() - want_g).max())
        assert err <= GRAD_TOL * np.linalg.norm(want_g) + 1e-12, (name, err)
        frozen += ".norm." in name and float(np.abs(want_g).max()) > 0
    assert frozen > 100  # the JAX step trains the frozen BN's scale / bias


def test_postprocess_matches_jax():
    rng = np.random.default_rng(7)
    out = _random_out(rng, n=100)
    out["cls_logits"][0, 10:20] = out["cls_logits"][0, 30]  # tied scores
    out["obj_logits"][0, 10:20] = out["obj_logits"][0, 30]
    out["mask_logits"][0, 10:20] = out["mask_logits"][0, 30]
    out["mask_logits"][1, 5] = -9.0  # an empty mask
    want = jsi.sparseinst_postprocess(
        {k: jnp.asarray(v) for k, v in out.items()})
    got = tsi.sparseinst_postprocess(_torch(out))
    for f in ("classes", "valid", "boxes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.masks.numpy(), np.asarray(want.masks),
                               atol=1e-6)
    assert not bool(got.valid[1].all())


@pytest.mark.parametrize("orig_hw", [(100, 75), (24, 30)])
def test_upsample_masks_two_stage_matches_jax(orig_hw):
    """Masks of a 64 px input whose letterbox holds a 64x48 image, back to
    an original that is larger (stage 2 enlarges) or smaller (stage 2
    shrinks: antialiased in both packages). Pixels that differ, counted:
    at most 0.5% (bilinear sums in another order, at the threshold)."""
    rng = np.random.default_rng(9)
    masks = 1 / (1 + np.exp(-rng.normal(0, 3, (6, 16, 16)))).astype(
        np.float32)
    want = np.asarray(jsi.upsample_masks_two_stage(
        jnp.asarray(masks), (64, 64), (64, 48), orig_hw))
    got = tsi.upsample_masks_two_stage(torch.from_numpy(masks), (64, 64),
                                       (64, 48), orig_hw).numpy()
    assert got.shape == want.shape == (6,) + orig_hw
    differ = int((got != want).sum())
    print(f"{orig_hw}: {differ} of {want.size} mask pixels differ")
    assert differ <= 0.005 * want.size


@pytest.mark.parametrize("in_hw,out_hw", [
    ((1, 1), (20, 20)), ((2, 2), (20, 20)), ((3, 3), (20, 20)),
    ((6, 6), (20, 20)), ((40, 40), (80, 80)), ((20, 20), (80, 80)),
    ((80, 80), (160, 160))])
def test_bilinear_resize_backward_matches_interpolate_and_jax(in_hw, out_hw):
    """``_resize``'s fixed-order backward (``_BilinearResize``) at every
    shape SparseInst R-50 at 640 takes it through: the PPM's 1, 2, 3 and 6
    up to 20, the encoder's 40 and 20 up to 80 and the mask logits' 2x (80
    up to 160). Its forward is ``F.interpolate``'s, bitwise; its input
    gradient is held against ``F.interpolate``'s own autograd (the form it
    replaces) and against ``jax.vjp`` of ``jax.image.resize``, within 1e-6
    of the gradient's largest magnitude (the same float32 sums of at most
    ``(out / in + 1)^2`` terms, in another order)."""
    rng = np.random.default_rng(in_hw[0] * 1000 + out_hw[0])
    x = rng.normal(size=(2, 3) + in_hw).astype(np.float32)
    g = rng.normal(size=(2, 3) + out_hw).astype(np.float32)
    ours = torch.from_numpy(x).requires_grad_(True)
    y = tsi._resize(ours, out_hw)
    assert type(y.grad_fn).__name__ == "_BilinearResizeBackward"
    y.backward(torch.from_numpy(g))
    plain = torch.from_numpy(x).requires_grad_(True)
    y_plain = torch.nn.functional.interpolate(
        plain, size=out_hw, mode="bilinear", align_corners=False)
    y_plain.backward(torch.from_numpy(g))
    assert torch.equal(y.detach(), y_plain.detach())
    y_jax, vjp = jax.vjp(lambda a: jax.image.resize(
        a, (2, 3) + out_hw, "bilinear", antialias=False), jnp.asarray(x))
    _close(y.detach(), y_jax, tol=1e-6, what="forward")
    scale = float(plain.grad.abs().max())
    for want, what in ((plain.grad, "F.interpolate"),
                       (vjp(jnp.asarray(g))[0], "jax")):
        err = float(np.abs(ours.grad.numpy() - np.asarray(want)).max())
        print(f"{in_hw} -> {out_hw}: gradient against {what} {err:.2e} "
              f"of {scale:.3g}")
        assert err <= 1e-6 * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# AdamW, builders
# ---------------------------------------------------------------------------

class _Net(torch.nn.Module):
    """A small decoder (weights, biases, fc) and a frozen-BN convolution
    (the norm class), named as the port's SparseInst."""

    def __init__(self):
        super().__init__()
        from yolov7_d2_tpu_torch.models.backbones.resnet import ConvNorm

        self.decoder = tsi.IAMDecoder(24, num_masks=6, num_classes=5,
                                      kernel_dim=8, inst_dim=16, mask_dim=16,
                                      groups=2)
        self.backbone = torch.nn.Module()
        self.backbone.stem = torch.nn.Module()
        self.backbone.stem.conv1 = ConvNorm(3, 8, 3)


def _flax_tree(net, values):
    """{torch name: array} -> the flax tree of the same leaves (paths from
    ``map_sparseinst_torch_name``, kernels in flax's layout)."""
    tree = {}
    for name, v in values.items():
        module, _, leaf = name.rpartition(".")
        path = twp.map_sparseinst_torch_name(module)
        flax_leaf = {"weight": "scale" if path[-1] == "bn" else "kernel",
                     "bias": "bias"}[leaf]
        if flax_leaf == "kernel":
            v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[flax_leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("bf16_state", [False, True])
def test_adamw_matches_optax(bf16_state):
    """3 steps of the port's AdamW (through ``build_optimizer``, the
    schedule's learning rate a step) against the JAX ``build_optimizer``'s
    optax chain on the same gradients, with the weight, bias and norm
    decay classes; bfloat16 first moments with ``ADAM_BF16_STATE``."""
    import optax

    from yolov7_d2_tpu.train.optimizer import build_optimizer as jax_opt
    from yolov7_d2_tpu_torch.train.schedules import build_lr_schedule

    opts = dict(SOLVER__WEIGHT_DECAY=5e-2, SOLVER__BASE_LR=1e-2,
                SOLVER__WARMUP_ITERS=2, SOLVER__ADAM_BF16_STATE=bf16_state)
    tcfg = SparseInstConfig.from_cfg(_cfg("sparse_inst_r50_base.yaml",
                                          **opts))
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(SI_DIR / "sparse_inst_r50_base.yaml"))
    for k, v in opts.items():
        jcfg.merge_from_list([k.replace("__", "."), repr(v)])
    rng = np.random.default_rng(13)
    net = _Net()
    for p in net.parameters():
        p.data = torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(
            np.float32))
    params = _flax_tree(net, {n: p.detach().numpy()
                              for n, p in net.named_parameters()})
    tx = jax_opt(jcfg, params)
    state = tx.init(params)
    update = jax.jit(tx.update)
    start = _flax_tree(net, {n: p.detach().numpy().copy()
                             for n, p in net.named_parameters()})
    opt = build_optimizer(tcfg, net)
    assert isinstance(opt, AdamW)
    assert {g["decay_class"] for g in opt.param_groups} == {
        "weight", "bias", "norm"}
    schedule = build_lr_schedule(tcfg)
    for step in range(3):
        for p in net.parameters():
            p.grad = torch.from_numpy(rng.normal(0, 1, p.shape).astype(
                np.float32))
        grads = _flax_tree(net, {n: p.grad.numpy()
                                 for n, p in net.named_parameters()})
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for group in opt.param_groups:
            group["lr"] = schedule(step) * group["lr_mult"]
        opt.step()
        got = _flax_tree(net, {n: p.detach().numpy()
                               for n, p in net.named_parameters()})
        for (path, w), (_, g), (_, s0) in zip(
                jax.tree_util.tree_leaves_with_path(params),
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves_with_path(start)):
            err = float(np.abs(np.asarray(g) - np.asarray(w)).max())
            scale = max(float(np.abs(np.asarray(w)).max()),
                        float(np.abs(np.asarray(s0)).max()),
                        10 * schedule(step))
            assert err <= ADAM_TOL * scale, (step, path, err)
    mu = opt.state[next(net.parameters())]["mu"]
    assert mu.dtype == (torch.bfloat16 if bf16_state else torch.float32)


@pytest.mark.parametrize("yaml,groups,size,stride,vd", [
    ("sparse_inst_r50_base.yaml", 1, 640, True, False),
    ("sparse_inst_r50_giam.yaml", 4, 608, True, False),
    ("Base-SparseInst.yaml", 1, 640, False, False),
    ("sparse_inst_r50vd_base.yaml", 1, 640, False, True)])
def test_sparseinst_config_reads_the_yaml(yaml, groups, size, stride, vd):
    """What the JAX builder reads: the base yaml has no ``_BASE_``, so its
    ``STRIDE_IN_1X1`` is the tree's True; ``Base-SparseInst.yaml`` says
    False; the vd ResNet strides on the 3x3 whatever the key says."""
    scfg = SparseInstConfig.from_cfg(_cfg(yaml))
    assert (scfg.groups, scfg.input_size, scfg.resnet.stride_in_1x1,
            scfg.resnet.vd) == (groups, (size, size), stride, vd)
    assert scfg.optimizer == "adamw" and scfg.base_lr == 5e-5
    assert scfg.weight_decay == 5e-4 and scfg.amp and not scfg.ema
    assert (scfg.num_masks, scfg.kernel_dim, scfg.scale_factor) == (
        100, 128, 2.0)


@pytest.mark.parametrize("yaml,groups", [("sparse_inst_r50_base.yaml", 1),
                                         ("sparse_inst_r50_giam.yaml", 4)])
def test_build_system_and_model_for_sparseinst(yaml, groups):
    cfg = _cfg(yaml)
    scfg = SparseInstConfig.from_cfg(cfg)
    assert scfg.optimizer == "adamw" and scfg.base_lr == 5e-5
    assert scfg.weight_decay == 5e-4 and scfg.amp and not scfg.ema
    model, state, step, fields = build_system(cfg, device="cpu")
    assert isinstance(model, tsi.SparseInst) and model.training
    assert model.dtype == torch.bfloat16
    assert fields == ("image", "gt_masks", "gt_classes", "gt_valid")
    assert isinstance(state.optimizer, AdamW)
    assert model.decoder.inst_branch.iam_conv.groups == groups
    again = build_model(scfg, "cpu")
    assert not again.training
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_sparseinst_defaults_to_the_card_and_refuses_dcn():
    """The builders default to the card; the DCN configs, which this test
    held to raise before DCN came, build DCNv2 in res4 and res5
    (``tests/test_torch_port_dcn.py`` holds them against JAX)."""
    from yolov7_d2_tpu_torch.ops.deform_conv import DeformConv

    for fn in (tsi.build_sparseinst, build_system):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert SparseInstConfig().resnet == ResNetSpec()
    model, _, _, _ = build_system(_cfg("sparse_inst_r50_dcn_giam_aug.yaml"),
                                  device="cpu")
    dcn = [n for n, m in model.named_modules() if isinstance(m, DeformConv)]
    assert len(dcn) == 7 and all(n.startswith(("backbone.res4.",
                                               "backbone.res5."))
                                 for n in dcn)
    with pytest.raises(NotImplementedError, match="SparseInstConfig"):
        tsi.build_sparseinst(dataclasses.replace(
            __import__("yolov7_d2_tpu_torch.config", fromlist=["x"])
            .YoloxConfig(), meta_architecture="SparseInst"), "cpu")


def test_frozen_bn_stays_frozen_and_trains_its_affine():
    """``train()`` leaves FrozenBN in eval; a step moves its scale and
    bias (as the JAX step does) but not its statistics."""
    cfg = SparseInstConfig(amp=False, input_size=(64, 64), warmup_iters=0,
                           base_lr=1e-3)
    model, state, step, _ = build_system(cfg, device="cpu")
    frozen = [m for m in model.modules() if isinstance(m, FrozenBatchNorm2d)]
    assert len(frozen) == 53 and not any(m.training for m in frozen)
    stats = [b.clone() for m in frozen for b in (m.running_mean,
                                                 m.running_var)]
    affine = [p.detach().clone() for m in frozen for p in (m.weight, m.bias)]
    rng = np.random.default_rng(1)
    masks, cls, valid = _gt(rng, counts=(3, 2))
    batch = {"image": torch.from_numpy(_images(rng).astype(np.uint8)),
             "gt_masks": torch.from_numpy(masks),
             "gt_classes": torch.from_numpy(cls),
             "gt_valid": torch.from_numpy(valid)}
    state, metrics = step(state, batch)
    assert float(metrics["num_inst"]) == 5.0
    assert torch.isfinite(metrics["total_loss"])
    assert float(metrics["match_iters"]) >= 1
    after = [b for m in frozen for b in (m.running_mean, m.running_var)]
    assert all(torch.equal(a, b) for a, b in zip(stats, after))
    moved = [p.detach() for m in frozen for p in (m.weight, m.bias)]
    assert sum(not torch.equal(a, b) for a, b in zip(affine, moved)) > 50


# ---------------------------------------------------------------------------
# YOLOV7P on ResNet-50 (configs/coco/r50.yaml)
# ---------------------------------------------------------------------------

def test_yolov7p_r50_matches_jax():
    """The JAX ``build_yolov7p`` on r50.yaml (ResNet-50 with FrozenBN,
    PAFPN at width 1.0, the direct head) at 64 px and 4 classes: train-mode
    head outputs within the forward's tolerance and the loss terms of one
    step within 1e-4."""
    from yolov7_d2_tpu.models.meta_arch import yolov7 as jarch
    from yolov7_d2_tpu_torch.config import AnchorYoloConfig
    from yolov7_d2_tpu_torch.engine import make_anchor_yolo_loss

    yaml = str(REPO / "configs" / "coco" / "r50.yaml")
    # unit-scale pixel statistics: the yaml's raw-scale PIXEL_MEAN with
    # PIXEL_STD 1 makes x / 255 - mean a near-constant input (ROADMAP.md
    # C.17), which train-mode BatchNorm then amplifies
    opts = ["MODEL.YOLO.CLASSES", "4", "INPUT.INPUT_SIZE", "[64, 64]",
            "SOLVER.AMP.ENABLED", "False",
            "MODEL.PIXEL_MEAN", "[0.406, 0.456, 0.485]",
            "MODEL.PIXEL_STD", "[0.225, 0.224, 0.229]"]
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(yaml)
    jcfg.merge_from_list(opts)
    tcfg = get_cfg()
    tcfg.merge_from_file(yaml)
    tcfg.merge_from_list(opts)
    acfg = AnchorYoloConfig.from_cfg(tcfg)
    assert acfg.resnet == ResNetSpec()
    jmodel = jarch.build_yolov7p(jcfg)
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.float32)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = build_model(acfg, "cpu")
    load_into(tmodel, variables, functools.partial(
        twp.map_anchor_yolo_torch_name, backbone_type="resnet"))
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, :3] = [[4, 6, 40, 50], [20, 10, 60, 30], [30, 30, 50, 62]]
    valid = np.zeros((2, 8), bool)
    valid[0, :3] = valid[1, :2] = True
    batch = {"gt_boxes": boxes, "gt_classes": (valid * 2).astype(np.int32),
             "gt_valid": valid}

    def fwd(v):
        out, _ = jmodel.apply(v, jnp.asarray(images), train=True,
                              mutable=["batch_stats"])
        losses = jarch.anchor_yolo_loss_fn(
            out, {k: jnp.asarray(x) for k, x in batch.items()},
            np.asarray(acfg.anchors, np.float32), 4, variant="yolov7",
            build_target_type="default", iou_type="ciou", loss_type="v4",
            ignore_threshold=0.5)
        return out, losses

    jout, jlosses = jax.jit(fwd)(variables)
    tmodel.train()
    with torch.no_grad():
        out = tmodel(torch.from_numpy(images))
        losses = make_anchor_yolo_loss(acfg)(
            out, {k: torch.from_numpy(x) for k, x in batch.items()}, False)
    _close(out["outputs"], jout["outputs"], what="head outputs")
    assert float(losses["num_fg"]) == float(jlosses["num_fg"]) > 0
    for k in ("loss_box", "loss_obj", "loss_cls", "total_loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=FWD_TOL, err_msg=k)
    assert isinstance(tmodel.backbone, ResNet)
