"""The port's deformable convolution (``ops/deform_conv.py``), ResNet's DCN
bottleneck and SparseInst on the R-50-DCN configurations against the JAX
package, in float32 on the CPU.

* ``bilinear_sample`` at points that cross cells and leave the image;
  ``deform_sample_taps`` (v2 and v1) and ``DeformConv``, forward and
  gradients, with the offset convolution's weights drawn non-zero
  (offsets of a few pixels, modulation away from 0.5);
* the weight carrier: the fuse weight ``[O, C, 3, 3]`` <-> the JAX
  ``[1, 1, 9 C, O]`` tap-major kernel, against the JAX
  ``port_dla_state_dict``;
* the DCN bottleneck of the plain ResNet (stride on the 3x3), forward and
  gradients; a strided 3x3 stays plain, as in the JAX ResNet;
* SparseInst with DCN on the vd ResNet (1, 1, 2, 2 bottlenecks in both
  packages, narrow encoder and decoder, 64 px): outputs and loss terms,
  and one ``build_system`` step against the JAX step's loss and gradient
  (one JAX compile for both);
* the three DCN yamls: ``SparseInstConfig`` reads DCN as the JAX builder
  does, and every parameter and BN statistic of the full model lands on
  a leaf of the JAX model's init (``jax.eval_shape``), with the same
  counts.

Tolerances: outputs 1e-4 of each tensor's largest magnitude (the sampling
goes through ``F.grid_sample``'s normalized coordinates, which moves a
sample by about 1e-6 px, and XLA-CPU and oneDNN sum convolutions in
another order); gradients 1e-4 of each tensor's norm; loss terms 1e-4
relative; the gradient norm of a step 1e-3 relative; the carrier exact.
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
from yolov7_d2_tpu.models.backbones import resnet as jresnet
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import sparseinst as jsi
from yolov7_d2_tpu.ops import deform_conv as jdcn
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config import SparseInstConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones import resnet as tresnet
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as tsi
from yolov7_d2_tpu_torch.ops import deform_conv as tdcn
from yolov7_d2_tpu_torch.utils import weight_port as twp

TOL = 1e-4
SIZE = 64
SI_DIR = REPO / "configs" / "coco" / "sparseinst"
DCN_YAMLS = ("sparse_inst_r50_dcn_giam_aug.yaml",
             "sparse_inst_r50vd_dcn_giam.yaml",
             "sparse_inst_r50vd_dcn_giam_aug.yaml")


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _grad_close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(float(np.linalg.norm(want)), 1e-8), (what, err)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


def _offsets_a_few_pixels(variables, rng, scale=2.5):
    """Every ``offset_conv`` kernel redrawn N(0, scale / fan_in), its bias
    N(0, 1): offsets of a few pixels, modulation logits spread around 0."""
    def draw(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        if "offset_conv" not in keys:
            return leaf
        if keys[-1] == "kernel":
            fan = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, scale * fan ** -0.5, leaf.shape).astype(
                np.float32)
        return rng.normal(0.0, 1.0, leaf.shape).astype(np.float32)

    return dict(variables, params=jax.tree_util.tree_map_with_path(
        draw, variables["params"]))


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def test_bilinear_sample_matches_jax():
    """Points inside, across cell borders, on the edge rows and columns,
    partly and wholly outside the image (each corner outside counts
    zero)."""
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (2, 6, 7, 3)).astype(np.float32)
    x = rng.uniform(-2.5, 8.5, (2, 5, 4)).astype(np.float32)
    y = rng.uniform(-2.5, 7.5, (2, 5, 4)).astype(np.float32)
    x[0, 0] = [-0.5, 6.0, 6.5, 0.0]
    y[0, 0] = [2.0, 5.0, -0.75, 5.5]
    want = np.asarray(jdcn.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                           jnp.asarray(y)))
    got = tdcn.bilinear_sample(_nchw(img), torch.from_numpy(x),
                               torch.from_numpy(y))
    _close(got.permute(0, 2, 3, 1).numpy(), want)
    assert float(np.abs(want[0, 0, 2]).max()) > 0       # half outside
    assert np.any(want == 0.0)                          # wholly outside


@pytest.mark.parametrize("modulated", [True, False])
def test_deform_sample_taps_forward_and_gradients(modulated):
    """The K*K taps of a 3x3 at offsets N(0, 2.5) px with logits N(0, 1):
    the taps, and the gradients of a random projection of them with
    respect to the input, the offsets and the logits."""
    rng = np.random.default_rng(1)
    b, h, w, c = 2, 7, 9, 5
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = rng.normal(0, 2.5, (b, h, w, 18)).astype(np.float32)
    mod = rng.normal(0, 1, (b, h, w, 9)).astype(np.float32)
    proj = rng.normal(0, 1, (b, h, w, 9 * c)).astype(np.float32)

    def jfn(x, off, mod):
        taps = jdcn.deform_sample_taps(x, off, 3, mod if modulated else None)
        return jnp.sum(taps * proj), taps

    (_, want), jg = jit_o0(jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                               has_aux=True))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mod))
    tx, toff, tmod = (_nchw(a).requires_grad_() for a in (x, off, mod))
    taps = tdcn.deform_sample_taps(tx, toff, 3, tmod if modulated else None)
    # [B, C, 9, H, W] -> the JAX layout [B, H, W, 9 C], tap-major
    flat = taps.permute(0, 3, 4, 2, 1).reshape(b, h, w, 9 * c)
    _close(flat.detach().numpy(), want)
    (flat * torch.from_numpy(proj)).sum().backward()
    for what, t, g in (("x", tx, jg[0]), ("offsets", toff, jg[1]),
                       ("modulation", tmod, jg[2])):
        if what == "modulation" and not modulated:
            assert t.grad is None
            continue
        _grad_close(t.grad.permute(0, 2, 3, 1).numpy(), g, what)


def _dcn_map(name):
    """``dcn`` (the fuse) -> the flax ``weight``; ``dcn.offset_conv``."""
    return ("weight",) if name == "dcn" else tuple(name.split(".")[1:])


def test_deform_conv_module_forward_and_gradients():
    """``DeformConv`` against the JAX module, the offset convolution drawn
    non-zero: the output and every parameter's and the input's
    gradient."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 8, 10, 6)).astype(np.float32)
    jm = jdcn.DeformConv(features=4)
    variables = flax_variables_like(jm, x, rng)
    variables = _offsets_a_few_pixels(variables, rng)
    tm = torch.nn.Module()
    tm.dcn = tdcn.DeformConv(6, 4)
    load_into(tm, variables, _dcn_map)
    with torch.no_grad():
        raw = tm.dcn.offset_conv(_nchw(x)).numpy()
    assert 1.0 < float(np.abs(raw[:, :18]).mean()) < 6.0
    assert float(np.abs(1 / (1 + np.exp(-raw[:, 18:])) - 0.5).mean()) > 0.1

    def jfn(params, x):
        out = jm.apply({"params": params}, x)
        return jnp.sum(out * out), out

    (_, want), (jgp, jgx) = jit_o0(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(variables["params"],
                                            jnp.asarray(x))
    tx = _nchw(x).requires_grad_()
    out = tm.dcn(tx)
    _close(out.detach().permute(0, 2, 3, 1).numpy(), want)
    (out * out).sum().backward()
    _grad_close(tx.grad.permute(0, 2, 3, 1).numpy(), jgx, "input")
    grads = twp.jax_to_torch_state_dict(
        numpy_variables({"params": jgp}), tm.state_dict(), _dcn_map)
    for name, p in tm.named_parameters():
        _grad_close(p.grad.numpy(), grads[name], name)


def test_dcn_weight_carrier_matches_the_jax_porter():
    """The fuse weight [O, C, 3, 3] -> [1, 1, 9 C, O] as the JAX
    ``port_dla_state_dict`` pours a reference DCN into flax, and back."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, (5, 4, 3, 3)).astype(np.float32)
    b = rng.normal(0, 1, (5,)).astype(np.float32)
    zero = {"params": {"dla_up": {"ida_0": {"proj_1": {"dcn": {"weight": {
        "kernel": np.zeros((1, 1, 36, 5), np.float32),
        "bias": np.zeros((5,), np.float32)}}}}}}}
    ported, report = jwp.port_dla_state_dict(
        {"dla_up.ida_0.proj_1.conv.weight": w,
         "dla_up.ida_0.proj_1.conv.bias": b}, zero)
    assert not report["unused"]
    kernel = ported["params"]["dla_up"]["ida_0"]["proj_1"]["dcn"]["weight"][
        "kernel"]
    np.testing.assert_array_equal(twp.dcn_weight_to_flax(w), kernel)
    np.testing.assert_array_equal(twp.dcn_weight_from_flax(kernel, 3), w)


# ---------------------------------------------------------------------------
# the ResNet bottleneck
# ---------------------------------------------------------------------------

def _block_map(name):
    return twp.map_resnet_torch_name(f"backbone.res4.1.{name}")[2:]


def test_dcn_bottleneck_forward_and_gradients():
    """A DCN bottleneck of the plain ResNet (stride 1, the projection
    shortcut, FrozenBN, the stride on the 3x3) against the JAX block:
    output, input gradient and every parameter's gradient (the vd
    ResNet's DCN blocks train in SparseInst's ``build_system`` step
    below); the strided first block of a DCN stage keeps its plain 3x3 in
    both packages."""
    vd = False
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    jm = jresnet.Bottleneck(32, stride=1, vd=vd, stride_in_1x1=False,
                            deform=True)
    variables = _offsets_a_few_pixels(flax_variables_like(jm, x, rng), rng)
    tm = tresnet.Bottleneck(16, 32, stride=1, vd=vd, stride_in_1x1=False,
                            deform=True)
    load_into(tm, variables, _block_map)

    def jfn(params, x):
        out = jm.apply({"params": params,
                        "batch_stats": variables["batch_stats"]}, x)
        return jnp.sum(out * out), out

    (_, want), (jgp, jgx) = jit_o0(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(variables["params"],
                                            jnp.asarray(x))
    tx = _nchw(x).requires_grad_()
    out = tm(tx)
    _close(out.detach().permute(0, 2, 3, 1).numpy(), want)
    (out * out).sum().backward()
    _grad_close(tx.grad.permute(0, 2, 3, 1).numpy(), jgx, "input")
    grads = twp.jax_to_torch_state_dict(
        numpy_variables({"params": jgp,
                         "batch_stats": variables["batch_stats"]}),
        tm.state_dict(), _block_map)
    for name, p in tm.named_parameters():
        _grad_close(p.grad.numpy(), grads[name], name)
    strided = tresnet.Bottleneck(16, 32, stride=2, stride_in_1x1=False,
                                 deform=True)
    assert hasattr(strided, "conv2") and not hasattr(strided, "conv2_dcn")
    jshapes = jax.eval_shape(
        lambda a: jresnet.Bottleneck(32, stride=2, stride_in_1x1=False,
                                     deform=True).init(
            jax.random.PRNGKey(0), a), jnp.zeros((1, 8, 8, 16)))
    assert "conv2" in jshapes["params"] and \
        "conv2_dcn" not in jshapes["params"]


# ---------------------------------------------------------------------------
# SparseInst with DCN
# ---------------------------------------------------------------------------

SI_DIMS = dict(num_classes=3, num_masks=10, kernel_dim=16, groups=1,
               encoder_channels=32)
# a ResNet cut to one block in res2 and res3 and two in res4 and res5 (a
# strided plain block and a DCN one), in both packages: the JAX compiles
# cost the file's time
CUT_DEPTH, CUT_BLOCKS = 10, (1, 1, 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _cut_resnet():
    with pytest.MonkeyPatch.context() as mp:
        for blocks in (jresnet.STAGE_BLOCKS, tresnet.STAGE_BLOCKS):
            mp.setitem(blocks, CUT_DEPTH, CUT_BLOCKS)
        yield


@functools.lru_cache(maxsize=None)
def _si_pair(vd: bool):
    """(flax SparseInst-DCN, variables, port model, images), the cut
    ResNet with DCN in res4 and res5, the stride on the 3x3."""
    rng = np.random.default_rng(10 + vd)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = jsi.SparseInst(resnet_depth=CUT_DEPTH, resnet_vd=vd,
                        resnet_dcn=True,
                        resnet_stride_in_1x1=False, **SI_DIMS)
    variables = _offsets_a_few_pixels(flax_variables_like(jm, images, rng),
                                      rng)
    tm = tsi.SparseInst(resnet=tresnet.ResNetSpec(
        depth=CUT_DEPTH, vd=vd, stride_in_1x1=False,
        deform_on_per_stage=(False, False, True, True)), **SI_DIMS)
    load_into(tm, variables, functools.partial(
        twp.map_sparseinst_torch_name, vd=vd))
    return jm, variables, tm, images


def _si_gt(rng, b=2, g=6, counts=(4, 6)):
    masks = np.zeros((b, g, SIZE, SIZE), np.uint8)
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(counts):
        for j in range(n):
            y0, x0 = rng.integers(0, SIZE - 20, 2)
            h, w = rng.integers(6, 20, 2)
            masks[i, j, y0:y0 + h, x0:x0 + w] = 1
        cls[i, :n] = rng.integers(0, 3, n)
        valid[i, :n] = True
    return masks, cls, valid


@functools.lru_cache(maxsize=None)
def _si_reference():
    """The vd pair's gts and the JAX outputs, losses and parameter
    gradients of one compile: ``sparseinst_losses`` as the JAX
    ``build_system`` wires it (3 classes, the default weights)."""
    jm, variables, _, images = _si_pair(True)
    masks, cls, valid = _si_gt(np.random.default_rng(21))

    @jit_o0
    def jfn(params, x, masks, cls, valid):
        def total(params):
            out = jm.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=True)
            losses = jsi.sparseinst_losses(out, masks, cls, valid, 3)
            return losses["total_loss"], (out, losses)

        (_, aux), grads = jax.value_and_grad(total, has_aux=True)(params)
        return aux, grads

    (out, losses), grads = jfn(variables["params"], jnp.asarray(images),
                               jnp.asarray(masks), jnp.asarray(cls),
                               jnp.asarray(valid))
    return (masks, cls, valid), out, losses, grads


def test_sparseinst_dcn_forward_and_losses_match_jax():
    """SparseInst on the vd ResNet with DCN (FrozenBN, no dropout: the JAX
    train-mode outputs of :func:`_si_reference`'s compile are the eval
    ones): the outputs of the uint8 path and the loss terms."""
    _, _, tm, images = _si_pair(True)
    (masks, cls, valid), want, jlosses, _ = _si_reference()
    dcn = [m for m in tm.modules() if isinstance(m, tdcn.DeformConv)]
    assert len(dcn) == 2  # block 1 of res4 and res5 (block 0 strides)
    with torch.no_grad():
        got = tm(torch.from_numpy(images.astype(np.uint8)))
        losses = tsi.sparseinst_losses(got, torch.from_numpy(masks),
                                       torch.from_numpy(cls),
                                       torch.from_numpy(valid), 3)
    for k in ("cls_logits", "obj_logits", "mask_logits"):
        _close(got[k], want[k], what=k)
    for k in ("loss_ce", "loss_dice", "loss_mask", "loss_objectness",
              "num_inst", "total_loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=TOL, err_msg=k)


def _yaml_cfg(fn, yaml, **opts):
    cfg = fn()
    cfg.merge_from_file(str(SI_DIR / yaml))
    for k, v in opts.items():
        cfg.merge_from_list([k, repr(v)])
    return cfg


def _jax_model(yaml):
    """The JAX model of ``yaml`` (flax modules are frozen dataclasses: the
    two vd yamls give equal ones)."""
    return jax_build_model(_yaml_cfg(jax_get_cfg, yaml))


@pytest.mark.parametrize("yaml", DCN_YAMLS)
def test_dcn_yaml_config_and_leaves_match_jax(yaml, monkeypatch):
    """``SparseInstConfig`` reads DCN as the JAX builder does (any stage on
    -> res4 and res5, the vd ResNet too; a stage list with res3 on gives
    the same); every key of the full model at the yaml's width and depth
    takes a leaf of the JAX model's init, the same counts."""
    cfg = _yaml_cfg(get_cfg, yaml)
    scfg = SparseInstConfig.from_cfg(cfg)
    assert scfg.resnet.deform_on_per_stage == (False, False, True, True)
    assert scfg.groups == 4
    assert scfg.resnet.vd == ("vd" in yaml)
    assert not scfg.resnet.stride_in_1x1
    odd = SparseInstConfig.from_cfg(_yaml_cfg(
        get_cfg, yaml, **{"MODEL.RESNETS.DEFORM_ON_PER_STAGE":
                          [False, True, False, False]}))
    assert odd.resnet.deform_on_per_stage == (False, False, True, True)
    monkeypatch.setattr(tsi, "init_weights_", lambda *a: None)
    model = build_model(scfg, "cpu")
    count = assert_leaves_match_jax(
        model, _jax_model(yaml),
        functools.partial(twp.map_sparseinst_torch_name, vd=scfg.resnet.vd),
        size=32)
    n_dcn = sum(isinstance(m, tdcn.DeformConv) for m in model.modules())
    assert n_dcn == 5 + 2 and count["params"] > 3e7


def test_sparseinst_dcn_build_system_step_matches_jax(monkeypatch):
    """One step of the port's ``build_system`` on
    ``sparse_inst_r50vd_dcn_giam.yaml`` (AdamW, float32, 64 px) against
    the JAX ``build_system``'s: both build the cut vd pair of
    :func:`_si_pair` (a fresh port model holding its weights) in place of
    the full-size model and give the same batch fields; every loss term of
    the step and its gradient norm against the loss and gradient of the
    JAX step's computation (:func:`_si_reference`)."""
    jm, init, _, images = _si_pair(True)
    gts, _, jlosses, jgrads = _si_reference()
    tm = load_into(tsi.SparseInst(resnet=tresnet.ResNetSpec(
        depth=CUT_DEPTH, vd=True, stride_in_1x1=False,
        deform_on_per_stage=(False, False, True, True)), **SI_DIMS), init,
        functools.partial(twp.map_sparseinst_torch_name, vd=True))
    opts = {"SOLVER.AMP.ENABLED": False, "INPUT.INPUT_SIZE": [SIZE, SIZE],
            "MODEL.SPARSE_INST.DECODER.NUM_CLASSES": 3,
            "SOLVER.WARMUP_ITERS": 0}
    jcfg = _yaml_cfg(jax_get_cfg, DCN_YAMLS[1], **opts)
    cfg = _yaml_cfg(get_cfg, DCN_YAMLS[1], **opts)
    monkeypatch.setattr(jax_engine, "build_model", lambda c: jm)
    make_state = jax_engine._make_state
    monkeypatch.setattr(
        jax_engine, "_make_state", lambda model, *a: make_state(
            types.SimpleNamespace(init=lambda *_, **__: init), *a))
    monkeypatch.setattr(engine, "build_model", lambda c, device, seed: tm)
    _, _, _, jfields = jax_engine.build_system(jcfg, jax.random.PRNGKey(0), 2)
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    assert fields == jfields and model is tm
    plain = tsi.normalize_images_plain
    monkeypatch.setattr(tsi, "normalize_images_plain",
                        lambda *a: plain(*a).contiguous())
    batch = dict(zip(fields, (images,) + gts))
    before = [p.detach().clone() for p in model.parameters()]
    state, tm_ = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    for k in ("loss_ce", "loss_dice", "loss_mask", "loss_objectness",
              "total_loss", "num_inst"):
        np.testing.assert_allclose(float(tm_[k]), float(jlosses[k]),
                                   rtol=TOL, err_msg=k)
    np.testing.assert_allclose(
        float(tm_["grad_norm"]),
        float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                          for g in jax.tree_util.tree_leaves(jgrads)))),
        rtol=1e-3)
    moved = [not torch.equal(a, b.detach())
             for a, b in zip(before, model.parameters())]
    assert sum(moved) > 0.9 * len(moved)
