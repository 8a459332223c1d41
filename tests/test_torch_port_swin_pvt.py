"""The port's Swin and PVTv2 backbones against the JAX package, in float32
on the CPU at 64 px: window partition and reverse, the shift mask and the
relative position index exactly; single blocks; Swin-T, PVTv2-b0 and
PVTv2-b1 whole; the weight carrier both ways (JAX variables into the port
by ``jax_to_torch_state_dict``, and the port's own state dict, under the
reference's names, through the JAX package's ``port_swin_state_dict`` /
``port_torch_state_dict(map_pvt_v2_torch_name)``, which proves the
PatchMerging channel order).

Weights: flax variables drawn with numpy (``flax_variables_like``:
kernels at the flax init's scale, relative position bias tables N(0, 1),
random LayerNorm scales and biases). Each JAX model is jitted once a
process and its compiled function serves both directions of the carrier.

Tolerances: exact for the index and mask arithmetic; 1e-5 of the output's
largest magnitude for one block (one block's sums in another order); 1e-4
for a whole backbone (four stages of them; measured about 1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_variables_like, load_into
from yolov7_d2_tpu.models.backbones import pvt_v2 as jpvt
from yolov7_d2_tpu.models.backbones import swin as jswin
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.models.backbones import pvt_v2 as tpvt
from yolov7_d2_tpu_torch.models.backbones import swin as tswin
from yolov7_d2_tpu_torch.models.build import init_weights_
from yolov7_d2_tpu_torch.utils import weight_port as twp

SIZE = 64
BLOCK_TOL = 1e-5
MODEL_TOL = 1e-4


def _assert_close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (err, tol)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@functools.lru_cache(maxsize=None)
def _backbone(kind: str):
    """(jitted flax apply, variables, port model holding them, images
    [2, 64, 64, 3] float32 NHWC) of ``kind``: "swin" (tiny), "b0" or "b1"
    (PVTv2)."""
    rng = np.random.default_rng({"swin": 0, "b0": 1, "b1": 2}[kind])
    images = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    if kind == "swin":
        jmodel, tmodel = jswin.SwinTransformer(size="tiny"), \
            tswin.SwinTransformer("tiny")
        mapper = twp.map_swin_torch_name
    else:
        jmodel, tmodel = jpvt.PVTv2(variant=kind), tpvt.PVTv2(kind)
        mapper = twp.map_pvt_v2_torch_name
    variables = flax_variables_like(jmodel, images, rng)
    load_into(tmodel, variables, mapper)
    return jax.jit(jmodel.apply), variables, tmodel, images


@pytest.mark.parametrize("kind", ["swin", "b0", "b1"])
def test_backbone_matches_jax(kind):
    apply, variables, tmodel, images = _backbone(kind)
    want = apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got = tmodel(_nchw(images))
    assert sorted(got) == sorted(want) == ["stage1", "stage2", "stage3"]
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == (w.shape[0], w.shape[3], w.shape[1],
                                       w.shape[2])
        assert tmodel.out_channels[k] == w.shape[3]
        _assert_close(got[k].permute(0, 2, 3, 1).numpy(), w, MODEL_TOL)


def _randomize_(model: torch.nn.Module, seed: int):
    """The port's own weights: its init, then random LayerNorm scales,
    biases and bias tables, so that none is an identity."""
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 1.0, generator=gen)
            elif p.ndim == 1:
                p.copy_(torch.rand(p.shape, generator=gen)
                        + (0.5 if name.endswith("weight") else -0.5))
    return model.eval()


@pytest.mark.parametrize("kind", ["swin", "b1"])
def test_port_state_dict_through_jax_porter(kind):
    """A state dict with the reference's names (the port's own) through
    the JAX package's porter gives the JAX model the port's forward: the
    name maps, the bias tables and, for Swin, the PatchMerging order."""
    apply, variables, _, images = _backbone(kind)
    tmodel = _randomize_(tswin.SwinTransformer("tiny") if kind == "swin"
                         else tpvt.PVTv2(kind), seed=5)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    if kind == "swin":
        assert "layers.0.blocks.0.attn.relative_position_index" in sd
        ported, report = jwp.port_swin_state_dict(sd, variables)
    else:
        ported, report = jwp.port_torch_state_dict(
            sd, variables, name_mapper=jwp.map_pvt_v2_torch_name)
    assert not report["unused"], report["unused"][:5]
    want = apply(ported, jnp.asarray(images))
    with torch.no_grad():
        got = tmodel(_nchw(images))
    for k in want:
        _assert_close(got[k].permute(0, 2, 3, 1).numpy(), want[k], MODEL_TOL)
    # and back: the carrier gives the port's state dict again
    back = twp.jax_to_torch_state_dict(
        jax.tree.map(np.asarray, ported), tmodel.state_dict(),
        twp.map_swin_torch_name if kind == "swin"
        else twp.map_pvt_v2_torch_name)
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_merge_permutation_is_the_jax_one():
    np.testing.assert_array_equal(twp.swin_merge_perm(16),
                                  jwp._swin_merge_perm(16))
    perm = twp.swin_merge_perm(384)
    np.testing.assert_array_equal(perm[perm], np.arange(384))


def test_window_partition_and_reverse_exact():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 14, 21, 5)).astype(np.float32)
    want = jswin.window_partition(jnp.asarray(x), 7)
    got = tswin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tswin.window_reverse(got, 7, 14, 21)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jswin.window_reverse(want, 7, 14, 21)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("h,w,ws,shift", [(7, 7, 7, 3), (21, 14, 7, 3),
                                          (84, 84, 7, 3), (8, 12, 4, 2)])
def test_shift_mask_and_relative_index_exact(h, w, ws, shift):
    np.testing.assert_array_equal(
        tswin.shift_attn_mask(h, w, ws, shift),
        np.asarray(jswin.shift_attn_mask(h, w, ws, shift)))
    np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                  jswin.relative_position_index(ws))


@pytest.mark.parametrize("shift,side", [(3, 10), (0, 7)])
def test_swin_block_matches_jax(shift, side):
    """One block on a map that pads (10 -> 14) and shifts, and on one
    window; the flax names of a block are the torch ones but ``mlp``'s."""
    x = np.random.default_rng(5).normal(size=(2, side, side, 48)).astype(
        np.float32)
    jblock = jswin.SwinBlock(48, 3, 7, shift=shift)
    tblock = tswin.SwinBlock(48, 3, 7, shift=shift)
    rng = np.random.default_rng(6)
    variables = flax_variables_like(jblock, x, rng)
    rename = {"mlp.fc1": ("mlp1",), "mlp.fc2": ("mlp2",)}
    load_into(tblock, variables,
              lambda n: rename.get(n, tuple(n.split("."))))
    want = jax.jit(jblock.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tblock(torch.from_numpy(x))
    _assert_close(got.numpy(), want, BLOCK_TOL)


@pytest.mark.parametrize("sr", [2, 1])
def test_pvt_block_matches_jax(sr):
    h = w = 8
    x = np.random.default_rng(7).normal(size=(2, h * w, 40)).astype(
        np.float32)
    jblock = jpvt.PVT2Block(40, 2, sr, 4)
    tblock = tpvt.PVT2Block(40, 2, sr, 4)
    rng = np.random.default_rng(8)
    shapes = jax.eval_shape(
        lambda v: jblock.init(jax.random.PRNGKey(0), v, h, w),
        jnp.zeros(x.shape, jnp.float32))

    def draw(path, leaf):
        p = str(getattr(path[-1], "key", path[-1]))
        if p == "kernel":
            fan = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan ** -0.5, leaf.shape).astype(np.float32)
        if p == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.3, leaf.shape).astype(np.float32)

    variables = {"params": jax.tree_util.tree_map_with_path(
        draw, shapes["params"])}
    names = {"mlp": "ffn", "attn.norm": "attn.sr_norm",
             "mlp.dwconv.dwconv": "ffn.dwconv"}

    def mapper(n):
        for a, b in sorted(names.items(), key=lambda kv: -len(kv[0])):
            if n.startswith(a):
                n = b + n[len(a):]
                break
        return tuple(n.split("."))

    load_into(tblock, variables, mapper)
    want = jax.jit(lambda v, t: jblock.apply(v, t, h, w))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tblock(torch.from_numpy(x), h, w)
    _assert_close(got.numpy(), want, BLOCK_TOL)


def test_same_padding_of_the_strided_convolutions():
    """flax ``SAME`` at kernel = stride pads only a side that is not a
    multiple (low half, then the rest): Swin's patch embedding and PVTv2's
    reduction convolution at 4 and 8 on 66 x 70 px, against flax."""
    from flax import linen as nn

    from yolov7_d2_tpu_torch.models.layers.blocks import pad_same

    x = np.random.default_rng(9).normal(size=(1, 66, 70, 3)).astype(
        np.float32)
    for k in (4, 8):
        conv = nn.Conv(5, (k, k), (k, k))
        variables = conv.init(jax.random.PRNGKey(k), jnp.asarray(x))
        kernel = np.asarray(variables["params"]["kernel"])
        want = conv.apply(variables, jnp.asarray(x))
        tconv = torch.nn.Conv2d(3, 5, k, k)
        with torch.no_grad():
            tconv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
            tconv.bias.zero_()
            got = tconv(pad_same(_nchw(x), k, k))
        _assert_close(got.permute(0, 2, 3, 1).numpy(), want, BLOCK_TOL)


def test_layer_norm_eps():
    """Swin's LayerNorms take 1e-5, PVTv2's flax's 1e-6 everywhere."""
    swin = tswin.SwinTransformer("tiny")
    pvt = tpvt.PVTv2("b0")
    lns = [m for m in swin.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert lns and all(m.eps == 1e-5 for m in lns)
    lns = [m for m in pvt.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(lns) == 4 + 8 * 2 + 3 * 2 + 4 and all(m.eps == 1e-6 for m in lns)
