"""The port's RoIAlign (``ops/roi_align.py``) and the fixed-order bilinear
backward it shares with the deformable convolution (``ops/fixed_order.py``)
against the JAX package, in float32 on the CPU.

* ``bilinear_sample`` (clamped to the border), ``roi_align`` at two scales
  and sampling ratios, ``multilevel_roi_align`` with boxes on every level
  (the JAX level rule, ROADMAP.md C.39) and boxes partly outside the map:
  forward, and the features' gradient against ``jax.vjp``;
* ``pool_proposals`` (Mask R-CNN's batched pooling from one buffer of the
  levels) against the JAX model's per-image ``multilevel_roi_align``;
* the GT-mask crop of the mask loss against the JAX per-proposal crop;
* Mask R-CNN's anchors of every RPN level (exact), its box deltas both
  ways (1e-6 of the max) and the sampled mode's subset draw on JAX's own
  uniforms (exact);
* the deformable convolution's sampling (``grid_sample_fixed_order``):
  the same forward as ``F.grid_sample``, its input and grid gradients
  against ``F.grid_sample``'s own autograd and against ``jax.vjp`` of the
  JAX DCN's taps; two backward passes bitwise equal, and a permutation of
  the samples' order moving the input gradient by rounding only.

Tolerances: forwards 1e-4 of the largest magnitude (the same float32
operations, but XLA contracts a sample's position ``x0 + t bw / s`` into
one fused multiply-add: at 2000 px a rounding moves it by 1e-4 px; the
pixel coordinate of ``grid_sample`` goes through its normalized one),
gradients 1e-4 of each tensor's largest magnitude (the
same products summed in another order: a border pixel takes every clamped
sample of the large boxes, hundreds of terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import jit_o0
from yolov7_d2_tpu.models.meta_arch import mask_rcnn as jm
from yolov7_d2_tpu.ops import deform_conv as jdcn
from yolov7_d2_tpu.ops import roi_align as jra
from yolov7_d2_tpu_torch.models.meta_arch import mask_rcnn as tm
from yolov7_d2_tpu_torch.ops import deform_conv as tdcn
from yolov7_d2_tpu_torch.ops import fixed_order
from yolov7_d2_tpu_torch.ops import roi_align as tra

TOL = 1e-4
GRAD_TOL = 1e-4
STRIDES = (4, 8, 16, 32)
LEVELS = ("p2", "p3", "p4", "p5")
IMG = 256


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _boxes(rng, n=24):
    """Boxes of sides 10-300 px, one on each level (the JAX rule: a side
    under 448 px is p2's, 448-895 p3's, 896-1791 p4's, p5 above; the
    samples clamp into the map), one partly outside, one degenerate."""
    side = np.exp(rng.uniform(np.log(10), np.log(300), (n, 2)))
    x0y0 = rng.uniform(-20, IMG - 30, (n, 2))
    boxes = np.concatenate([x0y0, x0y0 + side], -1).astype(np.float32)
    for i, s in enumerate((600.0, 1200.0, 2000.0)):
        boxes[i] = [-100.0 * i, 10.0, s - 100.0 * i, s + 10.0]
    boxes[3] = [-30, -10, 300, 100]
    boxes[4] = [100, 100, 100.5, 160]
    return boxes


def _feats(rng, c=3):
    return {k: rng.normal(0, 1, (IMG // s, IMG // s, c)).astype(np.float32)
            for k, s in zip(LEVELS, STRIDES)}


def _jit_vjp(fn, primal):
    """``jax.vjp(fn, primal)``, the forward and the pullback jitted (one
    compile each at XLA's optimization level 0, not an op-by-op one)."""
    want = jit_o0(fn)(primal)
    pull = jit_o0(lambda p, ct: jax.vjp(fn, p)[1](ct))
    return want, lambda ct: pull(primal, ct)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    feat = rng.normal(0, 1, (6, 7, 3)).astype(np.float32)
    ys = rng.uniform(-2, 8, (5, 4)).astype(np.float32)
    xs = rng.uniform(-2, 9, (5, 4)).astype(np.float32)
    ys[0, :2] = [5.0, 0.0]                            # on the border
    want = jra.bilinear_sample(*map(jnp.asarray, (feat, ys, xs)))
    got = tra.bilinear_sample(*map(torch.from_numpy, (feat, ys, xs)))
    _close(got.numpy(), want)


@pytest.mark.parametrize("scale,size,ratio", [(1.0, 7, 2), (0.25, 14, 2),
                                              (0.125, 5, 3)])
def test_roi_align_forward_and_vjp_match_jax(scale, size, ratio):
    """One map, boxes in image pixels at ``scale``: the pooled bins and
    the map's gradient of a random projection of them."""
    rng = np.random.default_rng(1)
    feat = rng.normal(0, 1, (int(IMG * scale), int(IMG * scale), 4)
                      ).astype(np.float32)
    boxes = _boxes(rng)
    want, vjp = _jit_vjp(lambda f: jra.roi_align(
        f, jnp.asarray(boxes), size, scale, ratio), jnp.asarray(feat))
    proj = rng.normal(0, 1, want.shape).astype(np.float32)
    tf = torch.from_numpy(feat).requires_grad_()
    got = tra.roi_align(tf, torch.from_numpy(boxes), size, scale, ratio)
    _close(got.detach().numpy(), want, what="pooled")
    (got * torch.from_numpy(proj)).sum().backward()
    _close(tf.grad.numpy(), vjp(jnp.asarray(proj))[0], GRAD_TOL, "grad")


def test_multilevel_roi_align_forward_and_vjp_match_jax():
    """Boxes on all four levels: the JAX function pools each from every
    level and keeps its own; the port samples its own level only."""
    rng = np.random.default_rng(2)
    feats = _feats(rng)
    boxes = _boxes(rng)
    levels = tra.box_levels(torch.from_numpy(boxes)).numpy()
    assert set(levels.tolist()) == {0, 1, 2, 3}, levels
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    want, vjp = _jit_vjp(lambda f: jra.multilevel_roi_align(
        f, jnp.asarray(boxes), 7), jfeats)
    proj = rng.normal(0, 1, want.shape).astype(np.float32)
    tf = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
    got = tra.multilevel_roi_align(tf, torch.from_numpy(boxes), 7)
    _close(got.detach().numpy(), want, what="pooled")
    (got * torch.from_numpy(proj)).sum().backward()
    jgrad = vjp(jnp.asarray(proj))[0]
    for k in LEVELS:
        _close(tf[k].grad.numpy(), jgrad[k], GRAD_TOL, k)
        assert float(tf[k].grad.abs().max()) > 0, k


def test_pool_proposals_match_jax_model_pooling():
    """Mask R-CNN's pooling of a batch (two images, their levels
    channels last, 7x7 and 14x14 from one buffer) against the JAX model's
    ``vmap`` of ``multilevel_roi_align``, and its gradient, bitwise the
    same on a second run."""
    rng = np.random.default_rng(3)
    feats = [_feats(rng, 5) for _ in range(2)]
    boxes = np.stack([_boxes(rng, 12) for _ in range(2)])
    levels = [torch.from_numpy(np.stack([f[k] for f in feats]))
              .requires_grad_() for k in LEVELS]
    grads = []
    for _ in range(2):
        for t in levels:
            t.grad = None
        pooled = tra.pool_proposals(levels, torch.from_numpy(boxes), (7, 14))
        (pooled[0].sum() + (pooled[1] ** 2).sum()).backward()
        grads.append([t.grad.clone() for t in levels])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    for size, got in zip((7, 14), pooled):
        want = jit_o0(jax.vmap(lambda fs, bx: jra.multilevel_roi_align(
            fs, bx, size, strides=STRIDES, level_names=LEVELS)))(
            {k: jnp.asarray(np.stack([f[k] for f in feats])) for k in LEVELS},
            jnp.asarray(boxes))
        _close(got.detach().numpy(), want, what=str(size))


def test_gt_mask_crops_match_jax():
    """``crop_gt_masks``: each proposal's matched uint8 mask cropped 28x28
    at its box, against the JAX loss's per-proposal ``roi_align``."""
    rng = np.random.default_rng(4)
    masks = (rng.random((2, 3, 64, 64)) > 0.5).astype(np.uint8)
    gt_index = rng.integers(0, 3, (2, 5))
    boxes = np.stack([_boxes(rng, 5) / 16 for _ in range(2)])
    got = tm.crop_gt_masks(*map(torch.from_numpy, (masks, gt_index, boxes)))
    for i in range(2):
        want = jit_o0(jax.vmap(lambda m, bx: jra.roi_align(
            m[..., None].astype(jnp.float32), bx[None], 28)[0, ..., 0]))(
            jnp.asarray(masks[i][gt_index[i]]), jnp.asarray(boxes[i]))
        _close(got[i].numpy(), want, what=f"image {i}")
        np.testing.assert_array_equal(got[i].numpy() > 0.5,
                                      np.asarray(want) > 0.5)


def _grid_inputs(rng, b=2, c=5, h=7, w=9, ho=6, wo=4):
    img = rng.normal(0, 1, (b, c, h, w)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (b, ho, wo, 2)).astype(np.float32)
    grid[0, 0, :2] = [[-1.0 - 1.0 / w, 0.0], [1.0 + 1.0 / w, 0.0]]
    return img, grid


def test_grid_sample_fixed_order_matches_autograd():
    """The forward is ``F.grid_sample``'s; the input gradient (the
    fixed-order sums) and the grid gradient against its own autograd, at
    points inside, on the border and outside (zero padding)."""
    rng = np.random.default_rng(5)
    img, grid = _grid_inputs(rng)
    gout = torch.from_numpy(rng.normal(0, 1, (2, 5, 6, 4)).astype(
        np.float32))
    outs, grads = [], []
    for fn in (fixed_order.grid_sample_fixed_order,
               lambda i, g: F.grid_sample(i, g, align_corners=False)):
        ti = torch.from_numpy(img).requires_grad_()
        tg = torch.from_numpy(grid).requires_grad_()
        out = fn(ti, tg)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * gout).sum(), (ti, tg)))
    assert torch.equal(outs[0], outs[1])
    _close(grads[0][0].numpy(), grads[1][0].numpy(), GRAD_TOL, "input")
    assert torch.equal(grads[0][1], grads[1][1])


def test_deform_taps_fixed_order_gradient_matches_jax_vjp():
    """The DCN taps (``deform_sample_taps``, sampling through
    :data:`ops.deform_conv.grid_sample`) at offsets of a few pixels: the
    input's gradient against ``jax.vjp`` of the JAX taps, and bitwise equal
    over two backward passes."""
    assert tdcn.grid_sample is fixed_order.grid_sample_fixed_order
    rng = np.random.default_rng(6)
    b, h, w, c = 2, 6, 8, 4
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = rng.normal(0, 2.5, (b, h, w, 18)).astype(np.float32)
    want, vjp = _jit_vjp(lambda v: jdcn.deform_sample_taps(
        v, jnp.asarray(off), 3, None), jnp.asarray(x))
    proj = rng.normal(0, 1, want.shape).astype(np.float32)
    jgrad = np.asarray(vjp(jnp.asarray(proj))[0])
    got = []
    for _ in range(2):
        tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()
                              ).requires_grad_()
        taps = tdcn.deform_sample_taps(
            tx, torch.from_numpy(off.transpose(0, 3, 1, 2).copy()), 3)
        flat = taps.permute(0, 3, 4, 2, 1).reshape(b, h, w, 9 * c)
        (flat * torch.from_numpy(proj)).sum().backward()
        got.append(tx.grad.permute(0, 2, 3, 1))
    assert torch.equal(got[0], got[1])
    _close(got[0].numpy(), jgrad, GRAD_TOL, "input")


def test_segment_sum_is_ordered():
    """Each key's rows are summed in their order: a permutation of the
    rows of one key moves the sum by rounding only, a repeat gives the same
    bits, and every key (an empty one too) gets its sum."""
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.normal(0, 1e3, (50, 3)).astype(np.float32))
    key = torch.from_numpy(rng.integers(0, 6, 50))
    key[key == 4] = 5                                   # key 4 empty
    a = fixed_order.segment_sum(rows, key, 7)
    b = fixed_order.segment_sum(rows, key, 7)
    assert torch.equal(a, b)
    want = np.zeros((7, 3))
    np.add.at(want, key.numpy(), rows.numpy().astype(np.float64))
    _close(a.numpy(), want, 1e-6)
    assert float(a[4].abs().max()) == 0.0 and float(a[6].abs().max()) == 0.0
    perm = torch.from_numpy(rng.permutation(50))
    _close(fixed_order.segment_sum(rows[perm], key[perm], 7).numpy(), want,
           1e-6)


# ---------------------------------------------------------------------------
# the R-CNN ops: anchors, box deltas, the sampled mode's subset draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", range(5))
def test_level_anchors_equal_jax(level):
    h = 128 // tm.RPN_STRIDES[level]
    np.testing.assert_array_equal(
        tm.level_anchors(h, h + 1, tm.RPN_STRIDES[level],
                         tm.ANCHOR_SIZES[level]),
        jm._level_anchors(h, h + 1, jm.RPN_STRIDES[level],
                          jm.ANCHOR_SIZES[level]))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     tm.ROI_DELTA_WEIGHTS])
def test_box_deltas_match_jax(weights):
    rng = np.random.default_rng(0)
    anchors = np.concatenate([rng.uniform(0, 50, (40, 2)),
                              rng.uniform(60, 120, (40, 2))],
                             -1).astype(np.float32)
    boxes = (anchors + rng.uniform(-5, 5, (40, 4))).astype(np.float32)
    boxes[0] = [10, 10, 10, 30]                     # a degenerate width
    deltas = rng.normal(0, 3, (40, 4)).astype(np.float32)  # dw past +-4
    _close(tm.encode_deltas(*map(torch.from_numpy, (anchors, boxes)),
                            weights).numpy(),
           jm.encode_deltas(jnp.asarray(anchors), jnp.asarray(boxes),
                            weights), 1e-6, "encode")
    _close(tm.decode_deltas(*map(torch.from_numpy, (anchors, deltas)),
                            weights).numpy(),
           jm.decode_deltas(jnp.asarray(anchors), jnp.asarray(deltas),
                            weights), 1e-6, "decode")


@pytest.mark.parametrize("n_take", [16, 64])
def test_random_subset_mask_matches_jax(n_take):
    """The subset draw on JAX's own uniforms: the same positions, 16 of 40
    eligible or all 40."""
    elig = np.zeros((2, 100), bool)
    elig[0, 10:50] = True
    elig[1, ::3] = True
    keys = jax.random.split(jax.random.PRNGKey(n_take), 2)
    want = np.stack([np.asarray(jm._random_subset_mask(
        jnp.asarray(e), jnp.int32(n_take), k)) for e, k in zip(elig, keys)])
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (100,)))
                                   for k in keys]))
    got = tm.random_subset_mask(torch.from_numpy(elig), n_take, u)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum(-1).tolist() == [min(n_take, 40), min(n_take, 34)]
