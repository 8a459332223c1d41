"""The port's YOLOX-KPTS against the JAX package, in float32 on the CPU at
64 px and width 0.25: the forward on each backbone (Swin, PVTv2-b1,
CSPDarknet-X), the keypoint decode, every loss term, the parameter
gradients of a train-mode step, and the serving tail index for index
(keypoints included, ties across the pre-NMS cut).

Swin runs at two blocks a stage here (``SWIN_SPECS["tiny"]`` patched in
both packages for this module): its XLA compile is the cost of the file,
and the full Swin-T is held in ``tests/test_torch_port_swin_pvt.py``. The
builders at full size, the feed and the eval are in
``tests/test_torch_port_kpts_feed.py``.

Weights: flax variables drawn with numpy (``flax_variables_like``), moved
into the port by ``jax_to_torch_state_dict`` through
``map_yolox_kpts_torch_name``. Each JAX function is compiled once.

Tolerances, each with its reason:

* forward: 1e-4 of each output's largest magnitude (XLA-CPU and oneDNN
  sum each convolution in another order; measured about 1e-6);
* decode: float32 rounding of the same two operations;
* loss terms on the same head outputs: 1e-5 relative;
* a train-mode step: loss terms 1e-4 relative (the forward's), each
  parameter's gradient within 1e-4 of the larger of its norm and 1e-2 of
  the whole gradient's (the output norms' biases feed train-mode
  BatchNorm, which removes a per-channel constant: their gradient is 0
  but for float32 noise); the port runs NCHW (ROADMAP.md C.20);
* the tail: the kept anchors and classes exact, boxes, scores and
  keypoints to float32 rounding (XLA fuses the decode and the sigmoid).
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
    numpy_variables,
    tied_kpts_head,
)
from yolov7_d2_tpu.models.backbones import swin as jswin
from yolov7_d2_tpu.models.meta_arch import yolox_kpts as jk
from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
from yolov7_d2_tpu_torch.models.backbones import swin as tswin
from yolov7_d2_tpu_torch.models.meta_arch import yolox_kpts as tk
from yolov7_d2_tpu_torch.utils.weight_port import (
    jax_to_torch_state_dict,
    map_yolox_kpts_torch_name,
)

SIZE = 64
WIDTH = 0.25
FWD_TOL = 1e-4
BACKBONES = ("swin", "pvt_v2", "cspdarknetx")
REDUCED_SWIN = ((2, 2, 2, 2), 96, (3, 6, 12, 24))


@pytest.fixture(scope="module", autouse=True)
def reduced_swin():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jswin.SWIN_SPECS, "tiny", REDUCED_SWIN)
        mp.setitem(tswin.SWIN_SPECS, "tiny", REDUCED_SWIN)
        yield


def _assert_close(got, want, tol=FWD_TOL):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (err, tol)


@functools.lru_cache(maxsize=None)
def _pair(backbone: str):
    """(flax model, variables, port model holding them, uint8 images [2,
    64, 64, 3], name map, jitted eval apply)."""
    rng = np.random.default_rng(BACKBONES.index(backbone))
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    kw = dict(width_mul=WIDTH, depth_mul=0.33, backbone_type=backbone)
    jmodel, tmodel = jk.YOLOXKPTS(**kw), tk.YOLOXKPTS(**kw)
    variables = flax_variables_like(jmodel, images, rng)
    mapper = functools.partial(map_yolox_kpts_torch_name,
                               backbone_type=backbone)
    load_into(tmodel, variables, mapper)
    return jmodel, variables, tmodel, images, mapper, jax.jit(jmodel.apply)


@functools.lru_cache(maxsize=None)
def _jax_out(backbone: str):
    _, variables, _, images, _, apply = _pair(backbone)
    out = apply(variables, jnp.asarray(images, jnp.float32))
    return {k: np.asarray(v) for k, v in out.items()}


def kpt_gts(rng, counts=(3, 4), g=5, p=17):
    """Boxes, one class, validity and keypoints [2, g, p, 3] of persons in
    a 64 px frame: visible (v 2), occluded (v 1) and unlabelled keypoints
    (0, 0, 0); image 0's gt 0 carries the C.23 case, a keypoint at (64,
    0) with v 0 (an unlabelled one after the mapper's flip)."""
    b = len(counts)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    kp = np.zeros((b, g, p, 3), np.float32)
    for i, n in enumerate(counts):
        xy = rng.uniform(0, SIZE * 0.5, (n, 2))
        wh = rng.uniform(10, SIZE * 0.5, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + wh], -1)
        valid[i, :n] = True
        pts = xy[:, None] + rng.uniform(0, 1, (n, p, 2)) * wh[:, None]
        vis = rng.integers(0, 3, (n, p)).astype(np.float32)
        kp[i, :n, :, :2] = np.where(vis[..., None] > 0, pts, 0.0)
        kp[i, :n, :, 2] = vis
    kp[0, 0, 3] = [SIZE, 0.0, 0.0]
    return {"gt_boxes": boxes, "gt_classes": np.zeros((b, g), np.int32),
            "gt_valid": valid, "gt_keypoints": kp}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_forward_matches_jax(backbone):
    _, _, tmodel, images, _, _ = _pair(backbone)
    want = _jax_out(backbone)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    a = (SIZE // 8) ** 2 + (SIZE // 16) ** 2 + (SIZE // 32) ** 2
    assert tuple(got["outputs"].shape) == (2, a, 6)
    assert tuple(got["kpts"].shape) == (2, a, 17, 3)
    for key in ("grids", "strides"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    for key in ("outputs", "kpts"):
        assert got[key].dtype == torch.float32
        _assert_close(got[key].numpy(), want[key])


def test_decode_kpts_matches_jax():
    out = _jax_out("pvt_v2")
    want = jk.decode_kpts(jnp.asarray(out["kpts"]), jnp.asarray(out["grids"]),
                          jnp.asarray(out["strides"]))
    got = tk.decode_kpts(torch.from_numpy(out["kpts"]),
                         torch.from_numpy(out["grids"]),
                         torch.from_numpy(out["strides"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=0)
    # the visibility logit is scaled by the stride too
    np.testing.assert_array_equal(
        got[..., 2].numpy(), out["kpts"][..., 2] * out["strides"][:, None])


@functools.lru_cache(maxsize=None)
def _jax_losses_fn():
    return jax.jit(lambda out, batch: jk.yolox_kpts_losses(out, batch))


@pytest.mark.parametrize("backbone", ["swin", "cspdarknetx"])
def test_losses_match_jax(backbone):
    out = _jax_out(backbone)
    batch = kpt_gts(np.random.default_rng(11))
    want = _jax_losses_fn()(out, batch)
    got = tk.yolox_kpts_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(want["num_fg"]) >= 2
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_flipped_unlabelled_keypoint_counts_as_visible():
    """ROADMAP.md C.23, reproduced: the loss's visibility proxy is x != 0,
    so an unlabelled keypoint that the flip moved to (w, 0) with v 0
    enters the OKS and visibility terms as visible, in both packages; at
    (0, 0, 0) it does not."""
    out = _jax_out("swin")
    flipped = kpt_gts(np.random.default_rng(11))
    zeroed = {k: v.copy() for k, v in flipped.items()}
    zeroed["gt_keypoints"][0, 0, 3] = 0.0
    tout = {k: torch.from_numpy(v) for k, v in out.items()}
    got = {}
    for name, batch in (("flipped", flipped), ("zeroed", zeroed)):
        want = _jax_losses_fn()(out, batch)
        t = tk.yolox_kpts_losses(tout, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        for k in ("loss_kpt", "loss_kpt_vis"):
            np.testing.assert_allclose(float(t[k]), float(want[k]),
                                       rtol=1e-5, err_msg=(name, k))
        got[name] = t
    # the keypoint's gt is matched (gt 0 of image 0 has fg anchors), so the
    # visibility term sees a target of 1 where v is 0
    assert float(got["flipped"]["loss_kpt_vis"]) != float(
        got["zeroed"]["loss_kpt_vis"])


def test_gradients_match_jax(monkeypatch):
    jmodel, variables, tmodel, images, mapper, _ = _pair("swin")
    batch = kpt_gts(np.random.default_rng(12))

    def loss_fn(params, stats, x, b):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
        losses = jk.yolox_kpts_losses(out, b)
        return losses["total_loss"], losses

    (_, jlosses), jgrads = jit_o0(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"],
        jnp.asarray(images, jnp.float32), batch)
    # the port in NCHW (ROADMAP.md C.20)
    plain = tk.normalize_images
    monkeypatch.setattr(tk, "normalize_images",
                        lambda *a: plain(*a).contiguous())
    tmodel.train()
    tmodel.zero_grad()
    try:
        losses = tk.yolox_kpts_losses(
            tmodel(torch.from_numpy(images)),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        losses["total_loss"].backward()
    finally:
        tmodel.eval()
        load_into(tmodel, variables, mapper)  # train mode moved BN stats
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=1e-4, err_msg=k)
    assert float(losses["loss_kpt"].detach()) > 0
    grads = jax_to_torch_state_dict(
        numpy_variables({"params": jgrads,
                         "batch_stats": variables["batch_stats"]}),
        tmodel.state_dict(), mapper)
    names = [n for n, _ in tmodel.named_parameters()]
    whole = float(np.sqrt(sum(np.sum(np.square(grads[n], dtype=np.float64))
                              for n in names)))
    for name, p in tmodel.named_parameters():
        want_g = grads[name]
        err = float(np.abs(p.grad.numpy() - want_g).max())
        floor = max(float(np.linalg.norm(want_g)), 1e-2 * whole)
        assert err <= 1e-4 * floor, (name, err, floor)
    table = "backbone.layers.0.blocks.1.attn.relative_position_bias_table"
    assert float(tmodel.get_parameter(table).grad.abs().max()) > 0


@pytest.mark.parametrize("case", ["model", "ties"])
def test_tail_matches_jax_index_for_index(case):
    head = (_jax_out("swin") if case == "model"
            else tied_kpts_head(np.random.default_rng(13)))
    conf = 0.001 if case == "model" else 0.01
    want = jax.jit(functools.partial(jk.yolox_kpts_postprocess,
                                     conf_threshold=conf))(head)
    th = {k: torch.from_numpy(v) for k, v in head.items()}
    got = tk.yolox_kpts_postprocess(th, conf_threshold=conf)
    plain = tk.yolox_kpts_postprocess(th, conf_threshold=conf,
                                      nms=nms_batched_plain)
    assert int(got.valid.sum()) > 10
    for f in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores", "keypoints"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=f)
        assert torch.equal(getattr(got, f), getattr(plain, f))
    kp = got.keypoints[got.valid]
    assert float(kp[..., 2].min()) >= 0 and float(kp[..., 2].max()) <= 1
