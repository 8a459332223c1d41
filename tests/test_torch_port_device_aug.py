"""The port's device geometry feed (``data/device_aug.DeviceAug``,
``make_device_aug_step``, ``mappers.TileDatasetMapper``, ``train_det``
with ``INPUT.MOSAIC_AND_MIXUP.DEVICE``) against the JAX package, on the
CPU at small shapes: 4 tiles of 64 px, one of them letterboxed with gray
pad, outputs at 64 px.

Both packages get the same draws: the port draws them with its
``torch.Generator`` (``DeviceAug.draw``), and the test hands them to the
JAX ``DeviceAug`` by replacing ``yolov7_d2_tpu.data.device_aug.
sample_params`` for the call (no JAX file changes). Tolerances, each with
its reason:

* the image: within 1e-3 of the 0-255 scale (0.255 levels) on at least
  99.9% of the pixels. The port builds M from elementwise products and
  inverts it by its adjugate where JAX multiplies matrices and inverts by
  LU, so each pixel's canvas coordinate differs by float noise (about
  1e-5 px); the bilinear taps carry that into the values (measured: at
  most 0.013 levels). A pixel at a tile seam or a paste edge can flip its
  quadrant or its inside test, and then differs by a whole pixel's value:
  the test counts those and allows 0.1% of the pixels (measured: 0);
* boxes: 1e-3 px (the same corner products, in another order; measured
  3.8e-6 px); classes and validity equal;
* the matrices: 1e-5 of their largest entry; boxes of the box functions
  alone: 1e-3 px;
* the two steps of ``make_device_aug_step`` against the JAX step: the
  tolerances of ``tests/test_torch_port_train.py``'s trajectory (losses
  1e-4 relative, the gradient norm 1e-3 on the first step and 1e-2 after
  an update), here with the JAX ``TPU.REMAT`` and the port's ``remat`` on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolov7_d2_tpu.data.device_aug as jda
from _torch_port_helpers import (
    TINY_OPTS,
    YOLOX_S_YAML,
    assert_batches_equal,
    jit_o0,
    load_into,
    opts_list,
    tiny_cfg,
    write_mini_coco,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.data import loader as jax_loader
from yolov7_d2_tpu.data import mappers as jax_mappers
from yolov7_d2_tpu.engine import build_yolox_system as jax_build_system
from yolov7_d2_tpu_torch import train_det
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data import coco, loader, mappers
from yolov7_d2_tpu_torch.data import device_aug as tda
from yolov7_d2_tpu_torch.data.catalog import (
    DatasetCatalog,
    register_coco_instances,
)
from yolov7_d2_tpu_torch.engine import build_yolox_system
from yolov7_d2_tpu_torch.kernels.grid_mask import grid_mask_plain
from yolov7_d2_tpu_torch.utils.args import default_argument_parser

S = 64            # tiles and output
B = 4
M = 6             # box slots of a tile
IMAGE_TOL = 1e-3 * 255
PIXEL_SHARE = 0.999
BOX_TOL = 1e-3
# each tile's size before the letterbox: the last leaves gray pad below
ORIG_HW = np.array([[48, 64], [64, 40], [100, 100], [30, 90]], np.float32)


def _cfgs(**opts):
    """(the JAX CfgNode, the port's YoloxConfig) of the tiny YOLOX at 64
    px with the mosaic at 48-80, HSV on, 30 box slots out."""
    opts = dict({"INPUT__DISTORTION__ENABLED": True,
                 "MODEL__YOLO__MAX_BOXES_NUM": 30}, **opts)
    jcfg = tiny_cfg(jax_get_cfg, **opts)
    return jcfg, YoloxConfig.from_cfg(tiny_cfg(get_cfg, **opts))


def _tiles(seed=0, b=B, orig=ORIG_HW):
    """Tiles as ``TileDatasetMapper`` gives them: each image letterboxed to
    fit S at the top left (gray elsewhere), 2-6 valid boxes inside it."""
    rng = np.random.default_rng(seed)
    img = np.full((b, S, S, 3), 114, np.uint8)
    boxes = np.zeros((b, M, 4), np.float32)
    valid = np.zeros((b, M), bool)
    for i, (h, w) in enumerate(orig):
        s = min(S / h, S / w)
        ph, pw = int(round(h * s)), int(round(w * s))
        img[i, :ph, :pw] = rng.integers(0, 256, (ph, pw, 3))
        for j in range(int(rng.integers(2, M + 1))):
            x, y = rng.uniform(0, pw - 12), rng.uniform(0, ph - 12)
            boxes[i, j] = [x, y, x + rng.uniform(8, pw - x),
                           y + rng.uniform(8, ph - y)]
            valid[i, j] = True
    classes = (rng.integers(0, 2, (b, M)) * valid).astype(np.int32)
    return {"image": img, "gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid, "orig_hw": orig.astype(np.float32)}


def _params(d: tda.AugDraws) -> jda.AugParams:
    """The port's draws as the JAX ``AugParams``."""
    def a(t, dtype=None):
        x = t.numpy()
        return jnp.asarray(x.astype(dtype) if dtype else x)

    return jda.AugParams(
        tile_idx=a(d.tile_idx, np.int32), canvas_hw=a(d.canvas_hw),
        center_yx=a(d.center_yx), angle=a(d.angle), pscale=a(d.pscale),
        shear=a(d.shear), translate=a(d.translate), persp=a(d.persp),
        do_mixup=a(d.do_mixup), mix_idx=a(d.mix_idx, np.int32),
        mix_jit=a(d.mix_jit), mix_flip=a(d.mix_flip), dhue=a(d.dhue),
        dsat=a(d.dsat), dexp=a(d.dexp), do_hflip=a(d.do_flip))


def _jax_aug(monkeypatch, jcfg, tiles, draws):
    monkeypatch.setattr(jda, "sample_params",
                        lambda rng, batch, **kw: _params(draws))
    out = jda.DeviceAug(jcfg)(jax.random.PRNGKey(0),
                              {k: jnp.asarray(v) for k, v in tiles.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _draws(cfg, seed, b=B):
    return tda.DeviceAug(cfg).draw(torch.Generator().manual_seed(seed), b)


def _torch(tiles):
    return {k: torch.from_numpy(v) for k, v in tiles.items()}


def _assert_image_close(got, want):
    px = np.abs(got - want).max(-1)
    off = int((px > IMAGE_TOL).sum())
    assert off <= (1 - PIXEL_SHARE) * px.size, (off, px.size, px.max())
    return off


def _assert_boxes_equal(got, want):
    np.testing.assert_array_equal(got["gt_valid"].numpy(), want["gt_valid"])
    np.testing.assert_array_equal(got["gt_classes"].numpy(),
                                  want["gt_classes"])
    np.testing.assert_allclose(got["gt_boxes"].numpy(), want["gt_boxes"],
                               atol=BOX_TOL, rtol=0)


# ------------------------------------------------------------- the draws


def test_draws_ranges_and_partners():
    jcfg, cfg = _cfgs(INPUT__GRID_MASK__ENABLED=True,
                      INPUT__GRID_MASK__PROB=0.5)
    n = 64
    d = _draws(cfg, 1, n)
    m = jcfg.INPUT.MOSAIC_AND_MIXUP
    assert torch.equal(d.tile_idx[:, 0], torch.arange(n))
    others = d.tile_idx[:, 1:]
    assert int(others.min()) >= 0 and int(others.max()) < n
    assert all(len(set(row)) == 3 for row in others.tolist())
    assert bool((others == d.tile_idx[:, :1]).any())   # itself a partner
    ch, cw = d.canvas_hw[:, 0], d.canvas_hw[:, 1]

    def within(x, lo, hi):
        return bool((x >= lo).all() and (x <= hi).all())

    assert within(ch, m.MOSAIC_HEIGHT_RANGE[0] / 2, m.MOSAIC_HEIGHT_RANGE[1] / 2)
    assert within(cw, m.MOSAIC_WIDTH_RANGE[0] / 2, m.MOSAIC_WIDTH_RANGE[1] / 2)
    assert within(d.center_yx[:, 0] / ch, 0.5, 1.5)
    assert within(d.center_yx[:, 1] / cw, 0.5, 1.5)
    assert within(d.angle, -m.DEGREES, m.DEGREES)
    assert within(d.pscale, *m.SCALE)
    assert within(d.shear, -m.SHEAR, m.SHEAR)
    assert within(d.translate, 0.5 - m.TRANSLATE, 0.5 + m.TRANSLATE)
    assert within(d.persp, -m.PERSPECTIVE, m.PERSPECTIVE)
    assert within(d.mix_idx, 0, n - 1) and within(d.mix_jit, *m.MSCALE)
    dist = jcfg.INPUT.DISTORTION
    assert within(d.dhue, -dist.HUE, dist.HUE)
    for g, top in ((d.dsat, dist.SATURATION), (d.dexp, dist.EXPOSURE)):
        up = g >= 1.0
        assert within(g[up], 1.0, top) and within(g[~up], 1 / top, 1.0)
        assert 0 < int(up.sum()) < n
    for coin in (d.do_mixup, d.mix_flip, d.do_flip):
        assert 0 < int(coin.sum()) < n
    drawn = d.grid_params[:, 0] > 1
    assert 0 < int(drawn.sum()) < n and d.grid_params.dtype == torch.int32
    assert not _draws(_cfgs(INPUT__MOSAIC_AND_MIXUP__ENABLE_MIXUP=False)[1],
                      1, n).do_mixup.any()
    with pytest.raises(ValueError, match="3 partners"):
        _draws(cfg, 0, 2)


# ----------------------------------------------------- the parts, one by one


def test_perspective_matrix_and_inverse_match_jax():
    _, cfg = _cfgs(INPUT__MOSAIC_AND_MIXUP__PERSPECTIVE=0.001)
    d = _draws(cfg, 2, 8)
    want = np.asarray(jax.vmap(jda.perspective_matrix, in_axes=(
        None, 0, 0, 0, 0, 0, 0))((S, S), *(jnp.asarray(t.numpy()) for t in (
            d.canvas_hw, d.angle, d.pscale, d.shear, d.translate,
            d.persp))))
    got = tda.perspective_matrix((S, S), d.canvas_hw, d.angle, d.pscale,
                                 d.shear, d.translate, d.persp)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    inv = tda.inverse3(got).numpy()
    ref = np.linalg.inv(got.numpy().astype(np.float64))
    np.testing.assert_allclose(inv, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=0)


def test_transform_and_mixup_boxes_match_jax():
    _, cfg = _cfgs()
    d = _draws(cfg, 3)
    t = _tiles(1)
    orig = torch.from_numpy(t["orig_hw"])
    pre_scale = torch.minimum(S / orig[:, 0], S / orig[:, 1])
    idx = d.tile_idx
    t_orig = orig[idx]
    ch, cw = d.canvas_hw[:, 0, None], d.canvas_hw[:, 1, None]
    s_c = torch.minimum(ch / t_orig[..., 0], cw / t_orig[..., 1])
    rect, pad = tda.mosaic_placement(d.canvas_hw, d.center_yx,
                                     t_orig * s_c[..., None])
    jrect, jpad = jax.vmap(jda._mosaic_placement)(
        jnp.asarray(d.canvas_hw.numpy()), jnp.asarray(d.center_yx.numpy()),
        jnp.asarray((t_orig * s_c[..., None]).numpy()))
    np.testing.assert_allclose(rect.numpy(), np.asarray(jrect), atol=1e-4)
    np.testing.assert_allclose(pad.numpy(), np.asarray(jpad), atol=1e-4)
    m = tda.perspective_matrix((S, S), d.canvas_hw, d.angle, d.pscale,
                               d.shear, d.translate, d.persp)
    boxes, valid = torch.from_numpy(t["gt_boxes"]), torch.from_numpy(
        t["gt_valid"])
    scale4 = s_c / pre_scale[idx]
    got = tda.transform_boxes(boxes[idx], valid[idx], scale4, pad,
                              d.canvas_hw, m, (S, S))
    want = jax.vmap(jda.transform_boxes, in_axes=(0, 0, 0, 0, 0, 0, None))(
        *(jnp.asarray(x.numpy()) for x in (boxes[idx], valid[idx], scale4,
                                            pad, d.canvas_hw, m)), (S, S))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=BOX_TOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() and not got[1].all()

    j = d.mix_idx
    r = torch.minimum(S / orig[j, 0], S / orig[j, 1]) * d.mix_jit
    nhw = (orig[j, 0] * r, orig[j, 1] * r)
    got = tda.mixup_boxes(boxes[j], valid[j], pre_scale[j], r, nhw,
                          d.mix_flip, (S, S))
    want = jax.vmap(jda.mixup_boxes, in_axes=(0, 0, 0, 0, 0, 0, None))(
        *(jnp.asarray(x.numpy()) for x in (boxes[j], valid[j], pre_scale[j],
                                            r)),
        tuple(jnp.asarray(x.numpy()) for x in nhw),
        jnp.asarray(d.mix_flip.numpy()), (S, S))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=BOX_TOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_passthrough_matches_jax():
    jcfg, cfg = _cfgs(MODEL__YOLO__MAX_BOXES_NUM=4)
    t = _tiles(2)
    want = jda.DeviceAug(jcfg).passthrough(
        {k: jnp.asarray(v) for k, v in t.items()})
    got = tda.DeviceAug(cfg).passthrough(_torch(t))
    assert got["image"].dtype == torch.uint8      # through K2 in the model
    for k in ("image", "gt_boxes", "gt_classes", "gt_valid"):
        np.testing.assert_array_equal(
            got[k].numpy().astype(np.asarray(want[k]).dtype),
            np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------ DeviceAug whole


@pytest.mark.parametrize("mixup", [True, False])
def test_device_aug_matches_jax(monkeypatch, mixup):
    """HSV and the flip on, MixUp on and off, the 4 tiles of
    :func:`_tiles` (one with gray pad) at 64 px."""
    jcfg, cfg = _cfgs(INPUT__MOSAIC_AND_MIXUP__ENABLE_MIXUP=mixup)
    t = _tiles(0)
    d = _draws(cfg, 3)
    assert d.do_flip.any() and not d.do_flip.all()
    assert not mixup or (d.do_mixup.any() and not d.do_mixup.all())
    want = _jax_aug(monkeypatch, jcfg, t, d)
    got = tda.DeviceAug(cfg).apply(_torch(t), d)
    assert got["image"].dtype == torch.float32
    assert got["image"].shape == (B, S, S, 3)
    _assert_image_close(got["image"].numpy(), want["image"])
    _assert_boxes_equal(got, want)
    assert 0 < int(got["gt_valid"].sum()) < got["gt_valid"].numel()


def test_device_aug_grid_mask_after_hsv_before_flip(monkeypatch):
    """With GridMask on, the port equals the JAX output (which has no
    GridMask: ROADMAP.md C.48) unflipped, through ``grid_mask_plain`` and
    flipped again."""
    jcfg, cfg = _cfgs(INPUT__GRID_MASK__ENABLED=True)
    t = _tiles(4)
    d = _draws(cfg, 5)
    d.grid_params = torch.tensor(
        [[6, 3, 1, 2, 1], [4, 2, 0, 3, 0], [1, 1, 0, 0, 0], [5, 3, 4, 4, 1]],
        dtype=torch.int32)
    assert d.do_flip.any()
    want = _jax_aug(monkeypatch, jcfg, t, d)
    flip = d.do_flip.numpy()[:, None, None, None]
    unflipped = np.where(flip, want["image"][:, :, ::-1], want["image"])
    masked = grid_mask_plain(torch.from_numpy(np.ascontiguousarray(
        unflipped)), d.grid_params).numpy()
    got = tda.DeviceAug(cfg).apply(_torch(t), d)
    _assert_image_close(got["image"].numpy(),
                        np.where(flip, masked[:, :, ::-1], masked))
    _assert_boxes_equal(got, want)


def test_non_square_tiles_and_one_band_grid_mask_raise():
    _, cfg = _cfgs()
    t = _torch(_tiles(0))
    t["image"] = t["image"][:, :, :48].contiguous()
    with pytest.raises(ValueError, match="square"):
        tda.DeviceAug(cfg).apply(t, _draws(cfg, 0))
    with pytest.raises(NotImplementedError, match="one band"):
        tda.DeviceAug(dataclasses.replace(cfg, grid_mask=True,
                                          grid_mask_use_width=False))


# ------------------------------------------------------- the mapper, the step


def test_tile_mapper_and_loader_match_jax(tmp_path):
    """``TileDatasetMapper`` through ``MapperFactory`` and the threaded
    loader against the JAX mapper through its loader: equal batches."""
    js, root = write_mini_coco(tmp_path, n=6)
    records = coco.load_coco_json(js, root)
    batches = []
    for m, ld, g in ((mappers, loader, get_cfg),
                     (jax_mappers, jax_loader, jax_get_cfg)):
        cfg = tiny_cfg(g)
        mapper = (m.MapperFactory(m.TileDatasetMapper, cfg)(0)
                  if m is mappers else m.TileDatasetMapper(cfg))
        it = iter(ld.build_detection_train_loader(cfg, records, mapper,
                                                  seed=2))
        batches.append([next(it) for _ in range(3)])
    for got, want in zip(*batches):
        assert got["image"].dtype == np.uint8
        assert got["orig_hw"].dtype == np.float32
        assert_batches_equal(got, want)


def test_device_aug_step_matches_jax_step(monkeypatch):
    """Two float32 steps of the tiny YOLOX through the JAX
    ``make_device_aug_step`` (``TPU.REMAT`` on) and the port's (``remat``
    on) from equal weights on the same tiles and draws (step s's from
    ``draw_seed(SEED, s)``)."""
    seed = 3
    opts = {"INPUT__MOSAIC_AND_MIXUP__DEVICE": True, "TPU__REMAT": True,
            "SEED": seed, "SOLVER__BASE_LR": 0.002,
            # the tiles' slots, as TileDatasetMapper densifies them (the
            # JAX cond's two branches then give one shape)
            "MODEL__YOLO__MAX_BOXES_NUM": M}
    jcfg, cfg = _cfgs(**opts)
    assert cfg.remat
    _, jstate, jstep, _ = jax_build_system(jcfg, jax.random.PRNGKey(0), B)
    model, state, step = build_yolox_system(cfg, device="cpu", seed=seed)
    load_into(model, {"params": jstate.params,
                      "batch_stats": jstate.batch_stats}).train()
    state.ema_params = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
    draws = [tda.DeviceAug(cfg).draw(torch.Generator().manual_seed(
        tda.draw_seed(seed, s, 0)), B) for s in range(2)]
    calls = []

    def sample(rng, batch, **kw):
        calls.append(batch)
        return _params(draws[len(calls) - 1])

    monkeypatch.setattr(jda, "sample_params", sample)
    jaug = jda.make_device_aug_step(jcfg, jit_o0(jstep))
    step = tda.make_device_aug_step(cfg, step, seed=seed, rank=0)
    for s in range(2):
        t = _tiles(10 + s)
        jstate, jm = jaug(jstate, {k: jnp.asarray(v) for k, v in t.items()})
        state, tm = step(state, _torch(t))
        assert float(tm["num_fg"]) == float(jm["num_fg"]) > 0, s
        np.testing.assert_allclose(float(tm["total_loss"]),
                                   float(jm["total_loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1e-3 if s == 0 else 1e-2)
        assert tm["grid_masked"] == 0
    assert calls == [B, B] and state.step == 2 and int(jstate.step) == 2


def test_device_aug_step_switches_off_and_draws_by_rank():
    _, cfg = _cfgs(INPUT__MOSAIC_AND_MIXUP__DISABLE_AT_ITER=2,
                   INPUT__GRID_MASK__ENABLED=True, INPUT__GRID_MASK__PROB=1.0)
    seen = []

    def record(state, batch):
        seen.append(batch)
        state.step += 1
        return state, {}

    class State:
        step = 0
        model = torch.nn.Linear(1, 1)

    t = _torch(_tiles(6))
    runs = {}
    for rank in (0, 0, 1):
        seen.clear()
        step = tda.make_device_aug_step(cfg, record, seed=4, rank=rank)
        state, metrics = State(), []
        for _ in range(3):
            state, m = step(state, t)
            metrics.append(m["grid_masked"])
        assert metrics == [B, B, 0]
        assert seen[0]["image"].dtype == torch.float32
        assert torch.equal(seen[2]["image"], t["image"])   # passthrough
        runs.setdefault(rank, []).append([b["image"] for b in seen[:2]])
    for a, b in zip(*runs[0]):
        assert torch.equal(a, b)                      # a run repeats
    assert not torch.equal(runs[0][0][0], runs[1][0][0])   # ranks differ
    assert not torch.equal(runs[0][0][0], runs[0][0][1])   # steps differ
    with pytest.raises(NotImplementedError, match="keypoints"):
        step(State(), dict(t, gt_keypoints=torch.zeros(B, M, 17, 3)))


# ------------------------------------------------------------- train_det


def test_train_det_device_feed_trains_and_resume_repeats_draws(
        tmp_path, monkeypatch):
    """``train_det`` with ``INPUT.MOSAIC_AND_MIXUP.DEVICE`` on the CPU: 4
    steps with GridMask and the aug off from step 3, finite losses, a
    checkpoint at 2; then a run of 2 and ``--resume`` to 4 draws at steps
    2 and 3 what the straight run drew."""
    js, root = write_mini_coco(tmp_path, n=8)
    name = "port_device_aug_mini"
    DatasetCatalog.remove(name)
    register_coco_instances(name, {}, js, root)
    drawn = []
    draw = tda.DeviceAug.draw

    def spy(self, generator, batch):
        d = draw(self, generator, batch)
        drawn.append(d)
        return d

    monkeypatch.setattr(tda.DeviceAug, "draw", spy)

    def run(out, *flags, **extra):
        opts = dict(TINY_OPTS, **{
            "INPUT.MOSAIC_AND_MIXUP.DEVICE": True,
            "INPUT.GRID_MASK.ENABLED": True,
            "INPUT.MOSAIC_AND_MIXUP.DISABLE_AT_ITER": 3,
            "DATASETS.TRAIN": (name,), "DATASETS.TEST": (name,),
            "OUTPUT_DIR": str(out), "SEED": 0, "SOLVER.MAX_ITER": 4,
            "SOLVER.CHECKPOINT_PERIOD": 2, "TEST.EVAL_PERIOD": 0})
        opts.update({k.replace("__", "."): v for k, v in extra.items()})
        return train_det.main(default_argument_parser().parse_args(
            ["--config-file", YOLOX_S_YAML, *flags, *opts_list(opts)]))

    try:
        trainer = run(tmp_path / "a")
        latest = trainer.storage.latest()
        for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls",
                  "grad_norm"):
            assert np.isfinite(latest[k]), k
        assert trainer.storage.iter == 4 and len(drawn) == 3
        straight = drawn[:]
        drawn.clear()
        run(tmp_path / "b", SOLVER__MAX_ITER=2)
        resumed = run(tmp_path / "b", "--resume")
        assert resumed.start_iter == 2 and resumed.storage.iter == 4
        assert len(drawn) == 3       # steps 0, 1, then 2 after the resume
        for f in dataclasses.fields(tda.AugDraws):
            assert torch.equal(getattr(drawn[2], f.name),
                               getattr(straight[2], f.name)), f.name
    finally:
        DatasetCatalog.remove(name)
