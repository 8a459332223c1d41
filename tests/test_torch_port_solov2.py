"""The port's SOLOv2 (``models/meta_arch/solov2.py``, ``necks/fpn.py``,
``ops/nms.matrix_nms_masks``) against the JAX package, in float32 on the
CPU.

* the copied table ``SCALE_RANGES``;
* ``matrix_nms_masks`` with both kernels, ``point_nms`` and the level
  targets (mass centres, centre regions clipped to 3x3 cells, scale
  ranges, empty masks, overlapping regions where the last gt wins);
* the model at narrow widths (ResNet of one bottleneck a stage in both
  packages, grids 12/10/8/6/4, 64 px): every category and kernel map and
  the mask features; ``solov2_losses``; the matrix-NMS tail on the model's
  outputs; ``solov2_upsample_masks``;
* the weight carrier both ways (flax -> port -> flax through the JAX
  ``port_torch_state_dict`` on the JAX SOLOv2 maps, exact), and the
  port's copies of those maps;
* the two yamls: what ``Solov2Config`` reads, every parameter and GN/BN
  leaf of the full model on the JAX init's (``jax.eval_shape``), the
  same counts; one ``build_system`` step against the JAX step's loss and
  gradient (the one JAX compile of the file's model, shared with the
  forward test).

Tolerances: outputs 1e-4 of each tensor's largest magnitude (XLA-CPU and
oneDNN sum convolutions in another order); loss terms and the gradient
norm 1e-4 and 1e-3 relative; the tail's scores 1e-4 of their largest, its
classes, validity and boxes exact, its masks 1e-4; the targets and the
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
from yolov7_d2_tpu.models.backbones import resnet as jresnet
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import solov2 as js
from yolov7_d2_tpu.ops.nms import matrix_nms_masks as jax_matrix_nms
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config import Solov2Config
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones import resnet as tresnet
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import solov2 as ts
from yolov7_d2_tpu_torch.ops.nms import matrix_nms_masks
from yolov7_d2_tpu_torch.utils import weight_port as twp

TOL = 1e-4
SIZE = 64
GRIDS = (12, 10, 8, 6, 4)
DIMS = dict(num_classes=3, num_grids=GRIDS, num_kernels=16,
            instance_channels=32, mask_channels=16)
CUT_DEPTH, CUT_BLOCKS = 10, (1, 1, 1, 1)
YAMLS = ("coco/solov2/solov2_r50.yaml", "coco-instance/solov2_lite.yaml")


@pytest.fixture(autouse=True, scope="module")
def _cut_resnet():
    """One bottleneck a stage in both packages: the JAX compiles cost the
    file's time."""
    with pytest.MonkeyPatch.context() as mp:
        for blocks in (jresnet.STAGE_BLOCKS, tresnet.STAGE_BLOCKS):
            mp.setitem(blocks, CUT_DEPTH, CUT_BLOCKS)
        yield


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _gts(rng, b=2, g=6, counts=(5, 4), size=SIZE):
    """Rectangles with a notch (a mass centre off the box centre), two of
    image 0 overlapping around one centre (the last gt wins its cells),
    one empty mask (skipped), one too large for the small levels."""
    masks = np.zeros((b, g, size, size), np.uint8)
    boxes = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(counts):
        for j in range(n):
            y0, x0 = rng.integers(0, size - 24, 2)
            h, w = rng.integers(6, 24, 2)
            if i == 0 and j == 1:
                (y0, x0), (h, w) = (y0_0, x0_0), (h0 + 2, w0 + 1)
            if i == 1 and j == 3:
                y0, x0, h, w = 2, 3, size - 6, size - 5
            masks[i, j, y0:y0 + h, x0:x0 + w] = 1
            masks[i, j, y0:y0 + h // 2, x0:x0 + w // 3] = 0
            boxes[i, j] = [x0, y0, x0 + w, y0 + h]
            if i == 0 and j == 0:
                y0_0, x0_0, h0, w0 = y0, x0, h, w
        cls[i, :n] = rng.integers(0, 3, n)
        valid[i, :n] = True
    masks[0, 2] = 0                                   # an empty mask
    return masks, boxes, cls, valid


def _global_norm(tree) -> float:
    """The global norm of a gradient tree: the JAX step's ``grad_norm``."""
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in jax.tree_util.tree_leaves(tree))))


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_copied_tables_equal_jax():
    assert ts.SCALE_RANGES == js.SCALE_RANGES


@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_matrix_nms_matches_jax(kernel):
    rng = np.random.default_rng(0)
    n = 30
    m = rng.random((n, 40)) > 0.6
    inter = (m[:, None] & m[None]).sum(-1)
    union = (m[:, None] | m[None]).sum(-1)
    ious = (inter / np.maximum(union, 1)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    scores = np.sort(rng.random(n).astype(np.float32))[::-1].copy()
    want = jax_matrix_nms(jnp.asarray(ious), jnp.asarray(labels),
                          jnp.asarray(scores), kernel, 2.0)
    got = matrix_nms_masks(*_torch(ious, labels, scores), kernel, 2.0)
    _close(got.numpy(), want)
    assert float(np.abs(np.asarray(want) - scores).max()) > 0.05


def test_point_nms_and_level_targets_match_jax():
    rng = np.random.default_rng(1)
    heat = rng.random((2, 7, 7, 3)).astype(np.float32)
    heat[0, 2, 2:4, 0] = 0.99                          # a tie in a window
    np.testing.assert_array_equal(
        ts.point_nms(torch.from_numpy(heat)).numpy(),
        np.asarray(js._point_nms(jnp.asarray(heat))))
    masks, boxes, cls, valid = _gts(rng)
    mf = masks.astype(np.float32)
    m00 = np.maximum(mf.sum((-2, -1)), 1e-6)
    centers = np.stack([(mf * np.arange(SIZE)).sum((-2, -1)) / m00,
                        (mf * np.arange(SIZE)[:, None]).sum((-2, -1)) / m00],
                       -1).astype(np.float32)
    mask_valid = mf.sum((-2, -1)) > 0
    positives = 0
    for lvl, grid in enumerate(GRIDS):
        want = jax.vmap(lambda gb, gc, gv, ce, mv: js._level_targets(
            grid, js.SCALE_RANGES[lvl], (SIZE, SIZE), gb, gc, gv, ce, mv))(
            *(jnp.asarray(a) for a in (boxes, cls, valid, centers,
                                       mask_valid)))
        got = ts.level_targets(grid, ts.SCALE_RANGES[lvl], (SIZE, SIZE),
                               *_torch(boxes, cls, valid, centers,
                                       mask_valid))
        for k in ("cate_target", "pos_cell", "pos_ok"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got["pos_gt"].numpy(),
                                      np.asarray(want["pos_gt"])[0])
        positives += int((got["cate_target"] > 0).sum())
    assert positives > 10


@functools.lru_cache(maxsize=None)
def _pair():
    """(flax SOLOv2, variables, port SOLOv2 with them, images, gts, and the
    JAX outputs, losses and parameter gradients of one compile)."""
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = js.SOLOv2(resnet_depth=CUT_DEPTH, **DIMS)
    variables = flax_variables_like(jm, images, rng)
    tm = load_into(ts.SOLOv2(resnet_depth=CUT_DEPTH, **DIMS), variables,
                   twp.map_solov2_torch_name)
    gts = _gts(rng)

    @jit_o0
    def jfn(params, x, masks, boxes, cls, valid):
        def total(params):
            # the frozen BN of the ResNet reads its statistics in train mode
            out = jm.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=True)
            losses = js.solov2_losses(out, masks, boxes, cls, valid,
                                      (SIZE, SIZE), 3, GRIDS)
            return losses["total_loss"], (out, losses)

        (_, aux), grads = jax.value_and_grad(total, has_aux=True)(params)
        return aux, grads

    (out, losses), grads = jfn(variables["params"],
                               *(jnp.asarray(a) for a in (images,) + gts))
    return jm, variables, tm, images, gts, out, losses, grads


def test_forward_and_losses_match_jax():
    """The uint8 path's outputs (every level's category and kernel maps,
    the mask features) and the loss terms on the gts of :func:`_gts`."""
    _, _, tm, images, gts, want, jlosses, _ = _pair()
    with torch.no_grad():
        got = tm(torch.from_numpy(images.astype(np.uint8)))
        losses = ts.solov2_losses(got, *_torch(*gts), (SIZE, SIZE), 3,
                                  GRIDS)
    for k in ("cate_preds", "kernel_preds"):
        for lvl, (g, w) in enumerate(zip(got[k], want[k])):
            _close(g.numpy(), w, what=f"{k}[{lvl}]")
    _close(got["mask_feats"].numpy(), want["mask_feats"], what="mask_feats")
    for k in ("loss_cate", "loss_mask", "num_pos", "total_loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=TOL, err_msg=k)
    assert float(losses["num_pos"]) > 5


def test_tail_and_upsample_match_jax():
    """``solov2_postprocess`` on the model's outputs (score threshold 0 so
    that the random weights give candidates, 60 of them, 20 kept) and
    ``solov2_upsample_masks`` of its masks, to a larger and a smaller
    original."""
    _, _, tm, images, _, want_out, _, _ = _pair()
    with torch.no_grad():
        out = tm(torch.from_numpy(images))
    kw = dict(score_thr=0.0, nms_pre=60, max_per_img=20)
    want = jit_o0(functools.partial(js.solov2_postprocess, **kw))(want_out)
    got = ts.solov2_postprocess(out, **kw)
    _close(got.scores.numpy(), want.scores, what="scores")
    for f in ("classes", "valid", "boxes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    _close(got.masks.numpy(), want.masks, what="masks")
    assert int(got.valid.sum()) > 0
    for ori in ((100, 90), (40, 50)):
        wb, wboxes = js.solov2_upsample_masks(want.masks[0], (SIZE, SIZE),
                                              ori)
        gb, gboxes = ts.solov2_upsample_masks(got.masks[0], (SIZE, SIZE), ori)
        mismatch = float((gb.numpy() != np.asarray(wb)).mean())
        assert mismatch < 1e-4, mismatch
        assert gb.shape == (20,) + ori


def _jax_map(name):
    """The port's key -> the flax path by the JAX package's own maps."""
    prefix, _, rest = name.partition(".")
    if prefix == "ins_head":
        return ("ins_head",) + jwp.map_solov2_ins_torch_name(rest)
    if prefix == "mask_head":
        return ("mask_head",) + jwp.map_solov2_mask_torch_name(rest)
    if prefix == "fpn":
        return tuple(name.split("."))
    return jwp.map_d2_resnet_name(name)


def test_weight_carrier_both_ways_and_the_name_maps():
    _, variables, tm, _, _, _, _, _ = _pair()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    zero = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        numpy_variables(variables))
    back, report = jwp.port_torch_state_dict(sd, zero, name_mapper=_jax_map)
    assert not report["unused"], report["unused"][:5]
    want = jax.tree_util.tree_leaves_with_path(numpy_variables(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))
    modules = {k.rpartition(".")[0] for k in sd}
    assert len(modules) > 50
    for m in modules:
        assert twp.map_solov2_torch_name(m) == _jax_map(m), m


def _yaml_cfg(fn, yaml, **opts):
    cfg = fn()
    cfg.merge_from_file(str(REPO / "configs" / yaml))
    for k, v in opts.items():
        cfg.merge_from_list([k, repr(v)])
    return cfg


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_config_and_leaves_match_jax(yaml, monkeypatch):
    """What ``Solov2Config`` reads (the lite yaml's ``FPN_SCALE_RANGES``
    is read by neither package, ROADMAP.md C.35), and every key of the
    full model of the yaml on a leaf of the JAX model's init, the same
    counts."""
    cfg = _yaml_cfg(get_cfg, yaml)
    scfg = Solov2Config.from_cfg(cfg)
    assert (scfg.num_classes, scfg.num_grids, scfg.num_kernels,
            scfg.instance_channels, scfg.mask_channels, scfg.resnet_depth,
            scfg.use_dcn_in_instance) == (80, (40, 36, 24, 16, 12), 256, 512,
                                          128, 50, False)
    assert scfg.input_size == ((448, 448) if "lite" in yaml else (640, 640))
    assert scfg.amp and scfg.base_lr == 0.01 and scfg.optimizer == "sgd"
    monkeypatch.setattr(ts, "init_weights_", lambda *a: None)
    count = assert_leaves_match_jax(
        build_model(scfg, "cpu"), jax_build_model(_yaml_cfg(jax_get_cfg,
                                                            yaml)),
        twp.map_solov2_torch_name, size=SIZE)
    assert count["params"] > 4e7 and count["batch_stats"] > 0


def test_build_system_step_matches_jax(monkeypatch):
    """One step of the port's ``build_system`` on ``solov2_r50.yaml``
    (SGD, float32, 64 px) against the JAX ``build_system``'s: both build
    the narrow model of :func:`_pair` (a fresh port model holding its
    weights) in place of the full-size one and give the same batch fields;
    the step's loss terms and gradient norm against the loss and gradient
    of the JAX step's computation (:func:`_pair`'s compile: the JAX step's
    ``solov2_losses`` call, as ``engine.py:250-259`` wires it)."""
    jm, init, _, images, gts, _, jlosses, jgrads = _pair()
    tm = load_into(ts.SOLOv2(resnet_depth=CUT_DEPTH, **DIMS), init,
                   twp.map_solov2_torch_name)
    opts = {"SOLVER.AMP.ENABLED": False, "INPUT.INPUT_SIZE": [SIZE, SIZE],
            "MODEL.SOLOV2.NUM_CLASSES": 3, "MODEL.SOLOV2.NUM_GRIDS":
            list(GRIDS), "SOLVER.WARMUP_ITERS": 0}
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
    assert fields == jfields == ("image", "gt_masks", "gt_boxes",
                                 "gt_classes", "gt_valid")
    batch = dict(zip(fields, (images,) + gts))
    plain = ts.normalize_images_plain
    monkeypatch.setattr(ts, "normalize_images_plain",
                        lambda *a: plain(*a).contiguous())
    before = [p.detach().clone() for p in model.parameters()]
    _, tm_ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss_cate", "loss_mask", "num_pos", "total_loss"):
        np.testing.assert_allclose(float(tm_[k]), float(jlosses[k]),
                                   rtol=TOL, err_msg=k)
    np.testing.assert_allclose(float(tm_["grad_norm"]), _global_norm(jgrads),
                               rtol=1e-3)
    assert sum(not torch.equal(a, b.detach())
               for a, b in zip(before, model.parameters())) > 50
