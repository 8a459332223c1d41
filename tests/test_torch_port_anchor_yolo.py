"""The port's anchor-YOLO pieces against the JAX package, in float32 on the
CPU: the IoU loss family, the decode, both target builders, the losses,
the NMS tail, the anchors of a config, the name maps and the config.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances, each with its reason:

* targets (``fg_mask``, ``matched_gt``): exact, scenes where several gts
  claim one anchor included; the JAX package's ``.at[idx].set`` lets the
  last write win on the CPU, which the port reproduces by taking the
  candidate of the largest position (``scatter_reduce`` ``amax``);
* IoU losses and their gradients: 1e-6 relative to the largest magnitude.
  XLA's and torch's atan, exp, sqrt and pow may differ by an ulp;
* the decode: grids, strides, anchors and the flattened outputs exact; the
  boxes within 4 ulp (4.8e-7 relative plus 1e-6 px): XLA's and torch's
  exp and sigmoid differ by an ulp on a share of the inputs (measured on
  1e6 normal floats: sigmoid 0.4%, exp 9.6%), and the v7 wh squares the
  sigmoid (2.5 ulp seen);
* losses: 1e-5 relative, ``num_fg`` exact; gradients with respect to the
  raw outputs 1e-5 of their largest magnitude (sums of 1e3-1e4 terms in
  another order);
* the NMS tail on the same decoded inputs: index for index (the same
  float32 operations; ties kept in ``jax.lax.top_k``'s order), tied scores
  included.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import colliding_gts, decoded_candidates
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.heads import anchor_yolo_head as jhead
from yolov7_d2_tpu.models.meta_arch import yolov7 as jarch
from yolov7_d2_tpu.ops.iou import iou_loss as jax_iou_loss
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import AnchorYoloConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones.darknet import Darknet53
from yolov7_d2_tpu_torch.models.heads import anchor_yolo_head as thead
from yolov7_d2_tpu_torch.models.meta_arch import yolov7 as tarch
from yolov7_d2_tpu_torch.models.necks.yolo_fpn import YOLOFPN
from yolov7_d2_tpu_torch.ops.iou import iou_loss
from yolov7_d2_tpu_torch.utils import weight_port as twp

REPO = Path(__file__).resolve().parent.parent
ANCHORS = np.array(AnchorYoloConfig.anchors, np.float32)   # level order
SIZE = 64
LEVEL_HW = ((8, 8), (4, 4), (2, 2))
STRIDES = (8, 16, 32)
A = sum(h * w * 3 for h, w in LEVEL_HW)
CLASSES = 5
LOSS_RTOL = 1e-5
IOU_TYPES = ("iou", "linear_iou", "giou", "diou", "ciou", "siou")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------- IoU losses


def _box_pairs(rng, n=400):
    """Aligned xyxy pairs: overlapping, disjoint, nested, equal centres."""
    c = rng.uniform(0, 600, (n, 2))
    wh_p = rng.uniform(2, 200, (n, 2))
    shift = rng.normal(0, 40, (n, 2))
    shift[: n // 8] = 0.0                         # equal centres
    shift[n // 8: n // 4] *= 10                   # mostly disjoint
    wh_t = wh_p * rng.uniform(0.3, 2.5, (n, 2))
    pred = np.concatenate([c - wh_p / 2, c + wh_p / 2], -1)
    tc = c + shift
    target = np.concatenate([tc - wh_t / 2, tc + wh_t / 2], -1)
    return pred.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("loss_type", IOU_TYPES)
def test_iou_losses_and_grads_match_jax(loss_type):
    pred, target = _box_pairs(np.random.default_rng(1))
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda p, t: jnp.sum(jax_iou_loss(p, t, loss_type) ** 2),
    ), static_argnums=())(jnp.asarray(pred), jnp.asarray(target))
    want_loss = jax_iou_loss(jnp.asarray(pred), jnp.asarray(target),
                             loss_type)
    p = torch.from_numpy(pred).requires_grad_(True)
    got_loss = iou_loss(p, torch.from_numpy(target), loss_type)
    (got_loss ** 2).sum().backward()
    assert np.isfinite(got_loss.detach().numpy()).all()
    assert _rel_err(got_loss.detach(), want_loss) <= 1e-6
    assert _rel_err(p.grad, want_grad) <= 1e-6


def test_iou_loss_rejects_unknown_type():
    with pytest.raises(ValueError):
        iou_loss(torch.zeros(1, 4), torch.zeros(1, 4), "eiou")


def test_ciou_alpha_carries_no_gradient():
    pred, target = _box_pairs(np.random.default_rng(2), 50)
    p = torch.from_numpy(pred).requires_grad_(True)
    iou_loss(p, torch.from_numpy(target), "ciou").sum().backward()
    want = jax.grad(lambda q: jnp.sum(jax_iou_loss(
        q, jnp.asarray(target), "ciou")))(jnp.asarray(pred))
    assert _rel_err(p.grad, want) <= 1e-6


# ----------------------------------------------------------------- decode


def _level_maps(rng, b=2, classes=CLASSES):
    """Per-level raw maps, NHWC for JAX and NCHW for the port."""
    maps = [rng.normal(0, 2, (b, h, w, 3 * (5 + classes))).astype(np.float32)
            for h, w in LEVEL_HW]
    return maps, [torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1,
                                                                     2)))
                  for m in maps]


@pytest.mark.parametrize("variant", ["yolov3", "yolov7"])
def test_decode_matches_jax(variant):
    jmaps, tmaps = _level_maps(np.random.default_rng(3))
    jmaps[0][..., 2:4] += 7.0                     # reach the v3 exp clip at 8
    tmaps[0][:, :, :, :] = torch.from_numpy(
        np.ascontiguousarray(jmaps[0].transpose(0, 3, 1, 2)))
    jflat = jhead.flatten_anchor_outputs([jnp.asarray(m) for m in jmaps],
                                         ANCHORS, STRIDES)
    tflat = thead.flatten_anchor_outputs(tmaps, ANCHORS.tolist(), STRIDES)
    for key in ("outputs", "grids", "strides", "anchors"):
        np.testing.assert_array_equal(tflat[key].numpy(),
                                      np.asarray(jflat[key]), err_msg=key)
    want = jhead.decode_anchor_outputs(jflat, variant)
    got = thead.decode_anchor_outputs(tflat, variant)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=4.8e-7, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ---------------------------------------------------------------- targets


def _gts(rng, b, g, n_valid, size=SIZE):
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        wh = rng.uniform(4, 1.6 * size, (n, 2))
        c = rng.uniform(0, size, (n, 2))
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :n] = True
    classes = (rng.integers(0, CLASSES, (b, g)) * valid).astype(np.int32)
    return boxes, classes, valid


def _targets_both(build, gts):
    jbuild = getattr(jhead, build)
    want = jax.jit(jax.vmap(lambda gb, gc, gv: jbuild(
        gb, gc, gv, ANCHORS, LEVEL_HW, STRIDES)))(*map(jnp.asarray, gts))
    got = getattr(thead, build)(*map(torch.from_numpy, gts), ANCHORS,
                                LEVEL_HW, STRIDES)
    return got, want


def _assert_targets_equal(got, want):
    np.testing.assert_array_equal(got["fg_mask"].numpy(),
                                  np.asarray(want["fg_mask"]))
    np.testing.assert_array_equal(got["matched_gt"].numpy(),
                                  np.asarray(want["matched_gt"]))


@pytest.mark.parametrize("build", ["build_targets_max_iou",
                                   "build_targets_ratio"])
@pytest.mark.parametrize("seed", [0, 1])
def test_targets_match_jax(build, seed):
    gts = _gts(np.random.default_rng(seed), 3, 12, [12, 5, 0])
    got, want = _targets_both(build, gts)
    _assert_targets_equal(got, want)
    assert int(got["fg_mask"][0].sum()) > 5
    assert not bool(got["fg_mask"][2].any())      # no valid gt, no target


@pytest.mark.parametrize("build", ["build_targets_max_iou",
                                   "build_targets_ratio"])
def test_targets_resolve_collisions_as_jax(build):
    gts = colliding_gts()
    got, want = _targets_both(build, gts)
    _assert_targets_equal(got, want)
    # the scene collides: fewer foreground anchors than claims, and the
    # anchor the copies share went to the last valid copy (gt 5)
    claims = _claims(build, gts)
    assert int(got["fg_mask"].sum()) < claims
    assert 5 in got["matched_gt"][0][got["fg_mask"][0]].tolist()
    assert not {0, 1, 2, 3} & set(
        got["matched_gt"][0][got["fg_mask"][0]].tolist())


def _claims(build, gts):
    """The (gt, anchor) claims before collisions are resolved."""
    boxes, classes, valid = map(torch.from_numpy, gts)
    total = 0
    for g in range(boxes.shape[1]):
        one = torch.zeros_like(valid)
        one[:, g] = valid[:, g]
        total += int(getattr(thead, build)(boxes, classes, one, ANCHORS,
                                           LEVEL_HW, STRIDES)
                     ["fg_mask"].sum())
    return total


def test_max_iou_targets_match_oracle():
    """The literal loop of ``tests/test_anchor_yolo.py:197`` (the reference
    ``get_target`` semantics; a later gt overwrites an earlier one)."""
    rng = np.random.default_rng(11)
    g_num = 6
    gt_boxes = np.zeros((g_num, 4), np.float32)
    gt_valid = np.zeros(g_num, bool)
    for g in range(4):
        x, y = rng.uniform(0, 40, 2)
        w, h = rng.uniform(8, 120, 2)
        gt_boxes[g] = [x, y, min(x + w, 64), min(y + h, 64)]
        gt_valid[g] = True
    gt_classes = rng.integers(0, 3, g_num).astype(np.int32)
    t = thead.build_targets_max_iou(
        torch.from_numpy(gt_boxes[None]), torch.from_numpy(gt_classes[None]),
        torch.from_numpy(gt_valid[None]), ANCHORS, LEVEL_HW, STRIDES)

    offsets, a_total = [], 0
    for h, w in LEVEL_HW:
        offsets.append(a_total)
        a_total += h * w * 3
    fg_o = np.zeros(a_total, bool)
    matched_o = np.zeros(a_total, np.int64)
    flat_anchors = ANCHORS.reshape(-1, 2)
    for g in range(g_num):
        if not gt_valid[g]:
            continue
        gw = gt_boxes[g, 2] - gt_boxes[g, 0]
        gh = gt_boxes[g, 3] - gt_boxes[g, 1]
        best, best_iou = -1, -1.0
        for ai, (aw, ah) in enumerate(flat_anchors):
            inter = min(gw, aw) * min(gh, ah)
            v = inter / (gw * gh + aw * ah - inter + 1e-9)
            if v > best_iou:
                best_iou, best = v, ai
        lvl, k = best // 3, best % 3
        h_l, w_l = LEVEL_HW[lvl]
        cx = int(np.clip((gt_boxes[g, 0] + gt_boxes[g, 2]) / 2
                         / STRIDES[lvl], 0, w_l - 1))
        cy = int(np.clip((gt_boxes[g, 1] + gt_boxes[g, 3]) / 2
                         / STRIDES[lvl], 0, h_l - 1))
        idx = offsets[lvl] + (cy * w_l + cx) * 3 + k
        fg_o[idx] = True
        matched_o[idx] = g
    fg = t["fg_mask"][0].numpy()
    np.testing.assert_array_equal(fg, fg_o)
    np.testing.assert_array_equal(t["matched_gt"][0].numpy()[fg],
                                  matched_o[fg_o])


# ----------------------------------------------------------------- losses


def _flat_outputs(rng, b=2):
    jmaps, tmaps = _level_maps(rng, b)
    for m in jmaps:
        m[..., :] *= 0.5
    tmaps = [torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1, 2)))
             for m in jmaps]
    jflat = jhead.flatten_anchor_outputs([jnp.asarray(m) for m in jmaps],
                                         ANCHORS, STRIDES)
    tflat = thead.flatten_anchor_outputs(tmaps, ANCHORS.tolist(), STRIDES)
    return jflat, tflat


LOSS_CASES = {
    # name: (variant, build target type, iou type, loss type, ignore thr)
    "v7_ciou": ("yolov7", "default", "ciou", "v7", 0.5),
    "v7_ratio_giou": ("yolov7", "yolov5", "giou", "v7", 0.5),
    "v7_siou": ("yolov7", "default", "siou", "v7", 0.7),
    "v4_v3_decode": ("yolov3", "default", "ciou", "v4", 0.5),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_anchor_losses_match_jax(case):
    variant, btype, iou_type, loss_type, thr = LOSS_CASES[case]
    rng = np.random.default_rng(5)
    jflat, tflat = _flat_outputs(rng)
    gts = _gts(rng, 2, 10, [10, 4])
    lambdas = dict(lambda_iou=1.1, lambda_conf=0.9, lambda_cls=1.2,
                   lambda_xy=0.8, lambda_wh=1.3)
    kw = dict(anchors=ANCHORS, level_hw=LEVEL_HW, level_strides=STRIDES,
              num_classes=CLASSES, variant=variant, build_target_type=btype,
              iou_type=iou_type, loss_type=loss_type, ignore_threshold=thr,
              **lambdas)

    def jloss(out):
        losses = jhead.anchor_yolo_losses(dict(jflat, outputs=out),
                                          *map(jnp.asarray, gts), **kw)
        return losses["total_loss"], losses

    jgrad, want = jax.jit(jax.grad(jloss, has_aux=True))(jflat["outputs"])
    out = tflat["outputs"].clone().requires_grad_(True)
    got = thead.anchor_yolo_losses(dict(tflat, outputs=out),
                                   *map(torch.from_numpy, gts), **kw)
    got["total_loss"].backward()
    assert float(got["num_fg"]) == float(want["num_fg"]) > 5
    for k in ("loss_box", "loss_obj", "loss_cls", "total_loss"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert _rel_err(out.grad, jgrad) <= LOSS_RTOL


def test_ignore_mask_drops_objectness_of_overlapping_predictions():
    rng = np.random.default_rng(6)
    _, tflat = _flat_outputs(rng)
    gts = _gts(rng, 2, 10, [10, 4])
    args = (*map(torch.from_numpy, gts), ANCHORS, LEVEL_HW, STRIDES, CLASSES)
    strict = thead.anchor_yolo_losses(tflat, *args, ignore_threshold=1.0)
    loose = thead.anchor_yolo_losses(tflat, *args, ignore_threshold=0.0)
    assert float(loose["loss_obj"]) < float(strict["loss_obj"])
    assert float(loose["loss_box"]) == float(strict["loss_box"])


# ---------------------------------------------------------------- the tail


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("v5_gate", [False, True])
def test_nms_tail_matches_jax_index_for_index(tied, v5_gate):
    rng = np.random.default_rng(7)
    inputs = decoded_candidates(rng, 2, A, CLASSES, SIZE,
                                cut=120 if tied else None)
    kw = dict(conf_threshold=0.05, nms_threshold=0.5, max_detections=40,
              pre_nms_topk=120, v5_gate=v5_gate)
    want = jax.jit(functools.partial(jarch.yolo_nms_postprocess, **kw))(
        *map(jnp.asarray, inputs))
    got = tarch.yolo_nms_postprocess(*map(torch.from_numpy, inputs), **kw)
    for field in ("valid", "classes", "boxes", "scores"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.valid.sum()) > 20
    if tied:   # the cut at 120 falls inside a run of equal scores
        scores = torch.from_numpy(inputs[1] * inputs[2].max(-1))
        ranked = torch.sort(scores, descending=True).values
        assert bool((ranked[:, 119] == ranked[:, 120]).all())


def test_anchor_yolo_postprocess_matches_jax():
    rng = np.random.default_rng(8)
    jflat, tflat = _flat_outputs(rng)
    kw = dict(conf_threshold=0.01, nms_threshold=0.5, max_detections=50,
              pre_nms_topk=200)
    for variant in ("yolov3", "yolov7"):
        want = jarch.anchor_yolo_postprocess(jflat, variant, **kw)
        got = tarch.anchor_yolo_postprocess(tflat, variant, **kw)
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes.numpy(),
                                      np.asarray(want.classes))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------- config, anchors, names


@pytest.mark.parametrize("yaml", ["yolov7.yaml", "darknet53.yaml",
                                  "r50.yaml", "cspdarknet53.yaml"])
def test_config_and_anchors_from_cfg(yaml):
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(REPO / "configs" / "coco" / yaml))
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "coco" / yaml))
    assert tarch._anchors_from_cfg(cfg) == jarch._anchors_from_cfg(jcfg)
    ycfg = AnchorYoloConfig.from_cfg(cfg)
    assert ycfg.anchors == jarch._anchors_from_cfg(jcfg)
    assert ycfg.meta_architecture == jcfg.MODEL.META_ARCHITECTURE
    assert ycfg.loss_type == jcfg.MODEL.YOLO.LOSS_TYPE
    assert ycfg.ignore_threshold == jcfg.MODEL.YOLO.IGNORE_THRESHOLD
    if yaml == "yolov7.yaml":
        # the dataclass's defaults are this yaml
        assert ycfg == AnchorYoloConfig()


def _module_names(module):
    return sorted({name.rpartition(".")[0] for name in module.state_dict()
                   if not name.endswith("num_batches_tracked")})


@pytest.mark.parametrize("name", ["darknet", "cspdarknet", "yolofpn"])
def test_name_map_copies_match_jax(name):
    module, tmap, jmap = {
        "darknet": (Darknet53(stage_blocks=(1, 2, 2, 2, 1)),
                    twp.map_darknet_torch_name, jwp.map_darknet_torch_name),
        "cspdarknet": (Darknet53(with_csp=True, stage_blocks=(1, 2, 2, 2, 1)),
                       twp.map_cspdarknet_torch_name,
                       jwp.map_cspdarknet_torch_name),
        "yolofpn": (YOLOFPN(with_spp=True), twp.map_yolofpn_torch_name,
                    jwp.map_yolofpn_torch_name),
    }[name]
    names = _module_names(module)
    assert len(names) > 10
    for n in names + ["unknown.module"]:
        assert tmap(n) == jmap(n), n


@pytest.mark.parametrize("builder", ["build_darknet_backbone",
                                     "build_cspdarknet_backbone"])
def test_backbone_builders_match_jax(builder):
    """The registry builders of the JAX package from ``yolov7.yaml``
    (CSP on): every parameter and statistic at the flax path of the copied
    name map, of the same shape, and the stem's BatchNorm eps."""
    from yolov7_d2_tpu.models.backbones import darknet as jdark
    from yolov7_d2_tpu_torch.models.backbones import darknet as tdark

    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(REPO / "configs" / "coco" / "yolov7.yaml"))
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "coco" / "yolov7.yaml"))
    jbb = getattr(jdark, builder)(jcfg)
    tbb = getattr(tdark, builder)(AnchorYoloConfig.from_cfg(cfg))
    shapes = jax.eval_shape(lambda x: jbb.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    flax = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes[coll]):
            flax[tuple(str(getattr(k, "key", k)) for k in path)] = leaf.shape
    mapper = (twp.map_cspdarknet_torch_name if tbb.with_csp
              else twp.map_darknet_torch_name)
    leaves = {"weight": ("kernel", "scale"), "bias": ("bias",),
              "running_mean": ("mean",), "running_var": ("var",)}
    for key, value in tbb.state_dict().items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        found = [mapper(module) + (n,) for n in leaves[leaf]
                 if mapper(module) + (n,) in flax]
        assert len(found) == 1, key
        shape = flax.pop(found[0])
        if len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert tuple(value.shape) == tuple(shape), key
    assert not flax, list(flax)[:5]
    stem_bn = tbb.bn1 if tbb.with_csp else tbb.stem.bn
    assert stem_bn.eps == jbb.bn_eps
    assert tbb.out_channels == tdark.DARKNET53_CHANNELS \
        == jdark.DARKNET53_CHANNELS


def test_mish_matches_jax():
    x = np.random.default_rng(9).normal(0, 6, 100000).astype(np.float32)
    x[:10] = [25.0, 21.0, 20.0, 19.9, -25.0, -30.0, 0.0, 1e-8, -1e-8, 60.0]
    from yolov7_d2_tpu.models.layers.blocks import get_activation

    want = np.asarray(get_activation("mish")(jnp.asarray(x)))
    got = torch.nn.Mish()(torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) < 1e-6
