"""The port's library ops against the JAX package on the CPU: the NMS suite
(``ops/nms.py``: ``nms``, ``batched_nms``, ``soft_nms``, ``cluster_nms``,
``generalized_batched_nms`` in its four modes, ``weighted_boxes_fusion``),
the GFL losses and the L1 family (``ops/losses.py``),
``bbox_overlaps_cxcywh`` (``ops/iou.py``), the box helpers and
``GtInstances`` (``structures/``), and the export surface of both packages'
``ops`` and ``structures``.

The inputs are numpy from a seed, handed to both sides. The greedy NMS and
cluster-NMS are index-exact on distinct scores; soft-NMS's kept scores and
WBF's boxes and scores within 1e-5 relative; the losses within 1e-6
relative in float32, QFL's and DFL's gradients against ``jax.grad``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import jit_o0
import yolov7_d2_tpu.ops as jops
import yolov7_d2_tpu.structures as jstructs
import yolov7_d2_tpu_torch.ops as tops
import yolov7_d2_tpu_torch.structures as tstructs
from yolov7_d2_tpu.ops import iou as jiou
from yolov7_d2_tpu.ops import losses as jlosses
from yolov7_d2_tpu_torch.ops import losses as tlosses


def _public(module):
    return sorted(n for n in vars(module) if not n.startswith("_")
                  and not inspect.ismodule(getattr(module, n)))


@pytest.mark.parametrize("jax_pkg,port_pkg", [(jops, tops),
                                              (jstructs, tstructs)],
                         ids=["ops", "structures"])
def test_port_exports_every_public_name_of_the_jax_package(jax_pkg,
                                                           port_pkg):
    jax_names = _public(jax_pkg)
    assert len(jax_names) >= 10, jax_names
    missing = [n for n in jax_names if not hasattr(port_pkg, n)]
    assert not missing, missing
    assert all(callable(getattr(port_pkg, n)) for n in jax_names)


def _boxes(rng, n, size=64.0, classes=None):
    xy = rng.uniform(0, size * 0.75, (n, 2))
    wh = rng.uniform(4, size * 0.4, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    # distinct scores: a permutation of evenly spaced values
    scores = (rng.permutation(n) + 1).astype(np.float32) / (n + 1)
    cls = (rng.integers(0, classes, n).astype(np.int32) if classes
           else np.zeros(n, np.int32))
    return boxes, scores, cls


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("n,thr,score_thr,classes", [
    (50, 0.5, 0.0, None), (120, 0.3, 0.25, None), (200, 0.6, 0.0, 5),
    (40, 0.45, 0.5, 3)])
def test_greedy_nms_is_index_exact(n, thr, score_thr, classes):
    rng = np.random.default_rng(n)
    boxes, scores, cls = _boxes(rng, n, classes=classes)
    if classes:
        want = jops.batched_nms(*map(jnp.asarray, (boxes, scores, cls)),
                                thr, n, score_thr)
        got = tops.batched_nms(*_t(boxes, scores, cls), thr, n, score_thr)
    else:
        want = jops.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, n,
                        score_thr)
        got = tops.nms(*_t(boxes, scores), thr, n, score_thr)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    # some kept, some suppressed
    assert 0 < int(got[1].sum()) < n


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_matches(method):
    rng = np.random.default_rng(3)
    boxes, scores, _ = _boxes(rng, 80)
    want = jops.soft_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.4, 40,
                         method=method, score_threshold=0.05)
    got = tops.soft_nms(*_t(boxes, scores), 0.4, 40, method=method,
                        score_threshold=0.05)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5,
                               atol=0)
    assert int(got[1].sum()) > 10


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_cluster_nms_is_index_exact(tied):
    rng = np.random.default_rng(11)
    boxes, scores, _ = _boxes(rng, 90)
    if tied:
        # blocks of equal scores: the stable sort keeps their index order
        scores = np.round(scores * 8) / 8
        scores[::7] = 0.0
    want = jops.cluster_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                            50)
    got = tops.cluster_nms(*_t(boxes, scores), 0.5, 50)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


@pytest.mark.parametrize("nms_type", ["normal", "softnms-linear",
                                      "softnms-gaussian", "cluster"])
def test_generalized_batched_nms_modes(nms_type):
    rng = np.random.default_rng(5)
    boxes, scores, cls = _boxes(rng, 150, classes=4)
    want = jops.generalized_batched_nms(
        *map(jnp.asarray, (boxes, scores, cls)), 0.5, 60, 0.1, nms_type)
    got = tops.generalized_batched_nms(*_t(boxes, scores, cls), 0.5, 60,
                                       0.1, nms_type)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5,
                               atol=0)
    with pytest.raises(ValueError):
        tops.generalized_batched_nms(*_t(boxes, scores, cls),
                                     nms_type="matrix")


@pytest.mark.parametrize("weight_thresh", [0.0, 0.2])
def test_weighted_boxes_fusion_matches(weight_thresh):
    rng = np.random.default_rng(8)
    boxes, scores, _ = _boxes(rng, 120)
    want = jops.weighted_boxes_fusion(jnp.asarray(boxes),
                                      jnp.asarray(scores), 0.55, 50,
                                      weight_thresh)
    got = tops.weighted_boxes_fusion(*_t(boxes, scores), 0.55, 50,
                                     weight_thresh)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)
    assert int(got[2].sum()) > 10


def test_greedy_nms_refuses_a_negative_threshold():
    boxes, scores = _t(*_boxes(np.random.default_rng(0), 8)[:2])
    with pytest.raises(ValueError, match="score_threshold"):
        tops.nms(boxes, scores, 0.5, 4, -0.1)


def _loss_inputs(rng, shape=(6, 9)):
    logits = rng.normal(0, 2, shape).astype(np.float32)
    quality = rng.uniform(0, 1, shape).astype(np.float32)
    return logits, quality


@pytest.mark.parametrize("name", ["l1_loss", "smooth_l1_loss"])
def test_l1_losses_match(name):
    rng = np.random.default_rng(2)
    a, b = (rng.normal(0, 1.5, (7, 4)).astype(np.float32) for _ in range(2))
    want = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tlosses, name)(*_t(a, b))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    if name == "smooth_l1_loss":
        want = jlosses.smooth_l1_loss(jnp.asarray(a), jnp.asarray(b), 0.3)
        got = tlosses.smooth_l1_loss(*_t(a, b), 0.3)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_loss_and_grad(fn, x, *rest):
    """The JAX loss and the gradient of its sum in x, one program compiled
    at XLA's level 0 (op by op they cost seconds)."""
    def total(z, *r):
        loss = fn(z, *r)
        return loss.sum(), loss

    grad, loss = jit_o0(jax.grad(total, has_aux=True))(
        *map(jnp.asarray, (x,) + rest))
    return loss, grad


def test_quality_focal_loss_and_its_gradient():
    logits, quality = _loss_inputs(np.random.default_rng(4))
    want, jgrad = _jax_loss_and_grad(
        lambda z, q: jlosses.quality_focal_loss(z, q, 2.0), logits, quality)
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.quality_focal_loss(x, torch.from_numpy(quality), 2.0)
    assert _rel(_np(got), _np(want)) < 1e-6
    got.sum().backward()
    assert _rel(_np(x.grad), _np(jgrad)) < 1e-6


def test_distribution_focal_loss_expectation_and_gradient():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 1.5, (5, 4, 17)).astype(np.float32)
    targets = rng.uniform(0, 16, (5, 4)).astype(np.float32)
    targets[0, :2] = (0.0, 16.0)   # the clamp at both ends
    want, jgrad = _jax_loss_and_grad(jlosses.distribution_focal_loss,
                                     logits, targets)
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.distribution_focal_loss(x, torch.from_numpy(targets))
    assert _rel(_np(got), _np(want)) < 1e-6
    got.sum().backward()
    assert _rel(_np(x.grad), _np(jgrad)) < 1e-6
    want = jit_o0(jlosses.dfl_expectation)(jnp.asarray(logits))
    got = tlosses.dfl_expectation(torch.from_numpy(logits))
    assert _rel(_np(got), _np(want)) < 1e-6


def test_bbox_overlaps_cxcywh_matches():
    rng = np.random.default_rng(9)
    a = np.concatenate([rng.uniform(10, 50, (12, 2)),
                        rng.uniform(2, 20, (12, 2))], 1).astype(np.float32)
    b = np.concatenate([rng.uniform(10, 50, (7, 2)),
                        rng.uniform(2, 20, (7, 2))], 1).astype(np.float32)
    want = jiou.bbox_overlaps_cxcywh(jnp.asarray(a), jnp.asarray(b))
    got = tops.bbox_overlaps_cxcywh(*_t(a, b))
    assert got.shape == (12, 7)
    assert _rel(_np(got), _np(want)) < 1e-6


@pytest.mark.parametrize("name,args", [
    ("xywh_corner_to_xyxy", ()), ("xyxy_to_xywh_corner", ()),
    ("cxcywh_to_xyxy", ()), ("xyxy_to_cxcywh", ()), ("box_area", ()),
    ("clip_boxes", (30, 40)), ("scale_boxes", (0.5, 2.0))])
def test_box_helpers_are_exact(name, args):
    rng = np.random.default_rng(1)
    boxes = rng.uniform(-10, 60, (3, 5, 4)).astype(np.float32)
    want = getattr(jstructs, name)(jnp.asarray(boxes), *args)
    got = getattr(tstructs, name)(torch.from_numpy(boxes), *args)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_convert_box_mode_every_pair():
    rng = np.random.default_rng(12)
    boxes = rng.uniform(0, 60, (6, 4)).astype(np.float32)
    modes = (0, 1, 5)  # XYXY_ABS, XYWH_ABS (center), XYWH_CORNER_ABS
    for a in modes:
        for b in modes:
            want = jstructs.convert_box_mode(
                jnp.asarray(boxes), jstructs.BoxMode(a), jstructs.BoxMode(b))
            got = tstructs.convert_box_mode(
                torch.from_numpy(boxes), tstructs.BoxMode(a),
                tstructs.BoxMode(b))
            np.testing.assert_array_equal(_np(got), _np(want))


def test_gt_instances_and_detections_containers():
    valid = np.zeros((2, 5), bool)
    valid[0, :3] = True
    valid[1, :1] = True
    gt = tstructs.GtInstances(boxes=torch.zeros(2, 5, 4),
                              classes=torch.zeros(2, 5, dtype=torch.int32),
                              valid=torch.from_numpy(valid))
    jgt = jstructs.GtInstances(boxes=jnp.zeros((2, 5, 4)),
                               classes=jnp.zeros((2, 5), jnp.int32),
                               valid=jnp.asarray(valid))
    assert gt.max_boxes == jgt.max_boxes == 5
    np.testing.assert_array_equal(_np(gt.num_valid()), _np(jgt.num_valid()))
    moved = gt.replace(valid=torch.ones(2, 5, dtype=torch.bool))
    assert moved.num_valid().tolist() == [5, 5] and gt.masks is None
    with pytest.raises(Exception):
        gt.valid = None  # frozen, as the JAX dataclass
    empty = tstructs.Detections.empty(7, num_keypoints=17,
                                      mask_shape=(4, 4))
    jempty = jstructs.Detections.empty(7, num_keypoints=17,
                                       mask_shape=(4, 4))
    for f in ("boxes", "scores", "classes", "valid", "masks", "keypoints"):
        assert tuple(getattr(empty, f).shape) == getattr(jempty, f).shape
        assert str(getattr(empty, f).dtype) == f"torch.{getattr(jempty, f).dtype}"
    assert empty.capacity == 7 and int(empty.num_valid()) == 0
