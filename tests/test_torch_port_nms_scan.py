"""The NMS kernel's algorithm (``yolov7_d2_tpu_torch/csrc/nms.cu``) on the
CPU, where the kernel cannot run.

``tiled_scan_nms`` is a test-only emulation, in plain PyTorch and numpy, of
the kernel's four steps: a 64-bit key a candidate (the inverted bits of a
positive score, then the index), the sort, the scan in tiles (a tile against
the kept boxes, then its own rows resolved in order, cut at ``max_out``),
and the padding. It is held index-exact against the plain version
``nms_batched_plain``, the JAX ``ops/nms.py`` ``nms_batched`` and the
Pallas ``pallas_batched_nms`` run in interpret mode, at the kernel's tile of
32 and at 8, where more tile boundaries fall inside the inputs. The IoU is
the port's ``elementwise_box_iou``, the same IEEE float32 operations as the
plain version and the kernel, so no tolerance applies.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from yolov7_d2_tpu.ops.nms import nms_batched as jax_nms_batched
from yolov7_d2_tpu.ops.pallas_nms import pallas_batched_nms
from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
from yolov7_d2_tpu_torch.ops.iou import elementwise_box_iou
from yolov7_d2_tpu_torch.ops.nms import _class_offset_boxes

DEAD = np.uint64(0xFFFFFFFF)


def tiled_scan_nms(boxes, scores, thr, max_out, tile=32):
    """boxes [B, K, 4], scores [B, K] float32 -> (keep_idx [B, max_out]
    int32 with -1 padding, keep_valid bool), as csrc/nms.cu computes them."""
    b, k, _ = boxes.shape
    keep_idx = torch.full((b, max_out), -1, dtype=torch.int32)
    keep_valid = torch.zeros((b, max_out), dtype=torch.bool)
    for i in range(b):
        # 1. key: larger score first, then the lower index; dead ones last
        s = scores[i].numpy()
        live = s > 0
        hi = np.where(live, ~s.view(np.uint32), DEAD).astype(np.uint64)
        keys = (hi << np.uint64(32)) | np.arange(k, dtype=np.uint64)
        n_live = int(live.sum())
        # 2. sort, then gather the boxes by sorted position
        order = (np.sort(keys) & DEAD).astype(np.int64)[:n_live]
        sb = boxes[i][torch.from_numpy(order)]
        # 3. scan in tiles
        kept = []
        for base in range(0, n_live, tile):
            if len(kept) >= max_out:
                break
            cand = sb[base:base + tile]
            count = cand.shape[0]
            supp = torch.zeros(count, dtype=torch.bool)
            if kept:  # the tile against the kept boxes, a kept box the row
                supp = (elementwise_box_iou(sb[kept][:, None], cand[None])
                        > thr).any(0)
            # column j: the earlier candidates i of the tile that suppress
            # j if kept; from "every alive one kept", the kernel repeats
            # "j kept iff alive and no kept one in its column" until it
            # stops changing
            j = torch.arange(count)
            cols = ((elementwise_box_iou(cand[:, None], cand[None]) > thr)
                    & (j[:, None] < j[None])).T.tolist()
            alive = (~supp).tolist()
            tile_kept = alive
            while True:
                nxt = [a and not any(c and k for c, k in zip(col, tile_kept))
                       for a, col in zip(alive, cols)]
                if nxt == tile_kept:
                    break
                tile_kept = nxt
            kept += [base + r for r in range(count)
                     if tile_kept[r]][:max_out - len(kept)]
        # 4. the rest is padding
        keep_idx[i, :len(kept)] = torch.from_numpy(order[kept]).int()
        keep_valid[i, :len(kept)] = True
    return keep_idx, keep_valid


def _clustered(rng, b, k, classes=80, tie_every=5, zeros=64):
    """Boxes in clusters of 8 in a 640 frame, as chip_smoke.py makes them."""
    centers = rng.uniform(0, 640, (b, k // 8 + 1, 2)).repeat(8, 1)[:, :k]
    centers = centers + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(8, 120, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = rng.uniform(0.0, 1.0, (b, k))
    if tie_every:
        n_tied = scores[:, 1::tie_every].shape[1]
        scores[:, 1::tie_every] = scores[:, ::tie_every][:, :n_tied]
    scores[:, :zeros] = 0.0
    cls = rng.integers(0, classes, (b, k))
    return boxes, scores, cls


def _grid_boxes(k, size=10.0, gap=20.0):
    """k disjoint boxes on a grid of 8 columns."""
    pos = np.arange(k)
    x0, y0 = (pos % 8) * gap, (pos // 8) * gap
    return np.stack([x0, y0, x0 + size, y0 + size], -1)


def _case_inputs(name):
    """(boxes [B, K, 4], scores [B, K], classes [B, K], thr, max_out)."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "clustered_80_classes":
        return (*_clustered(rng, 2, 1024), 0.65, 100)
    if name == "single_class_heavy":
        # 1024 boxes crowded around one point: the scan runs through every
        # tile, since fewer than max_out survive
        centers = rng.uniform(200, 440, (1, 1024, 2))
        wh = rng.uniform(40, 160, (1, 1024, 2))
        boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
        return (boxes, rng.uniform(0.01, 1.0, (1, 1024)),
                np.zeros((1, 1024), np.int64), 0.3, 100)
    if name == "ties_across_tiles":
        # one score for all: the order is the index order. Candidates 7 / 8
        # and 31 / 32 straddle a tile boundary (of 8 and of 32) with the
        # same box, 20 / 40 are the same box far apart: the lower index wins
        boxes = _grid_boxes(64)
        for lo, hi in ((7, 8), (31, 32), (20, 40), (15, 16)):
            boxes[hi] = boxes[lo]
        scores = np.full((1, 64), 0.5)
        scores[0, 48:] = 0.25  # a second tied group, after the first
        boxes[49] = boxes[56]
        return boxes[None], scores, np.zeros((1, 64), np.int64), 0.5, 64
    if name == "zero_and_negative_scores":
        boxes, scores, cls = _clustered(rng, 2, 200, classes=3, zeros=0)
        scores[:, ::3] = -scores[:, ::3]
        scores[:, 1::7] = 0.0
        scores[0, 2] = -0.0
        scores[1, 5] = np.float32(1e-45)  # the least positive float
        return boxes, scores, cls, 0.5, 100
    if name == "iou_at_threshold":
        # inter 1, union 2 + 1 - 1 (+1e-9 lost in float32): IoU 0.5 exactly,
        # which must not suppress at 0.5
        boxes = np.array([[[0, 0, 2, 1], [0, 0, 1, 1]]], np.float64)
        return (boxes, np.array([[0.9, 0.8]]), np.zeros((1, 2), np.int64),
                0.5, 4)
    if name == "k1":
        return (*_clustered(rng, 3, 1, classes=2, zeros=0), 0.5, 5)
    if name == "k33":
        return (*_clustered(rng, 2, 33, classes=2, zeros=3), 0.3, 20)
    if name == "max_out_1":
        return (*_clustered(rng, 2, 300, classes=4, zeros=10), 0.5, 1)
    if name == "rpn_1280":
        # Mask R-CNN's RPN: 5 levels of 256 candidates, one class, 0.7, 128
        # out (the kernel's 2048 instance); a twentieth of them dead
        boxes, scores, _ = _clustered(rng, 2, 1280, classes=1, zeros=64)
        return boxes, scores, np.zeros((2, 1280), np.int64), 0.7, 128
    if name == "max_out_above_live":
        boxes, scores, cls = _clustered(rng, 2, 50, classes=2, zeros=40)
        return boxes, scores, cls, 0.65, 64
    raise KeyError(name)


CASES = ["clustered_80_classes", "single_class_heavy", "ties_across_tiles",
         "zero_and_negative_scores", "iou_at_threshold", "k1", "k33",
         "max_out_1", "max_out_above_live", "rpn_1280"]


@functools.lru_cache(maxsize=None)
def _case(name):
    """The class-offset inputs (span per image, as pallas_batched_nms takes
    it) and the three references' results."""
    boxes, scores, cls, thr, max_out = _case_inputs(name)
    boxes = boxes.astype(np.float32)
    scores = scores.astype(np.float32)
    cls = cls.astype(np.int32)
    shifted = torch.cat([
        _class_offset_boxes(torch.from_numpy(boxes[i:i + 1]),
                            torch.from_numpy(cls[i:i + 1]))
        for i in range(len(boxes))])
    scores_t = torch.from_numpy(scores)
    refs = {"plain": nms_batched_plain(shifted, scores_t, thr, max_out)}
    idx, valid = jax_nms_batched(jnp.asarray(shifted.numpy()),
                                 jnp.asarray(scores), thr, max_out)
    refs["jax"] = (np.asarray(idx), np.asarray(valid))
    pallas = [pallas_batched_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                 jnp.asarray(cls[i]), thr, max_out)
              for i in range(len(boxes))]
    refs["pallas"] = (np.stack([np.asarray(p[0]) for p in pallas]),
                      np.stack([np.asarray(p[1]) for p in pallas]))
    return shifted, scores_t, thr, max_out, refs


@pytest.mark.parametrize("tile", [32, 8])
@pytest.mark.parametrize("name", CASES)
def test_tiled_scan_matches_references(name, tile):
    shifted, scores, thr, max_out, refs = _case(name)
    idx, valid = tiled_scan_nms(shifted, scores, thr, max_out, tile)
    for ref, (ref_idx, ref_valid) in refs.items():
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid),
                                      err_msg=ref)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx),
                                      err_msg=ref)
    kept = valid.sum(1)
    if name == "single_class_heavy":
        assert 0 < int(kept.max()) < max_out  # every tile was scanned
    if name == "ties_across_tiles":
        assert not np.isin([8, 32, 40, 16, 56], idx.numpy()).any()
        assert np.isin([7, 31, 20, 15, 49], idx.numpy()).all()
    if name == "iou_at_threshold":
        assert idx[0, :2].tolist() == [0, 1] and int(kept[0]) == 2
    if name in ("clustered_80_classes", "max_out_1"):
        assert bool(valid.all())  # max_out reached in every image
    if name == "max_out_above_live":
        assert (kept <= 10).all() and not bool(valid[:, 10:].any())


@settings(max_examples=50, deadline=None)
@given(data=st.data(), k=st.integers(1, 40), max_out=st.integers(1, 48),
       thr=st.sampled_from([0.0, 0.3, 0.5, 0.65]),
       tile=st.sampled_from([1, 8, 32]))
def test_tiled_scan_property(data, k, max_out, thr, tile):
    """Small integer boxes (exact ties of IoU and of score) on a 6 x 6
    grid, scores from a few values with zeros and negatives."""
    ints = st.integers(0, 6)
    corners = data.draw(st.lists(st.tuples(ints, ints, ints, ints),
                                 min_size=k, max_size=k))
    boxes = torch.tensor([[min(a, c), min(b, d), max(a, c), max(b, d)]
                          for a, b, c, d in corners],
                         dtype=torch.float32)[None]
    scores = torch.tensor(data.draw(st.lists(
        st.sampled_from([-0.5, 0.0, 0.25, 0.5, 0.75, 1.0]),
        min_size=k, max_size=k)), dtype=torch.float32)[None]
    got = tiled_scan_nms(boxes, scores, thr, max_out, tile)
    want = nms_batched_plain(boxes, scores, thr, max_out)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
