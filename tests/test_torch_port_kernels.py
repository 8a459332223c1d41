"""The plain versions of the port's two kernels against the JAX package.

* NMS (``yolov7_d2_tpu_torch/kernels/nms.py``): index-exact against the XLA
  ``batched_nms_batched`` and against the Pallas ``pallas_batched_nms`` run
  in interpret mode. Both sides do the same IEEE float32 operations in the
  same order, so no tolerance applies.
* Normalize (``kernels/preprocess.py``): bit-exact against
  ``reference_normalize`` and the Pallas ``fused_normalize`` (interpret).

The kernels themselves are held against their plain versions on the card by
``tests/test_torch_port_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov7_d2_tpu.ops.nms import batched_nms_batched as jax_batched_nms
from yolov7_d2_tpu.ops.pallas_nms import pallas_batched_nms
from yolov7_d2_tpu.ops.pallas_preprocess import (
    fused_normalize,
    reference_normalize,
)
from yolov7_d2_tpu_torch.kernels import build
from yolov7_d2_tpu_torch.kernels.nms import nms_batched, nms_batched_plain
from yolov7_d2_tpu_torch.kernels.preprocess import (
    normalize_images,
    normalize_images_plain,
)
from yolov7_d2_tpu_torch.ops.nms import batched_nms_batched

PIXEL_MEAN = (103.53, 116.28, 123.675)  # config/defaults.py:36
PIXEL_STD = (57.375, 57.12, 58.395)


def _boxes(rng, b, n, classes=80, tie_every=0):
    """Clustered xyxy boxes in a 640 frame, scores, classes; ``tie_every``
    copies every such score onto its neighbour to make argmax ties."""
    centers = rng.uniform(0, 640, (b, n // 8 + 1, 2)).repeat(8, 1)[:, :n]
    centers = centers + rng.normal(0, 6, (b, n, 2))
    wh = rng.uniform(8, 120, (b, n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = rng.uniform(0.0, 1.0, (b, n))
    if tie_every:
        n_tied = scores[:, 1::tie_every].shape[1]
        scores[:, 1::tie_every] = scores[:, ::tie_every][:, :n_tied]
    cls = rng.integers(0, classes, (b, n))
    return (boxes.astype(np.float32), scores.astype(np.float32),
            cls.astype(np.int32))


def _port_batched(boxes, scores, cls, thr, max_out):
    idx, valid = batched_nms_batched(torch.from_numpy(boxes),
                                     torch.from_numpy(scores),
                                     torch.from_numpy(cls), thr, max_out)
    return idx.numpy(), valid.numpy()


@pytest.mark.parametrize("seed,thr", [(0, 0.65), (1, 0.5), (2, 0.3)])
def test_nms_plain_matches_xla_batched(seed, thr):
    rng = np.random.default_rng(seed)
    boxes, scores, cls = _boxes(rng, 2, 1024, tie_every=5)
    scores[:, rng.integers(0, 1024, 200)] = 0.0  # padded slots
    ref_idx, ref_valid = jax_batched_nms(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         jnp.asarray(cls), thr, 100)
    idx, valid = _port_batched(boxes, scores, cls, thr, 100)
    np.testing.assert_array_equal(valid, np.asarray(ref_valid))
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    assert valid.all()  # 1024 clustered boxes keep more than 100


def test_nms_plain_single_class_heavy_suppression():
    rng = np.random.default_rng(7)
    # 512 large boxes crowded around one point: most overlap
    centers = rng.uniform(100, 160, (2, 512, 2))
    wh = rng.uniform(40, 80, (2, 512, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 512)).astype(np.float32)
    cls = np.zeros((2, 512), np.int32)
    ref_idx, ref_valid = jax_batched_nms(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         jnp.asarray(cls), 0.2, 100)
    idx, valid = _port_batched(boxes, scores, cls, 0.2, 100)
    np.testing.assert_array_equal(valid, np.asarray(ref_valid))
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    assert 0 < valid.sum() < 200  # fewer survivors than max_out


def _pallas_cases():
    rng = np.random.default_rng(11)
    cases = {}
    b, s, c = _boxes(rng, 1, 256, classes=5, tie_every=3)
    cases["ties"] = (b[0], s[0], c[0], 0.5, 64)
    b, s, c = _boxes(rng, 1, 128, classes=3)
    cases["all_zero_scores"] = (b[0], np.zeros_like(s[0]), c[0], 0.5, 16)
    b, s, c = _boxes(rng, 1, 64, classes=2)
    s[0, 10:] = 0.0  # 10 live candidates, 32 outputs
    cases["fewer_than_max_out"] = (b[0], s[0], c[0], 0.65, 32)
    b, s, c = _boxes(rng, 1, 200, classes=80)
    cases["random_80_classes"] = (b[0], s[0], c[0], 0.65, 100)
    # one box duplicated: IoU exactly 1 with itself, equal scores
    b = np.tile(np.array([[10, 10, 50, 50]], np.float32), (8, 1))
    cases["exact_duplicates"] = (b, np.full(8, 0.5, np.float32),
                                 np.zeros(8, np.int32), 0.65, 8)
    return cases


_PALLAS = _pallas_cases()


@pytest.mark.parametrize("case", sorted(_PALLAS))
def test_nms_plain_matches_pallas_interpret(case):
    boxes, scores, cls, thr, max_out = _PALLAS[case]
    ref_idx, ref_valid = pallas_batched_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), thr,
        max_out)
    idx, valid = _port_batched(boxes[None], scores[None], cls[None], thr,
                               max_out)
    np.testing.assert_array_equal(valid[0], np.asarray(ref_valid))
    np.testing.assert_array_equal(idx[0], np.asarray(ref_idx))


def test_nms_wrapper_takes_plain_version_on_cpu_only():
    rng = np.random.default_rng(5)
    boxes, scores, _ = _boxes(rng, 2, 64)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = build.LAUNCHES["nms"]
    for got, want in zip(nms_batched(b, s, 0.5, 10),
                         nms_batched_plain(b, s, 0.5, 10)):
        assert torch.equal(got, want)
    assert build.LAUNCHES["nms"] == before  # the plain version launches nothing
    with pytest.raises(ValueError):
        nms_batched(b.to("meta"), s.to("meta"), 0.5, 10)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stats", ["identity", "pixel"])
def test_normalize_plain_bit_exact_against_jax(out_dtype, stats):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    mean, std = ((0.0,) * 3, (1.0,) * 3) if stats == "identity" \
        else (PIXEL_MEAN, PIXEL_STD)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    jm, js = jnp.asarray(mean, jnp.float32), jnp.asarray(std, jnp.float32)
    ref = np.asarray(reference_normalize(jnp.asarray(imgs), jm, js, jdt))
    pallas = np.asarray(fused_normalize(jnp.asarray(imgs), jm, js,
                                        out_dtype=jdt, block_rows=32))
    out = normalize_images_plain(torch.from_numpy(imgs), mean, std, tdt)
    assert out.shape == (2, 3, 64, 48) and out.dtype == tdt
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = out.permute(0, 2, 3, 1).float().numpy()
    # bit-exact: compare the float32 images of the values, which are exact
    # for both output dtypes
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    np.testing.assert_array_equal(got, pallas.astype(np.float32))


def test_normalize_wrapper_takes_plain_version_on_cpu_only():
    imgs = torch.randint(0, 256, (1, 32, 32, 3), dtype=torch.uint8)
    before = build.LAUNCHES["normalize"]
    assert torch.equal(normalize_images(imgs, PIXEL_MEAN, PIXEL_STD),
                       normalize_images_plain(imgs, PIXEL_MEAN, PIXEL_STD))
    assert build.LAUNCHES["normalize"] == before
    with pytest.raises(ValueError):
        normalize_images(imgs.to("meta"), PIXEL_MEAN, PIXEL_STD)
