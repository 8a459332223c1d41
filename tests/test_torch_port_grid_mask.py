"""The port's GridMask (``kernels/grid_mask.py``) and its parameter sampler
(``data/device_aug.py``) against the JAX package, on the CPU.

* ``grid_mask_plain`` against ``pallas_grid_mask`` run in interpret mode,
  as ``tests/test_pallas_preprocess.py`` runs it: exact, float32 and uint8,
  modes 0 and 1, several d / keep / offsets, and the identity parameters.
  Both select between the input and zero, so there is no rounding.
* The sampler: its ranges against ``augment.grid_mask`` (the host
  augmentation the parameters stand for), and the mask of the parameters
  that ``augment.grid_mask`` draws from a seeded generator, exact.
* The wrapper takes the plain version for a CPU tensor and refuses other
  devices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov7_d2_tpu.data.transforms import augment
from yolov7_d2_tpu.ops.pallas_preprocess import pallas_grid_mask
from yolov7_d2_tpu_torch.data.device_aug import (
    IDENTITY_GRID,
    sample_grid_mask_params,
)
from yolov7_d2_tpu_torch.kernels import build
from yolov7_d2_tpu_torch.kernels.grid_mask import grid_mask, grid_mask_plain

PARAMS = [
    (8, 4, 0, 0, 0), (8, 4, 0, 0, 1), (7, 4, 3, 5, 1), (5, 1, 4, 0, 0),
    (16, 8, 15, 2, 1), (3, 2, 1, 1, 0), (2, 1, 0, 1, 1), IDENTITY_GRID,
]


def _images(dtype, shape=(len(PARAMS), 24, 40, 3), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(1, 256, shape, dtype=np.uint8)
    return rng.uniform(0.5, 255.0, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_grid_mask_plain_matches_pallas(dtype):
    imgs = _images(dtype)
    params = np.asarray(PARAMS, np.int32)
    want = np.asarray(pallas_grid_mask(jnp.asarray(imgs),
                                       jnp.asarray(params)))
    got = grid_mask_plain(torch.from_numpy(imgs), torch.from_numpy(params))
    assert got.dtype == torch.from_numpy(imgs).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    zeroed = (got.numpy() == 0).all(-1)
    assert zeroed[:-1].any(axis=(1, 2)).all()   # every drawn row masks
    assert not zeroed[-1].any()                 # identity masks nothing


def test_sampler_ranges_match_augment():
    h, w, n = 96, 160, 4000
    gen = torch.Generator().manual_seed(0)
    params = sample_grid_mask_params(gen, n, h, w, prob=0.3, mode=1).numpy()
    assert params.dtype == np.int32 and params.shape == (n, 5)
    drawn = params[:, 0] > 1
    assert abs(drawn.mean() - 0.3) < 0.03
    np.testing.assert_array_equal(params[~drawn],
                                  np.tile(IDENTITY_GRID, ((~drawn).sum(), 1)))
    d, keep, oy, ox, mode = params[drawn].T
    hi = max(min(h, w) // 4, 3)              # augment.grid_mask's bound
    assert d.min() == 2 and d.max() == hi - 1
    np.testing.assert_array_equal(
        keep, np.maximum((d * 0.5 + 0.5).astype(int), 1))
    assert (oy >= 0).all() and (oy < d).all() and (ox >= 0).all() \
        and (ox < d).all()
    assert len(np.unique(oy)) == hi - 1 and (mode == 1).all()


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_params_reproduce_augment_grid_mask(mode, seed):
    """The mask that ``augment.grid_mask`` draws, as parameters."""
    img = _images("uint8", (1, 48, 64, 3), seed)[0]
    want = augment.grid_mask(img, np.random.default_rng(seed), mode=mode)
    rng = np.random.default_rng(seed)        # the same draws, in order
    d = int(rng.integers(2, max(min(img.shape[:2]) // 4, 3)))
    params = [d, max(int(d * 0.5 + 0.5), 1), int(rng.integers(0, d)),
              int(rng.integers(0, d)), mode]
    got = grid_mask_plain(torch.from_numpy(img)[None],
                          torch.tensor([params], dtype=torch.int32))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_wrapper_takes_plain_version_on_cpu_only():
    imgs = torch.from_numpy(_images("float32"))
    params = torch.tensor(PARAMS, dtype=torch.int32)
    build.reset_launches()
    assert torch.equal(grid_mask(imgs, params), grid_mask_plain(imgs, params))
    assert build.LAUNCHES["grid_mask"] == 0
    with pytest.raises(ValueError, match="meta"):
        grid_mask(imgs.to("meta"), params.to("meta"))
