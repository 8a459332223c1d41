"""The port's YOLO blocks against their flax twins
(``yolov7_d2_tpu/models/layers/blocks.py``), in float32 on the CPU.

Weights come from the flax init with random BatchNorm statistics and move to
torch through ``jax_to_torch_state_dict``. Tolerance: 1e-5 max abs error, as
XLA-CPU and oneDNN sum each convolution in a different order (float32, values
of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    block_name_mapper,
    load_into,
    nchw_to_nhwc,
    nhwc_to_nchw,
    randomize_bn,
)
from yolov7_d2_tpu.models.layers import blocks as jb
from yolov7_d2_tpu_torch.models.layers import blocks as tb

ATOL = 1e-5


def _compare(jax_module, torch_module, shape, seed=0, atol=ATOL):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    variables = jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = randomize_bn(variables, rng)
    ref = np.asarray(jax_module.apply(variables, jnp.asarray(x)))
    load_into(torch_module, variables, block_name_mapper)
    with torch.no_grad():
        got = nchw_to_nhwc(torch_module(nhwc_to_nchw(x)))
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= atol, err


@pytest.mark.parametrize("ksize,stride,groups", [
    (1, 1, 1), (3, 1, 1), (3, 2, 1), (3, 1, 8),
])
def test_base_conv(ksize, stride, groups):
    _compare(jb.BaseConv(16, ksize, stride, groups=groups),
             tb.BaseConv(8, 16, ksize, stride, groups=groups), (2, 12, 12, 8))


@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv(stride):
    _compare(jb.DWConv(16, 3, stride), tb.DWConv(8, 16, 3, stride),
             (2, 12, 12, 8))


@pytest.mark.parametrize("shortcut,depthwise", [
    (True, False), (False, False), (True, True),
])
def test_bottleneck(shortcut, depthwise):
    _compare(jb.Bottleneck(8, shortcut=shortcut, depthwise=depthwise),
             tb.Bottleneck(8, 8, shortcut, depthwise=depthwise),
             (2, 10, 10, 8))


def test_spp_bottleneck():
    # the JAX block runs the cascade of 5-pools, the port the 5/9/13 pools
    _compare(jb.SPPBottleneck(16), tb.SPPBottleneck(16, 16), (2, 13, 13, 16))


@pytest.mark.parametrize("n,shortcut", [(1, True), (2, False)])
def test_csp_layer(n, shortcut):
    _compare(jb.CSPLayer(16, n=n, shortcut=shortcut),
             tb.CSPLayer(8, 16, n=n, shortcut=shortcut), (2, 10, 10, 8))


@pytest.mark.parametrize("fold", [True, False])
def test_focus_plain_matches_jax(fold):
    # the JAX default folds the space-to-depth into a 6x6 stride-2 conv over
    # the same 12-channel kernel; the port keeps the plain form
    _compare(jb.Focus(16, ksize=3, fold=fold), tb.Focus(3, 16, ksize=3),
             (2, 16, 16, 3))


def test_space_to_depth_group_order():
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    y = tb.space_to_depth(x)
    # groups (tl, bl, tr, br) of the top-left 2x2 patch
    assert y[0, :, 0, 0].tolist() == [0.0, 4.0, 1.0, 5.0]


@pytest.mark.parametrize("name", ["silu", "relu", "lrelu", "gelu", "mish",
                                  "identity"])
def test_activation(name):
    x = np.random.default_rng(1).normal(0, 3, (257,)).astype(np.float32)
    ref = np.asarray(jb.get_activation(name)(jnp.asarray(x)))
    got = tb.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_batchnorm_train_statistics_match():
    """BN momentum: flax 0.97 is torch 0.03, with torch's unbiased running
    variance on both sides, after one train-mode forward."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (4, 6, 6, 8)).astype(np.float32)
    jm, tm = jb.BaseConv(16, 3), tb.BaseConv(8, 16, 3)
    variables = randomize_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                             rng)
    _, new = jm.apply(variables, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    load_into(tm, variables, block_name_mapper).train()
    with torch.no_grad():
        tm(nhwc_to_nchw(x))
    stats = new["batch_stats"]["bn"]
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)
