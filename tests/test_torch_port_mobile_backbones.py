"""The registry's backbones that no yaml sets, against the JAX package on
the CPU: MobileViT (``build_mobilevit_backbone``), CSPResNet50d
(``build_cspresnet50d_backbone``) and FBNet under the FPN
(``FBNetV2FpnBackbone``), each built by both packages' registry from one
merged config.

Each port module takes the JAX variables (drawn with numpy) through the
weight carrier (``jax_to_torch_state_dict`` with ``BACKBONE_MAPS``); its
parameter and statistic counts are the JAX init's, and the float32
forward agrees with the JAX one within 1e-4 of each output's largest
value. MobileViT runs at 128 px, its least size in both packages (its last
block unfolds 2 x 2 patches of the 1/64 map); the others at 64 px.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    flax_variables_like,
    jit_o0,
    load_into,
    nchw_to_nhwc,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.core.registry import BACKBONE_REGISTRY as JAX_BACKBONES
from yolov7_d2_tpu.models import build as _jax_build  # noqa: F401
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.registries import BACKBONE_REGISTRY
from yolov7_d2_tpu_torch.utils.weight_port import BACKBONE_MAPS

# registry name -> (the carrier's backbone type, px, config overrides)
CASES = {
    "build_mobilevit_backbone": ("mobilevit", 128, []),
    "build_cspresnet50d_backbone": (
        "cspresnet50d", 64,
        ["MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"]]),
    "FBNetV2FpnBackbone": (
        "fbnet_fpn", 64,
        ["MODEL.FBNET_V2.ARCH", "FBNetV3_A", "MODEL.FPN.IN_FEATURES",
         ["trunk1", "trunk2", "trunk3"], "MODEL.FPN.OUT_CHANNELS", 64]),
}


def _cfgs(opts):
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(list(opts))
    return jcfg, tcfg


@pytest.mark.parametrize("name", list(CASES))
def test_backbone_takes_the_jax_parameters_and_matches(name):
    kind, size, opts = CASES[name]
    jcfg, tcfg = _cfgs(opts)
    rng = np.random.default_rng(len(name))
    images = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jmodel = JAX_BACKBONES.get(name)(jcfg)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = load_into(BACKBONE_REGISTRY.get(name)(tcfg).eval(), variables,
                       BACKBONE_MAPS[kind])
    counts = {coll: sum(int(np.prod(v.shape))
                        for v in jax.tree_util.tree_leaves(variables[coll]))
              for coll in ("params", "batch_stats")}
    stats = sum(v.numel() for k, v in tmodel.state_dict().items()
                if k.endswith(("running_mean", "running_var")))
    assert sum(p.numel() for p in tmodel.parameters()) == counts["params"]
    assert stats == counts["batch_stats"]

    want = jit_o0(lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                                images)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) and len(got) >= 3
    for key, w in want.items():
        w = np.asarray(w)
        g = nchw_to_nhwc(got[key])
        assert g.shape == w.shape, key
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key
    if hasattr(tmodel, "out_channels"):
        assert {k: v.shape[-1] for k, v in want.items()} == {
            k: tmodel.out_channels[k] for k in want}
