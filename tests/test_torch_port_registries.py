"""The port's backbone, neck and head registries against the JAX
package's (``core/registry.py:79-81``): the same names, and each builder,
given one small merged config in both packages, builds a module with the
JAX module's output features (names and shapes; the JAX side by
``jax.eval_shape``, so nothing of it compiles). The parameter counts are
held here for the necks and the head, which no family test counts alone;
the backbones' counts are held by their families' tests and
``test_torch_port_mobile_backbones.py``.

The backbone zoo has one table: ``ZOO_BACKBONES`` is the registry's view.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import shape_only_deform_sampling
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.core import registry as jreg
from yolov7_d2_tpu.models import build as _jax_build  # noqa: F401
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models import registries as treg
from yolov7_d2_tpu_torch.models.backbones.zoo import ZOO_BACKBONES

# a small config in both packages: YOLO widths and depths cut, the FPN and
# BiFPN narrow, the ResNets at depth 18, DLA's trunk levels raw (its DLAUp
# is the DLAUp builder's); every other key at its default
SMALL = ["MODEL.YOLO.WIDTH_MUL", 0.25, "MODEL.YOLO.DEPTH_MUL", 0.33,
         "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.BIFPN.OUT_CHANNELS", 32,
         "MODEL.BIFPN.NUM_BIFPN", 2, "MODEL.DARKNET.STEM_OUT_CHANNELS", 16,
         "MODEL.RESNETS.DEPTH", 18, "MODEL.DLA.USE_DLA_UP", False,
         "MODEL.DLA.MS_OUTPUT", True,
         "MODEL.DLA.OUT_FEATURES", ["dla3", "dla4", "dla5"]]
# the input size a backbone needs (MobileViT unfolds 2 x 2 patches of its
# 1/64 map); 64 px otherwise
SIZE = {"build_mobilevit_backbone": 128}
# a neck's input: channels (strides 8, 16, 32) and the image size
NECK_IN = {"build_yolo_pafpn": ((64, 128, 256), 64),
           "build_yolo_fpn": ((32, 64, 128), 64),
           "build_bifpn": ((32, 64, 128), 128),
           "build_reppan": ((32, 64, 128), 64),
           "build_ppyolo_pan": ((32, 64, 128), 64)}
HEAD_IN = 32   # the FPN's width the semantic head reads, p2..p5 of 64 px

REGISTRIES = {"BACKBONE": (jreg.BACKBONE_REGISTRY, treg.BACKBONE_REGISTRY),
              "NECK": (jreg.NECK_REGISTRY, treg.NECK_REGISTRY),
              "HEAD": (jreg.HEAD_REGISTRY, treg.HEAD_REGISTRY)}


@pytest.fixture(scope="module")
def cfgs():
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(list(SMALL))
    return jcfg, tcfg


@pytest.mark.parametrize("kind", list(REGISTRIES))
def test_the_port_registry_holds_every_jax_name(kind):
    jax_registry, port_registry = REGISTRIES[kind]
    assert len(jax_registry) == {"BACKBONE": 23, "NECK": 5,
                                 "HEAD": 1}[kind]
    assert sorted(port_registry.keys()) == sorted(jax_registry.keys())


def test_zoo_table_is_the_registry_view():
    assert set(ZOO_BACKBONES) < set(treg.BACKBONE_REGISTRY.keys())
    for name, (kind, from_spec) in ZOO_BACKBONES.items():
        entry = treg.BACKBONE_REGISTRY.get(name)
        assert (entry.kind, entry.from_spec) == (kind, from_spec)
    assert len(ZOO_BACKBONES) == 8


def _shapes(tree):
    """{name: NHWC shape} of a dict or a tuple of outputs."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: tuple(v.shape) for k, v in items}


def _nhwc(tree):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: tuple(v.permute(0, 2, 3, 1).shape) if v.dim() == 4
            else tuple(v.shape) for k, v in items}


def _jax_out(jmodel, *args):
    shapes = jax.eval_shape(
        lambda *a: jmodel.init_with_output(jax.random.PRNGKey(0), *a),
        *args)
    return shapes[0], shapes[1]


def _count(variables):
    return {coll: sum(int(np.prod(v.shape))
                      for v in jax.tree_util.tree_leaves(
                          variables.get(coll, {})))
            for coll in ("params", "batch_stats")}


def _port_count(model):
    stats = sum(v.numel() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var")))
    return {"params": sum(p.numel() for p in model.parameters()),
            "batch_stats": stats}


@pytest.mark.parametrize("name", sorted(jreg.BACKBONE_REGISTRY.keys()))
def test_backbone_builder_gives_the_jax_features(name, cfgs):
    jcfg, tcfg = cfgs
    size = SIZE.get(name, 64)
    with shape_only_deform_sampling():
        want, _ = _jax_out(jreg.BACKBONE_REGISTRY.get(name)(jcfg),
                           jnp.zeros((1, size, size, 3), jnp.float32))
    model = treg.BACKBONE_REGISTRY.get(name)(tcfg).eval()
    with torch.no_grad():
        got = model(torch.zeros(1, 3, size, size))
    assert _nhwc(got) == _shapes(want)


@pytest.mark.parametrize("name", sorted(jreg.NECK_REGISTRY.keys()))
def test_neck_builder_gives_the_jax_features(name, cfgs):
    jcfg, tcfg = cfgs
    channels, size = NECK_IN[name]
    # two images: torch's GroupNorm refuses one value a channel (BiFPN's
    # 1 x 1 P7 of one image)
    shapes = [(2, size // s, size // s, c)
              for s, c in zip((8, 16, 32), channels)]
    want, variables = _jax_out(jreg.NECK_REGISTRY.get(name)(jcfg),
                               [jnp.zeros(s, jnp.float32) for s in shapes])
    builder = treg.NECK_REGISTRY.get(name)
    model = (builder(tcfg, in_channels=channels) if name == "build_yolo_fpn"
             else builder(tcfg, feat_channels=channels)).eval()
    with torch.no_grad():
        got = model([torch.zeros(s).permute(0, 3, 1, 2) for s in shapes])
    assert _nhwc(got) == _shapes(want)
    assert _port_count(model) == _count(variables)


def test_head_builder_gives_the_jax_features(cfgs):
    jcfg, tcfg = cfgs
    name, = jreg.HEAD_REGISTRY.keys()
    strides = (4, 8, 16, 32)
    shapes = [(1, 64 // s, 64 // s, HEAD_IN) for s in strides]
    jhead = jreg.HEAD_REGISTRY.get(name)(jcfg)
    shapes_out = jax.eval_shape(
        lambda f: jhead.init_with_output(jax.random.PRNGKey(0), f, strides),
        [jnp.zeros(s, jnp.float32) for s in shapes])
    model = treg.HEAD_REGISTRY.get(name)(tcfg, in_channels=HEAD_IN).eval()
    with torch.no_grad():
        got = model([torch.zeros(s).permute(0, 3, 1, 2) for s in shapes])
    # both return NHWC logits
    assert tuple(got.shape) == tuple(shapes_out[0].shape)
    assert _port_count(model) == _count(shapes_out[1])
