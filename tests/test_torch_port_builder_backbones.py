"""Every registered backbone under the builders that take any name: YOLOX
(JAX ``meta_arch/yolox.py:177-199``), YOLOV7 and YOLOV7P (JAX
``meta_arch/yolov7.py:301-304``, ``:328-331``) and the d2go DETR (JAX
``meta_arch/detr_variants.py:686-689``, any name without "resnet" through
the registry), against the JAX builders.

* each pairing that the port's builders took from the registry's one table
  (``models/registries.build_backbone``) in this slice: the parameter and
  BatchNorm-statistic counts of the port's model against the JAX model's
  (``jax.eval_shape`` of its init, 128 px; nothing of JAX compiles), from
  one small merged config in both packages (ResNets at depth 18, YOLO
  widths at 0.25, the FPN at 32 channels, DETR's tiny transformer), with
  ``MODEL.YOLO.IN_FEATURES`` naming three of the backbone's outputs;
* three pairings forward through the weight carrier (flax variables drawn
  with numpy, moved by ``jax_to_torch_state_dict``), float32, eval mode:
  the head outputs within 1e-4 of each output's largest magnitude (at
  least 1; XLA-CPU and oneDNN sum each convolution in another order);
* an unregistered name raises in both packages, and the port's message
  names it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    DETR_TINY_OPTS,
    REPO,
    flax_variables_like,
    jit_o0,
    load_into,
    shape_only_deform_sampling,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import config_from_cfg
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.utils import weight_port as twp

TOL = 1e-4
SMALL = {"MODEL.YOLO.WIDTH_MUL": 0.25, "MODEL.YOLO.DEPTH_MUL": 0.33,
         "MODEL.YOLO.CLASSES": 3, "MODEL.FPN.OUT_CHANNELS": 32,
         "MODEL.RESNETS.DEPTH": 18, "SOLVER.AMP.ENABLED": False}
D2GO_YAML = REPO / "configs" / "coco" / "detr" / "d2go" / "detr_bs16.yaml"

# registered name -> the three outputs the YOLO necks take (strides 8-32)
FEATURES = {
    "build_resnet_backbone": ("res3", "res4", "res5"),
    "build_resnet_vd_backbone": ("res3", "res4", "res5"),
    "build_res2net_backbone": ("res3", "res4", "res5"),
    "build_cspresnet50d_backbone": ("res3", "res4", "res5"),
    "build_resnet_fpn_backbone": ("p3", "p4", "p5"),
    "FBNetV2FpnBackbone": ("p3", "p4", "p5"),
    "build_darknet_backbone": ("dark3", "dark4", "dark5"),
    "build_cspdarknet_backbone": ("dark3", "dark4", "dark5"),
    "build_yolov5_backbone": ("c3", "c4", "c5"),
    "build_efficientrep_backbone": ("erep3", "erep4", "erep5"),
    "build_efficientrep_tiny_backbone": ("erep3", "erep4", "erep5"),
    "build_swin_transformer_backbone": ("stage1", "stage2", "stage3"),
    "build_pvt_v2_backbone": ("stage1", "stage2", "stage3"),
    "build_mobilevit_backbone": ("stage2", "stage3", "stage4"),
}
# the pairings the port refused before this slice (ROADMAP.md C.45): YOLOX
# on every registered name outside CSPDarknet-X and the zoo, YOLOV7 /
# YOLOV7P on the four outside their tables, the d2go DETR on every name
# outside the zoo and CSPDarknet-X (the ones with "resnet" build its own
# ResNet, as in JAX)
PAIRINGS = ([("YOLOX", n) for n in FEATURES]
            + [(arch, n) for arch in ("YOLOV7", "YOLOV7P")
               for n in ("build_cspresnet50d_backbone", "FBNetV2FpnBackbone",
                         "build_resnet_fpn_backbone",
                         "build_mobilevit_backbone")]
            + [("DetrD2go", n) for n in FEATURES
               if n not in ("build_resnet_backbone",
                            "build_resnet_vd_backbone")])


def _cfgs(arch, name, **extra):
    """(port CfgNode, JAX CfgNode) of ``arch`` on ``name``."""
    opts = dict(SMALL, **{
        "MODEL.META_ARCHITECTURE": arch, "MODEL.BACKBONE.NAME": name,
        "MODEL.YOLO.IN_FEATURES": list(FEATURES.get(
            name, ("dark3", "dark4", "dark5")))}, **extra)
    cfgs = []
    for fn in (get_cfg, jax_get_cfg):
        cfg = fn()
        if arch == "DetrD2go":
            cfg.merge_from_file(str(D2GO_YAML))
            cfg.merge_from_list([x for kv in DETR_TINY_OPTS.items()
                                 for x in kv])
        for k, v in opts.items():
            node = cfg
            *parents, leaf = k.split(".")
            for p in parents:
                node = node[p]
            node[leaf] = v
        cfgs.append(cfg)
    return cfgs


def _counts(shapes):
    return tuple(sum(int(np.prod(s.shape)) for s in
                     jax.tree_util.tree_leaves(shapes.get(coll, {})))
                 for coll in ("params", "batch_stats"))


def _port_counts(model):
    stats = sum(v.numel() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var")))
    return sum(p.numel() for p in model.parameters()), stats


@pytest.mark.parametrize("arch,name", PAIRINGS)
def test_pairing_builds_with_the_jax_counts(arch, name):
    cfg, jcfg = _cfgs(arch, name)
    jmodel = jax_build_model(jcfg)
    with shape_only_deform_sampling():
        shapes = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
            jnp.zeros((1, 128, 128, 3), jnp.float32))
    model = build_model(config_from_cfg(cfg), "cpu")
    assert _port_counts(model) == _counts(shapes)
    assert type(model).__name__ == {"YOLOX": "YOLOX", "DetrD2go": "DetrD2go"
                                    }.get(arch, "AnchorYOLO")


def _yolox_resnet_map(name):
    if name.startswith("backbone."):
        return twp.map_resnet_torch_name(name)
    return twp.map_yolox_torch_name(name)


# (arch, registered name, image size, the carrier's name map, output keys)
FORWARD = {
    "yolox_resnet18": ("YOLOX", "build_resnet_backbone", 64,
                       _yolox_resnet_map, ("outputs",)),
    "yolov7_mobilevit": ("YOLOV7", "build_mobilevit_backbone", 128,
                         functools.partial(twp.map_anchor_yolo_torch_name,
                                           backbone_type="mobilevit"),
                         ("outputs",)),
    "d2go_fbnet_fpn": ("DetrD2go", "FBNetV2FpnBackbone", 64,
                       functools.partial(twp.map_detr_variant_torch_name,
                                         backbone_type="fbnet_fpn"),
                       ("pred_logits", "pred_boxes")),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_pairing_forward_matches_jax(case):
    arch, name, size, mapper, keys = FORWARD[case]
    cfg, jcfg = _cfgs(arch, name, **{"INPUT.INPUT_SIZE": [size, size]})
    jmodel = jax_build_model(jcfg)
    model = build_model(config_from_cfg(cfg), "cpu")
    rng = np.random.default_rng(len(case))
    images = rng.integers(0, 256, (2, size, size, 3)).astype(np.float32)
    variables = flax_variables_like(jmodel, images, rng)
    load_into(model, variables, mapper)
    want = jit_o0(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for key in keys:
        w = np.asarray(want[key], np.float64)
        g = got[key].float().numpy().astype(np.float64)
        assert g.shape == w.shape, key
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= TOL * scale, key


@pytest.mark.parametrize("arch", ["YOLOX", "YOLOV7", "YOLOV7P", "DetrD2go"])
def test_unregistered_name_raises_in_both_packages(arch):
    cfg, jcfg = _cfgs(arch, "build_swin_backbone")
    with pytest.raises(KeyError):
        jax_build_model(jcfg)
    with pytest.raises(NotImplementedError, match="build_swin_backbone"):
        build_model(config_from_cfg(cfg), "cpu")
