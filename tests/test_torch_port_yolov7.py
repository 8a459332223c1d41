"""The port's anchor-YOLO models (YOLOV7, YOLO, YOLOV7P) against the JAX
package, in float32 on the CPU: the eval-mode forward at reduced depth, the
builders' parameters at full depth, and what the port refuses (the
training step is in ``tests/test_torch_port_yolov7_grads.py`` and
``tests/test_torch_port_yolov7_trajectory.py``).

Weights: flax variables drawn with numpy at the flax init's scale, with
random BatchNorm statistics and affine parameters (``randomize_bn``),
moved into the port by ``jax_to_torch_state_dict`` through
``map_anchor_yolo_torch_name``.
Tolerance of the forward: max abs error 1e-4 times the largest magnitude of
the tensor (and at least 1e-4), as for YOLOX
(``tests/test_torch_port_yolox.py``): XLA-CPU and oneDNN sum each
convolution in another order. Grids, strides, anchors and level sizes are
exact.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import ANCHOR_ARCHS, anchor_yolo_pair, jit_o0
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu_torch.config import AnchorYoloConfig, YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import AnchorYOLO
from yolov7_d2_tpu_torch.predictor import Predictor
from yolov7_d2_tpu_torch.utils.weight_port import map_anchor_yolo_torch_name

REPO = Path(__file__).resolve().parent.parent
FWD_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return anchor_yolo_pair(arch)


def _assert_close(got, want):
    want = np.asarray(want, np.float64)
    tol = FWD_TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("arch", sorted(ANCHOR_ARCHS))
def test_forward_matches_jax(arch):
    jmodel, variables, tmodel, images = _pair(arch)
    want = jit_o0(jmodel.apply)(variables, jnp.asarray(images, jnp.float32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    assert got["level_hw"] == want["level_hw"] == ((8, 8), (4, 4), (2, 2))
    for key in ("grids", "strides", "anchors"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["outputs"].dtype == torch.float32
    _assert_close(got["outputs"].numpy(), want["outputs"])
    assert float(got["outputs"].abs().max()) > 1.0
    # a float batch (the training step's, after mixup) gives the same
    with torch.no_grad():
        again = tmodel(torch.from_numpy(images.astype(np.float32)))
    assert torch.equal(again["outputs"], got["outputs"])


def _cfg(yaml, **opts):
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "coco" / yaml))
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(REPO / "configs" / "coco" / yaml))
    for k, v in opts.items():
        for c in (cfg, jcfg):
            node, _, leaf = k.rpartition(".")
            target = c
            for part in node.split("."):
                target = getattr(target, part)
            setattr(target, leaf, v)
    return cfg, jcfg


BUILDS = {
    "yolov7": ("yolov7.yaml", {}, "cspdarknet53"),
    "yolo_darknet53": ("darknet53.yaml", {}, "darknet53"),
    "yolov7p_csp": ("yolov7.yaml", {
        "MODEL.META_ARCHITECTURE": "YOLOV7P"}, "cspdarknet53"),
    "yolov7_fpn_spp": ("cspdarknet53.yaml", {}, "cspdarknet53"),
    "yolov7_darknetx": ("yolov7.yaml", {
        "MODEL.BACKBONE.NAME": "build_cspdarknetx_backbone",
        "MODEL.YOLO.WIDTH_MUL": 0.5, "MODEL.YOLO.DEPTH_MUL": 0.33},
        "cspdarknetx"),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builders_match_jax_at_full_depth(name):
    """Every parameter and statistic of the full-depth model from the yaml
    has its flax leaf, of the same shape, and no flax leaf is left over."""
    yaml, opts, backbone_type = BUILDS[name]
    cfg, jcfg = _cfg(yaml, **{"INPUT.INPUT_SIZE": [64, 64], **opts})
    model = build_model(AnchorYoloConfig.from_cfg(cfg), "cpu")
    assert model.dtype == torch.bfloat16     # SOLVER.AMP.ENABLED in the yaml
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    flax = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes[coll]):
            flax[tuple(str(getattr(k, "key", k)) for k in path)] = leaf.shape
    for key, value in model.state_dict().items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        path = map_anchor_yolo_torch_name(module, backbone_type)
        names = {"weight": ("kernel", "scale"), "bias": ("bias",),
                 "running_mean": ("mean",), "running_var": ("var",)}[leaf]
        found = [path + (n,) for n in names if path + (n,) in flax]
        assert len(found) == 1, key
        shape = flax.pop(found[0])
        if len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert tuple(value.shape) == tuple(shape), key
    assert not flax, list(flax)[:5]


def test_yolov7_flagship_size():
    model = build_model(AnchorYoloConfig(), "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert 70e6 < n < 73e6, n
    # the stride-32 head tower: 1024 -> 2048, 3x3
    assert tuple(model.head.towers[2].conv.weight.shape) == (2048, 1024, 3, 3)


def test_unported_parts_raise():
    cfg = dataclasses.replace(AnchorYoloConfig(), amp=False)
    # every registered backbone builds (MobileViT from the defaults'
    # MODEL.MOBILEVIT, the YOLO features set to its outputs)
    model = build_model(dataclasses.replace(
        cfg, backbone="build_mobilevit_backbone",
        in_features=("stage2", "stage3", "stage4")), "cpu")
    assert type(model.backbone).__name__ == "MobileViT"
    for replace, item in (
            # an unregistered name raises, naming it
            (dict(backbone="build_swin_backbone"), "'build_swin_backbone'"),
            # the R-CNN family builds, from its own config
            (dict(meta_architecture="MaskRCNN"), "takes an RcnnConfig")):
        with pytest.raises(NotImplementedError, match=item):
            build_model(dataclasses.replace(cfg, **replace), "cpu")
    # a YoloxConfig (what the CLIs read) cannot build this family
    with pytest.raises(NotImplementedError, match="AnchorYoloConfig"):
        build_model(dataclasses.replace(YoloxConfig(),
                                        meta_architecture="YOLOV7"), "cpu")


@pytest.mark.parametrize("arch,item", [
    ("FasterRCNN", "A.8d"), ("MaskRCNN", "A.8d"), ("PanopticFPN", "A.8d"),
    ("RetinaNet", "A.8"), ("CenterNet", "A.8"), ("MaskFormer", "A.8")])
def test_build_system_raises_for_unported_architectures(arch, item):
    """A name neither package builds names ROADMAP.md's Queue A; the
    R-CNN family, the last of the JAX package's architectures, came with
    item A.8d and builds (its fields: the yaml has no MASK_ON, Panoptic
    FPN always has masks)."""
    cfg, _ = _cfg("yolov7.yaml", **{"MODEL.META_ARCHITECTURE": arch})
    if item == "A.8d":
        model, _, _, fields = build_system(cfg, device="cpu")
        assert model.training and fields[:2] == (
            ("image", "gt_masks") if arch == "PanopticFPN" else
            ("image", "gt_boxes"))
        return
    with pytest.raises(NotImplementedError, match="Queue A"):
        build_system(cfg, device="cpu")


def test_predictor_serves_yolox_only():
    with pytest.raises(NotImplementedError, match="anchor_yolo_postprocess"):
        Predictor(AnchorYoloConfig(), device="cpu")


def test_anchor_yolo_defaults_to_the_card():
    import inspect

    from yolov7_d2_tpu_torch.models.meta_arch import yolov7

    for fn in (yolov7.build_yolo, yolov7.build_yolov5, yolov7.build_yolov7,
               yolov7.build_yolov7p, build_system):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert AnchorYOLO().dtype == torch.float32
