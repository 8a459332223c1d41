"""The port's Res2Net / Res2NeXt backbone and YOLOV7 on it against the JAX
package, in float32 on the CPU.

* The backbones of ``configs/coco/r2_50.yaml`` (``res2net50_v1b``),
  ``r2_50_l.yaml`` (``res2net50_v1d``) and ``r2next_50.yaml``
  (``res2next50``) through both packages' ``build_res2net_backbone``, full
  depth, at 64 px in eval mode: res3-res5 within 1e-4 of each map's
  largest magnitude (XLA-CPU and oneDNN sum each convolution in another
  order), weights drawn with numpy (``flax_variables_like``) and carried
  into the port by ``jax_to_torch_state_dict``;
* the weight carrier both ways (flax -> port -> flax through the JAX
  ``port_torch_state_dict``, exact) and the port's copies of
  ``map_res2net_torch_name`` / ``map_res2next_torch_name`` against the
  JAX package's over every key;
* the 9 yamls that wait on Res2Net built through ``build_model``: every
  parameter and BatchNorm statistic of the full-size model has the JAX
  model's flax leaf of the same shape (``jax.eval_shape`` of its init),
  none left over;
* one float32 train step of YOLOV7 on a Res2Net of 2 blocks a layer (both
  packages' ``Res2Net(depth=18)``) with the yaml's YOLOFPN, 64 px: the
  loss terms within 1e-4 relative, ``num_fg`` exact, the gradient norm
  within 1e-3 relative (the anchor family's tolerances,
  ``tests/test_torch_port_yolov7_grads.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    ANCHOR_CLASSES,
    REPO,
    flax_variables_like,
    load_into,
    numpy_variables,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.backbones import res2net as jres2net
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import yolov7 as jarch
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import AnchorYoloConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones import res2net as tres2net
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import yolov7 as tarch
from yolov7_d2_tpu_torch.utils import weight_port as twp

FWD_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
SIZE = 64
BACKBONES = {"res2net50_v1b": "coco/r2_50.yaml",
             "res2net50_v1d": "coco/r2_50_l.yaml",
             "res2next50": "coco/r2next_50.yaml"}
YAMLS = ("coco/r2_50.yaml", "coco/r2_50_l.yaml", "coco/r2next_50.yaml",
         "tl/r2_50.yaml", "tl/res2net_fpn.yaml", "tl/res2net_bifpn.yaml",
         "voc/r2_50_1gpu.yaml", "facemask/r2_50_1gpu.yaml",
         "visdrone/r2_50_1gpu.yaml")


def _cfgs(yaml):
    out = []
    for fn in (get_cfg, jax_get_cfg):
        cfg = fn()
        cfg.merge_from_file(str(REPO / "configs" / yaml))
        out.append(cfg)
    return out


def _maps(r2type):
    if "next" in r2type:
        return twp.map_res2next_torch_name, jwp.map_res2next_torch_name
    return twp.map_res2net_torch_name, jwp.map_res2net_torch_name


@functools.lru_cache(maxsize=None)
def _backbones(r2type):
    """(flax backbone, its variables, the port's holding them, images)."""
    cfg, jcfg = _cfgs(BACKBONES[r2type])
    assert cfg.MODEL.RESNETS.R2TYPE == r2type
    rng = np.random.default_rng(len(r2type))
    images = rng.uniform(-2, 2, (2, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = jres2net.build_res2net_backbone(jcfg)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = tres2net.build_res2net_backbone(AnchorYoloConfig.from_cfg(cfg))
    load_into(tmodel, variables, _maps(r2type)[0])
    return jmodel, variables, tmodel, images


@pytest.mark.parametrize("r2type", sorted(BACKBONES))
def test_backbone_matches_jax(r2type):
    jmodel, variables, tmodel, images = _backbones(r2type)
    vd = "next" not in r2type
    assert jmodel.vd == vd and isinstance(tmodel.conv1, torch.nn.Sequential) \
        == vd
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["res3", "res4", "res5"]
    for k, w in want.items():
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert got[k].shape == w.shape, k
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= FWD_TOL * max(1.0, float(np.abs(w).max())), (k, err)
        assert float(np.abs(w).max()) > 0.1, k


@pytest.mark.parametrize("r2type", ["res2net50_v1b", "res2next50"])
def test_weight_carrier_both_ways_and_the_name_map(r2type):
    _, variables, tmodel, _ = _backbones(r2type)
    ours, theirs = _maps(r2type)
    modules = {k.rpartition(".")[0] for k in tmodel.state_dict()}
    for name in modules:
        assert ours(name) == theirs(name), name
    back, report = jwp.port_torch_state_dict(
        {k: v.numpy() for k, v in tmodel.state_dict().items()},
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                     numpy_variables(variables)), name_mapper=theirs)
    assert not report["unused"], report["unused"][:5]
    want = jax.tree_util.tree_leaves_with_path(numpy_variables(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_builds_with_the_jax_leaves(yaml, monkeypatch):
    cfg, jcfg = _cfgs(yaml)
    acfg = AnchorYoloConfig.from_cfg(cfg)
    # the leaves' shapes are what is held: the weights' draw is skipped
    monkeypatch.setattr(tarch, "init_weights_", lambda *args: None)
    model = build_model(acfg, "cpu")
    assert isinstance(model.backbone, tres2net.Res2Net)
    h, w = acfg.input_size
    shapes = jax.eval_shape(
        lambda x: jax_build_model(jcfg).init(jax.random.PRNGKey(0), x),
        jnp.zeros((1, h, w, 3), jnp.float32))
    flax = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes[coll]):
            flax[tuple(str(getattr(k, "key", k)) for k in path)] = leaf.shape
    backbone = "res2next" if "next" in acfg.r2type else "res2net"
    n_params = n_stats = 0
    for key, value in model.state_dict().items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        path = twp.map_anchor_yolo_torch_name(module, backbone)
        names = {"weight": ("kernel", "scale"), "bias": ("bias",),
                 "running_mean": ("mean",), "running_var": ("var",),
                 "edge_weights": ()}[leaf]
        found = [path + (n,) for n in names if path + (n,) in flax] or (
            [path] if path in flax else [])
        assert len(found) == 1, key
        shape = flax.pop(found[0])
        if len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert tuple(value.shape) == tuple(shape), key
        if leaf.startswith("running_"):
            n_stats += value.numel()
        else:
            n_params += value.numel()
    assert not flax, list(flax)[:5]
    assert n_params == sum(p.numel() for p in model.parameters())
    assert n_stats > 0


def _yolov7_pair(rng):
    """(flax AnchorYOLO, variables, port AnchorYOLO with them) of YOLOV7 on
    a 2-blocks-a-layer Res2Net-v1b, YOLOFPN, SiLU, 6 classes."""
    kw = dict(neck_type="yolov3", in_features=("res3", "res4", "res5"),
              act="silu", num_classes=ANCHOR_CLASSES)
    jmodel = jarch.AnchorYOLO(backbone=jres2net.Res2Net(depth=18), **kw)
    tmodel = tarch.AnchorYOLO(backbone=tres2net.Res2Net(depth=18), **kw)
    images = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = flax_variables_like(jmodel, images, rng)
    load_into(tmodel, variables, functools.partial(
        twp.map_anchor_yolo_torch_name, backbone_type="res2net"))
    return jmodel, variables, tmodel, images


def test_yolov7_res2net_train_step_matches_jax():
    from test_torch_port_yolov7_grads import ANCHORS, LOSS_KW, _gts

    rng = np.random.default_rng(21)
    jmodel, variables, tmodel, images = _yolov7_pair(rng)
    batch = dict(zip(("gt_boxes", "gt_classes", "gt_valid"),
                     _gts(rng, 2, SIZE, 8, [6, 3])))
    kw = LOSS_KW["YOLOV7"]

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        losses = jarch.anchor_yolo_loss_fn(
            out, {k: jnp.asarray(v) for k, v in batch.items()}, ANCHORS,
            ANCHOR_CLASSES, **kw)
        return losses["total_loss"], losses

    jgrads, jlosses = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"])
    tmodel.train()
    tmodel.zero_grad()
    losses = tarch.anchor_yolo_loss_fn(
        tmodel(torch.from_numpy(images)),
        {k: torch.from_numpy(v) for k, v in batch.items()}, ANCHORS,
        ANCHOR_CLASSES, **kw)
    losses["total_loss"].backward()
    assert float(losses["num_fg"]) == float(jlosses["num_fg"]) > 3
    for k in ("loss_box", "loss_obj", "loss_cls", "total_loss"):
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    want = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                       for g in jax.tree_util.tree_leaves(jgrads)))
    got = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                               for p in tmodel.parameters())))
    assert len(jax.tree_util.tree_leaves(jgrads)) == len(
        list(tmodel.parameters()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL)
