"""The port's Panoptic FPN (``models/meta_arch/panoptic_fpn.py``,
``models/heads/sem_seg_head.py``) against the JAX package, in float32 on the
CPU.

* ``SemSegFPNHead`` on a four-level pyramid (32-channel convs, GroupNorm of
  32 groups, 2x resizes): the logits and the pyramid's gradient
  (``jax.vjp``);
* ``panoptic_losses`` on random outputs of both heads: every term (the
  semantic target resized by "nearest" at half-pixel centres, the ignore
  label) and the gradient of the semantic logits;
* ``combine_semantic_and_instance`` with masks, without masks (Mask R-CNN
  serves none, ROADMAP.md C.41) and with overlapping instances;
* ``PanopticFPNShared`` at narrow widths (ResNet of one bottleneck a stage,
  FPN 32, 6 stuff classes, 64 px) with carried weights: the semantic logits
  and the R-CNN's outputs; one ``build_system`` step of PanopticFPN in
  expectation mode: its fields and its losses;
* the R-CNN family's configs: what ``RcnnConfig`` reads for MaskRCNN
  (masks on and off), FasterRCNN and PanopticFPN from the JAX test's mini
  config, every key of the model it builds on a leaf of the JAX build's
  init with the same counts, and ``build_resnet_fpn_backbone`` under the
  JAX BACKBONE_REGISTRY's name (FrozenBN and BN).

Tolerances: outputs and gradients 1e-4 of each tensor's largest magnitude
(XLA-CPU and oneDNN sum convolutions in another order); loss terms 1e-4
relative; the fusion exact.
"""

import functools

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    assert_leaves_match_jax,
    flax_variables_like,
    jit_o0,
    load_into,
    rcnn_mini_cfg,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.backbones import resnet as jresnet
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.heads import sem_seg_head as jsem
from yolov7_d2_tpu.models.meta_arch import panoptic_fpn as jp
from yolov7_d2_tpu.structures.instances import Detections as JDetections
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config import RcnnConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones import resnet as tresnet
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.heads import sem_seg_head as tsem
from yolov7_d2_tpu_torch.models.meta_arch import mask_rcnn as tm
from yolov7_d2_tpu_torch.models.meta_arch import panoptic_fpn as tp
from yolov7_d2_tpu_torch.structures.instances import Detections
from yolov7_d2_tpu_torch.utils import weight_port as twp

TOL = 1e-4
SIZE = 64
CUT_DEPTH, CUT_BLOCKS = 10, (1, 1, 1, 1)
DIMS = dict(num_classes=5, sem_seg_classes=6, resnet_depth=CUT_DEPTH,
            fpn_channels=32, num_proposals=16, pre_nms_topk=32)


@pytest.fixture(autouse=True, scope="module")
def _cut_resnet():
    with pytest.MonkeyPatch.context() as mp:
        for blocks in (jresnet.STAGE_BLOCKS, tresnet.STAGE_BLOCKS):
            mp.setitem(blocks, CUT_DEPTH, CUT_BLOCKS)
            mp.setitem(blocks, 18, CUT_BLOCKS)  # the mini config's depth
        yield


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


class _Head(nn.Module):
    """The JAX head at the pyramid's strides (a one-input module)."""

    @nn.compact
    def __call__(self, feats):
        return jsem.SemSegFPNHead(num_classes=6, conv_dims=32, name="head")(
            feats, (4, 8, 16, 32))


def test_sem_seg_head_forward_and_vjp_match_jax():
    rng = np.random.default_rng(0)
    feats = [rng.normal(0, 1, (2, 32 // s, 32 // s, 16)).astype(np.float32)
             for s in (1, 2, 4, 8)]
    jhead = _Head()
    variables = flax_variables_like(jhead, feats, rng)

    def fwd(fs):
        return jhead.apply(variables, fs)

    want, pull = jax.vjp(jax.jit(fwd), [jnp.asarray(f) for f in feats])
    head = load_into(tsem.SemSegFPNHead(16, 6, 32), variables,
                     lambda n: ("head",) + tuple(n.split(".")))
    tf = [_nchw(f).requires_grad_() for f in feats]
    got = head(tf)
    _close(got.detach().numpy(), want, what="logits")
    assert got.shape == (2, 32, 32, 6)
    proj = rng.normal(0, 1, want.shape).astype(np.float32)
    (got * torch.from_numpy(proj)).sum().backward()
    jgrads = pull(jnp.asarray(proj))[0]
    for i, (t, g) in enumerate(zip(tf, jgrads)):
        _close(t.grad.permute(0, 2, 3, 1).numpy(), g, what=f"level {i}")


def _random_out(rng, b=2, a=400, p=8, c=5, s=6, hs=16):
    boxes = np.sort(rng.uniform(0, SIZE, (b, p, 2, 2)), 2).reshape(
        b, p, 4).astype(np.float32)
    anchors = np.sort(rng.uniform(0, SIZE, (a, 2, 2)), 1).reshape(
        a, 4).astype(np.float32)
    f = np.float32
    return {
        "anchors": anchors, "proposals": boxes,
        "proposal_valid": rng.random((b, p)) > 0.2,
        "rpn_obj": rng.normal(0, 1, (b, a)).astype(f),
        "rpn_deltas": rng.normal(0, 0.3, (b, a, 4)).astype(f),
        "cls_logits": rng.normal(0, 1, (b, p, c + 1)).astype(f),
        "box_deltas": rng.normal(0, 0.3, (b, p, c, 4)).astype(f),
        "mask_logits": rng.normal(0, 1, (b, p, 28, 28, c)).astype(f),
        "sem_seg_logits": rng.normal(0, 1, (b, hs, hs, s)).astype(f),
    }


def _random_batch(rng, b=2, g=3, s=6):
    boxes = np.sort(rng.uniform(0, SIZE, (b, g, 2, 2)), 2).reshape(
        b, g, 4).astype(np.float32)
    sem = rng.integers(0, s + 1, (b, SIZE, SIZE)).astype(np.int32)
    sem[:, :8] = s                                      # the ignore label
    return {"gt_boxes": boxes,
            "gt_classes": rng.integers(0, 5, (b, g)).astype(np.int32),
            "gt_valid": np.array([[True, True, False], [True, False, True]]),
            "gt_masks": (rng.random((b, g, SIZE, SIZE)) > 0.5).astype(
                np.uint8),
            "gt_sem_seg": sem}


def test_panoptic_losses_match_jax():
    """Every term on random outputs, in expectation mode, and the
    semantic logits' gradient."""
    rng = np.random.default_rng(1)
    out, batch = _random_out(rng), _random_batch(rng)

    def jfn(sem, out, batch):
        losses = jp.panoptic_losses({**out, "sem_seg_logits": sem}, batch, 5,
                                    6)
        return losses["total_loss"], losses

    jout = {k: jnp.asarray(v) for k, v in out.items()
            if k != "sem_seg_logits"}
    jgrad, jlosses = jax.jit(jax.grad(jfn, has_aux=True))(
        jnp.asarray(out["sem_seg_logits"]), jout,
        {k: jnp.asarray(v) for k, v in batch.items()})
    tout = {k: torch.from_numpy(v) for k, v in out.items()}
    tout["sem_seg_logits"].requires_grad_()
    losses = tp.panoptic_losses(tout, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, 5, 6)
    assert sorted(losses) == sorted(jlosses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=TOL, err_msg=k)
    losses["total_loss"].backward()
    _close(tout["sem_seg_logits"].grad.numpy(), jgrad, what="sem grad")


@pytest.mark.parametrize("case", ["masks", "no_masks", "overlap"])
def test_combine_semantic_and_instance_matches_jax(case):
    rng = np.random.default_rng(2)
    sem = rng.normal(0, 1, (32, 32, 4)).astype(np.float32)
    sem[:, :20, 1] += 3.0                              # a large stuff region
    masks = np.zeros((4, 32, 32), np.float32)
    masks[0, 2:12, 2:12] = 1.0
    masks[1, 20:30, 20:30] = 0.9
    masks[2, 4:14, 4:14] = 1.0 if case == "overlap" else 0.0
    masks[3, 25:31, 1:7] = 1.0
    scores = np.asarray([0.9, 0.7, 0.95, 0.3], np.float32)
    valid = np.asarray([True, True, True, True])
    kw = dict(boxes=np.zeros((4, 4), np.float32), scores=scores,
              classes=np.zeros(4, np.int32), valid=valid,
              masks=None if case == "no_masks" else masks)
    want = jp.combine_semantic_and_instance(sem, JDetections(**kw),
                                            stuff_area_limit=50)
    got = tp.combine_semantic_and_instance(
        sem, Detections(**{k: v if v is None else torch.from_numpy(v)
                           for k, v in kw.items()}), stuff_area_limit=50)
    np.testing.assert_array_equal(got, want)
    assert got.max() >= (2 if case == "no_masks" else 3)


@functools.lru_cache(maxsize=None)
def _pair():
    """(variables, images, batch, the JAX outputs): one compile of the JAX
    forward."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    jmodel = jp.PanopticFPNShared(**DIMS)
    variables = flax_variables_like(jmodel, images.astype(np.float32), rng)
    jout = jit_o0(lambda v, x: jmodel.apply(v, x, train=True))(
        variables, jnp.asarray(images, jnp.float32))
    return variables, images, _random_batch(rng), jout


def _port_model():
    return load_into(tp.PanopticFPNShared(**DIMS), _pair()[0],
                     twp.map_mask_rcnn_torch_name)


def test_panoptic_fpn_forward_matches_jax():
    _, images, _, jout = _pair()
    with torch.no_grad():
        out = _port_model()(torch.from_numpy(images))
    for k in ("sem_seg_logits", "rpn_obj", "proposals", "cls_logits",
              "box_deltas", "mask_logits"):
        _close(out[k].numpy(), jout[k], what=k)
    assert out["sem_seg_logits"].shape == (2, SIZE // 4, SIZE // 4, 6)


def test_build_system_step_wires_panoptic_losses(monkeypatch):
    """One ``build_system`` step of PanopticFPN (expectation mode, the
    narrow model holding the carried weights): its fields, and its loss
    terms those of ``panoptic_losses`` on the model's outputs (which
    :func:`test_panoptic_fpn_forward_matches_jax` and
    :func:`test_panoptic_losses_match_jax` hold against JAX)."""
    _, images, batch, _ = _pair()
    tb = {"image": torch.from_numpy(images),
          **{k: torch.from_numpy(v) for k, v in batch.items()}}
    with torch.no_grad():
        want = tp.panoptic_losses(_port_model().train()(tb["image"]), tb, 5,
                                  6)
    monkeypatch.setattr(engine, "build_model",
                        lambda cfg, device, seed: _port_model())
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "PanopticFPN",
                         "MODEL.ROI_HEADS.NUM_CLASSES", "5",
                         "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "6",
                         "MODEL.ROI_HEADS.SAMPLE_MODE", "expectation",
                         "SOLVER.AMP.ENABLED", "False",
                         "INPUT.INPUT_SIZE", f"[{SIZE}, {SIZE}]"])
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    assert fields == ("image", "gt_masks", "gt_boxes", "gt_classes",
                      "gt_valid", "gt_sem_seg")
    assert model.generator is model.rcnn.generator is not None
    _, metrics = step(state, tb)
    assert float(metrics["loss_sem_seg"]) > 0
    for k in want:
        np.testing.assert_allclose(float(metrics[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)


@functools.lru_cache(maxsize=None)
def _init_shapes(kind: str, mask_on: bool):
    """The JAX init's leaf shapes of the mini config's model: one trace,
    Panoptic FPN's; Mask R-CNN's are its ``backbone`` and its ``rcnn``'s
    leaves, less the mask head where the masks are off."""
    if kind == "MaskRCNN":
        shapes = _init_shapes("PanopticFPNShared", True)
        params = {"backbone": shapes["params"]["backbone"],
                  **{k: v for k, v in shapes["params"]["rcnn"].items()
                     if mask_on or not k.startswith("mask_")}}
        return {"params": params, "batch_stats": shapes["batch_stats"]}
    model = jax_build_model(rcnn_mini_cfg(jax_get_cfg, "PanopticFPN"))
    return jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))


@pytest.mark.parametrize("arch,mask_on", [("MaskRCNN", True),
                                          ("MaskRCNN", False),
                                          ("FasterRCNN", True),
                                          ("PanopticFPN", False)])
def test_config_and_full_model_leaves_match_jax(arch, mask_on,
                                                monkeypatch):
    """What ``RcnnConfig`` reads (Faster R-CNN never has the mask head,
    Panoptic FPN always), and every key of the model it builds on a leaf of
    the JAX build's init (``jax.eval_shape``) with the same counts, at the
    mini config's ResNet-18 (a bottleneck a stage in both packages) with
    FPN 256."""
    for module in (tm, tp):
        monkeypatch.setattr(module, "init_weights_", lambda *a: None)
    cfg = RcnnConfig.from_cfg(rcnn_mini_cfg(get_cfg, arch, mask_on))
    assert (cfg.num_classes, cfg.resnet_depth, cfg.fpn_channels,
            cfg.num_proposals, cfg.rcnn_pre_nms_topk, cfg.sem_seg_classes,
            cfg.sample_mode, cfg.rpn_batch, cfg.roi_batch) == (
        5, 18, 256, 16, 32, 6, "sampled", 256, 512)
    assert cfg.mask_on == (arch == "PanopticFPN" or (arch == "MaskRCNN"
                                                    and mask_on))
    assert engine.config_from_cfg(rcnn_mini_cfg(get_cfg, arch, mask_on)) == cfg
    jax_model = jax_build_model(rcnn_mini_cfg(jax_get_cfg, arch, mask_on))
    # Faster R-CNN's JAX model is the masks-off Mask R-CNN: one trace
    shapes = _init_shapes(type(jax_model).__name__, cfg.mask_on)
    monkeypatch.setattr(jax, "eval_shape", lambda *a: shapes)
    count = assert_leaves_match_jax(build_model(cfg, "cpu"), jax_model,
                                    twp.map_mask_rcnn_torch_name, size=64)
    assert count["params"] > 5e6 and count["batch_stats"] > 0


@pytest.mark.parametrize("norm", ["FrozenBN", "BN"])
def test_resnet_fpn_registry_builder_matches_jax(norm):
    """``build_resnet_fpn_backbone`` under the JAX BACKBONE_REGISTRY's name
    reads ``RESNETS.DEPTH``, ``FPN.OUT_CHANNELS`` and ``RESNETS.NORM``
    (FrozenBN or a trained BatchNorm); its keys land on the JAX builder's
    init leaves with the same counts."""
    from yolov7_d2_tpu.models.necks import fpn as jfpn
    from yolov7_d2_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
    from yolov7_d2_tpu_torch.models.build import BACKBONE_REGISTRY

    opts = {"MODEL.RESNETS.NORM": norm, "MODEL.FPN.OUT_CHANNELS": "64"}
    model = BACKBONE_REGISTRY.get("build_resnet_fpn_backbone")(
        rcnn_mini_cfg(get_cfg, **opts))
    frozen = [isinstance(m, FrozenBatchNorm2d) for m in model.modules()]
    assert any(frozen) == (norm == "FrozenBN")
    assert model.fpn.output_0.out_channels == 64
    count = assert_leaves_match_jax(
        model, jfpn.build_resnet_fpn_backbone(rcnn_mini_cfg(jax_get_cfg, **opts)),
        lambda n: twp.map_mask_rcnn_torch_name("backbone." + n)[1:],
        size=64)
    assert count["batch_stats"] > 0
