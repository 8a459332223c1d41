"""The port's YOLOv5 and the BiFPN and PP-YOLO PAN necks of the anchor
family against the JAX package, in float32 on the CPU, and every shipped
configuration of the one-stage slice served and trained through the port's
entry points.

* YOLOv5-s (the v5 backbone, YOLOPAFPN at width 0.5 / depth 0.33, the
  anchor head) at 64 px: the eval forward, a train-mode pass with the v5
  decode and ratio targets (loss terms and BatchNorm statistics), the tail
  with the objectness gate index for index, the weight carrier both ways;
* BiFPN alone (2 cells, 32 channels) with GroupNorm, BatchNorm and no norm,
  plain and separable; PPYOLOPAN alone in eval mode and in train mode at
  keep_prob 1.0 (statistics), and DropBlock's dropped share at keep_prob
  0.9 against its expectation over a seeded draw (flax draws other masks);
* YOLOV7 on ResNet (bottleneck ResNet-18, as the JAX ResNet builds it) with
  the ``bifpn`` neck at its defaults (160 channels, 6 cells) and with
  ``pan``: the eval forward;
* the builders of ``yolov5_s.yaml``, ``wearmask/r50_bifpn.yaml`` and
  ``wearmask/r50_pan.yaml`` at full depth, leaf for leaf against the flax
  init's shapes, and ``build_model`` + the tail and ``engine.build_system``
  for every configuration of the slice at 64 px.

Weights: flax variables drawn with numpy (``flax_variables_like``), moved
into the port by ``jax_to_torch_state_dict``. Tolerances: forward and
BatchNorm statistics 1e-4 of each tensor's largest magnitude (XLA-CPU and
oneDNN sum each convolution in another order), loss terms after a forward
1e-4 relative, ``num_fg`` exact (the ratio targets do not depend on the
predictions), the tail's kept indices exact; DropBlock's dropped share
within 3 standard deviations of its expectation.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    flax_variables_like,
    jit_o0,
    load_into,
    numpy_variables,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.backbones.resnet import ResNet as JResNet
from yolov7_d2_tpu.models.backbones.yolov5 import YOLOv5Backbone as JV5
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import yolov7 as jarch
from yolov7_d2_tpu.models.necks.bifpn import BiFPN as JBiFPN
from yolov7_d2_tpu.models.necks.reppan import PPYOLOPAN as JPAN
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import (
    AnchorYoloConfig,
    YolofConfig,
    Yolov6Config,
)
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system
from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
from yolov7_d2_tpu_torch.models.backbones.resnet import ResNet, ResNetSpec
from yolov7_d2_tpu_torch.models.backbones.yolov5 import YOLOv5Backbone
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import yolov7 as tarch
from yolov7_d2_tpu_torch.models.meta_arch.yolof import yolof_postprocess
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess
from yolov7_d2_tpu_torch.models.necks.bifpn import BiFPN
from yolov7_d2_tpu_torch.models.necks.reppan import PPYOLOPAN, DropBlock
from yolov7_d2_tpu_torch.models.necks.yolo_pafpn import YOLOPAFPN
from yolov7_d2_tpu_torch.utils import weight_port as twp

REPO = Path(__file__).resolve().parent.parent
SIZE = 64
CLASSES = 3
FWD_TOL = 1e-4
ANCHORS = AnchorYoloConfig.anchors


def _assert_close(got, want, tol=FWD_TOL, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _gts(rng, counts=(3, 5), g=6):
    boxes = np.zeros((len(counts), g, 4), np.float32)
    valid = np.zeros((len(counts), g), bool)
    for i, n in enumerate(counts):
        wh = rng.uniform(0.15, 0.7, (n, 2)) * SIZE
        c = rng.uniform(wh / 2, SIZE - wh / 2)
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :n] = True
    classes = (rng.integers(0, CLASSES, valid.shape) * valid).astype(np.int32)
    return {"gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid}


# ---------------------------------------------------------------------------
# YOLOv5-s
# ---------------------------------------------------------------------------

V5_KW = dict(neck_type="pafpn", in_features=("c3", "c4", "c5"),
             width_mul=0.5, depth_mul=0.33, act="silu")
V5_MAPPER = functools.partial(twp.map_anchor_yolo_torch_name,
                              backbone_type="yolov5")


@functools.lru_cache(maxsize=None)
def _v5_pair():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    jmodel = jarch.AnchorYOLO(num_classes=CLASSES, backbone=JV5("s"),
                              **V5_KW)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = load_into(tarch.AnchorYOLO(num_classes=CLASSES,
                                        backbone=YOLOv5Backbone("s"),
                                        **V5_KW), variables, V5_MAPPER)
    return jmodel, variables, tmodel, images


@functools.lru_cache(maxsize=None)
def _v5_eval():
    jmodel, variables, _, images = _v5_pair()
    out = jit_o0(jmodel.apply)(variables, jnp.asarray(images, jnp.float32))
    return {k: np.asarray(v) for k, v in out.items() if k != "level_hw"}


def test_yolov5_forward_matches_jax():
    _, _, tmodel, images = _v5_pair()
    want = _v5_eval()
    assert tmodel.backbone.out_channels == {"c3": 128, "c4": 256, "c5": 256}
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    for key in ("grids", "strides", "anchors"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    _assert_close(got["outputs"].numpy(), want["outputs"])
    assert float(got["outputs"].abs().max()) > 1.0


def test_yolov5_train_mode_losses_and_statistics():
    """The v5 decode and ratio targets, as ``build_system`` wires YOLOV5
    (JAX ``engine.py:186-192``)."""
    jmodel, variables, tmodel, _ = _v5_pair()
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    batch = _gts(rng)
    kw = dict(variant="yolov5", build_target_type="yolov5", iou_type="ciou",
              loss_type="v7", ignore_threshold=0.5)

    def run(v):
        out, new = jmodel.apply(v, jnp.asarray(images), train=True,
                                mutable=["batch_stats"])
        return jarch.anchor_yolo_loss_fn(out, batch, np.asarray(ANCHORS),
                                         CLASSES, **kw), new

    jlosses, jnew = jit_o0(run)(variables)
    import copy
    model = copy.deepcopy(tmodel).train()
    losses = tarch.anchor_yolo_loss_fn(model(torch.from_numpy(images)),
                                       _torch(batch), ANCHORS, CLASSES, **kw)
    assert float(losses["num_fg"]) == float(jlosses["num_fg"]) > 3
    for k in ("loss_box", "loss_obj", "loss_cls", "total_loss"):
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=1e-4, err_msg=k)
    moved = twp.jax_to_torch_state_dict(
        numpy_variables({"params": variables["params"], **jnew}),
        model.state_dict(), V5_MAPPER)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _assert_close(v.numpy(), moved[k], what=k)


def test_yolov5_tail_matches_jax_index_for_index():
    """``anchor_yolo_postprocess`` with the v5 decode and the objectness
    gate."""
    out = _v5_eval()
    flat = {**out, "level_hw": ((8, 8), (4, 4), (2, 2))}
    kw = dict(conf_threshold=0.05, nms_threshold=0.5, max_detections=50,
              pre_nms_topk=200)
    want = jarch.anchor_yolo_postprocess(
        {k: jnp.asarray(v) if k != "level_hw" else v
         for k, v in flat.items()}, variant="yolov5", **kw)
    tflat = {**_torch(out), "level_hw": flat["level_hw"]}
    got = tarch.anchor_yolo_postprocess(tflat, "yolov5", **kw)
    plain = tarch.anchor_yolo_postprocess(tflat, "yolov5",
                                          nms=nms_batched_plain, **kw)
    assert int(got.valid.sum()) > 5
    for f in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))
        assert torch.equal(getattr(got, f), getattr(plain, f))


def test_yolov5_weight_carrier_both_ways():
    """The port's state dict through the JAX package's maps (the YOLOX CSP
    names, ``_csp_inner``, for the backbone; ``map_yolox_torch_name`` for
    the neck) gives the JAX model the port's outputs, and back."""
    jmodel, variables, tmodel, images = _v5_pair()
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}

    def mapper(name):
        prefix, _, rest = name.partition(".")
        if prefix == "backbone":
            part, _, inner = rest.partition(".")
            return ("backbone", part) + tuple(
                jwp._csp_inner(inner).split("/"))
        m = name.split(".")
        if m[0] == "head":
            return ("head", f"{m[1][:-1]}_{m[2]}") + tuple(m[3:])
        return jwp.map_yolox_torch_name(name)

    ported, report = jwp.port_torch_state_dict(sd, variables,
                                               name_mapper=mapper)
    assert not report["unused"], report["unused"][:5]
    want = jit_o0(jmodel.apply)(ported, jnp.asarray(images, jnp.float32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    _assert_close(got["outputs"].numpy(), want["outputs"])
    back = twp.jax_to_torch_state_dict(jax.tree.map(np.asarray, ported),
                                       tmodel.state_dict(), V5_MAPPER)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the necks alone
# ---------------------------------------------------------------------------

def _levels(rng, channels=(24, 40, 64), side=16):
    return [rng.normal(0, 1, (2, side >> i, side >> i, c)).astype(np.float32)
            for i, c in enumerate(channels)]


@pytest.mark.parametrize("norm,separable", [("GN", False), ("BN", True),
                                            ("", False), ("", True)])
def test_bifpn_matches_jax(norm, separable):
    rng = np.random.default_rng(len(norm) * 2 + separable)
    feats = _levels(rng)
    kw = dict(out_channels=32, num_bifpn=2, norm=norm,
              separable_conv=separable)
    jneck = JBiFPN(**kw)
    variables = flax_variables_like(jneck, feats, rng)
    # edge weights away from 1, some below 0 (the ReLU's kink)
    for name in variables["params"]:
        if name.endswith("_edge"):
            variables["params"][name] = rng.uniform(
                -0.3, 1.5, variables["params"][name].shape).astype(np.float32)
    tneck = load_into(BiFPN([f.shape[-1] for f in feats], **kw), variables,
                      twp.map_bifpn_torch_name)
    if norm == "":
        assert tneck.cell[0].fnode[0].after_combine.conv.bn is None
    want = jax.jit(jneck.apply)(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tneck([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[2] == w.shape[1] == 16 >> i
        _assert_close(_nhwc(g), w, what=f"level {i}")
    # the carrier both ways through the JAX package's port_bifpn_state_dict
    sd = {k: v.numpy() for k, v in tneck.state_dict().items()}
    ported, report = jwp.port_bifpn_state_dict(sd, variables)
    assert not [k for k in report["unused"]
                if not k.endswith("num_batches_tracked")]
    back = twp.jax_to_torch_state_dict(jax.tree.map(np.asarray, ported),
                                       tneck.state_dict(),
                                       twp.map_bifpn_torch_name)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("with_spp", [True, False])
def test_ppyolo_pan_matches_jax(with_spp):
    """Eval mode, and train mode at keep_prob 1.0 (DropBlock off, BatchNorm
    on batch statistics): outputs and the statistics left behind."""
    rng = np.random.default_rng(with_spp)
    feats = _levels(rng, side=8)
    kw = dict(channels=(16, 32, 64), with_spp=with_spp, keep_prob=1.0)
    jneck = JPAN(**kw)
    variables = flax_variables_like(jneck, feats, rng)
    tneck = load_into(PPYOLOPAN([f.shape[-1] for f in feats], **kw),
                      variables, lambda n: tuple(n.split(".")))
    xs = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    jx = [jnp.asarray(f) for f in feats]
    want = jax.jit(jneck.apply)(variables, jx)
    want_t, new = jax.jit(lambda v, x: jneck.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jx)
    with torch.no_grad():
        got = tneck(xs)
        tneck.train()
        got_t = tneck(xs)
    tneck.eval()
    for g, w, gt, wt in zip(got, want, got_t, want_t):
        _assert_close(_nhwc(g), w)
        _assert_close(_nhwc(gt), wt)
    moved = twp.jax_to_torch_state_dict(
        numpy_variables({"params": variables["params"], **new}),
        tneck.state_dict(), lambda n: tuple(n.split(".")))
    for k, v in tneck.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _assert_close(v.numpy(), moved[k], what=k)


def test_dropblock_drops_its_share():
    """keep_prob 0.9 at block 3 over a seeded draw: the zeroed share of
    [16, 8, 40, 40] is within 3 standard deviations of what the JAX
    DropBlock's seed rate gives (each pixel zero unless no seed lands in
    its 3x3 window, the windows clipped at the edges), the kept values are
    scaled by the kept share, and eval mode is the identity."""
    drop = DropBlock(3, 0.9).train()
    x = torch.ones(16, 8, 40, 40)
    y = drop(x, torch.Generator().manual_seed(5))
    mask = y[:, 0] != 0
    assert torch.equal(mask[:, None].expand_as(y), y != 0)   # channel-shared
    h = w = 40
    gamma = 0.1 / 9 * (h * w) / ((h - 2) * (w - 2))
    rows = np.minimum(np.arange(h) + 1, h - 1) - np.maximum(
        np.arange(h) - 1, 0) + 1
    cells = np.outer(rows, rows)                 # window size per pixel
    p_zero = 1 - (1 - gamma) ** cells
    expect = float(p_zero.mean())
    sd = float(np.sqrt((p_zero * (1 - p_zero)).sum() * 9 / (h * w) ** 2
                       / 16))
    got = 1 - float(mask.float().mean())
    assert abs(got - expect) <= 3 * sd, (got, expect, sd)
    kept = y[y != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / mask.float()
                                                .mean().item()))
    drop.eval()
    assert drop(x, None) is x


# ---------------------------------------------------------------------------
# YOLOV7 on ResNet with the bifpn and pan necks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("neck", ["bifpn", "pan"])
def test_yolov7_resnet_neck_forward_matches_jax(neck):
    """At 128 px: BiFPN's fifth level (stride 128) is 1x1 there; at 64 px
    it would be empty, and the JAX model fails on it too."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (2, 2 * SIZE, 2 * SIZE, 3), dtype=np.uint8)
    kw = dict(num_classes=2, neck_type=neck, in_features=("res3", "res4",
                                                          "res5"),
              with_spp=False, act="silu")
    jmodel = jarch.AnchorYOLO(backbone=JResNet(depth=18), **kw)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = tarch.AnchorYOLO(backbone=ResNet(ResNetSpec(depth=18)), **kw)
    mapper = functools.partial(twp.map_anchor_yolo_torch_name,
                               backbone_type="resnet")
    load_into(tmodel, variables, mapper)
    want = jit_o0(jmodel.apply)(variables, jnp.asarray(images, jnp.float32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    assert got["level_hw"] == want["level_hw"] == ((16, 16), (8, 8), (4, 4))
    _assert_close(got["outputs"].numpy(), want["outputs"])


# ---------------------------------------------------------------------------
# the shipped configurations: builders, serving, training
# ---------------------------------------------------------------------------

# yaml under configs/, config class, replacements, the flax map's backbone
SLICE = {
    "yolov5_s": ("coco/yolov5_s.yaml", AnchorYoloConfig, {}, "yolov5"),
    "yolov6_s": ("coco/yolov6_s.yaml", Yolov6Config, {}, None),
    "yolov6_tiny": ("coco/yolov6/yolov6_tiny.yaml", Yolov6Config, {}, None),
    "yolov6_m": ("coco/yolov6/yolov6_m.yaml", Yolov6Config, {}, None),
    "yolof_R_50_DC5_1x": ("coco/yolof/yolof_R_50_DC5_1x.yaml", YolofConfig,
                          {}, None),
    "yolof_r50": ("coco/yolof_r50.yaml", YolofConfig, {}, None),
    "r50_bifpn": ("wearmask/r50_bifpn.yaml", AnchorYoloConfig, {},
                  "resnet"),
    "r50_pan": ("wearmask/r50_pan.yaml", AnchorYoloConfig, {}, "resnet"),
    "r50_bifpn_yolov7": ("wearmask/r50_bifpn.yaml", AnchorYoloConfig,
                         {"MODEL.META_ARCHITECTURE": "YOLOV7"}, "resnet"),
    "r50_pan_yolov7": ("wearmask/r50_pan.yaml", AnchorYoloConfig,
                       {"MODEL.META_ARCHITECTURE": "YOLOV7"}, "resnet"),
    # the JAX YOLOV7 takes any registered backbone by name
    "efficientrep_tiny_yolov7": (
        "coco/yolov7.yaml", AnchorYoloConfig,
        {"MODEL.BACKBONE.NAME": "build_efficientrep_tiny_backbone",
         "MODEL.YOLO.IN_FEATURES": ["erep3", "erep4", "erep5"]},
        "efficientrep"),
    "yolov5_backbone_yolov7": (
        "coco/yolov7.yaml", AnchorYoloConfig,
        {"MODEL.BACKBONE.NAME": "build_yolov5_backbone",
         "MODEL.YOLO.IN_FEATURES": ["c3", "c4", "c5"]}, "yolov5"),
}


def _slice_cfgs(name, **extra):
    yaml, _, opts, _ = SLICE[name]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(str(REPO / "configs" / yaml))
        for k, v in {**opts, **extra}.items():
            node, _, leaf = k.rpartition(".")
            target = c
            for part in node.split("."):
                target = getattr(target, part)
            setattr(target, leaf, v)
    return cfg, jcfg


@pytest.mark.parametrize("name", ["yolov5_s", "r50_bifpn", "r50_pan",
                                  "r50_bifpn_yolov7", "r50_pan_yolov7",
                                  "efficientrep_tiny_yolov7",
                                  "yolov5_backbone_yolov7"])
def test_anchor_builders_match_jax_at_full_depth(name):
    """Leaf for leaf against the flax init's shapes. The wearmask yamls
    build YOLOV7P, whose JAX builder keeps YOLOPAFPN whatever
    ``MODEL.YOLO.NECK.TYPE`` says (ROADMAP.md C.26): the necks run under
    YOLOV7."""
    cfg, jcfg = _slice_cfgs(name)
    tcfg = AnchorYoloConfig.from_cfg(cfg)
    model = build_model(tcfg, "cpu")
    neck = {"r50_bifpn_yolov7": BiFPN, "r50_pan_yolov7": PPYOLOPAN}.get(
        name, YOLOPAFPN)
    assert isinstance(model.neck, neck)
    shapes = jax.eval_shape(
        lambda x: jax_build_model(jcfg).init(jax.random.PRNGKey(0), x),
        jnp.zeros((1, 128, 128, 3), jnp.float32))
    mapper = functools.partial(twp.map_anchor_yolo_torch_name,
                               backbone_type=SLICE[name][3])
    leaves = twp.jax_to_torch_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        model.state_dict(), mapper)
    assert sorted(leaves) == sorted(model.state_dict())


def _tail(name, cfg, out):
    arch = cfg.meta_architecture
    if arch == "YOLOV6":
        return yolox_postprocess(out, cfg.conf_threshold, cfg.nms_threshold,
                                 cfg.max_detections, cfg.pre_nms_topk)
    if arch == "YOLOF":
        return yolof_postprocess(out)
    return tarch.anchor_yolo_postprocess(
        out, "yolov5" if arch == "YOLOV5" else "yolov7", cfg.conf_threshold,
        cfg.nms_threshold, cfg.max_detections, cfg.pre_nms_topk)


@pytest.mark.parametrize("name", sorted(SLICE))
def test_slice_configs_serve_and_train(name):
    """``build_model`` + the tail serves two images and
    ``engine.build_system`` takes one step from the yaml, at full width and
    depth, 64 px (128 with BiFPN), float32: Detections of the configured
    size, finite
    losses, a foreground, moved parameters."""
    size = 2 * SIZE if "bifpn" in name else SIZE  # BiFPN's P7 needs 128
    cfg, _ = _slice_cfgs(name, **{"INPUT.INPUT_SIZE": [size, size],
                                  "SOLVER.AMP.ENABLED": False})
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (2, size, size, 3),
                                           dtype=np.uint8))
    tcfg = SLICE[name][1].from_cfg(cfg)
    assert tcfg.meta_architecture == cfg.MODEL.META_ARCHITECTURE
    with torch.no_grad():
        dets = _tail(name, tcfg, build_model(tcfg, "cpu")(images))
    assert tuple(dets.boxes.shape) == (2, tcfg.max_detections, 4)
    model, state, step, fields = build_system(cfg, device="cpu")
    assert fields == ("image", "gt_boxes", "gt_classes", "gt_valid")
    before = [p.detach().clone() for p in model.parameters()]
    gts = _gts(rng)
    gts["gt_classes"] %= tcfg.num_classes
    batch = {"image": images.float(), **_torch(gts)}
    state, metrics = step(state, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["num_fg"]) >= 1
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(before, model.parameters()))


def test_pan_dropblock_reseeded_by_step():
    """With the pan neck, ``build_system`` draws a step's DropBlock masks
    from the seed and the step (``seed_dropout_by_step``), on the model's
    device."""
    cfg, _ = _slice_cfgs("r50_pan_yolov7",
                         **{"INPUT.INPUT_SIZE": [SIZE, SIZE],
                            "SOLVER.AMP.ENABLED": False})
    model, state, step, _ = build_system(cfg, device="cpu", seed=3)
    assert isinstance(model.generator, torch.Generator)
    assert model.generator is model.neck.generator
    draws = []
    orig = torch.rand

    def spy(*a, **k):
        out = orig(*a, **k)
        if k.get("generator") is model.generator:
            draws.append(out.clone())
        return out

    batch = {"image": torch.zeros((2, SIZE, SIZE, 3)),
             **_torch(_gts(np.random.default_rng(4)))}
    torch.rand = spy
    try:
        step(state, batch)
    finally:
        torch.rand = orig
    assert len(draws) == 3
    gen = torch.Generator().manual_seed(3 * 1_000_003 + 0)
    np.testing.assert_array_equal(
        draws[0].numpy(),
        torch.rand(draws[0].shape, generator=gen).numpy())


def test_yolov6_yolof_configs_read_the_yaml():
    """The dataclass defaults are the yaml files' values (the backbone name
    aside, which neither builder reads)."""
    for name, cls in (("yolov6_s", Yolov6Config),
                      ("yolof_R_50_DC5_1x", YolofConfig)):
        cfg, _ = _slice_cfgs(name)
        got = dataclasses.replace(cls.from_cfg(cfg), backbone=cls.backbone)
        assert got == cls(), name
