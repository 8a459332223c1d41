"""The port's YOLOF against the JAX package, in float32 on the CPU: ResNet-18
(bottleneck blocks, as the JAX ResNet builds every depth) with a 64-channel
encoder at 128 px and 4 classes, as ``tests/test_meta_arch_zoo.py`` runs
the JAX model. The input normalize at YOLOF's statistics, the encoder and
decoder inside one eval forward, the anchors, the delta decode,
``uniform_match`` on a random scene and on one built with ties and shared
anchors, every loss term, a train-mode pass (BatchNorm statistics, FrozenBN
unmoved, losses), serving to ``Detections`` index for index, the weight
carrier both ways, the builders of ``yolof_R_50_DC5_1x.yaml`` and
``yolof_r50.yaml`` at full depth, and the norms the port refuses.

Weights: flax variables drawn with numpy (``flax_variables_like``), moved
into the port by ``jax_to_torch_state_dict`` through
``map_yolof_torch_name``. Each JAX function is compiled once.

Tolerances, each with its reason:

* the normalize, the anchors, the matching and the class map: exact (the
  normalize against the JAX expression op by op; compiled, XLA's
  reciprocal product is within one ulp);
* forward: 1e-4 of each output's largest magnitude (XLA-CPU and oneDNN
  sum each convolution in another order);
* the delta decode: float32 rounding of the same operations (1e-6
  relative);
* loss terms on the same outputs: 1e-5 relative; after a train-mode pass,
  1e-4 relative, and its BatchNorm statistics 1e-4 of each tensor's
  largest magnitude (the forward's);
* the tail: kept indices and classes exact, boxes and scores to float32
  rounding.
"""

import copy
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
    load_into,
    numpy_variables,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import yolof as jf
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import YolofConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
from yolov7_d2_tpu_torch.kernels.preprocess import normalize_images
from yolov7_d2_tpu_torch.models.backbones.resnet import frozen_bn_buffers
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import yolof as tf
from yolov7_d2_tpu_torch.utils import weight_port as twp

REPO = Path(__file__).resolve().parent.parent
SIZE = 128
CLASSES = 4
KW = dict(num_classes=CLASSES, resnet_depth=18, encoder_channels=64)
FWD_TOL = 1e-4
MATCH_KEYS = ("occ_anchor", "occ_gt", "occ_valid", "occ_pos_ignore",
              "winner", "base_cls")


def _assert_close(got, want, tol=FWD_TOL, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _pair():
    """(flax YOLOF, variables, port YOLOF holding them, uint8 images)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    jmodel = jf.YOLOF(**KW)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = load_into(tf.YOLOF(**KW), variables, twp.map_yolof_torch_name)
    return jmodel, variables, tmodel, images


@functools.lru_cache(maxsize=None)
def _jax_eval():
    jmodel, variables, _, images = _pair()
    out = jax.jit(jmodel.apply)(variables, jnp.asarray(images, jnp.float32))
    return {k: np.asarray(v) for k, v in out.items()}


def _gts(rng, counts=(3, 5), g=6):
    boxes = np.zeros((len(counts), g, 4), np.float32)
    valid = np.zeros((len(counts), g), bool)
    for i, n in enumerate(counts):
        wh = rng.uniform(0.2, 0.8, (n, 2)) * SIZE
        c = rng.uniform(wh / 2, SIZE - wh / 2)
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :n] = True
    classes = (rng.integers(0, CLASSES, valid.shape) * valid).astype(np.int32)
    return {"gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid}


def test_normalize_is_the_jax_models_input():
    """The normalize (the kernel's wrapper; its plain version on the CPU) at
    YOLOF's mean and std is bit for bit the JAX model's expression
    ``(images - mean) / std`` in float32 (JAX :173, run op by op). Compiled
    with the statistics as constants, XLA turns the division into a
    product with the reciprocal, which moves some elements by one float32
    ulp (measured: 647 of 2304); the port keeps the division."""
    images = np.random.default_rng(1).integers(0, 256, (2, 16, 24, 3),
                                               dtype=np.uint8)
    assert tf.PIXEL_MEAN == (103.53, 116.28, 123.675)
    assert tf.PIXEL_STD == (57.375, 57.12, 58.395)

    def expr(x):
        return ((x - jnp.asarray([103.53, 116.28, 123.675]))
                / jnp.asarray([57.375, 57.12, 58.395]))

    x = jnp.asarray(images, jnp.float32)
    got = normalize_images(torch.from_numpy(images), tf.PIXEL_MEAN,
                           tf.PIXEL_STD, torch.float32)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(expr(x)))
    np.testing.assert_array_max_ulp(got, np.asarray(jax.jit(expr)(x)), 1)


def test_forward_matches_jax():
    _, _, tmodel, images = _pair()
    want = _jax_eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    a = (SIZE // 32) ** 2 * 5
    assert tuple(got["logits"].shape) == (2, a, CLASSES)
    assert tuple(got["deltas"].shape) == (2, a, 4)
    np.testing.assert_array_equal(got["anchors"].numpy(), want["anchors"])
    for k in ("logits", "deltas"):
        assert got[k].dtype == torch.float32
        _assert_close(got[k].numpy(), want[k], what=k)
    with torch.no_grad():
        again = tmodel(torch.from_numpy(images).float())
    assert torch.equal(again["logits"], got["logits"])


@pytest.mark.parametrize("hw", [(1, 1), (4, 4), (25, 19)])
def test_anchors_match_jax(hw):
    np.testing.assert_array_equal(tf.yolof_anchors(*hw).numpy(),
                                  jf.yolof_anchors(*hw))


def test_decode_deltas_matches_jax():
    rng = np.random.default_rng(4)
    anchors = jf.yolof_anchors(3, 3)
    deltas = rng.normal(0, 2, (2, anchors.shape[0], 4)).astype(np.float32)
    deltas[0, :5, 2:] = 9.0            # past the scale clamp
    want = jax.jit(jf.decode_deltas)(anchors[None], deltas)
    got = tf.decode_deltas(torch.from_numpy(anchors)[None],
                           torch.from_numpy(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def tie_scene():
    """Predicted boxes equal to their anchors (each gt's two top-k lists
    coincide), gts centred on the boundary between two cells (equal L1
    costs straddle the top-k cut), a gt given twice and two gts sharing
    anchors (later occurrences overwrite), an invalid slot pointing at the
    same cell."""
    anchors = jf.yolof_anchors(4, 4)
    pred = np.repeat(anchors[None], 2, 0).copy()
    pred[1, ::3] += 3.0
    boxes = np.zeros((2, 5, 4), np.float32)
    boxes[0, 0] = [32.0, 16.0, 96.0, 80.0]        # centre x 64: cells 1|2
    boxes[0, 1] = [32.0, 16.0, 96.0, 80.0]        # the same gt again
    boxes[0, 2] = [40.0, 20.0, 100.0, 84.0]       # overlaps, shares anchors
    boxes[0, 3] = [0.0, 0.0, 128.0, 128.0]        # centre on a corner
    boxes[0, 4] = [32.0, 16.0, 96.0, 80.0]
    boxes[1, 0] = [10.0, 70.0, 60.0, 120.0]
    boxes[1, 1] = [48.0, 48.0, 80.0, 80.0]
    valid = np.array([[True, True, True, True, False],
                      [True, True, False, False, False]])
    classes = np.array([[1, 2, 3, 0, 1], [2, 0, 0, 0, 0]], np.int32)
    return anchors, pred, {"gt_boxes": boxes, "gt_classes": classes,
                           "gt_valid": valid}


def _jax_match(anchors, pred, batch):
    m = jax.jit(jax.vmap(lambda pb, gb, gv: jf.uniform_match(
        pb, jnp.asarray(anchors), gb, gv, num_classes=CLASSES)))(
        pred, batch["gt_boxes"], batch["gt_valid"])
    return {k: np.asarray(v) for k, v in m.items()}


def _jax_cls_map(m, gt_classes, a):
    occ_cls = np.where(m["occ_pos_ignore"], -1,
                       np.take_along_axis(gt_classes, m["occ_gt"], 1))
    out = m["base_cls"].copy()
    for b in range(out.shape[0]):
        for j in np.flatnonzero(m["winner"][b]):
            out[b, m["occ_anchor"][b, j]] = occ_cls[b, j]
    return out


@pytest.mark.parametrize("scene", ["random", "ties"])
def test_uniform_match_matches_jax(scene):
    if scene == "ties":
        anchors, pred, batch = tie_scene()
    else:
        out = _jax_eval()
        anchors = out["anchors"]
        pred = np.asarray(jax.jit(jf.decode_deltas)(anchors[None],
                                                     out["deltas"]))
        batch = _gts(np.random.default_rng(5))
    want = _jax_match(anchors, pred, batch)
    got = tf.uniform_match(torch.from_numpy(pred), torch.from_numpy(anchors),
                           torch.from_numpy(batch["gt_boxes"]),
                           torch.from_numpy(batch["gt_valid"]),
                           num_classes=CLASSES)
    for k in MATCH_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    cls_map = tf.class_map(got, torch.from_numpy(batch["gt_classes"]),
                           anchors.shape[0])
    np.testing.assert_array_equal(
        cls_map.numpy(), _jax_cls_map(want, batch["gt_classes"],
                                      anchors.shape[0]))
    if scene == "ties":
        # an anchor claimed more than once, resolved to its last claim
        occ = want["occ_anchor"][0][want["occ_valid"][0]]
        assert len(occ) > len(np.unique(occ))
        assert not want["winner"][0][want["occ_valid"][0]].all()


@functools.lru_cache(maxsize=None)
def _jax_losses():
    return jax.jit(lambda out, b: jf.yolof_losses(out, b, CLASSES))


@pytest.mark.parametrize("scene", ["random", "ties"])
def test_losses_match_jax(scene):
    out = _jax_eval()
    if scene == "ties":
        anchors, _, batch = tie_scene()
        out = {"logits": np.resize(out["logits"], (2, anchors.shape[0],
                                                   CLASSES)),
               "deltas": np.zeros((2, anchors.shape[0], 4), np.float32),
               "anchors": anchors}
    else:
        batch = _gts(np.random.default_rng(6))
    want = _jax_losses()(out, batch)
    got = tf.yolof_losses(_torch(out), _torch(batch), CLASSES)
    assert sorted(got) == sorted(want)
    assert float(want["num_fg"]) >= 4
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_train_mode_bn_statistics_and_losses():
    """A train-mode pass: the encoder's and decoder's BatchNorm statistics,
    the ResNet's FrozenBN statistics unmoved, and every loss term."""
    jmodel, variables, tmodel, _ = _pair()
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    batch = _gts(rng, counts=(4, 2))

    def run(v):
        out, new = jmodel.apply(v, jnp.asarray(images), train=True,
                                mutable=["batch_stats"])
        return jf.yolof_losses(out, batch, CLASSES), new

    jlosses, jnew = jax.jit(run)(variables)
    model = copy.deepcopy(tmodel).train()
    frozen = [b.clone() for b in frozen_bn_buffers(model)]
    losses = tf.yolof_losses(model(torch.from_numpy(images)), _torch(batch),
                             CLASSES)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=1e-4, err_msg=k)
    assert frozen and all(torch.equal(a, b) for a, b in
                          zip(frozen, frozen_bn_buffers(model)))
    moved = twp.jax_to_torch_state_dict(
        numpy_variables({"params": variables["params"], **jnew}),
        model.state_dict(), twp.map_yolof_torch_name)
    n = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")) and \
                not k.startswith("backbone."):
            _assert_close(v.numpy(), moved[k], what=k)
            n += 1
    assert n == 2 * (2 + 4 * 3 + 6)


def test_tail_matches_jax_index_for_index():
    out = _jax_eval()
    kw = dict(score_thresh=0.05, nms_thresh=0.6, topk_candidates=300,
              max_detections=100)
    want = jax.jit(functools.partial(jf.yolof_postprocess, **kw))(out)
    got = tf.yolof_postprocess(_torch(out), **kw)
    plain = tf.yolof_postprocess(_torch(out), nms=nms_batched_plain, **kw)
    assert int(got.valid.sum()) > 10
    for f in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))
        assert torch.equal(getattr(got, f), getattr(plain, f))


def test_weight_carrier_both_ways():
    """The port's state dict (the reference's names) through the JAX maps
    (``map_d2_resnet_name``, ``map_yolof_encoder_torch_name``,
    ``map_yolof_decoder_torch_name``) gives the JAX model the port's
    outputs; the port's carrier gives the state dict back."""
    jmodel, variables, tmodel, images = _pair()
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}

    def mapper(name):
        prefix, _, rest = name.partition(".")
        if prefix == "encoder":
            return ("encoder",) + jwp.map_yolof_encoder_torch_name(rest)
        if prefix == "decoder":
            return ("decoder",) + jwp.map_yolof_decoder_torch_name(rest)
        return jwp.map_d2_resnet_name(name)

    ported, report = jwp.port_torch_state_dict(sd, variables,
                                               name_mapper=mapper)
    assert not report["unused"], report["unused"][:5]
    want = jax.jit(jmodel.apply)(ported, jnp.asarray(images, jnp.float32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    _assert_close(got["logits"].numpy(), want["logits"])
    back = twp.jax_to_torch_state_dict(jax.tree.map(np.asarray, ported),
                                       tmodel.state_dict(),
                                       twp.map_yolof_torch_name)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("yaml", ["yolof/yolof_R_50_DC5_1x.yaml",
                                  "yolof_r50.yaml"])
def test_builders_match_jax_at_full_depth(yaml):
    """Every parameter and statistic of the full-depth model has its flax
    leaf of the same shape, none is left over, and res5 stays at stride 32
    whatever ``RES5_DILATION`` says, as in the JAX builder (ROADMAP.md
    C.24)."""
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(str(REPO / "configs" / "coco" / yaml))
    tcfg = YolofConfig.from_cfg(cfg)
    model = build_model(tcfg, "cpu")
    shapes = jax.eval_shape(
        lambda x: jax_build_model(jcfg).init(jax.random.PRNGKey(0), x),
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    leaves = twp.jax_to_torch_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        model.state_dict(), twp.map_yolof_torch_name)
    assert sorted(leaves) == sorted(model.state_dict())
    with torch.no_grad():
        out = build_model(dataclasses.replace(tcfg, amp=False), "cpu")(
            torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert tuple(out["anchors"].shape) == ((64 // 32) ** 2 * 5, 4)


@pytest.mark.parametrize("norm", ["SyncBN", "GN", ""])
def test_build_yolof_refuses_norms_the_jax_maps_silently(norm):
    """ROADMAP.md C.2: the JAX ``build_yolof`` takes any norm but FrozenBN
    for a trainable BatchNorm; the port builds FrozenBN and BN and raises
    for the rest."""
    cfg = dataclasses.replace(YolofConfig(), resnet_norm=norm, amp=False)
    with pytest.raises(NotImplementedError, match="C.2"):
        build_model(cfg, "cpu")
    model = build_model(dataclasses.replace(cfg, resnet_norm="BN"), "cpu")
    assert not frozen_bn_buffers(model)
