"""The port's YOLOX serving slice against the JAX package, in float32 on
the CPU.

Weights: the flax init, moved into the port by ``jax_to_torch_state_dict``.
The BatchNorm statistics are then calibrated on the test batch in the port
(so that activations are of order 1, as in a trained model) and moved back
into the flax variables by the JAX package's own
``port_torch_state_dict``. Both sides then hold the same numbers.

Tolerances, each with its reason:
* model outputs: max abs error 1e-4 times the largest magnitude of the
  tensor (and at least 1e-4). XLA-CPU and oneDNN sum each convolution in a
  different order, and the calibrated BatchNorm layers carry that float32
  rounding through some 60 layers; both sides are equally far from a
  float64 run of the port;
* postprocess on shared head outputs: valid mask and classes exact, boxes and
  scores within 1e-6 absolute plus 1e-6 relative (one float32 ulp of a box
  coordinate in the hundreds of pixels, where exp may differ by an ulp);
* image -> Detections: valid mask and classes exact, once the test has
  asserted that the smallest gap between kept scores exceeds 10x the largest
  difference between the two sides' scores.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import load_into, nchw_to_nhwc
from yolov7_d2_tpu.models.meta_arch.yolox import YOLOX as JaxYOLOX
from yolov7_d2_tpu.models.meta_arch.yolox import (
    yolox_postprocess as jax_postprocess,
)
from yolov7_d2_tpu.utils.weight_port import port_torch_state_dict
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.kernels.preprocess import normalize_images
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch.yolox import YOLOX, yolox_postprocess
from yolov7_d2_tpu_torch.predictor import Predictor
from yolov7_d2_tpu_torch.utils.weight_port import jax_to_torch_state_dict

FWD_TOL = 1e-4
POST_TOL = 1e-6
VAR_FLOOR = 0.3

# (classes, depth, width, input size): __graft_entry__._tiny_cfg and YOLOX-s
SCALES = {"tiny": (8, 0.33, 0.25, 64), "yolox_s": (80, 0.33, 0.50, 128)}


@functools.lru_cache(maxsize=None)
def _pair(scale):
    classes, depth, width, size = SCALES[scale]
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    jmodel = JaxYOLOX(num_classes=classes, depth_mul=depth, width_mul=width)
    variables = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x))(
        jnp.asarray(images, jnp.float32))
    tmodel = load_into(
        YOLOX(classes, depth, width, dtype=torch.float32),
        variables)
    # calibrate the BatchNorm statistics on the batch in one eval pass, each
    # layer on the input it sees in eval mode, then hand them back; the
    # variance floor keeps near-constant channels from amplifying rounding
    def calibrate(bn, inputs):
        bn.running_mean.copy_(inputs[0].mean((0, 2, 3)))
        bn.running_var.copy_(
            inputs[0].var((0, 2, 3), unbiased=False).clamp(min=VAR_FLOOR))

    hooks = [m.register_forward_pre_hook(calibrate)
             for m in tmodel.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        tmodel(torch.from_numpy(images))
    for h in hooks:
        h.remove()
    variables, report = port_torch_state_dict(
        {k: v.numpy() for k, v in tmodel.state_dict().items()}, variables,
        strict=True)
    assert not report["unused"]
    return jmodel, variables, tmodel, images


def _jax_forward(jmodel, variables, images):
    def fn(v, x):
        return jmodel.apply(
            v, x, capture_intermediates=lambda m, _: m.name in
            ("backbone", "neck"), mutable=["intermediates"])
    out, inter = jax.jit(fn)(variables, jnp.asarray(images, jnp.float32))
    inter = inter["intermediates"]
    return (inter["backbone"]["__call__"][0], inter["neck"]["__call__"][0],
            out)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _assert_close(got, want):
    tol = FWD_TOL * max(1.0, float(np.max(np.abs(np.asarray(want)))))
    assert _max_err(got, want) <= tol, (_max_err(got, want), tol)


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_yolox_forward_matches_jax(scale):
    jmodel, variables, tmodel, images = _pair(scale)
    jfeats, jfpn, jout = _jax_forward(jmodel, variables, images)
    with torch.no_grad():
        x = normalize_images(torch.from_numpy(images), (0.0,) * 3, (1.0,) * 3,
                             torch.float32)
        feats = tmodel.backbone(x)
        fpn = tmodel.neck([feats[f] for f in tmodel.in_features])
        out = tmodel.head(fpn)
        whole = tmodel(torch.from_numpy(images))
    for name in ("dark3", "dark4", "dark5"):
        _assert_close(nchw_to_nhwc(feats[name]), jfeats[name])
    for got, want in zip(fpn, jfpn):
        _assert_close(nchw_to_nhwc(got), want)
    for key in ("outputs", "grids", "strides"):
        assert out[key].shape == jout[key].shape
        assert out[key].dtype == torch.float32
        _assert_close(out[key].numpy(), jout[key])
        assert torch.equal(whole[key], out[key])
    np.testing.assert_array_equal(out["grids"].numpy(), jout["grids"])
    np.testing.assert_array_equal(out["strides"].numpy(), jout["strides"])


def _head_layout(size):
    grids, strides = [], []
    for s in (8, 16, 32):
        n = size // s
        ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        grids.append(np.stack([xs, ys], -1).reshape(-1, 2))
        strides.append(np.full(n * n, s))
    return (np.concatenate(grids).astype(np.float32),
            np.concatenate(strides).astype(np.float32))


def _assert_detections_match(got, want, tol=POST_TOL):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy()[valid],
                                  np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_postprocess_matches_jax_on_shared_head_outputs(dtype):
    rng = np.random.default_rng(1)
    grids, strides = _head_layout(640)                 # 8400 anchors
    out = rng.normal(0.0, 1.5, (2, grids.shape[0], 85)).astype(np.float32)
    out[..., 2:4] = rng.normal(1.5, 0.7, out[..., 2:4].shape)  # overlap
    head = {"grids": grids, "strides": strides}
    jout = jnp.asarray(out).astype(getattr(jnp, dtype))
    want = jax.jit(lambda h: jax_postprocess(h, 0.01, 0.65, 100, 1024))(
        {**head, "outputs": jout})
    tout = torch.tensor(np.asarray(jout.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = yolox_postprocess(
        {"outputs": tout, "grids": torch.from_numpy(grids),
         "strides": torch.from_numpy(strides)}, 0.01, 0.65, 100, 1024)
    assert got.boxes.shape == (2, 100, 4) and got.valid.dtype == torch.bool
    assert got.classes.dtype == torch.int32
    _assert_detections_match(got, want)
    assert np.asarray(want.valid).sum() == 200


def test_image_to_detections_matches_jax():
    jmodel, variables, tmodel, _ = _pair("tiny")
    # fresh images, not the calibration batch; seed 11 keeps the kept scores
    # some 400x the score difference apart (asserted below at 10x)
    images = np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    want_out = jax.jit(lambda v, x: jmodel.apply(v, x))(
        variables, jnp.asarray(images, jnp.float32))
    want = jax_postprocess(want_out, 0.01, 0.65, 100, 1024)
    cfg = YoloxConfig(num_classes=8, width_mul=0.25, input_size=(64, 64),
                      amp=False)
    predictor = Predictor(cfg, device="cpu", model=tmodel)
    head = predictor.forward(torch.from_numpy(images))
    score_err = _max_err(_scores(head["outputs"].numpy()),
                         _scores(want_out["outputs"]))
    got = predictor.predict_batch(torch.from_numpy(images))
    # the seed is not lucky: the kept scores, which order the greedy NMS,
    # are far apart against the difference of the two forwards
    assert int(np.asarray(want.valid).sum()) > 10
    for b in range(images.shape[0]):
        kept = np.sort(np.asarray(want.scores[b])[np.asarray(want.valid[b])])
        assert np.min(np.diff(kept)) > 10 * score_err, (
            np.min(np.diff(kept)), score_err)
    # boxes: exp(tw) * stride carries the forward error into pixels
    _assert_detections_match(got, want, tol=1e-3)


def _scores(outputs):
    """sigmoid(obj) * sigmoid(best class logit), in float64."""
    out = np.asarray(outputs, np.float64)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    return sig(out[..., 4]) * sig(out[..., 5:].max(-1))


def test_jax_to_torch_state_dict_round_trips():
    jmodel, variables, tmodel, _ = _pair("tiny")
    sd = jax_to_torch_state_dict(variables, tmodel.state_dict())
    for key, value in tmodel.state_dict().items():
        np.testing.assert_array_equal(sd[key], value.numpy())
    back, report = port_torch_state_dict(sd, variables, strict=True)
    assert not report["unused"]
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(back_leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(back_leaves[path], np.asarray(leaf))


def test_jax_to_torch_state_dict_rejects_mismatches():
    _, variables, tmodel, _ = _pair("tiny")
    template = dict(tmodel.state_dict())
    key = "backbone.dark2.0.conv.weight"
    bad = dict(template, **{key: template[key][:1]})
    with pytest.raises(ValueError, match="shape"):
        jax_to_torch_state_dict(variables, bad)
    with pytest.raises(KeyError):
        jax_to_torch_state_dict(variables,
                                dict(template, **{"head.extra.weight":
                                                  template[key]}))
    with pytest.raises(KeyError, match="no port key"):
        jax_to_torch_state_dict(
            variables, {k: v for k, v in template.items() if k != key})


def test_name_map_copy_matches_jax_on_yolox_s():
    """The port's copy of ``map_yolox_torch_name`` against the JAX
    package's, on every module name of the YOLOX-s ``state_dict``."""
    from yolov7_d2_tpu.utils.weight_port import (
        map_yolox_torch_name as jax_map,
    )
    from yolov7_d2_tpu_torch.utils.weight_port import map_yolox_torch_name

    keys = build_model(YoloxConfig(), "cpu").state_dict().keys()
    modules = sorted({k.rpartition(".")[0] for k in keys})
    assert len(keys) > 300 and len(modules) > 80
    for name in modules:
        assert map_yolox_torch_name(name) == jax_map(name), name


def test_build_model_registry():
    cfg = YoloxConfig(num_classes=8, width_mul=0.25, amp=False)
    model = build_model(cfg, "cpu", seed=3)
    again = build_model(cfg, "cpu", seed=3)
    assert not model.training
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    # Mask R-CNN builds from its own config only
    with pytest.raises(NotImplementedError, match="takes an RcnnConfig"):
        build_model(YoloxConfig(meta_architecture="MaskRCNN"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(YoloxConfig(meta_architecture="RetinaNet"))
    # any registered backbone builds; an unregistered name raises, naming
    # it
    model = build_model(YoloxConfig(
        backbone="build_mobilevit_backbone", width_mul=0.25, amp=False,
        in_features=("stage2", "stage3", "stage4")), "cpu")
    assert type(model.backbone).__name__ == "MobileViT"
    with pytest.raises(NotImplementedError, match="'build_swin_backbone'"):
        build_model(YoloxConfig(backbone="build_swin_backbone"))


def test_decode_outputs_matches_jax():
    from yolov7_d2_tpu.models.heads.yolox_head import (
        decode_outputs as jax_decode,
    )
    from yolov7_d2_tpu_torch.models.heads.yolox_head import decode_outputs

    rng = np.random.default_rng(2)
    grids, strides = _head_layout(128)
    out = rng.normal(0.0, 3.0, (2, grids.shape[0], 13)).astype(np.float32)
    out[0, 0, 2:4] = 20.0  # past the exp clamp
    want = jax_decode(jnp.asarray(out), jnp.asarray(grids),
                      jnp.asarray(strides))
    got = decode_outputs(torch.from_numpy(out), torch.from_numpy(grids),
                         torch.from_numpy(strides))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=POST_TOL,
                                   atol=POST_TOL)


def test_letterbox_and_call_match_jax_pipeline():
    from yolov7_d2_tpu.data.transforms.augment import letterbox as jax_lb
    from yolov7_d2_tpu_torch.data.transforms.augment import letterbox

    rng = np.random.default_rng(4)
    bgr = rng.integers(0, 256, (37, 50, 3), dtype=np.uint8)
    want, _, want_scale = jax_lb(bgr, np.zeros((0, 4), np.float32), (64, 64),
                                 114)
    got, _, scale = letterbox(bgr, np.zeros((0, 4), np.float32), (64, 64),
                              114)
    np.testing.assert_array_equal(got, want)
    assert scale == want_scale
    _, _, tmodel, _ = _pair("tiny")
    cfg = YoloxConfig(num_classes=8, width_mul=0.25, input_size=(64, 64),
                      amp=False)
    predictor = Predictor(cfg, device="cpu", model=tmodel)
    res = predictor(bgr)
    dets = predictor.predict_batch(torch.from_numpy(got)[None])
    valid = dets.valid[0].numpy()
    np.testing.assert_array_equal(res["boxes"],
                                  dets.boxes[0].numpy()[valid] / scale)
    np.testing.assert_array_equal(res["classes"], dets.classes[0].numpy()[valid])
