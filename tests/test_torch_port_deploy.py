"""The port's deploy package (``yolov7_d2_tpu_torch/deploy``) and its export
CLI against the JAX package's ``deploy/`` and ``export.py``, on the CPU at
tiny size (YOLOX at 64 px, width 0.125, 2 classes; the tiny DETR of
``_torch_port_helpers.detr_pair`` for the attention kernels), float32.

* export: a function, and a tiny YOLOX with and without YOLOX's tail
  fused in, through ``export_program`` / ``export_inference_fn`` and
  ``load_program`` against the JAX ``export_stablehlo`` /
  ``export_inference_fn`` and ``load_stablehlo(...).call`` on the same
  weights (flax variables drawn with numpy, moved by the carrier): outputs
  within 1e-4 of their largest magnitude (at least 1), the ``Detections``
  index-equal; the metadata keys and values equal; the artifact loaded in
  a fresh process; a bf16 model's program convolving in bfloat16; the CLI
  with ``--weights`` and ``--fuse-postprocess``;
* quantization: int8 values equal and scales within 1e-7 relative (the
  JAX ones mapped through the carrier), the dequantized bf16 weights, the
  observer and ``calibrate`` on the same arrays, ``fake_quant``'s forward
  and straight-through gradient, ``qat_transform_params`` and its
  gradient, on the tiny YOLOX and the tiny DETR (on a ResNet-18, so that
  the JAX functions, which run op by op, compile fewer shapes);
* pruning: both prunes' masks equal (mapped through the carrier), and the
  sparsity report by the carrier's names.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    DETR_DIMS,
    DETR_SIZE,
    REPO,
    detr_variables_like,
    flax_variables_like,
    load_into,
    tiny_cfg,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.deploy import export as jexport
from yolov7_d2_tpu.deploy import prune as jprune
from yolov7_d2_tpu.deploy import quantize as jquant
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import detr as jdetr
from yolov7_d2_tpu.models.meta_arch.yolox import (
    yolox_postprocess as jax_postprocess,
)
from yolov7_d2_tpu_torch import export as cli
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.deploy import export, prune, quantize
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import detr as tdetr
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess
from yolov7_d2_tpu_torch.utils.weight_port import (
    jax_to_torch_state_dict,
    map_detr_torch_name,
    map_yolox_torch_name,
)

TOL = 1e-4
SIZE = 64


@pytest.fixture(scope="module")
def yolox():
    """(flax YOLOX, variables, port YOLOX holding them, float32 images
    [2, 64, 64, 3] of integer values, the carrier's name map)."""
    jmodel = jax_build_model(tiny_cfg(jax_get_cfg))
    model = build_model(YoloxConfig.from_cfg(tiny_cfg(get_cfg)), "cpu")
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = flax_variables_like(jmodel, images, rng)
    load_into(model, variables)
    return jmodel, variables, model, images, map_yolox_torch_name


@pytest.fixture(scope="module")
def detr():
    """(flax variables, port DETR holding them, carrier map): the tiny
    transformer of ``_torch_port_helpers.DETR_DIMS`` on a ResNet-18."""
    kw = dict(DETR_DIMS, num_queries=10, dropout=0.0, resnet_depth=18)
    model = tdetr.DETR(**kw)
    variables = detr_variables_like(jdetr.DETR(**kw),
                                    (2, DETR_SIZE, DETR_SIZE, 3),
                                    np.random.default_rng(8))
    load_into(model, variables, map_detr_torch_name)
    return variables, model, map_detr_torch_name


@pytest.fixture(scope="module", params=["yolox", "detr"])
def pair(request, yolox, detr):
    """(flax variables, port model, carrier map) of both tiny models."""
    if request.param == "yolox":
        _, variables, model, _, mapper = yolox
        return variables, model, mapper
    return detr


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def _post(out):
    d = yolox_postprocess(out, 0.01, 0.65, 100, 1024)
    return d.boxes, d.scores, d.classes, d.valid


def _jax_post(out):
    d = jax_postprocess(out, 0.01, 0.65, 100, 1024)
    return d.boxes, d.scores, d.classes, d.valid


def _check_detections(got, want):
    boxes, scores, classes, valid = (np.asarray(w) for w in want)
    assert valid.sum() > 10
    assert np.array_equal(got[3].numpy(), valid)
    assert np.array_equal(got[2].numpy()[valid], classes[valid])
    _close(got[0].detach().numpy()[valid], boxes[valid], "boxes")
    _close(got[1].detach().numpy()[valid], scores[valid], "scores")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_function_round_trip_matches_jax(tmp_path):
    x = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    path = export.export_program(lambda t: (t * 2.0 + 1.0).sum(-1),
                                 (torch.from_numpy(x),),
                                 str(tmp_path / "fn.pt2"))
    got = export.load_program(path).module()(torch.from_numpy(x))
    jpath = jexport.export_stablehlo(lambda t: (t * 2.0 + 1.0).sum(-1),
                                     (jnp.asarray(x),),
                                     str(tmp_path / "fn.stablehlo"))
    want = jexport.load_stablehlo(jpath).call(jnp.asarray(x))
    _close(got.numpy(), want, "fn")


@pytest.mark.parametrize("fused", [False, True])
def test_yolox_round_trip_matches_jax(yolox, tmp_path, fused):
    jmodel, variables, model, images, _ = yolox
    shape = images.shape
    paths = export.export_inference_fn(model, shape, str(tmp_path / "port"),
                                       _post if fused else None)
    jpaths = jexport.export_inference_fn(
        jmodel, variables, shape, str(tmp_path / "jax"),
        _jax_post if fused else None)
    with open(paths["meta"]) as f, open(jpaths["meta"]) as g:
        assert json.load(f) == json.load(g)
    program = export.load_program(paths["program"])
    with torch.no_grad():
        got = program.module()(torch.from_numpy(images))
    want = jexport.load_stablehlo(jpaths["stablehlo"]).call(
        jnp.asarray(images))
    if fused:
        _check_detections(got, want)
        nodes = [str(n.target) for n in program.graph.nodes]
        assert "yolov7_d2_tpu_torch.nms_batched.default" in nodes
    else:
        _close(got["outputs"].numpy(), want["outputs"], "outputs")


def test_artifact_loads_in_a_fresh_process(yolox, tmp_path):
    _, _, model, images, _ = yolox
    paths = export.export_inference_fn(model, images.shape, str(tmp_path),
                                       _post)
    np.save(tmp_path / "images.npy", images)
    code = (
        "import sys, numpy as np, torch\n"
        "from yolov7_d2_tpu_torch.deploy.export import load_program\n"
        "p = load_program(sys.argv[1])\n"
        "with torch.no_grad():\n"
        "    out = p.module()(torch.from_numpy(np.load(sys.argv[2])))\n"
        "torch.save(out, sys.argv[3])\n"
        "print('jax' in sys.modules)\n")
    run = subprocess.run(
        [sys.executable, "-c", code, paths["program"],
         str(tmp_path / "images.npy"), str(tmp_path / "out.pt")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == "False"
    got = torch.load(tmp_path / "out.pt")
    with torch.no_grad():
        want = _post(model(torch.from_numpy(images)))
    # the other process may sum the convolutions on another number of
    # threads: the same detections, values within the tolerance
    _check_detections(got, [w.numpy() for w in want])


def test_bf16_model_exports_a_bf16_program(tmp_path):
    cfg = YoloxConfig.from_cfg(tiny_cfg(get_cfg, SOLVER__AMP__ENABLED=True))
    model = build_model(cfg, "cpu")
    paths = export.export_inference_fn(model, (1, SIZE, SIZE, 3),
                                       str(tmp_path))
    dtypes = export.conv_dtypes(export.load_program(paths["program"]))
    assert list(dtypes) == ["bfloat16"] and dtypes["bfloat16"] > 50


def test_export_cli_with_weights_and_the_fused_tail(tmp_path, capsys):
    cfg = tiny_cfg(get_cfg)
    model = build_model(YoloxConfig.from_cfg(cfg), "cpu", seed=7)
    weights = dict(model.state_dict(), extra_key=torch.zeros(2))
    torch.save({"model": weights}, tmp_path / "w.pth")
    opts = [k for kv in (("MODEL.YOLO.CLASSES", "2"),
                         ("MODEL.YOLO.WIDTH_MUL", "0.125"),
                         ("INPUT.INPUT_SIZE", "[64, 64]"),
                         ("SOLVER.AMP.ENABLED", "False"),
                         ("MODEL.DEVICE", "cpu")) for k in kv]
    paths = cli.main(["--config-file", str(REPO / "configs" / "coco" /
                                            "yolox_s.yaml"),
                      "--output", str(tmp_path / "out"), "--batch", "2",
                      "--fuse-postprocess", "--weights",
                      str(tmp_path / "w.pth"), *opts])
    printed = capsys.readouterr().out
    assert f"ported {len(weights) - 1} tensors, 1 unmatched" in printed
    with open(paths["meta"]) as f:
        meta = json.load(f)
    assert meta == {"input_shape": [2, 64, 64, 3], "input_dtype": "float32",
                    "layout": "NHWC", "postprocess_fused": True}
    images = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        got = export.load_program(paths["program"]).module()(images)
        want = _post(model(images))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(NotImplementedError, match="YOLOX's tail"):
        cli.main(["--config-file", str(REPO / "configs" / "coco" /
                                       "yolov7.yaml"),
                  "--fuse-postprocess", "MODEL.DEVICE", "cpu"])


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _flat_with_none(tree):
    return jax.tree_util.tree_flatten(tree, is_leaf=lambda x: x is None)[0]


def _to_port(variables, params_tree, model, mapper):
    """A flax ``params`` tree (same structure as ``variables['params']``)
    -> the port's names and layouts through the carrier."""
    return jax_to_torch_state_dict(
        {"params": jax.tree.map(np.asarray, params_tree),
         "batch_stats": variables.get("batch_stats", {})},
        model.state_dict(), mapper)


def test_quantize_and_dequantize_match_jax(pair):
    variables, model, mapper = pair
    jq, js = jquant.quantize_weights_int8(variables["params"])
    q, s = quantize.quantize_weights_int8(model)
    # the scales broadcast to their leaves, so that the carrier maps them
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    jscale = jax.tree_util.tree_unflatten(treedef, [
        np.broadcast_to(np.asarray(sc), np.shape(leaf)) if sc is not None
        else np.zeros(np.shape(leaf), np.float32)
        for leaf, sc in zip(leaves, _flat_with_none(js))])
    want_q = _to_port(variables, jax.tree.map(
        lambda a: np.asarray(a, np.float32), jq), model, mapper)
    want_s = _to_port(variables, jscale, model, mapper)
    jdq = jquant.dequantize_weights(jq, js, jnp.bfloat16)
    want_dq = _to_port(variables, jax.tree.map(
        lambda a: np.asarray(a, np.float32), jdq), model, mapper)
    dq = quantize.dequantize_weights(q, s, torch.bfloat16)
    quantized = [k for k in q if s[k] is not None]
    assert len(quantized) > 20
    assert any(k.endswith("in_proj_weight") for k in quantized) == (
        "transformer.encoder.layers.0.self_attn.in_proj_weight" in q)
    for name in q:
        if s[name] is None:
            assert torch.equal(q[name], torch.from_numpy(want_q[name]))
            continue
        assert q[name].dtype == torch.int8
        assert np.array_equal(q[name].numpy(), want_q[name]), name
        got_s = torch.broadcast_to(s[name], q[name].shape).numpy()
        np.testing.assert_allclose(got_s, want_s[name], rtol=1e-7,
                                   atol=0, err_msg=name)
        np.testing.assert_allclose(dq[name].float().numpy(), want_dq[name],
                                   rtol=2 ** -8, atol=0, err_msg=name)
        # each element within its half scale of the weight
        w = dict(model.named_parameters())[name].detach()
        assert float(((q[name].float() * s[name] - w).abs()
                      - s[name] / 2).max()) <= 1e-6 * float(w.abs().max())


def test_observer_and_calibrate_match_jax():
    rng = np.random.default_rng(3)
    batches = [{"a": rng.normal(size=(4, 7)).astype(np.float32),
                "b": [rng.uniform(-3, 5, (5,)).astype(np.float32)]}
               for _ in range(3)]
    for pct in (100.0, 99.0):
        taps = {"tap": lambda out: out["a"][:, :2]}
        want = jquant.calibrate(
            lambda v, b: jax.tree.map(jnp.asarray, b), None, batches,
            jquant.MinMaxObserver(pct), taps)
        got = quantize.calibrate(
            lambda b: jax.tree.map(torch.from_numpy, b), batches,
            quantize.MinMaxObserver(pct), taps)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (pct, k)


def test_fake_quant_and_its_gradient_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (6, 9)).astype(np.float32)
    scale = np.full((6, 1), 0.01, np.float32)   # |x / scale| beyond 127 too
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(t):
        return (jquant.fake_quant(t, jnp.asarray(scale)) * w).sum()

    want_y = jquant.fake_quant(jnp.asarray(x), jnp.asarray(scale))
    want_g = jax.grad(jloss)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = quantize.fake_quant(t, torch.from_numpy(scale))
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), t)
    assert np.array_equal(y.detach().numpy(), np.asarray(want_y))
    assert np.array_equal(g.numpy(), np.asarray(want_g))
    assert 0 < int((g == 0).sum()) < g.numel()


def test_qat_transform_params_match_jax(pair):
    """The fake-quantized parameters against JAX's (within 1e-6 relative:
    q * scale with scales an ulp apart at most), and their gradient: the
    straight-through one, w where |p / scale| <= 127 (``fake_quant``'s
    gradient itself is held against ``jax.grad`` above)."""
    variables, model, mapper = pair
    want = _to_port(variables, jquant.qat_transform_params(
        variables["params"]), model, mapper)
    params = dict(model.named_parameters())
    layouts = quantize.leaf_layouts(model)
    got = quantize.qat_transform_params(model)
    rng = np.random.default_rng(6)
    w = {k: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(
        np.float32)) for k, p in params.items()}
    loss = sum((p * w[k]).sum() for k, p in got.items())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert len(layouts) > 20
    for name, value in got.items():
        np.testing.assert_allclose(value.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-30, err_msg=name)
        inside = torch.ones_like(w[name])
        if name in layouts:
            p = params[name].detach()
            scale = quantize.channel_absmax(p, layouts[name]).clamp(
                min=1e-8) / 127.0
            inside = ((p / scale).abs() <= 127).float()
        assert torch.equal(grads[name], w[name] * inside), name


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["l1_filter", "magnitude"])
def test_prunes_and_report_match_jax(pair, kind):
    variables, model, mapper = pair
    if kind == "l1_filter":
        jp, jm = jprune.l1_filter_prune(variables["params"], 0.5)
        p, m = prune.l1_filter_prune(model, 0.5)
    else:
        jp, jm = jprune.magnitude_prune(variables["params"], 0.5)
        p, m = prune.magnitude_prune(model, 0.5)
    want_m = _to_port(variables, jm, model, mapper)
    want_p = _to_port(variables, jp, model, mapper)
    assert sorted(m) == sorted(k for k, _ in model.named_parameters())
    for name in m:
        assert m[name].dtype == torch.float32
        assert np.array_equal(m[name].numpy(), want_m[name]), name
        assert np.array_equal(p[name].numpy(), want_p[name]), name
    again = prune.apply_masks(p, m)
    assert all(torch.equal(again[k], p[k]) for k in p)
    # the report by the carrier's names: an attention's fused projection
    # is its query, key and value kernels, of one size each
    report = prune.sparsity_report(model, p)
    want = jprune.sparsity_report(jp)
    assert report["global"] == want["global"] and 0.3 < want["global"] < 0.6
    for key, value in report.items():
        if key == "global":
            continue
        if key.endswith(".in_proj"):
            path = "/".join(mapper(key[:-len(".in_proj")]))
            parts = [want[f"{path}/{p}"] for p in ("query", "key", "value")]
            assert value == pytest.approx(sum(parts) / 3, abs=1e-12), key
        else:
            assert value == want["/".join(mapper(key))], key
    assert len(report) == len(want) - 2 * sum(
        k.endswith(".in_proj") for k in report)
