"""The port's native serving path against the JAX package's, on the CPU at
tiny size (YOLOX at 64 px, width 0.125, 2 classes, float32; flax variables
drawn with numpy and moved by the carrier):

* the C++ op ``yolov7_d2_tpu_torch::nms_batched`` (``deploy/cc/nms_op.cpp``)
  has the schema of ``kernels/nms.py``'s; its CPU body, through the
  client's op-only mode, is index-exact with ``nms_batched_plain`` (ties,
  padded slots, and one class that suppresses heavily);
* the client (``deploy/cc/aoti_infer.cpp``, built by ``cc_build`` for the
  CPU) serves the AOTInductor package that the export CLI writes with
  ``--fuse-postprocess --emit-package`` in a process without Python: its
  ``Detections`` against the JAX ``export_inference_fn`` +
  ``load_stablehlo(...).call`` and against ``load_program`` (validity and
  classes equal, boxes and scores within 1e-4 of their largest magnitude);
  one op call a request; usage with no arguments exits 2, a CUDA request
  in a client without CUDA exits 1;
* ``deploy/program_infer.py`` prints the detections JAX
  ``deploy/stablehlo_infer.py`` prints for the same JPEG and weights (to
  the printed digits), and its ``numpy_nms`` is JAX's;
* ``deploy/demo_quantized_int8.py`` prints the byte counts that JAX's
  takes from the same config's parameters.

One g++ build of the client, overlapped with the one AOTInductor compile
of the package, serves the whole module.
"""

import concurrent.futures
import importlib.util
import json
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    REPO,
    TINY_OPTS,
    YOLOX_S_YAML,
    flax_variables_like,
    load_into,
    opts_list,
    tiny_cfg,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.deploy import export as jexport
from yolov7_d2_tpu.deploy import quantize as jquant
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch.yolox import (
    yolox_postprocess as jax_postprocess,
)
from yolov7_d2_tpu_torch import export as cli
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.deploy import cc_build, demo_quantized_int8
from yolov7_d2_tpu_torch.deploy import export, program_infer
from yolov7_d2_tpu_torch.kernels import nms
from yolov7_d2_tpu_torch.models.build import build_model

TOL = 1e-4
SIZE = 64
BATCH = 2
DTYPES = {"float32": np.float32, "int32": np.int32, "bool": np.bool_}


def _jax_script(name):
    """A module of the JAX package's ``deploy/`` scripts (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_deploy_{name}", REPO / "deploy" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def client_build():
    """The CPU client's build, started in a thread so that it overlaps the
    package's compile; None where no g++ is found."""
    try:
        subprocess.run(["g++", "--version"], capture_output=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        yield None
        return
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(cc_build.build_client, "cpu")


@pytest.fixture(scope="module")
def client(client_build):
    if client_build is None:
        pytest.skip("no g++")
    return str(client_build.result())


@pytest.fixture(scope="module")
def yolox():
    """(flax YOLOX, variables, port YOLOX holding them, its config)."""
    jmodel = jax_build_model(tiny_cfg(jax_get_cfg))
    cfg = YoloxConfig.from_cfg(tiny_cfg(get_cfg))
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(11)
    sample = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    variables = flax_variables_like(jmodel, sample, rng)
    load_into(model, variables)
    return jmodel, variables, model, cfg


def _jax_tail(cfg):
    def post(out):
        d = jax_postprocess(out, cfg.conf_threshold, cfg.nms_threshold,
                            cfg.max_detections, cfg.pre_nms_topk)
        return d.boxes, d.scores, d.classes, d.valid

    return post


@pytest.fixture(scope="module")
def package(yolox, client_build, tmp_path_factory):
    """The export CLI's ``--fuse-postprocess --emit-package`` artifacts of
    the tiny YOLOX at bs 2 (its weights through ``--weights``), the JAX
    artifact of the same weights, and a seeded raw batch."""
    jmodel, variables, model, cfg = yolox
    tmp = tmp_path_factory.mktemp("native")
    torch.save({"model": model.state_dict()}, tmp / "w.pth")
    paths = cli.main(["--config-file", YOLOX_S_YAML, "--output",
                      str(tmp / "port"), "--batch", str(BATCH),
                      "--fuse-postprocess", "--emit-package", "--weights",
                      str(tmp / "w.pth"), *opts_list(TINY_OPTS)])
    jpaths = jexport.export_inference_fn(
        jmodel, variables, (BATCH, SIZE, SIZE, 3), str(tmp / "jax"),
        _jax_tail(cfg))
    images = np.random.default_rng(3).integers(
        0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    images.tofile(tmp / "images.raw")
    return paths, jpaths, images, tmp


def _run(client, *args, check=True):
    run = subprocess.run([client, *map(str, args)], capture_output=True,
                         text=True, timeout=300, env=cc_build.client_env())
    if check:
        assert run.returncode == 0, run.stderr[-3000:]
    return run


def _served(client, *args):
    """The client's JSON line and the outputs it wrote under the prefix
    (the argument before the flags)."""
    run = _run(client, *args, "--device", "cpu")
    info = json.loads(run.stdout.strip().splitlines()[-1])
    prefix = args[-1]
    outs = [np.fromfile(f"{prefix}.{i}.raw", DTYPES[o["dtype"]])
            .reshape(o["shape"]) for i, o in enumerate(info["outputs"])]
    return info, outs


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def _check_detections(got, want):
    boxes, scores, classes, valid = (np.asarray(w) for w in want)
    assert valid.sum() > 10
    assert np.array_equal(got[3], valid)
    assert np.array_equal(got[2][valid], classes[valid])
    _close(got[0][valid], boxes[valid], "boxes")
    _close(got[1][valid], scores[valid], "scores")


# ---------------------------------------------------------------------------
# the client and the package
# ---------------------------------------------------------------------------

def test_client_serves_the_package_as_jax_does(client, package):
    paths, jpaths, images, tmp = package
    assert paths["package"].endswith("model_aoti.pt2")
    info, got = _served(client, paths["package"], tmp / "images.raw",
                        tmp / "served")
    assert [o["dtype"] for o in info["outputs"]] == [
        "float32", "float32", "int32", "bool"]
    assert info["op_calls"] == info["runs"] == 1  # one op call a request
    want = jexport.load_stablehlo(jpaths["stablehlo"]).call(
        jnp.asarray(images))
    _check_detections(got, want)
    with torch.no_grad():
        program = export.load_program(paths["program"]).module()(
            torch.from_numpy(images))
    _check_detections(got, [t.numpy() for t in program])


def test_client_usage_and_refusals(client, package):
    run = _run(client, check=False)
    assert run.returncode == 2 and "usage" in run.stderr
    paths, _, _, tmp = package
    # the card is the default; this client has no CUDA, and falls back
    # to nothing
    run = _run(client, paths["package"], tmp / "images.raw",
               tmp / "refused", check=False)
    assert run.returncode == 1 and "without CUDA" in run.stderr
    run = _run(client, paths["package"], tmp / "images.raw",
               tmp / "refused", "--device", "cuda", check=False)
    assert run.returncode == 1 and "without CUDA" in run.stderr


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def test_cpp_schema_is_the_python_ops():
    header = (REPO / "yolov7_d2_tpu_torch" / "deploy" / "cc" /
              "nms_op.h").read_text()
    decl = re.search(r"kNmsSchema\s*=\s*((?:\s*\"[^\"]*\")+);", header)
    schema = "".join(re.findall(r"\"([^\"]*)\"", decl.group(1)))
    assert schema == "nms_batched" + nms.SCHEMA
    python = str(torch.ops.yolov7_d2_tpu_torch.nms_batched.default._schema)
    assert python == "yolov7_d2_tpu_torch::" + schema


def _nms_inputs(case):
    """Seeded [B, N] candidates: ``ties`` draws scores from ten values,
    repeats boxes and pads the last slots with score 0; ``one_class``
    crowds boxes around three centres of one class."""
    rng = np.random.default_rng(21 if case == "ties" else 22)
    b, n = 3, 300
    if case == "ties":
        xy = rng.uniform(0, 120, (b, n, 2))
        wh = rng.uniform(4, 40, (b, n, 2))
        boxes = np.concatenate([xy, xy + wh], -1)
        boxes[:, 1::7] = boxes[:, 0:1]  # repeated boxes
        scores = rng.integers(1, 11, (b, n)) / 10.0
        scores[:, -40:] = 0.0
        return boxes.astype(np.float32), scores.astype(np.float32), 0.5
    centres = rng.uniform(40, 200, (b, 3, 2))[:, rng.integers(0, 3, n)]
    xy = centres + rng.normal(0, 6, (b, n, 2))
    wh = rng.uniform(30, 60, (b, n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    scores = rng.uniform(0.05, 1.0, (b, n))
    return boxes.astype(np.float32), scores.astype(np.float32), 0.3


@pytest.mark.parametrize("case", ["ties", "one_class"])
def test_cpp_op_cpu_body_is_index_exact(client, tmp_path, case):
    boxes, scores, thr = _nms_inputs(case)
    boxes.tofile(tmp_path / "boxes.raw")
    scores.tofile(tmp_path / "scores.raw")
    b, n = scores.shape
    info, (idx, valid) = _served(
        client, "--op", tmp_path / "boxes.raw", tmp_path / "scores.raw", b,
        n, repr(thr), 100, tmp_path / "op")
    want = nms.nms_batched_plain(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), thr, 100)
    assert np.array_equal(idx, want[0].numpy())
    assert np.array_equal(valid, want[1].numpy())
    assert info["op_calls"] == info["runs"] == 1
    assert info["op_launches"] == 0
    kept = want[1].sum(1)
    if case == "one_class":
        assert 0 < int(kept.max()) < 100  # the walk ran out of candidates


# ---------------------------------------------------------------------------
# the Python demos
# ---------------------------------------------------------------------------

def _printed_detections(text):
    """(count, [(class, score, box)]) of the demos' printed lines."""
    count = int(re.search(r"ms, (\d+) detections", text).group(1))
    dets = [(int(c), float(s), json.loads(b)) for c, s, b in re.findall(
        r"class (\d+)\s+score ([\d.]+)\s+box (\[[^\]]*\])", text)]
    return count, dets


def test_program_infer_prints_jax_detections(yolox, tmp_path, capsys,
                                             monkeypatch):
    import cv2

    jmodel, variables, model, cfg = yolox
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (48, 80, 3)).astype(np.uint8)
    cv2.rectangle(img, (10, 8), (40, 30), (20, 200, 90), -1)
    cv2.imwrite(str(tmp_path / "img.jpg"), img)
    paths = export.export_inference_fn(
        model, (1, SIZE, SIZE, 3), str(tmp_path / "port"),
        cli.yolox_tail(cfg))
    jpaths = jexport.export_inference_fn(
        jmodel, variables, (1, SIZE, SIZE, 3), str(tmp_path / "jax"),
        _jax_tail(cfg))
    args = ["-i", str(tmp_path / "img.jpg"), "--input-size", str(SIZE),
            "--conf", "0.05"]
    program_infer.main(["--model", paths["program"], *args, "--device",
                        "cpu"])
    got = _printed_detections(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["stablehlo_infer.py", "--model",
                                     jpaths["stablehlo"], *args])
    _jax_script("stablehlo_infer").main()
    want = _printed_detections(capsys.readouterr().out)
    assert got[0] == want[0] > 10
    assert len(got[1]) == len(want[1]) > 0
    for (gc, gs, gb), (wc, ws, wb) in zip(got[1], want[1]):
        # equal to the printed digits: a score to 1e-3, a box to 0.1 px
        assert gc == wc and abs(gs - ws) <= 1e-3 + 1e-6
        assert np.abs(np.subtract(gb, wb)).max() <= 0.1 + 1e-4


def test_program_infer_refuses_a_raw_program(tmp_path):
    import cv2

    cv2.imwrite(str(tmp_path / "img.jpg"),
                np.full((32, 32, 3), 127, np.uint8))
    # a program with the model's raw output (a dict), as export_inference_fn
    # writes one without a postprocess
    path = export.export_program(lambda x: {"outputs": x.mean(-1)},
                                 (torch.zeros(1, SIZE, SIZE, 3),),
                                 str(tmp_path / "model.pt2"))
    with pytest.raises(SystemExit, match="--fuse-postprocess"):
        program_infer.main(["--model", path, "-i", str(tmp_path / "img.jpg"),
                            "--input-size", str(SIZE), "--device", "cpu"])


@pytest.mark.parametrize("thresh", [0.3, 0.65])
def test_numpy_nms_is_jax_s(thresh):
    rng = np.random.default_rng(31)
    xy = rng.uniform(0, 100, (200, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 50, (200, 2))], -1)
    scores = rng.uniform(0, 1, 200)
    want = _jax_script("stablehlo_infer").numpy_nms(boxes, scores, thresh)
    assert program_infer.numpy_nms(boxes, scores, thresh) == want
    assert 0 < len(want) < 200


def test_int8_demo_prints_jax_byte_counts(yolox, capsys):
    got = demo_quantized_int8.main(["--config-file", YOLOX_S_YAML,
                                    "--batch", "2", *opts_list(TINY_OPTS)])
    printed = capsys.readouterr().out
    # the counts as the JAX demo takes them from its parameters (the flax
    # variables of the same config), and its line
    params = yolox[1]["params"]
    qparams, _ = jquant.quantize_weights_int8(params)
    int8_bytes = sum(x.size for x in jax.tree_util.tree_leaves(qparams)
                     if x.dtype == jnp.int8)
    f32_bytes = sum(x.size * 4 for x in jax.tree_util.tree_leaves(params))
    assert (got["f32_bytes"], got["int8_bytes"]) == (f32_bytes, int8_bytes)
    assert (f"param bytes: f32 {f32_bytes / 1e6:.1f} MB -> int8+scales "
            f"~{int8_bytes / 1e6:.1f} MB") in printed
    assert np.isfinite(got["drift"]) and got["relative"] < 0.05
    assert "max output drift int8-weights vs f32" in printed
