"""Package-level contracts of the PyTorch port ``yolov7_d2_tpu_torch``:
it runs without JAX, Flax, PyYAML or OpenCV, its configuration matches the
JAX package's YOLOX-s config, and ``chip_smoke.py`` refuses to run, and
prints no result, where there is no CUDA card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from yolov7_d2_tpu.config import get_cfg
from yolov7_d2_tpu_torch.config import YoloxConfig

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "yolov7_d2_tpu_torch"

_TINY_SLICE = """
import sys, dataclasses, torch
import yolov7_d2_tpu_torch
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.predictor import Predictor
cfg = dataclasses.replace(YoloxConfig(), num_classes=8, width_mul=0.25,
                          input_size=(64, 64), amp=False)
dets = Predictor(cfg, device="cpu", seed=0).predict_batch(
    torch.full((2, 64, 64, 3), 114, dtype=torch.uint8))
assert dets.boxes.shape == (2, 100, 4), dets.boxes.shape
print(sorted(m for m in ("jax", "flax", "yaml", "cv2") if m in sys.modules))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_slice_runs_without_jax_flax_yaml_cv2():
    proc = subprocess.run([sys.executable, "-c", _TINY_SLICE], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "tools/kernel_times.py",
       "tools/profile_torch_port.py", "tools/profile_torch_feed.py"])
def test_port_module_imports_no_jax(path):
    # no allow-list: the port keeps its own copies of what it needs from
    # the JAX package, even of modules there that import no JAX
    for mod in _imported_modules(REPO / path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                            "yolov7_d2_tpu"), mod


def test_default_config_is_yolox_s():
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "coco" / "yolox_s.yaml"))
    assert YoloxConfig() == YoloxConfig.from_cfg(cfg)


def test_from_cfg_reads_overrides():
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "coco" / "yolox_s.yaml"))
    cfg.MODEL.YOLO.CLASSES = 8
    cfg.SOLVER.AMP.ENABLED = False
    cfg.INPUT.INPUT_SIZE = [320, 416]
    got = YoloxConfig.from_cfg(cfg)
    assert (got.num_classes, got.amp, got.input_size) == (8, False,
                                                          (320, 416))


def _run_smoke(cwd: Path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the host has
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
