"""The closure of the yaml zoo on the port: one train step of a yaml at its
full width and depth (``yolov7_d2_tpu_torch/zoo_step.py``), the port's
counterpart of the JAX ``tests/test_config_zoo.py:29``, and its batch
builder against the JAX ``tests/_synth_batch.py``.

The whole sweep of 109 yamls is marked ``slow``, as its JAX counterpart is
(minutes of full-width CPU steps); the fast tier runs the sweep's code on
YOLOX-s and SparseInst R-50, and ``chip_smoke.py`` section 22 runs every
yaml on the card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_port_helpers  # noqa: F401  (the worker's share of the cores)
from _synth_batch import synth_batch as jax_synth_batch
from yolov7_d2_tpu_torch.zoo_step import (
    OVERRIDES,
    step_cfg,
    step_sweep,
    synth_batch,
)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
YAMLS = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml"))
FIELDS = ("image", "gt_boxes", "gt_classes", "gt_valid", "gt_masks",
          "gt_keypoints", "gt_sem_seg")


def test_synth_batch_is_the_jax_batch():
    want = jax_synth_batch(FIELDS, b=2, g=4, s=64)
    got = synth_batch(FIELDS, b=2, g=4, s=64, device="cpu")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert tuple(g.shape) == tuple(w.shape), key
        # the image is the JAX float batch's 114 as uint8
        np.testing.assert_array_equal(g.numpy().astype(np.float64),
                                      np.asarray(w, np.float64), key)
    assert got["image"].dtype == torch.uint8
    one = synth_batch(("gt_classes",), num_classes=1, device="cpu")
    assert int(one["gt_classes"].max()) == 0


def test_step_cfg_sets_the_jax_tests_sizes():
    assert len(YAMLS) == 109
    sizes = {rel: step_cfg(CONFIGS / rel, rel)[1] for rel in YAMLS}
    assert set(sizes.values()) == {64, 128}
    for rel, size in sizes.items():
        cfg, _ = step_cfg(CONFIGS / rel, rel)
        assert (size == 128) == (cfg.MODEL.YOLO.NECK.TYPE == "bifpn"), rel
        assert cfg.INPUT.INPUT_SIZE == [size, size]
        assert cfg.MODEL.YOLO.MAX_BOXES_NUM == 8
        assert not cfg.SOLVER.AMP.ENABLED
    assert set(OVERRIDES) <= set(YAMLS)
    cfg, _ = step_cfg(CONFIGS / "wearmask/efficient_b2.yaml",
                      "wearmask/efficient_b2.yaml")
    assert list(cfg.MODEL.EFFICIENTNET.FEATURE_INDICES) == [4, 7, 15, 22]


@pytest.mark.parametrize("rel", ["coco/yolox_s.yaml",
                                 "coco/sparseinst/sparse_inst_r50_base.yaml"])
def test_the_sweep_takes_a_step(rel):
    lines = []
    rows = step_sweep(CONFIGS, "cpu", [CONFIGS / rel], log=lines.append)
    (row,) = rows
    assert row["yaml"] == rel and np.isfinite(row["total_loss"])
    assert row["parameters"] > 1_000_000
    assert len(lines) == 1 and lines[0].startswith(f"step {rel}: ")


@pytest.mark.slow
@pytest.mark.parametrize("rel", YAMLS)
def test_yaml_takes_one_train_step(rel):
    (row,) = step_sweep(CONFIGS, "cpu", [CONFIGS / rel], log=lambda _: None)
    assert np.isfinite(row["total_loss"]), rel


def test_step_mode_of_the_sweep_tool(tmp_path, monkeypatch, capsys):
    """``tools/config_sweep_torch_port.py --step`` on the CPU: its lines,
    the count and the rows it writes."""
    import importlib.util
    import json
    import sys

    spec = importlib.util.spec_from_file_location(
        "config_sweep_torch_port", REPO / "tools" / "config_sweep_torch_port.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "rows.json"
    monkeypatch.setattr(sys, "argv", [
        "config_sweep_torch_port.py", "--step", "--device", "cpu", "--json",
        str(out), str(CONFIGS / "canaries" / "yolox_tiny_canary.yaml")])
    assert tool.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "1 of 1 yamls took a step", lines
    assert lines[0].startswith("step canaries/yolox_tiny_canary.yaml: YOLOX")
    (row,) = json.loads(out.read_text())
    assert row["arch"] == "YOLOX" and row["px"] == 64
