"""The port's entry points on the CPU (``MODEL.DEVICE cpu``), at tiny size
(YOLOX-s cut to 64 px, width 0.125, 2 classes; 8 synthetic images):
``train_det.main`` on the host mosaic feed and on packed shards, each 10
iterations with a checkpoint, the COCO eval and ``--resume``; the exact
resume (3 + 3 steps against 6); the checkpointer and its helpers; the
custom-dataset and demo CLIs; and the paths that must raise.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    REPO,
    TINY_OPTS,
    YOLOX_S_YAML,
    opts_list,
    tiny_cfg,
    write_mini_coco,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.train import schedules as jax_schedules
from yolov7_d2_tpu.train.checkpoint import fuse_conv_bn as jax_fuse_conv_bn
from yolov7_d2_tpu_torch import demo, train_custom_datasets, train_det
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data import device_aug
from yolov7_d2_tpu_torch.data.catalog import (
    DatasetCatalog,
    register_coco_instances,
)
from yolov7_d2_tpu_torch.data.coco import load_coco_json
from yolov7_d2_tpu_torch.data.packed_cache import (
    write_geometry_shards,
    write_plain_shards,
)
from yolov7_d2_tpu_torch.engine import build_yolox_system
from yolov7_d2_tpu_torch.parallel import dist as pdist
from yolov7_d2_tpu_torch.parallel.launch import local_dist_url
from yolov7_d2_tpu_torch.parallel.norm_sync import SyncBatchNorm2d
from yolov7_d2_tpu_torch.train import schedules, trainer as trainer_mod
from yolov7_d2_tpu_torch.train.checkpoint import (
    Checkpointer,
    fuse_conv_bn,
    strip_optimizer,
)
from yolov7_d2_tpu_torch.utils.args import default_argument_parser

LOSSES = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_l1")
EVAL_KEYS = ("eval/AP", "eval/AP50", "eval/AP75", "eval/AR100")


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The mini-COCO registered as ``port_cli_mini``: (name, json, root)."""
    js, root = write_mini_coco(tmp_path_factory.mktemp("climini"))
    name = "port_cli_mini"
    DatasetCatalog.remove(name)
    register_coco_instances(name, {}, js, root)
    yield name, js, root
    DatasetCatalog.remove(name)


def _opts(out, dataset, **extra):
    opts = dict(TINY_OPTS, **{
        "DATASETS.TRAIN": (dataset,), "DATASETS.TEST": (dataset,),
        "OUTPUT_DIR": str(out), "SEED": 0, "SOLVER.MAX_ITER": 10,
        "SOLVER.CHECKPOINT_PERIOD": 5, "TEST.EVAL_PERIOD": 10})
    opts.update({k.replace("__", "."): v for k, v in extra.items()})
    return opts_list(opts)


def _args(out, dataset, *flags, **extra):
    return default_argument_parser().parse_args(
        ["--config-file", YOLOX_S_YAML, *flags, *_opts(out, dataset,
                                                       **extra)])


def _metrics(out):
    with open(out / "metrics.json") as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def spied(monkeypatch):
    """Where each ``Trainer.train`` started, and the GridMask calls of the
    packed step."""
    seen = {"starts": [], "grid_mask": 0}
    train = trainer_mod.Trainer.train

    def spy_train(self):
        seen["starts"].append(self.storage.iter)
        return train(self)

    def spy_grid_mask(images, params):
        seen["grid_mask"] += 1
        return grid_mask(images, params)

    grid_mask = device_aug.grid_mask
    monkeypatch.setattr(trainer_mod.Trainer, "train", spy_train)
    monkeypatch.setattr(device_aug, "grid_mask", spy_grid_mask)
    return seen


@pytest.mark.parametrize("feed", ["host_mosaic", "packed"])
def test_train_det_trains_checkpoints_evaluates_and_resumes(
        mini, tmp_path, spied, feed):
    name, js, root = mini
    extra = {}
    if feed == "packed":
        cfg = tiny_cfg(get_cfg)
        cfg.freeze()
        records = load_coco_json(js, root)
        geo, plain = tmp_path / "geo", tmp_path / "plain"
        write_geometry_shards(records, cfg, str(geo), shard_size=8)
        write_plain_shards(records, cfg, str(plain), shard_size=8)
        extra = {"DATALOADER__PACKED_CACHE_DIR": str(geo),
                 "DATALOADER__PACKED_CACHE_PLAIN_DIR": str(plain),
                 "INPUT__GRID_MASK__ENABLED": True,
                 "INPUT__MOSAIC_AND_MIXUP__DISABLE_AT_ITER": 5}
    out = tmp_path / "out"
    latest = train_det.main(_args(out, name, **extra)).storage.latest()
    lines = _metrics(out)
    assert [r["iteration"] for r in lines] == [10]
    for k in LOSSES:
        assert np.isfinite(lines[-1][k]) and np.isfinite(latest[k]), k
    assert lines[-1]["num_fg"] > 0
    for k in EVAL_KEYS:
        assert k in lines[-1] and 0.0 <= latest[k] <= 1.0, k
    assert Checkpointer(str(out / "ckpt")).steps() == [5, 10]
    assert (out / "config.yaml").exists()
    # GridMask runs in the packed step before DISABLE_AT_ITER only
    assert spied["grid_mask"] == (5 if feed == "packed" else 0)

    latest = train_det.main(_args(out, name, "--resume", SOLVER__MAX_ITER=12,
                                  **extra)).storage.latest()
    assert spied["starts"] == [0, 10]
    assert spied["grid_mask"] == (5 if feed == "packed" else 0)
    assert [r["iteration"] for r in _metrics(out)] == [10, 12]
    assert Checkpointer(str(out / "ckpt")).steps() == [5, 10, 12]
    assert all(k in latest for k in EVAL_KEYS)


def _snapshot(state):
    opt = state.optimizer
    return {
        "step": state.step,
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "ema": {k: v.clone() for k, v in state.ema_params.items()},
        "momentum": [opt.state[p]["momentum_buffer"].clone()
                     for g in opt.param_groups for p in g["params"]],
    }


def test_resume_continues_exactly(tmp_path):
    """3 steps, a checkpoint, a fresh state of other weights restored from
    it, 3 more steps: bit for bit the 6 straight steps (parameters, BN
    buffers, EMA, momentum buffers), through the trainer and its
    checkpoint hook, on the packed step with mixup and GridMask."""
    ycfg = YoloxConfig.from_cfg(tiny_cfg(get_cfg, INPUT__GRID_MASK__ENABLED=
                                         True))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(6):
        valid = np.arange(8)[None] < rng.integers(1, 9, (4, 1))
        xy = rng.uniform(0, 40, (4, 8, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(6, 24, (4, 8, 2))], -1)
        batches.append({
            "image": torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3),
                                                   dtype=np.uint8)),
            "gt_boxes": torch.from_numpy(boxes.astype(np.float32)),
            "gt_classes": torch.from_numpy(rng.integers(0, 2, (4, 8)).astype(
                np.int32)),
            "gt_valid": torch.from_numpy(valid)})

    def run(seed, data, start, stop, ckpt):
        _, state, step = build_yolox_system(ycfg, "cpu", seed)
        state, start_iter = ckpt.resume_or_load(state, resume=True)
        assert start_iter == start
        tr = trainer_mod.Trainer(
            device_aug.make_packed_photo_step(ycfg, step, seed=0), state,
            data, stop, hooks=[trainer_mod.PeriodicCheckpointer(ckpt, 0)],
            start_iter=start_iter)
        return tr.train()

    straight = _snapshot(run(0, batches, 0, 6,
                             Checkpointer(str(tmp_path / "a"))))
    ckpt = Checkpointer(str(tmp_path / "b"))
    run(0, batches[:3], 0, 3, ckpt)
    assert ckpt.steps() == [3]
    resumed = _snapshot(run(5, batches[3:], 3, 6, ckpt))
    assert straight["step"] == resumed["step"] == 6
    for key in ("model", "ema"):
        assert sorted(straight[key]) == sorted(resumed[key])
        for k, v in straight[key].items():
            assert torch.equal(v, resumed[key][k]), (key, k)
    assert len(straight["momentum"]) == len(resumed["momentum"]) > 0
    for a, b in zip(straight["momentum"], resumed["momentum"]):
        assert torch.equal(a, b)


def test_checkpointer_round_trip_and_keeps_five(tmp_path):
    ycfg = YoloxConfig.from_cfg(tiny_cfg(get_cfg))
    _, state, _ = build_yolox_system(ycfg, "cpu", 0)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    assert ckpt.latest_step() is None and not (tmp_path / "ck").exists()
    assert ckpt.resume_or_load(state, resume=True) == (state, 0)
    for step in (1, 2, 3, 4, 5, 6, 7):
        ckpt.save(step, state)
    assert ckpt.steps() == [3, 4, 5, 6, 7]
    assert sorted(os.listdir(tmp_path / "ck")) == [
        f"ckpt_{s:08d}.pt" for s in (3, 4, 5, 6, 7)]
    blob = ckpt.load()
    groups = blob["optimizer"]["param_groups"]
    assert {g["decay_class"] for g in groups} == {"weight", "norm", "bias"}
    assert all("lr_mult" in g for g in groups)
    weights = strip_optimizer(blob)
    assert sorted(weights) == sorted(state.model.state_dict())
    for name, value in state.ema_params.items():
        assert torch.equal(weights[name], value)
    assert "backbone.stem.conv.bn.running_var" in weights


def test_fuse_conv_bn_matches_jax():
    rng = np.random.default_rng(2)
    kernel = rng.normal(size=(6, 3, 3, 3)).astype(np.float32)
    bn = [rng.uniform(0.5, 1.5, 6).astype(np.float32) for _ in range(4)]
    got_k, got_b = fuse_conv_bn(kernel, *bn)
    want_k, want_b = jax_fuse_conv_bn(kernel.transpose(2, 3, 1, 0), *bn)
    np.testing.assert_array_equal(got_k, want_k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got_b, want_b)


@pytest.mark.parametrize("world", [1, 2, 8])
def test_auto_scale_config_matches_jax(world):
    ours, theirs = get_cfg(), jax_get_cfg()
    for c in (ours, theirs):
        c.merge_from_file(YOLOX_S_YAML)
        c.SOLVER.REFERENCE_WORLD_SIZE = 4
        c.SOLVER.STEPS = [100, 200]
        c.freeze()
    schedules.auto_scale_config(ours, world)
    jax_schedules.auto_scale_config(theirs, world)
    assert ours.is_frozen()
    assert ours.SOLVER.dump() == theirs.SOLVER.dump()


def _run_ranks(tmp_path, commands, timeout=300.0):
    """Each ``commands`` entry as ``python -m
    yolov7_d2_tpu_torch.train_custom_datasets ARGS`` in a session of its
    own, all at once; past ``timeout`` seconds every session (its spawned
    ranks too) is killed and the test fails. Returns their outputs."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    for i, argv in enumerate(commands):
        log = open(tmp_path / f"cmd{i}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "yolov7_d2_tpu_torch.train_custom_datasets",
             *argv], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True), log))
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    outputs = []
    for proc, log in procs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
        assert proc.returncode == 0, outputs[-1][-3000:]
    return outputs


def _cli_argv(out, name, js, root, *flags, **extra):
    return ["--register", name, js, root, "--config-file", YOLOX_S_YAML,
            *flags, *_opts(out, name, **extra)]


def test_train_custom_datasets_on_2_ranks_registers_in_each_and_resumes_in_one(
        mini, tmp_path, monkeypatch):
    """``--num-gpus 2`` on the CPU (gloo): the dataset exists only through
    ``--register``, so each spawned rank must register it for itself; rank
    0 alone writes ``metrics.json`` and the checkpoints and runs the eval;
    the checkpoint of 2 ranks then resumes in one process with its state
    exactly."""
    _, js, root = mini
    name = "port_cli_ranks"
    out = tmp_path / "out"
    _run_ranks(tmp_path, [_cli_argv(
        out, name, js, root, "--num-gpus", "2", SOLVER__MAX_ITER=4,
        SOLVER__CHECKPOINT_PERIOD=2, TEST__EVAL_PERIOD=4)])
    lines = _metrics(out)
    assert [r["iteration"] for r in lines] == [4]
    for k in LOSSES + EVAL_KEYS:
        assert np.isfinite(lines[-1][k]), k
    assert lines[-1]["num_fg"] > 0
    ckpt = Checkpointer(str(out / "ckpt"))
    assert ckpt.steps() == [2, 4] and (out / "config.yaml").exists()

    blob = ckpt.load(4)
    seen = {}
    train = trainer_mod.Trainer.train

    def spy_train(self):
        seen["state"] = _snapshot(self.state)
        return train(self)

    monkeypatch.setattr(trainer_mod.Trainer, "train", spy_train)
    register_coco_instances(name, {}, js, root)
    try:
        tr = train_det.main(_args(out, name, "--resume", SOLVER__MAX_ITER=6,
                                  SOLVER__CHECKPOINT_PERIOD=2,
                                  TEST__EVAL_PERIOD=0))
    finally:
        DatasetCatalog.remove(name)
    assert (tr.start_iter, tr.storage.iter) == (4, 6)
    # one process: no group, no wrapper, plain BatchNorm
    assert tr.state.ddp is None and not pdist.is_initialized()
    assert not any(isinstance(m, SyncBatchNorm2d)
                   for m in tr.state.model.modules())
    resumed = seen["state"]
    assert resumed["step"] == blob["step"] == 4
    for key, want in (("model", blob["model"]), ("ema", blob["ema_params"])):
        assert sorted(resumed[key]) == sorted(want)
        for k, v in want.items():
            assert torch.equal(resumed[key][k], v), (key, k)
    momentum = [s["momentum_buffer"] for s in
                blob["optimizer"]["state"].values()]
    assert len(momentum) == len(resumed["momentum"]) > 0
    for a, b in zip(resumed["momentum"], momentum):
        assert torch.equal(a, b)
    assert ckpt.steps() == [2, 4, 6]


def test_num_machines_2_resume_a_one_process_checkpoint(mini, tmp_path):
    """``--num-machines 2 --machine-rank {0,1} --dist-url tcp://...`` as two
    commands of one rank each, resuming the checkpoint of a one-process
    run: they start at its step (a checkpoint at every step from there)."""
    name, js, root = mini
    out = tmp_path / "out"
    train_det.main(_args(out, name, SOLVER__MAX_ITER=2,
                         SOLVER__CHECKPOINT_PERIOD=2, TEST__EVAL_PERIOD=0))
    url = local_dist_url()
    _run_ranks(tmp_path, [_cli_argv(
        out, name, js, root, "--resume", "--num-machines", "2",
        "--machine-rank", str(rank), "--dist-url", url, SOLVER__MAX_ITER=4,
        SOLVER__CHECKPOINT_PERIOD=1, TEST__EVAL_PERIOD=0)
        for rank in (0, 1)])
    assert [r["iteration"] for r in _metrics(out)] == [2, 4]
    assert Checkpointer(str(out / "ckpt")).steps() == [2, 3, 4]
    assert np.isfinite(_metrics(out)[-1]["total_loss"])


def test_num_gpus_2_on_cuda_without_two_cards_raises(mini, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--num-gpus 2 but 1 CUDA"):
        train_det.main(_args(tmp_path, mini[0], "--num-gpus", "2",
                             MODEL__DEVICE="cuda"))


def test_device_tile_aug_raises(mini, tmp_path):
    """The device geometry feed trains (tests/test_torch_port_device_aug.py)
    on square tiles only: a non-square input size raises, as the JAX
    ``DeviceAug`` asserts."""
    with pytest.raises(ValueError, match="tiles must be square"):
        train_det.main(_args(tmp_path, mini[0],
                             INPUT__MOSAIC_AND_MIXUP__DEVICE=True,
                             INPUT__INPUT_SIZE=[64, 96]))


def test_cuda_without_a_card_raises(mini, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MODEL.DEVICE cpu"):
        train_det.main(_args(tmp_path, mini[0], MODEL__DEVICE="cuda"))


def test_entry_points_import_no_jax():
    code = ("import sys\n"
            "import yolov7_d2_tpu_torch.train_det, yolov7_d2_tpu_torch.demo\n"
            "import yolov7_d2_tpu_torch.train_custom_datasets\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'yolov7_d2_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_train_custom_datasets_registers_and_evaluates(mini, tmp_path,
                                                       capsys):
    _, js, root = mini
    name = "port_cli_custom"
    try:
        results = train_custom_datasets.main(
            ["--register", name, js, root, "--config-file", YOLOX_S_YAML,
             "--eval-only", *_opts(tmp_path, name)])
    finally:
        DatasetCatalog.remove(name)
    assert {"AP", "AP50", "AP75", "AR100"} <= set(results)
    assert str(results) in capsys.readouterr().out


def test_demo_applies_the_checkpoint_and_draws(mini, tmp_path, capsys):
    _, _, root = mini
    cfg = tiny_cfg(get_cfg)
    _, state, _ = build_yolox_system(YoloxConfig.from_cfg(cfg), "cpu", 3)
    ckpt_dir = tmp_path / "ckpt"
    Checkpointer(str(ckpt_dir)).save(4, state)
    predictor = demo.build_predictor(cfg, str(ckpt_dir))
    for name, p in predictor.model.named_parameters():
        assert torch.equal(p, state.ema_params[name]), name

    out = tmp_path / "vis"
    args = ["--config-file", YOLOX_S_YAML, "-i", os.path.join(root, "im0.jpg"),
            str(tmp_path / "nodir"), "--output", str(out), "-c", "0.01",
            "--weights", str(ckpt_dir),
            *opts_list({k: v for k, v in TINY_OPTS.items()
                        if k.startswith(("MODEL.", "INPUT."))})]
    demo.main(args)
    os.makedirs(tmp_path / "imgs")
    for i in (1, 2):
        os.link(os.path.join(root, f"im{i}.jpg"),
                tmp_path / "imgs" / f"im{i}.jpg")
    args[3:5] = [str(tmp_path / "imgs")]
    demo.main(args)
    printed = capsys.readouterr().out
    assert "im0.jpg: " in printed and "dets in" in printed
    assert "skip unreadable" in printed
    assert sorted(os.listdir(out)) == ["im0.jpg", "im1.jpg", "im2.jpg"]


def test_eval_only_with_resume_takes_the_checkpoint(mini, tmp_path,
                                                    monkeypatch):
    """``--eval-only --resume`` evaluates the state of the checkpoint."""
    name = mini[0]
    ycfg = YoloxConfig.from_cfg(tiny_cfg(get_cfg))
    _, state, _ = build_yolox_system(ycfg, "cpu", 9)
    state.step = 7
    Checkpointer(str(tmp_path / "ckpt")).save(7, state)
    monkeypatch.setattr(train_det, "build_eval_fn",
                        lambda cfg, recs: lambda tr: {"AP": 0.0,
                                                      "step": tr.state.step})
    got = train_det.main(_args(tmp_path, name, "--eval-only", "--resume"))
    assert got == {"AP": 0.0, "step": 7}
