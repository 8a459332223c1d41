"""The port's LazyConfig (``config/lazy.py``) and its two entry points
(``lazyconfig_train_net.py``, ``demo_lazyconfig.py``) against the JAX
package, on the CPU.

* ``LazyCall``, ``instantiate`` (string targets of the JAX package map to
  the port's modules) and ``apply_overrides`` against the JAX primitives;
* every one of the 18 files of ``configs/common/`` and
  ``configs/new_baselines/`` loaded in a subprocess where importing ``jax``
  or ``yolov7_d2_tpu`` raises: the keys the JAX loader's filter keeps,
  every ``model`` instantiating a port module, ``sys.path`` as it was and
  no config module or JAX name left in ``sys.modules``;
* C.38: loads in any order give what the JAX loader gives each file in a
  fresh state (its cached fragments cleared); the JAX loader itself leaks
  ``panoptic_fpn_regnetx_0.4g_s.py``'s ``fpn_channels``; a ``common.*``
  that the JAX loader left in ``sys.modules`` is not read;
* ``do_train`` on ``yolox_s_lazy.py`` (width 0.125, 64 px, 2 images, a
  batch of random images) against the JAX train step with ``do_train``'s
  optimizer and schedule (JAX ``tools/lazyconfig_train_net.py:95-128``):
  the losses after an update and the update of three steps; a checkpoint,
  and ``--resume``
  continuing from it; the demo on two JPEGs.

Tolerances: the tiny model's losses, gradient norms and parameters 1e-5
relative (XLA and oneDNN sum a convolution in another order);
the models of the 18 files are built on the ``meta`` device (no weights);
config values exact.
"""

import functools
import json
import os
import subprocess
import sys

import cv2
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_helpers import REPO, flax_variables_like, jit_o0, load_into
from yolov7_d2_tpu.config import lazy as jlazy
from yolov7_d2_tpu.train.train_state import TrainState as JaxTrainState
from yolov7_d2_tpu.train.train_state import make_train_step
from yolov7_d2_tpu_torch import demo_lazyconfig, lazyconfig_train_net
from yolov7_d2_tpu_torch.config import lazy as tlazy
from yolov7_d2_tpu_torch.models.meta_arch.yolox import YOLOX

FILES = sorted(
    str(p.relative_to(REPO)) for p in
    list((REPO / "configs" / "common").rglob("*.py"))
    + list((REPO / "configs" / "new_baselines").glob("*.py")))
PANOPTIC = "configs/new_baselines/panoptic_fpn_regnetx_0.4g.py"
PANOPTIC_S = "configs/new_baselines/panoptic_fpn_regnetx_0.4g_s.py"
SIZE = 64


# one function for this process and the import-blocked subprocess
SUMMARY_SRC = r"""
def summary(value):
    '''A config as plain data: a class or callable by its module and name,
    any other object by its class, the JAX package's module names mapped to
    the port's.'''
    from yolov7_d2_tpu_torch.config.lazy import port_module_name

    if isinstance(value, dict):
        return {str(k): summary(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [summary(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if type(value).__name__ == "module":
        return "module " + value.__name__
    kind = ("callable" if isinstance(value, type) or callable(value)
            else "object")
    obj = value if kind == "callable" else type(value)
    return (kind + " " + port_module_name(getattr(obj, "__module__", ""))
            + "." + getattr(obj, "__qualname__", type(obj).__name__))
"""
exec(SUMMARY_SRC)


def test_file_list():
    assert len(FILES) == 18


def _fn(**kw):
    return dict(kw)


def test_lazycall_and_instantiate_match_jax():
    """Nested LazyCalls, lists and tuples, a string target: the port's
    primitives build what the JAX ones build (a JAX-package string target
    resolves to the port's module)."""
    for lazy in (jlazy, tlazy):
        inner = lazy.LazyCall(_fn)(a=1, b=[2, lazy.LazyCall(_fn)(c=(3,))])
        node = {"x": inner, "y": (inner, 4)}
        assert lazy.instantiate(node) == {
            "x": {"a": 1, "b": [2, {"c": (3,)}]},
            "y": ({"a": 1, "b": [2, {"c": (3,)}]}, 4)}
        with pytest.raises(TypeError):
            lazy.LazyCall(3)
    built = tlazy.instantiate({
        "_target_": "yolov7_d2_tpu.config.lazy.port_module_name",
        "name": "yolov7_d2_tpu.models"})
    assert built == "yolov7_d2_tpu_torch.models"


def test_apply_overrides_match_jax():
    over = ["model.num_classes=3", "train.input_size=(64, 64)",
            "train.output_dir=/tmp/x", "optimizer.name='adamw'"]
    got = tlazy.LazyConfig.apply_overrides(
        tlazy.LazyConfig.load(REPO / "configs/common/yolox_s_lazy.py"), over)
    want = jlazy.LazyConfig.apply_overrides(
        _jax_load("configs/common/yolox_s_lazy.py"), over)
    assert summary(got) == summary(want)
    assert got["train"]["input_size"] == (64, 64)


_BLOCKED_LOAD = r"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "yolov7_d2_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from yolov7_d2_tpu_torch.config.lazy import LazyConfig, instantiate
import torch
path_before = list(sys.path)
out = {}
for f in sys.argv[2:]:
    cfg = LazyConfig.load(f)
    res = {"summary": summary(cfg)}
    if "model" in cfg:
        with torch.device("meta"):  # the modules without their weights
            model = instantiate(cfg["model"])
        res["model"] = type(model).__module__ + "." + type(model).__name__
        res["is_module"] = isinstance(model, torch.nn.Module)
    out[f] = res
left = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "yolov7_d2_tpu", "common"))
print(json.dumps({"files": out, "left": left,
                  "path_kept": sys.path == path_before}))
"""


@functools.lru_cache(maxsize=None)
def _blocked():
    """Every file loaded, and its model instantiated, in one subprocess
    that cannot import JAX or the JAX package."""
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "-c", SUMMARY_SRC + _BLOCKED_LOAD, str(REPO),
         *FILES],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _jax_load(path):
    """The JAX loader on ``path`` in a fresh state: its cached fragments
    (``common.*``) cleared and ``sys.path`` restored around the load."""
    saved = list(sys.path)
    for m in [m for m in sys.modules if m.split(".")[0] == "common"]:
        del sys.modules[m]
    try:
        return jlazy.LazyConfig.load(str(REPO / path))
    finally:
        sys.path[:] = saved
        for m in [m for m in sys.modules if m.split(".")[0] == "common"]:
            del sys.modules[m]


@functools.lru_cache(maxsize=None)
def _jax_fresh(path):
    return summary(_jax_load(path))


@pytest.mark.parametrize("path", FILES)
def test_file_loads_without_jax_as_jax_loads_it(path):
    """The file's config under the import block equals what the JAX loader
    gives it in a fresh state; its model is a port module."""
    res = _blocked()
    assert res["left"] == [] and res["path_kept"]
    got = res["files"][path]
    assert got["summary"] == _jax_fresh(path)
    if "model" in got:
        assert got["is_module"]
        assert got["model"].startswith("yolov7_d2_tpu_torch.models.")


def test_load_order_independence_c38():
    """The port's loads in forward, reverse and sandwiched order all give
    each file's fresh JAX config; the JAX loader's third load of the
    sandwich reads the small file's 128 channels (the leak)."""
    for order in (FILES, FILES[::-1], [PANOPTIC, PANOPTIC_S, PANOPTIC]):
        for path in order:
            assert summary(tlazy.LazyConfig.load(REPO / path)) == \
                _jax_fresh(path), path
    first = _jax_fresh(PANOPTIC)
    assert first["model"]["fpn_channels"] == 256
    saved = list(sys.path)
    try:
        loads = [jlazy.LazyConfig.load(str(REPO / p))
                 for p in (PANOPTIC, PANOPTIC_S, PANOPTIC)]
        assert [c["model"]["fpn_channels"] for c in loads] == [128] * 3
        # a fragment the JAX loader left in sys.modules is not read
        assert "common.models.panoptic_fpn" in sys.modules
        got = tlazy.LazyConfig.load(REPO / PANOPTIC)
        assert got["model"]["fpn_channels"] == 256
        assert got["model"]["_target_"].__module__.startswith(
            "yolov7_d2_tpu_torch.")
    finally:
        sys.path[:] = saved
        for m in [m for m in sys.modules if m.split(".")[0] == "common"]:
            del sys.modules[m]


def _random_batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 255, (b, SIZE, SIZE, 3)).astype(
                np.float32),
            "target": rng.normal(0, 1, (b, SIZE, SIZE, 2)).astype(
                np.float32)}


def _torch_batches():
    batch = {k: torch.from_numpy(v) for k, v in _random_batch().items()}
    while True:
        yield batch


class _JaxTiny(fnn.Module):
    """A 3x3 conv + ReLU + 1x1 conv on the scaled NHWC image."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.relu(fnn.Conv(4, (3, 3), padding=[(1, 1), (1, 1)],
                              name="conv")(x / 255.0))
        return fnn.Conv(2, (1, 1), name="head")(x)


class _TorchTiny(torch.nn.Module):
    """:class:`_JaxTiny` in torch (flax names: ``conv``, ``head``)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, 1, 1)
        self.head = torch.nn.Conv2d(4, 2, 1)

    def forward(self, images):
        x = torch.relu(self.conv(images.permute(0, 3, 1, 2) / 255.0))
        return self.head(x).permute(0, 2, 3, 1)


def _torch_loss_fn():
    """The loss a config's ``loss_fn`` LazyCall builds: a mean square."""
    def loss_fn(out, batch, use_l1):
        return {"total_loss": ((out - batch["target"]) ** 2).mean()}

    return loss_fn


def _tiny_cfg(out_dir, max_iter=3):
    """``yolox_s_lazy.py`` (its optimizer: SGD, lr 0.02, momentum 0.9,
    decay 5e-4) with the tiny model, the loss and the batches as
    LazyCalls."""
    cfg = tlazy.LazyConfig.load(REPO / "configs/common/yolox_s_lazy.py")
    cfg["model"] = tlazy.LazyCall(_TorchTiny)()
    cfg["loss_fn"] = tlazy.LazyCall(_torch_loss_fn)()
    cfg["dataloader"] = tlazy.LazyCall(_torch_batches)()
    cfg["train"].update(max_iter=max_iter, input_size=(SIZE, SIZE),
                        ims_per_batch=2, output_dir=str(out_dir),
                        checkpointer={"period": 2}, log_period=1)
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """The JAX train step (``train/train_state.make_train_step``) with
    ``do_train``'s optimizer and schedule (JAX
    ``tools/lazyconfig_train_net.py:101-114``: warm-up ``min(1000, 3 //
    2)`` = 1, cosine to 0 at 3, SGD after ``add_decayed_weights``) on the
    tiny model: the losses of three steps, the initial and final
    parameters."""
    ocfg = _jax_load("configs/common/yolox_s_lazy.py")["optimizer"]
    model = _JaxTiny()
    batch = _random_batch()
    variables = flax_variables_like(model, batch["image"],
                                    np.random.default_rng(5))
    schedule = optax.warmup_cosine_decay_schedule(0.0, ocfg["base_lr"], 1, 3)
    tx = optax.chain(optax.add_decayed_weights(ocfg["weight_decay"]),
                     optax.sgd(schedule, momentum=ocfg["momentum"]))

    def loss_fn(out, batch, use_l1):
        return {"total_loss": jnp.mean((out - batch["target"]) ** 2)}

    step = jit_o0(make_train_step(model, loss_fn, tx, seed=0))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"], batch_stats={},
                          opt_state=tx.init(variables["params"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(3):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return variables, metrics, jax.tree.map(np.asarray, state.params)


def _port_train(monkeypatch, out_dir, max_iter=3, resume=False):
    variables = _jax_steps()[0]
    monkeypatch.setattr(lazyconfig_train_net, "init_weights_",
                        lambda model, gen: load_into(model, variables))
    return lazyconfig_train_net.do_train(_tiny_cfg(out_dir, max_iter),
                                         resume=resume, device="cpu")


def test_do_train_matches_jax_step(monkeypatch, tmp_path):
    """Three steps of the port's ``do_train`` on a config with a
    ``loss_fn`` and a ``dataloader`` (SGD with the decay on every
    parameter, the warm-up cosine: lr 0, then the base lr, then half of
    it) against the JAX step with ``do_train``'s optimizer and schedule:
    the losses of every step and the parameters after the three."""
    variables, jmetrics, jparams = _jax_steps()
    trainer = _port_train(monkeypatch, tmp_path)
    assert trainer.state.step == 3
    with open(tmp_path / "metrics.json") as f:
        by_iter = {d["iteration"]: d for d in map(json.loads, f)}
    for i, want in enumerate(jmetrics):
        for k in ("total_loss", "grad_norm"):
            np.testing.assert_allclose(by_iter[i + 1][k], want[k],
                                       rtol=1e-5, err_msg=(i, k))
    assert jmetrics[0]["total_loss"] != jmetrics[2]["total_loss"]
    want = load_into(_TorchTiny(), {"params": jparams}).state_dict()
    init = load_into(_TorchTiny(), variables).state_dict()
    for k, v in trainer.state.model.state_dict().items():
        assert float((want[k] - init[k]).abs().max()) > 0, k
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_checkpoint_and_resume(monkeypatch, tmp_path):
    """The run writes its checkpoint at step 2; ``--resume`` to 3 starts
    from it."""
    _port_train(monkeypatch, tmp_path, max_iter=2)
    assert os.listdir(tmp_path / "ckpt") == ["ckpt_00000002.pt"]
    trainer = _port_train(monkeypatch, tmp_path, max_iter=3, resume=True)
    assert trainer.start_iter == 2 and trainer.state.step == 3
    assert (tmp_path / "metrics.json").exists()


def test_main_runs_a_file_and_demo(tmp_path):
    """The CLI forms: ``lazyconfig_train_net.main`` with overrides on the
    synthetic loader, then ``demo_lazyconfig.main`` on two JPEGs."""
    out = tmp_path / "train"
    trainer = lazyconfig_train_net.main([
        "--config-file", str(REPO / "configs/common/yolox_s_lazy.py"),
        "--device", "cpu", "model.width_mul=0.125", "train.max_iter=1",
        f"train.input_size=({SIZE}, {SIZE})", "train.ims_per_batch=2",
        f"train.output_dir={out}"])
    assert trainer.state.step == 1
    assert isinstance(trainer.state.model, YOLOX)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"img{i}.jpg"))
        cv2.imwrite(paths[-1], rng.integers(0, 256, (48, 80, 3),
                                            dtype=np.uint8))
    results = demo_lazyconfig.main([
        "--config-file", str(REPO / "configs/common/yolox_s_lazy.py"),
        "-i", *paths, "--output", str(tmp_path / "vis"),
        "--input-size", str(SIZE), "-c", "0.0", "--device", "cpu"])
    assert [p for p, _ in results] == paths
    assert sorted(os.listdir(tmp_path / "vis")) == ["img0.jpg", "img1.jpg"]
    assert all(bool(d.valid.any()) for _, d in results)


def test_lazy_entry_points_default_to_the_card(tmp_path):
    """Without ``--device cpu`` the entry points ask for a card, which the
    CPU here has not."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        lazyconfig_train_net.main([
            "--config-file", str(REPO / "configs/common/yolox_s_lazy.py"),
            f"train.output_dir={tmp_path}"])
