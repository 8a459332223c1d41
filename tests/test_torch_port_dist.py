"""The port's data-parallel training (``yolov7_d2_tpu_torch/parallel/``) on
the CPU: gloo process groups of 2 ranks, tiny shapes.

* 2 processes against 1 on the same global batch, and against the JAX
  ``train_step`` jitted under a (2, 1) data mesh of 2 of conftest's virtual
  CPU devices (the reference of record: one step over the global batch):
  a 3-step SGD + EMA trajectory with the tolerances of
  ``tests/test_torch_port_train.py::test_yolox_sgd_ema_trajectory_3steps``
  (losses 1e-4 relative, the gradient norm 1e-3 on the first step and 1e-2
  after, parameters, BN statistics and EMA by its trajectory rule), the
  foreground count exact, and every rank bitwise equal to the others; the
  same spawn runs the 3 steps again with ``remat`` (``TPU.REMAT``): every
  metric, parameter, BN statistic and ``num_batches_tracked`` and the EMA
  bitwise those of the ranks without it;
* ``SyncBatchNorm2d`` over 2 ranks against ``nn.BatchNorm2d`` on the whole
  batch: 1e-5 relative (the same float32 moments, summed in another order;
  Chan's merge of two halves against one pass), the running statistics
  bitwise equal across ranks;
* ``all_reduce_norm`` and ``precise_bn`` against the JAX package's
  ``allreduce_norm_host`` and ``precise_bn``: 1e-6 and 1e-5 relative (an
  average of two float32 numbers; float32 moments of another sum order);
* ``dryrun_multigpu(2)``: a (1, 2) grid, the widest parameters sharded
  over the model axis.

Each spawn is bounded by ``launch``'s ``timeout``: past it the ranks are
killed and the test fails.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_port_helpers import assert_trajectory_close, jit_o0
from _torch_port_tp_ranks import steps_with_and_without_remat
from test_torch_port_train import (
    GRAD_RTOL,
    MODEL_LOSS_RTOL,
    _gts,
    _jax_cfg,
)
from yolov7_d2_tpu.engine import dummy_batch as jax_dummy_batch
from yolov7_d2_tpu.engine import make_yolox_loss_adapter as jax_adapter
from yolov7_d2_tpu.engine import resolve_simota_prefilter as jax_resolve
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.layers.norm import BatchNorm as JaxBatchNorm
from yolov7_d2_tpu.parallel.mesh import build_mesh, shard_batch_pytree
from yolov7_d2_tpu.parallel.norm_sync import allreduce_norm_host
from yolov7_d2_tpu.parallel.norm_sync import precise_bn as jax_precise_bn
from yolov7_d2_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from yolov7_d2_tpu.train.train_state import TrainState as JaxTrainState
from yolov7_d2_tpu.train.train_state import (
    make_train_step as jax_make_train_step,
)
from yolov7_d2_tpu.utils.weight_port import port_torch_state_dict
from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.engine import build_yolox_system
from yolov7_d2_tpu_torch.parallel import dist as pdist
from yolov7_d2_tpu_torch.parallel.dryrun import (
    dryrun_multigpu,
    norm_sync_ranks,
)
from yolov7_d2_tpu_torch.parallel.launch import launch
from yolov7_d2_tpu_torch.parallel.norm_sync import (
    SyncBatchNorm2d,
    convert_sync_batchnorm,
    precise_bn,
)

WORLD = 2
TIMEOUT = 240.0  # seconds a spawn may take, ranks' imports included


def _ranks(tmp_path, fn, *args):
    """``fn(out_dir, *args)`` on WORLD gloo ranks; each rank's record."""
    launch(fn, WORLD, args=(str(tmp_path), *args), backend="gloo",
           timeout=TIMEOUT)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
            for r in range(WORLD)]


def _assert_ranks_equal(ranks, keys):
    for key in keys:
        first = ranks[0][key]
        for r, rec in enumerate(ranks[1:], 1):
            got = rec[key]
            if isinstance(first, dict):
                assert sorted(got) == sorted(first)
                for k in first:
                    assert torch.equal(got[k], first[k]), (r, key, k)
            else:
                assert torch.equal(got, first), (r, key)


def _jax_system(jcfg, torch_sd, batch_size):
    """The JAX state and train step wired as the JAX package's
    ``build_yolox_system`` wires them, with the port's initial weights
    (``port_torch_state_dict`` into the tree of an abstract flax init: the
    eager flax init takes half a minute on the CPU)."""
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(
        lambda key, x: model.init(key, x, train=False),
        jax.random.PRNGKey(0), jax_dummy_batch(jcfg, batch_size)["image"])
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    variables = jax.tree.map(jnp.asarray, port_torch_state_dict(
        {k: v.numpy() for k, v in torch_sd.items()}, tmpl)[0])
    tx = jax_build_optimizer(jcfg, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        ema_params=jax.tree.map(jnp.copy, variables["params"]))
    step = jax_make_train_step(
        model, jax_adapter(jcfg.MODEL.YOLO.CLASSES,
                           prefilter_topk=jax_resolve(jcfg)),
        tx, ema_decay=jcfg.SOLVER.EMA.DECAY,
        use_l1_after=jcfg.INPUT.MOSAIC_AND_MIXUP.DISABLE_AT_ITER,
        remat=jcfg.TPU.REMAT, seed=max(jcfg.SEED, 0))
    return state, step


def test_two_ranks_match_one_process_and_the_jax_mesh(tmp_path):
    """3 steps of 4 images (2 a rank): the JAX step under a (2, 1) data
    mesh, the port in one process, and the port on 2 gloo ranks
    (``SyncBatchNorm2d``, the global foreground count, DDP's reduced
    gradient), from the same flax init."""
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        images = rng.uniform(0, 255, (4, 64, 64, 3)).astype(np.float32)
        batches.append(dict(zip(
            ("image", "gt_boxes", "gt_classes", "gt_valid"),
            (images,) + _gts(rng, 4, 64, 8, [5, 3, 1, 4]))))
    jcfg = _jax_cfg(64, **{
        "SOLVER.BASE_LR": 0.002, "SOLVER.WARMUP_ITERS": 2,
        "SOLVER.WEIGHT_DECAY": 0.05,
        "SOLVER.WEIGHT_DECAY_BIAS": 0.01, "SOLVER.EMA.DECAY": 0.9,
        "SOLVER.CLIP_GRADIENTS.ENABLED": True,
        "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 40.0,
        "INPUT.MOSAIC_AND_MIXUP.DISABLE_AT_ITER": 1,
        "MODEL.YOLO.SIMOTA_PREFILTER_TOPK": 60})
    ycfg = YoloxConfig.from_cfg(jcfg)
    model, state, step = build_yolox_system(ycfg, device="cpu")
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    jstate, jstep = _jax_system(jcfg, sd0, 4)

    # the ranks run while JAX compiles its step here
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(
            _ranks, tmp_path, steps_with_and_without_remat, ycfg,
            [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
            "cpu", 0, sd0)
        mesh = build_mesh((WORLD, 1), ("data", "model"),
                          jax.devices()[:WORLD])
        jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
        jstep = jit_o0(jstep)
        jax_metrics = []
        for batch in batches:
            jstate, jm = jstep(jstate, shard_batch_pytree(
                {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
            jax_metrics.append(jm)
        ranks = spawned.result()
    for s, (batch, jm) in enumerate(zip(batches, jax_metrics)):
        state, tm = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        ms = [rec["metrics"][s] for rec in ranks]
        # the foreground count is global on every rank
        assert {m["num_fg"] for m in ms} == {float(tm["num_fg"])} == {
            float(jm["num_fg"])}, s
        # each rank's losses are its share of the global loss
        for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls",
                  "loss_l1"):
            got = sum(m[k] for m in ms)
            for want in (float(tm[k]), float(jm[k])):
                np.testing.assert_allclose(got, want, rtol=MODEL_LOSS_RTOL,
                                           err_msg=f"{k} step {s}")
        assert len({m["grad_norm"] for m in ms}) == 1
        for want in (float(tm["grad_norm"]), float(jm["grad_norm"])):
            np.testing.assert_allclose(ms[0]["grad_norm"], want,
                                       rtol=GRAD_RTOL if s == 0 else 1e-2)
    assert [rec["step"] for rec in ranks] == [3, 3] and state.step == 3
    _assert_ranks_equal(ranks, ("model", "ema"))
    # remat on the same ranks: the same steps, bit for bit
    for r, rec in enumerate(ranks):
        remat = torch.load(tmp_path / f"remat{r}.pt", weights_only=True)
        assert remat["metrics"] == rec["metrics"], r
        _assert_ranks_equal([rec, remat], ("model", "ema"))
        assert any(k.endswith("num_batches_tracked") for k in remat["model"])

    tmpl = jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32),
                        {"params": jstate.params,
                         "batch_stats": jstate.batch_stats})

    def flax(sd):
        return port_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                     tmpl)[0]

    final, ema = ranks[0]["model"], dict(ranks[0]["model"], **ranks[0]["ema"])
    one_f = {k: v.detach() for k, v in model.state_dict().items()}
    one_e = dict(one_f, **state.ema_params)
    init = flax(sd0)
    for want_name, want_f, want_e in (
            ("jax", {"params": jstate.params,
                     "batch_stats": jstate.batch_stats},
             {"params": jstate.ema_params}),
            ("one process", flax(one_f), flax(one_e))):
        for name, ours, theirs, coll in (
                ("params", flax(final), want_f, "params"),
                ("batch_stats", flax(final), want_f, "batch_stats"),
                ("ema", flax(ema), want_e, "params")):
            assert_trajectory_close(f"{want_name} {name}", ours[coll],
                                    init[coll], theirs[coll])


class _JaxBN(fnn.Module):
    momentum: float

    @fnn.compact
    def __call__(self, x, train=False):
        return JaxBatchNorm(use_running_average=not train,
                            momentum=self.momentum, epsilon=1e-3)(x)


def test_sync_batchnorm_all_reduce_norm_and_precise_bn(tmp_path):
    rng = np.random.default_rng(3)
    c = 5
    x = torch.from_numpy(rng.normal(3.0, 2.0, (6, c, 5, 4)).astype(
        np.float32))
    grad_out = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    params = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(
        np.float32)), "bias": torch.from_numpy(rng.normal(size=c).astype(
            np.float32)), "eps": 1e-3, "momentum": 0.1}
    running = torch.from_numpy(np.stack([
        np.stack([rng.normal(size=c), rng.uniform(0.5, 2.0, c)])
        for _ in range(WORLD)]).astype(np.float32))
    batches = torch.from_numpy(rng.normal(1.0, 3.0, (3, 6, c, 5, 4)).astype(
        np.float32))
    ranks = _ranks(tmp_path, norm_sync_ranks, params, x, grad_out, running,
                   batches, "cpu")
    _assert_ranks_equal(ranks, ("running_mean", "running_var",
                                "reduced_mean", "reduced_var",
                                "precise_mean", "precise_var"))

    # nn.BatchNorm2d on the whole batch
    ref = torch.nn.BatchNorm2d(c, eps=1e-3, momentum=0.1).train()
    with torch.no_grad():
        ref.weight.copy_(params["weight"])
        ref.bias.copy_(params["bias"])
    xr = x.clone().requires_grad_(True)
    y = ref(xr)
    (y * grad_out).sum().backward()
    close = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r["y"] for r in ranks]), y, **close)
    torch.testing.assert_close(torch.cat([r["x_grad"] for r in ranks]),
                               xr.grad, **close)
    for name, p in (("weight_grad", ref.weight), ("bias_grad", ref.bias)):
        torch.testing.assert_close(sum(r[name] for r in ranks), p.grad,
                                   rtol=1e-5, atol=1e-4)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(ranks[0][name], getattr(ref, name),
                                   **close)

    # all_reduce_norm: the mean of the ranks' statistics, as JAX's host hook
    want = allreduce_norm_host([
        {"bn": {"mean": jnp.asarray(running[r, 0].numpy()),
                "var": jnp.asarray(running[r, 1].numpy())}}
        for r in range(WORLD)])
    for ours, theirs in (("reduced_mean", "mean"), ("reduced_var", "var")):
        np.testing.assert_allclose(ranks[0][ours].numpy(),
                                   np.asarray(want["bn"][theirs]), rtol=1e-6)

    # precise_bn: JAX's on the whole batches, the port's in one process and
    # on 2 ranks of half batches (global moments)
    jmodel = _JaxBN(momentum=0.9)
    nhwc = [jnp.asarray(b.permute(0, 2, 3, 1).numpy()) for b in batches]
    variables = jmodel.init(jax.random.PRNGKey(0), nhwc[0])
    stats = jax_precise_bn(jmodel, variables["params"],
                           variables["batch_stats"], nhwc)["BatchNorm_0"]
    one = SyncBatchNorm2d(c, eps=1e-3, momentum=0.1)
    precise_bn(one, list(batches))
    for got in ((one.running_mean, one.running_var),
                (ranks[0]["precise_mean"], ranks[0]["precise_var"])):
        np.testing.assert_allclose(got[0].detach().numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[1].detach().numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5)


def test_sync_batchnorm_without_a_group_is_batchnorm():
    """One process: the same module as ``nn.BatchNorm2d`` (outputs and
    running statistics bitwise), with the same state-dict keys and the
    same parameter objects after the conversion."""
    torch.manual_seed(0)
    seq = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              torch.nn.BatchNorm2d(4, momentum=0.03))
    params = list(seq.parameters())
    keys = list(seq.state_dict())
    ref = torch.nn.BatchNorm2d(4, momentum=0.03)
    ref.load_state_dict(seq[1].state_dict())
    conv = convert_sync_batchnorm(seq)
    assert type(conv[1]) is SyncBatchNorm2d and not pdist.is_initialized()
    assert list(conv.parameters()) == params and list(conv.state_dict()) \
        == keys
    x = torch.randn(2, 4, 6, 6)
    for train in (True, False):
        conv[1].train(train)
        ref.train(train)
        assert torch.equal(conv[1](x), ref(x))
        assert torch.equal(conv[1].running_var, ref.running_var)
    assert pdist.local_batch_size(8) == 8 and pdist.get_world_size() == 1
    assert pdist.all_reduce_scalars({"a": torch.tensor(2.5), "b": 3}) == {
        "a": 2.5, "b": 3.0}


def test_dryrun_multigpu_two_ranks():
    """Two ranks are a (1, 2) grid, as the JAX dryrun's (n // 2, 2) mesh:
    the widest parameters (128 or more output features) sharded over the
    model axis, half of their rows a rank."""
    ranks = dryrun_multigpu(WORLD, device="cpu", timeout=TIMEOUT)
    assert len(ranks) == WORLD and ranks[0]["step"] == 1
    assert [r["grid"] for r in ranks] == [
        {"shape": (1, 2), "data_rank": 0, "model_rank": m} for m in (0, 1)]
    assert ranks[0]["shards"]
    for name, shard in ranks[0]["shards"].items():
        assert 2 * shard.shape[0] == ranks[0]["model"][name].shape[0] >= 128


def test_launch_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--num-gpus 2"):
        launch(print, 2)
    # the dryrun takes the cards unless it is asked for the CPU
    with pytest.raises(RuntimeError, match="--num-gpus 2"):
        dryrun_multigpu(2)
    with pytest.raises(ValueError, match="one machine"):
        launch(print, 1, num_machines=2, backend="gloo")
