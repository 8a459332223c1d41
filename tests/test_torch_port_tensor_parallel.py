"""Tensor parallelism over the model axis of the port's (data, model) grid
(``yolov7_d2_tpu_torch/parallel/mesh.py``) on the CPU: gloo process groups,
tiny shapes.

* The rule: ``tp_param_names`` selects the parameters whose flax leaves the
  JAX ``state_shardings`` shards, mapped through the weight carrier's
  names (a marker tree through ``jax_to_torch_state_dict``), and
  ``ShardSpec.take`` cuts the shard ``jax.device_put`` places on each
  model index (tiny YOLOX, DETR at 8): the dryrun's
  tiny YOLOX (``__graft_entry__._tiny_cfg``) on a (4, 2) mesh at 64,
  full-width YOLOX-s on a (1, 2) mesh at 128 (55 tensors, 8,658,944
  parameters; the JAX state from ``jax.eval_shape``, nothing
  initialised), and a tiny DETR at 32 (its ``Linear`` layers, the query
  embedding, the convolutions) and at 8 (the attention's packed
  projections, by head rows).
* ``build_grid``'s errors and the CLIs' grid, batch share and seeds from a
  ``CfgNode`` and a world size, without a spawn.
* The step: a (2 data, 2 model) grid of 4 gloo ranks at
  ``tp_min_features`` 64, 3 SGD + EMA steps of 4 images, against the
  port's one process and against the JAX ``train_step`` jitted on a (2, 2)
  mesh of 4 of conftest's virtual devices under ``state_shardings(...,
  64)``, at ``tests/test_torch_port_dist.py``'s tolerances (losses 1e-4
  relative, the gradient norm 1e-3 on the first step and 1e-2 after,
  parameters, BN statistics and EMA by their trajectory); the foreground
  count exact; each sharded parameter, its momentum and its EMA of O / 2
  rows; the gathered state bitwise equal on every rank (so the replicated
  parameters across model ranks), each shard bitwise equal across data
  ranks and different across model ranks.
* In one 2-rank spawn, a (1, 2) grid: a plain (channels_last input), a
  grouped and a depthwise ``Conv2d`` and a ``Linear``, each
  column-parallel against the whole module, with the gathers as
  all_gathers and as all_reduces of zero-filled buffers: output, input
  gradient and weight gradient within 1e-6 of their max; then one step of
  the tiny DETR (ResNet-18's ``ConvNorm`` column-parallel through its
  ``super().forward``, the ``Linear`` layers, the query embedding read
  gathered whole) against one process.

Measured gaps are printed (``-s``). Each spawn is bounded by ``launch``'s
``timeout``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__
from _torch_port_helpers import (
    DETR_TINY_OPTS,
    assert_trajectory_close,
    jit_o0,
    opts_list,
)
from _torch_port_tp_ranks import modules_then_steps
from test_torch_port_dist import _jax_system
from test_torch_port_train import (
    GRAD_RTOL,
    MODEL_LOSS_RTOL,
    REPO,
    _gts,
    _jax_cfg,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.parallel.mesh import (
    build_mesh,
    shard_batch_pytree,
    state_shardings,
)
from yolov7_d2_tpu.utils.weight_port import port_torch_state_dict
from yolov7_d2_tpu_torch.config import DetrConfig, YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system, build_yolox_system
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.parallel.dryrun import tiny_config, train_steps
from yolov7_d2_tpu_torch.parallel.launch import launch
from yolov7_d2_tpu_torch.parallel.mesh import (
    Grid,
    build_grid,
    tp_param_names,
)
from yolov7_d2_tpu_torch.train_det import rank_share
from yolov7_d2_tpu_torch.utils import weight_port as twp

TIMEOUT = 240.0  # seconds a spawn may take, ranks' imports included
DETR_OPTS = dict(DETR_TINY_OPTS, **{
    "MODEL.DETR.ENC_LAYERS": 1, "MODEL.DETR.DEC_LAYERS": 2,
    "MODEL.DETR.DROPOUT": 0.0, "MODEL.RESNETS.DEPTH": 18,
    "SOLVER.BASE_LR": 1e-3, "SOLVER.WARMUP_ITERS": 0,
    "SOLVER.WEIGHT_DECAY": 1e-2,
})
DETR_TP = 32  # selects the Linear layers and the query embedding


def _ranks(tmp_path, world, fn, *args, prefix="rank"):
    launch(fn, world, args=(str(tmp_path), *args), backend="gloo",
           timeout=TIMEOUT)
    return [torch.load(tmp_path / f"{prefix}{r}.pt", weights_only=True)
            for r in range(world)]


def _detr_cfgs():
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(str(REPO / "configs/coco/detr/"
                                "detr_256_6_6_r50.yaml"))
        cfg.merge_from_list(opts_list(DETR_OPTS))
        out.append(cfg)
    return out


def _rule_case(case):
    """(JAX flax params' shapes, the port's model, mesh shape, threshold,
    name map) of a rule case."""
    if case.startswith("detr"):
        jcfg, pcfg = _detr_cfgs()
        jmodel = jax_build_model(jcfg)
        shapes = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x),
            jnp.zeros((1, 64, 64, 3), jnp.float32))
        model = build_model(DetrConfig.from_cfg(pcfg), "cpu")
        return (shapes, model, (1, 2), int(case.split("_")[1]),
                twp.map_detr_torch_name)
    if case == "tiny_yolox_64":
        jcfg, pcfg, mesh, tp = (__graft_entry__._tiny_cfg(), tiny_config(),
                                (4, 2), 64)
    else:  # full-width YOLOX-s: width 0.5, depth 0.33, 80 classes
        jcfg = jax_get_cfg()
        jcfg.merge_from_file(str(REPO / "configs/coco/yolox_s.yaml"))
        pcfg, mesh, tp = YoloxConfig.from_cfg(jcfg), (1, 2), 128
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    return shapes, build_model(pcfg, "cpu"), mesh, tp, twp.map_yolox_torch_name


def _jax_sharded_keys(shapes, model, mesh_shape, tp, mapper):
    """The port's keys whose flax leaves ``state_shardings`` shards over
    ``model``: a marker tree (1 sharded, 0 replicated) through the weight
    carrier; a key that carries both kinds fails."""
    mesh = build_mesh(mesh_shape, ("data", "model"),
                      jax.devices()[:int(np.prod(mesh_shape))])
    specs = state_shardings(shapes["params"], mesh, tp_min_features=tp)
    markers = jax.tree.map(
        lambda a, s: np.full(a.shape, float(s.spec != P()), np.float32),
        shapes["params"], specs)
    stats = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         shapes.get("batch_stats", {}))
    got = twp.jax_to_torch_state_dict(
        {"params": markers, "batch_stats": stats}, model.state_dict(), mapper)
    mixed = [k for k, v in got.items() if 0 < float(np.mean(v)) < 1]
    assert not mixed, mixed
    return {k for k, v in got.items() if v.size and float(np.min(v)) == 1}


def _assert_carried_shards(shapes, model, mesh_shape, tp, mapper, specs):
    """A random flax state placed by ``jax.device_put`` under
    ``state_shardings``: the shard on each model index, carried into the
    port's names, is ``ShardSpec.take`` of the carried whole state."""
    rng = np.random.default_rng(0)
    tree = {coll: jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), t)
        for coll, t in shapes.items()}
    whole = {k: torch.from_numpy(v) for k, v in twp.jax_to_torch_state_dict(
        tree, model.state_dict(), mapper).items()}
    mesh = build_mesh(mesh_shape, ("data", "model"),
                      jax.devices()[:int(np.prod(mesh_shape))])
    placed = jax.device_put(tree["params"], state_shardings(
        tree["params"], mesh, tp_min_features=tp))
    size = mesh_shape[1]
    for m in range(size):
        device = mesh.devices[0, m]
        shard = jax.tree.map(lambda a: np.asarray(next(
            s.data for s in a.addressable_shards if s.device == device)),
            placed)
        mine = {k: specs[k].take(v, size, m) if k in specs else v
                for k, v in whole.items()}
        carried = twp.jax_to_torch_state_dict(
            dict(tree, params=shard), mine, mapper)
        for k, v in mine.items():
            assert torch.equal(torch.from_numpy(carried[k]), v), (m, k)


@pytest.mark.parametrize("case", ["tiny_yolox_64", "yolox_s_128", "detr_32",
                                  "detr_8"])
def test_rule_matches_jax_state_shardings(case):
    shapes, model, mesh_shape, tp, mapper = _rule_case(case)
    ours = tp_param_names(model, mesh_shape[1], tp)
    assert set(ours) == _jax_sharded_keys(shapes, model, mesh_shape, tp,
                                          mapper)
    if case in ("tiny_yolox_64", "detr_8"):
        _assert_carried_shards(shapes, model, mesh_shape, tp, mapper, ours)
    params = dict(model.named_parameters())
    if case == "yolox_s_128":
        assert len(ours) == 55
        assert sum(params[k].numel() for k in ours) == 8_658_944
        assert sum(p.numel() for p in params.values()) == 8_968_255
    if case == "detr_32":
        assert "query_embed.weight" in ours
        assert not any(k.endswith("in_proj_weight") for k in ours)
    if case == "detr_8":
        assert any(k.endswith("in_proj_weight") for k in ours)
        assert any(k.endswith("in_proj_bias") for k in ours)


def test_grid_layout_errors_and_the_clis_share():
    # rank r at data r // model, model r % model (JAX's reshape of devices)
    g = Grid.layout((-1, 2), 8, 5)
    assert (g.shape, g.data_rank, g.model_rank) == ((4, 2), 2, 1)
    assert (g.data_size, g.model_size) == (4, 2)
    g = Grid.layout((2, 2), 4, 2, ("model", "data"))
    assert (g.data_rank, g.model_rank, g.data_size) == (0, 1, 2)
    with pytest.raises(ValueError, match="cannot infer -1"):
        Grid.layout((-1, 2), 3, 0)
    with pytest.raises(ValueError, match="needs 8 processes"):
        Grid.layout((4, 2), 4, 0)
    with pytest.raises(ValueError, match="'data' and 'model'"):
        Grid.layout((2, 2), 4, 0, ("batch", "model"))
    # without a process group: a world of 1
    assert build_grid().shape == (1, 1)
    with pytest.raises(ValueError, match="cannot infer -1"):
        build_grid((-1, 2))
    with pytest.raises(ValueError, match="needs 8 processes"):
        build_grid((4, 2))
    # the CLIs: TPU.MESH_SHAPE over --num-gpus x machines
    cfg = get_cfg()
    cfg.SOLVER.IMS_PER_BATCH = 16
    grid, images = rank_share(cfg, 4, 3)  # MESH_SHAPE [-1, 1]
    assert (grid.shape, grid.data_rank, images) == ((4, 1), 3, 4)
    cfg.TPU.MESH_SHAPE = [-1, 2]
    shares = [rank_share(cfg, 4, r) for r in range(4)]
    assert [(g.data_rank, g.model_rank, n) for g, n in shares] == [
        (0, 0, 8), (0, 1, 8), (1, 0, 8), (1, 1, 8)]
    cfg.SOLVER.IMS_PER_BATCH = 9
    with pytest.raises(ValueError, match="data ranks"):
        rank_share(cfg, 4, 0)


def test_two_by_two_grid_matches_one_process_and_the_jax_mesh(tmp_path):
    rng = np.random.default_rng(17)
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
    rule = tp_param_names(model, 2, 64)
    jstate, jstep = _jax_system(jcfg, sd0, 4)

    # the ranks run while JAX compiles its step here
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(
            _ranks, tmp_path, 4, train_steps, ycfg,
            [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
            "cpu", 0, sd0, None, False, False, (2, 2), 64)
        mesh = build_mesh((2, 2), ("data", "model"), jax.devices()[:4])
        shardings = state_shardings(jstate, mesh, 64)
        jstep = jit_o0(jstep)
        jax_metrics = []
        for batch in batches:
            # each step's state placed by the rule again: the compiled step
            # takes the placement of its first call
            jstate, jm = jstep(jax.device_put(jstate, shardings),
                               shard_batch_pytree({
                                   k: jnp.asarray(v)
                                   for k, v in batch.items()}, mesh))
            jax_metrics.append(jm)
        ranks = spawned.result()
    assert [(r["grid"]["data_rank"], r["grid"]["model_rank"])
            for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    gaps = {}
    for s, (batch, jm) in enumerate(zip(batches, jax_metrics)):
        state, tm = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        ms = [rec["metrics"][s] for rec in ranks]
        # the model ranks of a data slice compute the same loss share
        assert ms[0] == ms[1] and ms[2] == ms[3], s
        assert {m["num_fg"] for m in ms} == {float(tm["num_fg"])} == {
            float(jm["num_fg"])}, s
        for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls",
                  "loss_l1"):
            got = ms[0][k] + ms[2][k]
            for who, want in (("one", float(tm[k])), ("jax", float(jm[k]))):
                np.testing.assert_allclose(got, want, rtol=MODEL_LOSS_RTOL,
                                           err_msg=f"{who} {k} step {s}")
                gaps[(who, k)] = max(gaps.get((who, k), 0.0),
                                     abs(got - want) / max(abs(want), 1e-12))
        for who, want in (("one", float(tm["grad_norm"])),
                          ("jax", float(jm["grad_norm"]))):
            np.testing.assert_allclose(ms[0]["grad_norm"], want,
                                       rtol=GRAD_RTOL if s == 0 else 1e-2)
            gaps[(who, f"grad_norm step {s}")] = abs(
                ms[0]["grad_norm"] - want) / want
    print("measured relative gaps of the (2, 2) grid:", gaps)
    assert [rec["step"] for rec in ranks] == [3] * 4 and state.step == 3

    # shards: O / 2 rows of the parameter, its momentum and its EMA; equal
    # across data ranks, apart across model ranks
    assert set(ranks[0]["shards"]) == set(rule) and len(rule) > 0
    for name in rule:
        rows = sd0[name].shape[0] // 2
        for rec in ranks:
            assert rec["shards"][name].shape[0] == rows, name
            assert rec["ema_shards"][name].shape[0] == rows, name
            assert [s[0] for s in rec["opt_shapes"][name]] == [rows], name
        for a, b in ((0, 2), (1, 3)):
            assert torch.equal(ranks[a]["shards"][name],
                               ranks[b]["shards"][name]), name
        assert not torch.equal(ranks[0]["shards"][name],
                               ranks[1]["shards"][name]), name
    # the gathered state, and so every replicated parameter, bitwise equal
    for rec in ranks[1:]:
        for key in ("model", "ema"):
            for k, v in ranks[0][key].items():
                assert torch.equal(rec[key][k], v), (key, k)

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
    jax_f = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    for want_name, want_f, want_e in (
            ("jax", jax_f, {"params": jstate.ema_params}),
            ("one process", flax(one_f), flax(one_e))):
        for name, ours, theirs, coll in (
                ("params", flax(final), want_f, "params"),
                ("batch_stats", flax(final), want_f, "batch_stats"),
                ("ema", flax(ema), want_e, "params")):
            assert_trajectory_close(f"{want_name} {name}", ours[coll],
                                    init[coll], theirs[coll])


def _module_cases(rng):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    torch.manual_seed(3)
    cases = {
        "conv": (torch.nn.Conv2d(6, 8, 3, 2, 1), t(2, 6, 9, 9).contiguous(
            memory_format=torch.channels_last), t(2, 8, 5, 5)),
        "grouped": (torch.nn.Conv2d(8, 12, 3, 1, 1, groups=4), t(2, 8, 6, 6),
                    t(2, 12, 6, 6)),
        "depthwise": (torch.nn.Conv2d(6, 6, 5, 1, 2, groups=6), t(2, 6, 7, 7),
                      t(2, 6, 7, 7)),
        "linear": (torch.nn.Linear(10, 6), t(3, 4, 10), t(3, 4, 6)),
    }
    for module, _, _ in cases.values():
        with torch.no_grad():
            module.bias.normal_()
    return cases


def test_column_parallel_modules_and_a_detr_step_on_two_ranks(tmp_path):
    rng = np.random.default_rng(23)
    cases = _module_cases(rng)
    _, pcfg = _detr_cfgs()
    # SGD, whose update is linear in the gradient: AdamW's first update,
    # g / (|g| + eps), would magnify the sum order's noise where |g| ~ eps
    dcfg = dataclasses.replace(DetrConfig.from_cfg(pcfg), optimizer="sgd")
    model, state, step, _ = build_system(dcfg, device="cpu")
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {"image": torch.from_numpy(
        rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8))}
    boxes = np.zeros((2, 6, 4), np.float32)
    boxes[:, :3] = [[4, 6, 30, 40], [20, 10, 60, 50], [8, 30, 40, 62]]
    batch.update(gt_boxes=torch.from_numpy(boxes),
                 gt_classes=torch.from_numpy(
                     rng.integers(0, 3, (2, 6)).astype(np.int32)),
                 gt_valid=torch.from_numpy(np.arange(6)[None] < np.array(
                     [[3], [2]])))
    ranks = _ranks(tmp_path, 2, modules_then_steps, cases, (
        dcfg, [batch], "cpu", 0, sd0, None, False, False, (1, 2), DETR_TP))
    mods = [torch.load(tmp_path / f"modules{r}.pt", weights_only=True)
            for r in range(2)]

    for name, (module, x, grad_out) in cases.items():
        xr = x.clone().requires_grad_(True)
        y = module(xr)
        y.backward(grad_out)
        for how in ("all_gather", "all_reduce"):
            for rec in mods:
                got = rec[f"{name}/{how}"]
                assert got["type"] == ("ColumnParallelLinear"
                                       if name == "linear"
                                       else "ColumnParallelConv2d")
                assert got["rows"] == module.weight.shape[0] // 2
                for key, want in (("y", y), ("x_grad", xr.grad),
                                  ("weight_grad", module.weight.grad),
                                  ("bias_grad", module.bias.grad)):
                    tol = 1e-6 * float(want.detach().abs().max())
                    gap = float((got[key] - want.detach()).abs().max())
                    assert gap <= tol, (name, how, key, gap)
            assert torch.equal(mods[0][f"{name}/{how}"]["y"],
                               mods[1][f"{name}/{how}"]["y"])

    # the DETR step on (1, 2) against one process
    state, m = step(state, batch)
    got = ranks[0]["metrics"][0]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert set(ranks[0]["shards"]) == set(tp_param_names(model, 2, DETR_TP))
    assert "query_embed.weight" in ranks[0]["shards"]
    for k in ("loss_ce", "loss_bbox", "loss_giou", "total_loss"):
        np.testing.assert_allclose(got[k], float(m[k]), rtol=MODEL_LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                               rtol=GRAD_RTOL)
    one = model.state_dict()
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k
    assert_trajectory_close(
        "detr (1, 2) vs one process",
        {k: v.numpy() for k, v in ranks[0]["model"].items()},
        {k: v.numpy() for k, v in sd0.items()},
        {k: v.numpy() for k, v in one.items()})
