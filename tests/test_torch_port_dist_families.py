"""The port's data-parallel training of SparseInst, DETR and AnchorDETR on
the CPU: gloo process groups of 2 ranks, tiny shapes.

* 2 processes (``parallel.dryrun.train_steps``: DDP, the global matched
  count of SparseInst, DETR's normalizers in one all-reduce) against 1 on
  the same global batch of 4 images at 64 px, and against the JAX
  ``train_step`` of its ``engine.build_system`` jitted under a (2, 1) data
  mesh of 2 of conftest's virtual CPU devices (one step over the global
  batch): SparseInst (ResNet-18 layout of the R-50 yaml, 20 masks, AdamW)
  2 steps, DETR (1 + 2 layers, 10 queries, dropout 0, the softmax
  criterion) 2 steps, AnchorDETR (the focal criterion) 1 step, each from
  the same flax weights. Tolerances are those of the families'
  single-process tests (``tests/test_torch_port_sparseinst.py``,
  ``tests/test_torch_port_detr.py``): each loss term 1e-4 relative, the
  gradient norm 1e-3 on the first step (1e-2 after, as
  ``tests/test_torch_port_dist.py``), the global counts and the matcher's
  assignments exact, every rank bitwise equal to the other; none of the
  three has a BatchNorm for ``convert_sync_batchnorm`` to convert;
* the trainer's reduction of a step's metrics over 2 ranks, by kind
  (``train_state.METRIC_KINDS``): shares summed, global counts as they
  are, the auction's rounds by their maximum, a per-image mean averaged;
* the dropout masks of ``engine.seed_dropout_by_step``: another rank
  draws other masks, and a step's masks do not depend on the steps
  before it.

Each spawn is bounded by ``launch``'s ``timeout``: past it the ranks are
killed and the test fails.
"""

import copy
import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_port_helpers import (
    DETR_TINY_OPTS,
    REPO,
    detr_gt,
    detr_variables_like,
    flax_variables_like,
    jit_o0,
    load_into,
    opts_list,
)
from yolov7_d2_tpu import engine as jengine
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.parallel.mesh import build_mesh, shard_batch_pytree
from yolov7_d2_tpu.train.optimizer import build_optimizer as jax_opt
from yolov7_d2_tpu.train.train_state import TrainState as JaxTrainState
from yolov7_d2_tpu_torch.config import DetrConfig, SparseInstConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system, seed_dropout_by_step
from yolov7_d2_tpu_torch.parallel.dryrun import (
    merge_matches,
    reduce_metrics_ranks,
    train_steps,
)
from yolov7_d2_tpu_torch.parallel.launch import launch
from yolov7_d2_tpu_torch.parallel.norm_sync import (
    SyncBatchNorm2d,
    convert_sync_batchnorm,
)
from yolov7_d2_tpu_torch.train.train_state import metric_kind
from yolov7_d2_tpu_torch.utils import weight_port as twp

WORLD = 2
TIMEOUT = 240.0  # seconds a spawn may take, ranks' imports included
SIZE = 64
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
SI_YAML = "configs/coco/sparseinst/sparse_inst_r50_base.yaml"
SI_OPTS = {
    "INPUT.INPUT_SIZE": [SIZE, SIZE], "SOLVER.AMP.ENABLED": False,
    "MODEL.RESNETS.DEPTH": 18, "MODEL.SPARSE_INST.DECODER.NUM_MASKS": 20,
    "MODEL.SPARSE_INST.DECODER.KERNEL_DIM": 32,
    "MODEL.SPARSE_INST.DECODER.NUM_CLASSES": 8,
    "MODEL.SPARSE_INST.ENCODER.NUM_CHANNELS": 64,
    "SOLVER.BASE_LR": 1e-3, "SOLVER.WARMUP_ITERS": 0,
    "SOLVER.WEIGHT_DECAY": 1e-2,
}
DETR_OPTS = dict(DETR_TINY_OPTS, **{
    "MODEL.DETR.ENC_LAYERS": 1, "MODEL.DETR.DEC_LAYERS": 2,
    "MODEL.DETR.DROPOUT": 0.0, "MODEL.RESNETS.DEPTH": 18,
    "SOLVER.BASE_LR": 1e-3, "SOLVER.WARMUP_ITERS": 0,
    "SOLVER.WEIGHT_DECAY": 1e-2,
})
# family -> (yaml, options, steps)
FAMILIES = {
    "sparseinst": (SI_YAML, SI_OPTS, 2),
    "detr": ("configs/coco/detr/detr_256_6_6_r50.yaml", DETR_OPTS, 2),
    "anchordetr": ("configs/coco/detr/anchordetr_r50.yaml", DETR_OPTS, 1),
}


def _ranks(tmp_path, fn, *args):
    """``fn(out_dir, *args)`` on WORLD gloo ranks; each rank's record."""
    launch(fn, WORLD, args=(str(tmp_path), *args), backend="gloo",
           timeout=TIMEOUT)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
            for r in range(WORLD)]


def _merged(get, family):
    yaml, opts, _ = FAMILIES[family]
    cfg = get()
    cfg.merge_from_file(str(REPO / yaml))
    cfg.merge_from_list(opts_list(opts))
    return cfg


def _batches(family, steps, rng):
    """``steps`` global batches of 4 uint8 images and their gts (SparseInst:
    rectangles as uint8 masks [4, 6, 64, 64] of 8 classes; DETR: xyxy
    boxes of 3 classes)."""
    out = []
    for _ in range(steps):
        batch = {"image": rng.integers(0, 256, (4, SIZE, SIZE, 3)).astype(
            np.uint8)}
        if family == "sparseinst":
            g, counts = 6, rng.integers(1, 7, 4)
            masks = np.zeros((4, g, SIZE, SIZE), np.uint8)
            valid = np.arange(g)[None] < counts[:, None]
            for i, j in zip(*np.nonzero(valid)):
                y0, x0 = rng.integers(0, SIZE - 20, 2)
                h, w = rng.integers(6, 20, 2)
                masks[i, j, y0:y0 + h, x0:x0 + w] = 1
            batch.update(gt_masks=masks, gt_valid=valid,
                         gt_classes=(rng.integers(0, 8, (4, g))
                                     * valid).astype(np.int32))
        else:
            batch.update(detr_gt(rng, b=4, counts=tuple(
                int(c) for c in rng.integers(1, 7, 4))))
        out.append(batch)
    return out


def _jax_steps(jcfg, variables, batches, monkeypatch):
    """The JAX ``engine.build_system`` step of ``jcfg`` from ``variables``
    (its optimizer state fresh; the flax init replaced, as the eager init
    costs seconds), jitted over a (2, 1) data mesh: each step's metrics."""
    def make_state(model, cfg, rng, batch_size):
        tx = jax_opt(cfg, variables["params"])
        return variables, tx, JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats", {}),
            opt_state=tx.init(variables["params"]), ema_params=None)

    monkeypatch.setattr(jengine, "_make_state", make_state)
    _, state, step, _ = jengine.build_system(jcfg)
    mesh = build_mesh((WORLD, 1), ("data", "model"), jax.devices()[:WORLD])
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = jit_o0(step)
    metrics = []
    for batch in batches:
        jb = {k: jnp.asarray(v.astype(np.float32) if k == "image" else v)
              for k, v in batch.items()}
        state, m = step(state, shard_batch_pytree(jb, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _combine(ms):
    """The ranks' metrics of one step as the trainer reduces them."""
    out = {}
    for k in ms[0]:
        vals = [m[k] for m in ms]
        kind = metric_kind(k)
        if kind == "global":
            assert len(set(vals)) == 1, (k, vals)
        out[k] = {"global": vals[0], "max": max(vals),
                  "mean": sum(vals) / len(vals)}.get(kind, sum(vals))
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_ranks_match_one_process_and_the_jax_mesh(family, tmp_path,
                                                      monkeypatch):
    _, _, steps = FAMILIES[family]
    rng = np.random.default_rng({"sparseinst": 3, "detr": 4,
                                 "anchordetr": 5}[family])
    jcfg = _merged(jax_get_cfg, family)
    pcfg = _merged(get_cfg, family)
    jmodel = jax_build_model(jcfg)
    images = np.zeros((4, SIZE, SIZE, 3), np.float32)
    if family == "sparseinst":
        pcfg = SparseInstConfig.from_cfg(pcfg)
        variables = flax_variables_like(jmodel, images, rng)
        mapper = twp.map_sparseinst_torch_name
    else:
        pcfg = DetrConfig.from_cfg(pcfg)
        variables = detr_variables_like(jmodel, images.shape, rng)
        mapper = (twp.map_detr_torch_name if family == "detr" else
                  functools.partial(twp.map_anchor_detr_torch_name,
                                    attention_type=pcfg.attention_type))
        assert pcfg.use_focal == (family == "anchordetr")
    batches = _batches(family, steps, rng)
    model, state, step, _ = build_system(pcfg, device="cpu")
    load_into(model, variables, mapper).train()
    # no train-mode BatchNorm (FrozenBN, LayerNorm): nothing to synchronize
    assert not any(isinstance(m, SyncBatchNorm2d) for m in
                   convert_sync_batchnorm(copy.deepcopy(model)).modules())
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}

    # the ranks run while JAX compiles its step here
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(
            _ranks, tmp_path, train_steps, pcfg,
            [{k: torch.from_numpy(v) for k, v in b.items()}
             for b in batches], "cpu", 0, sd0)
        jax_metrics = _jax_steps(jcfg, variables, batches, monkeypatch)
        ranks = spawned.result()

    one, own = [], []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        one.append({k: float(v) for k, v in m.items()})
        own.append(state.match)
    for s in range(steps):
        got = _combine([rec["metrics"][s] for rec in ranks])
        for k in ("num_inst", "num_matched", "aux0_num_matched"):
            if k in got:
                assert got[k] == one[s][k], (k, s)
        if "num_inst" in got:
            assert got["num_inst"] == jax_metrics[s]["num_inst"], s
        losses = [k for k in jax_metrics[s] if "loss" in k
                  or "cardinality" in k]
        assert "total_loss" in losses
        for k in losses:
            for want in (one[s][k], jax_metrics[s][k]):
                np.testing.assert_allclose(got[k], want, rtol=LOSS_RTOL,
                                           atol=1e-7, err_msg=f"{k} {s}")
        for want in (one[s]["grad_norm"], jax_metrics[s]["grad_norm"]):
            np.testing.assert_allclose(got["grad_norm"], want,
                                       rtol=GRAD_RTOL if s == 0 else 1e-2)
        # the assignments: the ranks' on their images, merged, are the
        # one process's on the global batch
        levels = own[s][0].shape[0] // 4
        merged = merge_matches([rec["matches"][s] for rec in ranks], levels)
        for a, b in zip(merged, own[s]):
            assert torch.equal(a, b), s
        assert bool(own[s][1].any())
    assert [rec["step"] for rec in ranks] == [steps] * WORLD
    for name, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][name]), name


def test_metrics_reduce_over_ranks_by_kind(tmp_path):
    per_rank = [
        {"loss_ce": 1.5, "num_inst": 7.0, "match_iters": 9.0,
         "cardinality_error": 2.0, "aux1_cardinality_error": 1.0,
         "aux1_num_matched": 3.0, "grad_norm": 0.25},
        {"loss_ce": 0.5, "num_inst": 7.0, "match_iters": 24.0,
         "cardinality_error": 5.0, "aux1_cardinality_error": 0.0,
         "aux1_num_matched": 4.0, "grad_norm": 0.25},
    ]
    want = {"loss_ce": 2.0, "num_inst": 7.0, "match_iters": 24.0,
            "cardinality_error": 3.5, "aux1_cardinality_error": 0.5,
            "aux1_num_matched": 7.0, "grad_norm": 0.25}
    ranks = _ranks(tmp_path, reduce_metrics_ranks, per_rank)
    assert ranks[0] == ranks[1] == want
    assert _combine(per_rank) == want


def test_dropout_masks_differ_by_rank_and_not_by_history(monkeypatch):
    """``seed_dropout_by_step``: the generator's draws of a step on data
    rank 0 and data rank 1 differ, data rank 0's are the seed's and the
    step's alone (the same after other steps), and a world of 1 is data
    rank 0. The draws follow the data rank, so the model ranks of a data
    slice draw alike."""
    from yolov7_d2_tpu_torch import engine

    def draw(state, batch):
        return state, torch.rand(8, generator=state.model.generator)

    step = seed_dropout_by_step(draw, seed=3)

    def run(rank, at, before=()):
        monkeypatch.setattr(engine, "get_data_rank", lambda: rank)
        state = SimpleNamespace(step=0, model=SimpleNamespace(
            generator=torch.Generator()))
        for s in (*before, at):
            state.step = s
            _, masks = step(state, None)
        return masks

    assert torch.equal(run(0, 5), run(0, 5, before=(0, 1, 2)))
    assert not torch.equal(run(0, 5), run(1, 5))
    assert not torch.equal(run(0, 5), run(0, 6))
    assert torch.equal(run(1, 2), run(1, 2, before=(7,)))
