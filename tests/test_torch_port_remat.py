"""Rematerialization in the port (``utils/remat.py``; ``TPU.REMAT`` as
every family's ``remat``, ``MODEL.DETR.REMAT`` as DETR's ``layer_remat``)
on the CPU, float32, tiny shapes.

* A step with remat against the same step without it, from equal weights
  on the same batch: the losses, every gradient, the BatchNorm running
  statistics and ``num_batches_tracked`` within 1e-6 relative (measured:
  bitwise, the recompute runs the same kernels on the same inputs). The
  tiny YOLOX (train-mode BatchNorm: the statistics must take one update a
  step) and the tiny DETR with dropout 0.1 (the recompute must draw the
  first forward's masks from the model's generator), each way of
  recomputing.
* ``remat_call`` alone: a BatchNorm and a dropout from an explicit
  generator; without the replay the gradient differs, which is the fault
  the replay prevents.
* The tiny DETR step with ``TPU.REMAT`` and ``MODEL.DETR.REMAT`` against
  the JAX step with both (``jax.checkpoint`` of the forward, ``nn.remat``
  of each layer), dropout 0 (the two packages draw other masks), the
  tolerances of ``tests/test_torch_port_detr_feed.py`` (1e-4). The YOLOX
  step with remat against the JAX step with ``TPU.REMAT`` is
  ``tests/test_torch_port_device_aug.py::
  test_device_aug_step_matches_jax_step``; 2 gloo ranks with remat against
  2 without, ``tests/test_torch_port_dist.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    DETR_GRAD_GT_SEED,
    DETR_SIZE,
    DETR_TINY_OPTS,
    detr_gt,
    detr_pair,
    jit_o0,
    load_into,
    merged_detr_cfg,
    tiny_cfg,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system, config_from_cfg
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.layers.transformer import dropout
from yolov7_d2_tpu_torch.utils.remat import remat_call

RTOL = 1e-6
FWD_TOL = 1e-4


def _step_record(cfg, batch):
    """One step of ``build_system(cfg)`` on the CPU from seed 0: (its
    metrics, each parameter's gradient, the BatchNorm buffers after it)."""
    model, state, step, _ = build_system(cfg, device="cpu", seed=0)
    grads = {}
    update = state.optimizer.step

    def grab():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        update()

    state.optimizer.step = grab
    _, metrics = step(state, batch)
    buffers = {k: v.clone() for k, v in model.state_dict().items()
               if "running_" in k or "num_batches_tracked" in k}
    return metrics, grads, buffers


def _assert_records_equal(got, want):
    gm, gg, gb = got
    wm, wg, wb = want
    assert sorted(gm) == sorted(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=RTOL,
                                   err_msg=k)
    assert sorted(gg) == sorted(wg) and len(wg) > 20
    for k in wg:
        scale = float(wg[k].abs().max())
        assert float((gg[k] - wg[k]).abs().max()) <= RTOL * scale, k
    assert sorted(gb) == sorted(wb)
    for k in wb:
        assert torch.equal(gb[k], wb[k]), k


def _boxes(rng, b, g=8, n=3, size=64):
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(n):
            xy = rng.uniform(0, size * 0.6, 2)
            boxes[i, j] = np.concatenate([xy, xy + rng.uniform(8, size * 0.4,
                                                               2)])
            valid[i, j] = True
    return {"gt_boxes": torch.from_numpy(boxes),
            "gt_classes": torch.from_numpy((rng.integers(0, 2, (b, g))
                                            * valid).astype(np.int32)),
            "gt_valid": torch.from_numpy(valid)}


def test_yolox_step_with_remat_equals_the_step_without():
    rng = np.random.default_rng(0)
    cfg = config_from_cfg(tiny_cfg(get_cfg))
    batch = dict(_boxes(rng, 4), image=torch.from_numpy(
        rng.uniform(0, 255, (4, 64, 64, 3)).astype(np.float32)))
    want = _step_record(cfg, batch)
    assert any(k.endswith("num_batches_tracked") for k in want[2])
    _assert_records_equal(_step_record(
        dataclasses.replace(cfg, remat=True), batch), want)
    assert config_from_cfg(tiny_cfg(get_cfg, TPU__REMAT=True)).remat


@pytest.mark.parametrize("remat,layer_remat", [(True, False), (False, True),
                                               (True, True)])
def test_detr_step_with_remat_equals_the_step_without(remat, layer_remat):
    rng = np.random.default_rng(1)
    cfg = config_from_cfg(merged_detr_cfg(
        get_cfg, "detr_256_6_6_r50.yaml",
        **dict(DETR_TINY_OPTS, **{"MODEL.DEVICE": "cpu"})))
    assert cfg.dropout == 0.1 and not cfg.remat and not cfg.layer_remat
    batch = dict(_boxes(rng, 2), image=torch.from_numpy(
        rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)))
    want = _step_record(cfg, batch)
    _assert_records_equal(_step_record(dataclasses.replace(
        cfg, remat=remat, layer_remat=layer_remat), batch), want)
    model = build_model(dataclasses.replace(cfg, layer_remat=layer_remat),
                        "cpu")
    assert model.transformer.remat == layer_remat


def test_remat_call_replays_the_generator_and_keeps_the_statistics():
    torch.manual_seed(0)
    bn = torch.nn.BatchNorm2d(4)
    conv = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(2, 3, 8, 8)
    gen = torch.Generator()

    def fn(inp):
        return dropout(bn(conv(inp)), 0.5, True, gen).square().sum()

    def run(call):
        """(loss, the conv's gradient, the running mean, the count, the
        generator's state after the backward)."""
        for p in (*conv.parameters(), *bn.parameters()):
            p.grad = None
        bn.reset_running_stats()
        gen.manual_seed(5)
        loss = call(x)
        loss.backward()
        return (float(loss.detach()), conv.weight.grad.clone(),
                bn.running_mean.clone(), int(bn.num_batches_tracked),
                gen.get_state())

    want = run(fn)
    got = run(lambda inp: remat_call(fn, inp, generators=(gen,), norms=bn))
    assert got[0] == want[0] and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2]) and got[3] == want[3] == 1
    assert torch.equal(got[4], want[4])     # the generator where it was
    # without the replay the recompute draws other masks; without the
    # kept statistics BatchNorm takes a second update
    bare = run(lambda inp: remat_call(fn, inp))
    assert bare[0] == want[0] and not torch.equal(bare[1], want[1])
    assert bare[3] == 2 and not torch.equal(bare[2], want[2])


def test_detr_remat_step_matches_jax(monkeypatch):
    """One step of the tiny DETR at dropout 0 with ``TPU.REMAT`` and
    ``MODEL.DETR.REMAT`` through ``build_system``, against the JAX
    ``make_train_step(..., remat=True)`` of the flax DETR with
    ``remat=True``, from equal weights: the loss terms and the gradient
    norm."""
    from yolov7_d2_tpu.models.meta_arch import detr as jd
    from yolov7_d2_tpu.train.optimizer import build_optimizer as jax_opt
    from yolov7_d2_tpu.train.train_state import TrainState, make_train_step
    from yolov7_d2_tpu_torch.models.meta_arch import detr as td

    opts = dict(DETR_TINY_OPTS, **{"MODEL.DETR.DROPOUT": 0.0,
                                   "SOLVER.BASE_LR": 1e-3,
                                   "SOLVER.WARMUP_ITERS": 0,
                                   "MODEL.DETR.REMAT": True,
                                   "TPU.REMAT": True})
    jcfg = merged_detr_cfg(jax_get_cfg, "detr_256_6_6_r50.yaml", **opts)
    jmodel, variables, _, images, mapper = detr_pair("detr")
    jmodel = jmodel.clone(remat=True)
    tx = jax_opt(jcfg, variables["params"])
    jstate = TrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]))
    gt = detr_gt(np.random.default_rng(DETR_GRAD_GT_SEED))

    def loss_fn(out, batch, use_l1):
        return jd.detr_losses(out, batch, 3, (DETR_SIZE, DETR_SIZE))

    _, jm = jit_o0(make_train_step(jmodel, loss_fn, tx, remat=True))(
        jstate, dict({k: jnp.asarray(v) for k, v in gt.items()},
                     image=jnp.asarray(images)))

    cfg = config_from_cfg(merged_detr_cfg(
        get_cfg, "detr_256_6_6_r50.yaml", **dict(opts, **{"MODEL.DEVICE":
                                                          "cpu"})))
    assert cfg.remat and cfg.layer_remat
    model, state, step, _ = build_system(cfg, device="cpu")
    assert model.transformer.remat
    load_into(model, variables, mapper)
    # NCHW, as the JAX comparisons of DETR's gradients run (ROADMAP C.20)
    plain = td.normalize_images_plain
    model.to(memory_format=torch.contiguous_format)
    monkeypatch.setattr(td, "normalize_images_plain",
                        lambda *a: plain(*a).contiguous())
    batch = {k: torch.from_numpy(v) for k, v in gt.items()}
    batch["image"] = torch.from_numpy(images.astype(np.uint8))
    _, m = step(state, batch)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=FWD_TOL,
                                   err_msg=k)
    assert float(m["grad_norm"]) > 0


def test_detr_config_reads_both_switches():
    jcfg = merged_detr_cfg(get_cfg, "detr_256_6_6_r50.yaml",
                           **{"MODEL.DETR.REMAT": True})
    cfg = config_from_cfg(jcfg)
    assert cfg.layer_remat and not cfg.remat
    cfg = config_from_cfg(merged_detr_cfg(get_cfg, "detr_256_6_6_r50.yaml",
                                          **{"TPU.REMAT": True}))
    assert cfg.remat and not cfg.layer_remat
