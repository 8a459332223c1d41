"""The port's anchor-YOLO training through ``engine.build_system`` against
the JAX package's, in float32 on the CPU: a 3-step YOLOV7 trajectory (SGD
over the decay classes, warm-up, clipping, EMA, BN statistics) and
``build_system`` under YOLOX.

The model: YOLOV7 at reduced depth (one block a Darknet stage,
``_torch_port_helpers.ANCHOR_ARCHS``), 64 px. Tolerances: losses 1e-4
relative (the forward's), ``num_fg`` exact, the gradient norm 1e-3 on the
first step and 1e-2 after updates (which amplify the gradients' float
noise), parameters, BN statistics and EMA at the tolerances of
``assert_trajectory_close`` (the YOLOX trajectory's).
"""

import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import (
    ANCHOR_CLASSES,
    anchor_yolo_modules,
    anchor_yolo_name_mapper,
    assert_trajectory_close,
    flax_variables_like,
    load_into,
    tiny_cfg,
)
from yolov7_d2_tpu import engine as jax_engine
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.utils.weight_port import port_torch_state_dict
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config.defaults import get_cfg

REPO = Path(__file__).resolve().parent.parent
MODEL_LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3


def _gts(rng, b, size, g, n_valid):
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        wh = rng.uniform(0.15, 0.8, (n, 2)) * size
        c = rng.uniform(wh / 2, size - wh / 2)
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :n] = True
    classes = (rng.integers(0, ANCHOR_CLASSES, (b, g)) * valid).astype(
        np.int32)
    return boxes, classes, valid


def _yolov7_cfgs():
    opts = {
        "MODEL.YOLO.CLASSES": ANCHOR_CLASSES, "MODEL.YOLO.MAX_BOXES_NUM": 8,
        "INPUT.INPUT_SIZE": [64, 64], "SOLVER.AMP.ENABLED": False,
        "SOLVER.BASE_LR": 0.002, "SOLVER.WARMUP_ITERS": 2,
        "SOLVER.WEIGHT_DECAY": 0.05, "SOLVER.WEIGHT_DECAY_BIAS": 0.01,
        "SOLVER.EMA.ENABLED": True, "SOLVER.EMA.DECAY": 0.9,
        "SOLVER.CLIP_GRADIENTS.ENABLED": True,
        "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 40.0,
        "MODEL.YOLO.WIDTH_MUL": 0.25, "MODEL.YOLO.DEPTH_MUL": 0.33,
    }
    out = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.merge_from_file(str(REPO / "configs" / "coco" / "yolov7.yaml"))
        for k, v in opts.items():
            node, _, leaf = k.rpartition(".")
            target = cfg
            for part in node.split("."):
                target = getattr(target, part)
            setattr(target, leaf, v)
        out.append(cfg)
    return out


def test_yolov7_sgd_ema_trajectory_3steps(monkeypatch):
    """3 steps of the JAX ``build_system``'s step against the port's
    ``build_system``, both building YOLOV7 from ``configs/coco/yolov7.yaml``
    (cut to 64 px, 6 classes, width 0.25, EMA and clipping on) with the
    one-block-a-stage model in place of the full-depth one: parameters, BN
    running statistics and EMA agree afterwards."""
    cfg, jcfg = _yolov7_cfgs()
    jmodel, tmodel = anchor_yolo_modules("YOLOV7")
    init = flax_variables_like(jmodel, np.zeros((2, 64, 64, 3)),
                               np.random.default_rng(3))
    monkeypatch.setattr(jax_engine, "build_model", lambda c: jmodel)
    # the JAX builder's flax init (an eager one, 20 s) draws what any init
    # would: hand it the variables drawn with numpy instead
    make_state = jax_engine._make_state
    monkeypatch.setattr(
        jax_engine, "_make_state", lambda model, *a: make_state(
            types.SimpleNamespace(init=lambda *_, **__: init), *a))
    monkeypatch.setattr(engine, "build_model",
                        lambda c, device, seed: tmodel)
    _, jstate, jstep, jfields = jax_engine.build_system(
        jcfg, jax.random.PRNGKey(0), 2)
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    assert fields == jfields and model is tmodel and model.training
    mapper = anchor_yolo_name_mapper("YOLOV7")
    load_into(model, init, mapper).train()
    state.ema_params = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
    sd0 = {k: v.numpy().copy() for k, v in model.state_dict().items()}

    rng = np.random.default_rng(22)
    jstep = jax.jit(jstep)
    for s in range(3):
        images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
        gts = _gts(rng, 2, 64, 8, [5, 3])
        batch = dict(zip(fields, (images,) + gts))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, tm = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        assert float(tm["num_fg"]) == float(jm["num_fg"]) > 3, s
        for k in ("loss_box", "loss_obj", "loss_cls", "total_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=MODEL_LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=GRAD_RTOL if s == 0 else 1e-2)
    assert state.step == 3 and int(jstate.step) == 3

    tmpl = jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32),
                        {"params": jstate.params,
                         "batch_stats": jstate.batch_stats})
    final = {k: v.numpy() for k, v in model.state_dict().items()}
    ema = dict(final, **{k: v.numpy() for k, v in state.ema_params.items()})
    port = functools.partial(port_torch_state_dict, variables=tmpl,
                             name_mapper=mapper, strict=True)
    port_f, port_e, port_i = (port(sd)[0] for sd in (final, ema, sd0))
    for name, ours, theirs, coll in (
            ("params", port_f, jstate.params, "params"),
            ("batch_stats", port_f, jstate.batch_stats, "batch_stats"),
            ("ema", port_e, jstate.ema_params, "params")):
        assert_trajectory_close(name, ours[coll], port_i[coll], theirs)


def test_build_system_under_yolox_is_build_yolox_system():
    cfg = tiny_cfg(get_cfg)
    batch = engine.dummy_batch(engine.YoloxConfig.from_cfg(cfg), 2,
                               device="cpu")
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    assert fields == ("image", "gt_boxes", "gt_classes", "gt_valid")
    _, state2, step2 = engine.build_yolox_system(
        engine.YoloxConfig.from_cfg(cfg), device="cpu")
    for a, b in zip(model.state_dict().values(),
                    state2.model.state_dict().values()):
        assert torch.equal(a, b)
    _, m1 = step(state, batch)
    _, m2 = step2(state2, batch)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
