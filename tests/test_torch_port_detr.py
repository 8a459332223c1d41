"""The port's DETR and AnchorDETR against the JAX package, in float32 on the
CPU: sine embeddings, MLP, the encoder and decoder layers, RCDA,
AnchorDETR's forward and gradients, the batched set criterion, the
tails, the weight carrier, the optimizer's groups, dropout and the
builders. DETR's forward, gradients and one AdamW train step share one
compile of the JAX train step in ``test_torch_port_detr_feed.py``.

Sizes: ResNet-50 at 64 px, hidden 32, 4 heads, 2 + 2 layers, FFN 64, 10
queries (AnchorDETR 4 positions x 2 patterns), 3 classes
(``_torch_port_helpers.detr_pair``). Weights: flax variables drawn with
numpy (``detr_variables_like``: kernels at the flax init's scale, random
FrozenBN statistics and affine parameters, random biases and raw
parameters), moved into the port by ``jax_to_torch_state_dict``. The JAX
variables and compiled functions are built once per process.

Tolerances, each with its reason:

* layers: 1e-5 of each output's largest magnitude (one layer's sums in
  another order);
* whole models: 1e-4 of the largest magnitude (XLA-CPU and oneDNN sum each
  convolution in another order; measured about 1e-6);
* assignments: exact, level by level (the port keeps the JAX tie rules,
  and its one stacked auction treats every row on its own);
* loss terms: 1e-5 relative on the same outputs;
* gradients: each parameter's within 1e-4 of its norm, the port in NCHW
  (in channels_last oneDNN's CPU convolutions sum less precisely, enough
  to flip a ReLU at 0; ROADMAP.md C.20), and at least 1e-6 of the whole
  gradient's norm: the first decoder layer's self-attention reads zeros
  (the decoder starts from them), so its query and key gradients are 0
  but for float32 noise (norm 1.6e-7 against a whole of about 1e2);
* the tails: indices exact, ties included; scores and boxes to float32
  rounding;
* the loss terms of a gradient step: 1e-4 relative (the forward's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    DETR_DIMS,
    DETR_GRAD_GT_SEED,
    DETR_SIZE as SIZE,
    check_detr_gradients,
    detr_gt as _gt,
    detr_pair as _pair,
    jit_o0,
    load_into,
    merged_detr_cfg as _merged,
    numpy_variables,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.layers import rcda as jrcda
from yolov7_d2_tpu.models.layers import transformer as jtr
from yolov7_d2_tpu.models.meta_arch import detr as jd
from yolov7_d2_tpu.models.meta_arch import detr_variants as jdv
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import DetrConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system
from yolov7_d2_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.layers import rcda as trcda
from yolov7_d2_tpu_torch.models.layers import transformer as ttr
from yolov7_d2_tpu_torch.models.meta_arch import detr as td
from yolov7_d2_tpu_torch.models.meta_arch import detr_variants as tdv
from yolov7_d2_tpu_torch.train.optimizer import AdamW
from yolov7_d2_tpu_torch.utils import weight_port as twp

LAYER_TOL = 1e-5
FWD_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
DIMS = {k: v for k, v in DETR_DIMS.items() if k != "dim_feedforward"}


def _close(got, want, tol=FWD_TOL, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


ANCHOR_CASES = [("RCDA", "learned"), ("nn.MultiheadAttention", "grid")]


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """(gradients, losses, outputs) of one train-mode step of the
    AnchorDETR pair (RCDA, learned anchors; focal criterion) on the gts of
    ``DETR_GRAD_GT_SEED``; its outputs equal eval mode's (no dropout,
    FrozenBN), so the forward test takes them from this one compile."""
    jmodel, variables, _, images, _ = _pair("anchor")
    gt = _jnp(_gt(np.random.default_rng(DETR_GRAD_GT_SEED)))

    def loss(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           jnp.asarray(images), train=True)
        losses = jd.detr_losses(out, gt, 3, (SIZE, SIZE), use_focal=True)
        return losses["total_loss"], (losses, out)

    grads, (losses, out) = jit_o0(jax.grad(loss, has_aux=True))(
        variables["params"])
    return jax.tree.map(np.asarray, (grads, losses, out))


@functools.lru_cache(maxsize=None)
def _jax_forward(attention_type, spatial_prior):
    if (attention_type, spatial_prior) == ("RCDA", "learned"):
        return _jax_grads()[2]
    jmodel, variables, _, images, _ = _pair("anchor", attention_type,
                                            spatial_prior)
    return jax.tree.map(np.asarray, jax.jit(jmodel.apply)(
        variables, jnp.asarray(images)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,normalize,centered", [
    (5, 7, True, False), (4, 3, True, True), (6, 2, False, False),
    (1, 9, True, False)])
def test_sine_position_embedding_matches_jax(h, w, normalize, centered):
    want = jtr.sine_position_embedding(h, w, 16, normalize=normalize,
                                       centered=centered)
    got = ttr.sine_position_embedding(h, w, 16, normalize=normalize,
                                      centered=centered)
    assert got.dtype == torch.float32
    _close(got, want, LAYER_TOL)


def test_pos2posemb2d_matches_jax():
    pts = np.random.default_rng(2).random((3, 7, 2)).astype(np.float32)
    _close(trcda.pos2posemb2d(torch.from_numpy(pts), 16),
           jrcda.pos2posemb2d(jnp.asarray(pts), 16), LAYER_TOL)


def _layer_params(jmodel, *args, seed=3):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0),
                                                   *a),
                            *[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map_with_path(
        lambda p, s: rng.normal(0, (s.shape[0] ** -0.5
                                    if p[-1].key == "kernel" else 0.3),
                                s.shape).astype(np.float32)
        if p[-1].key != "scale" else
        rng.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_mlp_matches_jax():
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 16)).astype(np.float32)
    jm = jtr.MLP(24, 4, 3)
    params = _layer_params(jm, x)
    tm = ttr.MLP(16, 24, 4, 3)
    load_into(tm, params, lambda n: tuple(
        n.replace("layers.", "layer_").split(".")))
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(params, jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_encoder_and_decoder_layers_match_jax(pre_norm):
    """One encoder and one decoder layer in eval mode, post- and
    pre-norm: the flax attention's per-head kernels through the port's
    fused in-projection."""
    rng = np.random.default_rng(5)
    src = rng.normal(0, 1, (2, 12, 32)).astype(np.float32)
    pos = rng.normal(0, 1, (2, 12, 32)).astype(np.float32)
    tgt = rng.normal(0, 1, (2, 6, 32)).astype(np.float32)
    qpos = rng.normal(0, 1, (2, 6, 32)).astype(np.float32)
    mapper = functools.partial(twp.map_detr_torch_name)
    jenc = jtr.EncoderLayer(32, 4, 64, pre_norm=pre_norm)
    params = _layer_params(jenc, src, pos)
    tenc = ttr.EncoderLayer(32, 4, 64, pre_norm=pre_norm)
    load_into(tenc, params, mapper)
    jdec = jtr.DecoderLayer(32, 4, 64, pre_norm=pre_norm)
    dparams = _layer_params(jdec, tgt, src, qpos, pos, seed=6)
    tdec = ttr.DecoderLayer(32, 4, 64, pre_norm=pre_norm)
    load_into(tdec, dparams, mapper)
    with torch.no_grad():
        _close(tenc(_t(src), _t(pos)),
               jax.jit(jenc.apply)(params, src, pos), LAYER_TOL, "encoder")
        _close(tdec(_t(tgt), _t(src), _t(qpos), _t(pos)),
               jax.jit(jdec.apply)(dparams, tgt, src, qpos, pos),
               LAYER_TOL, "decoder")


def test_rcda_matches_jax():
    rng = np.random.default_rng(7)
    qr, qc = (rng.normal(0, 1, (2, 9, 32)).astype(np.float32)
              for _ in range(2))
    kr, kc, v = (rng.normal(0, 1, (2, 5, 6, 32)).astype(np.float32)
                 for _ in range(3))
    jm = jrcda.RCDAttention(32, 4)
    params = _layer_params(jm, qr, qc, kr, kc, v)
    tm = trcda.RCDAttention(32, 4)
    load_into(tm, params, lambda n: tuple(n.split(".")))
    with torch.no_grad():
        got = tm(*map(_t, (qr, qc, kr, kc, v)))
    _close(got, jax.jit(jm.apply)(params, qr, qc, kr, kc, v), LAYER_TOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention_type,spatial_prior", ANCHOR_CASES)
def test_anchor_detr_forward_matches_jax(attention_type, spatial_prior):
    """Both encoders and both anchor priors (4 positions: a 2x2 grid)."""
    _, _, tmodel, images, _ = _pair("anchor", attention_type, spatial_prior)
    want = _jax_forward(attention_type, spatial_prior)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    for k in want:
        _close(got[k], want[k], what=k)
    assert got["pred_logits"].shape == (2, 8, 3)


# ---------------------------------------------------------------------------
# the criterion
# ---------------------------------------------------------------------------

def _random_out(rng, levels=3, b=2, q=10, c=4, ties=False):
    """Decoder outputs of ``levels`` levels: logits [L, B, Q, c], boxes
    (sigmoid) in normalized cxcywh. With ``ties``: queries 3-5 copy
    query 2 at every level."""
    logits = rng.normal(0, 2, (levels, b, q, c)).astype(np.float32)
    boxes = 1 / (1 + np.exp(-rng.normal(0, 1, (levels, b, q, 4))))
    boxes = boxes.astype(np.float32)
    if ties:
        logits[:, :, 3:6] = logits[:, :, 2:3]
        boxes[:, :, 3:6] = boxes[:, :, 2:3]
    return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
            "aux_logits": logits[:-1], "aux_boxes": boxes[:-1]}


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("use_focal", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_detr_match_matches_jax(use_focal, ties):
    """Every level's assignment, from one stacked call, against the JAX
    ``detr_match`` of that level alone: random outputs and gts, and built
    ties (copied queries, copied gts)."""
    rng = np.random.default_rng(20 + ties)
    c = 3 if use_focal else 4
    out = _random_out(rng, levels=6, c=c, ties=ties)
    gt = _gt(rng, ties=ties)
    gt_norm = td.normalized_gt_boxes(torch.from_numpy(gt["gt_boxes"]),
                                     (SIZE, SIZE))
    levels = [(out["pred_logits"], out["pred_boxes"])] + [
        (out["aux_logits"][i], out["aux_boxes"][i]) for i in range(5)]
    n = len(levels)
    pred, ok, iters = td.detr_match(
        torch.from_numpy(np.concatenate([lg for lg, _ in levels])),
        torch.from_numpy(np.concatenate([bx for _, bx in levels])),
        gt_norm.repeat(n, 1, 1),
        torch.from_numpy(gt["gt_classes"]).repeat(n, 1),
        torch.from_numpy(gt["gt_valid"]).repeat(n, 1), use_focal=use_focal)
    jmatch = jax.jit(functools.partial(jd.detr_match, use_focal=use_focal))
    for i, (lg, bx) in enumerate(levels):
        jp, jok = jmatch(jnp.asarray(lg), jnp.asarray(bx),
                         jnp.asarray(gt_norm.numpy()),
                         jnp.asarray(gt["gt_classes"]),
                         jnp.asarray(gt["gt_valid"]))
        np.testing.assert_array_equal(pred[2 * i:2 * i + 2].numpy(),
                                      np.asarray(jp), f"level {i}")
        np.testing.assert_array_equal(ok[2 * i:2 * i + 2].numpy(),
                                      np.asarray(jok), f"level {i}")
    assert int(ok.sum()) == n * int(gt["gt_valid"].sum())
    assert int(iters.min()) >= 1


@pytest.mark.parametrize("use_focal", [False, True])
def test_losses_match_jax(use_focal):
    """Every term of ``detr_losses`` (both levels' CE or focal, L1, gIoU,
    cardinality, the total) on the same outputs, deep supervision on."""
    rng = np.random.default_rng(30 + use_focal)
    out = _random_out(rng, levels=3, c=3 if use_focal else 4)
    gt = _gt(rng)
    want = jax.jit(functools.partial(
        jd.detr_losses, num_classes=3, input_hw=(SIZE, SIZE),
        use_focal=use_focal))(_jnp(out), _jnp(gt))
    got = td.detr_losses({k: torch.from_numpy(v) for k, v in out.items()},
                         {k: torch.from_numpy(v) for k, v in gt.items()},
                         3, (SIZE, SIZE), use_focal=use_focal)
    assert set(want) | {"match_iters", "num_matched", "aux0_num_matched",
                        "aux1_num_matched", "num_boxes", "match"} == set(got)
    assert len(want) == 13
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for p in ("", "aux0_", "aux1_"):
        assert float(got[p + "num_matched"]) == gt["gt_valid"].sum()
    assert float(got["num_boxes"]) == gt["gt_valid"].sum()


def test_mask_loss_raises():
    """The mask term needs both ``pred_masks`` and ``gt_masks``, as in the
    JAX criterion: DETR's outputs with a batch's masks give the box terms
    alone (the mask term is ``test_torch_port_detr_segm.py``'s)."""
    out = {k: torch.from_numpy(v) for k, v in _random_out(
        np.random.default_rng(0)).items()}
    batch = {k: torch.from_numpy(v) for k, v in _gt(
        np.random.default_rng(0)).items()}
    plain = td.detr_losses(out, batch, 3, (SIZE, SIZE))
    batch["gt_masks"] = torch.zeros(2, 6, SIZE, SIZE, dtype=torch.uint8)
    got = td.detr_losses(out, batch, 3, (SIZE, SIZE))
    assert "loss_mask_dice" not in got and set(got) == set(plain)
    assert torch.equal(got["total_loss"], plain["total_loss"])


def test_anchor_detr_gradients_match_jax(monkeypatch):
    """One train step's loss terms and parameter gradients of AnchorDETR
    (RCDA, learned anchors, the focal criterion), the port in NCHW
    (module docstring). DETR's, with the softmax CE, are in
    ``test_torch_port_detr_feed.py`` beside the train step they share a
    compile with."""
    jgrads, jlosses, _ = _jax_grads()
    check_detr_gradients("anchor", jgrads, jlosses, monkeypatch,
                         GRAD_TOL, FWD_TOL)


# ---------------------------------------------------------------------------
# the tails
# ---------------------------------------------------------------------------

def test_detr_postprocess_matches_jax():
    rng = np.random.default_rng(50)
    out = _random_out(rng, q=100, c=81)
    out["pred_logits"][0, 10:30] = out["pred_logits"][0, 40]  # tied scores
    out["pred_logits"][1, :, :] = 0.0                       # all tied
    want = jd.detr_postprocess(_jnp(out), (SIZE, 2 * SIZE))
    got = td.detr_postprocess({k: torch.from_numpy(v)
                               for k, v in out.items()}, (SIZE, 2 * SIZE))
    for f in ("classes", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-6, atol=1e-4)
    assert got.boxes.shape == (2, 100, 4)


def test_anchor_detr_postprocess_matches_jax():
    """900 queries x 80 classes: the top 100 of 72,000, with a block of
    tied scores that the cut splits; the boxes gathered at each pick's
    query (index-exact)."""
    rng = np.random.default_rng(51)
    out = _random_out(rng, q=900, c=80)
    lg = out["pred_logits"]
    kth = np.sort(lg.reshape(2, -1), -1)[:, ::-1][:, 90]
    for i in range(2):
        lg[i, 100:120, 7] = kth[i]      # 20 ties around rank 91
    lg[1, 5, 5:9] = lg[1, 5, 4]
    want = jdv.anchor_detr_postprocess(_jnp(out), (SIZE, SIZE))
    got = tdv.anchor_detr_postprocess({k: torch.from_numpy(v)
                                       for k, v in out.items()}, (SIZE, SIZE))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------------------
# the weight carrier, the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("yaml", ["detr_256_6_6_r50.yaml",
                                  "anchordetr_r50.yaml"])
def test_full_width_variables_carry_over(yaml):
    """Every leaf of the JAX builder's full-width variables (shapes by
    ``jax.eval_shape``) lands on exactly one key of the port's model of the
    same yaml (built on the meta device), with its shape: the carrier
    raises on a key without a leaf and on a leaf left over.
    (``anchordetr_origin.yaml`` builds the model of ``anchordetr_r50.yaml``
    at another batch size.)"""
    jcfg = _merged(jax_get_cfg, yaml, **{"SOLVER.AMP.ENABLED": False})
    tcfg = DetrConfig.from_cfg(_merged(get_cfg, yaml))
    jmodel = (jd.build_detr if tcfg.meta_architecture == "Detr"
              else jdv.build_anchor_detr)(jcfg)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 800, 800, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    kw = dict(num_classes=80, hidden_dim=256, nheads=8, enc_layers=6,
              dec_layers=6, dim_feedforward=tcfg.dim_feedforward)
    with torch.device("meta"):
        if tcfg.meta_architecture == "Detr":
            model = td.DETR(num_queries=100, **kw)
        else:
            model = tdv.AnchorDETR(num_query_position=300,
                                   num_query_pattern=3, **kw)
    if tcfg.meta_architecture == "Detr":
        mapper = twp.map_detr_torch_name
    else:
        mapper = functools.partial(twp.map_anchor_detr_torch_name,
                                   attention_type=tcfg.attention_type)
    sd = twp.jax_to_torch_state_dict(variables, model.state_dict(), mapper)
    assert sd.keys() == model.state_dict().keys()
    assert (tcfg.use_focal, tcfg.dim_feedforward) == (
        (False, 2048) if "detr_256" in yaml else (True, 1024))


def test_reference_names_port_through_the_jax_porter():
    """The port's DETR keeps the reference's names: the JAX package's
    ``port_detr_state_dict`` (the reference checkpoint's porter, fused qkv
    split) takes the port's transformer and heads back to the flax
    variables they came from."""
    _, variables, tmodel, _, _ = _pair("detr")
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()
          if not k.startswith("backbone.")}
    zero = jax.tree.map(np.zeros_like, numpy_variables(variables))
    back, report = jwp.port_detr_state_dict(sd, zero, num_heads=4)
    assert not report["unused"]
    flat = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(
            variables["params"]):
        if path[0].key == "backbone":
            continue
        np.testing.assert_allclose(np.asarray(flat[path]), want, rtol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# dropout, builders
# ---------------------------------------------------------------------------

def test_dropout_acts_in_train_mode_only_and_draws_from_the_generator():
    """Eval mode: no dropout and no generator needed. Train mode: the
    masks come from ``model.generator`` (two seeds, two outputs; one seed
    twice, one output; the global RNG untouched) and a model without one
    raises."""
    cfg = DetrConfig(amp=False, input_size=(SIZE, SIZE), num_queries=10,
                     dim_feedforward=64, **DIMS)
    model = build_model(cfg, "cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(70).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    gen = model.generator
    with torch.no_grad():
        model.generator = None
        a = model(x)["pred_logits"]
        assert torch.equal(a, model(x)["pred_logits"])
        model.train()
        with pytest.raises(ValueError, match="Generator"):
            model(x)
        model.generator = gen
        outs = []
        for seed in (1, 2, 1):
            gen.manual_seed(seed)
            state = torch.random.get_rng_state()
            outs.append(model(x)["pred_logits"])
            assert torch.equal(state, torch.random.get_rng_state())
    frozen = [m for m in model.modules() if isinstance(m, FrozenBatchNorm2d)]
    assert frozen and not any(m.training for m in frozen)
    assert torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], a)


def test_train_step_draws_dropout_from_seed_and_step():
    """``build_system``'s DETR step (dropout 0.1) reseeds the dropout
    generator from the seed and the step, as the JAX step folds the step
    into its key: two states at step 5 from equal weights take equal steps
    whatever the generator drew before; at step 6 the masks differ."""
    cfg = DetrConfig(amp=False, input_size=(SIZE, SIZE), num_queries=10,
                     dim_feedforward=64, warmup_iters=0, **DIMS)
    batch = {k: torch.from_numpy(v) for k, v in _gt(
        np.random.default_rng(71)).items()}
    batch["image"] = torch.from_numpy(np.random.default_rng(72).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    losses = []
    for step_no, history in ((5, 1), (5, 2), (6, 1)):
        _, state, step, _ = build_system(cfg, device="cpu", seed=0)
        state.step = step_no
        state.model.generator.manual_seed(history)
        state, m = step(state, batch)
        assert state.step == step_no + 1
        losses.append(float(m["total_loss"]))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("yaml,arch,queries,focal", [
    ("detr_256_6_6_r50.yaml", "Detr", 100, False),
    ("anchordetr_r50.yaml", "AnchorDetr", 900, True),
    ("anchordetr_origin.yaml", "AnchorDetr", 900, True)])
def test_build_system_reads_the_yaml(yaml, arch, queries, focal):
    """``build_system`` on each yaml at full width and 800 px: the model
    (bf16 compute over f32 parameters, train mode, FrozenBN), AdamW with
    the backbone at 0.1 of lr 1e-4, the box fields and the criterion's
    choice; ``build_model`` gives the same weights from the same seed."""
    cfg = _merged(get_cfg, yaml)
    dcfg = DetrConfig.from_cfg(cfg)
    assert (dcfg.meta_architecture, dcfg.input_size, dcfg.use_focal) == (
        arch, (800, 800), focal)
    assert (dcfg.optimizer, dcfg.base_lr, dcfg.backbone_multiplier,
            dcfg.amp, dcfg.ema) == ("adamw", 1e-4, 0.1, True, False)
    model, state, _, fields = build_system(cfg, device="cpu")
    assert model.training and model.dtype == torch.bfloat16
    assert fields == ("image", "gt_boxes", "gt_classes", "gt_valid")
    assert isinstance(state.optimizer, AdamW)
    assert {g["lr_mult"] for g in state.optimizer.param_groups} == {0.1, 1.0}
    assert isinstance(model, td.DETR if arch == "Detr" else tdv.AnchorDETR)
    n_queries = (model.query_embed.weight.shape[0] if arch == "Detr" else
                 model.num_query_position * model.num_query_pattern)
    assert n_queries == queries
    again = build_model(dcfg, "cpu")
    assert not again.training
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("arch,item", [
    ("MaskRCNN", "A.8d"), ("FasterRCNN", "A.8d"), ("PanopticFPN", "A.8d")])
def test_unported_detr_variants_raise(arch, item):
    """The R-CNN family (ported in item A.8d) merged over a DETR yaml
    reads its own config; a DetrConfig naming it raises, naming the
    architecture and the config it takes."""
    from yolov7_d2_tpu_torch.engine import config_from_cfg

    cfg = _merged(get_cfg, "detr_256_6_6_r50.yaml",
                  **{"MODEL.META_ARCHITECTURE": arch})
    got = config_from_cfg(cfg)
    assert type(got).__name__ == "RcnnConfig"
    assert got.meta_architecture == arch
    with pytest.raises(NotImplementedError,
                       match=f"{arch} takes an RcnnConfig"):
        build_model(DetrConfig(meta_architecture=arch), "cpu")


def test_detr_defaults_to_the_card():
    import inspect

    for fn in (td.build_detr, tdv.build_anchor_detr, tdv.build_smca_detr,
               tdv.build_dab_detr, tdv.build_detr_d2go, build_system):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(NotImplementedError, match="DetrConfig"):
        td.build_detr(get_cfg(), "cpu")
    with pytest.raises(NotImplementedError, match="REMAT"):
        build_model(DetrConfig(remat=True), "cpu")
