"""The port's DETRsegm (``models/meta_arch/detr_seg.py``) and the mask term
of ``detr_losses`` against the JAX package, in float32 on the CPU.

* ``MHAttentionMap`` and ``MaskHeadSmallConv`` on random inputs;
* the whole model at a tiny size (a ResNet of one bottleneck a stage in
  both packages, hidden 32, 4 heads, 2 + 2 layers, 10 queries, 64 px):
  the class, box and mask outputs of the uint8 path;
* ``detr_losses`` with ``pred_masks`` and ``gt_masks`` (the dice and focal
  terms of the last level's matched queries, and every other term), and
  without ``pred_masks`` (no mask term); ``postprocess_segm`` and
  ``postprocess_panoptic``;
* the weight carrier both ways through the JAX ``port_detr_state_dict``
  (the reference's fused attention) and the name map on every key;
* ``detr_256_6_6_torchvision_mask.yaml``: what ``DetrConfig`` reads for
  DetrSegm, every parameter and BN statistic of the full model on a leaf
  of the JAX init's (``jax.eval_shape``), the same counts; one
  ``build_system`` step (with ``gt_masks``) against the JAX step's loss
  and gradient (one JAX compile, shared with the forward test); two
  ``train_transformer`` steps on a mini-COCO (the CLI's mapper gives no
  masks, so no mask term trains, as in the JAX script).

Tolerances: layers 1e-5 of each output's largest magnitude, the whole
model 1e-4 (XLA-CPU and oneDNN sum convolutions in another order); loss
terms 1e-5 relative on the same outputs, 1e-4 through a model; the
gradient norm of a step 1e-3 relative; the tails and the carrier exact.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    DETR_SIZE as SIZE,
    REPO,
    assert_leaves_match_jax,
    detr_gt,
    detr_variables_like,
    jit_o0,
    load_into,
    merged_detr_cfg,
    numpy_variables,
    opts_list,
    write_mini_coco,
)
from yolov7_d2_tpu import engine as jax_engine
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.backbones import resnet as jresnet
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import detr as jd
from yolov7_d2_tpu.models.meta_arch import detr_seg as jds
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch import engine
from yolov7_d2_tpu_torch.config import DetrConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.models.backbones import resnet as tresnet
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import detr as td
from yolov7_d2_tpu_torch.models.meta_arch import detr_seg as tds
from yolov7_d2_tpu_torch.utils import weight_port as twp

LAYER_TOL = 1e-5
FWD_TOL = 1e-4
LOSS_RTOL = 1e-5
YAML = "detr_256_6_6_torchvision_mask.yaml"
CUT_DEPTH, CUT_BLOCKS = 10, (1, 1, 1, 1)
DIMS = dict(num_classes=3, hidden_dim=32, num_queries=10, nheads=4,
            enc_layers=2, dec_layers=2, resnet_depth=CUT_DEPTH)
TINY = {"MODEL.DETR.NUM_CLASSES": 3, "MODEL.DETR.HIDDEN_DIM": 32,
        "MODEL.DETR.NHEADS": 4, "MODEL.DETR.ENC_LAYERS": 2,
        "MODEL.DETR.DEC_LAYERS": 2, "MODEL.DETR.NUM_OBJECT_QUERIES": 10,
        "INPUT.INPUT_SIZE": [SIZE, SIZE], "SOLVER.AMP.ENABLED": False}


@pytest.fixture(autouse=True, scope="module")
def _cut_resnet():
    """One bottleneck a stage in both packages: the JAX compiles cost the
    file's time."""
    with pytest.MonkeyPatch.context() as mp:
        for blocks in (jresnet.STAGE_BLOCKS, tresnet.STAGE_BLOCKS):
            mp.setitem(blocks, CUT_DEPTH, CUT_BLOCKS)
        yield


def _close(got, want, tol=FWD_TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _masks(rng, gt, size=SIZE):
    """Each valid gt box filled, a notch cut out."""
    b, g = gt["gt_valid"].shape
    masks = np.zeros((b, g, size, size), np.uint8)
    for i in range(b):
        for j in np.flatnonzero(gt["gt_valid"][i]):
            x0, y0, x1, y1 = np.round(gt["gt_boxes"][i, j]).astype(int)
            masks[i, j, y0:y1, x0:x1] = 1
            masks[i, j, y0:(y0 + y1) // 2, x0:(x0 + x1) // 2] = 0
    return masks


def test_attention_map_and_mask_head_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
    mem = rng.normal(0, 1, (2, 4, 3, 32)).astype(np.float32)
    jm = jds.MHAttentionMap(32, 4)
    shapes = jax.eval_shape(lambda a, b: jm.init(jax.random.PRNGKey(0), a, b),
                            jnp.zeros(q.shape), jnp.zeros(mem.shape))
    v = jax.tree.map(lambda s: rng.normal(0, 0.3, s.shape).astype(
        np.float32), shapes)
    tm = load_into(tds.MHAttentionMap(32, 4), v,
                   lambda n: tuple(n.split(".")))
    want = jm.apply(v, jnp.asarray(q), jnp.asarray(mem))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(mem))
    _close(got.numpy(), want, LAYER_TOL)
    np.testing.assert_allclose(got.sum((-2, -1)).numpy(), 1.0, rtol=1e-5)

    head = jds.MaskHeadSmallConv(32, 4)
    attn = np.array(want)
    shapes = jax.eval_shape(lambda a, b: head.init(jax.random.PRNGKey(0), a,
                                                   b),
                            jnp.zeros(mem.shape), jnp.zeros(attn.shape))
    hv = jax.tree.map(lambda s: rng.normal(0, 0.3, s.shape).astype(
        np.float32), shapes)
    thead = load_into(tds.MaskHeadSmallConv(32, 4), hv,
                      lambda n: tuple(n.split(".")))
    want = head.apply(hv, jnp.asarray(mem), jnp.asarray(attn))
    with torch.no_grad():
        got = thead(torch.from_numpy(mem), torch.from_numpy(attn))
    assert got.shape == (2, 5, 16, 12)
    _close(got.numpy(), want, LAYER_TOL)


@functools.lru_cache(maxsize=None)
def _pair():
    """(flax DETRsegm, variables, port DETRsegm with them, images, a batch
    with masks, and the JAX outputs, losses and parameter gradients of one
    compile: ``detr_losses`` as the JAX ``build_system`` wires it, softmax
    CE, deep supervision, no-object weight 0.1)."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = jds.DETRsegm(**DIMS)
    variables = detr_variables_like(jm, images.shape, rng)
    tm = load_into(tds.DETRsegm(**DIMS), variables,
                   twp.map_detr_segm_torch_name)
    gt = detr_gt(rng)
    gt["gt_masks"] = _masks(rng, gt)

    @jit_o0
    def jfn(params, x, gt):
        def total(params):
            out = jm.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=True)
            losses = jd.detr_losses(out, gt, 3, (SIZE, SIZE))
            return losses["total_loss"], (out, losses)

        (_, aux), grads = jax.value_and_grad(total, has_aux=True)(params)
        return aux, grads

    (out, losses), grads = jfn(variables["params"], jnp.asarray(images),
                               {k: jnp.asarray(v) for k, v in gt.items()})
    return jm, variables, tm, images, gt, out, losses, grads


def test_model_matches_jax():
    """The uint8 path's outputs (no dropout: the JAX train-mode outputs of
    :func:`_pair`'s compile are the eval ones)."""
    _, _, tm, images, _, want, _, _ = _pair()
    with torch.no_grad():
        got = tm(torch.from_numpy(images.astype(np.uint8)))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], what=k)
    assert got["pred_masks"].shape == (2, 10, SIZE // 8, SIZE // 8)


def _random_out(rng, levels=3, b=2, q=10, c=4, hm=SIZE // 8):
    logits = rng.normal(0, 1.5, (levels, b, q, c)).astype(np.float32)
    cxcy = rng.uniform(0.2, 0.8, (levels, b, q, 2))
    wh = rng.uniform(0.05, 0.4, (levels, b, q, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
            "aux_logits": logits[:-1], "aux_boxes": boxes[:-1],
            "pred_masks": rng.normal(0, 2, (b, q, hm, hm)).astype(
                np.float32)}


@pytest.mark.parametrize("use_focal", [False, True])
def test_mask_term_of_the_losses_matches_jax(use_focal):
    """``detr_losses`` with masks (the gts' masks at 64 px, the predictions
    at 8 x 8): every term, the two mask terms among them; without
    ``pred_masks`` the same terms but the mask ones."""
    rng = np.random.default_rng(2 + use_focal)
    out = _random_out(rng, c=3 if use_focal else 4)
    gt = detr_gt(rng)
    gt["gt_masks"] = _masks(rng, gt)
    want = jax.jit(functools.partial(
        jd.detr_losses, num_classes=3, input_hw=(SIZE, SIZE),
        use_focal=use_focal))({k: jnp.asarray(v) for k, v in out.items()},
                              {k: jnp.asarray(v) for k, v in gt.items()})
    tout = {k: torch.from_numpy(v) for k, v in out.items()}
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    got = td.detr_losses(tout, tgt, 3, (SIZE, SIZE), use_focal=use_focal)
    assert {"loss_mask_dice", "loss_mask_focal"} <= set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    tout.pop("pred_masks")
    plain = td.detr_losses(tout, tgt, 3, (SIZE, SIZE), use_focal=use_focal)
    assert "loss_mask_dice" not in plain
    np.testing.assert_allclose(
        float(plain["total_loss"]),
        float(got["total_loss"] - got["loss_mask_dice"]
              - got["loss_mask_focal"]), rtol=1e-6)


def test_tails_match_jax():
    rng = np.random.default_rng(4)
    out = _random_out(rng)
    out["pred_logits"][0, :3, 0] = 6.0                # kept queries
    jout = {k: jnp.asarray(v) for k, v in out.items()}
    tout = {k: torch.from_numpy(v) for k, v in out.items()}
    np.testing.assert_array_equal(tds.postprocess_segm(tout).numpy(),
                                  np.asarray(jds.postprocess_segm(jout)))
    seg, keep = tds.postprocess_panoptic(tout, 3)
    jseg, jkeep = jds.postprocess_panoptic(jout, 3)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    assert int(keep.sum()) >= 3


def test_weight_carrier_both_ways_and_the_name_map():
    """The port's keys through the JAX ``port_detr_state_dict`` (fused
    attention split; the heads by their flax names) back to the flax
    variables they came from, the backbone through the JAX detectron2
    map; the port's map against the JAX maps on every key."""
    _, variables, tm, _, _, _, _, _ = _pair()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    zero = jax.tree.map(np.zeros_like, numpy_variables(variables))
    head = {k: v for k, v in sd.items() if not k.startswith("backbone.")}
    back, report = jwp.port_detr_state_dict(head, zero, num_heads=4)
    assert not report["unused"]
    backbone = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    back_bb, report = jwp.port_torch_state_dict(
        backbone, zero, name_mapper=jwp.map_d2_resnet_name)
    assert not report["unused"]
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_bb = dict(jax.tree_util.tree_leaves_with_path(back_bb))
    for path, want in jax.tree_util.tree_leaves_with_path(
            numpy_variables(variables)):
        got = (flat_bb if path[1].key == "backbone" else flat)[path]
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    for m in {k.rpartition(".")[0] for k in sd}:
        want = (tuple(m.split(".")) if m.startswith(("bbox_attention.",
                                                      "mask_head."))
                else twp.map_detr_torch_name(m))
        assert twp.map_detr_segm_torch_name(m) == want, m


def test_yaml_config_and_leaves_match_jax(monkeypatch):
    """``DetrConfig`` of the yaml names DetrSegm (``FROZEN_WEIGHTS`` read
    nowhere, ROADMAP.md C.37); every key of the full model on a leaf of the
    JAX model's init, the same counts."""
    cfg = merged_detr_cfg(get_cfg, YAML)
    dcfg = DetrConfig.from_cfg(cfg)
    assert dcfg.meta_architecture == "DetrSegm"
    assert cfg.MODEL.DETR.FROZEN_WEIGHTS
    monkeypatch.setattr(td, "init_detr_weights_", lambda *a: None)
    model = build_model(dcfg, "cpu")
    assert model.transformer.encoder.layers[0].linear1.out_features == 2048
    count = assert_leaves_match_jax(
        model, jax_build_model(merged_detr_cfg(jax_get_cfg, YAML)),
        twp.map_detr_segm_torch_name, size=SIZE)
    assert count["params"] > 4e7 and count["batch_stats"] > 0


def test_build_system_step_matches_jax(monkeypatch):
    """One step of the port's ``build_system`` on the yaml (tiny dims, 64
    px, float32, AdamW) against the JAX ``build_system``'s: both build the
    tiny model of :func:`_pair` (a fresh port model holding its weights)
    and give the same batch fields; every loss term of the step (the mask
    terms on the batch's ``gt_masks``) and its gradient norm against the
    loss and gradient of the JAX step's computation (:func:`_pair`)."""
    jm, init, _, images, gt, _, jlosses, jgrads = _pair()
    tm = load_into(tds.DETRsegm(**DIMS), init, twp.map_detr_segm_torch_name)
    opts = dict(TINY, **{"SOLVER.WARMUP_ITERS": 0})
    jcfg = merged_detr_cfg(jax_get_cfg, YAML, **opts)
    cfg = merged_detr_cfg(get_cfg, YAML, **opts)
    monkeypatch.setattr(jax_engine, "build_model", lambda c: jm)
    make_state = jax_engine._make_state
    monkeypatch.setattr(
        jax_engine, "_make_state", lambda model, *a: make_state(
            types.SimpleNamespace(init=lambda *_, **__: init), *a))
    monkeypatch.setattr(engine, "build_model", lambda c, device, seed: tm)
    _, _, _, jfields = jax_engine.build_system(jcfg, jax.random.PRNGKey(0), 2)
    model, state, step, fields = engine.build_system(cfg, device="cpu")
    assert fields == jfields == ("image", "gt_boxes", "gt_classes",
                                 "gt_valid", "gt_masks")
    batch = dict(gt, image=images)
    plain = td.normalize_images_plain
    monkeypatch.setattr(td, "normalize_images_plain",
                        lambda *a: plain(*a).contiguous())
    _, tm_ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert {"loss_mask_dice", "loss_mask_focal"} <= set(jlosses)
    for k in jlosses:
        if "loss" in k:
            np.testing.assert_allclose(float(tm_[k]), float(jlosses[k]),
                                       rtol=FWD_TOL, err_msg=k)
    np.testing.assert_allclose(
        float(tm_["grad_norm"]),
        float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                          for g in jax.tree_util.tree_leaves(jgrads)))),
        rtol=1e-3)


def test_train_transformer_takes_detr_segm(tmp_path):
    """``train_transformer`` on the yaml (tiny dims, 64 px) and a
    mini-COCO: two steps of DETRsegm, finite box losses, no mask term."""
    from yolov7_d2_tpu_torch import train_transformer
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    js_path, root = write_mini_coco(tmp_path, n=4)
    register_coco_instances("detr_segm_mini", {}, js_path, root)
    try:
        opts = dict(TINY, **{
            "MODEL.DEVICE": "cpu", "MODEL.RESNETS.DEPTH": CUT_DEPTH,
            "SOLVER.MAX_ITER": 2, "SOLVER.IMS_PER_BATCH": 2,
            "SOLVER.CHECKPOINT_PERIOD": 2, "DATALOADER.NUM_WORKERS": 1,
            "INPUT.MIN_SIZE_TRAIN": [SIZE], "INPUT.MAX_SIZE_TRAIN": SIZE,
            "DATASETS.TRAIN": "('detr_segm_mini',)",
            "OUTPUT_DIR": str(tmp_path / "out")})
        argv = ["--config-file",
                str(REPO / "configs" / "coco" / "detr" / YAML)] + opts_list(
                    opts)
        trainer = train_transformer.main(
            default_argument_parser().parse_args(argv))
    finally:
        DatasetCatalog.remove("detr_segm_mini")
    assert isinstance(trainer.state.model, tds.DETRsegm)
    last = trainer.storage.latest()
    for k in ("loss_ce", "loss_bbox", "loss_giou", "total_loss",
              "grad_norm"):
        assert np.isfinite(last[k]), k
    assert "loss_mask_dice" not in last
