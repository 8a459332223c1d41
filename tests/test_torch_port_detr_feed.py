"""The port's DETR training path against the JAX package, on the CPU: the
feed (``PadTransform``, ``TransformList`` and ``RandomCrop``, each crop type
draw for draw at one seed; ``DetrDatasetMapper``, samples equal for the
same seed with the crop branch on and off, both with the cv2 letterbox),
the tiny DETR's forward, gradients and one AdamW train step against the
JAX ``make_train_step`` (one compile for the three), the optimizer's
parameter groups against the JAX optimizer's, and
``train_transformer`` at a tiny size: 3 steps, ``--resume`` to 6, and the
refusals (no card without ``MODEL.DEVICE cpu``, ``--num-gpus 2``). The feed
comparisons are exact. The model's tolerances, each with its reason:

* forward: 1e-4 of each output's largest magnitude (XLA-CPU and oneDNN sum
  each convolution in another order; measured about 1e-6);
* gradients: as in ``test_torch_port_detr.py`` (1e-4 of each tensor's
  norm, at least 1e-6 of the whole's; NCHW), the JAX gradients read from
  the train step's first Adam moment over 1 - b1 (one float32 rounding);
* the AdamW step: the loss terms and the gradient norm within 1e-4
  relative; every parameter within 1e-5 of the larger of its magnitude and
  10 lr (an Adam step's size). Adam's first step is lr g / (|g| + 1e-8),
  nearly the sign of g: an element whose gradient lies within the
  gradient tolerance of 0 (so that its sign is not held) may step the
  other way, within 2 lr, and at most 1e-3 of the elements do (2,383 of
  23.6 M measured: the 2,048 query and key weights of the first decoder
  self-attention, whose gradient is 0 in exact arithmetic, and 335 of the
  backbone's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    DETR_DIR,
    DETR_GRAD_GT_SEED,
    DETR_SIZE,
    DETR_TINY_OPTS,
    assert_batches_equal,
    check_detr_gradients,
    detr_gt,
    detr_pair,
    jit_o0,
    load_into,
    merged_detr_cfg,
    opts_list,
    write_mini_coco,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.data import mappers as jax_mappers
from yolov7_d2_tpu.data.transforms import api as jax_api
from yolov7_d2_tpu_torch.config import DetrConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data import coco, mappers
from yolov7_d2_tpu_torch.data.loader import stack_uint8_batch
from yolov7_d2_tpu_torch.data.transforms import api
from yolov7_d2_tpu_torch.engine import build_system
from yolov7_d2_tpu_torch.models.meta_arch import detr as td
from yolov7_d2_tpu_torch.train.optimizer import AdamW
from yolov7_d2_tpu_torch.utils import weight_port as twp

FWD_TOL = 1e-4
GRAD_TOL = 1e-4

DETR_YAML = str(DETR_DIR / "detr_256_6_6_r50.yaml")
# the tiny DETR of the port's tests at 64 px, 2 classes, f32, one thread
TINY = {
    "MODEL.DETR.NUM_CLASSES": 2, "MODEL.DETR.HIDDEN_DIM": 32,
    "MODEL.DETR.NHEADS": 4, "MODEL.DETR.ENC_LAYERS": 2,
    "MODEL.DETR.DEC_LAYERS": 2, "MODEL.DETR.DIM_FEEDFORWARD": 64,
    "MODEL.DETR.NUM_OBJECT_QUERIES": 10,
    "MODEL.YOLO.MAX_BOXES_NUM": 8,
    "INPUT.INPUT_SIZE": [64, 64],
    "INPUT.MIN_SIZE_TRAIN": [48, 56, 64],
    "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64,
    "INPUT.MAX_SIZE_TEST": 128,
    "SOLVER.IMS_PER_BATCH": 2,
    "SOLVER.AMP.ENABLED": False,
    "DATALOADER.NUM_WORKERS": 1,
}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    js, root = write_mini_coco(tmp_path_factory.mktemp("detr"), n=8)
    return js, root, coco.load_coco_json(js, root, "port_detr_records")


def _cfgs(**extra):
    return [merged_detr_cfg(fn, "detr_256_6_6_r50.yaml", **TINY, **extra)
            for fn in (get_cfg, jax_get_cfg)]


def test_pad_and_transform_list_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
    mask = (rng.random((23, 31)) > 0.5).astype(np.uint8)
    boxes = np.array([[2.0, 3.0, 20.0, 15.0], [10.0, 1.0, 30.0, 22.0]],
                     np.float32)
    pairs = [
        (api.PadTransform(40, 36), jax_api.PadTransform(40, 36)),
        (api.PadTransform(30, 50, fill=7), jax_api.PadTransform(30, 50, 7)),
        (api.TransformList([api.HFlipTransform(31),
                            api.ResizeTransform(23, 31, 40, 17),
                            api.CropTransform(3, 4, 12, 11),
                            api.PadTransform(16, 20)]),
         jax_api.TransformList([jax_api.HFlipTransform(31),
                                jax_api.ResizeTransform(23, 31, 40, 17),
                                jax_api.CropTransform(3, 4, 12, 11),
                                jax_api.PadTransform(16, 20)])),
    ]
    for ours, theirs in pairs:
        for fn in ("apply_image", "apply_segmentation"):
            x = img if fn == "apply_image" else mask
            got, want = getattr(ours, fn)(x), getattr(theirs, fn)(x)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, fn)
        np.testing.assert_array_equal(ours.apply_box(boxes),
                                      theirs.apply_box(boxes))
        np.testing.assert_array_equal(
            ours.apply_coords(boxes.reshape(-1, 2)),
            theirs.apply_coords(boxes.reshape(-1, 2)))


@pytest.mark.parametrize("crop_type,size", [
    ("relative_range", (0.5, 0.7)), ("relative", (0.6, 0.9)),
    ("absolute", (30, 200))])
def test_random_crop_matches_jax(crop_type, size):
    """Twenty draws from one seed on images of several shapes: the same
    windows, then the same crop of image and boxes."""
    ours, theirs = api.RandomCrop(crop_type, size), \
        jax_api.RandomCrop(crop_type, size)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    img_rng = np.random.default_rng(4)
    boxes = np.array([[5.0, 5.0, 40.0, 30.0]], np.float32)
    for i in range(20):
        img = img_rng.integers(0, 256, (40 + 3 * i, 90 - 2 * i, 3)).astype(
            np.uint8)
        a, b = ours.get_transform(img, r1), theirs.get_transform(img, r2)
        assert (a.x0, a.y0, a.w, a.h) == (b.x0, b.y0, b.w, b.h)
        np.testing.assert_array_equal(a.apply_image(img), b.apply_image(img))
        np.testing.assert_array_equal(a.apply_box(boxes), b.apply_box(boxes))


@pytest.mark.parametrize("crop", [False, True])
def test_detr_mapper_matches_jax(mini, monkeypatch, crop):
    """Samples of the training mapper (flip, the short-edge choice, with
    ``crop`` the 50% branch: resize to 400-600, ``RandomCrop``
    relative_range 0.6) and of the eval mapper, equal for one seed over
    the records twice, cv2 letterbox on both sides."""
    _, _, records = mini
    monkeypatch.setattr(mappers, "_NATIVE", False)
    monkeypatch.setattr(jax_mappers, "_NATIVE", False)
    ours_cfg, jax_cfg = _cfgs(**{"INPUT.CROP.ENABLED": crop,
                                 "INPUT.CROP.SIZE": [0.6, 0.6]})
    for train in (True, False):
        ours = mappers.DetrDatasetMapper(ours_cfg, is_train=train, seed=5)
        theirs = jax_mappers.DetrDatasetMapper(jax_cfg, is_train=train,
                                               seed=5)
        assert (ours.crop_gen is None) == (theirs.crop_gen is None) == (
            not (crop and train))
        cropped = 0
        for r in records * 2:
            got, want = ours(r), theirs(r)
            assert sorted(got) == sorted(want)
            assert_batches_equal(got, want)
            assert got["image"].shape == (64, 64, 3)
            cropped += len(ours.augmentations) == 4
        assert (cropped > 0) == (crop and train)
    batch = stack_uint8_batch([got, want])
    assert batch["image"].dtype == np.uint8


# ---------------------------------------------------------------------------
# the model's forward, gradients and one AdamW step against the JAX step
# ---------------------------------------------------------------------------

# both packages' options of the step: the tiny DETR at dropout 0, lr 1e-3
# with no warmup, the backbone at 0.1 of it
STEP_OPTS = dict(DETR_TINY_OPTS, **{"MODEL.DETR.DROPOUT": 0.0,
                                    "SOLVER.BASE_LR": 1e-3,
                                    "SOLVER.WARMUP_ITERS": 0,
                                    "SOLVER.WEIGHT_DECAY": 1e-2})


@functools.lru_cache(maxsize=None)
def _jax_train_step():
    """One step of the JAX ``make_train_step`` over ``build_optimizer``'s
    AdamW on the tiny DETR (softmax CE) and the gts of
    ``DETR_GRAD_GT_SEED``: (the new state, the outputs, the metrics, the
    gradients). The loss returns the outputs too, so that they come back
    among the metrics (train mode at dropout 0 with FrozenBN is eval
    mode); the gradients are the first Adam moment over 1 - b1, its one
    update from zero."""
    from yolov7_d2_tpu.models.meta_arch import detr as jd
    from yolov7_d2_tpu.train.optimizer import build_optimizer as jax_opt
    from yolov7_d2_tpu.train.train_state import TrainState, make_train_step

    jcfg = merged_detr_cfg(jax_get_cfg, "detr_256_6_6_r50.yaml",
                           **STEP_OPTS)
    jmodel, variables, _, images, _ = detr_pair("detr")
    gt = {k: jnp.asarray(v) for k, v in detr_gt(
        np.random.default_rng(DETR_GRAD_GT_SEED)).items()}
    tx = jax_opt(jcfg, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))

    def loss_fn(out, batch, use_l1):
        losses = jd.detr_losses(out, batch, 3, (DETR_SIZE, DETR_SIZE))
        return dict(losses, **{"out/" + k: v for k, v in out.items()})

    state, metrics = jit_o0(make_train_step(jmodel, loss_fn, tx))(
        state, dict(gt, image=jnp.asarray(images)))
    metrics = jax.tree.map(np.asarray, metrics)
    out = {k[4:]: metrics.pop(k) for k in list(metrics)
           if k.startswith("out/")}
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu"))
    grads = jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), adam.mu)
    return jax.tree.map(np.asarray, state), out, metrics, grads


def test_detr_forward_matches_jax():
    """DETR in eval mode, float and uint8 input."""
    _, _, tmodel, images, _ = detr_pair("detr")
    want = _jax_train_step()[1]
    with torch.no_grad():
        for x in (images, images.astype(np.uint8)):
            got = tmodel(torch.from_numpy(x))
            for k in want:
                w = np.asarray(want[k], np.float64)
                err = float(np.abs(got[k].numpy() - w).max())
                assert err <= FWD_TOL * max(1.0, float(np.abs(w).max())), k
    assert got["pred_logits"].shape == (2, 10, 4)
    assert got["aux_boxes"].shape == (1, 2, 10, 4)


def test_detr_gradients_match_jax(monkeypatch):
    """One train step's loss terms and parameter gradients of DETR with
    the softmax CE criterion at dropout 0, the port in NCHW."""
    _, _, metrics, jgrads = _jax_train_step()
    jlosses = {k: v for k, v in metrics.items() if k != "grad_norm"}
    check_detr_gradients("detr", jgrads, jlosses, monkeypatch, GRAD_TOL,
                         FWD_TOL)


def test_adamw_train_step_matches_jax(monkeypatch):
    """One train step of ``build_system`` (AdamW, lr 1e-3 with no warmup,
    the backbone at 0.1 of it, dropout 0) against the JAX
    ``make_train_step`` over ``build_optimizer``'s chain, from equal
    weights: the loss terms, the gradient norm and every parameter after
    the update (the module docstring's tolerances)."""
    cfg = merged_detr_cfg(get_cfg, "detr_256_6_6_r50.yaml", **STEP_OPTS,
                          **{"MODEL.DEVICE": "cpu"})
    _, variables, _, images, mapper = detr_pair("detr")
    model, state, step, fields = build_system(cfg, device="cpu")
    load_into(model, variables, mapper)
    plain = td.normalize_images_plain
    monkeypatch.setattr(td, "normalize_images_plain",
                        lambda *a: plain(*a).contiguous())
    model.to(memory_format=torch.contiguous_format)
    jstate, _, jm, _ = _jax_train_step()
    batch = {k: torch.from_numpy(v) for k, v in detr_gt(
        np.random.default_rng(DETR_GRAD_GT_SEED)).items()}
    batch["image"] = torch.from_numpy(images.astype(np.uint8))
    state, m = step(state, batch)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=FWD_TOL,
                                   err_msg=k)
    assert isinstance(state.optimizer, AdamW) and fields[0] == "image"
    got = twp.jax_to_torch_state_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        model.state_dict(), mapper)
    start = twp.jax_to_torch_state_dict(
        {k: jax.tree.map(np.asarray, v) for k, v in variables.items()},
        model.state_dict(), mapper)
    whole = float(m["grad_norm"])
    moved = exempt = total = 0
    for name, p in model.named_parameters():
        want = got[name]
        scale = max(float(np.abs(want).max()), 10 * 1e-3)
        err = np.abs(p.detach().numpy() - want)
        g = np.abs(p.grad.numpy())
        # Adam's first step is lr g / (|g| + 1e-8): where g is within the
        # gradient tolerance of 0, its sign is not fixed by it
        noise = g <= GRAD_TOL * max(float(np.linalg.norm(g)), 1e-2 * whole)
        close = err <= 1e-5 * scale
        assert (close | (noise & (err <= 2 * 1e-3))).all(), (
            name, float(err.max()), scale)
        exempt += int((~close).sum())
        total += err.size
        moved += not np.array_equal(start[name], want)
    assert exempt <= 1e-3 * total, (exempt, total)
    assert moved == len(list(model.parameters()))


@pytest.mark.parametrize("kind", ["detr", "anchor"])
def test_optimizer_groups_match_jax(kind):
    """Each parameter's weight-decay class and learning-rate multiplier
    equal the JAX optimizer's for its flax path, with BIAS_LR_FACTOR 2
    (the fused ``in_proj_bias`` is a bias) and BACKBONE_MULTIPLIER 0.1."""
    from yolov7_d2_tpu.train import optimizer as jopt
    from yolov7_d2_tpu_torch.train.optimizer import param_groups

    opts = dict(DETR_TINY_OPTS, **{"SOLVER.BIAS_LR_FACTOR": 2.0})
    yaml = "detr_256_6_6_r50.yaml" if kind == "detr" else \
        "anchordetr_r50.yaml"
    jcfg = merged_detr_cfg(jax_get_cfg, yaml, **opts)
    tcfg = DetrConfig.from_cfg(merged_detr_cfg(get_cfg, yaml, **opts))
    _, _, tmodel, _, mapper = detr_pair(kind)
    groups = {id(p): g for g in param_groups(tmodel, tcfg)
              for p in g["params"]}
    seen = set()
    for name, p in tmodel.named_parameters():
        module, _, leaf = name.rpartition(".")
        path = mapper(module) if module else ()
        flax = {"weight": (path + ("kernel",) if "norm" not in module
                           else path + ("scale",)),
                "bias": path + ("bias",),
                "in_proj_weight": path + ("query", "kernel"),
                "in_proj_bias": path + ("query", "bias")}.get(
            leaf, path + (leaf,))
        if module.endswith("query_embed"):
            flax = path
        fpath = "/".join(flax)
        g = groups[id(p)]
        assert g["decay_class"] == jopt.param_decay_class(fpath), name
        assert g["lr_mult"] == jopt._lr_multiplier(fpath, jcfg), name
        seen.add((g["decay_class"], g["lr_mult"]))
    assert {("weight", 0.1), ("norm", 0.1), ("weight", 1.0), ("bias", 2.0),
            ("norm", 1.0)} <= seen


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_transformer_on_the_cpu(mini, tmp_path, monkeypatch):
    """``train_transformer`` on the mini-COCO at 64 px (full-depth
    ResNet-50, the tiny transformer, dropout 0.1, the crop branch on): 3
    steps with a checkpoint at each, finite losses at both levels and the
    matched count of the valid gts; ``--resume`` to 6; without
    ``MODEL.DEVICE cpu`` it wants a card; ``--num-gpus 2`` on the cards
    with fewer than 2 visible raises (the gloo ranks on the CPU are
    ``tests/test_torch_port_dist_families.py``'s)."""
    from yolov7_d2_tpu_torch import train_transformer
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.models.meta_arch.detr import DETR
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    js, root, _ = mini
    register_coco_instances("detr_cli_mini", {}, js, root)
    try:
        opts = dict(TINY, **{
            "MODEL.DEVICE": "cpu", "SOLVER.MAX_ITER": 3,
            "SOLVER.CHECKPOINT_PERIOD": 1, "INPUT.CROP.ENABLED": True,
            "DATASETS.TRAIN": "('detr_cli_mini',)",
            "OUTPUT_DIR": str(tmp_path / "out")})

        def args(*flags, **more):
            argv = ["--config-file", DETR_YAML, *flags] + opts_list(
                dict(opts, **more))
            return default_argument_parser().parse_args(argv)

        trainer = train_transformer.main(args())
        assert isinstance(trainer.state.model, DETR)
        last = trainer.storage.latest()
        for k in ("loss_ce", "loss_bbox", "loss_giou", "aux0_loss_ce",
                  "aux0_loss_bbox", "aux0_loss_giou", "total_loss",
                  "grad_norm"):
            assert np.isfinite(last[k]), k
        assert last["num_matched"] == last["aux0_num_matched"] >= 1
        assert last["match_iters"] >= 1
        ckpts = sorted(p.name for p in (tmp_path / "out" / "ckpt").iterdir())
        assert ckpts == [f"ckpt_0000000{i}.pt" for i in (1, 2, 3)]
        again = train_transformer.main(args("--resume",
                                            **{"SOLVER.MAX_ITER": 6}))
        assert again.start_iter == 3 and again.state.step == 6
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "device_count", lambda: 1)
            with pytest.raises(RuntimeError, match="--num-gpus 2"):
                train_transformer.main(args("--num-gpus", "2",
                                            **{"MODEL.DEVICE": "cuda"}))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="MODEL.DEVICE cpu"):
                train_transformer.main(args(**{"MODEL.DEVICE": "cuda"}))
    finally:
        DatasetCatalog.remove("detr_cli_mini")
