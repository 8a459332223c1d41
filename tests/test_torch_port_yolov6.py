"""The port's YOLOv6 against the JAX package, in float32 on the CPU at
width 0.25, depth 0.33, 64 px and 4 classes: the RepVGG block (three
branches, train-mode statistics), EfficientRep, RepPAN and EffiDeHead
inside one eval forward, a train-mode pass (BatchNorm statistics, every
loss term, the parameter gradients), the loss terms and SimOTA's
assignment on the same head outputs, serving through ``yolox_postprocess``
index for index, the weight carrier both ways, and the builders of
``yolov6_s.yaml``, ``yolov6_tiny.yaml`` and ``yolov6_m.yaml`` at full
depth.

Weights: flax variables drawn with numpy (``flax_variables_like``, random
BatchNorm statistics and affine parameters), moved into the port by
``jax_to_torch_state_dict`` through ``map_yolov6_torch_name``. Each JAX
function is compiled once.

Tolerances, each with its reason:

* forward and intermediate features: 1e-4 of each tensor's largest
  magnitude (XLA-CPU and oneDNN sum each convolution in another order);
* a train-mode pass (at depth 0.1, see the test): loss terms 1e-4
  relative and BatchNorm statistics 1e-4 of each tensor's largest
  magnitude, the forward's; measured, the train-mode head outputs of the
  two packages are 2.8e-5 of their largest magnitude apart (the port's
  5.4e-6 and the JAX package's 2.7e-5 from a float64 run of the port; at
  depth 0.33 batch statistics over 2 images of 2x2 cells carry that to
  3.6e-4);
* loss terms on the same head outputs: 1e-5 relative, the assignment
  exact;
* gradients: the port's float32 gradient against a float64 run of the
  port, 1e-3 of the whole gradient's norm and of each tensor's (measured
  2.1e-5 and 2.7e-5; ReLU kinks: an element whose pre-activation rounds
  to the other side of 0 takes the other slope, ROADMAP.md C.7; at depth
  0.33 they reached 9.3e-4 and 1.6e-3). The JAX gradient's distance from
  the same float64 run is measured and printed, not held (1.35e-4 of the
  norm, 1.9e-4 of the worst tensor's; at depth 0.33 3.5e-3 and 1.4e-2;
  ROADMAP.md C.1);
* the tail: kept indices and classes exact, boxes and scores to float32
  rounding.
"""

import copy
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    flax_variables_like,
    jit_o0,
    load_into,
    numpy_variables,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.models.backbones.efficientrep import EfficientRep as JRep
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.layers.blocks import RepVGGBlock as JRepVGG
from yolov7_d2_tpu.models.meta_arch import yolov6 as j6
from yolov7_d2_tpu.models.meta_arch.yolox import (
    yolox_postprocess as jax_postprocess,
)
from yolov7_d2_tpu.models.necks.reppan import RepPANNeck as JRepPAN
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import Yolov6Config
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.layers.blocks import RepVGGBlock
from yolov7_d2_tpu_torch.models.meta_arch import yolov6 as t6
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess
from yolov7_d2_tpu_torch.utils import weight_port as twp

REPO = Path(__file__).resolve().parent.parent
SIZE = 64
CLASSES = 4
KW = dict(num_classes=CLASSES, width_mul=0.25, depth_mul=0.33)
FWD_TOL = 1e-4
TRAIN_TOL = FWD_TOL
GRAD_DEPTH = 0.1


def _assert_close(got, want, tol=FWD_TOL, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=None)
def _pair(depth_mul: float = KW["depth_mul"]):
    """(flax YOLOV6, variables, port YOLOV6 holding them, uint8 images)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    kw = dict(KW, depth_mul=depth_mul)
    jmodel = j6.YOLOV6(**kw)
    variables = flax_variables_like(jmodel, images, rng)
    tmodel = load_into(t6.YOLOV6(**kw), variables, twp.map_yolov6_torch_name)
    return jmodel, variables, tmodel, images


def _is_part(mdl, _name):
    return isinstance(mdl, (JRep, JRepPAN))


@functools.lru_cache(maxsize=None)
def _jax_eval():
    """The JAX eval forward: head outputs and the backbone's and neck's
    outputs (captured intermediates)."""
    jmodel, variables, _, images = _pair()
    out, state = jax.jit(functools.partial(
        jmodel.apply, capture_intermediates=_is_part,
        mutable=["intermediates"]))(variables,
                                    jnp.asarray(images, jnp.float32))
    inter = state["intermediates"]
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in
             inter["backbone"]["__call__"][0].items()},
            [np.asarray(v) for v in inter["neck"]["__call__"][0]])


def _gts(rng, counts=(3, 5), g=6):
    boxes = np.zeros((len(counts), g, 4), np.float32)
    valid = np.zeros((len(counts), g), bool)
    for i, n in enumerate(counts):
        wh = rng.uniform(0.15, 0.7, (n, 2)) * SIZE
        c = rng.uniform(wh / 2, SIZE - wh / 2)
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :n] = True
    classes = (rng.integers(0, CLASSES, valid.shape) * valid).astype(np.int32)
    return {"gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("stride,c_in", [(1, 8), (2, 8), (1, 4)])
def test_repvgg_block_matches_jax(stride, c_in):
    """Eval output and train-mode statistics of one block: with the
    identity branch (stride 1, equal channels) and without it."""
    rng = np.random.default_rng(stride * 10 + c_in)
    x = rng.normal(0, 1, (2, 8, 8, c_in)).astype(np.float32)
    jblock = JRepVGG(8, stride)
    variables = flax_variables_like(jblock, x, rng)
    tblock = load_into(RepVGGBlock(c_in, 8, stride), variables,
                       lambda n: (twp._rep_leaf(n),))
    assert (tblock.rbr_identity is not None) == (stride == 1 and c_in == 8)

    def run(v, train):
        return jblock.apply(v, x, train=train, mutable=["batch_stats"])

    want, _ = jit_o0(functools.partial(run, train=False))(variables)
    want_t, stats = jit_o0(functools.partial(run, train=True))(variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        _assert_close(_nhwc(tblock(xt)), want)
        tblock.train()
        _assert_close(_nhwc(tblock(xt)), want_t)
    tblock.eval()
    moved = twp.jax_to_torch_state_dict(
        numpy_variables({"params": variables["params"], **stats}),
        tblock.state_dict(), lambda n: (twp._rep_leaf(n),))
    for k, v in tblock.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _assert_close(v.numpy(), moved[k], what=k)


def test_forward_matches_jax():
    """EfficientRep's features, RepPAN's outputs and EffiDeHead's outputs of
    one eval forward; grids and strides exact."""
    _, _, tmodel, images = _pair()
    want, want_bb, want_neck = _jax_eval()
    x = torch.from_numpy(images)
    with torch.no_grad():
        got = tmodel(x)
        feats = tmodel.backbone(x.permute(0, 3, 1, 2).float())
        neck = tmodel.neck([feats[k] for k in ("erep3", "erep4", "erep5")])
    for k in ("erep3", "erep4", "erep5"):
        _assert_close(_nhwc(feats[k]), want_bb[k], what=k)
    for i, (g, w) in enumerate(zip(neck, want_neck)):
        _assert_close(_nhwc(g), w, what=f"neck {i}")
    a = (SIZE // 8) ** 2 + (SIZE // 16) ** 2 + (SIZE // 32) ** 2
    assert tuple(got["outputs"].shape) == (2, a, 5 + CLASSES)
    assert got["outputs"].dtype == torch.float32
    _assert_close(got["outputs"].numpy(), want["outputs"], what="outputs")
    for key in ("grids", "strides"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    # the float batch of the training step gives the same
    with torch.no_grad():
        again = tmodel(x.float())
    assert torch.equal(again["outputs"], got["outputs"])


@functools.lru_cache(maxsize=None)
def _jax_losses():
    return jax.jit(lambda out, b: j6.yolov6_losses(out, b, CLASSES))


def test_losses_and_assignment_match_jax():
    """Every term on the same head outputs, and SimOTA's foreground (the
    JAX loss's ``simota_assign`` over all anchors, no prefilter)."""
    want_out, _, _ = _jax_eval()
    batch = _gts(np.random.default_rng(3))
    want = _jax_losses()(want_out, batch)
    got = t6.yolov6_losses(_torch(want_out), _torch(batch), CLASSES)
    assert sorted(got) == sorted(want)
    assert float(want["num_fg"]) >= 4
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    from yolov7_d2_tpu.models.heads import yolox_head as jhead
    from yolov7_d2_tpu_torch.models.heads import yolox_head as thead

    dec = jhead.decode_outputs(jnp.asarray(want_out["outputs"]),
                               want_out["grids"], want_out["strides"])
    jassign = jax.vmap(lambda b, o, c, gb, gc, gv: jhead.simota_assign(
        b, o, c, want_out["grids"], want_out["strides"], gb, gc, gv))(
        *dec, batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"])
    tdec = thead.decode_outputs(torch.from_numpy(want_out["outputs"]),
                                torch.from_numpy(want_out["grids"]),
                                torch.from_numpy(want_out["strides"]))
    tassign = thead.simota_assign(
        *tdec, torch.from_numpy(want_out["grids"]),
        torch.from_numpy(want_out["strides"]), *_torch(batch).values())
    fg = tassign["fg_mask"].numpy()
    np.testing.assert_array_equal(fg, np.asarray(jassign["fg_mask"]))
    np.testing.assert_array_equal(tassign["matched_gt"].numpy()[fg],
                                  np.asarray(jassign["matched_gt"])[fg])


def _port_grads(model, images, batch):
    model.train()
    model.zero_grad()
    x = torch.from_numpy(images).permute(0, 3, 1, 2).to(
        next(model.parameters()).dtype)
    feats = model.backbone(x)
    out = model.head(model.neck([feats[k] for k in ("erep3", "erep4",
                                                    "erep5")]))
    losses = t6.yolov6_losses(out, _torch(batch), CLASSES)
    losses["total_loss"].backward()
    model.eval()
    return losses, {n: p.grad.detach().double().numpy()
                    for n, p in model.named_parameters()}


def test_train_step_bn_statistics_losses_and_gradients():
    """A train-mode pass: the BatchNorm statistics it leaves, every loss
    term, and the gradients (see the module docstring), at depth 0.1 (one
    RepVGG block a RepBlock but in the backbone's third stage, two there:
    the JAX gradient's compile is the cost of the file)."""
    jmodel, variables, tmodel, _ = _pair(GRAD_DEPTH)
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    batch = _gts(rng, counts=(4, 2))

    def loss(params):
        out, new = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        losses = j6.yolov6_losses(out, batch, CLASSES)
        return losses["total_loss"], (losses, new)

    jgrads, (jlosses, jnew) = jit_o0(jax.grad(loss, has_aux=True))(
        variables["params"])
    fresh = copy.deepcopy(tmodel)
    losses, grads = _port_grads(fresh, images, batch)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=TRAIN_TOL,
                                   err_msg=k)
    assert float(losses["num_fg"]) == float(jlosses["num_fg"]) >= 4
    moved = twp.jax_to_torch_state_dict(
        numpy_variables({"params": variables["params"], **jnew}),
        fresh.state_dict(), twp.map_yolov6_torch_name)
    n_stats = 0
    for k, v in fresh.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _assert_close(v.numpy(), moved[k], TRAIN_TOL, what=k)
            n_stats += 1
    assert n_stats == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                              for m in fresh.modules())

    ref = copy.deepcopy(tmodel).double()
    _, grads64 = _port_grads(ref, images, batch)
    jax_g = twp.jax_to_torch_state_dict(
        numpy_variables({"params": jgrads,
                         "batch_stats": variables["batch_stats"]}),
        tmodel.state_dict(), twp.map_yolov6_torch_name)

    def gaps(g):
        whole = np.sqrt(sum(np.sum(np.square(grads64[n] - g[n]))
                            for n in grads64))
        norm = np.sqrt(sum(np.sum(np.square(v)) for v in grads64.values()))
        worst, name = max(
            (float(np.linalg.norm(grads64[n] - g[n])
                   / max(np.linalg.norm(grads64[n]), 1e-12)), n)
            for n in grads64)
        return whole / norm, worst, name

    port_whole, port_worst, _ = gaps(grads)
    jax_whole, jax_worst, jax_name = gaps(jax_g)
    print(f"YOLOv6 gradients against a float64 run of the port: port float32"
          f" {port_whole:.3g} of the norm (worst tensor {port_worst:.3g}); "
          f"JAX float32 {jax_whole:.3g} (worst tensor {jax_worst:.3g}, "
          f"{jax_name})")
    assert port_whole <= 1e-3, port_whole
    assert port_worst <= 1e-3, port_worst


def test_tail_matches_jax_index_for_index():
    """``yolox_postprocess`` of the eval outputs, the kernel's wrapper (the
    plain version on the CPU) against the JAX tail: same kept indices."""
    want_out, _, _ = _jax_eval()
    want = jax.jit(functools.partial(jax_postprocess, conf_threshold=0.001,
                                     nms_threshold=0.5))(want_out)
    head = _torch(want_out)
    got = yolox_postprocess(head, conf_threshold=0.001, nms_threshold=0.5)
    plain = yolox_postprocess(head, conf_threshold=0.001, nms_threshold=0.5,
                              nms=nms_batched_plain)
    assert int(got.valid.sum()) > 10
    for f in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("boxes", "scores"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))
        assert torch.equal(getattr(got, f), getattr(plain, f))


def test_weight_carrier_both_ways():
    """The port's state dict, under the reference's names, through the JAX
    package's maps (``map_efficientrep_torch_name``,
    ``port_reppan_state_dict``, ``map_effidehead_torch_name``) gives the
    JAX model the port's outputs, once the JAX carrier's transposed
    kernels are flipped (it does not flip them, ROADMAP.md C.25); and the
    port's carrier gives the state dict back."""
    jmodel, variables, tmodel, images = _pair()
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    parts = {p: {k[len(p) + 1:]: v for k, v in sd.items()
                 if k.startswith(p + ".")}
             for p in ("backbone", "neck", "head")}
    ported, rep_b = jwp.port_torch_state_dict(
        parts["backbone"], variables,
        name_mapper=lambda n: ("backbone",) + jwp.map_efficientrep_torch_name(
            n))
    ported, rep_n = jwp.port_reppan_state_dict(parts["neck"], ported,
                                               prefix=("neck",))
    ported, rep_h = jwp.port_torch_state_dict(
        parts["head"], ported,
        name_mapper=lambda n: ("head",) + jwp.map_effidehead_torch_name(n))
    for rep in (rep_b, rep_h):
        assert not [k for k in rep["unused"]
                    if not k.endswith("num_batches_tracked")]
    for i in (0, 1):
        w = sd[f"neck.upsample{i}.upsample_transpose.weight"]
        kernel = np.asarray(ported["params"]["neck"][f"upsample{i}"]["kernel"])
        # the JAX carrier: [I, O, kH, kW] -> [kH, kW, I, O], no flip
        np.testing.assert_array_equal(kernel, w.transpose(2, 3, 0, 1))
        ported["params"]["neck"][f"upsample{i}"]["kernel"] = kernel[::-1,
                                                                    ::-1]
    want = jit_o0(jmodel.apply)(ported, jnp.asarray(images, jnp.float32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    _assert_close(got["outputs"].numpy(), want["outputs"])
    back = twp.jax_to_torch_state_dict(jax.tree.map(np.asarray, ported),
                                       tmodel.state_dict(),
                                       twp.map_yolov6_torch_name)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _merged(yaml):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(str(REPO / "configs" / "coco" / yaml))
    return cfg, jcfg


@pytest.mark.parametrize("yaml", ["yolov6_s.yaml", "yolov6/yolov6_tiny.yaml",
                                  "yolov6/yolov6_m.yaml"])
def test_builders_match_jax_at_full_depth(yaml):
    """Every parameter and statistic of the full-depth model from the yaml
    has its flax leaf of the same shape, and no flax leaf is left over."""
    cfg, jcfg = _merged(yaml)
    tcfg = Yolov6Config.from_cfg(cfg)
    model = build_model(tcfg, "cpu")
    assert model.dtype == torch.bfloat16     # SOLVER.AMP.ENABLED in the yaml
    shapes = jax.eval_shape(
        lambda x: jax_build_model(jcfg).init(jax.random.PRNGKey(0), x),
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    leaves = twp.jax_to_torch_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        model.state_dict(), twp.map_yolov6_torch_name)
    assert sorted(leaves) == sorted(model.state_dict())
