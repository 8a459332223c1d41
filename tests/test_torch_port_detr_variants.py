"""The port's SMCA-DETR, DAB-DETR and d2go DETR against the JAX package, in
float32 on the CPU, and the entry points of the slice.

* ``SMCADecoderLayer`` alone in float32 and in bfloat16 (the prior cast
  to the logits' dtype before the add, only the softmax in float32);
* each model at 96 px (a 3 x 3 memory), the family's ResNet at depth 18
  (FrozenBN, the bottleneck blocks both packages build, 2 a stage; the
  yamls' ResNet-50 is held by the DETR tests and, leaf for leaf, below) or
  FBNet ``FBNetV3_A_dsmask`` (BatchNorm on batch statistics), hidden 32, 4
  heads, 2 encoder and 6 decoder layers (six levels), 10 queries, 3
  classes: SMCA-DETR, DAB-DETR, the d2go DETR on its DETR path (C + 1
  logits, the centred embedding) and on its SMCA path with the focal head
  (C logits) on FBNet. One JAX compile a model gives the train-mode
  outputs, every term of ``detr_losses`` and ``jax.grad``; the port holds
  its outputs, its loss terms, every parameter's gradient and (FBNet)
  every BatchNorm statistic against them;
* the weight carrier both ways: flax -> port, and back through the JAX
  package's ``port_torch_state_dict`` and ``split_torch_mha`` with the
  port's name map, exactly;
* the tails on the JAX outputs: ``detr_postprocess`` for the C + 1 heads,
  the sigmoid top-k ``anchor_detr_postprocess`` for the focal d2go head
  (``detr_tail``);
* the decay classes of every parameter of each new model and backbone
  against the JAX ``param_decay_class`` of its flax path (ConvNeXt's
  ``gamma``, SMCA's query embedding and DAB's ``ref_boxes`` are "weight",
  every LayerNorm "norm");
* the DETR yamls of the slice: what ``DetrConfig`` reads from each, and
  every parameter of the full-size model on a leaf of the JAX model's
  (``jax.eval_shape``), with the same parameter and statistic counts;
* ``train_transformer`` on SMCA-DETR and ``train_det`` on YOLOX-ConvNeXt
  (drop path 0.2) for 2 steps on a mini-COCO at 64 px.

Weights: flax variables drawn with numpy (``detr_variables_like``).
Tolerances, each with its reason:

* the layer: 1e-5 of its output's largest magnitude in float32; in
  bfloat16 3e-2 (both sides round the projections, the logits and the
  softmax's output to bfloat16 and add in another order: a few bf16 ulps);
* outputs and BatchNorm statistics: 1e-4 of each tensor's largest
  magnitude (at least 1; XLA-CPU and oneDNN sum each convolution in
  another order);
* loss terms: 1e-4 relative (the forward's);
* gradients, the port in NCHW (ROADMAP.md C.20): outside the backbone,
  each parameter's within 1e-3 of the larger of its norm and 1e-2 of the
  whole head's (the first decoder layer's self-attention reads zeros, so
  its query and key gradients are float32 noise; measured within 1e-5);
  the backbone's as a whole within 1e-3 of its norm (measured 1.1e-6 on
  ResNet, 2.4e-4 on FBNet, whose ReLU6 kinks part single BatchNorm
  biases of the two packages by more than a per-parameter bound holds;
  at ResNet-50 and 96-128 px the ResNet's kinks do the same, so the
  models run at depth 18);
* the tails: indices exact, scores and boxes to float32 rounding.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    DETR_DIMS,
    DETR_DIR,
    REPO,
    TINY_OPTS,
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
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.core.registry import BACKBONE_REGISTRY
from yolov7_d2_tpu.models.backbones import mobile as jmobile
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.models.meta_arch import detr as jd
from yolov7_d2_tpu.models.meta_arch import detr_variants as jdv
from yolov7_d2_tpu.train import optimizer as jopt
from yolov7_d2_tpu_torch.config import DetrConfig, YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data.catalog import (
    DatasetCatalog,
    register_coco_instances,
)
from yolov7_d2_tpu_torch.engine import build_system
from yolov7_d2_tpu_torch.models.backbones import mobile as tmobile
from yolov7_d2_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
from yolov7_d2_tpu_torch.models.backbones.zoo import (
    ZOO_BACKBONES,
    build_zoo_backbone,
)
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.layers import smca as tsmca
from yolov7_d2_tpu_torch.models.meta_arch import detr as td
from yolov7_d2_tpu_torch.models.meta_arch import detr_variants as tdv
from yolov7_d2_tpu_torch.train.optimizer import AdamW, param_decay_class
from yolov7_d2_tpu_torch.utils import weight_port as twp
from yolov7_d2_tpu_torch.utils.args import default_argument_parser

SIZE = 96
CLASSES = 3
LAYER_TOL = 1e-5
BF16_TOL = 3e-2
FWD_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
BACKBONE_GRAD_RTOL = 1e-3
DIMS = dict(DETR_DIMS, dec_layers=6, num_queries=10, resnet_depth=18)
FBNET = dict(arch="FBNetV3_A_dsmask", out_features=("trunk4",))

# name -> (JAX class, port class, keywords, backbone type, focal)
VARIANTS = {
    "smca": (jdv.SMCADETR,
             functools.partial(tdv.DetrD2go, attention_type="SMCA"), {},
             "resnet", False),
    "dab": (jdv.DABDETR, tdv.DABDETR, {}, "resnet", False),
    "d2go_detr": (jdv.DetrD2goModule, tdv.DetrD2go,
                  dict(centered_pe=True), "resnet", False),
    "d2go_smca_fbnet": (jdv.DetrD2goModule, tdv.DetrD2go,
                        dict(attention_type="SMCA", use_focal=True,
                             centered_pe=True), "fbnet", True),
}


def _close(got, want, tol=FWD_TOL, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, (what, err, scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, variables, the port's holding them, images, gts, map)."""
    jcls, tcls, kw, kind, _ = VARIANTS[name]
    jkw, tkw = dict(DIMS, **kw), dict(DIMS, **kw)
    if kind == "fbnet":
        jkw["backbone"] = jmobile.FBNet(**FBNET)
        tkw["backbone"] = tmobile.FBNet(**FBNET)
    jmodel, tmodel = jcls(**jkw), tcls(**tkw)
    rng = np.random.default_rng(sorted(VARIANTS).index(name))
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = detr_variables_like(jmodel, images.shape, rng)
    mapper = functools.partial(twp.map_detr_variant_torch_name,
                               backbone_type=kind)
    load_into(tmodel, variables, mapper)
    gt = detr_gt(rng, size=SIZE, classes=CLASSES)
    return jmodel, variables, tmodel, images, gt, mapper


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """One JAX compile: the train-mode outputs, the loss terms, the
    gradients and the updated BatchNorm statistics of ``name``."""
    jmodel, variables, _, images, gt, _ = _pair(name)
    focal = VARIANTS[name][4]
    stats = variables.get("batch_stats", {})

    def loss(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(images), train=True,
                                mutable=["batch_stats"])
        losses = jd.detr_losses(out, {k: jnp.asarray(v)
                                      for k, v in gt.items()},
                                CLASSES, (SIZE, SIZE), use_focal=focal)
        return losses["total_loss"], (losses, out, upd)

    grads, (losses, out, upd) = jit_o0(jax.grad(loss, has_aux=True))(
        variables["params"])
    return _np(grads), _np(losses), _np(out), _np(upd)


@functools.lru_cache(maxsize=None)
def _port_step(name):
    """The port's train-mode outputs, loss terms, gradients (by parameter
    name) and state after the forward, in NCHW (the normalize's plain
    version made contiguous, ROADMAP.md C.20)."""
    _, variables, tmodel, images, gt, mapper = _pair(name)
    focal = VARIANTS[name][4]
    plain = td.normalize_images_plain
    td.normalize_images_plain = lambda *a: plain(*a).contiguous()
    tmodel.train()
    tmodel.zero_grad()
    try:
        out = tmodel(torch.from_numpy(images))
        losses = td.detr_losses(out, {k: torch.from_numpy(v)
                                      for k, v in gt.items()},
                                CLASSES, (SIZE, SIZE), use_focal=focal)
        losses["total_loss"].backward()
        grads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
        state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    finally:
        td.normalize_images_plain = plain
        load_into(tmodel, variables, mapper)    # eval, statistics back
    return ({k: v.detach() for k, v in out.items()},
            {k: v.detach() for k, v in losses.items() if k != "match"},
            grads, state)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smca_layer_matches_jax(dtype):
    """One decoder layer, eval mode, 7 queries, a 3 x 4 memory, 4 heads,
    random centres and scales; the port's prior from ``smca_prior``."""
    rng = np.random.default_rng(3)
    b, q, c, h, w = 2, 7, 32, 3, 4
    tgt, qpos = (rng.normal(0, 1, (b, q, c)).astype(np.float32)
                 for _ in range(2))
    mem, pos = (rng.normal(0, 1, (b, h * w, c)).astype(np.float32)
                for _ in range(2))
    cs = rng.normal(0, 1, (b, q, 4, 4)).astype(np.float32)
    cs[..., :2] = 1 / (1 + np.exp(-cs[..., :2]))
    ys, xs = (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = jdv.SMCADecoderLayer(c, 4, 64, dtype=jdt)
    args = (tgt, mem, qpos, pos, cs, grid.astype(np.float32))
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a),
                            *[jnp.asarray(a) for a in args])
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if p[-1].key == "scale"
                      else rng.normal(0, s.shape[0] ** -0.5 if p[-1].key ==
                                      "kernel" else 0.3, s.shape)
                      ).astype(np.float32), shapes)
    tdt = getattr(torch, dtype)
    tm = tsmca.SMCADecoderLayer(c, 4, 64, dtype=tdt).eval()
    load_into(tm, params, lambda n: twp.map_detr_variant_torch_name(
        "transformer.decoder.layers.0." + n)[1:])
    want = np.asarray(jax.jit(jm.apply)(
        params, *[jnp.asarray(a, jdt if i < 4 else jnp.float32)
                  for i, a in enumerate(args)]).astype(jnp.float32))
    with torch.no_grad(), torch.autocast("cpu", dtype=tdt,
                                         enabled=dtype == "bfloat16"):
        prior = tsmca.smca_prior(torch.from_numpy(cs), h, w, tdt)
        got = tm(*[torch.from_numpy(a).to(tdt)
                   for a in (tgt, mem, qpos, pos)], prior)
    assert got.dtype == tdt
    _close(got.float().numpy(), want,
           LAYER_TOL if dtype == "float32" else BF16_TOL, dtype)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name):
    """Train-mode outputs of every level (FrozenBN ResNet: those of eval
    mode; FBNet: batch statistics) and, on FBNet, every updated running
    mean and variance."""
    out, _, _, state = _port_step(name)
    _, _, want, upd = _jax_step(name)
    for k in want:
        _close(out[k].numpy(), want[k], what=k)
    q = DIMS["num_queries"]
    assert out["pred_logits"].shape == (2, q, CLASSES + (not VARIANTS[
        name][4]))
    assert out["aux_boxes"].shape == (5, 2, q, 4)
    _, variables, _, _, _, mapper = _pair(name)
    if "batch_stats" in upd:
        stats = twp.jax_to_torch_state_dict(
            numpy_variables({"params": variables["params"],
                             "batch_stats": upd["batch_stats"]}), state,
            mapper)
        keys = [k for k in stats if k.endswith(("running_mean",
                                                "running_var"))]
        assert len(keys) > 20
        for k in keys:
            _close(state[k].numpy(), stats[k], what=k)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_losses_match_jax(name):
    """Every term of ``detr_losses`` at all six levels."""
    _, losses, _, _ = _port_step(name)
    _, want, _, _ = _jax_step(name)
    assert sum(k.endswith("loss_giou") for k in want) == 6
    for k, w in want.items():
        np.testing.assert_allclose(float(losses[k]), float(w),
                                   rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gradients_match_jax(name):
    """Every parameter outside the backbone within ``GRAD_TOL`` of the
    larger of its norm and 1e-2 of theirs; the backbone's gradient as a
    whole within ``BACKBONE_GRAD_RTOL`` of its norm."""
    _, _, grads, state = _port_step(name)
    jgrads = _jax_step(name)[0]
    _, variables, _, _, _, mapper = _pair(name)
    want = twp.jax_to_torch_state_dict(
        numpy_variables({"params": jgrads,
                         "batch_stats": variables.get("batch_stats", {})}),
        state, mapper)
    head = [n for n in grads if not n.startswith("backbone.")]
    whole = float(np.sqrt(sum(np.sum(np.square(want[n], dtype=np.float64))
                              for n in head)))
    for n in head:
        err = float(np.abs(grads[n].numpy() - want[n]).max())
        floor = max(float(np.linalg.norm(want[n])), 1e-2 * whole)
        assert err <= GRAD_TOL * floor, (n, err, floor)
    body = [n for n in grads if n.startswith("backbone.")]
    diff = np.sqrt(sum(np.sum(np.square(grads[n].numpy() - want[n],
                                        dtype=np.float64)) for n in body))
    norm = np.sqrt(sum(np.sum(np.square(want[n], dtype=np.float64))
                       for n in body))
    assert diff <= BACKBONE_GRAD_RTOL * norm, (diff, norm)
    assert sum(float(np.abs(want[n]).max()) > 0 for n in grads) > 100
    if name == "dab":
        assert float(grads["ref_boxes"].abs().max()) > 0


@pytest.mark.parametrize("name", ["smca", "d2go_smca_fbnet"])
def test_tails_match_jax(name):
    """The tail ``detr_tail`` picks, on the JAX outputs, against the JAX
    tail: softmax with "no object" dropped for C + 1 logits, the sigmoid
    top-k over (query, class) pairs for the focal head's C."""
    out = _jax_step(name)[2]
    focal = VARIANTS[name][4]
    tail = tdv.detr_tail(DetrConfig(use_focal_loss=focal))
    assert tail is (tdv.anchor_detr_postprocess if focal
                    else td.detr_postprocess)
    jtail = jdv.anchor_detr_postprocess if focal else jd.detr_postprocess
    want = jtail({k: jnp.asarray(v) for k, v in out.items()}, (SIZE, SIZE),
                 max_detections=7)
    got = tail({k: torch.from_numpy(v) for k, v in out.items()},
               (SIZE, SIZE), max_detections=7)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_weight_carrier_back_to_flax(name):
    """flax -> port (``jax_to_torch_state_dict``, :func:`_pair`) -> flax
    through the JAX package's own pieces, with the port's name map: the
    fused attentions split by ``split_torch_mha``, the raw ``query_embed``
    and ``ref_boxes`` as they are, the rest by ``port_torch_state_dict``:
    every leaf back, exactly."""
    from yolov7_d2_tpu.utils import weight_port as jwp

    _, variables, tmodel, _, _, mapper = _pair(name)
    want = numpy_variables(variables)
    back = jax.tree.map(np.zeros_like, want)
    attn, rest = {}, {}
    for key, v in tmodel.state_dict().items():
        m = re.match(r"^(.*\.(?:self_attn|multihead_attn))\.(in_proj_weight|"
                     r"in_proj_bias|out_proj\.weight|out_proj\.bias)$", key)
        if m:
            attn.setdefault(m.group(1), {})[m.group(2)] = v.numpy()
        elif key in ("ref_boxes", "query_embed.weight"):
            back["params"][key.partition(".")[0]] = v.numpy()
        else:
            rest[key] = v.numpy()
    back, report = jwp.port_torch_state_dict(rest, back, name_mapper=mapper)
    assert not report["unused"], report["unused"][:5]
    for owner, t in attn.items():
        node = back["params"]
        for part in mapper(owner):
            node = node[part]
        node.update(jwp.split_torch_mha(
            t["in_proj_weight"], t["in_proj_bias"], t["out_proj.weight"],
            t["out_proj.bias"], num_heads=DIMS["nheads"]))
    assert len(attn) == DIMS["enc_layers"] + DIMS["dec_layers"] * (
        1 + (name in ("dab", "d2go_detr")))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(got) == len(leaves)
    for path, w in leaves:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the decay classes
# ---------------------------------------------------------------------------

def _flax_leaf(module, pname, path):
    """The flax path of ``pname`` of ``module`` (mapped to ``path``)."""
    if pname in ("in_proj_weight", "in_proj_bias"):
        return path + ("query", "kernel" if pname.endswith("weight")
                       else "bias")
    if isinstance(module, torch.nn.Embedding):
        return path
    if pname == "weight":
        norm = isinstance(module, (torch.nn.LayerNorm, FrozenBatchNorm2d,
                                   torch.nn.modules.batchnorm._BatchNorm))
        return path + ("scale" if norm else "kernel",)
    return path + (pname,)


# zoo backbones: name -> (registry name, config options of both packages)
ZOO = {
    "convnext": ("build_convnext_backbone", {}),
    "regnety": ("build_regnet_backbone", {"MODEL.REGNETS.TYPE": "y"}),
    "efficientnet": ("build_efficientnet_backbone", {}),
    "fbnet_se_hs": ("build_fbnet_backbone", {"MODEL.FBNET_V2.ARCH_DEF": [
        {"trunk": [[("conv_k3_hs", 16, 2, 1)],
                   [("ir_k3_se_hs", 24, 2, 1, {"expansion": 4})],
                   [("ir_pool_hs", 32, 1, 1, 2)]]}],
        "MODEL.FBNET_V2.OUT_FEATURES": ["trunk2"]}),
}


def _zoo_pair(name):
    builder, opts = ZOO[name]
    cfgs = []
    for fn in (get_cfg, jax_get_cfg):
        cfg = fn()
        cfg.MODEL.BACKBONE.NAME = builder
        for k, v in opts.items():
            cfg.MODEL[k.split(".")[1]][k.split(".")[2]] = v
        cfgs.append(cfg)
    tmodel = build_zoo_backbone(YoloxConfig.from_cfg(cfgs[0]))
    jmodel = BACKBONE_REGISTRY.get(builder)(cfgs[1])
    kind = ZOO_BACKBONES[builder][0]
    return jmodel, tmodel, twp.BACKBONE_MAPS[kind]


@pytest.mark.parametrize("name", sorted(VARIANTS) + sorted(ZOO))
def test_decay_classes_match_jax(name):
    """Every parameter's class (the port's by module type and name) equals
    the JAX ``param_decay_class`` of its flax path (by leaf and parent
    names), and every flax parameter is met once."""
    if name in VARIANTS:
        jmodel, variables, tmodel, images, _, mapper = _pair(name)
        shapes = variables["params"]
    else:
        jmodel, tmodel, mapper = _zoo_pair(name)
        shapes = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x),
            jnp.zeros((1, 64, 64, 3)))["params"]
    paths = {tuple(str(getattr(k, "key", k)) for k in p)
             for p, _ in jax.tree_util.tree_leaves_with_path(shapes)}
    seen, classes = set(), set()
    for mname, module in tmodel.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            path = _flax_leaf(module, pname, mapper(mname) if mname else ())
            assert path in paths, (mname, pname, path)
            seen.add(path)
            cls = param_decay_class(module, pname)
            assert cls == jopt.param_decay_class("/".join(path)), \
                f"{mname}.{pname}"
            classes.add((pname, cls))
    # the fused in-projection stands for three flax leaves
    assert {p for p in paths - seen if p[-2] not in ("key", "value")} == set()
    for pname in ("gamma", "ref_boxes"):
        assert {c for p, c in classes if p == pname} <= {"weight"}
    assert ("weight", "norm") in classes


# ---------------------------------------------------------------------------
# the yamls
# ---------------------------------------------------------------------------

# yaml -> (architecture, backbone type, focal, queries, d2go attention)
DETR_YAMLS = {
    "smca_detr_r50.yaml": ("SMCADetr", "resnet", False, 100, "SMCA"),
    "smcadetr_origin.yaml": ("SMCADetr", "resnet", False, 100, "SMCA"),
    "d2go/smca_bs16.yaml": ("SMCADetr", "resnet", False, 100, "DETR"),
    "d2go/smca_bs64.yaml": ("SMCADetr", "resnet", False, 100, "DETR"),
    # the JAX builder ignores MODEL.BACKBONE.NAME (ROADMAP.md C.28)
    "d2go/smca_regnetx_0.4g.yaml": ("SMCADetr", "resnet", False, 100,
                                    "DETR"),
    "dab_detr_r50.yaml": ("DABDetr", "resnet", False, 100, "DETR"),
    # MODEL.BACKBONE.NAME's default: CSPDarknet-X (ROADMAP.md C.30)
    "d2go/detr_bs16.yaml": ("DetrD2go", "cspdarknetx", False, 100, "DETR"),
    "d2go/detr_fbv3_bs16.yaml": ("DetrD2go", "fbnet", False, 100, "DETR"),
    "d2go/smca_fbv3.yaml": ("DetrD2go", "fbnet", True, 300, "SMCA"),
}


@pytest.mark.parametrize("yaml", sorted(DETR_YAMLS))
def test_detr_yaml_builds_with_the_jax_leaves(yaml, monkeypatch):
    arch, kind, focal, queries, attention = DETR_YAMLS[yaml]
    tcfg = DetrConfig.from_cfg(merged_detr_cfg(get_cfg, yaml))
    assert (tcfg.meta_architecture, tcfg.use_focal, tcfg.num_queries,
            tcfg.d2go_attention) == (arch, focal, queries, attention)
    assert tcfg.centered_pe == (yaml == "d2go/smca_fbv3.yaml")
    monkeypatch.setattr(td, "init_detr_weights_", lambda *args: None)
    model = build_model(tcfg, "cpu")
    jcfg = merged_detr_cfg(jax_get_cfg, yaml, **{"SOLVER.AMP.ENABLED":
                                                 False})
    mapper = functools.partial(twp.map_detr_variant_torch_name,
                               backbone_type=kind)
    count = assert_leaves_match_jax(model, jax_build_model(jcfg), mapper)
    assert count["params"] > 1e7
    assert model.class_embed.out_features == 80 + (not focal)


def test_smca_fbv3_trains_with_adamw_and_full_model_clipping():
    """``smca_fbv3.yaml``: AdamW, the whole gradient clipped to norm 0.1,
    the focal criterion; one step at the tiny size moves the weights by
    at most lr a parameter element, as Adam does."""
    cfg = merged_detr_cfg(get_cfg, "d2go/smca_fbv3.yaml", **dict(
        {k: v for k, v in DETR_TINY.items()},
        **{"SOLVER.WARMUP_ITERS": 0}))
    dcfg = DetrConfig.from_cfg(cfg)
    assert (dcfg.optimizer, dcfg.clip_gradients, dcfg.clip_type,
            dcfg.clip_value) == ("adamw", True, "full_model", 0.1)
    model, state, step, fields = build_system(cfg, device="cpu")
    assert isinstance(state.optimizer, AdamW)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in detr_gt(
        np.random.default_rng(5), size=64, classes=2).items()}
    batch["image"] = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["total_loss"]))
    assert float(metrics["grad_norm"]) > 0.1   # clipped to 0.1
    lr = dcfg.base_lr
    for n, p in model.named_parameters():
        mult = dcfg.backbone_multiplier if n.startswith("backbone") else 1
        assert float((p.detach() - before[n]).abs().max()) <= 1.01 * lr * \
            mult + 1e-6, n


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

DETR_TINY = {
    "MODEL.DETR.NUM_CLASSES": 2, "MODEL.DETR.HIDDEN_DIM": 32,
    "MODEL.DETR.NHEADS": 4, "MODEL.DETR.ENC_LAYERS": 2,
    "MODEL.DETR.DEC_LAYERS": 2, "MODEL.DETR.DIM_FEEDFORWARD": 64,
    "MODEL.DETR.NUM_OBJECT_QUERIES": 10, "MODEL.YOLO.MAX_BOXES_NUM": 8,
    "INPUT.INPUT_SIZE": [64, 64], "INPUT.MIN_SIZE_TRAIN": [48, 56, 64],
    "INPUT.MAX_SIZE_TRAIN": 128, "SOLVER.IMS_PER_BATCH": 2,
    "SOLVER.AMP.ENABLED": False, "DATALOADER.NUM_WORKERS": 1,
}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    js, root = write_mini_coco(tmp_path_factory.mktemp("variants"), n=8)
    DatasetCatalog.remove("variants_mini")
    register_coco_instances("variants_mini", {}, js, root)
    yield "variants_mini"
    DatasetCatalog.remove("variants_mini")


def test_train_transformer_smca_on_the_cpu(mini, tmp_path):
    """2 steps of SMCA-DETR (full-depth ResNet-50, the tiny transformer)
    with a checkpoint at each: finite losses at both levels."""
    from yolov7_d2_tpu_torch import train_transformer

    opts = dict(DETR_TINY, **{
        "MODEL.DEVICE": "cpu", "SOLVER.MAX_ITER": 2,
        "SOLVER.CHECKPOINT_PERIOD": 1, "DATASETS.TRAIN": f"('{mini}',)",
        "OUTPUT_DIR": str(tmp_path / "out")})
    args = default_argument_parser().parse_args(
        ["--config-file", str(DETR_DIR / "smca_detr_r50.yaml")]
        + opts_list(opts))
    trainer = train_transformer.main(args)
    assert isinstance(trainer.state.model, tdv.DetrD2go)
    assert trainer.state.model.attention_type == "SMCA"
    last = trainer.storage.latest()
    for k in ("loss_ce", "loss_bbox", "loss_giou", "aux0_loss_ce",
              "total_loss", "grad_norm"):
        assert np.isfinite(last[k]), k
    assert last["num_matched"] >= 1
    assert sorted(p.name for p in (tmp_path / "out" / "ckpt").iterdir()) \
        == ["ckpt_00000001.pt", "ckpt_00000002.pt"]


def test_train_det_yolox_convnext_on_the_cpu(mini, tmp_path):
    """2 steps of YOLOX on ConvNeXt-T (width 0.125 neck and head, drop
    path 0.2 from the step's seed) through ``train_det``: finite losses,
    the drop path's generator on the model."""
    from yolov7_d2_tpu_torch import train_det

    opts = dict(TINY_OPTS, **{
        "DATASETS.TRAIN": (mini,), "DATASETS.TEST": (mini,),
        "OUTPUT_DIR": str(tmp_path / "out"), "SOLVER.MAX_ITER": 2,
        "SOLVER.CHECKPOINT_PERIOD": 2, "TEST.EVAL_PERIOD": 0})
    args = default_argument_parser().parse_args(
        ["--config-file", str(REPO / "configs/coco/yolox/yolox_convnext.yaml")]
        + opts_list(opts))
    trainer = train_det.main(args)
    model = trainer.state.model
    assert type(model.backbone).__name__ == "ConvNeXt"
    assert model.generator is not None
    assert model.backbone.stages[3][2].drop_path == pytest.approx(0.2)
    last = trainer.storage.latest()
    for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls"):
        assert np.isfinite(last[k]), k
