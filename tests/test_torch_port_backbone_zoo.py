"""The port's backbone zoo (RegNet, ConvNeXt, EfficientNet, FBNet) against
the JAX package, in float32 on the CPU, and the yamls it unlocks.

* the copied tables (``REGNET_SPECS``, ``CONVNEXT_SPECS``,
  ``EFFNET_SCALING``, ``MBCONV_PLAN``, ``FBNET_ARCH`` with its derived
  entries) equal the JAX package's, and so do the name and arch helpers
  (RegNet's type names, ``normalize_arch_def``, ``resolve_fbnet_arch``,
  ``_parse_op``, the channel and repeat rounding, the static-same pad);
* every backbone through both packages' builders from the same config
  (RegNet X and Y 400MF, ConvNeXt-T at drop path 0, EfficientNet b0 and
  b2, FBNet ``FBNetV3_A_dsmask_C5``, the SE table ``FBNetV3_A``, an
  ``ARCH_DEF`` literal with SE and hard-swish ops, a skip, a negative
  stride and ``dw_skip_bnrelu`` off) at 64 px, full depth: each output
  leaf in eval mode, and after a train-mode forward at 128 px (at 64 px
  the stride-32 maps hold 8 values a channel for the batch statistics)
  the outputs and every BatchNorm statistic;
* the weight carrier both ways (flax -> port -> flax through the JAX
  ``port_torch_state_dict`` / ``port_convnext_state_dict``, exact) and the
  port's copies of the JAX ConvNeXt and EfficientNet name maps over every
  key;
* ConvNeXt's drop path: masks from the model's generator, one a sample,
  the rates linear in the block index, nothing in eval mode;
* YOLOX on RegNet and ConvNeXt and YOLOV7 on EfficientNet-b0, the whole
  model at 64 px against the JAX builder's (the neck takes the
  backbone's widths); YOLOX on a cut ConvNeXt-T in train mode at 128 px:
  SimOTA's foreground count, the loss terms and every gradient against
  ``jax.grad``;
* the zoo yamls that this slice unlocks built through ``build_model``:
  every parameter and BatchNorm statistic of the full-size model on a
  leaf of the JAX model's (``jax.eval_shape`` of its init), none left
  over, and the same counts. ``wearmask/efficient_b2.yaml`` taps b0's
  block indices [1, 4, 10, 15] on b2, which gives strides 4, 16 and 16:
  YOLOFPN cannot join them, and both packages fail on the yaml as it is
  (ROADMAP.md C.31); its leaves are held with the taps at b2's stage ends
  ([4, 7, 15, 22]).

Weights: flax variables drawn with numpy (``flax_variables_like``; the
ConvNeXt layer scales N(0, 0.5), since their init 1e-6 would hide the
blocks), moved into the port by ``jax_to_torch_state_dict``. Tolerances:
outputs and statistics within 1e-4 of each tensor's largest magnitude
(at least 1; XLA-CPU and oneDNN sum each convolution in another order,
measured within 1e-5); the carrier and the tables exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    REPO,
    assert_leaves_match_jax,
    flax_variables_like,
    jit_o0,
    load_into,
    numpy_variables,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.core.registry import BACKBONE_REGISTRY
from yolov7_d2_tpu.models.backbones import convnext as jconvnext
from yolov7_d2_tpu.models.backbones import efficientnet as jeff
from yolov7_d2_tpu.models.backbones import mobile as jmobile
from yolov7_d2_tpu.models.backbones import regnet as jregnet
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu.utils import weight_port as jwp
from yolov7_d2_tpu_torch.config import AnchorYoloConfig, YoloxConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.config.yolox import ZooSpec
from yolov7_d2_tpu_torch.models.backbones import convnext as tconvnext
from yolov7_d2_tpu_torch.models.backbones import efficientnet as teff
from yolov7_d2_tpu_torch.models.backbones import mobile as tmobile
from yolov7_d2_tpu_torch.models.backbones import regnet as tregnet
from yolov7_d2_tpu_torch.models.backbones.zoo import (
    ZOO_BACKBONES,
    build_zoo_backbone,
)
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import yolov7 as tyolov7
from yolov7_d2_tpu_torch.models.meta_arch import yolox as tyolox
from yolov7_d2_tpu_torch.utils import weight_port as twp

TOL = 1e-4
SIZE = 64

# an ARCH_DEF literal in the reference's form (a list of dicts merged in
# order, mobile_cv block tuples): SE and hard-swish ops, a skip that
# bridges, a 2x upsample, expansion as a dict and as a number, and the
# depthwise BN + act kept
ARCH_DEF = [
    {"trunk": [
        [("conv_k3_hs", 16, 2, 1)],
        [("ir_k3_se_hs", 24, 2, 2, {"expansion": 4}),
         ("skip", 32, 1, 1)],
        [("ir_k5_hs", 40, 2, 1, 3), ("ir_k3_se", 40, 1, 1, {})],
        [("ir_k3_se_hs", 48, -2, 1, {"expansion": 2}),
         ("conv_k1", 56, 2, 1)],
    ]},
    {"basic_args": {"dw_skip_bnrelu": False}},
]

# name -> (MODEL.BACKBONE.NAME, config options of both packages)
BACKBONES = {
    "regnetx_400mf": ("build_regnet_backbone", {
        "MODEL.REGNETS.TYPE": "RegNetX_400MF",
        "MODEL.REGNETS.OUT_FEATURES": ["s2", "s3", "s4"]}),
    "regnety_400mf": ("build_regnet_backbone", {
        "MODEL.REGNETS.TYPE": "regnety_0.4g",
        "MODEL.REGNETS.OUT_FEATURES": ["s1", "s3", "s4"]}),
    "convnext_tiny": ("build_convnext_backbone", {
        "MODEL.CONVNEXT.DROP_PATH_RATE": 0.0}),
    "efficientnet_b0": ("build_efficientnet_backbone", {}),
    "efficientnet_b2": ("build_efficientnet_backbone", {
        "MODEL.EFFICIENTNET.NAME": "efficientnet_b2",
        "MODEL.EFFICIENTNET.OUT_FEATURES": ["stride8", "stride16",
                                            "stride32"]}),
    "fbnet_dsmask_c5": ("build_fbnet_backbone", {
        "MODEL.FBNET_V2.ARCH": "FBNetV3_A_dsmask_C5"}),
    "fbnet_v3a_se": ("FBNetV2C4Backbone", {
        "MODEL.FBNET_V2.ARCH": "FBNetV3_A",
        "MODEL.FBNET_V2.OUT_FEATURES": ["trunk1", "trunk3"],
        "MODEL.FBNET_V2.SCALE_FACTOR": 0.75}),
    "fbnet_arch_def": ("build_fbnet_backbone", {
        "MODEL.FBNET_V2.OUT_FEATURES": ["trunk2", "trunk3"]}),
}


def _merge(cfg, opts):
    for k, v in opts.items():
        node = cfg
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
    return cfg


def _spec_cfgs(name):
    """(port YoloxConfig, JAX CfgNode) of the backbone case ``name``."""
    builder, opts = BACKBONES[name]
    opts = dict(opts, **{"MODEL.BACKBONE.NAME": builder})
    if name == "fbnet_arch_def":
        opts["MODEL.FBNET_V2.ARCH_DEF"] = ARCH_DEF
    cfg = _merge(get_cfg(), opts)
    return YoloxConfig.from_cfg(cfg), _merge(jax_get_cfg(), opts)


def _map(name):
    return twp.BACKBONE_MAPS[ZOO_BACKBONES[BACKBONES[name][0]][0]]


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(flax backbone, its variables, the port's holding them, images)."""
    tcfg, jcfg = _spec_cfgs(name)
    jmodel = BACKBONE_REGISTRY.get(BACKBONES[name][0])(jcfg)
    tmodel = build_zoo_backbone(tcfg)
    rng = np.random.default_rng(len(name))
    images = rng.uniform(-2, 2, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = flax_variables_like(jmodel, images, rng)
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0.0, 0.5, v.shape).astype(np.float32)
                      if p[-1].key == "gamma" else v), variables["params"])
    load_into(tmodel, variables, _map(name))
    return jmodel, variables, tmodel, images


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= TOL * scale, (what, err, scale)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close_maps(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        _close(got[k].detach().permute(0, 2, 3, 1).numpy(), w, k)
        assert float(np.abs(np.asarray(w)).max()) > 0.1, k


# ---------------------------------------------------------------------------
# the copied tables and helpers
# ---------------------------------------------------------------------------

def test_copied_tables_equal_jax():
    assert tregnet.REGNET_SPECS == jregnet.REGNET_SPECS
    assert tconvnext.CONVNEXT_SPECS == jconvnext.CONVNEXT_SPECS
    assert teff.EFFNET_SCALING == jeff.EFFNET_SCALING
    assert teff.MBCONV_PLAN == jeff.MBCONV_PLAN
    assert tmobile.FBNET_ARCH == jmobile.FBNET_ARCH
    assert sorted(tmobile.FBNET_ARCH) == sorted(jmobile.FBNET_ARCH)
    for k in ("default_dsmask", "FBNetV3_B_light_large", "FBNetV3_G_fpn",
              "FBNetV3_A_no_se", "FBNetV3_B_no_se"):
        assert k in tmobile.FBNET_ARCH, k


@pytest.mark.parametrize("regnet_type", [
    "x", "y", "RegNetX_400MF", "regnetx_0.4g", "regnetx_200mf",
    "regnetx_0.2g", "RegNetY_800MF", "regnetx_1.6g", "x_800mf"])
def test_regnet_names_resolve_as_in_jax(regnet_type):
    jcfg = _merge(jax_get_cfg(), {"MODEL.REGNETS.TYPE": regnet_type})
    want = jregnet.build_regnet_backbone(jcfg).variant
    assert tregnet.regnet_variant(regnet_type) == want
    assert want in tregnet.REGNET_SPECS


def test_fbnet_and_efficientnet_helpers_match_jax():
    for op in ("conv_k3", "conv_k1_hs", "ir_k5", "ir_k3_se", "ir_k5_se_hs",
               "skip", "ir_pool_hs"):
        assert tmobile._parse_op(op) == jmobile._parse_op(op), op
    for bad in ("dw_k3", "ir_kx"):
        with pytest.raises(ValueError):
            tmobile._parse_op(bad)
    for name in ("FBNetV3_A_dsmask_C5", "FBNetV3_G_C4", "default",
                 "FBNetV3_B_light_no_se"):
        assert tmobile.resolve_fbnet_arch(name) == \
            jmobile.resolve_fbnet_arch(name), name
    with pytest.raises(KeyError):
        tmobile.resolve_fbnet_arch("FBNetV9")
    assert tmobile.normalize_arch_def(ARCH_DEF[0]["trunk"]) == \
        jmobile.normalize_arch_def(ARCH_DEF[0]["trunk"])
    for c in (3.0, 7.9, 12.0, 17.5, 100.0, 1001.0):
        assert tmobile._round_channels(c) == jmobile._round_channels(c), c
    for c, m in ((32, 1.1), (24, 1.4), (320, 2.0), (16, 1.0), (40, 1.8)):
        assert teff.round_filters(c, m) == jeff._round_filters(c, m)
        assert teff.round_repeats(c // 8, m) == jeff._round_repeats(c // 8, m)
    for k, s in ((3, 1), (3, 2), (5, 1), (5, 2), (1, 1)):
        assert teff.static_same_pad(k, s) == jeff._static_same_pad(k, s)


# ---------------------------------------------------------------------------
# the backbones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_jax(name):
    """Eval mode, every output leaf; ``out_channels`` gives their widths."""
    jmodel, variables, tmodel, images = _pair(name)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    with torch.no_grad():
        got = tmodel(_nchw(images))
    _close_maps(got, want)
    assert list(tmodel.out_channels) == list(got)
    for k, v in got.items():
        assert tmodel.out_channels[k] == v.shape[1], k


@pytest.mark.parametrize("name", ["regnety_400mf", "efficientnet_b2",
                                  "fbnet_arch_def", "convnext_tiny"])
def test_train_forward_and_batchnorm_statistics_match_jax(name):
    """Train mode (batch statistics, momentum 0.1 / 0.01 against flax 0.9
    / 0.99, unbiased running variance): the outputs and every updated
    running mean and variance. ConvNeXt (LayerNorm only, drop path 0)
    gives its eval outputs."""
    jmodel, variables, tmodel, _ = _pair(name)
    images = np.random.default_rng(11).uniform(
        -2, 2, (2, 2 * SIZE, 2 * SIZE, 3)).astype(np.float32)
    want, upd = jax.jit(functools.partial(
        jmodel.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(images))
    tmodel.train()
    try:
        with torch.no_grad():
            got = tmodel(_nchw(images))
        sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    finally:
        load_into(tmodel, variables, _map(name))  # eval, statistics back
    _close_maps(got, want)
    if name == "convnext_tiny":
        assert "batch_stats" not in variables
        return
    stats = twp.jax_to_torch_state_dict(
        numpy_variables({"params": variables["params"],
                         "batch_stats": upd["batch_stats"]}), sd,
        _map(name))
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    for k in keys:
        _close(sd[k].numpy(), stats[k], k)
    assert len(keys) > 10


def _jax_map(name):
    kind = ZOO_BACKBONES[BACKBONES[name][0]][0]
    return {"convnext": jwp.map_convnext_torch_name,
            "efficientnet": jwp.map_efficientnet_torch_name}.get(
        kind, lambda n: tuple(n.split(".")))


@pytest.mark.parametrize("name", ["regnety_400mf", "convnext_tiny",
                                  "efficientnet_b0", "fbnet_arch_def"])
def test_weight_carrier_both_ways(name):
    """flax -> port (``jax_to_torch_state_dict``) -> flax through the JAX
    porters (ConvNeXt's with its layer-scale ``gamma``): every leaf back,
    exactly."""
    _, variables, tmodel, _ = _pair(name)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    zero = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        numpy_variables(variables))
    if name == "convnext_tiny":
        back, report = jwp.port_convnext_state_dict(sd, zero)
    else:
        back, report = jwp.port_torch_state_dict(sd, zero,
                                                 name_mapper=_jax_map(name))
    assert not report["unused"], report["unused"][:5]
    want = jax.tree_util.tree_leaves_with_path(numpy_variables(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["convnext_tiny", "efficientnet_b2"])
def test_name_maps_equal_jax(name):
    _, _, tmodel, _ = _pair(name)
    modules = {k.rpartition(".")[0] for k in tmodel.state_dict()}
    assert len(modules) > 50
    for m in modules:
        assert _map(name)(m) == _jax_map(name)(m), m


def test_convnext_drop_path_draws_from_the_generator():
    """Rates linear from 0 to ``DROP_PATH_RATE`` over the blocks; in train
    mode a whole sample's branch is dropped or kept and divided by the
    keep share, with masks from ``generator`` (one seed twice, the same
    output; another seed, another; the global RNG untouched); without a
    generator train mode raises; eval mode ignores it."""
    model = tconvnext.ConvNeXt("tiny", (3,), drop_path_rate=0.9).eval()
    rates = [b.drop_path for s in model.stages for b in s]
    np.testing.assert_allclose(rates, np.linspace(0, 0.9, 18), rtol=1e-12)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (8, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        for b in (blk for s in model.stages for blk in s):
            b.gamma.fill_(0.5)
        a = model(x)["stage3"]
        model.train()
        with pytest.raises(ValueError, match="Generator"):
            model(x)
        model.generator = torch.Generator()
        outs = []
        for seed in (1, 2, 1):
            model.generator.manual_seed(seed)
            state = torch.random.get_rng_state()
            outs.append(model(x)["stage3"])
            assert torch.equal(state, torch.random.get_rng_state())
        # the last block alone at rate 0.9: one keep-or-drop a sample
        blk = model.stages[3][2]
        y = torch.randn(8, 768, 1, 1)
        blk.generator.manual_seed(3)
        out = blk(y) - y
        kept = out.flatten(1).abs().amax(1) > 0
        assert 0 < int(kept.sum()) < 8
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0],
                                                             outs[1])
    assert not torch.equal(outs[0], a)


# ---------------------------------------------------------------------------
# the heads on the zoo
# ---------------------------------------------------------------------------

HEADS = {
    # name -> (yaml, options, backbone type)
    "yolox_regnetx_s": ("coco/yolox_regnetx_s.yaml", {}, "regnet"),
    "yolox_convnext": ("coco/yolox/yolox_convnext.yaml", {
        "MODEL.CONVNEXT.DROP_PATH_RATE": 0.0, "MODEL.YOLO.WIDTH_MUL": 0.25},
        "convnext"),
    # b0, where the default taps [1, 4, 10, 15] are at strides 4-32
    "yolov7_efficientnet_b0": ("wearmask/efficient_b2.yaml", {
        "MODEL.EFFICIENTNET.NAME": "efficientnet_b0"}, "efficientnet"),
}


def _yaml_cfgs(yaml, **opts):
    cfgs = []
    for fn in (get_cfg, jax_get_cfg):
        cfg = fn()
        cfg.merge_from_file(str(REPO / "configs" / yaml))
        cfgs.append(_merge(cfg, opts))
    return cfgs


@pytest.mark.parametrize("name", sorted(HEADS))
def test_heads_on_the_zoo_match_jax(name):
    """The whole model of the yaml (YOLOX through ``build_yolox``, YOLOV7
    through ``build_yolov7``; full-width backbone), 64 px, float32, eval
    mode: every head output."""
    yaml, opts, kind = HEADS[name]
    cfg, jcfg = _yaml_cfgs(yaml, **dict(opts, **{
        "SOLVER.AMP.ENABLED": False, "INPUT.INPUT_SIZE": [SIZE, SIZE]}))
    yolox = cfg.MODEL.META_ARCHITECTURE == "YOLOX"
    tcfg = (YoloxConfig if yolox else AnchorYoloConfig).from_cfg(cfg)
    tmodel = build_model(tcfg, "cpu")
    jmodel = jax_build_model(jcfg)
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = flax_variables_like(jmodel, images, rng)
    mapper = functools.partial(
        twp.map_yolox_kpts_torch_name if yolox
        else twp.map_anchor_yolo_torch_name, backbone_type=kind)
    load_into(tmodel, variables, mapper)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    _close(got["outputs"].numpy(), want["outputs"], "outputs")
    if yolox:
        assert isinstance(tmodel, tyolox.YOLOX)
    else:
        assert isinstance(tmodel, tyolov7.AnchorYOLO)


# ---------------------------------------------------------------------------
# the yamls
# ---------------------------------------------------------------------------

ZOO_YAMLS = {
    "coco/regnetx_0.4g.yaml": {},
    "coco/yolox_regnetx_s.yaml": {},
    "canaries/regnetx_0.2g.yaml": {},
    "coco/yolox_convnext.yaml": {},
    "coco/yolox/yolox_convnext.yaml": {},
    # b2's stage ends (the yaml's own taps fail in both packages, C.31)
    "wearmask/efficient_b2.yaml": {
        "MODEL.EFFICIENTNET.FEATURE_INDICES": [4, 7, 15, 22]},
}


@pytest.mark.parametrize("yaml", sorted(ZOO_YAMLS))
def test_zoo_yaml_builds_with_the_jax_leaves(yaml, monkeypatch):
    cfg, jcfg = _yaml_cfgs(yaml, **ZOO_YAMLS[yaml])
    yolox = cfg.MODEL.META_ARCHITECTURE == "YOLOX"
    tcfg = (YoloxConfig if yolox else AnchorYoloConfig).from_cfg(cfg)
    assert tcfg.zoo == ZooSpec.from_cfg(cfg)
    # the leaves' shapes are what is held: the weights' draw is skipped
    monkeypatch.setattr(tyolox if yolox else tyolov7, "init_weights_",
                        lambda *args: None)
    model = build_model(tcfg, "cpu")
    kind = ZOO_BACKBONES[tcfg.backbone][0]
    mapper = functools.partial(
        twp.map_yolox_kpts_torch_name if yolox
        else twp.map_anchor_yolo_torch_name, backbone_type=kind)
    count = assert_leaves_match_jax(model, jax_build_model(jcfg), mapper)
    assert count["params"] > 5e6 and count["batch_stats"] > 0


def test_efficient_b2_taps_fail_in_both_packages():
    """``wearmask/efficient_b2.yaml`` as it is: b0's taps on b2 give
    features at strides 4, 16 and 16, and YOLOFPN's concatenation fails
    in the JAX init and in the port's forward alike (ROADMAP.md C.31)."""
    cfg, jcfg = _yaml_cfgs("wearmask/efficient_b2.yaml", **{
        "INPUT.INPUT_SIZE": [SIZE, SIZE], "SOLVER.AMP.ENABLED": False})
    tcfg = AnchorYoloConfig.from_cfg(cfg)
    assert tcfg.zoo.efficientnet_feature_indices == (1, 4, 10, 15)
    model = build_model(tcfg, "cpu")
    with torch.no_grad():
        feats = model.backbone(torch.zeros(1, 3, SIZE, SIZE))
    assert [f.shape[-1] for f in feats.values()] == [SIZE // 4, SIZE // 16,
                                                     SIZE // 16]
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        with torch.no_grad():
            model(torch.zeros(1, SIZE, SIZE, 3, dtype=torch.uint8))
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(
            lambda x: jax_build_model(jcfg).init(jax.random.PRNGKey(0), x),
            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))


def test_yolox_convnext_train_step_matches_jax(monkeypatch):
    """YOLOX on ConvNeXt-T (neck and head at width 0.25, the stages cut to
    1 / 1 / 2 / 1 blocks in both packages, drop path 0), train mode, 128
    px, 8 classes: SimOTA's foreground count exact, the loss terms within
    1e-4 relative (the forward's), each parameter's gradient within 1e-3
    of its tensor's largest magnitude plus 1e-6 of the largest gradient
    (``tests/test_torch_port_train.py``'s YOLOX tolerances: the JAX
    BatchNorm variance of the neck and head, C.7)."""
    from yolov7_d2_tpu.engine import make_yolox_loss_adapter as jax_adapter
    from yolov7_d2_tpu.models.meta_arch.yolox import YOLOX as JaxYOLOX
    from yolov7_d2_tpu_torch.engine import make_yolox_loss_adapter

    from test_torch_port_train import _gts

    cut = ((1, 1, 2, 1), tconvnext.CONVNEXT_SPECS["tiny"][1])
    monkeypatch.setitem(tconvnext.CONVNEXT_SPECS, "tiny", cut)
    monkeypatch.setitem(jconvnext.CONVNEXT_SPECS, "tiny", cut)
    kw = dict(num_classes=8, width_mul=0.25,
              in_features=("stage1", "stage2", "stage3"))
    jmodel = JaxYOLOX(backbone=jconvnext.ConvNeXt("tiny"), **kw)
    tmodel = tyolox.YOLOX(backbone=tconvnext.ConvNeXt("tiny"), **kw)
    rng = np.random.default_rng(17)
    images = rng.uniform(0, 255, (2, 2 * SIZE, 2 * SIZE, 3)).astype(
        np.float32)
    variables = flax_variables_like(jmodel, images, rng)
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0.0, 0.5, v.shape).astype(np.float32)
                      if p[-1].key == "gamma" else v), variables["params"])
    mapper = functools.partial(twp.map_yolox_kpts_torch_name,
                               backbone_type="convnext")
    load_into(tmodel, variables, mapper)
    batch = dict(zip(("gt_boxes", "gt_classes", "gt_valid"),
                     _gts(rng, 2, 2 * SIZE, 8, [6, 2])))
    jloss = jax_adapter(8, prefilter_topk=None)

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        losses = jloss(out, {k: jnp.asarray(v) for k, v in batch.items()},
                       True)
        return losses["total_loss"], losses

    jgrads, jlosses = jit_o0(jax.grad(loss, has_aux=True))(
        variables["params"])
    tmodel.train()
    try:
        losses = make_yolox_loss_adapter(8, prefilter_topk=None)(
            tmodel(torch.from_numpy(images)),
            {k: torch.from_numpy(v) for k, v in batch.items()}, True)
        losses["total_loss"].backward()
    finally:
        tmodel.eval()
    assert float(losses["num_fg"]) == float(jlosses["num_fg"]) > 5
    for k in ("loss_iou", "loss_obj", "loss_cls", "loss_l1", "total_loss"):
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=1e-4, err_msg=k)
    want = twp.jax_to_torch_state_dict(
        numpy_variables({"params": jgrads,
                         "batch_stats": variables["batch_stats"]}),
        tmodel.state_dict(), mapper)
    top = max(float(np.abs(want[n]).max())
              for n, _ in tmodel.named_parameters())
    for name, p in tmodel.named_parameters():
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(p.grad.numpy() - want[name]).max())
        assert err <= 1e-3 * scale + 1e-6 * top, (name, err, scale)
    assert float(tmodel.backbone.stages[2][1].gamma.grad.abs().max()) > 0
