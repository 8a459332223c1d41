"""YOLOX-KPTS's feed, eval and builders in the port, against the JAX
package, on the CPU:

* ``SimpleDatasetMapper``'s keypoint path on a synthetic mini-COCO of
  persons (``write_mini_coco_keypoints``): every sample equal to the JAX
  mapper's under flips and shifts; then, with the flip forced, the left /
  right permutation, the keypoints of a dropped box gone with it, a
  keypoint out of the frame made invisible, the letterbox scale, and the
  ROADMAP.md C.23 case (an unlabelled keypoint at (0, 0) comes out at
  (w, 0) with v 0); the loader and ``CudaPrefetcher`` carry
  ``gt_keypoints``;
* ``oks_matrix`` and ``COCOKeypointEvaluator`` (copies) on built scenes:
  equal to the JAX package's;
* ``python -m yolov7_d2_tpu_torch.eval_coco`` on the mini-COCO at 64 px:
  the keys that ``tools/eval_coco.py`` prints, and the same numbers from
  ``--weights`` of the model's own state dict;
* the builders at full size: every parameter of ``build_model`` on
  ``yolox_kpts_swin.yaml``, ``yolox_kpts.yaml``, PVTv2-b1, and of YOLOV7
  on ``swin_t.yaml``, ``swin_s.yaml`` and ``pvt_v2_b0.yaml`` has its flax
  leaf of the same shape (``jax.eval_shape``); ``build_system`` trains each
  for a step; ``make_packed_photo_step`` refuses keypoints; the entry
  points want a card unless told otherwise.
"""

import dataclasses
import functools
import importlib.util
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    REPO,
    flax_variables_like,
    opts_list,
    write_mini_coco_keypoints,
)
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.data import mappers as jax_mappers
from yolov7_d2_tpu.data.coco import load_coco_json as jax_load_coco_json
from yolov7_d2_tpu.evaluation import coco_eval as jax_coco_eval
from yolov7_d2_tpu.models.build import build_model as jax_build_model
from yolov7_d2_tpu_torch import eval_coco
from yolov7_d2_tpu_torch.config import AnchorYoloConfig, YoloxKptsConfig
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data.coco import load_coco_json
from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
from yolov7_d2_tpu_torch.data.loader import (
    CudaPrefetcher,
    build_detection_test_loader,
)
from yolov7_d2_tpu_torch.data.mappers import (
    COCO_KP_HFLIP_17,
    SimpleDatasetMapper,
)
from yolov7_d2_tpu_torch.engine import KPTS_FIELDS, build_system
from yolov7_d2_tpu_torch.evaluation import coco_eval
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch import yolox_kpts as tk
from yolov7_d2_tpu_torch.utils.weight_port import (
    map_anchor_yolo_torch_name,
    map_yolox_kpts_torch_name,
)

COCO = REPO / "configs" / "coco"
# 64 px, one loader thread, the CPU; shifts push keypoints out of frame
FEED_OPTS = {
    "INPUT.INPUT_SIZE": [64, 64], "INPUT.MIN_SIZE_TRAIN": [64],
    "INPUT.MAX_SIZE_TRAIN": 128, "INPUT.MIN_SIZE_TEST": 64,
    "INPUT.MAX_SIZE_TEST": 128, "MODEL.YOLO.MAX_BOXES_NUM": 6,
    "INPUT.SHIFT.ENABLED": True, "INPUT.SHIFT.SHIFT_PIXELS": 12,
    "DATALOADER.NUM_WORKERS": 1,
}
EVAL_OPTS = {**FEED_OPTS, "MODEL.YOLO.WIDTH_MUL": 0.125,
             "MODEL.YOLO.CONF_THRESHOLD": 0.001, "SOLVER.AMP.ENABLED": False}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return write_mini_coco_keypoints(tmp_path_factory.mktemp("kptsmini"))


def _cfgs(yaml="yolox_kpts.yaml", **opts):
    """(port CfgNode, JAX CfgNode) of ``configs/coco/<yaml>`` with
    ``opts`` ({KEY: value}); MODEL.DEVICE only on the port's side."""
    out = []
    for make in (get_cfg, jax_get_cfg):
        cfg = make()
        cfg.merge_from_file(str(COCO / yaml))
        o = dict(opts)
        if make is jax_get_cfg:
            o.pop("MODEL.DEVICE", None)
        cfg.merge_from_list(opts_list(o))
        out.append(cfg)
    return out


def test_keypoint_mapper_matches_jax(mini):
    js, root = mini
    cfg, jcfg = _cfgs(**FEED_OPTS)
    records = load_coco_json(js, root)
    assert records == jax_load_coco_json(js, root)
    for is_train in (True, False):
        port = SimpleDatasetMapper(cfg, is_train, seed=3)
        ref = jax_mappers.SimpleDatasetMapper(jcfg, is_train, seed=3)
        flips = 0
        for _ in range(3):
            for r in records:
                got, want = port(r), ref(r)
                assert sorted(got) == sorted(want)
                assert "gt_keypoints" in got
                for k in want:
                    if k == "image":   # letterboxes may differ by one level
                        np.testing.assert_allclose(got[k], want[k], atol=1)
                    else:
                        np.testing.assert_array_equal(got[k], want[k],
                                                      err_msg=k)
                flips += bool((got["gt_keypoints"][..., 2] == 0).any())
        assert flips


def _forced(cfg, flip: bool):
    """The training mapper with the flip always or never, no shift."""
    cfg = cfg.clone()
    cfg.INPUT.SHIFT.ENABLED = False
    cfg.INPUT.RANDOM_FLIP_HORIZONTAL.PROB = 1.0 if flip else 0.0
    return SimpleDatasetMapper(cfg, is_train=True, seed=0)


def test_keypoint_mapper_geometry(mini):
    js, root = mini
    cfg, _ = _cfgs(**FEED_OPTS)
    records = load_coco_json(js, root)
    r0 = records[0]
    persons = [a for a in r0["annotations"] if not a["iscrowd"]]
    orig = np.asarray([a["keypoints"] for a in persons],
                      np.float32).reshape(len(persons), 17, 3)
    plain, flipped = _forced(cfg, False)(r0), _forced(cfg, True)(r0)
    for s in (plain, flipped):
        assert s["gt_keypoints"].shape == (6, 17, 3)
        assert s["gt_keypoints"].dtype == np.float32
    # the 0.5 px wide box is dropped, and its keypoints with it
    n = int(plain["gt_valid"].sum())
    assert n == len(persons) - 1
    keep = [i for i, a in enumerate(persons) if a["bbox"][2] > 1]
    np.testing.assert_array_equal(plain["gt_keypoints"][n:], 0.0)
    # the letterbox scale: back in the original pixels (resizes round)
    kp = plain["gt_keypoints"][:n]
    scale = float(plain["scale"])
    np.testing.assert_allclose(kp[..., :2] / scale, orig[keep, :, :2],
                               atol=0.6)
    # the keypoint beyond the right edge is invisible now, its x kept
    assert orig[0, 5, 2] == 2 and kp[0, 5, 2] == 0
    assert kp[0, 5, 0] / scale > r0["width"]
    inside = orig[keep, :, 2] > 0
    inside[0, 5] = False
    np.testing.assert_array_equal(kp[..., 2][inside], orig[keep][..., 2][
        inside])
    # the flip mirrors x and swaps left and right: x_flip + x = the
    # content's width, for every labelled keypoint of every person
    fk = flipped["gt_keypoints"][:n]
    np.testing.assert_array_equal(flipped["gt_boxes"][:n, [1, 3]],
                                  plain["gt_boxes"][:n, [1, 3]])
    mirrored = kp[:, COCO_KP_HFLIP_17]
    labelled = mirrored[..., 2] > 0
    total = fk[..., 0][labelled] + mirrored[..., 0][labelled]
    np.testing.assert_allclose(total, total[0], rtol=1e-5)
    np.testing.assert_array_equal(fk[..., 1][labelled],
                                  mirrored[..., 1][labelled])
    # C.23: an unlabelled keypoint (0, 0, 0) comes out at (w, 0) with v 0,
    # which the loss's x != 0 proxy counts as visible
    unlabelled = (mirrored[..., 2] == 0) & (mirrored[..., 0] == 0)
    assert unlabelled.any()
    np.testing.assert_allclose(fk[..., 0][unlabelled], total[0], rtol=1e-5)
    assert (fk[..., 1][unlabelled] == 0).all()
    assert (fk[..., 2][unlabelled] == 0).all()


def test_loader_and_prefetcher_carry_keypoints(mini):
    js, root = mini
    cfg, _ = _cfgs(**FEED_OPTS)
    records = load_coco_json(js, root)
    loader = build_detection_test_loader(
        cfg, records, SimpleDatasetMapper(cfg, is_train=False), 4)
    batch = next(iter(CudaPrefetcher(loader, "cpu", fields=KPTS_FIELDS)))
    assert sorted(batch) == sorted(KPTS_FIELDS)
    assert tuple(batch["gt_keypoints"].shape) == (4, 6, 17, 3)
    assert batch["gt_keypoints"].dtype == torch.float32


def _scene(rng, n_img=4):
    """Per image: gts [G, 17, 3] with areas and xywh boxes (one all
    invisible, one crowd), and detections near them with scores."""
    out = []
    for i in range(n_img):
        g = 3
        xy = rng.uniform(0, 200, (g, 2))
        wh = rng.uniform(20, 120, (g, 2))
        gk = np.concatenate([xy[:, None] + rng.uniform(0, 1, (g, 17, 2))
                             * wh[:, None],
                             rng.integers(0, 3, (g, 17, 1))], -1)
        if i == 0:
            gk[1, :, 2] = 0                   # no visible keypoint
        boxes = np.concatenate([xy, wh], -1)
        areas = wh.prod(-1) * rng.uniform(0.5, 1.0, g)
        crowd = np.array([False, False, i == 1])
        d = 5
        src = rng.integers(0, g, d)
        dk = gk[src].copy()
        dk[..., :2] += rng.normal(0, 4, (d, 17, 2))
        dk[..., 2] = rng.uniform(0, 1, (d, 17))
        out.append((gk, areas, boxes, crowd, dk, rng.uniform(0, 1, d)))
    return out


def test_oks_and_keypoint_evaluator_match_jax():
    scene = _scene(np.random.default_rng(21))
    for gk, areas, boxes, _, dk, _ in scene:
        np.testing.assert_array_equal(
            coco_eval.oks_matrix(dk, gk, areas, gt_boxes=boxes),
            jax_coco_eval.oks_matrix(dk, gk, areas, gt_boxes=boxes))
    results = []
    for mod in (coco_eval, jax_coco_eval):
        ev = mod.COCOKeypointEvaluator(1)
        for i, (gk, areas, boxes, crowd, dk, scores) in enumerate(scene):
            ev.add_gt_keypoints(i, gk, areas, boxes=boxes, iscrowd=crowd)
            ev.add_pred_keypoints(i, dk, scores)
        ev.add_gt_keypoints(9, scene[0][0], scene[0][1])   # boxes derived
        results.append(ev.evaluate())
    got, want = results
    assert sorted(got) == sorted(want)
    assert 0.0 < got["AP"] < 1.0
    for k in want:
        np.testing.assert_equal(got[k], want[k], err_msg=k)


def _keys(text: str):
    return [line.split(":")[0] for line in text.splitlines()
            if re.match(r"^(kpt_)?A[PR]\w*: ", line)]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_eval_coco", REPO / "tools" / "eval_coco.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_eval_coco_on_the_cpu(mini, tmp_path, capsys, monkeypatch):
    js, root = mini
    argv = ["--config-file", str(COCO / "yolox_kpts.yaml"), "--json", js,
            "--image-root", root, "--batch", "4"]
    opts = opts_list({**EVAL_OPTS, "MODEL.DEVICE": "cpu"})
    args = eval_coco.build_argument_parser().parse_args(argv + opts)
    got = eval_coco.main(args)
    printed = capsys.readouterr().out
    keys = _keys(printed)
    assert "kpt_AP" in keys and "AP" in keys
    assert set(got["keypoints"]) == {k[4:] for k in keys if
                                     k.startswith("kpt_")}
    # the JAX tool's keys, on the same data and options; its model's init
    # draws the variables with numpy (the flax init's op-by-op compile
    # costs 20 s here), the rest of the tool runs as it is
    from yolov7_d2_tpu.models import build as jax_build

    class CheapInit:
        def __init__(self, model):
            self.model = model

        def init(self, rng, x, train=False):
            return flax_variables_like(self.model, np.asarray(x),
                                       np.random.default_rng(0))

        def apply(self, *a, **kw):
            return self.model.apply(*a, **kw)

    jax_build_model_ = jax_build.build_model
    monkeypatch.setattr(jax_build, "build_model",
                        lambda cfg: CheapInit(jax_build_model_(cfg)))
    monkeypatch.setattr(sys, "argv", ["eval_coco.py"] + argv
                        + opts_list(EVAL_OPTS))
    _jax_tool().main()
    assert keys == _keys(capsys.readouterr().out)
    # --weights: a state dict with the reference's names (the port's own,
    # from seed 1) gives what the model drawn from seed 1 gives
    from yolov7_d2_tpu_torch.models import build as build_mod
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    model = build_model(YoloxKptsConfig.from_cfg(setup_cfg(args)), "cpu",
                        seed=1)
    path = tmp_path / "w.pth"
    torch.save({"model": model.state_dict()}, path)
    drawn = build_mod.build_model
    with monkeypatch.context() as mp:
        mp.setattr(build_mod, "build_model",
                   lambda cfg, device, seed=0: drawn(cfg, device, 1))
        want = eval_coco.main(args)
    capsys.readouterr()
    again = eval_coco.main(eval_coco.build_argument_parser().parse_args(
        argv + ["--weights", str(path)] + opts))
    out = capsys.readouterr().out
    assert "ported" in out and _keys(out) == keys
    for kind in ("bbox", "keypoints"):
        for k, v in want[kind].items():
            np.testing.assert_equal(again[kind][k], v, err_msg=k)


def test_eval_coco_wants_a_card_and_refuses_other_models(mini):
    js, root = mini
    base = ["--json", js, "--image-root", root]
    parse = eval_coco.build_argument_parser().parse_args
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="MODEL.DEVICE"):
            eval_coco.main(parse(["--config-file",
                                  str(COCO / "yolox_kpts.yaml")] + base))
    with pytest.raises(NotImplementedError, match="YOLOV7"):
        eval_coco.main(parse(["--config-file", str(COCO / "yolov7.yaml")]
                             + base + ["MODEL.DEVICE", "cpu"]))
    import inspect

    assert inspect.signature(tk.build_yolox_kpts).parameters[
        "device"].default == "cuda"


def _flax_shapes(jmodel):
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    flax = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                shapes.get(coll, {})):
            flax[tuple(str(getattr(k, "key", k)) for k in path)] = leaf.shape
    return flax


BUILDS = {
    "kpts_swin": ("yolox_kpts_swin.yaml", {}, "swin"),
    "kpts_cspdarknetx": ("yolox_kpts.yaml", {}, "cspdarknetx"),
    "kpts_pvt_v2_b1": ("yolox_kpts.yaml", {
        "MODEL.BACKBONE.NAME": "build_pvt_v2_backbone"}, "pvt_v2"),
    "yolov7_swin_t": ("swin_t.yaml", {}, "swin"),
    "yolov7_swin_s": ("swin_s.yaml", {}, "swin"),
    "yolov7_pvt_v2_b0": ("pvt_v2_b0.yaml", {}, "pvt_v2"),
}


@functools.lru_cache(maxsize=None)
def _built(name):
    yaml, opts, backbone = BUILDS[name]
    cfg, jcfg = _cfgs(yaml, **{"INPUT.INPUT_SIZE": [64, 64], **opts})
    kpts = cfg.MODEL.META_ARCHITECTURE == "YOLOX_KPTS"
    mcfg = (YoloxKptsConfig if kpts else AnchorYoloConfig).from_cfg(cfg)
    mapper = (functools.partial(map_yolox_kpts_torch_name,
                                backbone_type=backbone) if kpts else
              functools.partial(map_anchor_yolo_torch_name,
                                backbone_type=backbone))
    return cfg, jcfg, mcfg, mapper


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builders_match_jax_at_full_size(name):
    """Every parameter and statistic of the full-size model has its flax
    leaf, of the same shape, and no flax leaf is left over."""
    cfg, jcfg, mcfg, mapper = _built(name)
    model = build_model(mcfg, "cpu")
    assert model.dtype == torch.bfloat16     # SOLVER.AMP.ENABLED
    flax = _flax_shapes(jax_build_model(jcfg))
    names = {"weight": ("kernel", "scale"), "bias": ("bias",),
             "running_mean": ("mean",), "running_var": ("var",),
             "relative_position_bias_table": ("rel_pos_bias",)}
    for key, value in model.state_dict().items():
        module, _, leaf = key.rpartition(".")
        if leaf in ("num_batches_tracked", "relative_position_index"):
            continue
        path = mapper(module)
        found = [path + (n,) for n in names[leaf] if path + (n,) in flax]
        assert len(found) == 1, key
        shape = flax.pop(found[0])
        if len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        elif len(shape) == 2 and found[0][-1] == "kernel":
            shape = shape[::-1]
        assert tuple(value.shape) == tuple(shape), key
    assert not flax, list(flax)[:5]


def _train_batch(rng, keypoints: bool):
    boxes = np.array([[[8, 10, 40, 50], [30, 4, 60, 30], [0, 0, 0, 0]]] * 2,
                     np.float32)
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)),
        "gt_boxes": torch.from_numpy(boxes),
        "gt_classes": torch.zeros((2, 3), dtype=torch.int32),
        "gt_valid": torch.tensor([[True, True, False]] * 2)}
    if keypoints:
        kp = np.zeros((2, 3, 17, 3), np.float32)
        kp[:, :2, :, 0] = rng.uniform(10, 40, (2, 2, 17))
        kp[:, :2, :, 1] = rng.uniform(10, 40, (2, 2, 17))
        kp[:, :2, :, 2] = 2.0
        batch["gt_keypoints"] = torch.from_numpy(kp)
    return batch


@pytest.mark.parametrize("name", ["kpts_swin", "yolov7_swin_s",
                                  "yolov7_pvt_v2_b0"])
def test_build_system_trains_a_step(name):
    """``build_system`` on the CfgNode at 64 px, f32: one step of 2 images
    on the CPU, finite losses, moved weights; YOLOX_KPTS takes
    ``gt_keypoints`` and its loss reads them."""
    cfg = _built(name)[0].clone()
    cfg.SOLVER.AMP.ENABLED = False
    cfg.SOLVER.WARMUP_ITERS = 0
    kpts = cfg.MODEL.META_ARCHITECTURE == "YOLOX_KPTS"
    model, state, step, fields = build_system(cfg, device="cpu")
    assert fields == (KPTS_FIELDS if kpts else KPTS_FIELDS[:-1])
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = step(state, _train_batch(np.random.default_rng(0),
                                              kpts))
    for k, v in metrics.items():
        assert bool(torch.isfinite(v)), k
    if kpts:
        assert float(metrics["loss_kpt"]) > 0
        assert float(metrics["num_fg"]) >= 2
    assert any(not torch.equal(a, b) for a, b in
               zip(before, model.parameters()))


def test_packed_photo_step_refuses_keypoints():
    cfg = dataclasses.replace(YoloxKptsConfig(), amp=False)

    def step(state, batch):
        raise AssertionError("not reached")

    wrapped = make_packed_photo_step(cfg, step)
    with pytest.raises(NotImplementedError, match="keypoints"):
        wrapped(None, _train_batch(np.random.default_rng(0), True))
