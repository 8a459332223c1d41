"""The port's SparseInst feed, evaluator and ``train_inseg`` against the JAX
package, on the CPU: the transforms' ``apply_segmentation``,
``blend_mosaic4``, ``polygons_to_mask``, the mask path of
``SimpleDatasetMapper`` and ``DarknetMosaicDatasetMapper`` (samples equal
for the same seed, both with the cv2 letterbox), the collate that cuts the
ground-truth slots (losses and assignments equal to the full slots'),
``COCOMaskEvaluator`` (the same metric dict) and the CLI at a tiny size.
Every comparison with the JAX package is exact unless it says otherwise.
"""

import json

import numpy as np
import pytest
import torch

from _torch_port_helpers import REPO, assert_batches_equal, opts_list
from _torch_port_helpers import write_mini_coco
from yolov7_d2_tpu.config import get_cfg as jax_get_cfg
from yolov7_d2_tpu.data import mappers as jax_mappers
from yolov7_d2_tpu.data.transforms import api as jax_api
from yolov7_d2_tpu.data.transforms import augment as jax_aug
from yolov7_d2_tpu.evaluation import coco_eval as jax_eval
from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.data import coco, mappers
from yolov7_d2_tpu_torch.data.loader import stack_batch, stack_mask_batch
from yolov7_d2_tpu_torch.data.transforms import api, augment
from yolov7_d2_tpu_torch.evaluation import coco_eval
from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as tsi

BASE_YAML = str(REPO / "configs" / "coco" / "sparseinst" /
                "sparse_inst_r50_base.yaml")
# SparseInst at 64 px, 2 classes, 8 slots, mosaic on, f32, one thread
TINY = {
    "MODEL.SPARSE_INST.DECODER.NUM_CLASSES": 2,
    "MODEL.YOLO.MAX_BOXES_NUM": 8,
    "INPUT.INPUT_SIZE": [64, 64],
    "INPUT.MIN_SIZE_TRAIN": [64],
    "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64,
    "INPUT.MAX_SIZE_TEST": 128,
    "INPUT.MOSAIC.ENABLED": True,
    "INPUT.MOSAIC.MOSAIC_HEIGHT": 64,
    "INPUT.MOSAIC.MOSAIC_WIDTH": 64,
    "SOLVER.IMS_PER_BATCH": 2,
    "SOLVER.AMP.ENABLED": False,
    "DATALOADER.NUM_WORKERS": 1,
}


def write_mini_coco_segm(root, n: int = 8, seed: int = 7):
    """The helpers' mini-COCO with a polygon for every box: the box with
    its lower-right corner cut off (not a rectangle, so that a mask is
    not its box)."""
    js, img_dir = write_mini_coco(root, n=n, seed=seed)
    data = json.loads(open(js).read())
    for a in data["annotations"]:
        x, y, w, h = a["bbox"]
        a["segmentation"] = [[x, y, x + w, y, x + w, y + 0.6 * h,
                              x + 0.6 * w, y + h, x, y + h]]
    with open(js, "w") as f:
        f.write(json.dumps(data))
    return js, img_dir


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    js, root = write_mini_coco_segm(tmp_path_factory.mktemp("segm"), n=10)
    return js, root, coco.load_coco_json(js, root, "port_segm_records")


def _cfgs(**extra):
    opts = dict(TINY, **{k.replace("__", "."): v for k, v in extra.items()})
    out = []
    for fn in (get_cfg, jax_get_cfg):
        cfg = fn()
        cfg.merge_from_file(BASE_YAML)
        cfg.merge_from_list(opts_list(opts))
        out.append(cfg)
    return out


def _masks(rng, n=3, h=23, w=31):
    return [(rng.random((h, w)) > 0.6).astype(np.uint8) for _ in range(n)]


def test_apply_segmentation_matches_jax():
    rng = np.random.default_rng(0)
    mask = _masks(rng, 1)[0]
    pairs = [
        (api.NoOpTransform(), jax_api.NoOpTransform()),
        (api.HFlipTransform(31), jax_api.HFlipTransform(31)),
        (api.VFlipTransform(23), jax_api.VFlipTransform(23)),
        (api.ResizeTransform(23, 31, 40, 17),
         jax_api.ResizeTransform(23, 31, 40, 17)),
        (api.CropTransform(3, 4, 20, 11), jax_api.CropTransform(3, 4, 20, 11)),
        (api.ShiftTransform(-5, 3), jax_api.ShiftTransform(-5, 3)),
        (api.PhotometricTransform(lambda x: x * 0),
         jax_api.PhotometricTransform(lambda x: x * 0)),
    ]
    for ours, theirs in pairs:
        got, want = ours.apply_segmentation(mask), \
            theirs.apply_segmentation(mask)
        assert got.dtype == want.dtype, type(ours).__name__
        np.testing.assert_array_equal(got, want, type(ours).__name__)


@pytest.mark.parametrize("with_masks", [True, False])
def test_blend_mosaic4_matches_jax(with_masks):
    rng = np.random.default_rng(1)
    tiles = []
    for i, (h, w) in enumerate([(70, 90), (40, 50), (64, 64), (100, 60)]):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        boxes = np.array([[2, 3, w - 5, h // 2], [w // 3, h // 3, w - 1, h - 2]],
                         np.float32)
        classes = np.array([i % 2, 1], np.int64)
        masks = _masks(rng, 2, h, w) if with_masks else None
        tiles.append((img, boxes, classes, masks))
    got = augment.blend_mosaic4(tiles, (64, 64), 0.2,
                                np.random.default_rng(5))
    want = jax_aug.blend_mosaic4(tiles, (64, 64), 0.2,
                                 np.random.default_rng(5))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    if with_masks:
        assert len(got[3]) == len(want[3]) == len(got[1]) > 0
        for g, w in zip(got[3], want[3]):
            np.testing.assert_array_equal(g, w)
    else:
        assert got[3] is None and want[3] is None


def test_polygons_to_mask_matches_jax():
    polys = [[1.2, 2.0, 30.7, 4.1, 20.0, 25.5, 3.0, 18.0],
             [35, 5, 45, 5, 45, 15]]
    got = coco_eval.polygons_to_mask(polys, 30, 50)
    want = jax_eval.polygons_to_mask(polys, 30, 50)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 200 < got.sum() < 1500


def test_mask_mappers_match_jax(mini, monkeypatch):
    """The plain mask path (the eval mapper) and the blend-mosaic mapper
    (its pool, coin flips and re-augmented tiles) emit equal samples for
    the same seed over the same records, cv2 letterbox on both sides."""
    _, _, records = mini
    monkeypatch.setattr(mappers, "_NATIVE", False)
    monkeypatch.setattr(jax_mappers, "_NATIVE", False)
    ours_cfg, jax_cfg = _cfgs()
    for cls_ours, cls_jax, train in (
            (mappers.SimpleDatasetMapper, jax_mappers.SimpleDatasetMapper,
             False),
            (mappers.DarknetMosaicDatasetMapper,
             jax_mappers.DarknetMosaicDatasetMapper, True)):
        ours = cls_ours(ours_cfg, is_train=train, seed=3, with_masks=True)
        theirs = cls_jax(jax_cfg, is_train=train, seed=3, with_masks=True)
        blended = 0
        for r in records * 2:
            got, want = ours(r), theirs(r)
            assert sorted(got) == sorted(want)
            assert_batches_equal(got, want)
            assert got["gt_masks"].shape == (8, 64, 64)
            assert got["gt_masks"].dtype == np.uint8
            n = int(got["gt_valid"].sum())
            assert got["gt_masks"][:n].any((1, 2)).all()
            assert not got["gt_masks"][n:].any()
            blended += float(got["scale"]) == 1.0 and train
        if train:
            assert blended > 0  # some samples went through blend_mosaic4


def _slots(rng, b=3, g=8, size=64):
    masks = np.zeros((b, g, size, size), np.uint8)
    cls = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate((2, 5, 1)):
        for j in range(n):
            y0, x0 = rng.integers(0, size - 16, 2)
            masks[i, j, y0:y0 + 12, x0:x0 + 9] = 1
        cls[i, :n] = rng.integers(0, 80, n)
        valid[i, :n] = True
    return masks, cls, valid


def test_cut_slots_give_the_same_losses_and_assignments():
    """``stack_mask_batch`` keeps the first max(valid) slots (5 of 8
    here): the auction's assignments are equal and the losses equal to
    float32 rounding (sums over fewer zero terms)."""
    rng = np.random.default_rng(2)
    masks, cls, valid = _slots(rng)
    samples = [{"image": rng.integers(0, 256, (64, 64, 3)).astype(np.float32),
                "gt_masks": m, "gt_classes": c, "gt_valid": v,
                "gt_boxes": np.zeros((8, 4), np.float32)}
               for m, c, v in zip(masks, cls, valid)]
    full, cut = stack_batch(samples), stack_mask_batch(samples)
    assert cut["image"].dtype == np.uint8
    np.testing.assert_array_equal(cut["image"], full["image"])
    assert cut["gt_masks"].shape == (3, 5, 64, 64)
    out = {"cls_logits": torch.from_numpy(
               rng.normal(-2, 1, (3, 100, 80)).astype(np.float32)),
           "obj_logits": torch.from_numpy(
               rng.normal(0, 1, (3, 100)).astype(np.float32)),
           "mask_logits": torch.from_numpy(
               rng.normal(0, 2, (3, 100, 16, 16)).astype(np.float32))}
    res = {}
    for name, batch in (("full", full), ("cut", cut)):
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        small = tsi._resize(t["gt_masks"].float(), (16, 16))
        pred, ok, _ = tsi.sparseinst_match(out, small, t["gt_classes"],
                                           t["gt_valid"])
        res[name] = (pred[:, :5], ok[:, :5], tsi.sparseinst_losses(
            out, t["gt_masks"], t["gt_classes"], t["gt_valid"], 80))
    assert torch.equal(res["full"][0], res["cut"][0])
    assert torch.equal(res["full"][1], res["cut"][1])
    for k, v in res["full"][2].items():
        if k == "match":  # the assignments, held above
            continue
        np.testing.assert_allclose(float(res["cut"][2][k]), float(v),
                                   rtol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="integers"):
        stack_mask_batch([dict(samples[0], image=samples[0]["image"] + 0.5)])


def test_coco_mask_evaluator_matches_jax():
    rng = np.random.default_rng(4)
    ours, theirs = coco_eval.COCOMaskEvaluator(3), jax_eval.COCOMaskEvaluator(3)
    for img in range(5):
        h, w = 40 + img * 7, 60
        gm = [(rng.random((h, w)) > 0.5) & (np.arange(w) < 10 * (k + 2))
              for k in range(3)]
        gcls = np.array([0, 1, img % 3])
        gboxes = np.tile([0.0, 0.0, 10.0, 10.0], (3, 1))
        crowd = np.array([False, False, img == 2])
        areas = np.array([m.sum() for m in gm], np.float64)
        dm = [m if rng.random() < 0.6 else rng.random((h, w)) > 0.5
              for m in gm] + [rng.random((h, w)) > 0.7]
        scores = rng.random(4)
        dcls = np.array([0, 1, img % 3, 2])
        for ev in (ours, theirs):
            ev.add_gt(img, gboxes, gcls, iscrowd=crowd, areas=areas,
                      masks=gm)
            ev.add_predictions(img, np.tile([0.0, 0.0, 5.0, 5.0], (4, 1)),
                               scores, dcls, masks=dm)
    got, want = ours.evaluate(), theirs.evaluate()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_equal(got[k], want[k])
    assert got["AP"] > 0


def test_train_inseg_on_the_cpu(mini, tmp_path, monkeypatch):
    """``train_inseg`` on the mini-COCO at 64 px (full-width ResNet-50 and
    decoders): 2 steps with checkpoints at 1 and 2, the blend mosaic on,
    finite losses; ``--resume`` to 3; ``--eval-only`` gives the segm keys;
    ``--num-gpus 2`` on the cards with fewer than 2 visible and a
    detector's config raise (the gloo ranks on the CPU are
    ``tests/test_torch_port_dist_families.py``'s)."""
    from yolov7_d2_tpu_torch import train_inseg
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    js, root, _ = mini
    register_coco_instances("inseg_cli_mini", {}, js, root)
    try:
        opts = dict(TINY, **{
            "MODEL.DEVICE": "cpu", "SOLVER.MAX_ITER": 2,
            "SOLVER.CHECKPOINT_PERIOD": 1,
            "DATASETS.TRAIN": "('inseg_cli_mini',)",
            "DATASETS.TEST": "('inseg_cli_mini',)",
            "OUTPUT_DIR": str(tmp_path / "out")})

        def args(*flags, **more):
            argv = ["--config-file", BASE_YAML, *flags] + opts_list(
                dict(opts, **more))
            return default_argument_parser().parse_args(argv)

        trainer = train_inseg.main(args())
        last = trainer.storage.latest()
        for k in ("loss_ce", "loss_dice", "loss_mask", "loss_objectness",
                  "total_loss", "grad_norm"):
            assert np.isfinite(last[k]), k
        assert last["num_inst"] >= 1 and last["match_iters"] >= 1
        ckpts = sorted(p.name for p in (tmp_path / "out" / "ckpt").iterdir())
        assert ckpts == ["ckpt_00000001.pt", "ckpt_00000002.pt"]
        again = train_inseg.main(args("--resume", **{"SOLVER.MAX_ITER": 3}))
        assert again.start_iter == 2 and again.state.step == 3
        res = train_inseg.main(args("--eval-only"))
        assert {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR100"} <= \
            set(res)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="--num-gpus 2"):
            train_inseg.main(args("--num-gpus", "2",
                                  **{"MODEL.DEVICE": "cuda"}))
        det = default_argument_parser().parse_args(
            ["--config-file", str(REPO / "configs" / "coco" /
                                  "yolox_s.yaml"), "MODEL.DEVICE", "cpu"])
        with pytest.raises(NotImplementedError, match="SparseInst"):
            train_inseg.main(det)
    finally:
        DatasetCatalog.remove("inseg_cli_mini")
