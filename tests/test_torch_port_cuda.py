"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one. The file imports no
JAX, so that it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

The kernels must agree exactly: the NMS kernel index for index (it does the
plain version's IEEE float32 operations, one rounding each), the normalize
and GridMask kernels bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.data.device_aug import (
    make_packed_photo_step,
    sample_grid_mask_params,
)
from yolov7_d2_tpu_torch.engine import build_yolox_system, dummy_batch
from yolov7_d2_tpu_torch.kernels import build
from yolov7_d2_tpu_torch.kernels.grid_mask import grid_mask, grid_mask_plain
from yolov7_d2_tpu_torch.kernels.nms import nms_batched, nms_batched_plain
from yolov7_d2_tpu_torch.kernels.preprocess import (
    normalize_images,
    normalize_images_plain,
)
from yolov7_d2_tpu_torch.ops.nms import batched_nms_batched
from yolov7_d2_tpu_torch.predictor import Predictor

PIXEL_MEAN = (103.53, 116.28, 123.675)
PIXEL_STD = (57.375, 57.12, 58.395)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda", 0)


def _nms_inputs(dev, b, n, seed=0, classes=80):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 640, (b, n // 8 + 1, 2)).repeat(8, 1)[:, :n]
    centers = centers + rng.normal(0, 6, (b, n, 2))
    wh = rng.uniform(8, 120, (b, n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = rng.uniform(0.0, 1.0, (b, n))
    scores[:, 1::4] = scores[:, 0:n - 1:4][:, :scores[:, 1::4].shape[1]]
    scores[:, : n // 10] = 0.0
    cls = rng.integers(0, classes, (b, n))
    return (torch.tensor(boxes, dtype=torch.float32, device=dev),
            torch.tensor(scores, dtype=torch.float32, device=dev),
            torch.tensor(cls, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,max_out,thr", [
    (8, 1024, 100, 0.65), (8, 1024, 100, 0.3), (3, 300, 100, 0.65),
    (2, 17, 32, 0.5),
])
def test_nms_kernel_matches_plain(dev, b, n, max_out, thr):
    boxes, scores, cls = _nms_inputs(dev, b, n)
    before = build.LAUNCHES["nms"]
    got = batched_nms_batched(boxes, scores, cls, thr, max_out)
    want = batched_nms_batched(boxes, scores, cls, thr, max_out,
                               nms=nms_batched_plain)
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _assert_nms_matches_plain(boxes, scores, thr, max_out):
    before = build.LAUNCHES["nms"]
    got = nms_batched(boxes, scores, thr, max_out)
    want = nms_batched_plain(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,max_out", [
    (1, 1024, 100), (3, 1, 5), (2, 33, 20), (2, 200, 300), (4, 1024, 1),
])
def test_nms_kernel_shapes(dev, b, n, max_out):
    boxes, scores, cls = _nms_inputs(dev, b, n, seed=n)
    shifted = boxes + cls[..., None].float() * (boxes.max() + 1.0)
    _assert_nms_matches_plain(shifted, scores, 0.5, max_out)


@pytest.mark.cuda
def test_nms_kernel_single_class_heavy_suppression(dev):
    """1024 boxes crowded around one point, one class: fewer than max_out
    survive, so the kernel scans every tile of 32."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(200, 440, (8, 1024, 2))
    wh = rng.uniform(40, 160, (8, 1024, 2))
    boxes = torch.tensor(np.concatenate([centers - wh / 2, centers + wh / 2],
                                        -1), dtype=torch.float32, device=dev)
    scores = torch.tensor(rng.uniform(0.01, 1.0, (8, 1024)),
                          dtype=torch.float32, device=dev)
    _, valid = _assert_nms_matches_plain(boxes, scores, 0.3, 100)
    assert 0 < int(valid.sum(1).max()) < 100


@pytest.mark.cuda
def test_nms_kernel_ties_across_tile_boundary(dev):
    """One score for all 64 boxes, so the order is the index order; the
    pairs (31, 32) and (20, 40) share a box: the lower index wins."""
    pos = torch.arange(64, dtype=torch.float32)
    x0, y0 = (pos % 8) * 20, (pos // 8) * 20
    boxes = torch.stack([x0, y0, x0 + 10, y0 + 10], -1)
    boxes[32], boxes[40] = boxes[31], boxes[20]
    boxes = boxes[None].to(dev).contiguous()
    scores = torch.full((1, 64), 0.5, device=dev)
    idx, valid = _assert_nms_matches_plain(boxes, scores, 0.5, 64)
    kept = idx[valid].tolist()
    assert 31 in kept and 20 in kept and 32 not in kept and 40 not in kept
    assert len(kept) == 62


@pytest.mark.cuda
def test_nms_kernel_iou_at_threshold(dev):
    """IoU exactly 0.5 (inter 1, union 2) does not suppress at 0.5."""
    boxes = torch.tensor([[[0.0, 0.0, 2.0, 1.0], [0.0, 0.0, 1.0, 1.0]]],
                         device=dev)
    scores = torch.tensor([[0.9, 0.8]], device=dev)
    idx, valid = _assert_nms_matches_plain(boxes, scores, 0.5, 4)
    assert idx[0].tolist() == [0, 1, -1, -1] and int(valid.sum()) == 2


@pytest.mark.cuda
def test_nms_kernel_all_dead(dev):
    boxes, scores, _ = _nms_inputs(dev, 2, 64)
    idx, valid = nms_batched(boxes, torch.zeros_like(scores), 0.5, 16)
    assert (idx == -1).all() and not valid.any()


@pytest.mark.cuda
def test_nms_kernel_refuses_what_it_cannot_take(dev):
    boxes, scores, _ = _nms_inputs(dev, 1, 1032)
    with pytest.raises(ValueError, match="candidates"):
        nms_batched(boxes, scores, 0.5, 10)
    with pytest.raises(TypeError):
        nms_batched(boxes[:, :64].double(), scores[:, :64].double(), 0.5, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stats", ["identity", "pixel"])
def test_normalize_kernel_matches_plain(dev, out_dtype, stats):
    mean, std = ((0.0,) * 3, (1.0,) * 3) if stats == "identity" \
        else (PIXEL_MEAN, PIXEL_STD)
    imgs = torch.randint(0, 256, (3, 64, 48, 3), dtype=torch.uint8,
                         device=dev)
    got = normalize_images(imgs, mean, std, out_dtype)
    want = normalize_images_plain(imgs, mean, std, out_dtype)
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_normalize_kernel_refuses_odd_plane(dev):
    imgs = torch.zeros((1, 5, 5, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        normalize_images(imgs, (0.0,) * 3, (1.0,) * 3)


@pytest.mark.cuda
def test_predict_batch_on_card_launches_both_kernels(dev):
    cfg = dataclasses.replace(YoloxConfig(), num_classes=8, width_mul=0.25,
                              input_size=(128, 128))
    predictor = Predictor(cfg, device=dev, seed=0)
    images = torch.randint(0, 256, (4, 128, 128, 3), dtype=torch.uint8)
    build.reset_launches()
    dets = predictor.predict_batch(images)
    torch.cuda.synchronize()
    assert build.LAUNCHES["normalize"] == 1 and build.LAUNCHES["nms"] == 1
    assert dets.boxes.shape == (4, 100, 4) and bool(dets.valid.any())
    head = predictor.forward(images)
    plain = predictor.postprocess(head, nms=nms_batched_plain)
    kernel = predictor.postprocess(head)
    for field in ("valid", "classes", "boxes", "scores"):
        assert torch.equal(getattr(kernel, field), getattr(plain, field))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(6, 48, 64, 3), (3, 40, 24, 4)])
def test_grid_mask_kernel_matches_plain(dev, dtype, shape):
    gen = torch.Generator().manual_seed(0)
    params = sample_grid_mask_params(gen, shape[0], *shape[1:3], prob=0.8)
    params[::2, 4] = torch.where(params[::2, 0] > 1, 0, params[::2, 4])
    imgs = (torch.randint(0, 256, shape, generator=gen, dtype=dtype)
            if dtype == torch.uint8 else torch.randn(shape, generator=gen))
    imgs, params = imgs.to(dev), params.to(dev)
    before = build.LAUNCHES["grid_mask"]
    got = grid_mask(imgs, params)
    want = grid_mask_plain(imgs, params)
    torch.cuda.synchronize()
    assert build.LAUNCHES["grid_mask"] == before + 1
    assert torch.equal(got, want) and bool((got == 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("params", [
    [(8, 4, -3, -11, 1), (5, 2, -7, 4, 0)],  # negative offsets
    [(1, 1, 0, 0, 0), (1, 0, 3, -2, 0)],     # d = 1: nothing or all zeroed
    [(7, 3, 2, 5, 1), (3, 1, -1, -1, 0)],
])
def test_grid_mask_kernel_rows_across_chunks(dev, dtype, params):
    """[2, 40, 40, 3]: a uint8 row is 120 bytes, not a multiple of the 16
    bytes a thread takes, so chunks cross rows."""
    gen = torch.Generator().manual_seed(1)
    shape = (2, 40, 40, 3)
    imgs = (torch.randint(1, 256, shape, generator=gen, dtype=dtype)
            if dtype == torch.uint8 else torch.rand(shape, generator=gen) + 1)
    imgs = imgs.to(dev)
    p = torch.tensor(params, dtype=torch.int32, device=dev)
    got = grid_mask(imgs, p)
    want = grid_mask_plain(imgs, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if params[0][0] == 1:
        assert torch.equal(got[0], imgs[0]) and not bool(got[1].any())


@pytest.mark.cuda
def test_grid_mask_kernel_refuses_what_it_cannot_take(dev):
    params = torch.ones((1, 5), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        grid_mask(torch.zeros((1, 5, 5, 3), dtype=torch.uint8, device=dev),
                  params)
    with pytest.raises(TypeError):
        grid_mask(torch.zeros((1, 8, 8, 3), dtype=torch.float64,
                              device=dev), params)
    with pytest.raises(TypeError):
        grid_mask(torch.zeros((1, 8, 8, 3), device=dev), params.long())


@pytest.mark.cuda
def test_train_step_on_card_launches_grid_mask(dev):
    cfg = dataclasses.replace(YoloxConfig(), num_classes=8, width_mul=0.25,
                              input_size=(128, 128), grid_mask=True,
                              grid_mask_prob=1.0)
    _, state, train_step = build_yolox_system(cfg, device=dev, seed=0)
    step = make_packed_photo_step(cfg, train_step)
    batch = dummy_batch(cfg, 2, device=dev)
    build.reset_launches()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert build.LAUNCHES["grid_mask"] == 1 and metrics["grid_masked"] == 2
    assert bool(torch.isfinite(metrics["total_loss"]))
    assert float(metrics["num_fg"]) > 1 and state.step == 1


@pytest.mark.cuda
def test_simota_takes_first_index_on_ties_on_card(dev):
    """argmin / argmax keep the first index on ties on the card as on the
    CPU: two identical gts claim the same anchors, groups of anchors share
    one prediction, and the assignment must equal the CPU's exactly."""
    from yolov7_d2_tpu_torch.models.heads.yolox_head import (
        decode_outputs,
        simota_assign,
    )

    gen = torch.Generator().manual_seed(0)
    size, classes = 128, 8
    grids, strides = [], []
    for s in (8, 16, 32):
        n = size // s
        ys, xs = torch.meshgrid(torch.arange(n), torch.arange(n),
                                indexing="ij")
        grids.append(torch.stack([xs, ys], -1).reshape(-1, 2).float())
        strides.append(torch.full((n * n,), float(s)))
    grids, strides = torch.cat(grids), torch.cat(strides)
    out = torch.randn((2, len(strides), 5 + classes), generator=gen)
    # stride-8 anchors of cells 2..8 all decode to the box of the first
    # two gts (centre 40, 48 px) with one score: tied IoUs and costs
    near = ((grids[:, 0] >= 2) & (grids[:, 0] <= 8) & (grids[:, 1] >= 2)
            & (grids[:, 1] <= 8) & (strides == 8)).nonzero()[:, 0]
    out[:, near, 0:2] = 5.0 - grids[near]
    out[:, near, 2:4] = float(np.log(6.0))
    out[:, near, 4:] = out[:, near[:1], 4:]
    gt = torch.tensor([[16.0, 16.0, 64.0, 64.0]] * 2
                      + [[70.0, 60.0, 120.0, 110.0]])[None].repeat(2, 1, 1)
    cls = torch.tensor([[3, 3, 5]] * 2, dtype=torch.int32)
    valid = torch.ones((2, 3), dtype=torch.bool)

    def assign(device):
        args = [t.to(device) for t in (out, grids, strides, gt, cls, valid)]
        boxes, obj, logits = decode_outputs(*args[:3])
        return simota_assign(boxes, obj, logits, *args[1:])

    cpu, card = assign("cpu"), assign(dev)
    for key in ("fg_mask", "matched_gt"):
        assert torch.equal(card[key].cpu(), cpu[key]), key
    assert int(cpu["fg_mask"].sum()) > 4
    assert not bool((cpu["matched_gt"][cpu["fg_mask"]] == 1).any())
    x = torch.tensor([[2.0, 1.0, 1.0], [1.0, 1.0, 3.0]], device=dev)
    assert x.argmin(-1).tolist() == [1, 0] and x.argmax(-1).tolist() == [0, 2]


@pytest.mark.cuda
def test_cuda_prefetcher_hands_out_the_loader_batches(dev):
    """Each batch reaches the step whole: the step's stream waits for the
    side stream's copy, and a batch's memory is not reused while a step
    still reads it. Checksums queued on the current stream right after each
    batch is handed out, and big allocations made between batches, must
    give the host arrays' sums."""
    from yolov7_d2_tpu_torch.data.loader import CudaPrefetcher

    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (16, 256, 256, 3),
                                      dtype=np.uint8),
                "gt_boxes": rng.random((16, 100, 4)).astype(np.float32),
                "image_id": np.arange(16)} for _ in range(6)]
    sums = []
    for batch in CudaPrefetcher(batches, dev, ("image", "gt_boxes")):
        assert sorted(batch) == ["gt_boxes", "image"]
        assert all(t.device == dev for t in batch.values())
        sums.append([batch["image"].double().sum(),
                     batch["gt_boxes"].double().sum()])
        torch.empty((64, 1024, 1024), device=dev).fill_(7.0)
    torch.cuda.synchronize()
    for got, want in zip(sums, batches):
        assert float(got[0]) == float(want["image"].astype(np.float64).sum())
        assert float(got[1]) == pytest.approx(
            float(want["gt_boxes"].astype(np.float64).sum()), rel=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("feed", ["host_mosaic", "packed"])
def test_train_det_on_card_launches_the_cli_kernels(dev, tmp_path, feed):
    """``train_det.main`` on the card at tiny size (YOLOX-s cut to 64 px,
    width 0.125, 8 images): 6 steps and the COCO eval; GridMask runs in the
    packed step before DISABLE_AT_ITER, normalize and NMS once an eval
    batch."""
    from _torch_port_helpers import (
        TINY_OPTS,
        YOLOX_S_YAML,
        opts_list,
        tiny_cfg,
        write_mini_coco,
    )
    from yolov7_d2_tpu_torch import train_det
    from yolov7_d2_tpu_torch.config.defaults import get_cfg
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.data.coco import load_coco_json
    from yolov7_d2_tpu_torch.data.packed_cache import (
        write_geometry_shards,
        write_plain_shards,
    )
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    js, root = write_mini_coco(tmp_path)
    name = f"card_mini_{feed}"
    register_coco_instances(name, {}, js, root)
    opts = dict(TINY_OPTS, **{
        "MODEL.DEVICE": "cuda", "DATASETS.TRAIN": (name,),
        "DATASETS.TEST": (name,), "OUTPUT_DIR": str(tmp_path / "out"),
        "SOLVER.MAX_ITER": 6, "SOLVER.CHECKPOINT_PERIOD": 3,
        "TEST.EVAL_PERIOD": 6})
    if feed == "packed":
        cfg = tiny_cfg(get_cfg)
        cfg.freeze()
        records = load_coco_json(js, root)
        write_geometry_shards(records, cfg, str(tmp_path / "geo"))
        write_plain_shards(records, cfg, str(tmp_path / "plain"))
        opts.update({"DATALOADER.PACKED_CACHE_DIR": str(tmp_path / "geo"),
                     "DATALOADER.PACKED_CACHE_PLAIN_DIR":
                         str(tmp_path / "plain"),
                     "INPUT.GRID_MASK.ENABLED": True,
                     "INPUT.MOSAIC_AND_MIXUP.DISABLE_AT_ITER": 3})
    args = default_argument_parser().parse_args(
        ["--config-file", YOLOX_S_YAML, *opts_list(opts)])
    build.reset_launches()
    try:
        trainer = train_det.main(args)
    finally:
        DatasetCatalog.remove(name)
    torch.cuda.synchronize()
    latest = trainer.storage.latest()
    assert np.isfinite(latest["total_loss"]) and "eval/AP" in latest
    assert next(trainer.state.model.parameters()).device == dev
    # 8 images, 4 a batch: 2 eval batches; the packed feed's plain uint8
    # images go through the normalize kernel at steps 3-5
    want = {"normalize": 2, "nms": 2}
    if feed == "packed":
        want = {"grid_mask": 3, "normalize": 2 + 3, "nms": 2}
    assert dict(build.LAUNCHES) == want
