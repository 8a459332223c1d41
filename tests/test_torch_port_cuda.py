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
    (2, 17, 32, 0.5), (8, 1280, 128, 0.7), (4, 2048, 100, 0.3),
])
def test_nms_kernel_matches_plain(dev, b, n, max_out, thr):
    boxes, scores, cls = _nms_inputs(dev, b, n)
    key = _instance(n)
    before = build.LAUNCHES[key]
    got = batched_nms_batched(boxes, scores, cls, thr, max_out)
    want = batched_nms_batched(boxes, scores, cls, thr, max_out,
                               nms=nms_batched_plain)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _instance(n: int) -> str:
    """The launch count of the kernel instance that holds n candidates."""
    return "nms" if n <= 1024 else "nms_2048"


def _assert_nms_matches_plain(boxes, scores, thr, max_out):
    key = _instance(scores.shape[1])
    before = build.LAUNCHES[key]
    got = nms_batched(boxes, scores, thr, max_out)
    want = nms_batched_plain(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,max_out", [
    (1, 1024, 100), (3, 1, 5), (2, 33, 20), (2, 200, 300), (4, 1024, 1),
    (2, 1025, 100), (3, 1280, 2000), (2, 2048, 1),
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
    # past the largest instance's 2048 candidates
    boxes, scores, _ = _nms_inputs(dev, 1, 2056)
    with pytest.raises(ValueError, match="candidates"):
        nms_batched(boxes, scores, 0.5, 10)
    with pytest.raises(TypeError):
        nms_batched(boxes[:, :64].double(), scores[:, :64].double(), 0.5, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["non_contiguous", "misaligned"])
def test_nms_op_copies_what_the_kernel_cannot_read(dev, layout):
    """The custom op's CUDA body copies inputs that are not contiguous or
    whose boxes are not 16-byte aligned, and launches the kernel."""
    boxes, scores, _ = _nms_inputs(dev, 3, 300, seed=5)
    if layout == "non_contiguous":
        boxes = boxes.transpose(0, 1).contiguous().transpose(0, 1)
        scores = scores.t().contiguous().t()
        assert not (boxes.is_contiguous() or scores.is_contiguous())
    else:
        flat = torch.empty(boxes.numel() + 1, device=dev)
        flat[1:] = boxes.flatten()
        boxes = flat[1:].view(boxes.shape)
        assert boxes.is_contiguous() and boxes.data_ptr() % 16
    _assert_nms_matches_plain(boxes, scores, 0.65, 100)


@pytest.mark.cuda
def test_exported_program_launches_the_nms_kernel(dev, tmp_path):
    """A program exported with the class-aware NMS in it, saved and loaded,
    launches the kernel through the custom op."""
    from yolov7_d2_tpu_torch.deploy.export import (
        export_program,
        load_program,
    )

    boxes, scores, cls = _nms_inputs(dev, 4, 1024, seed=9)
    path = export_program(
        lambda b, s, c: batched_nms_batched(b, s, c, 0.65, 100),
        (boxes, scores, cls), str(tmp_path / "nms.pt2"))
    program = load_program(path)
    nodes = [str(n.target) for n in program.graph.nodes]
    assert "yolov7_d2_tpu_torch.nms_batched.default" in nodes
    before = build.LAUNCHES["nms"]
    got = program.module()(boxes, scores, cls)
    want = batched_nms_batched(boxes, scores, cls, 0.65, 100,
                               nms=nms_batched_plain)
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_sync_batchnorm_fused_path_on_two_ranks(dev, tmp_path, dtype, tol):
    """``SyncBatchNorm2d``'s fused CUDA path on 2 gloo ranks sharing the
    card against ``nn.BatchNorm2d`` on the whole batch: output, input
    gradient and running statistics, of the reference's largest magnitude
    (bfloat16 outputs round to 2^-8 of a value)."""
    from yolov7_d2_tpu_torch.parallel.dryrun import norm_sync_ranks
    from yolov7_d2_tpu_torch.parallel.launch import launch

    gen = torch.Generator().manual_seed(0)
    c = 16
    x, g = (torch.randn((4, c, 12, 10), generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    params = {"weight": torch.rand(c, generator=gen) + 0.5,
              "bias": torch.randn(c, generator=gen), "eps": 1e-3,
              "momentum": 0.1}
    running = torch.ones((2, 2, c))
    launch(norm_sync_ranks, 2, args=(str(tmp_path), params, x, g, running,
                                     x[None], "cuda"),
           backend="gloo", timeout=240.0)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    ref = torch.nn.BatchNorm2d(c, eps=1e-3, momentum=0.1).to(dev)
    with torch.no_grad():
        ref.weight.copy_(params["weight"])
        ref.bias.copy_(params["bias"])
    xr = x.to(dev).requires_grad_(True)
    y = ref(xr)
    y.backward(g.to(dev))
    for got, want, bound in (
            (torch.cat([r["y"] for r in ranks]), y, tol),
            (torch.cat([r["x_grad"] for r in ranks]), xr.grad, tol),
            (ranks[0]["running_mean"], ref.running_mean, 1e-4),
            (ranks[0]["running_var"], ref.running_var, 1e-4)):
        want = want.detach().float().cpu()
        assert (got.float() - want).abs().max() <= bound * want.abs().max()
    assert torch.equal(ranks[0]["running_var"], ranks[1]["running_var"])


def _random_gts(rng, b, g, size):
    """A real batch's crowd: 1-g boxes an image, 8 px to half the frame."""
    xy = rng.uniform(0, size - 8, (b, g, 2))
    wh = rng.uniform(8, size / 2, (b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, size)], -1)
    valid = np.arange(g)[None] < rng.integers(1, g + 1, (b, 1))
    classes = rng.integers(0, 80, (b, g)) * valid
    return (boxes.astype(np.float32), classes.astype(np.int32), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["build_targets_max_iou",
                                   "build_targets_ratio"])
def test_anchor_targets_resolve_collisions_on_card_as_on_cpu(dev, build):
    """Where several gts claim one anchor, the card's ``scatter_reduce``
    keeps the same (last in the JAX order) candidate as the CPU's: the
    built collision scenes at 64 px, and 100 boxes an image at 640 px."""
    from _torch_port_helpers import colliding_gts
    from yolov7_d2_tpu_torch.config import AnchorYoloConfig
    from yolov7_d2_tpu_torch.models.heads import anchor_yolo_head as head

    anchors = AnchorYoloConfig.anchors
    for gts, size in ((colliding_gts(), 64),
                      (_random_gts(np.random.default_rng(3), 8, 100, 640),
                       640)):
        level_hw = [(size // s, size // s) for s in (8, 16, 32)]
        cpu = getattr(head, build)(*map(torch.from_numpy, gts), anchors,
                                   level_hw, (8, 16, 32))
        card = getattr(head, build)(*(torch.from_numpy(a).to(dev)
                                      for a in gts), anchors, level_hw,
                                    (8, 16, 32))
        for key in ("fg_mask", "matched_gt"):
            assert torch.equal(card[key].cpu(), cpu[key]), key
        assert int(cpu["fg_mask"].sum()) > 0


@pytest.mark.cuda
def test_anchor_nms_tail_on_card_matches_plain_and_cpu_on_ties(dev):
    """``yolo_nms_postprocess`` at 640 px (25200 candidates, top 1024) on
    tied scores: the NMS kernel's tail equals the plain tail on the card
    and the CPU's, index for index (the stable sort keeps the lower index
    first among equal scores on both)."""
    from _torch_port_helpers import decoded_candidates
    from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import (
        yolo_nms_postprocess,
    )

    inputs = decoded_candidates(np.random.default_rng(4), 8, 25200, 80, 640,
                                cut=1024)
    cpu = yolo_nms_postprocess(*map(torch.from_numpy, inputs))
    on_card = [torch.from_numpy(a).to(dev) for a in inputs]
    before = build.LAUNCHES["nms"]
    kernel = yolo_nms_postprocess(*on_card)
    plain = yolo_nms_postprocess(*on_card, nms=nms_batched_plain)
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms"] == before + 1
    for field in ("valid", "classes", "boxes", "scores"):
        got = getattr(kernel, field)
        assert torch.equal(got, getattr(plain, field)), field
        assert torch.equal(got.cpu(), getattr(cpu, field)), field
    assert int(kernel.valid.sum()) > 100


@pytest.mark.cuda
def test_sparseinst_serving_on_card_launches_normalize(dev, monkeypatch):
    """SparseInst's uint8 head goes through the normalize kernel with the
    model's ImageNet mean and std (bit-exact against the plain version),
    and the float32 outputs agree with the CPU's (full width, 64 px, TF32
    off: cuDNN's TF32 convolutions differ from the CPU by 4e-4 of the
    max)."""
    from yolov7_d2_tpu_torch.config import SparseInstConfig
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as tsi

    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    got = normalize_images(images.to(dev), tsi.PIXEL_MEAN, tsi.PIXEL_STD)
    want = normalize_images_plain(images.to(dev), tsi.PIXEL_MEAN,
                                  tsi.PIXEL_STD)
    assert torch.equal(got, want)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = SparseInstConfig(amp=False, input_size=(64, 64))
    before = build.LAUNCHES["normalize"]
    with torch.inference_mode():
        on_card = build_model(cfg, dev)(images.to(dev))
        ref = build_model(cfg, "cpu")(images)
    torch.cuda.synchronize()
    assert build.LAUNCHES["normalize"] == before + 1
    for k in ("cls_logits", "obj_logits", "mask_logits"):
        scale = float(ref[k].abs().max())
        assert float((on_card[k].cpu() - ref[k]).abs().max()) <= \
            1e-4 * max(scale, 1.0), k


@pytest.mark.cuda
def test_auction_on_card_matches_cpu(dev):
    """The batched auction on the card gives the CPU's assignments, ties
    included (24 quantized costs, 1-100 valid rows of 100)."""
    from yolov7_d2_tpu_torch.ops.matchers import hungarian_match

    rng = np.random.default_rng(0)
    costs = np.round(rng.random((24, 100, 100)) * 20) / 20
    valid = np.arange(100)[None] < rng.integers(1, 101, (24, 1))
    cost = torch.tensor(costs, dtype=torch.float32)
    rows = torch.tensor(valid)
    cols = torch.ones(24, 100, dtype=torch.bool)
    want = hungarian_match(cost, rows, cols)
    got = hungarian_match(cost.to(dev), rows.to(dev), cols.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["Detr", "AnchorDetr"])
def test_detr_serving_on_card_matches_cpu(dev, monkeypatch, arch):
    """DETR's and AnchorDETR's uint8 batch goes through the normalize
    kernel at their ImageNet mean and std, once a request; the float32
    outputs agree with the CPU's (full width, 6 + 6 layers, 128 px, TF32
    off), and the tail on the card gives the CPU tail's detections on the
    same outputs, quantized to quarters so that every score is either
    tied (the stable sort's order on both) or far from the others (the
    card's and the CPU's sigmoid and softmax differ in the last bit)."""
    from yolov7_d2_tpu_torch.config import DetrConfig
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import detr as td
    from yolov7_d2_tpu_torch.models.meta_arch import detr_variants as tdv

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = DetrConfig(meta_architecture=arch, amp=False,
                     input_size=(128, 128),
                     dim_feedforward=2048 if arch == "Detr" else 1024)
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    before = build.LAUNCHES["normalize"]
    with torch.inference_mode():
        on_card = build_model(cfg, dev)(images.to(dev))
        ref = build_model(cfg, "cpu")(images)
    torch.cuda.synchronize()
    assert build.LAUNCHES["normalize"] == before + 1
    for k in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        scale = float(ref[k].abs().max())
        assert float((on_card[k].cpu() - ref[k]).abs().max()) <= \
            1e-4 * max(scale, 1.0), k
    tail = (td.detr_postprocess if arch == "Detr"
            else tdv.anchor_detr_postprocess)
    out = {k: v.clone() for k, v in on_card.items()}
    out["pred_logits"] = torch.round(out["pred_logits"] * 4) / 4
    got = tail(out, cfg.input_size)
    want = tail({k: v.cpu() for k, v in out.items()}, cfg.input_size)
    assert got.boxes.shape == (2, 100, 4)
    for f in ("boxes", "classes", "valid"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert torch.allclose(got.scores.cpu(), want.scores, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("use_focal", [False, True])
def test_stacked_detr_auction_on_card_matches_cpu(dev, use_focal):
    """``detr_match`` over six decoder levels stacked on the batch axis
    ([6 x 4, 20, 100], copied queries and gts for ties) gives the CPU's
    assignments and the assignments of one call a level."""
    from yolov7_d2_tpu_torch.models.meta_arch.detr import detr_match

    rng = np.random.default_rng(1)
    lv, b, q, g = 6, 4, 100, 20
    logits = rng.normal(0, 2, (lv * b, q, 80 if use_focal else 81))
    boxes = 1 / (1 + np.exp(-rng.normal(0, 1, (lv * b, q, 4))))
    logits[:, 10:20] = logits[:, 9:10]
    boxes[:, 10:20] = boxes[:, 9:10]
    gt = rng.uniform(0.2, 0.6, (b, g, 4))
    gt[:, 1:4] = gt[:, :1]
    cls = rng.integers(0, 80, (b, g))
    valid = np.arange(g)[None] < rng.integers(1, g + 1, (b, 1))
    args = [torch.tensor(a, dtype=torch.float32) for a in (logits, boxes)] + [
        torch.tensor(np.tile(a, (lv,) + (1,) * (a.ndim - 1)))
        for a in (gt.astype(np.float32), cls, valid)]
    want = detr_match(*args, use_focal=use_focal)
    got = detr_match(*(a.to(dev) for a in args), use_focal=use_focal)
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x.cpu(), y)
    for i in range(lv):
        rows = slice(i * b, (i + 1) * b)
        one = detr_match(*(a[rows].to(dev) for a in args),
                         use_focal=use_focal)
        assert torch.equal(one[0].cpu(), want[0][rows])
        assert torch.equal(one[1].cpu(), want[1][rows])


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["build_swin_transformer_backbone",
                                      "build_pvt_v2_backbone",
                                      "build_cspdarknetx_backbone"])
def test_yolox_kpts_serving_on_card_matches_cpu(dev, monkeypatch, backbone):
    """YOLOX-KPTS's uint8 batch goes through the normalize kernel once a
    request; the float32 outputs and keypoints agree with the CPU's (full
    width, 128 px, TF32 off); the tail launches the NMS kernel once, gives
    the plain tail's ``Detections`` on the card, keypoints included, and
    the CPU tail's on the same outputs, quantized to quarters so that
    every score is tied or far from the others: the same kept anchors and
    classes, boxes, scores and keypoints to float32 rounding (the card's
    and the CPU's exp and sigmoid differ in the last bit)."""
    from yolov7_d2_tpu_torch.config import YoloxKptsConfig
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch.yolox_kpts import (
        yolox_kpts_postprocess,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = YoloxKptsConfig(backbone=backbone, amp=False,
                          input_size=(128, 128))
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    before = dict(build.LAUNCHES)
    with torch.inference_mode():
        on_card = build_model(cfg, dev)(images.to(dev))
        ref = build_model(cfg, "cpu")(images)
    torch.cuda.synchronize()
    assert build.LAUNCHES["normalize"] == before.get("normalize", 0) + 1
    for k in ("outputs", "kpts"):
        scale = float(ref[k].abs().max())
        assert float((on_card[k].cpu() - ref[k]).abs().max()) <= \
            1e-4 * max(scale, 1.0), k
    out = dict(on_card)
    out["outputs"] = torch.round(out["outputs"] * 4) / 4
    got = yolox_kpts_postprocess(out)
    plain = yolox_kpts_postprocess(out, nms=nms_batched_plain)
    want = yolox_kpts_postprocess({k: v.cpu() for k, v in out.items()})
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms"] == before.get("nms", 0) + 1
    for f in ("boxes", "scores", "classes", "valid", "keypoints"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    for f in ("classes", "valid"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("boxes", "scores", "keypoints"):
        assert torch.allclose(getattr(got, f).cpu(), getattr(want, f),
                              rtol=1e-6, atol=1e-5), f


@pytest.mark.cuda
def test_yolox_kpts_tail_on_card_matches_plain_and_cpu_on_ties(dev):
    """``yolox_kpts_postprocess`` over 8400 anchors with tied scores across
    the pre-NMS cut: the NMS kernel's tail equals the plain tail on the
    card, and the CPU's in the kept anchors and classes, boxes and
    keypoints to float32 rounding (exp and sigmoid differ in the last bit
    between the card and the CPU)."""
    from _torch_port_helpers import tied_kpts_head
    from yolov7_d2_tpu_torch.models.meta_arch.yolox_kpts import (
        yolox_kpts_postprocess,
    )

    head = {k: torch.from_numpy(v) for k, v in tied_kpts_head(
        np.random.default_rng(4), a=8400, size=640).items()}
    head["outputs"] = torch.round(head["outputs"] * 4) / 4
    cpu = yolox_kpts_postprocess(head)
    on_card = {k: v.to(dev) for k, v in head.items()}
    kernel = yolox_kpts_postprocess(on_card)
    plain = yolox_kpts_postprocess(on_card, nms=nms_batched_plain)
    for f in ("valid", "classes", "boxes", "scores", "keypoints"):
        assert torch.equal(getattr(kernel, f), getattr(plain, f)), f
    for f in ("valid", "classes"):
        assert torch.equal(getattr(kernel, f).cpu(), getattr(cpu, f)), f
    for f in ("boxes", "scores", "keypoints"):
        assert torch.allclose(getattr(kernel, f).cpu(), getattr(cpu, f),
                              rtol=1e-6, atol=1e-5), f
    assert int(kernel.valid.sum()) > 100


@pytest.mark.cuda
def test_normalize_yolof_kernel_matches_plain(dev):
    """The normalize kernel at YOLOF's mean and std (the JAX model's
    constants) on an 800 px batch, bf16 and float32: bit for bit its plain
    version, in channels_last."""
    from yolov7_d2_tpu_torch.models.meta_arch import yolof as tf

    images = torch.randint(0, 256, (4, 800, 800, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2)).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        got = normalize_images(images, tf.PIXEL_MEAN, tf.PIXEL_STD, dtype)
        want = normalize_images_plain(images, tf.PIXEL_MEAN, tf.PIXEL_STD,
                                      dtype)
        assert got.stride() == want.stride()
        assert torch.equal(got, want), dtype


def _onestage_cfg(arch):
    from yolov7_d2_tpu_torch.config import (
        AnchorYoloConfig,
        YolofConfig,
        Yolov6Config,
    )

    if arch == "YOLOV5":
        return AnchorYoloConfig(meta_architecture="YOLOV5", width_mul=0.5,
                                depth_mul=0.33, amp=False,
                                input_size=(128, 128))
    if arch == "YOLOV6":
        return Yolov6Config(amp=False, input_size=(128, 128))
    return YolofConfig(amp=False, input_size=(128, 128))


def _onestage_tail(cfg, out, nms=nms_batched):
    from yolov7_d2_tpu_torch.models.meta_arch.yolof import yolof_postprocess
    from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import (
        anchor_yolo_postprocess,
    )
    from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess

    if cfg.meta_architecture == "YOLOV6":
        return yolox_postprocess(out, cfg.conf_threshold, cfg.nms_threshold,
                                 nms=nms)
    if cfg.meta_architecture == "YOLOF":
        return yolof_postprocess(out, nms=nms)
    return anchor_yolo_postprocess(out, "yolov5", cfg.conf_threshold,
                                   cfg.nms_threshold, nms=nms)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["YOLOV5", "YOLOV6", "YOLOF"])
def test_onestage_serving_on_card_matches_cpu(dev, monkeypatch, arch):
    """YOLOv5-s, YOLOv6-s and YOLOF R-50 at full width, 128 px, float32
    (TF32 off): the uint8 batch goes through the normalize kernel once a
    request (YOLOF's at its mean and std), the outputs agree with the
    CPU's within 1e-4 of their max, and the tail launches the NMS kernel
    once and gives the plain tail's ``Detections`` on the card, and the
    CPU tail's on the same outputs quantized to quarters (every score tied
    or far from the others; the card's and the CPU's sigmoid and exp
    differ in the last bit)."""
    from yolov7_d2_tpu_torch.models.build import build_model

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _onestage_cfg(arch)
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    before = dict(build.LAUNCHES)
    with torch.inference_mode():
        on_card = build_model(cfg, dev)(images.to(dev))
        ref = build_model(cfg, "cpu")(images)
    torch.cuda.synchronize()
    assert build.LAUNCHES["normalize"] == before.get("normalize", 0) + 1
    key = "logits" if arch == "YOLOF" else "outputs"
    for k in (key, "deltas") if arch == "YOLOF" else (key,):
        scale = float(ref[k].abs().max())
        assert float((on_card[k].cpu() - ref[k]).abs().max()) <= \
            1e-4 * max(scale, 1.0), k
    out = dict(on_card)
    out[key] = torch.round(out[key] * 4) / 4
    got = _onestage_tail(cfg, out)
    plain = _onestage_tail(cfg, out, nms=nms_batched_plain)
    want = _onestage_tail(cfg, {k: v.cpu() if torch.is_tensor(v) else v
                                for k, v in out.items()})
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms"] == before.get("nms", 0) + 1
    assert int(got.valid.sum()) > 0
    for f in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    for f in ("classes", "valid"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("boxes", "scores"):
        assert torch.allclose(getattr(got, f).cpu(), getattr(want, f),
                              rtol=1e-6, atol=1e-4), f


@pytest.mark.cuda
def test_uniform_match_on_card_matches_cpu(dev):
    """``uniform_match`` on the card takes the CPU's assignments on a scene
    with ties and anchors claimed more than once: the stable sort and the
    ``amax`` scatter have one answer on both."""
    from yolov7_d2_tpu_torch.models.meta_arch import yolof as tf

    anchors = tf.yolof_anchors(25, 25)
    rng = np.random.default_rng(3)
    pred = anchors[None].repeat(4, 1, 1).clone()
    pred[1:] += torch.tensor(rng.normal(0, 4, (3,) + tuple(anchors.shape)),
                             dtype=torch.float32)
    boxes = torch.tensor(rng.uniform(0, 700, (4, 30, 2)), dtype=torch.float32)
    boxes = torch.cat([boxes, boxes + torch.tensor(
        rng.uniform(20, 300, (4, 30, 2)), dtype=torch.float32)], -1)
    boxes[:, 10:15] = boxes[:, 9:10]                     # repeated gts
    boxes[0, 0] = torch.tensor([32.0, 16.0, 96.0, 80.0])  # a cell boundary
    valid = torch.tensor(np.arange(30)[None] < rng.integers(5, 31, (4, 1)))
    want = tf.uniform_match(pred, anchors, boxes, valid)
    got = tf.uniform_match(pred.to(dev), anchors.to(dev), boxes.to(dev),
                           valid.to(dev))
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k
    assert not bool(want["winner"][want["occ_valid"]].all())


@pytest.mark.cuda
def test_yolov7_res2net_serving_on_card_matches_cpu(dev, monkeypatch):
    """YOLOV7 on Res2Net-50 v1b (``configs/coco/r2_50.yaml``'s model:
    YOLOFPN, 80 classes, raw pixels through the normalize kernel's identity
    form) at 128 px, float32 (TF32 off): the outputs agree with the CPU's
    within 1e-4 of their max, one normalize launch a request, and the tail
    launches the NMS kernel once and gives the plain tail's
    ``Detections``."""
    from yolov7_d2_tpu_torch.config import AnchorYoloConfig
    from yolov7_d2_tpu_torch.models.backbones.res2net import Res2Net
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import (
        anchor_yolo_postprocess,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = AnchorYoloConfig(backbone="build_res2net_backbone",
                           r2type="res2net50_v1b", neck_type="fpn",
                           in_features=("res3", "res4", "res5"), amp=False,
                           input_size=(128, 128))
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    before = dict(build.LAUNCHES)
    with torch.inference_mode():
        model = build_model(cfg, dev)
        on_card = model(images.to(dev))
        ref = build_model(cfg, "cpu")(images)
    torch.cuda.synchronize()
    assert isinstance(model.backbone, Res2Net)
    assert build.LAUNCHES["normalize"] == before.get("normalize", 0) + 1
    scale = float(ref["outputs"].abs().max())
    assert float((on_card["outputs"].cpu() - ref["outputs"]).abs().max()) \
        <= 1e-4 * max(scale, 1.0)
    got = anchor_yolo_postprocess(on_card, "yolov7", 0.001, 0.65)
    plain = anchor_yolo_postprocess(on_card, "yolov7", 0.001, 0.65,
                                    nms=nms_batched_plain)
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms"] == before.get("nms", 0) + 1
    assert int(got.valid.sum()) > 0
    for f in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


@pytest.mark.cuda
def test_bilinear_resize_backward_repeats_on_card(dev):
    """SparseInst's bilinear resize (``_resize``) on the card: its backward
    (two products with the interpolation matrices) is bitwise the same in
    two runs, where CUDA's own adds with atomics, and agrees with the
    CPU's and with ``F.interpolate``'s own CUDA backward (the form it
    replaces) within 1e-5 of its max."""
    from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import _resize

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((16, 100, 80, 80), generator=gen)
    g = torch.randn((16, 100, 160, 160), generator=gen)
    grads = []
    for where in (dev, dev, "cpu"):
        xi = x.to(where).requires_grad_(True)
        _resize(xi, (160, 160)).backward(g.to(where))
        grads.append(xi.grad.cpu())
    xi = x.detach().to(dev).requires_grad_(True)
    torch.nn.functional.interpolate(
        xi, size=(160, 160), mode="bilinear",
        align_corners=False).backward(g.to(dev))
    assert torch.equal(grads[0], grads[1])
    scale = float(grads[2].abs().max())
    for want in (grads[2], xi.grad.cpu()):
        assert float((grads[0] - want).abs().max()) <= 1e-5 * scale
