#!/usr/bin/env python3
"""Smoke run of the PyTorch port's YOLOX-s serving path and training step
on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``yolov7_d2_tpu_torch/csrc`` and holds
each against its plain PyTorch version at its path's shapes (NMS also on a
one-class case that suppresses heavily, GridMask on float32 and uint8).
Then the paths, full-width YOLOX-s (80 classes, 640 px, bf16 over f32
weights, random weights from a seed), each with the kernel launch counts
set to 0 just before it and read just after:

* serving: ``Predictor.predict_batch`` for requests of 1, 8 and 128
  images (normalize and NMS kernels), outputs checked, kernel path against
  plain path, the card against the CPU, times by CUDA events;
* training: ``build_yolox_system`` + ``make_packed_photo_step`` with
  GridMask on, 13 steps of 16 seeded uint8 images (mixup, GridMask
  kernel on float32, flip, forward, SimOTA and losses, backward, SGD,
  EMA), checked for finite losses, foreground anchors and moving weights,
  EMA and BN statistics; ms a step, img/s and peak memory;
* training with mixup off: 3 steps, the images uint8 through the GridMask
  kernel and the normalize kernel, checked for finite losses and moving
  weights; then one float32 step on the card against the CPU.

Output: progress lines, then the card's name and power limit, a JSON line
of the kernels (times, launches on the path, bound, plain and library
times), and last ``{"ok": true, "device": {...}}``. Any failed phase
raises, and the script exits non-zero without that last line; so does a
run without a CUDA card or outside the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128
SIZE = 640
REQUEST_BATCHES = (1, 8, BATCH)
PIXEL_MEAN = (103.53, 116.28, 123.675)  # config/defaults.py, R-50 families
PIXEL_STD = (57.375, 57.12, 58.395)
WARMUP, ITERS = 3, 10
TRAIN_BATCH = 16  # one card's share of IMS_PER_BATCH 112 over 8 cards
# the H100 SXM's published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=WARMUP, iters=ITERS) -> float:
    """Mean milliseconds a call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, warmup=WARMUP, iters=ITERS, host_ok=None) -> float:
    """Mean device milliseconds a call of ``fn``: the timed calls queue up
    behind a sleep kernel, so that the host's cost a call (a wrapper's
    checks, allocations and launch) is not in the time of a kernel that
    takes less. The reading counts only if the event after the sleep is
    still pending once the last call is queued; else the sleep grows, 1, 4
    and 16 ms. Where even that is short, the calls run at the host's pace:
    ``host_ok`` names a reading allowed to (a plain version's host loop),
    which is then logged as such; for any other that raises."""
    for _ in range(warmup):
        fn()
    for cycles in (2_000_000, 8_000_000, 32_000_000):  # at the H100's 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        if queued:
            return ms
    if host_ok is None:
        raise AssertionError("kernel_ms: the host could not queue the timed "
                             "calls ahead of the card")
    log(f"{host_ok}: {ms:.4f} ms at the host's pace (its calls could not be "
        "queued ahead of the card)")
    return ms


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nms_walk_pairs(scores, idx, valid, max_out) -> int:
    """IoU tests the greedy walk makes on this data: it visits the live
    candidates by (score descending, index ascending) up to the max_out-th
    kept one, or all L live ones where fewer are kept, and tests each
    visited candidate against the boxes kept before it."""
    b, k = scores.shape
    live = scores > 0
    order = torch.sort(scores.masked_fill(~live, -1.0), dim=1,
                       descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(k, device=scores.device).expand(b, k))
    pos = rank.gather(1, idx.clamp(min=0).long())  # kept ones' positions
    visited = torch.where(valid.sum(1) == max_out,
                          torch.where(valid, pos, -1).max(1).values + 1,
                          live.sum(1))
    # the kept box at position p is tested by the visited ones after it
    return int(torch.where(valid, visited[:, None] - 1 - pos, 0).sum())


def letterboxed_batch(n: int, gen: torch.Generator) -> torch.Tensor:
    """uint8 [n, 640, 640, 3]: random content of random size, anchored
    top-left, padded with 114 as the letterbox does."""
    batch = torch.full((n, SIZE, SIZE, 3), 114, dtype=torch.uint8)
    for i in range(n):
        h, w = (int(v) for v in torch.randint(160, SIZE + 1, (2,),
                                              generator=gen))
        if i % 2:
            h = SIZE
        else:
            w = SIZE
        batch[i, :h, :w] = torch.randint(0, 256, (h, w, 3), generator=gen,
                                         dtype=torch.uint8)
    return batch


def random_nms_inputs(dev, gen, b=BATCH, k=1024, classes=80):
    """Clustered boxes in a 640 frame, scores with ties and zeros, classes."""
    centers = (torch.rand((b, k // 8, 1, 2), generator=gen) * SIZE).expand(
        b, k // 8, 8, 2).reshape(b, k, 2)
    centers = centers + torch.randn((b, k, 2), generator=gen) * 6
    wh = 8 + torch.rand((b, k, 2), generator=gen) * 112
    boxes = torch.cat([centers - wh / 2, centers + wh / 2], -1)
    scores = torch.rand((b, k), generator=gen)
    scores[:, 1::5] = scores[:, ::5][:, : scores[:, 1::5].shape[1]]
    scores[:, :64] = 0.0
    cls = torch.randint(0, classes, (b, k), generator=gen)
    return boxes.to(dev), scores.to(dev), cls.to(dev)


def crowd_nms_inputs(dev, gen, b=BATCH, k=1024):
    """One class, boxes crowded around one point: at thr 0.3 fewer than 100
    of 1024 survive, so the kernel scans all 32 tiles of 32 candidates."""
    centers = 200 + torch.rand((b, k, 2), generator=gen) * 240
    wh = 40 + torch.rand((b, k, 2), generator=gen) * 120
    boxes = torch.cat([centers - wh / 2, centers + wh / 2], -1)
    scores = 0.01 + torch.rand((b, k), generator=gen)
    return boxes.to(dev), scores.to(dev)


def grid_mask_inputs(dev, gen):
    """Parameters for TRAIN_BATCH images drawn as the training path draws
    them, every other one made an identity (keep 0 in mode 0 where d > 1),
    and the uint8 and float32 images of [TRAIN_BATCH, 640, 640, 3]."""
    from yolov7_d2_tpu_torch.data.device_aug import sample_grid_mask_params
    params = sample_grid_mask_params(gen, TRAIN_BATCH, SIZE, SIZE, 0.75)
    params[::2, 4] = torch.where(params[::2, 0] > 1, 0, params[::2, 4])
    shape = (TRAIN_BATCH, SIZE, SIZE, 3)
    u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    f32 = torch.rand(shape, generator=gen) * 255
    return params.to(dev), u8.to(dev), f32.to(dev)


def train_batch(n: int, gen: torch.Generator, size: int = SIZE) -> dict:
    """A packed training batch: uint8 [n, size, size, 3] and 1-100 boxes of
    8 px to half the image an image, in ``max_boxes`` 100 valid-first
    slots."""
    g = 100
    xy = torch.rand((n, g, 2), generator=gen) * (size - 8)
    wh = 8 + torch.rand((n, g, 2), generator=gen) * (size // 2 - 8)
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    count = torch.randint(1, g + 1, (n, 1), generator=gen)
    valid = torch.arange(g)[None] < count
    return {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8),
        "gt_boxes": torch.where(valid[..., None], boxes, 0.0),
        "gt_classes": torch.randint(0, 80, (n, g), generator=gen,
                                    dtype=torch.int32) * valid,
        "gt_valid": valid,
    }


def snapshot(state) -> dict:
    model = state.model
    return {
        "params": [p.detach().clone() for p in model.parameters()],
        "ema": [e.clone() for e in state.ema_params.values()],
        "bn": [b.clone() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this check runs only "
                           "on a card")
    sys.path.insert(0, REPO)
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.device_aug import (
        DevicePhotometric,
        PhotoDraws,
        make_packed_photo_step,
    )
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.grid_mask import (
        grid_mask,
        grid_mask_plain,
    )
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched, nms_batched_plain
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.ops.nms import _class_offset_boxes
    from yolov7_d2_tpu_torch.predictor import Predictor

    # ---- 1. device
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator().manual_seed(SEED)

    # ---- 2. build
    t0 = time.perf_counter()
    build.load_library()
    nvcc = ("found built" if build.BUILD_SECONDS is None
            else f"nvcc {build.BUILD_SECONDS:.2f} s")
    log(f"build: kernels ready in {time.perf_counter() - t0:.2f} s ({nvcc})")

    kernels = {}

    # ---- 3. normalize kernel vs its plain version, [128, 640, 640, 3]
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    cases = [((0.0,) * 3, (1.0,) * 3, torch.bfloat16),
             (PIXEL_MEAN, PIXEL_STD, torch.float32)]
    norm_err = 0.0
    for mean, std, dtype in cases:
        got = normalize_images(images, mean, std, dtype)
        want = normalize_images_plain(images, mean, std, dtype)
        torch.cuda.synchronize()
        if got.stride() != want.stride() or not torch.equal(got, want):
            raise AssertionError(
                f"normalize kernel differs from its plain version: mean "
                f"{mean} {dtype}")
        norm_err = max(norm_err,
                       float((got.float() - want.float()).abs().max()))
        del got, want
    log(f"normalize: bit-exact against its plain version on "
        f"{tuple(images.shape)} -> channels_last (bf16 identity and f32 "
        f"pixel mean/std)")
    main_args = (images, (0.0,) * 3, (1.0,) * 3, torch.bfloat16)
    kernels["normalize"] = {
        "name": "normalize", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": norm_err,
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*main_args),
                              host_ok="normalize plain"),
        "ms": kernel_ms(lambda: normalize_images(*main_args)),
        # the identity case as one PyTorch call: cast into channels_last
        "library_ms": kernel_ms(lambda: images.permute(0, 3, 1, 2).to(
            torch.bfloat16, memory_format=torch.channels_last),
            host_ok="normalize library"),
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
    }
    del images

    # ---- 4. NMS kernel vs its plain version, [128, 1024], 80 classes
    boxes, scores, cls = random_nms_inputs(dev, gen)
    shifted = _class_offset_boxes(boxes, cls).contiguous()
    got = nms_batched(shifted, scores, 0.65, 100)
    want = nms_batched_plain(shifted, scores, 0.65, 100)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"NMS kernel differs from its plain version "
                             f"in {bad} slots")
    nms_err = float((got[0] - want[0]).abs().max())
    # the work this run's data needs: the IoU tests of the greedy walk
    # (about 15 float32 operations each); boxes and scores read once, the
    # kept indices and flags written once
    nms_ops = float(nms_walk_pairs(scores, *got, 100)) * 15
    nms_bytes = (boxes.numel() + scores.numel()) * 4 + got[1].numel() * 5
    log(f"nms: index-exact against its plain version on "
        f"{tuple(scores.shape)}, thr 0.65, max_out 100, 80 classes; kept "
        f"{int(got[1].sum())} of {got[1].numel()} slots")
    kernels["nms"] = {
        "name": "nms", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/nms.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_nms.py:34",
        "max_abs_err": nms_err,
        "plain_ms": kernel_ms(lambda: nms_batched_plain(shifted, scores,
                                                      0.65, 100),
                              host_ok="nms plain"),
        "ms": kernel_ms(lambda: nms_batched(shifted, scores, 0.65, 100)),
        "library_ms": None,  # no torchvision: no PyTorch call does NMS
        **bound(nms_bytes, nms_ops),
    }
    one_box, one_score = shifted[:1].contiguous(), scores[:1].contiguous()
    one_ms = kernel_ms(lambda: nms_batched(one_box, one_score, 0.65, 100))
    one_plain_ms = kernel_ms(
        lambda: nms_batched_plain(one_box, one_score, 0.65, 100),
        host_ok="nms plain bs 1")
    log(f"nms bs 1 {tuple(one_score.shape)} on [{card}]: kernel "
        f"{one_ms:.4f} ms, plain PyTorch {one_plain_ms:.4f} ms")
    crowd, crowd_scores = crowd_nms_inputs(dev, gen)
    got = nms_batched(crowd, crowd_scores, 0.3, 100)
    want = nms_batched_plain(crowd, crowd_scores, 0.3, 100)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"NMS kernel differs from its plain version "
                             f"in {bad} slots, one class")
    kept = got[1].sum(1)
    if not 0 < int(kept.max()) < 100:
        raise AssertionError("the one-class case did not scan every tile")
    crowd_ms = kernel_ms(lambda: nms_batched(crowd, crowd_scores, 0.3, 100))
    log(f"nms one class, thr 0.3: index-exact on {tuple(crowd_scores.shape)};"
        f" kept {int(kept.min())}-{int(kept.max())} an image; kernel "
        f"{crowd_ms:.4f} ms on [{card}]")
    del boxes, scores, cls, shifted, got, want, one_box, one_score
    del crowd, crowd_scores

    # ---- 5. GridMask kernel vs its plain version, [16, 640, 640, 3], the
    # float32 images of the training path and the uint8 ones it gets with
    # mixup off; drawn parameters in both modes and identity rows
    gparams, u8, f32 = grid_mask_inputs(dev, gen)
    for name, imgs in (("grid_mask_u8", u8), ("grid_mask", f32)):
        got = grid_mask(imgs, gparams)
        want = grid_mask_plain(imgs, gparams)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"GridMask kernel differs from its plain "
                                 f"version on {imgs.dtype}")
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": "yolov7_d2_tpu_torch/csrc/grid_mask.cu",
            "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:83",
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": kernel_ms(lambda: grid_mask(imgs, gparams)),
            "plain_ms": kernel_ms(lambda: grid_mask_plain(imgs, gparams),
                                  host_ok=f"{name} plain"),
            "library_ms": None,  # no single PyTorch call computes GridMask
            # read once, written once; one select an element
            **bound(imgs.numel() * imgs.element_size() * 2, imgs.numel()),
        }
    zeroed = [round(float(z), 3)
              for z in (got == 0).all(-1).flatten(1).float().mean(1)]
    log(f"grid_mask: bit-exact against its plain version on "
        f"{tuple(u8.shape)} uint8 and float32; share zeroed an image "
        f"{zeroed}")
    del imgs, u8, f32, got, want

    # ---- 6. serving: YOLOX-s 640, bf16, requests of 1, 8, 128 images
    cfg = YoloxConfig()
    predictor = Predictor(cfg, device=dev, seed=SEED)
    requests = [letterboxed_batch(n, gen) for n in REQUEST_BATCHES]
    torch.cuda.synchronize()
    build.reset_launches()
    results = [predictor.predict_batch(r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"main path launches: {launches}")
    for name in ("normalize", "nms"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the main path never launched {name}")
        kernels[name]["launches"] = launches[name]
    for req, dets in zip(requests, results):
        n = req.shape[0]
        if dets.boxes.shape != (n, cfg.max_detections, 4) or \
                dets.scores.shape != (n, cfg.max_detections) or \
                dets.valid.shape != (n, cfg.max_detections):
            raise AssertionError(f"bs {n}: Detections shapes "
                                 f"{tuple(dets.boxes.shape)}")
        counts = dets.num_valid()
        if int(counts.min()) < 1:
            raise AssertionError(f"bs {n}: an image with no detection")
        if not torch.isfinite(dets.boxes[dets.valid]).all():
            raise AssertionError(f"bs {n}: non-finite boxes")
        log(f"request bs {n}: detections per image min {int(counts.min())} "
            f"max {int(counts.max())}")

    # kernel path vs plain NMS path on the same bs-128 head outputs
    big = requests[-1].to(dev)
    head = predictor.forward(big)
    with_kernel = predictor.postprocess(head)
    with_plain = predictor.postprocess(head, nms=nms_batched_plain)
    for field in ("valid", "classes", "boxes", "scores"):
        if not torch.equal(getattr(with_kernel, field),
                           getattr(with_plain, field)):
            raise AssertionError(f"bs {BATCH}: Detections.{field} of the "
                                 "kernel path differ from the plain path")
    log(f"bs {BATCH}: kernel-path Detections equal the plain-path ones")

    # the card against the CPU on a small input, float32 without TF32. The
    # f32 card forward runs the same modules, layout and normalize kernel
    # as the bf16 one, so it is the check of BN, layout and weights: only
    # the convolutions' sum order differs from the CPU (measured on an H100:
    # 1.2e-5 of a max of 3.92, 3e-6 of it), and 1e-4 of the max leaves 30x
    # room. bf16 rounds every activation to 8 bits of mantissa (2**-8 =
    # 0.4% a rounding, through the model's depth); measured 2.2% of the
    # max, so 5e-2 bounds only gross faults of the autocast path.
    f32 = dataclasses.replace(cfg, amp=False)
    small = requests[0]
    ref = Predictor(f32, device="cpu", seed=SEED).forward(small)
    on_card = Predictor(f32, device=dev, seed=SEED).forward(small)
    bf16 = predictor.forward(small)
    ref_out = ref["outputs"]
    scale = float(ref_out.abs().max())
    err32 = float((on_card["outputs"].cpu() - ref_out).abs().max())
    err16 = float((bf16["outputs"].float().cpu() - ref_out).abs().max())
    log(f"bs 1 head outputs vs float32 on the CPU (max |ref| {scale:.4g}): "
        f"float32 card max err {err32:.4g}, bf16 card max err {err16:.4g}")
    if err32 > 1e-4 * scale or err16 > 5e-2 * scale:
        raise AssertionError("head outputs disagree with the CPU reference")
    if not torch.equal(on_card["grids"].cpu(), ref["grids"]) or \
            not torch.equal(on_card["strides"].cpu(), ref["strides"]):
        raise AssertionError("grids or strides differ from the CPU")

    # ---- 7. serving times: each request size, the batch already on the card
    for req in requests:
        n = req.shape[0]
        x = req.to(dev)
        e2e_ms = cuda_ms(lambda: predictor.predict_batch(x))
        fwd_ms = cuda_ms(lambda: predictor.forward(x))
        head = predictor.forward(x)
        tail_ms = cuda_ms(lambda: predictor.postprocess(head))
        log(f"YOLOX-s 640 bs {n} bf16 on [{card}]: e2e {e2e_ms:.3f} ms = "
            f"{n * 1000 / e2e_ms:.1f} img/s; forward-only {fwd_ms:.3f} ms = "
            f"{n * 1000 / fwd_ms:.1f} img/s; tail {tail_ms:.3f} ms")
    del predictor, requests, results, big, head, with_kernel, with_plain, x
    del ref, on_card, bf16
    torch.cuda.empty_cache()

    # ---- 8. training: YOLOX-s 640, bf16, 16 images a step, GridMask on
    tcfg = dataclasses.replace(cfg, grid_mask=True)
    _, state, train_step = build_yolox_system(tcfg, device=dev, seed=SEED)
    step = make_packed_photo_step(tcfg, train_step, seed=SEED)
    batches = [{k: v.to(dev) for k, v in train_batch(TRAIN_BATCH,
                                                     gen).items()}
               for _ in range(4)]
    before = snapshot(state)
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i in range(WARMUP):
        state, m = step(state, batches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + ITERS):
        state, m = step(state, batches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"training path launches: {launches}")
    if launches.get("grid_mask", 0) < 1:
        raise AssertionError("the training path never launched grid_mask")
    kernels["grid_mask"]["launches"] = launches["grid_mask"]
    masked = sum(m["grid_masked"] for m in metrics)
    if masked < 1:
        raise AssertionError("GridMask masked no image in the training run")
    for i, m in enumerate(metrics):
        for key in ("loss_iou", "loss_obj", "loss_cls", "loss_l1",
                    "total_loss", "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"step {i}: {key} = {float(m[key])}")
        if not float(m["num_fg"]) > 1.0:
            raise AssertionError(f"step {i}: no foreground anchor")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"training moved no {key} tensor")
    fmt = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "num_fg",
           "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    log(f"training: {masked} of {TRAIN_BATCH * len(metrics)} images "
        f"GridMask-ed; parameters, EMA and BN statistics moved")
    del state, train_step, step, before, after, metrics
    torch.cuda.empty_cache()

    # ---- 8b. training with mixup off: the images stay uint8 through the
    # GridMask kernel and into the normalize kernel at the model's head
    ucfg = dataclasses.replace(tcfg, mixup=False)
    _, state, train_step = build_yolox_system(ucfg, device=dev, seed=SEED)
    step = make_packed_photo_step(ucfg, train_step, seed=SEED + 1)
    before = snapshot(state)
    metrics = []
    torch.cuda.synchronize()
    build.reset_launches()
    for i in range(3):
        state, m = step(state, batches[i])
        metrics.append(m)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"training path, mixup off, launches: {launches}")
    for name in ("grid_mask", "normalize"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the mixup-off training path never "
                                 f"launched {name}")
    kernels["grid_mask_u8"]["launches"] = launches["grid_mask"]
    masked = sum(m["grid_masked"] for m in metrics)
    if masked < 1:
        raise AssertionError("GridMask masked no image with mixup off")
    for i, m in enumerate(metrics):
        for key in ("total_loss", "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"mixup off, step {i}: {key} = "
                                     f"{float(m[key])}")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"training with mixup off moved no {key} "
                                 "tensor")
    log(f"training, mixup off: {masked} of {TRAIN_BATCH * 3} uint8 images "
        f"GridMask-ed; total loss {float(metrics[0]['total_loss']):.4f} -> "
        f"{float(metrics[-1]['total_loss']):.4f}; parameters, EMA and BN "
        f"statistics moved")
    del state, train_step, step, batches, before, after, metrics
    torch.cuda.empty_cache()

    # ---- 9. one float32 train step, the card against the CPU: TF32 off,
    # width 0.25, 128 px, 2 images, the same weights, batch and draws
    # (GridMask parameters fixed). The forward differs from the CPU in the
    # convolutions' sum order only (1.2e-5 of its max in eval mode, section
    # 6), which train-mode BatchNorm and the losses carry to about 1e-5
    # relative; 1e-3 leaves room, and the fg count is exact unless an
    # assignment sits at a tie.
    scfg = dataclasses.replace(cfg, width_mul=0.25, input_size=(128, 128),
                               amp=False, grid_mask=True, warmup_iters=0)
    sbatch = train_batch(2, gen, 128)
    draws = PhotoDraws(
        perm=torch.tensor([1, 0]), do_mix=torch.tensor([True, False]),
        grid_params=torch.tensor([[16, 8, 3, 5, 1], [12, 6, 2, 7, 0]],
                                 dtype=torch.int32),
        do_flip=torch.tensor([False, True]))
    small_metrics = {}
    for where in ("cpu", dev):
        _, st, ts = build_yolox_system(scfg, device=where, seed=SEED)
        b = DevicePhotometric(scfg).apply(
            {k: v.to(where) for k, v in sbatch.items()}, draws)
        _, m = ts(st, b)
        small_metrics[str(where)] = {k: float(v) for k, v in m.items()}
    ref_m, card_m = small_metrics["cpu"], small_metrics[str(dev)]
    log("float32 train step, card vs CPU: " + ", ".join(
        f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}" for k in fmt))
    if card_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError("fg count differs between the card and the CPU")
    for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls", "grad_norm"):
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"{k} differs between the card and the CPU")

    # ---- 10. times
    log(f"YOLOX-s 640 train step bs {TRAIN_BATCH} bf16 on [{card}]: "
        f"{step_ms:.3f} ms a step = {TRAIN_BATCH * 1000 / step_ms:.1f} img/s "
        f"(host clock over {ITERS} steps after {WARMUP}, batches on the "
        f"card); peak memory {peak_gb:.3f} GB")
    for k in kernels.values():
        log(f"{k['name']} on [{card}]: kernel {k['ms']:.4f} ms, plain "
            f"PyTorch {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), library "
            + ("none" if k["library_ms"] is None
               else f"{k['library_ms']:.4f} ms"))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card, flush=True)
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
