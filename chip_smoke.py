#!/usr/bin/env python3
"""Smoke run of the PyTorch port's YOLOX-s serving path, training step,
training CLI and multi-GPU training, of the anchor-YOLO family's serving
and training, of SparseInst's and of DETR's and AnchorDETR's serving,
training and CLI, and of YOLOX-KPTS's serving, training and eval, on one
CUDA card.

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
  weights; then one float32 step on the card against the CPU;
* the CLI: ``train_det.main`` on ``configs/coco/yolox_s.yaml`` and a
  synthetic mini-COCO of 64 JPEGs (640x480, 1-8 boxes each): the host
  mosaic feed for 12 steps (checkpoints at 6 and 12, the COCO eval at 12
  through the normalize and NMS kernels) and ``--resume`` to 16; the
  packed feed (shards written by the port's writers) with GridMask until
  step 8 and the plain shards after it; the loaders alone, the eval and a
  checkpoint save timed;
* multi-GPU training (``parallel/``): (a) two ranks on one card over gloo
  (``launch(..., backend="gloo")``), the bare float32 step, 2 images a
  rank for 3 steps, against one process on the same 4 images (fg counts,
  losses and gradient norm, ranks bitwise equal, kernel launches a step);
  (b) the CLI's packed feed, 6 steps with GridMask until step 4 and the
  COCO eval at 6 on rank 0, inside an NCCL group of 1 (DDP) against no
  group: losses, the two ms-a-step medians, and the on-card step in turns
  with and without the group; (c) where two or more cards are visible, N
  of them (up to 4) over NCCL: the bare step against one process as in
  (a), then ``--num-gpus N`` through the CLI (logged as skipped on one
  card). The
  kernels' launches in the JSON line are those of (b) (GridMask on its
  steps before DISABLE_AT_ITER, normalize on the plain steps and in the
  eval, NMS in the eval); the uint8 GridMask's are the mixup-off path's;
  ``normalize_sparseinst``'s are the sum of SparseInst's serving (b) and
  training (d) paths below;
* the anchor-YOLO family (``anchor_yolo_phase``): YOLOV7 at 640 from
  ``configs/coco/yolov7.yaml``, full depth and width (CSP-Darknet53,
  YOLOPAFPN, the anchor head), bf16 over f32 weights from the seed.
  Serving: ``build_model`` + ``anchor_yolo_postprocess`` for requests of
  1, 8 and 128 images (normalize and NMS kernels, their launches counted
  from 0), the kernel path against the plain one index for index at bs
  128, the f32 head outputs on the card against the CPU at bs 1 within
  1e-4 of the max, times by CUDA events. Training: ``build_system``'s step
  in ``make_packed_photo_step``, GridMask (mode 1, prob 0.3) and mixup on,
  EMA on, 13 steps of 16 images (finite losses, foreground anchors,
  weights, EMA and BN statistics moved, ms a step, peak memory, GridMask
  launches), then one f32 step (128 px, 2 images) on the card against the
  CPU within 1e-3 with the same fg count. Then one request and one train
  step each for ``YOLO`` (``configs/coco/darknet53.yaml``), ``YOLOV7P``
  (CSP-Darknet53) and ``YOLOV7P`` on ResNet-50 (``configs/coco/r50.yaml``),
  full depth;
* SparseInst R-50 (``sparseinst_phase``): ``configs/coco/sparseinst/
  sparse_inst_r50_base.yaml`` at 640, full depth and width (ResNet-50
  with FrozenBN, the FPN-PPM encoder, ``BaseIAMDecoder`` with 100 masks),
  bf16 over f32 weights from the seed. (a) the normalize kernel at
  SparseInst's ImageNet mean and std on [128,640,640,3], bit-exact (the
  ``normalize_sparseinst`` entry); (b) serving, uint8 -> normalize kernel
  -> forward -> ``sparseinst_postprocess``, for requests of 1, 8 and 128
  images (instances found, finite masks, one launch a request, times by
  CUDA events) and ``upsample_masks_two_stage`` on one request; (c) the
  f32 forward on the card against the CPU at 128 px within 1e-4 of each
  output's max; (d) 13 steps of 16 images through ``build_system``
  (AdamW, 100 dense mask slots an image): finite losses, matched
  instances, parameters moved, FrozenBN statistics unmoved, ms a step,
  peak memory, the auction's rounds a step; one f32 step on the card
  against the CPU (assignments equal, losses and grad norm within 1e-3);
  (e) ``train_inseg`` on a mini-COCO of 64 JPEGs with polygons, the blend
  mosaic on: 12 steps with checkpoints at 6 and 12, ``--resume`` to 14,
  ``--eval-only`` (``COCOMaskEvaluator``'s keys);
* DETR R-50 and AnchorDETR R-50 (``detr_phase``):
  ``configs/coco/detr/detr_256_6_6_r50.yaml`` and ``anchordetr_r50.yaml``
  at 800, full depth and width (ResNet-50 with FrozenBN, 6 + 6 layers,
  100 queries, or 300 x 3 with RCDA), bf16 over f32 weights from the seed.
  (a) the normalize kernel at DETR's mean and std on [128,800,800,3],
  bit-exact (the ``normalize_detr`` entry, whose launches are those of
  both models' serving and training paths); serving, uint8 -> normalize
  kernel -> forward -> ``detr_postprocess`` / ``anchor_detr_postprocess``,
  for requests of 1, 8 and 128 images (one launch a request, e2e, forward
  and tail by CUDA events, the device's busy share at 128) and the kernel
  path's ``Detections`` equal to the plain path's at 8; (b) f32 outputs
  on the card against the CPU at 128 px within 1e-4 of the max, bf16
  within 5e-2; (c) 13 steps of 8 images through ``build_system``: finite
  losses and matched counts equal to the valid gts at all 6 levels,
  parameters moved, FrozenBN statistics unmoved, ms a step, peak memory,
  auction rounds; one f32 step at dropout 0 on the card against the CPU
  (assignments equal at every level, losses and grad norm within 1e-3);
  (d) ``train_transformer`` (DETR) on a mini-COCO of 64 JPEGs, the crop
  branch on: 12 steps, checkpoints at 6 and 12, ``--resume`` to 14;
* YOLOX-KPTS (``yolox_kpts_phase``): ``configs/coco/yolox_kpts_swin.yaml``
  (Swin-T, YOLOPAFPN at 0.33 / 0.50, one class, 17 keypoints), then
  ``yolox_kpts.yaml`` (CSPDarknet-X) and PVTv2-b1, at 640, full depth and
  width, bf16 over f32 weights from the seed. (a) serving, uint8 ->
  normalize kernel -> forward -> ``yolox_kpts_postprocess`` -> NMS
  kernel, for requests of 1, 8 and 128 images (launches counted from 0,
  e2e, forward and tail by CUDA events, the device's busy share at 128)
  and the kernel path's ``Detections``, keypoints included, equal to the
  plain path's at 8; (b) f32 outputs and keypoints on the card against
  the CPU at 128 px within 1e-4 of the max, bf16 within 5e-2; (c) 13
  steps of 16 images through ``build_system`` on Swin-T, 1-8 persons of
  17 keypoints an image (finite losses, foreground anchors, ``loss_kpt``
  > 0, parameters moved, ms a step, peak memory), then one f32 step at
  128 px on the card against the CPU; (d) ``eval_coco`` on a mini-COCO
  of 64 JPEGs of persons with keypoints (box and ``kpt_`` keys), and
  again with ``--weights`` of a saved state dict; (e) YOLOV7 on
  ``swin_t.yaml`` and ``pvt_v2_b0.yaml``: one request and one train step
  each. The launches of (a), (c) and (d) are added to the normalize and
  NMS entries of the kernels line.

``python3 chip_smoke.py --nccl`` runs (c) alone, on a machine of 2 or more
cards.

Output: progress lines, then the card's name and power limit, a JSON line
of the kernels (times, launches on the path, bound, plain and library
times), and last ``{"ok": true, "device": {...}}``. Any failed phase
raises, and the script exits non-zero without that last line; so does a
run without a CUDA card or outside the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import math
import os
import shutil
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
CLI_IMAGES = 64  # the CLI phase's synthetic mini-COCO
CLI_DATASET = "chip_smoke_mini_coco"
COCO_KEYS = ("AP", "AP50", "AP75", "AR100")
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


def letterboxed_batch(n: int, gen: torch.Generator,
                      size: int = SIZE) -> torch.Tensor:
    """uint8 [n, size, size, 3]: random content of random size, anchored
    top-left, padded with 114 as the letterbox does."""
    batch = torch.full((n, size, size, 3), 114, dtype=torch.uint8)
    for i in range(n):
        h, w = (int(v) for v in torch.randint(size // 4, size + 1, (2,),
                                              generator=gen))
        if i % 2:
            h = size
        else:
            w = size
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


def write_mini_coco(root: str, n: int = CLI_IMAGES, seed: int = SEED,
                    segm: bool = False, keypoints: bool = False):
    """``n`` JPEGs of 640x480 (OpenCV), each with 1-8 flat boxes of the 80
    COCO categories on a noisy background, and their COCO JSON; returns
    (json path, image dir). ``segm``: each box also gets a polygon, the
    box with its lower-right corner cut off (the SparseInst feed).
    ``keypoints``: every box is a person (the one category) with 17
    keypoints inside it, visible, occluded or unlabelled (0, 0, 0) (the
    YOLOX-KPTS feed)."""
    import cv2
    import numpy as np

    from yolov7_d2_tpu_torch.data.coco import COCO_CATEGORY_IDS

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(n):
        img = rng.integers(0, 60, (480, 640, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(1, 9))):
            bw, bh = (int(v) for v in rng.integers(24, 320, 2))
            x = int(rng.integers(0, 640 - bw))
            y = int(rng.integers(0, 480 - bh // 2))
            bh = min(bh, 480 - y)
            img[y:y + bh, x:x + bw] = rng.integers(60, 256, 3)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
            if keypoints:
                v = rng.integers(0, 3, 17)
                pts = np.stack([x + rng.uniform(0, bw, 17),
                                y + rng.uniform(0, bh, 17)], -1)
                kp = np.concatenate([np.where(v[:, None] > 0, pts, 0.0),
                                     v[:, None]], -1)
                anns[-1].update(category_id=1, num_keypoints=int(
                    (v > 0).sum()), keypoints=[float(k) for k in
                                               kp.reshape(-1)])
            if segm:
                anns[-1]["segmentation"] = [[
                    x, y, x + bw, y, x + bw, y + 0.6 * bh,
                    x + 0.6 * bw, y + bh, x, y + bh]]
        name = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append({"id": i + 1, "file_name": name, "height": 480,
                       "width": 640})
    js = os.path.join(root, "instances.json")
    with open(js, "w") as f:
        cats = [1] if keypoints else COCO_CATEGORY_IDS
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": str(c)} for c in cats]}, f)
    return js, img_dir


def cli_argv(out: str, *flags, **opts) -> list:
    """``train_det``'s command line for ``configs/coco/yolox_s.yaml`` on the
    mini-COCO: 16 images a step, 12 steps, a checkpoint every 6, the COCO
    eval at 12; ``opts`` (keys with ``__`` for ``.``) override."""
    base = {"DATASETS.TRAIN": (CLI_DATASET,), "DATASETS.TEST": (CLI_DATASET,),
            "OUTPUT_DIR": out, "SEED": SEED,
            "SOLVER.IMS_PER_BATCH": TRAIN_BATCH, "SOLVER.MAX_ITER": 12,
            "SOLVER.CHECKPOINT_PERIOD": 6, "TEST.EVAL_PERIOD": 12}
    base.update({k.replace("__", "."): v for k, v in opts.items()})
    argv = ["--config-file",
            os.path.join(REPO, "configs", "coco", "yolox_s.yaml"), *flags]
    for k, v in base.items():
        argv += [k, v if isinstance(v, str) else repr(v)]
    return argv


def cli_args(out: str, *flags, **opts):
    """:func:`cli_argv` parsed by the entry points' parser."""
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    return default_argument_parser().parse_args(cli_argv(out, *flags, **opts))


def loader_rate(loader, batches: int = 10, to=None) -> float:
    """Images a second of ``loader`` over ``batches`` batches after its
    first (host clock; with ``to``, through a ``CudaPrefetcher`` onto that
    device, synchronized at the end)."""
    from yolov7_d2_tpu_torch.data.loader import CudaPrefetcher

    it = iter(loader if to is None else CudaPrefetcher(loader, to))
    first = next(it)
    t0 = time.perf_counter()
    n = sum(len(next(it)["image"]) for _ in range(batches))
    if to is not None:
        torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    it.close()
    del first
    return rate


def cli_checks(trainer, out: str, name: str) -> dict:
    """Finite losses, weights and EMA moved since the first checkpoint;
    returns the storage's last scalars."""
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer

    latest = trainer.storage.latest()
    for key in ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_l1",
                "grad_norm"):
        if key not in latest or not math.isfinite(latest[key]):
            raise AssertionError(f"{name}: {key} = {latest.get(key)}")
    ckpt = Checkpointer(os.path.join(out, "ckpt"))
    first = ckpt.load(ckpt.steps()[0], map_location="cpu")
    state = trainer.state
    for kind, now, then in (
            ("parameters", dict(state.model.named_parameters()),
             first["model"]),
            ("EMA", state.ema_params, first["ema_params"])):
        if all(torch.equal(v.detach().cpu(), then[k]) for k, v in now.items()):
            raise AssertionError(f"{name}: no {kind} moved after step "
                                 f"{ckpt.steps()[0]}")
    return latest


@dataclasses.dataclass
class CliData:
    """The CLI phases' synthetic mini-COCO (registered as CLI_DATASET) and
    its packed shards, under ``work``."""

    work: str
    js: str
    img_dir: str
    records: list
    geo: str
    plain: str


def write_cli_data(**opts) -> CliData:
    """Write the mini-COCO of 64 JPEGs and its geometry and plain shards
    (``opts`` override config keys), and register it."""
    from yolov7_d2_tpu_torch.data.catalog import register_coco_instances
    from yolov7_d2_tpu_torch.data.coco import load_coco_json
    from yolov7_d2_tpu_torch.data.packed_cache import (
        write_geometry_shards,
        write_plain_shards,
    )
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    work = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    js, img_dir = write_mini_coco(work)
    register_coco_instances(CLI_DATASET, {}, js, img_dir)
    records = load_coco_json(js, img_dir)
    ccfg = setup_cfg(cli_args(work, **opts))
    geo, plain = os.path.join(work, "geo"), os.path.join(work, "plain")
    write_geometry_shards(records, ccfg, geo)
    write_plain_shards(records, ccfg, plain)
    log(f"cli: mini-COCO of {len(records)} images 640x480 and its packed "
        f"shards (geometry, plain) written in "
        f"{time.perf_counter() - t0:.2f} s")
    return CliData(work, js, img_dir, records, geo, plain)


def cli_phase(dev, card: str, kernels: dict, data: CliData, **opts):
    """``train_det.main`` as a user runs it: ``configs/coco/yolox_s.yaml``
    at 640 px and 80 classes on the synthetic mini-COCO of 64 JPEGs
    (``opts`` override config keys). Run A is the host mosaic feed, with
    the COCO eval at step 12 and then ``--resume`` to 16; run B the packed
    feed with GridMask on and the plain shards from step 8. Checks the
    runs, sets the kernels' ``launches`` to the CLI's and returns the
    median seconds a step of each feed."""
    import numpy as np

    from yolov7_d2_tpu_torch import native, train_det
    from yolov7_d2_tpu_torch.data import mappers
    from yolov7_d2_tpu_torch.data.loader import build_detection_train_loader
    from yolov7_d2_tpu_torch.data.packed_cache import PackedShardLoader
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    work, records, geo, plain = data.work, data.records, data.geo, data.plain
    ccfg = setup_cfg(cli_args(work, **opts))

    # the loaders alone, 10 batches of 16 after the first
    host_rate = loader_rate(build_detection_train_loader(
        ccfg, records, mappers.YOLOXDatasetMapper(ccfg, seed=0)))
    host_card_rate = loader_rate(build_detection_train_loader(
        ccfg, records, mappers.YOLOXDatasetMapper(ccfg, seed=0)), to=dev)
    packed_rate = loader_rate(PackedShardLoader(
        geo, TRAIN_BATCH, image_dtype=np.uint8, seed=SEED))
    packed_card_rate = loader_rate(PackedShardLoader(
        geo, TRAIN_BATCH, image_dtype=np.uint8, seed=SEED), to=dev)
    log(f"cli loaders on [{card}], {TRAIN_BATCH} images a batch: host "
        f"mosaic (YOLOXDatasetMapper, {ccfg.DATALOADER.NUM_WORKERS} "
        f"threads) {host_rate:.1f} img/s alone, {host_card_rate:.1f} img/s "
        f"through CudaPrefetcher onto the card; packed shards "
        f"{packed_rate:.1f} img/s alone, {packed_card_rate:.1f} img/s onto "
        f"the card")

    # run A: the host mosaic feed
    out_a = os.path.join(work, "host")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    run_a = train_det.main(cli_args(out_a, **opts))
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches_a = dict(build.LAUNCHES)
    log(f"cli run A (host mosaic) launches: {launches_a}")
    latest_a = cli_checks(run_a, out_a, "cli run A")
    eval_batches = -(-len(records) // TRAIN_BATCH)
    for name in ("normalize", "nms"):
        if launches_a.get(name, 0) != eval_batches:
            raise AssertionError(f"cli run A: {name} launched "
                                 f"{launches_a.get(name, 0)} times for "
                                 f"{eval_batches} eval batches")
    if launches_a.get("grid_mask", 0):
        raise AssertionError("cli run A: GridMask ran on the host feed")
    missing = [k for k in COCO_KEYS if f"eval/{k}" not in latest_a]
    if missing:
        raise AssertionError(f"cli run A: no COCO {missing} in {latest_a}")
    kernels["normalize"]["launches"] = launches_a["normalize"]
    kernels["nms"]["launches"] = launches_a["nms"]
    median_a = run_a.storage.median("time_per_iter")
    letterbox = ("native (build/native)" if mappers._NATIVE else
                 f"cv2: the native build failed: {native.BUILD_ERROR}")
    log(f"cli letterbox: {letterbox} for the eval and plain samples; the "
        f"mosaic samples take cv2's, as the JAX mapper does")
    log("cli run A COCO eval at step 12: " + ", ".join(
        f"{k} {latest_a['eval/' + k]:.4f}" for k in COCO_KEYS))

    eval_fn = train_det.build_eval_fn(ccfg, records)
    build.reset_launches()
    t0 = time.perf_counter()
    eval_fn(run_a)
    eval_s = time.perf_counter() - t0
    if dict(build.LAUNCHES) != {"normalize": eval_batches,
                                "nms": eval_batches}:
        raise AssertionError(f"eval launches {dict(build.LAUNCHES)}")
    ckpt = Checkpointer(os.path.join(work, "ckpt_timed"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(12, run_a.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    save_mb = os.path.getsize(ckpt.path(12)) / 1e6
    del run_a

    run_r = train_det.main(cli_args(out_a, "--resume", SOLVER__MAX_ITER=16,
                                    **opts))
    if run_r.start_iter != 12 or run_r.storage.iter != 16:
        raise AssertionError(f"cli --resume ran {run_r.start_iter} -> "
                             f"{run_r.storage.iter}, not 12 -> 16")
    cli_checks(run_r, out_a, "cli --resume")
    log(f"cli --resume: started at {run_r.start_iter}, ran to "
        f"{run_r.storage.iter}; checkpoints "
        f"{Checkpointer(os.path.join(out_a, 'ckpt')).steps()}")
    del run_r

    # run B: the packed feed, GridMask on, plain shards from step 8
    out_b = os.path.join(work, "packed")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    run_b = train_det.main(cli_args(
        out_b, DATALOADER__PACKED_CACHE_DIR=geo,
        DATALOADER__PACKED_CACHE_PLAIN_DIR=plain,
        INPUT__GRID_MASK__ENABLED=True,
        INPUT__MOSAIC_AND_MIXUP__DISABLE_AT_ITER=8, TEST__EVAL_PERIOD=0,
        **opts))
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = dict(build.LAUNCHES)
    log(f"cli run B (packed) launches: {launches_b}")
    cli_checks(run_b, out_b, "cli run B")
    # GridMask once a step before DISABLE_AT_ITER and never after; after
    # it the plain uint8 images go through the normalize kernel
    if launches_b.get("grid_mask", 0) != 8 or \
            launches_b.get("normalize", 0) != 4 or launches_b.get("nms", 0):
        raise AssertionError(f"cli run B launches {launches_b}: GridMask "
                             "must run at steps 0-7 only, normalize at 8-11")
    kernels["grid_mask"]["launches"] = launches_b["grid_mask"]
    median_b = run_b.storage.median("time_per_iter")
    del run_b
    torch.cuda.empty_cache()

    log(f"cli run A, host mosaic feed, on [{card}]: time_per_iter median "
        f"{median_a * 1e3:.3f} ms = {TRAIN_BATCH / median_a:.1f} img/s; "
        f"12 steps, eval and 2 checkpoints in {wall_a:.2f} s (build "
        f"included)")
    log(f"cli run B, packed feed, on [{card}]: time_per_iter median "
        f"{median_b * 1e3:.3f} ms = {TRAIN_BATCH / median_b:.1f} img/s; "
        f"12 steps and 2 checkpoints in {wall_b:.2f} s (build included)")
    log(f"cli eval on [{card}]: {len(records)} images in {eval_s:.3f} s = "
        f"{len(records) / eval_s:.1f} img/s (mapper, normalize, forward, "
        f"NMS, COCO matching)")
    log(f"cli checkpoint on [{card}]: save {save_ms:.1f} ms, "
        f"{save_mb:.1f} MB (model, optimizer, EMA)")
    return median_a, median_b


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def loss_assignment(outs, key_obj, batch, grids, strides, k) -> dict:
    """What ``yolox_losses`` keeps and matches of head outputs ``outs``
    [B, A, 5 + C] of one batch: its top-``k`` prefilter (None: off), ranked
    by the objectness logits ``key_obj`` [B, A], then SimOTA on the kept
    anchors. Returns ``kept``, ``fg`` (bool) and ``matched_gt`` over all
    A."""
    from yolov7_d2_tpu_torch.models.heads.yolox_head import (
        _geometry_prior,
        _prefilter_key,
        decode_outputs,
        simota_assign,
    )

    gts = [batch[k].to(outs.device)
           for k in ("gt_boxes", "gt_classes", "gt_valid")]
    b, a_total, width = outs.shape
    if k is None or k >= a_total:
        top = torch.arange(a_total, device=outs.device).expand(b, -1)
    else:
        in_box, in_center = _geometry_prior(grids, strides, gts[0])
        cand_any = ((in_box | in_center) & gts[2][..., None]).any(-2)
        top = torch.topk(_prefilter_key(cand_any, key_obj), k,
                         dim=-1).indices.sort(dim=-1).values
    out_k = outs.gather(1, top[..., None].expand(-1, -1, width))
    grids_k, strides_k = grids[top], strides[top]
    got = simota_assign(*decode_outputs(out_k, grids_k, strides_k), grids_k,
                        strides_k, *gts)

    def over_a(v, dtype):
        return torch.zeros((b, a_total), dtype=dtype,
                           device=outs.device).scatter(1, top, v.to(dtype))

    return {"kept": over_a(torch.ones_like(top), torch.bool),
            "fg": over_a(got["fg_mask"], torch.bool),
            "matched_gt": over_a(got["matched_gt"], torch.long)}


def assignment_gaps(outs, other, batch, grids, strides, k) -> tuple:
    """Between the one process's head outputs ``outs`` and the ranks'
    ``other`` [B, A, 5 + C] of one batch: the anchors the loss's top-``k``
    prefilter of each keeps apart (each ranked by its own objectness), and
    the anchors whose SimOTA assignment (foreground, matched box) differs
    among those the ranks keep (both ranked by the ranks' objectness, as
    in :func:`sync_phase`'s one-process step)."""
    ranks = loss_assignment(other, other[..., 4], batch, grids, strides, k)
    own = loss_assignment(outs, outs[..., 4], batch, grids, strides, k)
    one = loss_assignment(outs, other[..., 4], batch, grids, strides, k)
    kept_apart = int((own["kept"] != ranks["kept"]).sum())
    flips = int(((one["fg"] != ranks["fg"])
                 | (one["fg"] & (one["matched_gt"] != ranks["matched_gt"])))
                .sum())
    return kept_apart, flips


@contextlib.contextmanager
def prefilter_ranked_by(obj_logits: torch.Tensor):
    """Within the block, ``yolox_losses``'s top-K prefilter ranks the
    anchors by ``obj_logits`` [B, A] (another run's objectness of the same
    batch) in place of the step's own: both runs' losses then keep the
    same anchors."""
    from yolov7_d2_tpu_torch.models.heads import yolox_head

    own = yolox_head._prefilter_key
    yolox_head._prefilter_key = lambda cand_any, _: own(cand_any, obj_logits)
    try:
        yield
    finally:
        yolox_head._prefilter_key = own


def sync_phase(dev, card: str, cfg, world: int = 2,
               backend: str = "gloo", follow_ranks: bool = True):
    """(a) ``world`` ranks on one card over gloo (``launch(...,
    backend="gloo")``), or (c) one card each over NCCL: the bare YOLOX-s
    640 train step in float32, TF32 off, 2 images a rank, 3 steps
    (``parallel.dryrun.train_steps``: ``SyncBatchNorm2d``, the global
    foreground count, DDP), against the one-process step on the same
    images, each step taken from the ranks' weights before it
    (``follow_ranks``; else one process follows its own updates): the fg
    count equal, the summed loss shares and the gradient norm within 1e-3
    relative (the card-vs-CPU bound of section 9), and parameters, EMA and
    BN buffers bitwise equal across the ranks. From the ranks' weights,
    because two runs that update apart drift on the card by more than one
    step differs: one process against itself moves its head outputs by
    3.1e-4 of their max by step 2 (``tools/sync_step_gap.py``). The one
    process's loss keeps the anchors the ranks' top-K prefilter kept
    (:func:`prefilter_ranked_by`): these images hold 4000-8000 SimOTA
    candidates of 8400 anchors, the prefilter keeps 2100 by objectness,
    and head outputs 3e-5 apart reorder anchors at that boundary, which
    moves a loss by a jump and not by rounding. Logs how far the head
    outputs differ, in how many anchors the prefilter of each run's own
    outputs keeps apart, and in how many anchors the SimOTA assignment of
    each run's outputs differs among those kept (:func:`assignment_gaps`);
    with ``follow_ranks`` also the gaps of the one-process step under its
    own prefilter (taken first from the same weights, not held).
    Both count the CUDA kernels the host launches in step 1. Returns the
    batches, the one process's head outputs and the ranks' outputs, step
    by step."""
    from yolov7_d2_tpu_torch.engine import (
        build_yolox_system,
        resolve_simota_prefilter,
    )
    from yolov7_d2_tpu_torch.parallel.dryrun import train_steps
    from yolov7_d2_tpu_torch.parallel.launch import launch
    from yolov7_d2_tpu_torch.utils.profiling import count_cuda_launches

    label = "(a)" if backend == "gloo" else "(c)"
    fcfg = dataclasses.replace(cfg, amp=False)
    gen = torch.Generator().manual_seed(SEED + 2)
    batches = [train_batch(2 * world, gen) for _ in range(3)]
    out = os.path.join(REPO, "build", "chip_smoke_ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    # the ranks start with torch's defaults: TF32 off for them as here
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    t0 = time.perf_counter()
    try:
        # gloo: every rank on ``dev``; NCCL: rank i on card i
        launch(train_steps, world, args=(
            out, fcfg, batches, str(dev) if backend == "gloo" else dev.type,
            SEED, None, 1 if dev.type == "cuda" else None, True,
            follow_ranks), backend=backend)
    finally:
        del os.environ["NVIDIA_TF32_OVERRIDE"]
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)

    k = resolve_simota_prefilter(fcfg)
    _, state, step = build_yolox_system(fcfg, device=dev, seed=SEED)
    heads = []
    state.model.register_forward_hook(
        lambda module, args, head: heads.append(
            {k: v.detach().float() for k, v in head.items()}))
    one, own = [], []
    for i, batch in enumerate(batches):
        batch = {k: v.to(dev) for k, v in batch.items()}
        if follow_ranks:
            # first the step under its own prefilter, for the log only
            state.model.load_state_dict(ranks[0]["weights"][i])
            state.step = i
            state, m = step(state, batch)
            own.append({k: float(v) for k, v in m.items()})
            heads.pop()
            state.model.load_state_dict(ranks[0]["weights"][i])
            state.step = i
        ranked = torch.cat([rec["outputs"][i][..., 4] for rec in ranks])
        with prefilter_ranked_by(ranked.to(dev)):
            if i == 1:
                (state, m), launches_one = count_cuda_launches(
                    lambda: step(state, batch))
            else:
                state, m = step(state, batch)
        one.append({k: float(v) for k, v in m.items()})
    for i, want in enumerate(one):
        ms = [rec["metrics"][i] for rec in ranks]
        loss = sum(m["total_loss"] for m in ms)
        outs = heads[i]["outputs"]
        other = torch.cat([rec["outputs"][i] for rec in ranks]).to(dev)
        out_gap = float((other - outs).abs().max() / outs.abs().max())
        kept_apart, flips = assignment_gaps(
            outs, other, batches[i], heads[i]["grids"], heads[i]["strides"],
            k)
        gaps = {k: relative_gap(got, want[k]) for k, got in (
            ("total_loss", loss), ("grad_norm", ms[0]["grad_norm"]))}
        log(f"{label} step {i}: {world} ranks / one process: total_loss "
            f"{loss:.6g} / {want['total_loss']:.6g} ({gaps['total_loss']:.2e}"
            f"), grad_norm {ms[0]['grad_norm']:.6g} / "
            f"{want['grad_norm']:.6g} ({gaps['grad_norm']:.2e}), num_fg "
            f"{ms[0]['num_fg']:.0f} / {want['num_fg']:.0f}; head outputs "
            f"differ by {out_gap:.2e} of their max; the top-{k} prefilter "
            f"of each keeps {kept_apart} anchors apart (the one process "
            f"takes the ranks'), SimOTA assignments differ in {flips}"
            + ("" if not own else "; under its own prefilter the one "
               f"process is {relative_gap(loss, own[i]['total_loss']):.2e}"
               " in total_loss and "
               f"{relative_gap(ms[0]['grad_norm'], own[i]['grad_norm']):.2e}"
               " in grad_norm apart (not held)"))
        if any(m["num_fg"] != want["num_fg"] for m in ms):
            raise AssertionError(f"{label} step {i}: fg counts differ")
        if len({m["grad_norm"] for m in ms}) != 1:
            raise AssertionError(f"{label} step {i}: the ranks' gradient "
                                 "norms differ")
        for key, gap in gaps.items():
            if gap > 1e-3:
                raise AssertionError(f"{label} step {i}: {key} off by "
                                     f"{gap:.2e} relative to one process, "
                                     "above 1e-3")
    for rec in ranks[1:]:
        for key in ("model", "ema"):
            for name, v in ranks[0][key].items():
                if not torch.equal(v, rec[key][name]):
                    raise AssertionError(f"{label} ranks differ in {key} "
                                         f"{name}")
    if any(rec["step"] != 3 for rec in ranks):
        raise AssertionError(f"{label} the ranks took other than 3 steps")
    launches_rank = ranks[0]["metrics"][1].get("launches")
    where = ("on one card, host-paced over gloo and not a multi-GPU rate"
             if backend == "gloo" else "over NCCL, one card each")
    log(f"{label} {world} {backend} ranks [{card}]: parameters, BN buffers "
        f"and EMA bitwise equal across the ranks after 3 steps; CUDA kernel "
        f"launches in step 1: one process {launches_one} ({2 * world} "
        f"images), a rank {launches_rank} (2 images, SyncBatchNorm2d + DDP); "
        f"{wall:.2f} s for the spawn, 3 steps and the ranks' start-up, "
        f"{where}")
    return batches, heads, [rec["outputs"] for rec in ranks]


def sync_bn_phase(dev, card: str, world: int = 2,
                  backend: str = "gloo") -> None:
    """``SyncBatchNorm2d`` alone on CUDA tensors (its fused path), ``world``
    ranks on one card over gloo or one card each over NCCL
    (``parallel.dryrun.norm_sync_ranks``), at a YOLOX-s 640 layer's shape
    (2 images a rank, 128 channels at 80 x 80, channels_last), in float32
    and in bfloat16 (the recipe's activations, float32 weights), against
    ``nn.BatchNorm2d`` (cuDNN) on the whole batch on this card: output,
    input gradient, the summed weight and bias gradients, the running
    statistics, and ``all_reduce_norm`` and ``precise_bn`` against their
    one-process values; every rank's statistics bitwise equal. Bounds, of
    the reference's largest magnitude: float32 1e-4 (the same moments in
    another sum order); bfloat16 1e-2 for the outputs and gradients (both
    round to bfloat16, whose step is 2^-8 of a value) and 1e-4 for the
    statistics (float32 moments of the same bfloat16 inputs)."""
    from yolov7_d2_tpu_torch.parallel.dryrun import norm_sync_ranks
    from yolov7_d2_tpu_torch.parallel.launch import launch
    from yolov7_d2_tpu_torch.parallel.norm_sync import (
        SyncBatchNorm2d,
        precise_bn,
    )

    label = "(a)" if backend == "gloo" else "(c)"
    n, c, hw = 2 * world, 128, 80
    gen = torch.Generator().manual_seed(SEED + 4)
    params = {"weight": torch.rand(c, generator=gen) + 0.5,
              "bias": torch.randn(c, generator=gen), "eps": 1e-3,
              "momentum": 0.03}
    running = torch.stack([torch.stack([torch.randn(c, generator=gen),
                                        torch.rand(c, generator=gen) + 0.5])
                           for _ in range(world)])
    out = os.path.join(REPO, "build", "chip_smoke_bn")

    def nhwc(t, dtype):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    for dtype, close, stat_close in ((torch.float32, 1e-4, 1e-4),
                                     (torch.bfloat16, 1e-2, 1e-4)):
        x = nhwc(torch.randn((n, c, hw, hw), generator=gen) * 3.0 + 1.0,
                 dtype)
        grad_out = nhwc(torch.randn((n, c, hw, hw), generator=gen), dtype)
        batches = torch.stack([
            nhwc(torch.randn((n, c, hw, hw), generator=gen) * 2.0 - 1.0,
                 dtype) for _ in range(2)])
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        launch(norm_sync_ranks, world, args=(
            out, params, x, grad_out, running, batches,
            str(dev) if backend == "gloo" else dev.type), backend=backend)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=True) for r in range(world)]
        shutil.rmtree(out, ignore_errors=True)
        for key in ("running_mean", "running_var", "reduced_mean",
                    "reduced_var", "precise_mean", "precise_var"):
            if any(not torch.equal(r[key], ranks[0][key]) for r in ranks):
                raise AssertionError(f"{label} SyncBatchNorm2d {dtype}: the "
                                     f"ranks' {key} differ")
        ref = torch.nn.BatchNorm2d(c, eps=1e-3, momentum=0.03).to(dev)
        with torch.no_grad():
            ref.weight.copy_(params["weight"])
            ref.bias.copy_(params["bias"])
        xr = x.to(dev).requires_grad_(True)
        y = ref(xr)
        y.backward(grad_out.to(dev))
        one = SyncBatchNorm2d(c, eps=1e-3, momentum=0.03).to(dev)
        precise_bn(one, [b.to(dev) for b in batches])
        want = {
            "y": (torch.cat([r["y"] for r in ranks]), y, close),
            "x_grad": (torch.cat([r["x_grad"] for r in ranks]), xr.grad,
                       close),
            "weight_grad": (sum(r["weight_grad"] for r in ranks),
                            ref.weight.grad, close),
            "bias_grad": (sum(r["bias_grad"] for r in ranks), ref.bias.grad,
                          close),
            "running_mean": (ranks[0]["running_mean"], ref.running_mean,
                             stat_close),
            "running_var": (ranks[0]["running_var"], ref.running_var,
                            stat_close),
            "reduced_mean": (ranks[0]["reduced_mean"], running[:, 0].mean(0),
                             1e-6),
            "reduced_var": (ranks[0]["reduced_var"], running[:, 1].mean(0),
                            1e-6),
            "precise_mean": (ranks[0]["precise_mean"], one.running_mean,
                             stat_close),
            "precise_var": (ranks[0]["precise_var"], one.running_var,
                            stat_close),
        }
        errs = {}
        for key, (got, ref_t, tol) in want.items():
            ref_t = ref_t.detach().float().cpu()
            errs[key] = float((got.float().cpu() - ref_t).abs().max()
                              / ref_t.abs().max())
            if not errs[key] <= tol:
                raise AssertionError(f"{label} SyncBatchNorm2d {dtype}: {key} "
                                     f"off by {errs[key]:.2e} of its max, "
                                     f"above {tol}")
        log(f"{label} SyncBatchNorm2d {str(dtype).split('.')[-1]} on "
            f"{world} {backend} ranks [{card}] vs nn.BatchNorm2d on "
            f"[{n},{c},{hw},{hw}]: " + ", ".join(
                f"{k} {e:.2e}" for k, e in errs.items())
            + " (of the max); the ranks' statistics bitwise equal")


def packed_step_ms(dev, cfg, batches, in_group: bool) -> float:
    """Milliseconds a step of section 8's on-card packed step (16 images,
    GridMask on), 10 steps after 3, built inside an NCCL group of 1 (DDP)
    or without a group."""
    import torch.distributed as dist

    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.parallel.dist import init_distributed
    from yolov7_d2_tpu_torch.parallel.launch import local_dist_url

    if in_group:
        init_distributed("nccl", local_dist_url(), 1, 0)
    try:
        _, state, train_step = build_yolox_system(cfg, device=dev, seed=SEED)
        if (state.ddp is not None) != in_group:
            raise AssertionError("DDP built where it should not, or not "
                                 "where it should")
        step = make_packed_photo_step(cfg, train_step, seed=SEED)
        for i in range(WARMUP):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / ITERS
    finally:
        if in_group:
            dist.destroy_process_group()


def ddp_world1_phase(dev, card: str, kernels: dict, data: CliData,
                     cfg=None, **opts) -> None:
    """(b) The CLI's packed feed (``train_det.main``, 6 steps of 16 images,
    GridMask until ``DISABLE_AT_ITER`` 4, plain shards after, the COCO eval
    at 6 on rank 0) inside an NCCL group of 1: ``SyncBatchNorm2d`` (plain at
    a world of 1) and DDP. Its losses at step 6 against the run of the same
    steps without a group within 1e-3 relative; the medians of both runs'
    ``time_per_iter`` logged. Six CLI steps hold a first step, a shard
    load and a checkpoint, so DDP's cost on one card is timed apart, where
    ``cfg`` is given: section 8's on-card step, in turns without a group,
    in the group, in the group, without. Sets the kernels' ``launches`` to
    the CLI run's."""
    import torch.distributed as dist

    from yolov7_d2_tpu_torch import train_det
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.parallel.dist import init_distributed
    from yolov7_d2_tpu_torch.parallel.launch import local_dist_url

    steps, disable_at = 6, 4
    packed = dict(DATALOADER__PACKED_CACHE_DIR=data.geo,
                  DATALOADER__PACKED_CACHE_PLAIN_DIR=data.plain,
                  INPUT__GRID_MASK__ENABLED=True,
                  INPUT__MOSAIC_AND_MIXUP__DISABLE_AT_ITER=disable_at,
                  SOLVER__MAX_ITER=steps, SOLVER__CHECKPOINT_PERIOD=3,
                  **opts)
    init_distributed("nccl", local_dist_url(), 1, 0)
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        run_d = train_det.main(cli_args(
            os.path.join(data.work, "ddp1"), TEST__EVAL_PERIOD=steps,
            **packed))
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        dist.destroy_process_group()
    log(f"(b) NCCL world 1 launches: {launches}")
    if run_d.state.ddp is None:
        raise AssertionError("(b) the run inside a group built no DDP")
    eval_batches = -(-len(data.records) // TRAIN_BATCH)
    want = {"grid_mask": disable_at, "nms": eval_batches,
            "normalize": steps - disable_at + eval_batches}
    if launches != want:
        raise AssertionError(f"(b) launches {launches}, not {want}: GridMask "
                             "at every step before DISABLE_AT_ITER, normalize"
                             " on the plain steps and in the eval, NMS in "
                             "the eval")
    for name, n in want.items():
        kernels[name]["launches"] = n
    latest_d = cli_checks(run_d, os.path.join(data.work, "ddp1"), "(b)")
    missing = [k for k in COCO_KEYS if f"eval/{k}" not in latest_d]
    if missing:
        raise AssertionError(f"(b) rank 0's eval gave no COCO {missing}")
    median_d = run_d.storage.median("time_per_iter")
    del run_d

    t0 = time.perf_counter()
    run_p = train_det.main(cli_args(os.path.join(data.work, "plain1"),
                                    TEST__EVAL_PERIOD=0, **packed))
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    if run_p.state.ddp is not None:
        raise AssertionError("(b) one process without a group built DDP")
    latest_p = cli_checks(run_p, os.path.join(data.work, "plain1"),
                          "(b) no group")
    median_p = run_p.storage.median("time_per_iter")
    del run_p
    torch.cuda.empty_cache()
    keys = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_l1",
            "num_fg", "grad_norm")
    log(f"(b) step {steps}, NCCL world 1 / no group: " + ", ".join(
        f"{k} {latest_d[k]:.6g} / {latest_p[k]:.6g}" for k in keys))
    for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_l1"):
        if relative_gap(latest_d[k], latest_p[k]) > 1e-3:
            raise AssertionError(f"(b) {k} differs from the run without a "
                                 "group")
    log(f"(b) packed CLI feed on [{card}], {TRAIN_BATCH} images a step: "
        f"time_per_iter median {median_d * 1e3:.3f} ms in an NCCL group of 1 "
        f"(DDP) against {median_p * 1e3:.3f} ms without a group: ratio "
        f"{median_d / median_p:.4f}; {steps} steps in {wall_d:.2f} s (eval "
        f"included) and {wall_p:.2f} s")
    if cfg is None:
        return
    tcfg = dataclasses.replace(cfg, grid_mask=True)
    gen = torch.Generator().manual_seed(SEED + 3)
    batches = [{k: v.to(dev) for k, v in train_batch(TRAIN_BATCH,
                                                     gen).items()}
               for _ in range(4)]
    turns = [(g, packed_step_ms(dev, tcfg, batches, g))
             for g in (False, True, True, False)]
    plain = [ms for g, ms in turns if not g]
    ddp = [ms for g, ms in turns if g]
    log(f"(b) on-card packed step, {TRAIN_BATCH} images, on [{card}], in "
        f"turns (no group, NCCL group of 1, group, no group): "
        + ", ".join(f"{ms:.3f}" for _, ms in turns) + " ms a step; DDP at "
        f"world 1 / no group: {sum(ddp) / sum(plain):.4f}")


def nccl_ranks_phase(dev, card: str, cfg, data: CliData, **opts) -> None:
    """(c) Where two or more cards are visible, N of them (up to 4) over
    NCCL, one a rank: ``dryrun_multigpu(N)`` (the tiny system, one step,
    ranks equal), :func:`sync_phase`'s bare step against one process,
    :func:`sync_bn_phase`, then ``train_custom_datasets --num-gpus N`` on
    the packed feed, 16 images a rank, 6 steps, the COCO eval at 6 on rank
    0; rank 0's metrics.json and checkpoint checked. Logged as skipped on
    one card."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        log(f"(c) NCCL ranks: skipped, {n} CUDA card visible (needs 2)")
        return
    from yolov7_d2_tpu_torch import train_custom_datasets
    from yolov7_d2_tpu_torch.parallel.dryrun import dryrun_multigpu
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer

    t0 = time.perf_counter()
    ranks = dryrun_multigpu(n)
    log(f"(c) dryrun_multigpu({n}) over NCCL [{card}] x{n}: total_loss "
        f"{sum(r['metrics'][0]['total_loss'] for r in ranks):.6g}, ranks "
        f"equal, {time.perf_counter() - t0:.2f} s with start-up")
    sync_phase(dev, card, cfg, world=n, backend="nccl")
    sync_bn_phase(dev, card, world=n, backend="nccl")
    out = os.path.join(data.work, "nccl")
    t0 = time.perf_counter()
    train_custom_datasets.main([
        "--register", CLI_DATASET, data.js, data.img_dir, "--num-gpus",
        str(n), *cli_argv(out, DATALOADER__PACKED_CACHE_DIR=data.geo,
                          INPUT__GRID_MASK__ENABLED=True,
                          SOLVER__IMS_PER_BATCH=n * TRAIN_BATCH,
                          SOLVER__MAX_ITER=6, SOLVER__CHECKPOINT_PERIOD=6,
                          TEST__EVAL_PERIOD=6, **opts)])
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(line) for line in f]
    last = lines[-1]
    if [r["iteration"] for r in lines] != [6] or not math.isfinite(
            last["total_loss"]) or "eval/AP" not in last:
        raise AssertionError(f"(c) rank 0's metrics.json: {lines}")
    if Checkpointer(os.path.join(out, "ckpt")).steps() != [6]:
        raise AssertionError("(c) no checkpoint at step 6")
    log(f"(c) {n} NCCL ranks on [{card}] x{n}: the CLI's packed feed, 6 "
        f"steps of {TRAIN_BATCH} images a rank, eval included, in "
        f"{wall:.2f} s (start-up included); step 6: total_loss "
        f"{last['total_loss']:.6g}, num_fg {last['num_fg']:.0f}, "
        f"time_per_iter {last['time_per_iter'] * 1e3:.3f} ms on rank 0")


def anchor_yolo_cfg(yaml: str, **replace):
    """An ``AnchorYoloConfig`` from ``configs/coco/<yaml>`` (merged into the
    port's ``get_cfg``, as a user's config is), with dataclass fields
    replaced."""
    from yolov7_d2_tpu_torch.config import AnchorYoloConfig
    from yolov7_d2_tpu_torch.config.defaults import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "coco", yaml))
    return dataclasses.replace(AnchorYoloConfig.from_cfg(cfg), **replace)


def anchor_tail(head, cfg, nms=None):
    """``anchor_yolo_postprocess`` of ``cfg``'s architecture on head
    outputs, with the NMS kernel unless ``nms`` is given."""
    from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import (
        anchor_yolo_postprocess,
    )

    variant = cfg.variant if cfg.meta_architecture == "YOLO" else "yolov7"
    with torch.inference_mode():
        return anchor_yolo_postprocess(
            head, variant, cfg.conf_threshold, cfg.nms_threshold,
            cfg.max_detections, cfg.pre_nms_topk,
            **({} if nms is None else {"nms": nms}))


def anchor_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> head outputs
    -> :func:`anchor_tail` -> ``Detections``."""
    with torch.inference_mode():
        head = model(images)
    return head, anchor_tail(head, cfg)


def check_detections(dets, n: int, cfg, what: str) -> str:
    if dets.boxes.shape != (n, cfg.max_detections, 4) or \
            dets.valid.shape != (n, cfg.max_detections):
        raise AssertionError(f"{what}: Detections shapes "
                             f"{tuple(dets.boxes.shape)}")
    counts = dets.num_valid()
    if int(counts.min()) < 1:
        raise AssertionError(f"{what}: an image with no detection")
    if not torch.isfinite(dets.boxes[dets.valid]).all() or \
            not torch.isfinite(dets.scores).all():
        raise AssertionError(f"{what}: non-finite detections")
    return f"detections per image {int(counts.min())}-{int(counts.max())}"


def check_train_metrics(metrics, what: str) -> None:
    for i, m in enumerate(metrics):
        for key in ("loss_box", "loss_obj", "loss_cls", "total_loss",
                    "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"{what} step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_fg"]) > 1.0:
            raise AssertionError(f"{what} step {i}: no foreground anchor")


def anchor_yolo_phase(dev, card: str, gen: torch.Generator,
                      requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                      size: int = SIZE, small: int = 128) -> None:
    """Section 11: the anchor-YOLO family (``YOLOV7`` at 640 from
    ``configs/coco/yolov7.yaml``, full depth and width, bf16 compute over
    f32 weights from ``SEED``). (a) serving through ``build_model`` +
    ``anchor_yolo_postprocess`` (normalize and NMS kernels) at each request
    size, the kernel path against the plain one, the f32 card against the
    CPU at bs 1; (b) ``build_system``'s step in ``make_packed_photo_step``
    with GridMask (mode 1, prob 0.3) and mixup on, ``train_n`` images a step
    for 13 steps, then one f32 step on the card against the CPU; (c) one
    request and one train step each for ``YOLO`` (darknet53.yaml) and
    ``YOLOV7P`` (CSP-Darknet53), and ``YOLOV7P`` on ResNet-50 from
    ``configs/coco/r50.yaml`` (section 12 (f)). Each path's kernel launches
    are counted from 0."""
    from yolov7_d2_tpu_torch.data.device_aug import (
        DevicePhotometric,
        PhotoDraws,
        make_packed_photo_step,
    )
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
    from yolov7_d2_tpu_torch.models.build import build_model

    cfg = anchor_yolo_cfg("yolov7.yaml")
    model = build_model(cfg, dev, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"(11a) YOLOV7 {size} from configs/coco/yolov7.yaml: "
        f"{n_params / 1e6:.3f} M parameters, {model.dtype}")
    batches = [letterboxed_batch(n, gen)[:, :size, :size].contiguous()
               for n in requests]
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = anchor_serve(model, cfg, req.to(dev))
        log(f"(11a) request bs {req.shape[0]}: "
            + check_detections(dets, req.shape[0], cfg, "YOLOV7 serving"))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"(11a) YOLOV7 serving path launches: {launches}")
    for name in ("normalize", "nms"):
        if launches.get(name, 0) < len(requests):
            raise AssertionError(f"the YOLOV7 serving path launched {name} "
                                 f"{launches.get(name, 0)} times")

    big = batches[-1].to(dev)
    head, with_kernel = anchor_serve(model, cfg, big)
    with_plain = anchor_tail(head, cfg, nms=nms_batched_plain)
    for field in ("valid", "classes", "boxes", "scores"):
        if not torch.equal(getattr(with_kernel, field),
                           getattr(with_plain, field)):
            raise AssertionError(f"YOLOV7 bs {big.shape[0]}: Detections."
                                 f"{field} of the kernel path differ from "
                                 "the plain path")
    log(f"(11a) bs {big.shape[0]}: kernel-path Detections equal the "
        f"plain-path ones ({int(with_kernel.valid.sum())} kept)")

    # f32 on the card against the CPU at bs 1 (same modules, layout and
    # normalize kernel as bf16; only the convolutions' sum order differs)
    f32 = dataclasses.replace(cfg, amp=False)
    one = batches[0]
    with torch.inference_mode():
        ref = build_model(f32, "cpu", SEED)(one)["outputs"]
        on_card = build_model(f32, dev, SEED)(one.to(dev))["outputs"].cpu()
        bf16 = model(one.to(dev))["outputs"].float().cpu()
    scale = float(ref.abs().max())
    err32 = float((on_card - ref).abs().max())
    err16 = float((bf16 - ref).abs().max())
    log(f"(11a) bs 1 head outputs vs float32 on the CPU (max |ref| "
        f"{scale:.4g}): float32 card max err {err32:.4g} "
        f"({err32 / scale:.3g} of the max), bf16 {err16:.4g} on [{card}]")
    if err32 > 1e-4 * scale or err16 > 5e-2 * scale:
        raise AssertionError("YOLOV7 head outputs disagree with the CPU")

    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        e2e = cuda_ms(lambda: anchor_serve(model, cfg, x))
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(x))
            head = model(x)
        tail = cuda_ms(lambda: anchor_tail(head, cfg))
        log(f"YOLOV7 {size} bs {n} bf16 on [{card}]: e2e {e2e:.3f} ms = "
            f"{n * 1000 / e2e:.1f} img/s; forward-only {fwd:.3f} ms; tail "
            f"{tail:.3f} ms")
    del model, batches, big, head, with_kernel, with_plain, x
    torch.cuda.empty_cache()

    # ---- (b) training
    tcfg = dataclasses.replace(cfg, grid_mask=True, grid_mask_mode=1,
                               grid_mask_prob=0.3, mixup=True, ema=True)
    _, state, train_step, _ = build_system(tcfg, device=dev, seed=SEED)
    step = make_packed_photo_step(tcfg, train_step, seed=SEED)
    tbatches = [{k: v.to(dev) for k, v in train_batch(
        train_n, gen, size).items()} for _ in range(4)]
    before = snapshot(state)
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i in range(WARMUP):
        state, m = step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + ITERS):
        state, m = step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"(11b) YOLOV7 training path launches: {launches}")
    if launches.get("grid_mask", 0) < 1:
        raise AssertionError("the YOLOV7 training path never launched "
                             "grid_mask")
    masked = sum(m["grid_masked"] for m in metrics)
    if masked < 1:
        raise AssertionError("GridMask masked no image in YOLOV7 training")
    check_train_metrics(metrics, "YOLOV7 train")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"YOLOV7 training moved no {key} tensor")
    fmt = ("total_loss", "loss_box", "loss_obj", "loss_cls", "num_fg",
           "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"(11b) YOLOV7 train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    log(f"(11b) YOLOV7 {size} train step bs {train_n} bf16 on [{card}]: "
        f"{step_ms:.3f} ms a step = {train_n * 1000 / step_ms:.1f} img/s "
        f"(host clock over {ITERS} steps after {WARMUP}); peak memory "
        f"{peak_gb:.3f} GB; {masked} of {train_n * len(metrics)} images "
        f"GridMask-ed; parameters, EMA and BN statistics moved")
    del state, train_step, step, before, after, metrics, tbatches
    torch.cuda.empty_cache()

    # one f32 step, card against CPU: full depth and width, small px, 2
    # images, the same weights, batch and draws; TF32 off
    scfg = dataclasses.replace(tcfg, input_size=(small, small), amp=False,
                               warmup_iters=0)
    sbatch = train_batch(2, gen, small)
    draws = PhotoDraws(
        perm=torch.tensor([1, 0]), do_mix=torch.tensor([True, False]),
        grid_params=torch.tensor([[16, 8, 3, 5, 1], [12, 6, 2, 7, 0]],
                                 dtype=torch.int32),
        do_flip=torch.tensor([False, True]))
    got = {}
    for where in ("cpu", dev):
        _, st, ts, _ = build_system(scfg, device=where, seed=SEED)
        b = DevicePhotometric(scfg).apply(
            {k: v.to(where) for k, v in sbatch.items()}, draws)
        _, m = ts(st, b)
        got[str(where)] = {k: float(v) for k, v in m.items()}
    ref_m, card_m = got["cpu"], got[str(dev)]
    log(f"(11b) YOLOV7 float32 train step at {small} px, card vs CPU: "
        + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}" for k in fmt))
    if card_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError("YOLOV7 fg count differs between card and CPU")
    for k in ("total_loss", "loss_box", "loss_obj", "loss_cls",
              "grad_norm"):
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"YOLOV7 {k} differs between the card and "
                                 "the CPU")

    # ---- (c) the other two architectures: one request, one train step
    for arch, ccfg in (
            ("YOLO", anchor_yolo_cfg("darknet53.yaml")),
            ("YOLOV7P", anchor_yolo_cfg(
                "yolov7.yaml", meta_architecture="YOLOV7P")),
            ("YOLOV7P r50.yaml", anchor_yolo_cfg("r50.yaml"))):
        model = build_model(ccfg, dev, SEED)
        req = letterboxed_batch(requests[1], gen)[:, :size, :size]
        build.reset_launches()
        _, dets = anchor_serve(model, ccfg, req.contiguous().to(dev))
        torch.cuda.synchronize()
        serve_launches = dict(build.LAUNCHES)
        summary = check_detections(dets, req.shape[0], ccfg, arch)
        del model
        ccfg = dataclasses.replace(ccfg, grid_mask=True, ema=True)
        _, state, train_step, _ = build_system(ccfg, device=dev, seed=SEED)
        step = make_packed_photo_step(ccfg, train_step, seed=SEED)
        build.reset_launches()
        state, m = step(state, {k: v.to(dev) for k, v in train_batch(
            train_n, gen, size).items()})
        torch.cuda.synchronize()
        train_launches = dict(build.LAUNCHES)
        check_train_metrics([m], arch)
        for path, got_l, names in (("serving", serve_launches,
                                    ("normalize", "nms")),
                                   ("training", train_launches,
                                    ("grid_mask",))):
            for name in names:
                if got_l.get(name, 0) < 1:
                    raise AssertionError(f"{arch} {path} never launched "
                                         f"{name}")
        log(f"(11c) {arch}: bs {req.shape[0]} {summary}, launches "
            f"{serve_launches}; one train step of {train_n}: total loss "
            f"{float(m['total_loss']):.4f}, num_fg {float(m['num_fg']):.0f},"
            f" launches {train_launches}")
        del state, train_step, step
        torch.cuda.empty_cache()


INSEG_DATASET = "chip_smoke_mini_coco_segm"


SPARSEINST_YAML = os.path.join(REPO, "configs", "coco", "sparseinst",
                               "sparse_inst_r50_base.yaml")


def sparseinst_cfg(**replace):
    """A ``SparseInstConfig`` from ``sparse_inst_r50_base.yaml`` (merged
    into the port's ``get_cfg``), with dataclass fields replaced."""
    from yolov7_d2_tpu_torch.config import SparseInstConfig
    from yolov7_d2_tpu_torch.config.defaults import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(SPARSEINST_YAML)
    return dataclasses.replace(SparseInstConfig.from_cfg(cfg), **replace)


def inseg_batch(n: int, gen: torch.Generator, dev, size: int = SIZE,
                slots: int = 100, max_inst: int = 20) -> dict:
    """A SparseInst training batch in the JAX layout: uint8 images [n,
    size, size, 3] and 1-``max_inst`` elliptic instances an image as dense
    uint8 masks [n, slots, size, size] (valid slots first), classes and
    validity; the masks are drawn on ``dev``."""
    count = torch.randint(1, max_inst + 1, (n, 1), generator=gen)
    valid = torch.arange(slots)[None] < count
    centre = (torch.rand((n, slots, 2), generator=gen) * size).to(dev)
    radius = (8 + torch.rand((n, slots, 2), generator=gen)
              * (size // 4)).to(dev)
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    dy = ((grid - centre[..., 1:]) / radius[..., 1:]) ** 2
    dx = ((grid - centre[..., :1]) / radius[..., :1]) ** 2
    masks = (dy[..., :, None] + dx[..., None, :]) <= 1.0
    masks &= valid.to(dev)[..., None, None]
    return {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8).to(dev),
        "gt_masks": masks.to(torch.uint8),
        "gt_classes": (torch.randint(0, 80, (n, slots), generator=gen)
                       * valid).to(torch.int32).to(dev),
        "gt_valid": valid.to(dev),
    }


def sparseinst_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> the tail."""
    from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import (
        sparseinst_postprocess,
    )

    with torch.inference_mode():
        out = model(images)
        return out, sparseinst_postprocess(
            out, cfg.cls_threshold, cfg.mask_threshold, cfg.max_detections)


def check_inst_detections(dets, n: int, cfg, size: int, what: str) -> str:
    hm = size // 4
    if dets.masks.shape != (n, cfg.max_detections, hm, hm) or \
            dets.boxes.shape != (n, cfg.max_detections, 4):
        raise AssertionError(f"{what}: Detections shapes "
                             f"{tuple(dets.masks.shape)}")
    counts = dets.num_valid()
    if int(counts.min()) < 1:
        raise AssertionError(f"{what}: an image with no instance")
    if not torch.isfinite(dets.scores).all() or \
            not torch.isfinite(dets.masks).all():
        raise AssertionError(f"{what}: non-finite scores or masks")
    return f"instances per image {int(counts.min())}-{int(counts.max())}"


def sparseinst_phase(dev, card: str, gen: torch.Generator, kernels: dict,
                     requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                     size: int = SIZE, small: int = 128,
                     cli_images: int = CLI_IMAGES, **cli_opts) -> None:
    """Section 12: SparseInst R-50 at ``size`` from
    ``configs/coco/sparseinst/sparse_inst_r50_base.yaml``, full depth and
    width (ResNet-50 with FrozenBN, the FPN-PPM encoder at 256 channels,
    ``BaseIAMDecoder`` with 100 masks, 80 classes), bf16 over f32 weights
    from ``SEED``. (a) the normalize kernel at SparseInst's mean and std on
    [128, size, size, 3] against its plain version (the
    ``normalize_sparseinst`` entry); (b) serving: uint8 -> normalize kernel
    -> forward -> ``sparseinst_postprocess`` for each request size, times
    by CUDA events, ``upsample_masks_two_stage`` on one request; (c) the
    f32 forward on the card against the CPU at ``small`` px; (d) 13
    training steps of ``train_n`` images through ``build_system`` (AdamW),
    then one f32 step card against CPU; (e) ``train_inseg`` on a synthetic
    mini-COCO with polygons, the blend mosaic on: 12 steps, checkpoints,
    ``--resume``, the mask eval (``cli_opts`` override its config keys,
    ``__`` for ``.``). (f), YOLOV7P on ResNet-50, runs in section 11.
    Each path's launches are counted from 0."""
    from yolov7_d2_tpu_torch import train_inseg
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.models.backbones.resnet import (
        frozen_bn_buffers,
    )
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as si
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    cfg = sparseinst_cfg(input_size=(size, size))

    # ---- (a) the normalize kernel at SparseInst's statistics
    images = torch.randint(0, 256, (requests[-1], size, size, 3),
                           generator=gen, dtype=torch.uint8).to(dev)
    args = (images, si.PIXEL_MEAN, si.PIXEL_STD, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError("normalize kernel differs from its plain "
                             "version at SparseInst's mean and std")
    kernels["normalize_sparseinst"] = {
        "name": "normalize_sparseinst", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_sparseinst plain"),
        # no one PyTorch call takes uint8 NHWC to (x - mean) / std in
        # channels_last
        "library_ms": None,
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
    }
    log(f"(12a) normalize at SparseInst's mean {si.PIXEL_MEAN} and std "
        f"{si.PIXEL_STD}: bit-exact against its plain version on "
        f"{tuple(images.shape)} -> bf16 channels_last")
    del images, got, want, args

    # ---- (b) serving
    model = build_model(cfg, dev, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"(12b) SparseInst R-50 {size} from sparse_inst_r50_base.yaml: "
        f"{n_params / 1e6:.3f} M parameters, {model.dtype}, stride_in_1x1 "
        f"{cfg.resnet.stride_in_1x1}")
    batches = [letterboxed_batch(n, gen)[:, :size, :size].contiguous()
               for n in requests]
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = sparseinst_serve(model, cfg, req.to(dev))
        log(f"(12b) request bs {req.shape[0]}: " + check_inst_detections(
            dets, req.shape[0], cfg, size, "SparseInst serving"))
    torch.cuda.synchronize()
    serve_launches = dict(build.LAUNCHES)
    log(f"(12b) SparseInst serving path launches: {serve_launches}")
    if serve_launches.get("normalize", 0) != len(requests):
        raise AssertionError("the SparseInst serving path launched "
                             f"normalize {serve_launches} times")
    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        e2e = cuda_ms(lambda: sparseinst_serve(model, cfg, x))
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(x))
            out = model(x)
        tail = cuda_ms(lambda: si.sparseinst_postprocess(
            out, cfg.cls_threshold, cfg.mask_threshold, cfg.max_detections))
        log(f"SparseInst R-50 {size} bs {n} bf16 on [{card}]: e2e "
            f"{e2e:.3f} ms = {n * 1000 / e2e:.1f} img/s; forward-only "
            f"{fwd:.3f} ms = {n * 1000 / fwd:.1f} img/s; tail {tail:.3f} ms")
        del out
    # the two-stage upsample of one request: originals 1.5x the letterboxed
    # content (stage 2 enlarges) and 0.75x (stage 2 shrinks, antialiased)
    req = batches[1]
    _, dets = sparseinst_serve(model, cfg, req.to(dev))
    kept = 0
    t0 = time.perf_counter()
    for i in range(req.shape[0]):
        filled = (req[i] != 114).any(-1)
        vh = int(filled.any(1).nonzero().max()) + 1
        vw = int(filled.any(0).nonzero().max()) + 1
        f = 1.5 if i % 2 else 0.75
        orig = (round(vh * f), round(vw * f))
        up = si.upsample_masks_two_stage(
            dets.masks[i][dets.valid[i]], (size, size), (vh, vw), orig,
            cfg.mask_threshold)
        if up.shape[1:] != orig:
            raise AssertionError(f"two-stage upsample gave {up.shape}")
        kept += int(up.any((1, 2)).sum())
    torch.cuda.synchronize()
    log(f"(12b) upsample_masks_two_stage of bs {req.shape[0]}: "
        f"{int(dets.valid.sum())} masks, {kept} non-empty at the original "
        f"sizes, {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    del batches, dets

    # ---- (c) f32 card against CPU, full width, small px
    f32 = dataclasses.replace(cfg, amp=False, input_size=(small, small))
    one = letterboxed_batch(2, gen)[:, :small, :small].contiguous()
    with torch.inference_mode():
        ref = build_model(f32, "cpu", SEED)(one)
        on_card = build_model(f32, dev, SEED)(one.to(dev))
        bf16 = model(one.to(dev))
    gaps = []
    for k in ("cls_logits", "obj_logits", "mask_logits", "iam"):
        scale = float(ref[k].abs().max())
        err = float((on_card[k].cpu() - ref[k]).abs().max())
        err16 = float((bf16[k].float().cpu() - ref[k]).abs().max())
        gaps.append(f"{k} {err / scale:.3g} (bf16 {err16 / scale:.3g})")
        if err > 1e-4 * scale:
            raise AssertionError(f"SparseInst {k} on the card differs from "
                                 f"the CPU by {err} of {scale}")
    log(f"(12c) f32 forward at {small} px, card against CPU, error over "
        "each output's max: " + ", ".join(gaps))
    del model, ref, on_card, bf16
    torch.cuda.empty_cache()

    # ---- (d) training: build_system, AdamW, 16 images at 640
    _, state, train_step, fields = build_system(cfg, device=dev, seed=SEED)
    frozen = [b.clone() for b in frozen_bn_buffers(state.model)]
    before = [p.detach().clone() for p in state.model.parameters()]
    tbatches = [inseg_batch(train_n, gen, dev, size) for _ in range(4)]
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i in range(WARMUP):
        state, m = train_step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + ITERS):
        state, m = train_step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    train_launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"(12d) SparseInst training path launches: {train_launches}")
    if train_launches.get("normalize", 0) != len(metrics):
        raise AssertionError("the SparseInst training path launched "
                             f"normalize {train_launches} times")
    kernels["normalize_sparseinst"]["launches"] = (
        serve_launches["normalize"] + train_launches["normalize"])
    for i, m in enumerate(metrics):
        for key in ("loss_ce", "loss_dice", "loss_mask", "loss_objectness",
                    "total_loss", "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"SparseInst step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_inst"]) > 0:
            raise AssertionError(f"SparseInst step {i}: no instance matched")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError("SparseInst training moved no parameter")
    if not all(torch.equal(a, b)
               for a, b in zip(frozen, frozen_bn_buffers(state.model))):
        raise AssertionError("SparseInst training moved FrozenBN statistics")
    fmt = ("total_loss", "loss_ce", "loss_dice", "loss_mask",
           "loss_objectness", "num_inst", "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"(12d) SparseInst train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    iters = [int(m["match_iters"]) for m in metrics]
    slots = tbatches[0]["gt_masks"].shape[1]
    log(f"(12d) SparseInst R-50 {size} train step bs {train_n} bf16 on "
        f"[{card}]: {step_ms:.3f} ms a step = "
        f"{train_n * 1000 / step_ms:.1f} img/s (host clock over {ITERS} "
        f"steps after {WARMUP}, batches on the card, {slots} mask slots an "
        f"image, 1-20 valid); peak memory {peak_gb:.3f} GB; auction rounds "
        f"a step {iters}; parameters moved, FrozenBN statistics did not")
    del state, train_step, tbatches, metrics, before, frozen
    torch.cuda.empty_cache()

    # one f32 step, card against CPU, from the same weights and batch: the
    # assignments, the loss terms and the gradient norm
    scfg = dataclasses.replace(cfg, input_size=(small, small), amp=False,
                               warmup_iters=0)
    sbatch = inseg_batch(2, gen, "cpu", small, slots=8, max_inst=6)
    got = {}
    for where in ("cpu", dev):
        model, st, ts, _ = build_system(scfg, device=where, seed=SEED)
        b = {k: v.to(where) for k, v in sbatch.items()}
        with torch.no_grad():
            out = model(b["image"])
            small_gt = si._resize(b["gt_masks"].float(), out[
                "mask_logits"].shape[-2:])
            pred, ok, _ = si.sparseinst_match(out, small_gt,
                                              b["gt_classes"], b["gt_valid"])
        _, m = ts(st, b)
        got[str(where)] = ({k: float(v) for k, v in m.items()},
                           pred.cpu(), ok.cpu())
    (ref_m, ref_p, ref_ok), (card_m, card_p, card_ok) = (
        got["cpu"], got[str(dev)])
    log(f"(12d) SparseInst f32 train step at {small} px, card vs CPU: "
        + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}" for k in fmt))
    if not (torch.equal(card_p, ref_p) and torch.equal(card_ok, ref_ok)):
        raise AssertionError("SparseInst assignments differ between the "
                             "card and the CPU")
    for k in ("total_loss", "loss_ce", "loss_dice", "loss_mask",
              "loss_objectness", "grad_norm"):
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"SparseInst {k} differs between the card "
                                 "and the CPU")
    del model, st, ts
    torch.cuda.empty_cache()

    # ---- (e) the CLI: train_inseg on a mini-COCO with polygons
    work = os.path.join(REPO, "build", "chip_smoke_inseg")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=cli_images, segm=True)
    register_coco_instances(INSEG_DATASET, {}, js, img_dir)
    out_dir = os.path.join(work, "out")
    opts = {"DATASETS.TRAIN": (INSEG_DATASET,),
            "DATASETS.TEST": (INSEG_DATASET,), "OUTPUT_DIR": out_dir,
            "SEED": SEED, "SOLVER.IMS_PER_BATCH": train_n,
            "SOLVER.MAX_ITER": 12, "SOLVER.CHECKPOINT_PERIOD": 6,
            "INPUT.MOSAIC.ENABLED": True, "INPUT.INPUT_SIZE": [size, size],
            "INPUT.MOSAIC.MOSAIC_HEIGHT": size,
            "INPUT.MOSAIC.MOSAIC_WIDTH": size,
            **{k.replace("__", "."): v for k, v in cli_opts.items()}}

    def cli(*flags, **more):
        argv = ["--config-file", SPARSEINST_YAML, *flags]
        more = {k.replace("__", "."): v for k, v in more.items()}
        for k, v in dict(opts, **more).items():
            argv += [k, v if isinstance(v, str) else repr(v)]
        return default_argument_parser().parse_args(argv)

    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        run = train_inseg.main(cli())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        latest = run.storage.latest()
        for key in ("total_loss", "loss_ce", "loss_dice", "loss_mask",
                    "loss_objectness", "grad_norm"):
            if not math.isfinite(latest.get(key, float("nan"))):
                raise AssertionError(f"train_inseg: {key} = "
                                     f"{latest.get(key)}")
        if launches.get("normalize", 0) != 12:
            raise AssertionError(f"train_inseg launches {launches}")
        median = run.storage.median("time_per_iter")
        del run
        resumed = train_inseg.main(cli("--resume", SOLVER__MAX_ITER=14))
        if resumed.start_iter != 12 or resumed.storage.iter != 14:
            raise AssertionError(f"train_inseg --resume ran "
                                 f"{resumed.start_iter} -> "
                                 f"{resumed.storage.iter}, not 12 -> 14")
        del resumed
        build.reset_launches()
        t0 = time.perf_counter()
        results = train_inseg.main(cli("--eval-only"))
        eval_s = time.perf_counter() - t0
        missing = [k for k in ("AP", "AP50", "AP75", "APs", "APm", "APl",
                               "AR100") if k not in results]
        if missing:
            raise AssertionError(f"COCOMaskEvaluator: no {missing}")
        log(f"(12e) train_inseg on [{card}], {train_n} images a step, blend "
            f"mosaic on: time_per_iter median {median * 1e3:.3f} ms = "
            f"{train_n / median:.1f} img/s; 12 steps and 2 checkpoints in "
            f"{wall:.2f} s (build included); launches {launches}; --resume "
            f"12 -> 14; segm eval of {cli_images} images in {eval_s:.2f} s "
            f"(launches {dict(build.LAUNCHES)}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in results.items()))
    finally:
        DatasetCatalog.remove(INSEG_DATASET)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


DETR_DATASET = "chip_smoke_mini_coco_detr"
DETR_DIR = os.path.join(REPO, "configs", "coco", "detr")
DETR_SIZE = 800
DETR_TRAIN_BATCH = 8  # one card's share of IMS_PER_BATCH 32 over 4 cards
DETR_MODELS = (("DETR", "detr_256_6_6_r50.yaml"),
               ("AnchorDETR", "anchordetr_r50.yaml"))


def detr_cfg(yaml: str, **replace):
    """A ``DetrConfig`` from ``configs/coco/detr/<yaml>`` (merged into the
    port's ``get_cfg``), with dataclass fields replaced."""
    from yolov7_d2_tpu_torch.config import DetrConfig
    from yolov7_d2_tpu_torch.config.defaults import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(DETR_DIR, yaml))
    return dataclasses.replace(DetrConfig.from_cfg(cfg), **replace)


def detr_tail(out, cfg):
    """The family's tail: ``detr_postprocess`` or
    ``anchor_detr_postprocess`` -> ``Detections`` of
    ``cfg.max_detections``."""
    from yolov7_d2_tpu_torch.models.meta_arch.detr import detr_postprocess
    from yolov7_d2_tpu_torch.models.meta_arch.detr_variants import (
        anchor_detr_postprocess,
    )

    tail = (detr_postprocess if cfg.meta_architecture == "Detr"
            else anchor_detr_postprocess)
    with torch.inference_mode():
        return tail(out, cfg.input_size, cfg.max_detections)


def detr_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> the tail."""
    with torch.inference_mode():
        out = model(images)
    return out, detr_tail(out, cfg)


def detr_batch(n: int, gen: torch.Generator, dev, size: int = DETR_SIZE,
               slots: int = 100, max_boxes: int = 20) -> dict:
    """A DETR training batch in the JAX layout: uint8 images [n, size,
    size, 3] and 1-``max_boxes`` xyxy boxes in pixels an image (valid
    slots first), classes and validity."""
    count = torch.randint(1, max_boxes + 1, (n, 1), generator=gen)
    valid = torch.arange(slots)[None] < count
    xy = torch.rand((n, slots, 2), generator=gen) * (size - 16)
    wh = 8 + torch.rand((n, slots, 2), generator=gen) * (size // 2)
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    return {k: v.to(dev) for k, v in {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8),
        "gt_boxes": boxes * valid[..., None],
        "gt_classes": (torch.randint(0, 80, (n, slots), generator=gen)
                       * valid).to(torch.int32),
        "gt_valid": valid}.items()}


def level_assignments(out, batch, cfg):
    """Every decoder level's assignment, as ``detr_losses`` makes them (one
    auction over the stacked levels): ``(pred_of_gt, ok)`` [L * B, G],
    the last level first."""
    from yolov7_d2_tpu_torch.models.meta_arch import detr as dm

    gt = dm.normalized_gt_boxes(batch["gt_boxes"], cfg.input_size)
    logits = torch.cat([out["pred_logits"][None], out["aux_logits"]])
    boxes = torch.cat([out["pred_boxes"][None], out["aux_boxes"]])
    n = logits.shape[0]
    with torch.no_grad():
        pred, ok, _ = dm.detr_match(
            logits.flatten(0, 1), boxes.flatten(0, 1), gt.repeat(n, 1, 1),
            batch["gt_classes"].repeat(n, 1), batch["gt_valid"].repeat(n, 1),
            use_focal=cfg.use_focal)
    return pred, ok


def device_busy_ms(fn, calls: int = 3) -> tuple:
    """(device busy ms a call, window ms a call) of ``fn`` under
    torch.profiler: the kernels' summed device time against CUDA events
    around the traced calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    busy = sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type == torch.autograd.DeviceType.CUDA
               and "#" not in k.key) / 1000.0
    return busy / calls, start.elapsed_time(end) / calls


def detr_phase(dev, card: str, gen: torch.Generator, kernels: dict,
               requests=REQUEST_BATCHES, train_n: int = DETR_TRAIN_BATCH,
               size: int = DETR_SIZE, small: int = 128,
               cli_images: int = CLI_IMAGES, steps: int = WARMUP + ITERS,
               **cli_opts) -> None:
    """Section 13: DETR R-50 (``configs/coco/detr/detr_256_6_6_r50.yaml``)
    and AnchorDETR R-50 (``anchordetr_r50.yaml``, RCDA, 300 x 3 queries)
    at ``size``, full depth and width, 80 classes, bf16 over f32 weights
    from ``SEED``. (a) the normalize kernel at DETR's mean and std on
    [128, size, size, 3] against its plain version (the ``normalize_detr``
    entry); then for each model serving, uint8 -> normalize kernel ->
    forward -> the tail, for each request size (one launch a request,
    times by CUDA events, the device's busy share at the largest), and the
    kernel path's ``Detections`` against the plain path's (float input)
    at bs 8; (b) the f32 outputs on the card against the CPU at ``small``
    px within 1e-4 of each output's max, bf16 within 5e-2; (c) ``steps``
    training steps of ``train_n`` images through ``build_system`` (AdamW,
    the set criterion over 6 levels, dropout 0.1 for DETR): finite losses
    at every level, matched counts equal to the valid gts, parameters
    moved, FrozenBN statistics unmoved, ms a step, peak memory, auction
    rounds; one f32 step at dropout 0 on the card against the CPU
    (assignments equal at every level, losses and grad norm within 1e-3);
    (d) ``train_transformer`` on a synthetic mini-COCO of ``cli_images``
    JPEGs, the crop branch on: 12 steps with checkpoints at 6 and 12,
    ``--resume`` to 14 (``cli_opts`` override its config keys, ``__`` for
    ``.``). Each path's launches are counted from 0."""
    from yolov7_d2_tpu_torch import train_transformer
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.models.backbones.resnet import (
        frozen_bn_buffers,
    )
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import detr as dm
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    # ---- (a) the normalize kernel at DETR's statistics
    images = torch.randint(0, 256, (requests[-1], size, size, 3),
                           generator=gen, dtype=torch.uint8).to(dev)
    args = (images, dm.PIXEL_MEAN, dm.PIXEL_STD, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError("normalize kernel differs from its plain "
                             "version at DETR's mean and std")
    kernels["normalize_detr"] = {
        "name": "normalize_detr", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_detr plain"),
        # no one PyTorch call takes uint8 NHWC to (x - mean) / std in
        # channels_last
        "library_ms": None,
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
        "launches": 0,
    }
    log(f"(13a) normalize at DETR's mean {dm.PIXEL_MEAN} and std "
        f"{dm.PIXEL_STD}: bit-exact against its plain version on "
        f"{tuple(images.shape)} -> bf16 channels_last")
    del images, got, want, args
    batches = [letterboxed_batch(n, gen, size) for n in requests]

    for name, yaml in DETR_MODELS:
        cfg = detr_cfg(yaml)
        if cfg.input_size != (size, size):
            cfg = dataclasses.replace(cfg, input_size=(size, size))
        model = build_model(cfg, dev, SEED)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"(13a) {name} R-50 {size} from {yaml}: {n_params / 1e6:.3f} M "
            f"parameters, {model.dtype}, {cfg.enc_layers} + "
            f"{cfg.dec_layers} layers, "
            + (f"{cfg.num_queries} queries" if name == "DETR" else
               f"{cfg.num_query_position} x {cfg.num_query_pattern} "
               f"queries, {cfg.attention_type}"))
        torch.cuda.synchronize()
        build.reset_launches()
        for req in batches:
            _, dets = detr_serve(model, cfg, req.to(dev))
            log(f"(13a) {name} request bs {req.shape[0]}: " +
                check_detections(dets, req.shape[0], cfg, f"{name} serving"))
        torch.cuda.synchronize()
        serve_launches = dict(build.LAUNCHES)
        if serve_launches.get("normalize", 0) != len(requests):
            raise AssertionError(f"the {name} serving path launched "
                                 f"normalize {serve_launches} times")
        kernels["normalize_detr"]["launches"] += serve_launches["normalize"]
        for req in batches:
            n = req.shape[0]
            x = req.to(dev)
            e2e = cuda_ms(lambda: detr_serve(model, cfg, x))
            with torch.inference_mode():
                fwd = cuda_ms(lambda: model(x))
                out = model(x)
            tail = cuda_ms(lambda: detr_tail(out, cfg))
            extra = ""
            if n == requests[-1]:
                busy, window = device_busy_ms(
                    lambda: detr_serve(model, cfg, x))
                extra = (f"; device busy {busy:.3f} ms a call = "
                         f"{100 * busy / e2e:.1f}% of the untraced call "
                         f"(traced {window:.3f} ms)")
            log(f"{name} R-50 {size} bs {n} bf16 on [{card}]: e2e "
                f"{e2e:.3f} ms = {n * 1000 / e2e:.1f} img/s; forward-only "
                f"{fwd:.3f} ms = {n * 1000 / fwd:.1f} img/s; tail "
                f"{tail:.3f} ms{extra}")
            del out
        # the kernel path against the plain path (float input, the plain
        # normalize): the same Detections
        x = batches[1].to(dev)
        _, dets = detr_serve(model, cfg, x)
        _, plain = detr_serve(model, cfg, x.float())
        for f in ("boxes", "scores", "classes", "valid"):
            if not torch.equal(getattr(dets, f), getattr(plain, f)):
                raise AssertionError(f"{name}: the kernel path's {f} differ "
                                     "from the plain path's")
        log(f"(13a) {name} bs {x.shape[0]}: the kernel path's Detections "
            "equal the plain path's")

        # ---- (b) f32 card against CPU, full width, small px
        f32 = dataclasses.replace(cfg, amp=False, input_size=(small, small))
        one = letterboxed_batch(2, gen, small)
        with torch.inference_mode():
            ref = build_model(f32, "cpu", SEED)(one)
            on_card = build_model(f32, dev, SEED)(one.to(dev))
            bf16 = model(one.to(dev))
        gaps = []
        for k in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
            scale = float(ref[k].abs().max())
            err = float((on_card[k].cpu() - ref[k]).abs().max())
            err16 = float((bf16[k].float().cpu() - ref[k]).abs().max())
            gaps.append(f"{k} {err / scale:.3g} (bf16 {err16 / scale:.3g})")
            if err > 1e-4 * scale or err16 > 5e-2 * scale:
                raise AssertionError(f"{name} {k} on the card differs from "
                                     f"the CPU by {err} (bf16 {err16}) of "
                                     f"{scale}")
        log(f"(13b) {name} f32 forward at {small} px, card against CPU, "
            "error over each output's max: " + ", ".join(gaps))
        del model, ref, on_card, bf16
        torch.cuda.empty_cache()

        # ---- (c) training: build_system, AdamW, train_n images at size
        _, state, train_step, _ = build_system(cfg, device=dev, seed=SEED)
        frozen = [b.clone() for b in frozen_bn_buffers(state.model)]
        before = [p.detach().clone() for p in state.model.parameters()]
        tbatches = [detr_batch(train_n, gen, dev, size) for _ in range(4)]
        metrics = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        warm = min(WARMUP, steps - 1)
        for i in range(steps):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = train_step(state, tbatches[i % 4])
            metrics.append(m)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
        train_launches = dict(build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if train_launches.get("normalize", 0) != steps:
            raise AssertionError(f"the {name} training path launched "
                                 f"normalize {train_launches} times")
        kernels["normalize_detr"]["launches"] += train_launches["normalize"]
        prefixes = [""] + [f"aux{i}_" for i in range(cfg.dec_layers - 1)]
        for i, m in enumerate(metrics):
            valid = int(tbatches[i % 4]["gt_valid"].sum())
            for p in prefixes:
                for key in ("loss_ce", "loss_bbox", "loss_giou"):
                    if not bool(torch.isfinite(m[p + key])):
                        raise AssertionError(f"{name} step {i}: {p}{key} = "
                                             f"{float(m[p + key])}")
                if int(m[p + "num_matched"]) != valid:
                    raise AssertionError(
                        f"{name} step {i}: {p}num_matched "
                        f"{int(m[p + 'num_matched'])}, {valid} valid gts")
            for key in ("total_loss", "grad_norm"):
                if not bool(torch.isfinite(m[key])):
                    raise AssertionError(f"{name} step {i}: {key} = "
                                         f"{float(m[key])}")
        if all(torch.equal(a, b.detach())
               for a, b in zip(before, state.model.parameters())):
            raise AssertionError(f"{name} training moved no parameter")
        if not all(torch.equal(a, b)
                   for a, b in zip(frozen, frozen_bn_buffers(state.model))):
            raise AssertionError(f"{name} training moved FrozenBN "
                                 "statistics")
        fmt = ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
               "aux0_loss_ce", "num_matched", "grad_norm")
        for i in (0, len(metrics) - 1):
            log(f"(13c) {name} train step {i}: " + ", ".join(
                f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
        rounds = [int(m["match_iters"]) for m in metrics]
        log(f"(13c) {name} R-50 {size} train step bs {train_n} bf16 on "
            f"[{card}]: {step_ms:.3f} ms a step = "
            f"{train_n * 1000 / step_ms:.1f} img/s (host clock over "
            f"{steps - warm} steps after {warm}, batches on the card, 100 "
            f"box slots an image, 1-20 valid, {len(prefixes)} levels "
            f"matched in one auction); peak memory {peak_gb:.3f} GB; "
            f"auction rounds a step {rounds}; launches {train_launches}; "
            "every level's matched count = the valid gts; parameters moved, "
            "FrozenBN statistics did not")
        del state, train_step, tbatches, metrics, before, frozen
        torch.cuda.empty_cache()

        # one f32 step at dropout 0, card against CPU, from the same
        # weights and batch: every level's assignments, the losses, the
        # gradient norm
        scfg = dataclasses.replace(cfg, input_size=(small, small), amp=False,
                                   warmup_iters=0, dropout=0.0)
        sbatch = detr_batch(2, gen, "cpu", small, slots=8, max_boxes=6)
        got = {}
        for where in ("cpu", dev):
            model, st, ts, _ = build_system(scfg, device=where, seed=SEED)
            b = {k: v.to(where) for k, v in sbatch.items()}
            with torch.no_grad():
                pred, ok = level_assignments(model(b["image"]), b, scfg)
            _, m = ts(st, b)
            got[str(where)] = ({k: float(v) for k, v in m.items()},
                               pred.cpu(), ok.cpu())
        (ref_m, ref_p, ref_ok), (card_m, card_p, card_ok) = (
            got["cpu"], got[str(dev)])
        keys = ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
                "aux4_loss_ce", "grad_norm")
        log(f"(13c) {name} f32 train step at {small} px, card vs CPU: "
            + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}"
                        for k in keys)
            + f"; matched {int(card_ok.sum())} over {len(prefixes)} levels")
        if not (torch.equal(card_p, ref_p) and torch.equal(card_ok, ref_ok)):
            raise AssertionError(f"{name} assignments differ between the "
                                 "card and the CPU")
        for k in ref_m:
            if "loss" in k or k == "grad_norm":
                if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
                    raise AssertionError(f"{name} {k} differs between the "
                                         "card and the CPU")
        del model, st, ts
        torch.cuda.empty_cache()

    # ---- (d) the CLI: train_transformer on a mini-COCO, the crop branch
    work = os.path.join(REPO, "build", "chip_smoke_detr")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=cli_images)
    register_coco_instances(DETR_DATASET, {}, js, img_dir)
    out_dir = os.path.join(work, "out")
    yaml = os.path.join(DETR_DIR, DETR_MODELS[0][1])
    opts = {"DATASETS.TRAIN": (DETR_DATASET,), "OUTPUT_DIR": out_dir,
            "SEED": SEED, "SOLVER.IMS_PER_BATCH": train_n,
            "SOLVER.MAX_ITER": 12, "SOLVER.CHECKPOINT_PERIOD": 6,
            "INPUT.CROP.ENABLED": True, "INPUT.INPUT_SIZE": [size, size],
            **{k.replace("__", "."): v for k, v in cli_opts.items()}}

    def cli(*flags, **more):
        argv = ["--config-file", yaml, *flags]
        more = {k.replace("__", "."): v for k, v in more.items()}
        for k, v in dict(opts, **more).items():
            argv += [k, v if isinstance(v, str) else repr(v)]
        return default_argument_parser().parse_args(argv)

    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        run = train_transformer.main(cli())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        latest = run.storage.latest()
        for key in ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
                    "aux4_loss_giou", "grad_norm"):
            if not math.isfinite(latest.get(key, float("nan"))):
                raise AssertionError(f"train_transformer: {key} = "
                                     f"{latest.get(key)}")
        if launches.get("normalize", 0) != 12:
            raise AssertionError(f"train_transformer launches {launches}")
        ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
        if len(ckpts) != 2:
            raise AssertionError(f"train_transformer checkpoints {ckpts}")
        median = run.storage.median("time_per_iter")
        del run
        resumed = train_transformer.main(cli("--resume",
                                             SOLVER__MAX_ITER=14))
        if resumed.start_iter != 12 or resumed.storage.iter != 14:
            raise AssertionError(f"train_transformer --resume ran "
                                 f"{resumed.start_iter} -> "
                                 f"{resumed.storage.iter}, not 12 -> 14")
        del resumed
        log(f"(13d) train_transformer DETR on [{card}], {train_n} images a "
            f"step, the crop branch on: time_per_iter median "
            f"{median * 1e3:.3f} ms = {train_n / median:.1f} img/s; 12 steps "
            f"and checkpoints {ckpts} in {wall:.2f} s (build included); "
            f"launches {launches}; --resume 12 -> 14")
    finally:
        DatasetCatalog.remove(DETR_DATASET)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


KPTS_MODELS = (("Swin-T", "yolox_kpts_swin.yaml", {}),
               ("CSPDarknet-X", "yolox_kpts.yaml", {}),
               ("PVTv2-b1", "yolox_kpts.yaml",
                {"backbone": "build_pvt_v2_backbone"}))
KPTS_YOLOV7 = ("swin_t.yaml", "pvt_v2_b0.yaml")
BOX_KEYS = ("AP", "AP50", "AP75", "AR100")


def kpts_cfg(yaml: str, **replace):
    """A ``YoloxKptsConfig`` from ``configs/coco/<yaml>`` (merged into the
    port's ``get_cfg``), with dataclass fields replaced."""
    from yolov7_d2_tpu_torch.config import YoloxKptsConfig
    from yolov7_d2_tpu_torch.config.defaults import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "coco", yaml))
    return dataclasses.replace(YoloxKptsConfig.from_cfg(cfg), **replace)


def kpts_tail(head, cfg, nms=None):
    """``yolox_kpts_postprocess`` with the NMS kernel unless ``nms``."""
    from yolov7_d2_tpu_torch.models.meta_arch.yolox_kpts import (
        yolox_kpts_postprocess,
    )

    with torch.inference_mode():
        return yolox_kpts_postprocess(
            head, cfg.conf_threshold, cfg.nms_threshold, cfg.max_detections,
            cfg.pre_nms_topk, **({} if nms is None else {"nms": nms}))


def kpts_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> the tail."""
    with torch.inference_mode():
        head = model(images)
    return head, kpts_tail(head, cfg)


def kpts_batch(n: int, gen: torch.Generator, dev, size: int = SIZE,
               slots: int = 100, max_persons: int = 8) -> dict:
    """A YOLOX-KPTS training batch: uint8 images, 1-``max_persons``
    persons an image (valid slots first) with 17 keypoints each inside
    their box, visible, occluded or unlabelled ((0, 0) with v 0)."""
    count = torch.randint(1, max_persons + 1, (n, 1), generator=gen)
    valid = torch.arange(slots)[None] < count
    xy = torch.rand((n, slots, 2), generator=gen) * (size * 0.7)
    wh = 32 + torch.rand((n, slots, 2), generator=gen) * (size * 0.3)
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    u = torch.rand((n, slots, 17, 2), generator=gen)
    pts = boxes[..., None, :2] + u * (boxes[..., None, 2:]
                                      - boxes[..., None, :2])
    v = torch.randint(0, 3, (n, slots, 17), generator=gen).float()
    kp = torch.cat([torch.where(v[..., None] > 0, pts, 0.0), v[..., None]],
                   -1)
    return {k: t.to(dev) for k, t in {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8),
        "gt_boxes": boxes * valid[..., None],
        "gt_classes": torch.zeros((n, slots), dtype=torch.int32),
        "gt_valid": valid,
        "gt_keypoints": kp * valid[..., None, None]}.items()}


def check_kpt_detections(dets, n: int, cfg, what: str) -> str:
    summary = check_detections(dets, n, cfg, what)
    kp = dets.keypoints
    if kp is None or tuple(kp.shape) != (n, cfg.max_detections,
                                         cfg.num_keypoints, 3):
        raise AssertionError(f"{what}: keypoints "
                             f"{None if kp is None else tuple(kp.shape)}")
    kept = kp[dets.valid]
    if not torch.isfinite(kept).all() or float(kept[..., 2].min()) < 0 \
            or float(kept[..., 2].max()) > 1:
        raise AssertionError(f"{what}: keypoints not finite or scores out "
                             "of [0, 1]")
    return summary


def yolox_kpts_phase(dev, card: str, gen: torch.Generator, kernels: dict,
                     requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                     size: int = SIZE, small: int = 128,
                     eval_images: int = CLI_IMAGES,
                     steps: int = WARMUP + ITERS, **eval_opts) -> None:
    """Section 14: YOLOX-KPTS at ``size``, full depth and width, one class,
    17 keypoints, bf16 over f32 weights from ``SEED``. (a) serving on
    ``yolox_kpts_swin.yaml`` (Swin-T), then ``yolox_kpts.yaml``
    (CSPDarknet-X) and PVTv2-b1: uint8 -> normalize kernel -> forward ->
    ``yolox_kpts_postprocess`` -> NMS kernel, for each request size (one
    launch of each a request; e2e, forward and tail by CUDA events, the
    device's busy share at the largest), the kernel path's ``Detections``,
    keypoints included, equal to the plain path's at bs 8; (b) each model's
    f32 outputs on the card against the CPU at ``small`` px within 1e-4 of
    the max, bf16 within 5e-2; (c) ``steps`` training steps of
    ``train_n`` images through ``build_system`` on the Swin config (1-8
    persons of 17 keypoints an image): finite losses, foreground anchors,
    ``loss_kpt`` > 0, parameters moved, ms a step, peak memory, normalize
    launches; one f32 step at ``small`` px on the card against the CPU
    (fg count equal, losses and grad norm within 1e-3); (d) ``eval_coco``
    on a synthetic mini-COCO-keypoints of ``eval_images`` JPEGs: the box
    and ``kpt_`` keys, then the same keys from ``--weights`` of a saved
    state dict (``eval_opts`` override its config keys, ``__`` for
    ``.``); (e) YOLOV7 on ``swin_t.yaml`` and ``pvt_v2_b0.yaml``, full
    depth: one request and one train step each. The launches of (a), (c)
    and (d) go into the normalize and NMS entries."""
    from yolov7_d2_tpu_torch import eval_coco
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import KPTS_FIELDS, build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
    from yolov7_d2_tpu_torch.models.build import build_model

    batches = [letterboxed_batch(n, gen, size) for n in requests]
    for name, yaml, replace in KPTS_MODELS:
        # ---- (a) serving
        cfg = kpts_cfg(yaml, **replace)
        model = build_model(cfg, dev, SEED)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"(14a) YOLOX-KPTS {name} {size} from {yaml}: "
            f"{n_params / 1e6:.3f} M parameters, {model.dtype}, "
            f"{cfg.num_keypoints} keypoints")
        torch.cuda.synchronize()
        build.reset_launches()
        for req in batches:
            _, dets = kpts_serve(model, cfg, req.to(dev))
            log(f"(14a) {name} request bs {req.shape[0]}: " +
                check_kpt_detections(dets, req.shape[0], cfg,
                                     f"YOLOX-KPTS {name} serving"))
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        for k in ("normalize", "nms"):
            if launches.get(k, 0) != len(requests):
                raise AssertionError(f"the YOLOX-KPTS {name} serving path "
                                     f"launched {k} {launches} times")
            kernels[k]["launches"] += launches[k]
        log(f"(14a) {name} serving path launches, counted from 0: "
            f"{launches}")
        for req in batches:
            n = req.shape[0]
            x = req.to(dev)
            e2e = cuda_ms(lambda: kpts_serve(model, cfg, x))
            with torch.inference_mode():
                fwd = cuda_ms(lambda: model(x))
                head = model(x)
            tail = cuda_ms(lambda: kpts_tail(head, cfg))
            extra = ""
            if n == requests[-1]:
                busy, window = device_busy_ms(
                    lambda: kpts_serve(model, cfg, x))
                extra = (f"; device busy {busy:.3f} ms a call = "
                         f"{100 * busy / e2e:.1f}% of the untraced call "
                         f"(traced {window:.3f} ms)")
            log(f"YOLOX-KPTS {name} {size} bs {n} bf16 on [{card}]: e2e "
                f"{e2e:.3f} ms = {n * 1000 / e2e:.1f} img/s; forward-only "
                f"{fwd:.3f} ms = {n * 1000 / fwd:.1f} img/s; tail "
                f"{tail:.3f} ms{extra}")
            del head
        # the kernel path against the plain path (float input, the plain
        # normalize; the plain NMS): the same Detections, keypoints too
        x = batches[1].to(dev)
        _, dets = kpts_serve(model, cfg, x)
        with torch.inference_mode():
            plain = kpts_tail(model(x.float()), cfg, nms=nms_batched_plain)
        for f in ("boxes", "scores", "classes", "valid", "keypoints"):
            if not torch.equal(getattr(dets, f), getattr(plain, f)):
                raise AssertionError(f"YOLOX-KPTS {name}: the kernel path's "
                                     f"{f} differ from the plain path's")
        log(f"(14a) {name} bs {x.shape[0]}: the kernel path's Detections "
            f"(keypoints included) equal the plain path's "
            f"({int(dets.valid.sum())} kept)")

        # ---- (b) f32 card against CPU, full width, small px
        f32 = dataclasses.replace(cfg, amp=False)
        one = letterboxed_batch(2, gen, small)
        with torch.inference_mode():
            ref = build_model(f32, "cpu", SEED)(one)
            on_card = build_model(f32, dev, SEED)(one.to(dev))
            bf16 = model(one.to(dev))
        gaps = []
        for k in ("outputs", "kpts"):
            scale = float(ref[k].abs().max())
            err = float((on_card[k].cpu() - ref[k]).abs().max())
            err16 = float((bf16[k].float().cpu() - ref[k]).abs().max())
            gaps.append(f"{k} {err / scale:.3g} (bf16 {err16 / scale:.3g})")
            if err > 1e-4 * scale or err16 > 5e-2 * scale:
                raise AssertionError(f"YOLOX-KPTS {name} {k} on the card "
                                     f"differs from the CPU by {err} (bf16 "
                                     f"{err16}) of {scale}")
        log(f"(14b) {name} f32 forward at {small} px, card against CPU, "
            "error over each output's max: " + ", ".join(gaps))
        del model, ref, on_card, bf16, x, dets, plain
        torch.cuda.empty_cache()

    # ---- (c) training on the Swin config: build_system, train_n images
    cfg = kpts_cfg(KPTS_MODELS[0][1])
    _, state, train_step, fields = build_system(cfg, device=dev, seed=SEED)
    if fields != KPTS_FIELDS:
        raise AssertionError(f"YOLOX-KPTS batch fields {fields}")
    before = [p.detach().clone() for p in state.model.parameters()]
    tbatches = [kpts_batch(train_n, gen, dev, size) for _ in range(4)]
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    warm = min(WARMUP, steps - 1)
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = train_step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches.get("normalize", 0) != steps:
        raise AssertionError(f"the YOLOX-KPTS training path launched "
                             f"normalize {launches} times")
    kernels["normalize"]["launches"] += launches["normalize"]
    keys = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_kpt",
            "loss_kpt_vis", "grad_norm")
    for i, m in enumerate(metrics):
        for key in keys:
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"YOLOX-KPTS step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_fg"]) > 1.0 or not float(m["loss_kpt"]) > 0:
            raise AssertionError(f"YOLOX-KPTS step {i}: num_fg "
                                 f"{float(m['num_fg'])}, loss_kpt "
                                 f"{float(m['loss_kpt'])}")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError("YOLOX-KPTS training moved no parameter")
    for i in (0, len(metrics) - 1):
        log(f"(14c) YOLOX-KPTS Swin-T train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in keys + ("num_fg",)))
    log(f"(14c) YOLOX-KPTS Swin-T {size} train step bs {train_n} bf16 on "
        f"[{card}]: {step_ms:.3f} ms a step = "
        f"{train_n * 1000 / step_ms:.1f} img/s (host clock over "
        f"{steps - warm} steps after {warm}, batches on the card, 100 "
        f"slots, 1-8 persons of 17 keypoints an image, SimOTA over all "
        f"anchors); peak memory {peak_gb:.3f} GB; launches {launches}; "
        "parameters moved")
    del state, train_step, tbatches, metrics, before
    torch.cuda.empty_cache()

    # one f32 step, card against CPU, from the same weights and batch
    scfg = dataclasses.replace(cfg, input_size=(small, small), amp=False,
                               warmup_iters=0)
    sbatch = kpts_batch(2, gen, "cpu", small, slots=8, max_persons=4)
    got = {}
    for where in ("cpu", dev):
        _, st, ts, _ = build_system(scfg, device=where, seed=SEED)
        _, m = ts(st, {k: v.to(where) for k, v in sbatch.items()})
        got[str(where)] = {k: float(v) for k, v in m.items()}
    ref_m, card_m = got["cpu"], got[str(dev)]
    log(f"(14c) YOLOX-KPTS Swin-T f32 train step at {small} px, card vs "
        "CPU: " + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}"
                            for k in keys + ("num_fg",)))
    if card_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError("YOLOX-KPTS fg count differs between the card "
                             "and the CPU")
    for k in keys:
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"YOLOX-KPTS {k} differs between the card "
                                 "and the CPU")
    del st, ts
    torch.cuda.empty_cache()

    # ---- (d) eval_coco on a synthetic mini-COCO-keypoints
    work = os.path.join(REPO, "build", "chip_smoke_kpts")
    shutil.rmtree(work, ignore_errors=True)
    try:
        js, img_dir = write_mini_coco(work, n=eval_images, keypoints=True)
        yaml = os.path.join(REPO, "configs", "coco", KPTS_MODELS[0][1])
        base = ["--config-file", yaml, "--json", js, "--image-root",
                img_dir, "--batch", "8"]
        opts = []
        for k, v in eval_opts.items():
            opts += [k.replace("__", "."), v if isinstance(v, str)
                     else repr(v)]
        parse = eval_coco.build_argument_parser().parse_args
        printed = {}
        for run, flags in (("random", []), ("--weights", None)):
            if flags is None:
                path = os.path.join(work, "weights.pth")
                torch.save({"model": build_model(cfg, "cpu",
                                                 SEED + 1).state_dict()},
                           path)
                flags = ["--weights", path]
            torch.cuda.synchronize()
            build.reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = eval_coco.main(parse(base + flags + opts))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            text = buf.getvalue()
            keys_seen = [line.split(":")[0] for line in text.splitlines()
                         if ": " in line and not line.startswith("ported")]
            want = list(BOX_KEYS) + [f"kpt_{k}" for k in BOX_KEYS]
            missing = [k for k in want if k not in keys_seen]
            if missing or res["keypoints"] is None:
                raise AssertionError(f"eval_coco ({run}) printed {keys_seen}")
            if run == "--weights" and "ported" not in text:
                raise AssertionError("eval_coco --weights loaded nothing")
            batches_n = -(-eval_images // 8)
            for k in ("normalize", "nms"):
                if launches.get(k, 0) != batches_n:
                    raise AssertionError(f"eval_coco ({run}) launched {k} "
                                         f"{launches} times")
                kernels[k]["launches"] += launches[k]
            printed[run] = keys_seen
            log(f"(14d) eval_coco {run} on [{card}], {eval_images} images "
                f"(640x480) in batches of 8, Swin-T: {wall:.2f} s "
                f"(build included); launches {launches}; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in res["bbox"].items()
                    if k in BOX_KEYS) + "; " + ", ".join(
                    f"kpt_{k} {v:.4f}" for k, v in res["keypoints"].items()
                    if k in BOX_KEYS))
        if printed["random"] != printed["--weights"]:
            raise AssertionError("eval_coco --weights printed other keys")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- (e) YOLOV7 on Swin-T and PVTv2-b0: one request, one train step
    for yaml in KPTS_YOLOV7:
        ccfg = anchor_yolo_cfg(yaml)
        model = build_model(ccfg, dev, SEED)
        req = batches[1]
        build.reset_launches()
        _, dets = anchor_serve(model, ccfg, req.to(dev))
        torch.cuda.synchronize()
        serve_launches = dict(build.LAUNCHES)
        summary = check_detections(dets, req.shape[0], ccfg, yaml)
        del model
        ccfg = dataclasses.replace(ccfg, grid_mask=True, ema=True)
        _, state, train_step, _ = build_system(ccfg, device=dev, seed=SEED)
        step = make_packed_photo_step(ccfg, train_step, seed=SEED)
        build.reset_launches()
        state, m = step(state, {k: v.to(dev) for k, v in train_batch(
            train_n, gen, size).items()})
        torch.cuda.synchronize()
        train_launches = dict(build.LAUNCHES)
        check_train_metrics([m], yaml)
        for path, got_l, names in (("serving", serve_launches,
                                    ("normalize", "nms")),
                                   ("training", train_launches,
                                    ("grid_mask",))):
            for name in names:
                if got_l.get(name, 0) < 1:
                    raise AssertionError(f"YOLOV7 {yaml} {path} never "
                                         f"launched {name}")
        log(f"(14e) YOLOV7 {yaml}: bs {req.shape[0]} {summary}, launches "
            f"{serve_launches}; one train step of {train_n}: total loss "
            f"{float(m['total_loss']):.4f}, num_fg {float(m['num_fg']):.0f},"
            f" launches {train_launches}")
        del state, train_step, step
        torch.cuda.empty_cache()


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
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
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

    data = write_cli_data()
    median_a, median_b = cli_phase(dev, card, kernels, data)

    # ---- 10. multi-GPU training: (a) two gloo ranks on one card against
    # one process, (b) the CLI in an NCCL group of 1, (c) NCCL ranks
    sync_phase(dev, card, cfg)
    sync_bn_phase(dev, card)
    ddp_world1_phase(dev, card, kernels, data, cfg)
    nccl_ranks_phase(dev, card, cfg, data)
    DatasetCatalog.remove(CLI_DATASET)
    shutil.rmtree(data.work, ignore_errors=True)

    # ---- 11. the anchor-YOLO family: YOLOV7 serving and training, then
    # YOLO and YOLOV7P, YOLOV7P on ResNet-50 (anchor_yolo_phase)
    anchor_yolo_phase(dev, card, gen)

    # ---- 12. SparseInst R-50: the normalize kernel at its statistics,
    # serving, card against CPU, training, train_inseg (sparseinst_phase)
    sparseinst_phase(dev, card, gen, kernels)

    # ---- 13. DETR and AnchorDETR R-50 at 800: the normalize kernel at
    # their statistics, serving, card against CPU, training,
    # train_transformer (detr_phase)
    detr_phase(dev, card, gen, kernels)

    # ---- 14. YOLOX-KPTS on Swin-T, CSPDarknet-X and PVTv2-b1: serving,
    # card against CPU, training, eval_coco; YOLOV7 on Swin-T and PVTv2-b0
    # (yolox_kpts_phase)
    yolox_kpts_phase(dev, card, gen, kernels)

    # ---- 15. times
    log(f"YOLOX-s 640 train step bs {TRAIN_BATCH} bf16 on [{card}]: "
        f"{step_ms:.3f} ms a step = {TRAIN_BATCH * 1000 / step_ms:.1f} img/s "
        f"(host clock over {ITERS} steps after {WARMUP}, batches on the "
        f"card); peak memory {peak_gb:.3f} GB; a CLI step takes "
        f"{median_a * 1e3 / step_ms:.3f}x that on the host mosaic feed, "
        f"{median_b * 1e3 / step_ms:.3f}x on the packed feed")
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


def nccl_main() -> int:
    """``python3 chip_smoke.py --nccl``: section 10 (c) alone, on every
    visible card up to 4 (the path that exists only across cards, for a
    machine of several); the kernels are built first, so that the ranks
    only load them."""
    if torch.cuda.device_count() < 2:
        raise RuntimeError("chip_smoke --nccl: needs 2 or more CUDA cards")
    sys.path.insert(0, REPO)
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.kernels import build

    card = card_line()
    log(f"card: {card} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    data = write_cli_data()
    nccl_ranks_phase(torch.device("cuda", 0), card, YoloxConfig(), data)
    DatasetCatalog.remove(CLI_DATASET)
    shutil.rmtree(data.work, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(nccl_main() if sys.argv[1:] == ["--nccl"] else main())
