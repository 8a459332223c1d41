#!/usr/bin/env python3
"""Device times of the port's kernels beside another build of them, and
where the NMS kernel's time goes, on one CUDA card.

    python3 tools/kernel_times.py [--against DIR]

Builds ``yolov7_d2_tpu_torch/csrc`` with ``kernels/build.py``: as it is,
and with ``-DYOLO_NMS_CLOCKS``, where thread 0 of each NMS block reads
``clock64()`` as it enters each step (``NMS_STEP`` in ``csrc/nms.cu``).
``--against DIR`` also builds the ``.cu`` files of DIR, which must have the
same C entry points: for example an earlier commit's,

    git archive REV yolov7_d2_tpu_torch/csrc | tar -x -C build/old
    python3 tools/kernel_times.py --against build/old/yolov7_d2_tpu_torch/csrc

On ``chip_smoke.py``'s inputs (the same seed and draws) it launches each
kernel through its wrapper, checks it against its plain version, and times
it two ways: queued behind a sleep kernel (``chip_smoke.kernel_ms``, the
device's time) and back to back by CUDA events (``chip_smoke.cuda_ms``,
which holds the wrapper's host cost where that exceeds the kernel). With
``--against`` the two builds are timed in turns, against, this, this,
against. For NMS it adds max_out 1 and 300, bs 1, the one-class case and
the mean cycles a block spends in each step. Imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import sys
from pathlib import Path

import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from yolov7_d2_tpu_torch.kernels import build  # noqa: E402
from yolov7_d2_tpu_torch.kernels.grid_mask import (  # noqa: E402
    grid_mask,
    grid_mask_plain,
)
from yolov7_d2_tpu_torch.kernels.nms import (  # noqa: E402
    nms_batched,
    nms_batched_plain,
)
from yolov7_d2_tpu_torch.kernels.preprocess import (  # noqa: E402
    normalize_images,
    normalize_images_plain,
)
from yolov7_d2_tpu_torch.ops.nms import _class_offset_boxes  # noqa: E402

STEPS = ("key", "sort", "gather", "scan")  # NMS_STEP(0) .. NMS_STEP(4)
CLOCK_BLOCKS, CLOCK_SLOTS = 4096, 8  # csrc/nms.cu kClockBlocks, kClockSlots


def same(got, want) -> bool:
    if isinstance(got, tuple):
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def nms_cycles(clocked, boxes, scores, thr, max_out) -> list:
    """Mean cycles a block in each step, from the clocked build."""
    with build.use_library(clocked):
        nms_batched(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    clk = torch.zeros(CLOCK_BLOCKS * CLOCK_SLOTS, dtype=torch.int64)
    build.check(clocked.yolo_nms_clocks(ctypes.c_void_p(clk.data_ptr())),
                "nms clocks")
    c = clk.view(CLOCK_BLOCKS, CLOCK_SLOTS)[:scores.shape[0], :len(STEPS) + 1]
    return [float(x) for x in (c[:, 1:] - c[:, :-1]).double().mean(0)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path,
                        help="a directory of .cu files with the same C "
                        "entry points")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times: no CUDA device")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)

    this = sorted(build.SOURCE_DIR.glob("*.cu"))
    jobs = {"this": (this, ()), "clocked": (this, ("-DYOLO_NMS_CLOCKS",))}
    if args.against:
        jobs["against"] = (sorted(args.against.glob("*.cu")), ())
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(build.build_library, *job)
                   for name, job in jobs.items()}
        libs = {name: f.result()[0] for name, f in futures.items()}
    turns = ["against", "this", "this", "against"] if args.against \
        else ["this"]

    def compare(label, run, plain):
        """Checks each build against the plain result and prints its times
        in turns, queued and by events."""
        want = plain()
        times = {}
        for name in turns:
            with build.use_library(libs[name]):
                got = run()
                torch.cuda.synchronize()
                if not same(got, want):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version: {label}")
                t = times.setdefault(name, {"queued": [], "events": []})
                t["queued"].append(chip_smoke.kernel_ms(run))
                t["events"].append(chip_smoke.cuda_ms(run))
        print(f"{label} on [{card}]: " + "; ".join(
            f"{name} queued " + "/".join(f"{x:.4f}" for x in t["queued"])
            + " ms, events " + "/".join(f"{x:.4f}" for x in t["events"])
            + " ms" for name, t in times.items()), flush=True)
        return want

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    shape = (chip_smoke.BATCH, chip_smoke.SIZE, chip_smoke.SIZE, 3)
    images = torch.randint(0, 256, shape, generator=gen,
                           dtype=torch.uint8).to(dev)
    args_n = (images, (0.0,) * 3, (1.0,) * 3, torch.bfloat16)
    compare(f"normalize {shape} -> bf16", lambda: normalize_images(*args_n),
            lambda: normalize_images_plain(*args_n))
    del images

    boxes, scores, cls = chip_smoke.random_nms_inputs(dev, gen)
    serving = _class_offset_boxes(boxes, cls).contiguous()
    crowd, crowd_scores = chip_smoke.crowd_nms_inputs(dev, gen)
    cases = [("80 classes", serving, scores, 0.65, (1, 100, 300)),
             ("80 classes bs 1", serving[:1].contiguous(),
              scores[:1].contiguous(), 0.65, (100,)),
             ("one class", crowd, crowd_scores, 0.3, (1, 100, 300))]
    for what, b, s, thr, outs in cases:
        for max_out in outs:
            label = (f"nms {what} {tuple(s.shape)} thr {thr} max_out "
                     f"{max_out}")
            want = compare(
                label, lambda: nms_batched(b, s, thr, max_out),
                lambda: nms_batched_plain(b, s, thr, max_out))
            cycles = nms_cycles(libs["clocked"], b, s, thr, max_out)
            print(f"{label}: kept {float(want[1].sum(1).float().mean()):.1f}"
                  " an image; cycles a block: " + ", ".join(
                      f"{step} {n:.0f}" for step, n in zip(STEPS, cycles)),
                  flush=True)
    del boxes, scores, cls, serving, crowd, crowd_scores

    params, u8, f32 = chip_smoke.grid_mask_inputs(dev, gen)
    for imgs in (u8, f32):
        compare(f"grid_mask {tuple(imgs.shape)} {imgs.dtype}",
                lambda: grid_mask(imgs, params),
                lambda: grid_mask_plain(imgs, params))
    return 0


if __name__ == "__main__":
    sys.exit(main())
