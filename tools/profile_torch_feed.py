#!/usr/bin/env python3
"""Where the CLI's training step loses time to its feed, on one CUDA card.

    python3 tools/profile_torch_feed.py

YOLOX-s 640 (``configs/coco/yolox_s.yaml``), bf16, 16 images a step, the
packed photometric step with GridMask on (the CLI's packed feed, where
not said otherwise), on ``chip_smoke.py``'s synthetic mini-COCO of 64
JPEGs and its packed shards. The same ``Trainer`` loop (the median of 12
steps' host times after 2, as ``IterationTimer`` takes them) is fed seven
ways, all of them twice in turn:

* ``on card``: a cycle of batches already on the card (``chip_smoke.py``'s
  train step);
* ``+ drain mosaic`` / ``+ drain packed``: the same, while a thread of the
  process drains the host mosaic loader or the packed shard loader into
  nothing: what sharing the interpreter with a loader costs the step;
* ``in memory``: a cycle of host numpy batches through ``CudaPrefetcher``
  (pinning and the copy to the card, no loading);
* ``packed``: ``PackedShardLoader`` through ``CudaPrefetcher`` (the CLI's
  packed feed);
* ``packed, sync copy``: the same loader, each batch copied to the card
  from pageable memory when the step takes it (no pinning, no side
  stream);
* ``mosaic``: the host mosaic ``DataLoader`` through ``CudaPrefetcher``
  into the plain train step (the CLI's host feed: float32 images,
  augmented on the host).

Every line carries the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import shutil
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from yolov7_d2_tpu_torch.config import YoloxConfig  # noqa: E402
from yolov7_d2_tpu_torch.data.catalog import (  # noqa: E402
    register_coco_instances,
)
from yolov7_d2_tpu_torch.data.coco import load_coco_json  # noqa: E402
from yolov7_d2_tpu_torch.data.device_aug import (  # noqa: E402
    make_packed_photo_step,
)
from yolov7_d2_tpu_torch.data.loader import (  # noqa: E402
    CudaPrefetcher,
    build_detection_train_loader,
)
from yolov7_d2_tpu_torch.data.mappers import YOLOXDatasetMapper  # noqa: E402
from yolov7_d2_tpu_torch.data.packed_cache import (  # noqa: E402
    PackedShardLoader,
    write_geometry_shards,
)
from yolov7_d2_tpu_torch.engine import build_yolox_system  # noqa: E402
from yolov7_d2_tpu_torch.train.trainer import HookBase, Trainer  # noqa: E402
from yolov7_d2_tpu_torch.utils.args import setup_cfg  # noqa: E402

BATCH = chip_smoke.TRAIN_BATCH
WARMUP, STEPS = 2, 12
ROUNDS = 2  # the host's pace drifts within a call: every row twice
FIELDS = ("image", "gt_boxes", "gt_classes", "gt_valid")


def drain(loader, stop: threading.Event) -> threading.Thread:
    """A thread that takes batches of ``loader`` and drops them."""
    def run():
        it = iter(loader)
        while not stop.is_set():
            next(it)
        it.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


class StepTimes(HookBase):
    """Host seconds of each step, as ``IterationTimer`` takes them."""

    def before_train(self, trainer):
        self.times, self._start = [], time.perf_counter()

    def after_step(self, trainer):
        now = time.perf_counter()
        self.times.append(now - self._start)
        self._start = now


def median_step_ms(cfg, feed, photo: bool) -> float:
    """Median ms a step of the trainer over ``feed`` (an iterator of
    batches on the card) after ``WARMUP`` steps of a fresh system; the
    step is wrapped in the packed photometric stage where ``photo``."""
    _, state, step = build_yolox_system(cfg, device="cuda", seed=0)
    if photo:
        step = make_packed_photo_step(cfg, step, seed=0)
    timer = StepTimes()
    Trainer(step, state, feed, WARMUP + STEPS, hooks=[timer]).train()
    torch.cuda.synchronize()
    return float(np.median(timer.times[WARMUP:])) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_feed: no CUDA device")
    card = chip_smoke.card_line()
    work = os.path.join(REPO, "build", "profile_torch_feed")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = chip_smoke.write_mini_coco(work)
    register_coco_instances(chip_smoke.CLI_DATASET, {}, js, img_dir)
    records = load_coco_json(js, img_dir)
    ccfg = setup_cfg(chip_smoke.cli_args(work))
    geo = os.path.join(work, "geo")
    write_geometry_shards(records, ccfg, geo)
    cfg = dataclasses.replace(YoloxConfig.from_cfg(ccfg), grid_mask=True)

    def packed():
        return PackedShardLoader(geo, BATCH, image_dtype=np.uint8, seed=0)

    def mosaic():
        return build_detection_train_loader(
            ccfg, records, YOLOXDatasetMapper(ccfg, seed=0))

    host = list(itertools.islice(iter(packed()), 4))
    on_card = [{k: torch.from_numpy(b[k]).cuda() for k in FIELDS}
               for b in host]
    # (name, feed, a loader drained beside the step, photometric stage)
    rows = [("on card", lambda: itertools.cycle(on_card), None, True),
            ("+ drain mosaic", lambda: itertools.cycle(on_card), mosaic,
             True),
            ("+ drain packed", lambda: itertools.cycle(on_card), packed,
             True),
            ("in memory", lambda: iter(CudaPrefetcher(
                itertools.cycle(host), "cuda", FIELDS)), None, True),
            ("packed", lambda: iter(CudaPrefetcher(packed(), "cuda",
                                                   FIELDS)), None, True),
            ("packed, sync copy", lambda: ({k: torch.from_numpy(b[k]).cuda()
                                            for k in FIELDS}
                                           for b in packed()), None, True),
            ("mosaic", lambda: iter(CudaPrefetcher(mosaic(), "cuda",
                                                   FIELDS)), None, False)]
    base = None
    for round_, (name, feed, background, photo) in itertools.product(
            range(ROUNDS), rows):
        stop = threading.Event()
        thread = drain(background(), stop) if background else None
        ms = median_step_ms(cfg, feed(), photo)
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        base = base or ms
        print(f"round {round_} feed {name:17s} on [{card}]: {ms:8.3f} ms "
              f"a step = {BATCH * 1e3 / ms:6.1f} img/s, {ms / base:5.2f}x "
              f"the first on-card row", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
