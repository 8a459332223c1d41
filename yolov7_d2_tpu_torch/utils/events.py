"""Metrics storage and writers (copies from ``yolov7_d2_tpu/utils/events.py``):
``EventStorage`` keeps the scalars of the steps, ``CommonMetricPrinter``
logs them, ``JSONWriter`` appends them to ``metrics.json`` and
``TensorboardWriter`` adds them to a TensorBoard event file (a no-op where
``torch.utils.tensorboard`` does not import), every ``period``
iterations; ``force`` writes off the period too (the trainer's last
iteration, as detectron2's writers do).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


logger = logging.getLogger("yolov7_d2_tpu_torch")


class EventStorage:
    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._history: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._latest: Dict[str, float] = {}

    def put_scalar(self, name: str, value) -> None:
        v = float(value)
        self._history[name].append(v)
        self._latest[name] = v

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def median(self, name: str) -> float:
        hist = sorted(self._history[name])
        return hist[len(hist) // 2] if hist else 0.0

    def step(self) -> None:
        self.iter += 1


class CommonMetricPrinter:
    def __init__(self, max_iter: int, period: int = 20):
        self.max_iter = max_iter
        self.period = period
        self._last_time: Optional[float] = None
        self._last_iter: Optional[int] = None

    def write(self, storage: EventStorage, force: bool = False) -> None:
        if storage.iter % self.period != 0 and not force:
            return
        now = time.time()
        if self._last_time is not None and storage.iter > self._last_iter:
            it_time = (now - self._last_time) / (storage.iter - self._last_iter)
        else:
            it_time = 0.0
        self._last_time, self._last_iter = now, storage.iter
        metrics = "  ".join(
            f"{k}: {v:.4g}" for k, v in sorted(storage.latest().items())
        )
        logger.info(
            f"iter: {storage.iter}/{self.max_iter}  "
            f"time: {it_time:.4f}s/it  {metrics}"
        )


class JSONWriter:
    def __init__(self, json_file: str, period: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self.path = json_file
        self.period = period

    def write(self, storage: EventStorage, force: bool = False) -> None:
        if storage.iter % self.period != 0 and not force:
            return
        record = {"iteration": storage.iter, **storage.latest()}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")



class TensorboardWriter:
    def __init__(self, log_dir: str, period: int = 20):
        self.period = period
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:  # the optional tensorboard package is missing
            self._writer = None

    def write(self, storage: EventStorage, force: bool = False) -> None:
        if self._writer is None or (storage.iter % self.period != 0
                                    and not force):
            return
        for k, v in storage.latest().items():
            self._writer.add_scalar(k, v, storage.iter)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
