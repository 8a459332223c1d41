"""The trainer: hooks around the training loop (JAX ``train/trainer.py``).

The loop takes a batch (tensors on the model's device, from
``data.loader.CudaPrefetcher``), runs the train step, and calls the hooks.
The step's metrics stay on the device except every ``metrics_period``
steps and at the last step, where they are fetched into the
``EventStorage``: a fetch waits for the card, and the step is bound by the
host's launches, so no hook reads a device value on the other steps.

In a process group (``parallel/``) every rank runs the loop on its share of
the batch. At a fetch each metric is reduced over the ranks by its kind
(``train_state.METRIC_KINDS``: the shares of the loss summed into the
global loss, the global counts taken as they are, the auction's rounds as
their maximum, a per-image mean as the mean); checkpoints are written and
the eval run by rank 0, while the other ranks wait at a barrier; the entry
point gives the writers to rank 0 only.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from yolov7_d2_tpu_torch.parallel.dist import is_main_process, synchronize
from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
from yolov7_d2_tpu_torch.train.train_state import TrainState, reduce_metrics
from yolov7_d2_tpu_torch.utils.events import (
    CommonMetricPrinter,
    EventStorage,
    JSONWriter,
)

logger = logging.getLogger("yolov7_d2_tpu_torch")


class HookBase:
    def before_train(self, trainer: "Trainer") -> None: ...
    def after_step(self, trainer: "Trainer") -> None: ...
    def after_train(self, trainer: "Trainer") -> None: ...


class IterationTimer(HookBase):
    """Host seconds between the ends of two steps' hooks. The loop queues
    work on the card, so a step's time shows where the host or a fetch
    waits for it."""

    def before_train(self, trainer):
        self._start = time.perf_counter()

    def after_step(self, trainer):
        now = time.perf_counter()
        trainer.storage.put_scalar("time_per_iter", now - self._start)
        self._start = now


class PeriodicCheckpointer(HookBase):
    def __init__(self, checkpointer: Checkpointer, period: int):
        self.checkpointer = checkpointer
        self.period = period

    def after_step(self, trainer):
        it = trainer.storage.iter
        if self.period > 0 and it > 0 and it % self.period == 0:
            self.checkpointer.save(it, trainer.state)

    def after_train(self, trainer):
        self.checkpointer.save(trainer.storage.iter, trainer.state)


class PeriodicWriter(HookBase):
    """Calls the writers after every step (each keeps to its own period)
    and once more after the last step."""

    def __init__(self, writers: List):
        self.writers = writers

    def after_step(self, trainer):
        for w in self.writers:
            w.write(trainer.storage)

    def after_train(self, trainer):
        for w in self.writers:
            w.write(trainer.storage, force=True)


class EvalHook(HookBase):
    """``eval_fn(trainer) -> {metric: value}`` every ``period`` steps and
    after the last step, unless that step was just evaluated; the results
    go into the storage as ``eval/<metric>``. In a process group rank 0
    evaluates (the EMA weights are equal on every rank) and the others wait
    for it."""

    def __init__(self, period: int, eval_fn: Callable[["Trainer"], Dict]):
        self.period = period
        self.eval_fn = eval_fn
        self._done_at: Optional[int] = None

    def _evaluate(self, trainer):
        if is_main_process():
            results = self.eval_fn(trainer)
            for k, v in (results or {}).items():
                trainer.storage.put_scalar(f"eval/{k}", v)
        synchronize()
        self._done_at = trainer.storage.iter

    def after_step(self, trainer):
        it = trainer.storage.iter
        if self.period > 0 and it > 0 and it % self.period == 0:
            self._evaluate(trainer)

    def after_train(self, trainer):
        if self._done_at != trainer.storage.iter:
            self._evaluate(trainer)


class AugDisableHook(HookBase):
    """Turn off mosaic/mixup near the end of training (the reference's
    DISABLE_AT_ITER, yolox.py:105-121): a host-side switch on the mapper.
    With the loader's background threads, batches already mapped keep
    their augmentation."""

    def __init__(self, mapper, disable_at_iter: int):
        self.mapper = mapper
        self.disable_at = disable_at_iter

    def after_step(self, trainer):
        if (
            getattr(self.mapper, "enable_aug", None)
            and trainer.storage.iter >= self.disable_at
        ):
            self.mapper.enable_aug = False
            logger.info(
                f"iter {trainer.storage.iter}: strong augmentation disabled"
            )


class Trainer:
    """The loop: ``train_step(state, batch) -> (state, metrics)`` over a
    data iterator, from ``start_iter`` to ``max_iter`` steps."""

    def __init__(
        self,
        train_step: Callable,
        state: TrainState,
        data_iter: Iterable[Dict[str, torch.Tensor]],
        max_iter: int,
        hooks: Optional[List[HookBase]] = None,
        start_iter: int = 0,
        metrics_period: int = 20,
    ):
        self.train_step = train_step
        self.state = state
        self.data_iter = iter(data_iter)
        self.max_iter = max_iter
        self.hooks = hooks or []
        self.start_iter = start_iter
        self.storage = EventStorage(start_iter)
        self.metrics_period = max(metrics_period, 1)

    @staticmethod
    def default_writers(output_dir: str, max_iter: int, period: int = 20):
        return [
            CommonMetricPrinter(max_iter, period),
            JSONWriter(f"{output_dir}/metrics.json", period),
        ]

    def train(self) -> TrainState:
        for h in self.hooks:
            h.before_train(self)
        while self.storage.iter < self.max_iter:
            batch = next(self.data_iter)
            self.state, metrics = self.train_step(self.state, batch)
            self.storage.step()
            if (
                self.storage.iter % self.metrics_period == 0
                or self.storage.iter >= self.max_iter
            ):
                for k, v in reduce_metrics(metrics).items():
                    self.storage.put_scalar(k, v)
            for h in self.hooks:
                h.after_step(self)
        for h in self.hooks:
            h.after_train(self)
        # the feed's threads end with its iterator (a generator's close)
        getattr(self.data_iter, "close", lambda: None)()
        return self.state
