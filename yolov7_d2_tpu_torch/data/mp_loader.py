"""A batched loader whose mappers run in worker processes (JAX
``data/mp_loader.py``): the scaling path for augmentation that the host's
threads cannot speed up, since the mosaic's many small numpy calls hold
the GIL.

``MultiProcessDataLoader`` spawns ``num_workers`` processes, each with its
own mapper (``mapper_factory(worker_id)``, seeded by its worker id, so that
the mosaic pool is a worker's own as in the reference) and its own numpy
generator (``seed + worker_id``) for each epoch's permutation of the
records, of which it maps every ``num_workers``-th from its id on. Samples
come back over one queue; the parent stacks them into batches in arrival
order (``stack_batch``). A finite pass ends when every worker has sent
its ``None``.

The workers are spawned, not forked: a forked child would inherit the
parent's CUDA state. They import the port's data modules and numpy, never
JAX, and create no CUDA context (a worker that finds one raises); each
maps on one OpenCV and one torch thread. The JAX module pins a child's JAX
to the CPU; nothing here needs that.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import sys
from typing import Callable, Dict, Iterator, List

import numpy as np

from yolov7_d2_tpu_torch.data.loader import stack_batch


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _put(out_q, stop_evt, item) -> None:
    while not stop_evt.is_set():
        try:
            out_q.put(item, timeout=0.5)
            return
        except queue_mod.Full:
            continue


def _one_thread() -> None:
    """A worker is one core's worth of mapping: one OpenCV and one torch
    thread (their pools default to a thread a core, and the workers share
    the cores)."""
    import cv2

    cv2.setNumThreads(1)
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(1)


def _worker_loop(worker_id: int, num_workers: int, records: List[dict],
                 mapper_factory: Callable[[int], Callable], out_q, stop_evt,
                 infinite: bool, shuffle: bool, seed: int) -> None:
    """JAX :38: the shard ``order[worker_id::num_workers]`` of each
    epoch's permutation, a missing file skipped; ``None`` at the end of a
    finite pass. An error is sent to the parent as ``("error", text)``."""
    try:
        _one_thread()
        mapper = mapper_factory(worker_id)
        rng = np.random.default_rng(seed + worker_id)
        n = len(records)
        while not stop_evt.is_set():
            order = rng.permutation(n) if shuffle else np.arange(n)
            for idx in order[worker_id::num_workers]:
                if stop_evt.is_set():
                    return
                try:
                    sample = mapper(records[int(idx)])
                except FileNotFoundError:
                    continue
                if _cuda_initialized():
                    raise RuntimeError(f"loader worker {worker_id} created "
                                       "a CUDA context")
                _put(out_q, stop_evt, sample)
            if not infinite:
                break
    except Exception as exc:  # noqa: BLE001 - handed to the parent
        _put(out_q, stop_evt, ("error", f"worker {worker_id}: {exc!r}"))
        return
    _put(out_q, stop_evt, None)


class MultiProcessDataLoader:
    """Batches of ``batch_size`` mapped samples from ``num_workers``
    spawned processes (JAX :79); infinite by default (training). The last
    batch of a finite pass may be short."""

    def __init__(self, records: List[dict],
                 mapper_factory: Callable[[int], Callable], batch_size: int,
                 num_workers: int = 4, shuffle: bool = True,
                 infinite: bool = True, seed: int = 0,
                 queue_size: int = 64):
        if not records:
            raise ValueError("empty dataset")
        self.records = records
        self.mapper_factory = mapper_factory
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.infinite = infinite
        self.seed = seed
        self.queue_size = queue_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue(maxsize=self.queue_size)
        stop_evt = ctx.Event()
        procs = [ctx.Process(
            target=_worker_loop,
            args=(w, self.num_workers, self.records, self.mapper_factory,
                  out_q, stop_evt, self.infinite, self.shuffle, self.seed),
            daemon=True) for w in range(self.num_workers)]
        for p in procs:
            p.start()
        finished = 0
        batch: List[Dict[str, np.ndarray]] = []
        try:
            while finished < self.num_workers:
                try:
                    sample = out_q.get(timeout=5.0)
                except queue_mod.Empty:
                    if not any(p.is_alive() for p in procs):
                        raise RuntimeError("every loader worker ended "
                                           "without its end marker")
                    continue
                if sample is None:
                    finished += 1
                    continue
                if isinstance(sample, tuple):
                    raise RuntimeError(f"loader {sample[1]}")
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield stack_batch(batch)
                    batch = []
            if batch:
                yield stack_batch(batch)
        finally:
            stop_evt.set()
            for p in procs:
                p.join(timeout=2)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=2)
