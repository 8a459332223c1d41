"""Batched data loader with background workers (copies from
``yolov7_d2_tpu/data/loader.py``), and ``CudaPrefetcher``, which moves its
batches to the card one batch ahead (in place of the JAX package's
``device_prefetch``).

Mappers emit static-shape numpy samples, a thread pool maps records (cv2
releases the GIL) and batches are stacked in the index stream's order. One
change from the JAX package's loader: its producer thread ends when the
consumer has closed the iterator, instead of blocking on the full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch


def stack_batch(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Infinite (train) or single-pass (eval) batched loader."""

    def __init__(
        self,
        records: List[dict],
        mapper: Callable[[dict], Dict[str, np.ndarray]],
        batch_size: int,
        shuffle: bool = True,
        infinite: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if not records:
            raise ValueError("empty dataset")
        self.records = records
        self.mapper = mapper
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.infinite = infinite
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def _index_stream(self) -> Iterator[int]:
        n = len(self.records)
        while True:
            order = (
                self.rng.permutation(n) if self.shuffle else np.arange(n)
            )
            yield from order.tolist()
            if not self.infinite:
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Producer thread + a mapper thread pool (cv2 and large-array numpy
        release the GIL, so mapping parallelizes across ``num_workers``
        threads — the counterpart of d2's dataloader worker processes).
        Batches preserve the index-stream order."""
        from concurrent.futures import ThreadPoolExecutor

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            # the producer stops when the consumer has: it never blocks on
            # a full queue that nothing reads any more
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def safe_map(idx):
            try:
                return self.mapper(self.records[idx])
            except FileNotFoundError:
                return None

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    batch: List[Dict[str, np.ndarray]] = []
                    # keep ~2 batches of map futures in flight
                    window = max(self.batch_size * 2, self.num_workers * 2)
                    pending = []
                    stream = self._index_stream()
                    exhausted = False
                    while not stop.is_set():
                        while not exhausted and len(pending) < window:
                            try:
                                idx = next(stream)
                            except StopIteration:
                                exhausted = True
                                break
                            pending.append(ex.submit(safe_map, idx))
                        if not pending:
                            break
                        sample = pending.pop(0).result()
                        if sample is None:
                            continue
                        batch.append(sample)
                        if len(batch) == self.batch_size:
                            put(stack_batch(batch))
                            batch = []
                    if batch and not self.drop_last and not stop.is_set():
                        put(stack_batch(batch))
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


def build_detection_train_loader(cfg, records: List[dict], mapper, seed: int = 0):
    return DataLoader(
        records,
        mapper,
        batch_size=cfg.SOLVER.IMS_PER_BATCH,
        shuffle=cfg.DATALOADER.SHUFFLE,
        infinite=True,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        prefetch=cfg.DATALOADER.PREFETCH_BUFFER,
        seed=seed,
    )


def build_detection_test_loader(
    cfg, records: List[dict], mapper, batch_size: Optional[int] = None
):
    return DataLoader(
        records,
        mapper,
        batch_size=batch_size or cfg.SOLVER.IMS_PER_BATCH,
        shuffle=False,
        infinite=False,
        drop_last=False,
    )


class CudaPrefetcher:
    """Batches of ``loader`` (dicts of numpy arrays) as tensors on
    ``device``, with only the keys of ``fields`` (all where None).

    On a CUDA device each batch is pinned in the thread that iterates the
    loader (a ``non_blocking`` copy from pageable memory is synchronous;
    from pinned memory it overlaps) and its copy to the card is issued on a
    side stream one batch ahead: once the step of batch i is queued, batch
    i+1 crosses while that step runs. Before a batch is handed out, the
    current stream waits on the side stream, and each of its tensors is
    marked used by the current stream (``record_stream``), so that the
    allocator does not reuse its memory before the step is done. No thread
    of its own: the train step is bound by the host, and a pinning thread
    beside it slowed the packed feed's step (``tools/profile_torch_feed.py``
    on the card). On the CPU the batches are only wrapped as tensors.
    """

    def __init__(self, loader: Iterable[Dict[str, np.ndarray]], device,
                 fields: Optional[Sequence[str]] = None):
        self.loader = loader
        self.device = torch.device(device)
        self.fields = tuple(fields) if fields is not None else None

    def _host(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()
                if self.fields is None or k in self.fields}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        it = iter(self.loader)
        try:
            if self.device.type != "cuda":
                for batch in it:
                    yield self._host(batch)
                return
            device = torch.device("cuda", torch.cuda.current_device()
                                  if self.device.index is None
                                  else self.device.index)
            side = torch.cuda.Stream(device)

            def issue():
                batch = next(it, None)
                if batch is None:
                    return None
                host = {k: v.pin_memory()
                        for k, v in self._host(batch).items()}
                with torch.cuda.stream(side):
                    return {k: v.to(device, non_blocking=True)
                            for k, v in host.items()}

            ahead = issue()
            while ahead is not None:
                current = torch.cuda.current_stream(device)
                current.wait_stream(side)
                for t in ahead.values():
                    t.record_stream(current)
                yield ahead
                # the consumer has queued its step on the batch: the next
                # copy overlaps that step on the card
                ahead = issue()
        finally:
            getattr(it, "close", lambda: None)()  # the loader's threads end
