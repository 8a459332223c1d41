"""Tracing and timing on ``torch.profiler`` (the port's counterpart of
``yolov7_d2_tpu/utils/profiling.py``): ``trace`` records the enclosed
block, ``ProfilerHook`` a window of training iterations, each as a Chrome
trace (``trace.json``, Perfetto or chrome://tracing) in ``log_dir``;
``timed`` times one call up to the card's queued work being done;
``count_cuda_launches`` counts the CUDA kernels the host launches.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

from yolov7_d2_tpu_torch.train.trainer import HookBase

logger = logging.getLogger("yolov7_d2_tpu_torch")

# the host's kernel launch calls in a torch.profiler trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def _start(log_dir: str):
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=_activities())
    prof.__enter__()
    return prof


def _stop(prof, log_dir: str) -> str:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block into ``log_dir/trace.json``."""
    prof = _start(log_dir)
    try:
        yield prof
    finally:
        _stop(prof, log_dir)


class ProfilerHook(HookBase):
    """Record the iterations [start_iter, start_iter + num_iters) into
    ``log_dir/trace.json``."""

    def __init__(self, log_dir: str, start_iter: int = 10, num_iters: int = 5):
        self.log_dir = log_dir
        self.start = start_iter
        self.stop = start_iter + num_iters
        self._prof = None

    def after_step(self, trainer):
        it = trainer.storage.iter
        if it == self.start and self._prof is None:
            self._prof = _start(self.log_dir)
            logger.info(f"profiler: trace started at iter {it}")
        elif it >= self.stop and self._prof is not None:
            path = _stop(self._prof, self.log_dir)
            self._prof = None
            logger.info(f"profiler: trace written to {path} at iter {it}")

    def after_train(self, trainer):
        if self._prof is not None:
            _stop(self._prof, self.log_dir)
            self._prof = None


def timed(fn, *args, sync_result=True, **kwargs):
    """Time one call up to the card's queued work being done (the
    result's); returns (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync_result and torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def count_cuda_launches(fn):
    """``(fn(), the CUDA kernels it launched)``, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages()
                    if e.key in LAUNCH_CALLS)
