"""Counting the CUDA kernels the host launches, by torch.profiler."""

from __future__ import annotations

import torch

# the host's kernel launch calls in a torch.profiler trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def count_cuda_launches(fn):
    """``(fn(), the CUDA kernels it launched)``, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages()
                    if e.key in LAUNCH_CALLS)
