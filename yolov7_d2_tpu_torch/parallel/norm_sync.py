"""BatchNorm over the global batch of a process group (the counterpart of
``yolov7_d2_tpu/parallel/norm_sync.py``).

Under the JAX mesh one jitted step sees the global batch, so its BatchNorm
takes the moments of the global batch. The port's processes each hold a
share, and ``SyncBatchNorm2d`` rebuilds the global moments over the data
axis of the grid (``parallel/mesh.py``; the world without a grid): each
rank takes its per-channel count, mean and sum of squared deviations (M2),
one ``all_reduce`` over the data group of a zero-filled ``[data, 2C + 1]``
buffer in which each rank fills the row of its data rank stands in for an
all-gather (which gloo lacks for
CUDA tensors), and the rows are merged by Chan's parallel formula. That is
exact, with no E[x^2] - E[x]^2 cancellation (the stem sees raw 0-255
pixels). The backward runs through the all_reduce, so every rank's input
gradient is that of the global loss. ``torch.nn.SyncBatchNorm`` is not
used: it refuses CPU tensors, and its all-gather is missing from gloo.

On CUDA tensors the same buffer is filled and merged by the fused ATen
kernels behind ``nn.SyncBatchNorm`` (``batch_norm_stats``: Welford moments
as mean and 1 / sqrt(var + eps); ``batch_norm_gather_stats_with_counts``:
the pairwise merge and the running statistics; ``batch_norm_elemt`` and the
two backward kernels), about 16 launches a layer for a step in place of
about 80 from elementwise ops: the step is host-bound, so the launches set
its time. The CPU keeps the elementwise form, which those kernels lack.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from yolov7_d2_tpu_torch.parallel.dist import (
    data_group,
    get_data_rank,
    get_data_size,
)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the data ranks, whose gradient is the sum of the data
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, group=data_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=data_group())
        return out


class _SyncBatchNormCuda(torch.autograd.Function):
    """Training-mode BatchNorm over the group's global batch from the fused
    CUDA kernels; the input gradient sums ``sum(dy)`` and
    ``sum(dy * (x - mean))`` over the ranks, the weight and bias gradients
    stay the rank's (DDP sums them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum):
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)   # float32 for bf16
        rows = mean.new_zeros((get_data_size(), 2 * c + 1))
        row = rows[get_data_rank()]
        row[:c].copy_(mean)
        row[c:2 * c].copy_(invstd)
        row[2 * c] = x.numel() // c
        dist.all_reduce(rows, group=data_group())
        counts = rows[:, 2 * c].contiguous()
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, rows[:, :c], rows[:, c:2 * c], running_mean, running_var,
            momentum, eps, counts)
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    @staticmethod
    def backward(ctx, grad_out):
        if not grad_out.is_contiguous(memory_format=torch.channels_last):
            grad_out = grad_out.contiguous()
        x, weight, mean, invstd, counts = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
            grad_out, x, mean, invstd, weight, need_x, need_w, need_b)
        grad_x = None
        if need_x:
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, group=data_group())
            sum_dy, sum_dy_xmu = sums.split(sum_dy.shape[0])
            grad_x = torch.batch_norm_backward_elemt(
                grad_out, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                counts)
        return (grad_x, grad_w if need_w else None,
                grad_b if need_b else None, None, None, None, None)


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode moments are those of the
    global batch of the process group's data axis. Without a group, on a
    data axis of 1 and in eval mode it is ``nn.BatchNorm2d`` itself (``F.batch_norm``), and its
    state-dict keys are the same, so checkpoints move across world sizes.
    The running variance takes the global count for Bessel's correction, as
    torch does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or get_data_size() == 1:
            return super().forward(x)
        self._check_input_dim(x)
        m = 0.0
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
            m = (self.momentum if self.momentum is not None
                 else 1.0 / float(self.num_batches_tracked))
        if x.is_cuda:
            return self._forward_fused(x, m)
        return self._forward_elementwise(x, m)

    def _forward_fused(self, x: torch.Tensor, m: float) -> torch.Tensor:
        running = ((self.running_mean, self.running_var)
                   if self.track_running_stats else (None, None))
        return _SyncBatchNormCuda.apply(x, self.weight, self.bias, *running,
                                        self.eps, m)

    def _forward_elementwise(self, x: torch.Tensor, m: float) -> torch.Tensor:
        c = x.shape[1]
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        m2 = (xf - mean[:, None, None]).square().sum((0, 2, 3))
        count = mean.new_full((1,), xf.numel() // c)
        world, rank = get_data_size(), get_data_rank()
        row = torch.cat([mean, m2, count])[None]
        rows = _AllReduceSum.apply(torch.cat([
            row.new_zeros((rank, 2 * c + 1)), row,
            row.new_zeros((world - rank - 1, 2 * c + 1))]))
        means, m2s, counts = rows[:, :c], rows[:, c:2 * c], rows[:, 2 * c:]
        total = counts.sum()
        g_mean = (counts * means).sum(0) / total
        g_m2 = (m2s + counts * (means - g_mean).square()).sum(0)
        var = g_m2 / total
        if self.track_running_stats:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(g_mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(
                    g_m2 / (total - 1.0).clamp(min=1.0), alpha=m)
        y = (xf - g_mean[:, None, None]) * torch.rsqrt(var + self.eps)[
            :, None, None]
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def convert_sync_batchnorm(module: nn.Module) -> nn.Module:
    """Every ``nn.BatchNorm2d`` of ``module`` as a ``SyncBatchNorm2d`` that
    holds the same parameters and buffers (the objects themselves);
    returns the module, changed in place where it is not a BatchNorm
    itself."""
    if type(module) is nn.BatchNorm2d:
        sync = SyncBatchNorm2d(module.num_features, module.eps,
                               module.momentum, module.affine,
                               module.track_running_stats)
        if module.affine:
            sync.weight, sync.bias = module.weight, module.bias
        if module.track_running_stats:
            sync.running_mean = module.running_mean
            sync.running_var = module.running_var
            sync.num_batches_tracked = module.num_batches_tracked
        sync.train(module.training)
        return sync
    for name, child in module.named_children():
        setattr(module, name, convert_sync_batchnorm(child))
    return module


def _bn_buffers(model: nn.Module, counts: bool = False):
    return [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats
            for b in ((m.running_mean, m.running_var, m.num_batches_tracked)
                      if counts else (m.running_mean, m.running_var))]


@contextlib.contextmanager
def kept_norm_statistics(model: Optional[nn.Module]):
    """Every BatchNorm of ``model`` (``nn.BatchNorm2d``, ``SyncBatchNorm2d``;
    ``FrozenBatchNorm2d`` updates nothing) leaves the block with the
    running mean, variance and ``num_batches_tracked`` it entered with: a
    forward recomputed for the backward (``utils/remat.py``) must not
    update them a second time. Nothing where ``model`` is None."""
    buffers = [] if model is None else _bn_buffers(model, counts=True)
    kept = [b.clone() for b in buffers]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                b.copy_(k)


def all_reduce_norm(model: nn.Module) -> None:
    """Average every BatchNorm running mean and variance of ``model`` over
    the data ranks, in place (``allreduce_norm_host``; the reference's
    ``all_reduce_norm`` hook). Nothing without a group."""
    world = get_data_size()
    buffers = _bn_buffers(model)
    if world == 1 or not buffers:
        return
    flat = torch.cat([b.flatten() for b in buffers])
    dist.all_reduce(flat, group=data_group())
    flat /= world
    with torch.no_grad():
        for b, v in zip(buffers, flat.split([b.numel() for b in buffers])):
            b.copy_(v.view_as(b))


@torch.no_grad()
def precise_bn(model: nn.Module, batches: Iterable) -> None:
    """Re-estimate the BatchNorm running statistics from ``batches`` (the
    JAX package's ``precise_bn``): each batch (a tensor of images, or a
    dict with ``"image"``) runs through ``model`` in train mode from the
    running statistics as they were, and the statistics become the mean of
    those updates. Inside a group each batch is the rank's share of a
    global batch, and the moments are global (``SyncBatchNorm2d``)."""
    buffers = _bn_buffers(model)
    start = [b.clone() for b in buffers]
    accum = [torch.zeros_like(b) for b in buffers]
    was_training = model.training
    model.train()
    count = 0
    for batch in batches:
        images = batch["image"] if isinstance(batch, dict) else batch
        for b, s in zip(buffers, start):
            b.copy_(s)
        model(images)
        for a, b in zip(accum, buffers):
            a.add_(b)
        count += 1
    for b, a, s in zip(buffers, accum, start):
        b.copy_(a / count if count else s)
    model.train(was_training)
