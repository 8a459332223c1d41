"""Rematerialization: a function's activations are not kept for the
backward but recomputed there (the JAX package's ``jax.checkpoint`` under
``TPU.REMAT``, ``train/train_state.py:102``, and ``nn.remat`` under
``MODEL.DETR.REMAT``, ``models/layers/transformer.py:185``), through
``torch.utils.checkpoint`` without reentry.

Two things would differ between the first forward and its recompute, and
either would change the gradient or the state without an error:

* draws from an explicit ``torch.Generator`` (the DETR family's dropout,
  ConvNeXt's drop path, PP-YOLO's DropBlock, the R-CNN samplers):
  ``checkpoint`` restores only the default generators. :func:`remat_call`
  takes each given generator's state before the first forward and sets it
  again for the recompute, so that the recompute draws the first forward's
  masks, as ``nn.remat`` replays its keys; after the recompute each
  generator is back where the backward found it.
* a train-mode BatchNorm's running statistics and ``num_batches_tracked``:
  the recompute runs under ``parallel.norm_sync.kept_norm_statistics``, so
  that they take one update a step, the first forward's, as the JAX step's
  ``batch_stats`` come from its one primal forward. ``SyncBatchNorm2d``
  issues its collectives again in the recompute, in the same order on
  every rank.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from yolov7_d2_tpu_torch.parallel.norm_sync import kept_norm_statistics


def remat_call(fn: Callable, *args,
               generators: Iterable[Optional[torch.Generator]] = (),
               norms: Optional[nn.Module] = None):
    """``fn(*args)`` with its activations recomputed in the backward. The
    recompute draws from ``generators`` (None entries skipped) what the
    first forward drew, and leaves the BatchNorm statistics of ``norms``
    as the first forward left them."""
    gens = [g for g in generators if g is not None]
    start = {}

    @contextlib.contextmanager
    def first():
        start["states"] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def again():
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, start["states"]):
            g.set_state(state)
        try:
            with kept_norm_statistics(norms):
                yield
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (first(), again()))


class Remat(nn.Module):
    """``module`` whose forward goes through :func:`remat_call`, replaying
    ``module.generator`` where it has one and keeping its BatchNorm
    statistics. Under ``DistributedDataParallel`` this wrapper goes inside
    the DDP wrapper, so that the recompute does not run DDP's forward in
    the middle of its backward."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args):
        return remat_call(self.module, *args,
                          generators=(getattr(self.module, "generator",
                                              None),),
                          norms=self.module)
