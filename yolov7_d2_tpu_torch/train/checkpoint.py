"""Checkpoints of the train state on ``torch.save`` (JAX
``train/checkpoint.py:17-70``, which is on orbax), and the deploy-time
helpers ``strip_optimizer``, ``load_weights`` and ``fuse_conv_bn``.

A checkpoint is one file ``<directory>/ckpt_<step>.pt`` holding the step,
the model's ``state_dict`` (parameters and BatchNorm buffers), the
optimizer's (momentum buffers, and each group's ``lr_mult``, decay class
and weight decay) and the EMA of the parameters. It is written to a
temporary file and renamed, so that a crash leaves the last one whole.
In a process group rank 0 writes and every rank then waits for it; every
rank restores, onto its own device. The state dict has the same keys at
every world size, so a checkpoint of one process resumes on N and back.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from yolov7_d2_tpu_torch.parallel.dist import is_main_process, synchronize
from yolov7_d2_tpu_torch.train.train_state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                    os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: TrainState) -> None:
        if is_main_process():
            self._write(step, state)
        synchronize()

    def _write(self, step: int, state: TrainState) -> None:
        blob = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema_params": state.ema_params,
        }
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        try:
            torch.save(blob, tmp)
            os.replace(tmp, self.path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None, map_location="cpu") -> Dict:
        """The saved dict of ``step`` (the latest where None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a checkpoint into ``state`` in place, onto the device of its
        model, and return it."""
        device = next(state.model.parameters()).device
        blob = self.load(step, map_location=device)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        if (blob["ema_params"] is None) != (state.ema_params is None):
            raise ValueError("the checkpoint and the state disagree on EMA")
        if state.ema_params is not None:
            with torch.no_grad():
                for name, value in blob["ema_params"].items():
                    state.ema_params[name].copy_(value)
        state.step = blob["step"]
        return state

    def resume_or_load(self, state: TrainState,
                       resume: bool = True) -> Tuple[TrainState, int]:
        """d2 semantics: if resume and a checkpoint exists, restore it and
        report the step; otherwise return the state untouched and 0."""
        step = self.latest_step()
        if resume and step is not None:
            return self.restore(state, step), step
        return state, 0


def strip_optimizer(blob: Dict) -> Dict[str, torch.Tensor]:
    """Deploy-time stripping of a saved checkpoint dict: the model's
    ``state_dict`` with the EMA parameters in place of the trained ones
    where there is an EMA, the BatchNorm buffers always."""
    weights = dict(blob["model"])
    weights.update(blob.get("ema_params") or {})
    return weights


def load_weights(model: torch.nn.Module, path: str):
    """Load the weights of ``path`` into ``model`` by name, leniently: a
    reference-format ``.pth`` / ``.pt`` / ``.pkl`` state dict (whose names
    are the port's), or the port's checkpoint directory, of which the
    latest checkpoint's EMA weights are taken. Returns (the number of
    weights read, ``load_state_dict``'s missing and unexpected keys)."""
    from yolov7_d2_tpu_torch.utils.weight_port import load_torch_checkpoint

    if os.path.isdir(path):
        weights = strip_optimizer(Checkpointer(path).load())
    else:
        weights = load_torch_checkpoint(path)
    return len(weights), model.load_state_dict(weights, strict=False)


def fuse_conv_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-3):
    """Fold BN into conv weights (reference fuse_conv_and_bn:11).

    kernel: [cout, cin, kh, kw] (torch layout); BN vectors: [cout].
    Returns (fused_kernel, fused_bias).
    """
    std = np.sqrt(np.asarray(bn_var) + eps)
    scale = np.asarray(bn_scale) / std
    fused_kernel = np.asarray(kernel) * scale[:, None, None, None]
    fused_bias = np.asarray(bn_bias) - np.asarray(bn_mean) * scale
    return fused_kernel, fused_bias
