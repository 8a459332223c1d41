"""Post-training int8 quantization and quantization-aware training (JAX
``deploy/quantize.py``), on the port's parameters.

* weight-only int8 (:func:`quantize_weights_int8`,
  :func:`dequantize_weights`): every parameter whose flax leaf has two or
  more dimensions gets symmetric scales, one for each output channel, and
  is stored as int8 in [-127, 127];
* activation calibration (:class:`MinMaxObserver`, :func:`calibrate`):
  running min / max (or percentiles) a named activation, one scale each;
* QAT: :func:`fake_quant` rounds to the int8 grid in the forward and lets
  the gradient through inside the clip range (straight-through), and
  :func:`qat_transform_params` fake-quantizes every kernel.

A flax leaf is not a torch tensor. The JAX functions reduce every axis but
the last of each flax leaf; here the channel axis is the one the weight
carrier (``utils/weight_port.py``) maps to flax's last axis
(:func:`leaf_layouts`): dim 0 of a ``Conv2d`` or ``Linear`` weight, dim 1
of a ``ConvTranspose2d`` weight (dim 0 where it is grouped: DLA's
depthwise upsampling), the last dim of an embedding or any other table,
whose layout both packages share. flax's attention kernels are [E, H, D]
for the query, key and value (one scale a D, shared across heads), and
their biases [H, D]: the rows of ``in_proj_weight`` [3E, E] and the
entries of ``in_proj_bias`` [3E] are scaled in those groups.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a parameter keeps the last axis of its flax leaf.
    ``kernel``: a flax ``kernel`` leaf (convolution, dense, attention),
    as opposed to a table (an embedding, Swin's position bias table).
    ``heads``: an attention's fused q, k, v projection [3E, E] (or its
    bias [3E]) of this many heads."""

    dim: int
    kernel: bool
    heads: int = 0


def leaf_layouts(model: nn.Module) -> Dict[str, Layout]:
    """{parameter name: :class:`Layout`} of every parameter of ``model``
    that is a flax leaf of two or more dimensions: every parameter of two
    or more, and an attention's ``in_proj_bias`` (flax's [H, D] biases of
    the query, key and value); any other vector is a flax vector."""
    out: Dict[str, Layout] = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "in_proj_bias":
                # flax's q, k, v biases are [H, D]: one scale a D
                out[name] = Layout(0, False, module.num_heads)
                continue
            if p.dim() < 2:
                continue
            if pname == "weight" and isinstance(module, nn.ConvTranspose2d):
                out[name] = Layout(0 if module.groups > 1 else 1, True)
            elif pname == "weight" and isinstance(module,
                                                  (nn.Conv2d, nn.Linear)):
                out[name] = Layout(0, True)
            elif pname == "in_proj_weight":
                out[name] = Layout(0, True, module.num_heads)
            else:
                out[name] = Layout(p.dim() - 1, False)
    return out


def channel_absmax(w: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The largest |w| of each flax channel, broadcastable to ``w``."""
    if layout.heads:
        # in_proj_weight [3E, E] or in_proj_bias [3E]: rows h D + d of each
        # block share the scale of d
        e = w.shape[0] // 3
        d = e // layout.heads
        grouped = w.abs().reshape(3, layout.heads, d, -1)
        scale = grouped.amax(dim=(1, 3), keepdim=True).expand(
            3, layout.heads, d, 1)
        return scale.reshape(3 * e, 1) if w.dim() == 2 else scale.reshape(-1)
    dims = tuple(d for d in range(w.dim()) if d != layout.dim)
    return w.abs().amax(dim=dims, keepdim=True)


def _scale(w: torch.Tensor, layout: Layout) -> torch.Tensor:
    return channel_absmax(w, layout).clamp(min=1e-8) / 127.0


def _params(model_or_params) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_params, nn.Module):
        return {k: v.detach() for k, v in model_or_params.named_parameters()}
    return dict(model_or_params)


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------

def quantize_weights_int8(model: nn.Module
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, Optional[torch.Tensor]]]:
    """(quantized, scales) by parameter name (JAX :29): int8 of every
    parameter whose flax leaf has two or more dimensions
    (:func:`leaf_layouts`) with its float32 scales (broadcastable to it),
    every other parameter as it is with scale None."""
    layouts = leaf_layouts(model)
    qs: Dict[str, torch.Tensor] = {}
    scales: Dict[str, Optional[torch.Tensor]] = {}
    for name, w in _params(model).items():
        if name not in layouts:
            qs[name], scales[name] = w, None
            continue
        s = _scale(w.float(), layouts[name])
        qs[name] = torch.clamp(torch.round(w.float() / s), -127,
                               127).to(torch.int8)
        scales[name] = s
    return qs, scales


def dequantize_weights(qparams: Dict[str, torch.Tensor],
                       scales: Dict[str, Optional[torch.Tensor]],
                       dtype: torch.dtype = torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """q * scale in ``dtype`` where there is a scale, the rest as it is
    (JAX :55); ``model.load_state_dict(..., strict=False)`` takes it."""
    return {k: q if scales[k] is None
            else (q.float() * scales[k]).to(dtype)
            for k, q in qparams.items()}


# ---------------------------------------------------------------------------
# activation calibration
# ---------------------------------------------------------------------------

class MinMaxObserver:
    """Running min / max (or the ``percentile`` and its complement) of each
    named activation (JAX :71)."""

    def __init__(self, percentile: float = 100.0):
        self.percentile = percentile
        self._mins: Dict[str, float] = {}
        self._maxs: Dict[str, float] = {}

    def observe(self, name: str, value) -> None:
        v = (value.detach().float().cpu().numpy()
             if isinstance(value, torch.Tensor)
             else np.asarray(value)).astype(float)
        if self.percentile >= 100.0:
            lo, hi = float(v.min()), float(v.max())
        else:
            lo = float(np.percentile(v, 100 - self.percentile))
            hi = float(np.percentile(v, self.percentile))
        self._mins[name] = min(self._mins.get(name, lo), lo)
        self._maxs[name] = max(self._maxs.get(name, hi), hi)

    def scales(self) -> Dict[str, float]:
        return {k: max(abs(self._mins[k]), abs(self._maxs[k]), 1e-8) / 127.0
                for k in self._mins}


def tree_leaves(tree) -> List[Any]:
    """The tensors of ``tree`` in ``jax.tree_util.tree_leaves``' order:
    a dict by sorted key, a list or tuple in order, a dataclass by field,
    None dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


@torch.no_grad()
def calibrate(fn: Callable, batches: Iterable, observer: MinMaxObserver,
              taps: Optional[Dict[str, Callable]] = None) -> Dict[str, float]:
    """Observe ``fn(batch)``'s outputs (``output_{i}`` in
    :func:`tree_leaves`' order) and the named ``taps`` of them over the
    calibration ``batches``; return the observer's scales (JAX :98, whose
    ``apply_fn(variables, batch)`` is ``fn(batch)`` here)."""
    for batch in batches:
        out = fn(batch)
        for i, leaf in enumerate(tree_leaves(out)):
            observer.observe(f"output_{i}", leaf)
        for name, tap in (taps or {}).items():
            observer.observe(name, tap(out))
    return observer.scales()


# ---------------------------------------------------------------------------
# QAT fake-quant (straight-through estimator)
# ---------------------------------------------------------------------------

class FakeQuant(torch.autograd.Function):
    """round(x / scale) clipped to [-127, 127], times scale; the gradient
    passes to x where |x / scale| <= 127 and is 0 outside, and scale gets
    none (JAX :118-136)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return torch.clamp(torch.round(x / scale), -127, 127) * scale

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        inside = ((x / scale).abs() <= 127).to(g.dtype)
        return g * inside, torch.zeros_like(scale)


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return FakeQuant.apply(x, scale)


def qat_transform_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of :func:`leaf_layouts` fake-quantized with its
    own per-channel scales (computed without gradient, as the JAX
    ``fake_quant`` gives its scale none), the rest as it is (JAX :138):
    ``torch.func.functional_call(model, params, args)`` runs the QAT
    forward."""
    layouts = leaf_layouts(model)
    out = {}
    for name, p in model.named_parameters():
        if name in layouts:
            out[name] = fake_quant(p, _scale(p.detach(), layouts[name]))
        else:
            out[name] = p
    return out
