"""Weight pruning (JAX ``deploy/prune.py``), on the port's parameters.

* :func:`l1_filter_prune`: structured; in every convolution kernel, zero
  the output filters of the smallest L1 norms (NNI's L1FilterPruner). The
  shapes stay, so a model serves as it is.
* :func:`magnitude_prune`: unstructured; zero the smallest fraction of all
  kernels' weights by one global threshold on |w|.
* :func:`apply_masks` re-applies masks (after an optimizer step, for
  sparsity-aware fine-tuning); :func:`sparsity_report` gives the zero
  fraction of each kernel and of all of them.

Which parameters are kernels, and which axis holds their filters, is the
weight carrier's mapping (``deploy/quantize.leaf_layouts``): the JAX
functions select flax ``kernel`` leaves (four-dimensional ones for the
filter prune) and their last axis. So embeddings, norm scales and tables,
which torch also calls ``weight``, are never pruned; the fused
``in_proj_weight`` of an attention is the three flax kernels of its query,
key and value.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.deploy.quantize import leaf_layouts


def _kernels(model: nn.Module):
    return {k: v for k, v in leaf_layouts(model).items() if v.kernel}


def _filter_norms(w: torch.Tensor, dim: int) -> torch.Tensor:
    return w.abs().sum(dim=tuple(d for d in range(w.dim()) if d != dim))


def l1_filter_prune(model: nn.Module, sparsity: float = 0.5,
                    min_filters: int = 8
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """(pruned, masks) by parameter name (JAX :43): in every convolution
    kernel of more than ``min_filters`` filters, the ``k = min(int(O *
    sparsity), O - 1)`` filters of the smallest L1 norms zeroed (those at
    or below the k-th smallest norm); every other parameter as it is, its
    mask ones. Masks are float32."""
    layouts = _kernels(model)
    pruned, masks = {}, {}
    for name, w in model.named_parameters():
        w = w.detach()
        layout = layouts.get(name)
        mask = torch.ones_like(w, dtype=torch.float32)
        if layout is not None and w.dim() == 4:
            o = w.shape[layout.dim]
            k = min(int(o * sparsity), o - 1)
            if o > min_filters and k > 0:
                norms = _filter_norms(w.float(), layout.dim)
                thresh = torch.sort(norms).values[k - 1]
                shape = [1] * w.dim()
                shape[layout.dim] = o
                mask = (norms > thresh).float().reshape(shape).expand_as(
                    w).contiguous()
        pruned[name], masks[name] = w * mask, mask
    return pruned, masks


def magnitude_prune(model: nn.Module, sparsity: float = 0.5
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """(pruned, masks) by parameter name (JAX :79): the weights of every
    kernel with |w| at or below the global threshold (the ``int(N *
    sparsity)``-th smallest of all N kernel magnitudes, counted from 0)
    zeroed; the rest as it is."""
    layouts = _kernels(model)
    params = {k: v.detach() for k, v in model.named_parameters()}
    mags = [params[k].abs().flatten().float() for k in layouts]
    if not mags:
        return params, {k: torch.ones_like(v) for k, v in params.items()}
    allmag = torch.cat(mags)
    k = int(allmag.numel() * sparsity)
    thresh = (torch.kthvalue(allmag.cpu(), k + 1).values if k > 0
              else torch.tensor(-1.0))
    pruned, masks = {}, {}
    for name, w in params.items():
        if name in layouts:
            mask = (w.abs() > thresh.to(w.device)).float()
        else:
            mask = torch.ones_like(w, dtype=torch.float32)
        pruned[name], masks[name] = w * mask, mask
    return pruned, masks


def apply_masks(params: Dict[str, torch.Tensor],
                masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """params * masks, name by name (JAX :114)."""
    return {k: p * masks[k] for k, p in params.items()}


def sparsity_report(model: nn.Module,
                    params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, float]:
    """The zero fraction of each kernel of ``model`` (``params`` where
    given, else its own) by the module's name (an attention's fused
    projection as ``<module>.in_proj``), and ``global`` over all of them
    (JAX :119)."""
    values = params if params is not None else {
        k: v.detach() for k, v in model.named_parameters()}
    report: Dict[str, float] = {}
    total = nonzero = 0
    for name in _kernels(model):
        w = values[name]
        nz = int(torch.count_nonzero(w))
        module, _, leaf = name.rpartition(".")
        key = f"{module}.in_proj" if leaf == "in_proj_weight" else module
        report[key] = 1.0 - nz / w.numel()
        total += w.numel()
        nonzero += nz
    report["global"] = 1.0 - nonzero / max(total, 1)
    return report
