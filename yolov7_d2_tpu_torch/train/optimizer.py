"""SGD with detectron2-style parameter groups (JAX ``train/optimizer.py``).

One ``torch.optim.SGD`` group for each (weight-decay class, learning-rate
multiplier) pair. The decay class comes from the module type, as the
original reference's ``build.py`` takes it: a norm layer's weight and bias
are ``norm`` (``weight_decay_norm``), another parameter named ``bias`` is
``bias`` (``weight_decay_bias``), the rest ``weight`` (``weight_decay``).
The JAX package finds the same classes from the flax path
(``param_decay_class``). torch's SGD adds the decay to the gradient before
the momentum, which is the order the JAX optimizer copies.

The learning rate is set before every update by the train step: the
schedule's value times the group's ``lr_mult`` (bias factor, overwrite keys
found in the module name, backbone multiplier). AdamW comes with the DETR
slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

_NORM_TYPES = (nn.modules.batchnorm._BatchNorm, nn.GroupNorm, nn.LayerNorm,
               nn.modules.instancenorm._InstanceNorm, nn.LocalResponseNorm)


def param_decay_class(module: nn.Module, param_name: str) -> str:
    """``'norm' | 'bias' | 'weight'`` of the parameter ``param_name`` of
    ``module`` (its own name, without the module path)."""
    if isinstance(module, _NORM_TYPES):
        return "norm"
    if param_name == "bias":
        return "bias"
    return "weight"


def _lr_multiplier(module_name: str, param_name: str, cfg) -> float:
    """Bias factor for a bias, then every overwrite key contained in the
    module name, then the backbone multiplier (JAX ``_lr_multiplier``; the
    names here are torch module names, ``backbone.dark2.0.conv``)."""
    m = 1.0
    if param_name == "bias":
        m *= cfg.bias_lr_factor
    name = module_name.lower()
    for key, mult in cfg.lr_multiplier_overwrite:
        if key.lower() in name:
            m *= mult
    if cfg.backbone_multiplier != 1.0 and name.startswith("backbone"):
        m *= cfg.backbone_multiplier
    return m


def param_groups(model: nn.Module, cfg) -> List[Dict]:
    """Parameter groups ``{"params", "weight_decay", "lr_mult",
    "decay_class"}``, in the order the parameters are first met."""
    decay = {"weight": cfg.weight_decay, "norm": cfg.weight_decay_norm,
             "bias": cfg.weight_decay_bias}
    groups: Dict[Tuple[str, float], Dict] = {}
    for module_name, module in model.named_modules():
        for param_name, p in module.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            cls = param_decay_class(module, param_name)
            mult = _lr_multiplier(module_name, param_name, cfg)
            group = groups.setdefault((cls, mult), {
                "params": [], "weight_decay": decay[cls], "lr_mult": mult,
                "decay_class": cls})
            group["params"].append(p)
    return list(groups.values())


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """SGD (``cfg.optimizer == "sgd"``) over :func:`param_groups`."""
    if cfg.optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet; AdamW comes "
            "with the DETR slice (ROADMAP.md Queue A.7)")
    return torch.optim.SGD(param_groups(model, cfg), lr=cfg.base_lr,
                           momentum=cfg.momentum, nesterov=cfg.nesterov)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of all elements (optax ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_gradients_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                    cfg) -> None:
    """In place: ``clip_type`` "value" clamps each element to
    +-``clip_value`` (optax ``clip``); "full_model" scales every gradient by
    clip_value / norm where the global ``norm`` reaches clip_value (optax
    ``clip_by_global_norm``)."""
    if cfg.clip_type == "value":
        for g in grads:
            g.clamp_(-cfg.clip_value, cfg.clip_value)
        return
    scale = torch.where(norm < cfg.clip_value, 1.0, cfg.clip_value / norm)
    torch._foreach_mul_(list(grads), scale)
