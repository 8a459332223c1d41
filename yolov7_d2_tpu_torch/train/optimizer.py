"""SGD and AdamW with detectron2-style parameter groups (JAX
``train/optimizer.py``).

One ``torch.optim.SGD`` group for each (weight-decay class, learning-rate
multiplier) pair. The decay class comes from the module type, as the
original reference's ``build.py`` takes it: a norm layer's weight and bias
are ``norm`` (``weight_decay_norm``), another parameter named ``bias`` or
ending in ``_bias`` (the attention's ``in_proj_bias``, whose flax
counterparts are the query, key and value ``bias``) is ``bias``
(``weight_decay_bias``), the rest ``weight`` (``weight_decay``).
The JAX package finds the same classes from the flax path
(``param_decay_class``). torch's SGD adds the decay to the gradient before
the momentum, which is the order the JAX optimizer copies.

The learning rate is set before every update by the train step: the
schedule's value times the group's ``lr_mult`` (bias factor, overwrite keys
found in the module name, backbone multiplier).

:class:`AdamW` is optax's chain in the JAX ``adamw_with_groups`` (:171):
``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8; the first moment in
bfloat16 with ``SOLVER.ADAM_BF16_STATE``), then the decoupled decay of the
group's class, both scaled by the group's learning rate.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d

_NORM_TYPES = (nn.modules.batchnorm._BatchNorm, nn.GroupNorm, nn.LayerNorm,
               nn.modules.instancenorm._InstanceNorm, nn.LocalResponseNorm,
               FrozenBatchNorm2d)


def param_decay_class(module: nn.Module, param_name: str) -> str:
    """``'norm' | 'bias' | 'weight'`` of the parameter ``param_name`` of
    ``module`` (its own name, without the module path)."""
    if isinstance(module, _NORM_TYPES):
        return "norm"
    if is_bias(param_name):
        return "bias"
    return "weight"


def is_bias(param_name: str) -> bool:
    """``bias``, or a fused one such as ``in_proj_bias``."""
    return param_name == "bias" or param_name.endswith("_bias")


def _lr_multiplier(module_name: str, param_name: str, cfg) -> float:
    """Bias factor for a bias, then every overwrite key contained in the
    module name, then the backbone multiplier (JAX ``_lr_multiplier``; the
    names here are torch module names, ``backbone.dark2.0.conv``)."""
    m = 1.0
    if is_bias(param_name):
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


class AdamW(torch.optim.Optimizer):
    """optax ``scale_by_adam`` -> ``add_decayed_weights`` -> ``-lr``, one
    update over every group (JAX ``adamw_with_groups``):

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        u = mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p = p - lr u

    with the group's ``lr`` (the schedule's value times ``lr_mult``, set by
    the train step) and ``weight_decay``; the bias corrections ``1 - b^t``
    in float32, as optax computes them. ``mu_dtype`` bfloat16 keeps the
    first moment in bfloat16 between steps, with optax's decay of it by
    bf16(b1). Not ``torch.optim.AdamW``, which keeps its moments in the
    parameters' dtype."""

    B1, B2, EPS = 0.9, 0.999, 1e-8  # optax's defaults, which the JAX uses

    def __init__(self, params, lr: float,
                 mu_dtype: torch.dtype = torch.float32):
        super().__init__(params, dict(lr=lr, weight_decay=0.0))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = self.B1, self.B2
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            for st, p in zip(states, params):
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["nu"] = torch.zeros_like(p)
            count = states[0]["count"] + 1
            for st in states:
                st["count"] = count
            # a resumed state holds float32 moments (load_state_dict casts
            # to the parameters' dtype)
            mus = [st["mu"].to(self.mu_dtype) for st in states]
            nus = [st["nu"] for st in states]
            # mu = (1 - b1) g + b1 mu in float32. Over a bf16 moment optax
            # multiplies by b1 in bf16, so by bf16(0.9) = 0.8984375, and
            # XLA keeps that product in float32
            b1_mu = b1
            if self.mu_dtype != torch.float32:
                mus = [m.float() for m in mus]
                b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu = torch._foreach_mul(mus, b1_mu)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            nu = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(nu, 1.0 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(nus, b2))
            # optax's bias corrections 1 - b^t, computed in float32
            bc1, bc2 = (float(1.0 - torch.tensor(b, dtype=torch.float32)
                              ** count) for b in (b1, b2))
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.EPS)
            torch._foreach_div_(upd, den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, upd, alpha=-group["lr"])
            for st, m, n in zip(states, mu, nu):
                st["mu"] = m.to(self.mu_dtype)
                st["nu"] = n


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """SGD (``cfg.optimizer == "sgd"``) or :class:`AdamW` (``"adamw"``)
    over :func:`param_groups`."""
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(param_groups(model, cfg), lr=cfg.base_lr,
                               momentum=cfg.momentum, nesterov=cfg.nesterov)
    if cfg.optimizer == "adamw":
        return AdamW(param_groups(model, cfg), lr=cfg.base_lr,
                     mu_dtype=(torch.bfloat16 if cfg.adam_bf16_state
                               else torch.float32))
    raise NotImplementedError(f"optimizer {cfg.optimizer!r}: the JAX "
                              "package has sgd and adamw")


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
