"""FBNetV2 / V3 trunks (the FBNet part of JAX ``models/backbones/mobile.py``):
the backbone of ``configs/coco/detr/d2go/detr_fbv3_bs16.yaml`` and
``smca_fbv3.yaml`` (``FBNetV3_A_dsmask_C5``).

A trunk is a stage table (:data:`FBNET_ARCH`, or an ``ARCH_DEF`` literal
through :func:`normalize_arch_def`): each stage is groups of ``(op,
channels, stride, repeats, expansion)``, the first block of a group at the
group's stride. The ops are mobile_cv's: ``conv_k{k}`` (conv BN act),
``ir_k{k}`` (the inverted residual: 1x1 expand, depthwise k x k, optional
squeeze-excitation, 1x1 project, the residual at stride 1 and equal
width), ``skip`` and ``ir_pool``; ``_se`` adds the squeeze-excitation and
``_hs`` swaps ReLU6 for hard-swish; a negative stride upsamples (nearest)
by its size. With ``dw_skip_bnrelu`` (the default, the reference's
quantization-friendly variant) the depthwise convolution has no BN and no
activation. Only the stages that feed a requested output are built, as in
the JAX trunk, so that the parameters match. Stage i's output is
``trunk{i}``, at stride ``2 ** (i + 1)``.

BatchNorm: eps 1e-5, momentum 0.1 (flax 0.9); a conv-BN-act casts its
output to the stream's dtype. The squeeze-excitation and ``ir_pool``'s
pooling run in float32 outside autocast and cast back.

Module names are the flax ones (``s{stage}_g{group}_b{block}`` with
``conv`` / ``bn``, ``expand``, ``dw``, ``se.reduce`` / ``se.expand``,
``project``, ``bridge``), so that ``utils/weight_port.py`` maps them by
turning dots into slashes.

The registry's other mobile backbones, which no yaml sets: ``MobileViT``
(JAX :472; :class:`MobileViTBlock` :425: a local 3x3, a 1x1 into the
transformer width, the map unfolded into 2 x 2 patch positions of tokens,
pre-norm transformer layers of float32 LayerNorms, flax's multi-head
attention and a SiLU MLP, folded back, a 1x1 out and a 3x3 fusion with the
input), the FBNet trunk under ``necks/fpn.py``'s FPN (:class:`FBNetFPN`,
JAX :533, ``FBNetV2FpnBackbone`` :555) and CSPResNet50d (JAX :580: the
ResNet-50-vd without FrozenBN), with their builders of a merged
``CfgNode``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.backbones.resnet import ResNet, ResNetSpec
from yolov7_d2_tpu_torch.models.layers.transformer import (
    LayerNorm,
    MultiheadAttention,
)
from yolov7_d2_tpu_torch.models.necks.fpn import FPN


def _apply_act(x: torch.Tensor, act) -> torch.Tensor:
    """act: True / "relu6" (the mobile default), "hswish" (the ``_hs``
    ops), False / "none"."""
    if act is True or act == "relu6":
        return F.relu6(x)
    if act == "hswish":
        return x * F.relu6(x + 3.0) / 6.0
    return x


def _upsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """mobile_cv's negative stride: nearest upsampling by ``-stride`` (the
    convolution then runs at stride 1)."""
    if stride < 0:
        return F.interpolate(x, scale_factor=-stride, mode="nearest")
    return x


def _round_channels(c: float, divisor: int = 8) -> int:
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:  # never round down by more than 10%
        new += divisor
    return new


class ConvBNAct(nn.Module):
    """Conv k x k without bias (a negative stride upsamples first) -> BN ->
    act (JAX :32)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: Any = True):
        super().__init__()
        self.stride, self.act = stride, act
        self.conv = nn.Conv2d(c_in, c_out, kernel, max(stride, 1),
                              (kernel - 1) // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(_upsample(x, self.stride))
        return _apply_act(self.bn(y), self.act).to(y.dtype)


class SqueezeExcite(nn.Module):
    """Mean in float32 -> 1x1 reduce -> ReLU -> 1x1 expand -> sigmoid gate,
    both with biases, outside autocast; the gated map in the input's dtype
    (JAX :71)."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, se_channels, 1)
        self.expand = nn.Conv2d(se_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            s = x.float().mean((2, 3), keepdim=True)
            s = self.expand(F.relu(self.reduce(s)))
            return (x * torch.sigmoid(s)).to(x.dtype)


class InvertedResidual(nn.Module):
    """[1x1 expand] -> depthwise k x k (raw with ``dw_skip_bnrelu``, else
    conv-BN-act) -> [SE] -> 1x1 project (BN, no act) -> [+ input] (JAX
    :91). The hidden width is the input's times ``expand``, rounded to 8."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 expand: float = 6.0, kernel: int = 3, se: bool = False,
                 dw_skip_bnrelu: bool = False, act: Any = True):
        super().__init__()
        mid = _round_channels(c_in * expand)
        self.stride = stride
        self.expand = (ConvBNAct(c_in, mid, 1, act=act) if mid != c_in
                       else None)
        if dw_skip_bnrelu:
            self.dw = nn.Conv2d(mid, mid, kernel, max(stride, 1),
                                (kernel - 1) // 2, groups=mid, bias=False)
        else:
            self.dw = ConvBNAct(mid, mid, kernel, max(stride, 1), groups=mid,
                                act=act)
        self.se = (SqueezeExcite(mid, _round_channels(mid / 4)) if se
                   else None)
        self.project = ConvBNAct(mid, c_out, 1, act=False)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.dw(_upsample(y, self.stride))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return y + x if self.residual else y


class IRPool(nn.Module):
    """mobile_cv ``ir_pool``: 1x1 expand -> global mean in float32 -> act
    -> 1x1 project with bias (JAX :145)."""

    def __init__(self, c_in: int, c_out: int, expand: float = 6.0,
                 act: Any = True):
        super().__init__()
        mid = _round_channels(c_in * expand)
        self.act = act
        self.expand = ConvBNAct(c_in, mid, 1, act=act)
        self.project = nn.Conv2d(mid, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x)
        with torch.autocast(y.device.type, enabled=False):
            p = _apply_act(y.float().mean((2, 3), keepdim=True), self.act)
        return self.project(p.to(y.dtype))


class SkipOp(nn.Module):
    """mobile_cv ``skip``: the identity where the shape stays, else a 1x1
    conv-BN ``bridge`` (JAX :169)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.bridge = (None if stride == 1 and c_in == c_out
                       else ConvBNAct(c_in, c_out, 1, stride, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.bridge is None else self.bridge(x)


# Stage tables: each stage is a list of (op, out_channels, stride, repeats,
# expansion) groups; the first block of a group takes the stride, repeats run
# at stride 1. op in {conv_k3, ir_k3, ir_k5, ir_k3_se, ir_k5_se}. These are
# the published FBNetV3 architecture hyperparameters
# (the reference's fbnet_v3.py:67-296, from
# facebookresearch/mobile_cv), re-expressed as data.
FBNET_ARCH = {
    # the reference's "default"/"default_dsmask" trunk — DEFAULT_STAGES
    # verbatim (fbnet_v3.py:52-64; the MobileNetV2-like FBNetV2-builder
    # default). Stages 0-3 are the detection trunk there ([0:4]); stage 4
    # (160/320 e6) is DEFAULT_STAGES' "resolution stage 4", exposed here as
    # trunk4 for stride-32 consumers.
    "default": [
        [("conv_k3", 32, 2, 1, 1), ("ir_k3", 16, 1, 1, 1)],
        [("ir_k3", 24, 2, 2, 6)],
        [("ir_k3", 32, 2, 3, 6)],
        [("ir_k3", 64, 2, 4, 6), ("ir_k3", 96, 1, 3, 6)],
        [("ir_k3", 160, 2, 3, 6), ("ir_k3", 320, 1, 1, 6)],
    ],
    "FBNetV3_A_dsmask": [
        [("conv_k3", 16, 2, 1, 1), ("ir_k3", 16, 1, 1, 1)],
        [("ir_k5", 32, 2, 1, 4), ("ir_k5", 32, 1, 1, 2)],
        [("ir_k5", 40, 2, 1, 4), ("ir_k3", 40, 1, 3, 3)],
        [("ir_k5", 72, 2, 1, 4), ("ir_k3", 72, 1, 3, 3),
         ("ir_k5", 112, 1, 1, 4), ("ir_k5", 112, 1, 3, 4)],
        [("ir_k5", 184, 2, 1, 4), ("ir_k3", 184, 1, 4, 4),
         ("ir_k5", 200, 1, 1, 6)],
    ],
    "FBNetV3_A_dsmask_tiny": [
        [("conv_k3", 8, 2, 1, 1), ("ir_k3", 8, 1, 1, 1)],
        [("ir_k5", 16, 2, 1, 3), ("ir_k5", 16, 1, 1, 2)],
        [("ir_k5", 24, 2, 1, 4), ("ir_k3", 24, 1, 2, 3)],
        [("ir_k5", 40, 2, 1, 4), ("ir_k3", 40, 1, 2, 3),
         ("ir_k5", 64, 1, 1, 4), ("ir_k5", 64, 1, 2, 3)],
        [("ir_k5", 92, 2, 1, 4), ("ir_k3", 92, 1, 2, 4),
         ("ir_k5", 92, 1, 1, 6)],
    ],
    "FBNetV3_A": [
        [("conv_k3", 16, 2, 1, 1), ("ir_k3", 16, 1, 2, 1)],
        [("ir_k5", 24, 2, 1, 4), ("ir_k5", 24, 1, 3, 3)],
        [("ir_k5_se", 32, 2, 1, 4), ("ir_k3_se", 32, 1, 3, 3)],
        [("ir_k5", 64, 2, 1, 4), ("ir_k3", 64, 1, 3, 3),
         ("ir_k5_se", 112, 1, 1, 4), ("ir_k5_se", 112, 1, 5, 3)],
        [("ir_k5_se", 184, 2, 1, 4), ("ir_k3_se", 184, 1, 4, 4),
         ("ir_k5_se", 200, 1, 1, 6)],
    ],
    "FBNetV3_B": [
        [("conv_k3", 16, 2, 1, 1), ("ir_k3", 16, 1, 2, 1)],
        [("ir_k5", 24, 2, 1, 4), ("ir_k5", 24, 1, 3, 2)],
        [("ir_k5_se", 40, 2, 1, 5), ("ir_k5_se", 40, 1, 4, 3)],
        [("ir_k5", 72, 2, 1, 5), ("ir_k3", 72, 1, 4, 3),
         ("ir_k3_se", 120, 1, 1, 5), ("ir_k5_se", 120, 1, 5, 3)],
        [("ir_k3_se", 184, 2, 1, 6), ("ir_k5_se", 184, 1, 5, 4),
         ("ir_k5_se", 224, 1, 1, 6)],
    ],
    "FBNetV3_C": [
        [("conv_k3", 16, 2, 1, 1), ("ir_k3", 16, 1, 2, 1)],
        [("ir_k5", 24, 2, 1, 5), ("ir_k3", 24, 1, 4, 3)],
        [("ir_k5_se", 48, 2, 1, 5), ("ir_k5_se", 48, 1, 4, 2)],
        [("ir_k5", 88, 2, 1, 4), ("ir_k3", 88, 1, 4, 3),
         ("ir_k3_se", 120, 1, 1, 4), ("ir_k5_se", 120, 1, 5, 3)],
        [("ir_k5_se", 216, 2, 1, 5), ("ir_k5_se", 216, 1, 5, 5),
         ("ir_k5_se", 216, 1, 1, 6)],
    ],
    "FBNetV3_D": [
        [("conv_k3", 24, 2, 1, 1), ("ir_k3", 16, 1, 2, 1)],
        [("ir_k3", 24, 2, 1, 5), ("ir_k3", 24, 1, 5, 2)],
        [("ir_k5_se", 40, 2, 1, 4), ("ir_k3_se", 40, 1, 4, 3)],
        [("ir_k3", 72, 2, 1, 5), ("ir_k3", 72, 1, 4, 3),
         ("ir_k3_se", 128, 1, 1, 5), ("ir_k5_se", 128, 1, 6, 3)],
        [("ir_k3_se", 208, 2, 1, 6), ("ir_k5_se", 208, 1, 5, 5),
         ("ir_k5_se", 240, 1, 1, 6)],
    ],
    "FBNetV3_E": [
        [("conv_k3", 24, 2, 1, 1), ("ir_k3", 16, 1, 3, 1)],
        [("ir_k5", 24, 2, 1, 4), ("ir_k5", 24, 1, 4, 2)],
        [("ir_k5_se", 48, 2, 1, 4), ("ir_k5_se", 48, 1, 4, 3)],
        [("ir_k5", 80, 2, 1, 5), ("ir_k3", 80, 1, 4, 3),
         ("ir_k3_se", 128, 1, 1, 5), ("ir_k5_se", 128, 1, 7, 3)],
        [("ir_k3_se", 216, 2, 1, 6), ("ir_k5_se", 216, 1, 5, 5),
         ("ir_k5_se", 240, 1, 1, 6)],
    ],
    "FBNetV3_F": [
        [("conv_k3", 24, 2, 1, 1), ("ir_k3", 24, 1, 3, 1)],
        [("ir_k5", 32, 2, 1, 4), ("ir_k5", 32, 1, 4, 2)],
        [("ir_k5_se", 56, 2, 1, 4), ("ir_k5_se", 56, 1, 4, 3)],
        [("ir_k5", 88, 2, 1, 5), ("ir_k3", 88, 1, 4, 3),
         ("ir_k3_se", 144, 1, 1, 5), ("ir_k5_se", 144, 1, 8, 3)],
        [("ir_k3_se", 248, 2, 1, 6), ("ir_k5_se", 248, 1, 6, 5),
         ("ir_k5_se", 272, 1, 1, 6)],
    ],
    "FBNetV3_G": [
        [("conv_k3", 32, 2, 1, 1), ("ir_k3", 24, 1, 3, 1)],
        [("ir_k5", 40, 2, 1, 4), ("ir_k5", 40, 1, 4, 2)],
        [("ir_k5_se", 56, 2, 1, 4), ("ir_k5_se", 56, 1, 4, 3)],
        [("ir_k5", 104, 2, 1, 5), ("ir_k3", 104, 1, 4, 3),
         ("ir_k3_se", 160, 1, 1, 5), ("ir_k5_se", 160, 1, 8, 3)],
        [("ir_k3_se", 264, 2, 1, 6), ("ir_k5_se", 264, 1, 6, 5),
         ("ir_k5_se", 288, 1, 2, 6)],
    ],
    "FBNetV3_H": [
        [("conv_k3", 48, 2, 1, 1), ("ir_k3", 32, 1, 4, 1)],
        [("ir_k5", 64, 2, 1, 4), ("ir_k5", 64, 1, 6, 2)],
        [("ir_k5_se", 80, 2, 1, 4), ("ir_k5_se", 80, 1, 6, 3)],
        [("ir_k5", 160, 2, 1, 5), ("ir_k3", 160, 1, 6, 3),
         ("ir_k3_se", 240, 1, 1, 5), ("ir_k5_se", 240, 1, 12, 3)],
        [("ir_k3_se", 400, 2, 1, 6), ("ir_k5_se", 400, 1, 8, 5),
         ("ir_k5_se", 480, 1, 3, 6)],
    ],
    # quantization-friendly variant (reference fbnet_v3.py:347): B with a
    # shorter stage-2/3 schedule and no SE anywhere
    "FBNetV3_B_light_no_se": [
        [("conv_k3", 16, 2, 1, 1), ("ir_k3", 16, 1, 2, 1)],
        [("ir_k5", 24, 2, 1, 4), ("ir_k5", 24, 1, 2, 2)],
        [("ir_k5", 40, 2, 1, 5), ("ir_k5", 40, 1, 3, 3)],
        [("ir_k5", 72, 2, 1, 5), ("ir_k3", 72, 1, 4, 3),
         ("ir_k3", 120, 1, 1, 5), ("ir_k5", 120, 1, 5, 3)],
        [("ir_k3", 184, 2, 1, 6), ("ir_k5", 184, 1, 5, 4),
         ("ir_k5", 224, 1, 1, 6)],
    ],
}

# SE-free variants (reference fbnet_v3.py:298,322 — "SE is not
# quantization friendly"): identical stage tables with the _se ops demoted
for _src in ("FBNetV3_A", "FBNetV3_B"):
    FBNET_ARCH[f"{_src}_no_se"] = [
        [(op.replace("_se", ""), c, s, n, e) for (op, c, s, n, e) in stage]
        for stage in FBNET_ARCH[_src]
    ]

# the remaining MODEL_ARCH_BUILTIN trunk names (reference fbnet_v3.py:420-527)
# — every reference MODEL.FBNET_V2.ARCH value now resolves:
# "default_dsmask" shares the default trunk (:429-436), "FBNetV3_B_light_large"
# is the light-no-SE trunk (:512-519), "FBNetV3_G_fpn" is the full 5-stage G
# trunk (:520-527).
FBNET_ARCH["default_dsmask"] = FBNET_ARCH["default"]
FBNET_ARCH["FBNetV3_B_light_large"] = FBNET_ARCH["FBNetV3_B_light_no_se"]
FBNET_ARCH["FBNetV3_G_fpn"] = FBNET_ARCH["FBNetV3_G"]


def normalize_arch_def(arch_def) -> list:
    """Normalize a reference-style ARCH_DEF (mobile_cv block tuples, e.g.
    ``("ir_k5", 40, 2, 1, {"expansion": 4}, {...})``) into this module's
    ``(op, channels, stride, repeats, expansion)`` rows. Supports the cfg
    literal-dict path (reference fbnet_v2.py:64-71 _merge_fbnetv2_arch_def):
    pass the merged dict's "trunk" list."""
    stages = []
    for stage in arch_def:
        rows = []
        for blk in stage:
            blk = list(blk)
            op, c, s = blk[0], int(blk[1]), int(blk[2])
            n = int(blk[3]) if len(blk) > 3 else 1
            e = 6.0
            for extra in blk[4:]:
                if isinstance(extra, dict):
                    if "expansion" in extra:
                        e = float(extra["expansion"])
                elif isinstance(extra, (int, float)):
                    e = float(extra)
            rows.append((op, c, s, n, e))
        stages.append(rows)
    return stages


def resolve_fbnet_arch(name: str) -> Tuple[str, Tuple[str, ...]]:
    """Resolve an ARCH name like ``FBNetV3_A_dsmask_C5`` into a stage-table
    key and default out_features (``_C5`` -> through trunk4 @ stride 32,
    ``_C4`` -> trunk3 @ stride 16 — d2go's C4/C5 trunk split)."""
    out: Tuple[str, ...] = ("trunk2", "trunk3", "trunk4")
    if name.endswith("_C5"):
        name, out = name[:-3], ("trunk4",)
    elif name.endswith("_C4"):
        name, out = name[:-3], ("trunk3",)
    if name not in FBNET_ARCH:
        raise KeyError(
            f"unknown FBNet arch '{name}'; available: {sorted(FBNET_ARCH)}"
        )
    return name, out


def _parse_op(op: str):
    """``ir_k5_se_hs`` -> (base, kernel, se, act). Base ops: conv_k{1,3,5},
    ir_k{3,5}, skip, ir_pool; modifiers: _se (squeeze-excite), _hs
    (hard-swish) — the mobile_cv builder-op vocabulary the reference's
    ARCH_DEF dicts draw from."""
    act: Any = True
    if op.endswith("_hs"):
        act, op = "hswish", op[:-3]
    se = False
    if op.endswith("_se"):
        se, op = True, op[:-3]
    if op in ("skip", "ir_pool"):
        return op, 0, se, act
    base, _, k = op.rpartition("_k")
    if base not in ("conv", "ir") or not k.isdigit():
        raise ValueError(f"unknown FBNet builder op '{op}'")
    return base, int(k), se, act




class FBNet(nn.Module):
    """A trunk from a stage table: :data:`FBNET_ARCH` ``[arch]``, or
    ``stages`` (normalized rows) where given; widths times
    ``scale_factor``, rounded to 8. Builds the stages up to the deepest of
    ``out_features`` (``trunk{i}``) only; returns those and gives each
    one's width in ``out_channels`` (JAX :377)."""

    def __init__(self, arch: str = "default",
                 out_features: Sequence[str] = ("trunk2", "trunk3", "trunk4"),
                 scale_factor: float = 1.0, dw_skip_bnrelu: bool = True,
                 stages=None):
        super().__init__()
        stages = stages if stages is not None else FBNET_ARCH[arch]
        self.out_features = tuple(out_features)
        last = max(int(f[5:]) for f in self.out_features)
        self.out_channels: Dict[str, int] = {}
        self.blocks: Dict[int, list] = {}
        c_in = 3
        for si, stage in enumerate(stages[:last + 1]):
            names = []
            for gi, (op, c, s, n, e) in enumerate(stage):
                base, kernel, se, act = _parse_op(op)
                c = _round_channels(c * scale_factor)
                for bi in range(n):
                    stride = s if bi == 0 else 1
                    if base == "conv":
                        m = ConvBNAct(c_in, c, kernel, stride, act=act)
                    elif base == "skip":
                        m = SkipOp(c_in, c, stride)
                    elif base == "ir_pool":
                        m = IRPool(c_in, c, e, act=act)
                    else:
                        m = InvertedResidual(c_in, c, stride, e, kernel, se,
                                             dw_skip_bnrelu, act)
                    name = f"s{si}_g{gi}_b{bi}"
                    self.add_module(name, m)
                    names.append(name)
                    c_in = c
            self.blocks[si] = names
            if f"trunk{si}" in self.out_features:
                self.out_channels[f"trunk{si}"] = c_in

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for si, names in self.blocks.items():
            for name in names:
                x = getattr(self, name)(x)
            if f"trunk{si}" in self.out_features:
                out[f"trunk{si}"] = x
        return out


def build_fbnet_backbone(spec) -> FBNet:
    """FBNet from a ``ZooSpec`` (``MODEL.FBNET_V2``; JAX :496): an
    ``ARCH_DEF`` (a list of dicts merged in order, whose ``trunk`` is the
    stage table and whose ``basic_args`` may set ``dw_skip_bnrelu``) takes
    ``OUT_FEATURES``; otherwise ``ARCH`` names a table, a ``_C4`` / ``_C5``
    suffix taking ``trunk3`` / ``trunk4`` whatever ``OUT_FEATURES`` says."""
    if spec.fbnet_arch_def:
        merged: dict = {}
        for d in spec.fbnet_arch_def:
            merged.update(d)
        return FBNet(
            stages=normalize_arch_def(merged["trunk"]),
            out_features=spec.fbnet_out_features,
            scale_factor=spec.fbnet_scale_factor,
            dw_skip_bnrelu=bool(merged.get("basic_args", {}).get(
                "dw_skip_bnrelu", True)))
    arch, default_out = resolve_fbnet_arch(spec.fbnet_arch)
    out = spec.fbnet_out_features or default_out
    if spec.fbnet_arch.endswith(("_C4", "_C5")):
        out = default_out
    return FBNet(arch=arch, out_features=out,
                 scale_factor=spec.fbnet_scale_factor)


class MobileViTBlock(nn.Module):
    """Local representation, a transformer across patches, fusion (JAX
    :425). The layers' LayerNorms are flax's (eps 1e-6, float32), cast to
    the stream's dtype."""

    def __init__(self, c_in: int, dim: int, depth: int = 2, patch: int = 2,
                 num_heads: int = 4):
        super().__init__()
        self.patch, self.depth = patch, depth
        self.local_conv = ConvBNAct(c_in, c_in, 3)
        self.proj_in = nn.Conv2d(c_in, dim, 1)
        for i in range(depth):
            self.add_module(f"norm1_{i}", LayerNorm(dim, eps=1e-6))
            self.add_module(f"attn_{i}", MultiheadAttention(dim, num_heads))
            self.add_module(f"norm2_{i}", LayerNorm(dim, eps=1e-6))
            self.add_module(f"mlp1_{i}", nn.Linear(dim, dim * 2))
            self.add_module(f"mlp2_{i}", nn.Linear(dim * 2, dim))
        self.proj_out = nn.Conv2d(dim, c_in, 1)
        self.fusion = ConvBNAct(2 * c_in, c_in, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj_in(self.local_conv(x))
        b, c, h, w = y.shape
        p = self.patch
        # [B, C, H, W] -> [B * p * p, (H / p) (W / p), C]: the tokens of
        # one position within the patches attend to each other
        t = y.reshape(b, c, h // p, p, w // p, p).permute(0, 3, 5, 2, 4, 1)
        t = t.reshape(b * p * p, -1, c)
        for i in range(self.depth):
            a = getattr(self, f"norm1_{i}")(t).to(t.dtype)
            t = t + getattr(self, f"attn_{i}")(a, a, a)
            m = getattr(self, f"norm2_{i}")(t).to(t.dtype)
            m = getattr(self, f"mlp2_{i}")(F.silu(getattr(self,
                                                          f"mlp1_{i}")(m)))
            t = t + m
        y = t.reshape(b, p, p, h // p, w // p, c).permute(0, 5, 3, 1, 4, 2)
        y = self.proj_out(y.reshape(b, c, h, w))
        return self.fusion(torch.cat([x, y], 1))


class MobileViT(nn.Module):
    """A stride-2 stem, then five stages of a stride-2 inverted residual
    (expansion 4), the last three with a :class:`MobileViTBlock` (JAX
    :472); returns ``stage{i}`` for ``out_features``. Needs inputs of 128
    px or more: the last block unfolds 2 x 2 patches of a 1/64 map."""

    # (channels, kind, transformer width) a stage, the JAX plan
    PLAN = ((32, "mv2", 0), (64, "mv2", 0), (96, "vit", 144),
            (128, "vit", 192), (160, "vit", 240))

    def __init__(self, out_features: Sequence[str] = ("stage2", "stage3",
                                                       "stage4")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = ConvBNAct(3, 16, 3, 2)
        c_in = 16
        self.out_channels: Dict[str, int] = {}
        for i, (c, kind, tdim) in enumerate(self.PLAN):
            self.add_module(f"down_{i}", InvertedResidual(c_in, c, 2, 4))
            if kind == "vit":
                self.add_module(f"vit_{i}", MobileViTBlock(c, tdim))
            c_in = c
            if f"stage{i}" in self.out_features:
                self.out_channels[f"stage{i}"] = c

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        out = {}
        for i, (_, kind, _) in enumerate(self.PLAN):
            x = getattr(self, f"down_{i}")(x)
            if kind == "vit":
                x = getattr(self, f"vit_{i}")(x)
            if f"stage{i}" in self.out_features:
                out[f"stage{i}"] = x
        return out


class FBNetFPN(nn.Module):
    """An FBNet trunk (``bottom_up``) with the FPN (``fpn``, a max-pooled
    extra level) over its ``in_features`` (JAX ``_FBNetFPN`` :533):
    ``trunk{i}``, at stride ``2 ** (i + 1)``, is FPN level ``p{i + 1}``."""

    def __init__(self, trunk: FBNet, in_features: Sequence[str],
                 out_channels: int = 256):
        super().__init__()
        self.in_features = tuple(in_features)
        self.bottom_up = trunk
        first = int(self.in_features[0][5:]) + 1
        self.fpn = FPN([trunk.out_channels[f] for f in self.in_features],
                       out_channels, "maxpool", first)
        n = len(self.in_features)
        self.out_channels = {f"p{first + i}": out_channels
                             for i in range(n + 1)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.bottom_up(x)
        return self.fpn([feats[f] for f in self.in_features])


def build_fbnet_fpn_backbone(cfg) -> FBNetFPN:
    """``FBNetV2FpnBackbone`` from a merged ``CfgNode`` (JAX :556): the
    trunk of ``MODEL.FBNET_V2.ARCH`` at ``SCALE_FACTOR`` on
    ``MODEL.FPN.IN_FEATURES`` (``trunk1``..``trunk4`` where they are not
    all trunk levels), ``MODEL.FPN.OUT_CHANNELS`` wide."""
    in_features = tuple(cfg.MODEL.FPN.IN_FEATURES) or (
        "trunk1", "trunk2", "trunk3", "trunk4")
    if not all(f.startswith("trunk") for f in in_features):
        in_features = ("trunk1", "trunk2", "trunk3", "trunk4")
    arch, _ = resolve_fbnet_arch(cfg.MODEL.FBNET_V2.ARCH)
    trunk = FBNet(arch=arch, out_features=in_features,
                  scale_factor=float(cfg.MODEL.FBNET_V2.SCALE_FACTOR))
    return FBNetFPN(trunk, in_features, int(cfg.MODEL.FPN.OUT_CHANNELS))


def build_mobilevit_backbone(cfg) -> MobileViT:
    """MobileViT at its defaults, whatever the config says (JAX :575)."""
    return MobileViT()


def build_cspresnet50d_backbone(cfg) -> ResNet:
    """CSPResNet50d (JAX :580): the port's ResNet-50-vd with
    ``MODEL.RESNETS.OUT_FEATURES`` and trainable BatchNorm (no FrozenBN);
    the stride in the 1x1, as the JAX ResNet's default."""
    return ResNet(ResNetSpec(depth=50, vd=True,
                             out_features=tuple(cfg.MODEL.RESNETS.OUT_FEATURES),
                             frozen_bn=False))
