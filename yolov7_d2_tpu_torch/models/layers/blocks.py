"""Convolutional vocabulary of the YOLO family, in PyTorch.

Counterpart of ``yolov7_d2_tpu/models/layers/blocks.py``. Module and
parameter names follow the original PyTorch reference, so that
``yolov7_d2_tpu/utils/weight_port.py:map_yolox_torch_name`` maps every key of
a ``state_dict()`` here onto the flax path of the JAX twin.

BatchNorm: eps ``BN_EPS`` = 1e-3; flax momentum 0.97 is torch momentum
1 - 0.97 = 0.03 (``yolov7_d2_tpu/models/layers/norm.py`` keeps torch's
running-variance rule, so the two agree in train mode too).

Focus is the plain space-to-depth form. The JAX package folds it into a
2k x 2k stride-2 convolution (``_FoldedFocusConv``), a TPU layout trick over
the same 12-channel kernel, so both read the same parameter.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.03  # = 1 - flax 0.97
BN_EPS = 1e-3


def get_activation(name: str = "silu") -> nn.Module:
    """Activation lookup (JAX ``blocks.py:28``)."""
    if name in ("silu", "swish"):
        return nn.SiLU()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(0.1)
    if name == "gelu":
        return nn.GELU(approximate="tanh")  # flax nn.gelu is the tanh form
    if name == "mish":
        return nn.Mish()
    if name in ("identity", "none", ""):
        return nn.Identity()
    raise ValueError(f"Unsupported activation: {name}")


class BaseConv(nn.Module):
    """Conv2d without bias -> BatchNorm -> activation (JAX ``BaseConv``)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 stride: int = 1, groups: int = 1, act: str = "silu",
                 bn_eps: float = BN_EPS):
        super().__init__()
        pad = (ksize - 1) // 2
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride, pad,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=bn_eps,
                                 momentum=BN_MOMENTUM)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DWConv(nn.Module):
    """Depthwise k x k + pointwise 1x1 (JAX ``DWConv``)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              groups=in_channels, act=act)
        self.pconv = BaseConv(in_channels, out_channels, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


def conv_class(depthwise: bool):
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3, residual when shapes allow (JAX ``Bottleneck``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv2 = conv_class(depthwise)(hidden, out_channels, 3, 1, act=act)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class SPPBottleneck(nn.Module):
    """1x1 -> parallel stride-1 maxpools -> concat -> 1x1 (JAX
    ``SPPBottleneck``; the JAX cascade of 5-pools gives identical values).
    Torch pads the pools with -inf, as flax does."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu",
                 bn_eps: float = BN_EPS):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act,
                              bn_eps=bn_eps)
        self.m = nn.ModuleList(
            nn.MaxPool2d(k, stride=1, padding=k // 2) for k in kernel_sizes
        )
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_channels,
                              1, 1, act=act, bn_eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], dim=1))


class CSPLayer(nn.Module):
    """Cross-stage partial block (JAX ``CSPLayer``): concat order [x1, x2]."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv2 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, 1, act=act)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act)
            for _ in range(n)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], dim=1))


def pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad NCHW ``x`` as flax's ``SAME`` convolution does for a square
    ``kernel`` at ``stride``: the output side is ceil(side / stride), the
    padding split low = total // 2, high = the rest. Unpadded where none
    is needed (a side a multiple of a kernel equal to the stride)."""
    pads = []
    for side in (x.shape[-1], x.shape[-2]):
        total = max((-(-side // stride) - 1) * stride + kernel - side, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2], channel groups in the order
    (tl, bl, tr, br) = (0,0), (1,0), (0,1), (1,1) (JAX ``blocks.py:329``)."""
    return torch.cat(
        [x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
         x[..., 1::2, 1::2]],
        dim=1,
    )


class Focus(nn.Module):
    """Space-to-depth 2x2, then ``BaseConv`` (JAX ``Focus``, fold=False)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = BaseConv(in_channels * 4, out_channels, ksize, stride,
                             act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(space_to_depth(x))
