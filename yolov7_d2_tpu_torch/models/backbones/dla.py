"""DLA, deep layer aggregation, with the DLAUp / IDAUp decoders (JAX
``models/backbones/dla.py``): the backbone of ``configs/coco/
dla34_yolox.yaml`` (the bare trunk, ``build_dla_fpn3_backbone``) and of the
registry's ``build_dla_backbone`` / ``build_dlaup_backbone`` (``DLASeg``).

Module names are the reference's (``base_layer.{0,1}``, ``level{0,1}.{3c,
3c+1}``, ``level{2..5}.tree{1,2}...``, ``root.{conv,bn}``, ``project.{0,1}``;
the decoders' ``proj_{j}`` / ``node_{j}`` deformable blocks as ``offset``,
``conv`` and ``actf.0``, and ``up_{j}``), so that ``utils/weight_port.py``
``map_dla_torch_name`` (a copy of the JAX map) applies. Every BatchNorm
trains on batch statistics (momentum 0.1 = flax 0.9, eps 1e-5), as in the
JAX package.

``up_{j}`` is the reference's grouped ``ConvTranspose2d`` (kernel 2f,
stride f, padding f // 2, bilinear taps, no bias); the JAX ``BilinearUp``
is the lhs-dilated cross-correlation with the spatially flipped kernel, so
the carrier flips it between the two. The deformable blocks are DCNv2
(``ops/deform_conv.py``), their offsets zero at init.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.ops.deform_conv import ModulatedDeformConv2d

# num_layers -> (levels, channels, block); a copy of the JAX DLA_SPECS
DLA_SPECS = {
    34: ((1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), "basic"),
    60: ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneck"),
}
BN_EPS = 1e-5


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1)


def _conv_bn(c_in: int, c_out: int, kernel: int, stride: int = 1,
             act: bool = True) -> List[nn.Module]:
    mods = [nn.Conv2d(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                      bias=False), _bn(c_out)]
    return mods + [nn.ReLU()] if act else mods


class BasicBlock(nn.Module):
    """3x3 (stride) -> BN ReLU -> 3x3 -> BN, plus the residual, ReLU (JAX
    :39)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, dilation,
                               dilation=dilation, bias=False)
        self.bn1 = _bn(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, dilation,
                               dilation=dilation, bias=False)
        self.bn2 = _bn(c_out)

    def forward(self, x: torch.Tensor, residual=None) -> torch.Tensor:
        residual = x if residual is None else residual
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 at half the width (expansion 2), plus the
    residual, ReLU (JAX :72)."""

    expansion = 2

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        mid = c_out // self.expansion
        self.conv1 = nn.Conv2d(c_in, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, dilation,
                               dilation=dilation, bias=False)
        self.bn2 = _bn(mid)
        self.conv3 = nn.Conv2d(mid, c_out, 1, bias=False)
        self.bn3 = _bn(c_out)

    def forward(self, x: torch.Tensor, residual=None) -> torch.Tensor:
        residual = x if residual is None else residual
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


BLOCKS = {"basic": BasicBlock, "bottleneck": BottleneckBlock}


class Root(nn.Module):
    """Concatenated children -> 1x1 conv -> BN (+ the first child) -> ReLU
    (JAX :107)."""

    def __init__(self, c_in: int, c_out: int, residual: bool = False,
                 kernel: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, 1, (kernel - 1) // 2,
                              bias=False)
        self.bn = _bn(c_out)
        self.residual = residual

    def forward(self, *children: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(torch.cat(children, 1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """The hierarchical aggregation tree (JAX :126): at a ``level_root``
    the strided input (``bottom``) joins the aggregation; above level 1
    the left subtree's output joins too and the right subtree's root takes
    them all. ``project`` (where the width changes) runs at every level, as
    in the JAX and reference code, where an inner tree recomputes its own
    residual and the outer one's output goes unused."""

    def __init__(self, levels: int, block: str, c_in: int, c_out: int,
                 stride: int = 1, level_root: bool = False,
                 root_dim: int = 0, root_residual: bool = False,
                 dilation: int = 1):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * c_out
        if level_root:
            root_dim += c_in
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        blk = BLOCKS[block]
        if levels == 1:
            self.tree1 = blk(c_in, c_out, stride, dilation)
            self.tree2 = blk(c_out, c_out, 1, dilation)
            self.root = Root(root_dim, c_out, root_residual)
        else:
            self.tree1 = Tree(levels - 1, block, c_in, c_out, stride,
                              root_dim=0, root_residual=root_residual,
                              dilation=dilation)
            self.tree2 = Tree(levels - 1, block, c_out, c_out, 1,
                              root_dim=root_dim + c_out,
                              root_residual=root_residual, dilation=dilation)
        self.project = (nn.Sequential(*_conv_bn(c_in, c_out, 1, act=False))
                        if c_in != c_out else None)

    def forward(self, x: torch.Tensor, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        residual = self.project(bottom) if self.project is not None \
            else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """The DLA trunk (JAX :180): a 7x7 base, two conv levels, four trees
    (``level_root`` on levels 3-5); returns ``{"level{i}": feature}`` for
    ``out_features`` and gives each one's width in ``out_channels``."""

    def __init__(self, depth: int = 34,
                 out_features: Sequence[str] = ("level3", "level4",
                                                "level5"),
                 residual_root: bool = False):
        super().__init__()
        levels, channels, block = DLA_SPECS[depth]
        self.out_features = tuple(out_features)
        self.out_channels = {f"level{i}": c for i, c in enumerate(channels)
                             if f"level{i}" in self.out_features}
        self.base_layer = nn.Sequential(*_conv_bn(3, channels[0], 7))
        self.level0 = nn.Sequential(*[
            m for _ in range(levels[0])
            for m in _conv_bn(channels[0], channels[0], 3)])
        self.level1 = nn.Sequential(*[
            m for c in range(levels[1])
            for m in _conv_bn(channels[0] if c == 0 else channels[1],
                              channels[1], 3, 2 if c == 0 else 1)])
        for i in range(2, 6):
            self.add_module(f"level{i}", Tree(
                levels[i], block, channels[i - 1], channels[i], 2,
                level_root=i >= 3, root_residual=residual_root))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.base_layer(x)
        out = {}
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            if f"level{i}" in self.out_features:
                out[f"level{i}"] = x
        return out


def bilinear_kernel(k: int) -> np.ndarray:
    """``fill_up_weights``' separable bilinear taps [k, k] (JAX
    ``_bilinear_kernel``, :214)."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w


class BilinearUp(nn.ConvTranspose2d):
    """The learnable depthwise upsample by ``factor`` (JAX :225): a
    grouped transposed convolution, kernel 2f, stride f, padding f // 2,
    no bias, bilinear-initialised (``init_fixed_``)."""

    def __init__(self, channels: int, factor: int):
        super().__init__(channels, channels, 2 * factor, factor, factor // 2,
                         groups=channels, bias=False)
        self.init_fixed_()

    @torch.no_grad()
    def init_fixed_(self) -> None:
        k = self.kernel_size[0]
        self.weight.copy_(torch.from_numpy(bilinear_kernel(k)).expand(
            self.weight.shape[0], 1, k, k))


class DeformConvBlock(nn.Module):
    """DCNv2 3x3 -> BN -> ReLU (JAX :264, the reference's ``_DeformConv``):
    ``offset`` predicts the offsets and modulation, zero-initialised;
    ``conv`` is the fuse; ``actf`` the BN and ReLU."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.actf = nn.Sequential(_bn(c_out), nn.ReLU())
        self.offset = nn.Conv2d(c_in, 27, 3, 1, 1)
        self.conv = ModulatedDeformConv2d(c_in, c_out, 3)
        self.init_fixed_()

    @torch.no_grad()
    def init_fixed_(self) -> None:
        self.offset.weight.zero_()
        self.offset.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            raw = self.offset(x.float())
        return self.actf(self.conv(x, raw))


class IDAUp(nn.Module):
    """Iterative deep aggregation (JAX :280): each level above ``startp``
    is projected to ``c_out`` (deformable), upsampled by its factor and
    fused with the level before it (deformable). ``channels`` are the input
    levels' widths, ``up_factors`` their factors (index 0 unused)."""

    def __init__(self, c_out: int, channels: Sequence[int],
                 up_factors: Sequence[int]):
        super().__init__()
        for j in range(1, len(channels)):
            self.add_module(f"proj_{j}", DeformConvBlock(channels[j], c_out))
            self.add_module(f"up_{j}", BilinearUp(c_out, int(up_factors[j])))
            self.add_module(f"node_{j}", DeformConvBlock(c_out, c_out))

    def forward(self, layers: List[torch.Tensor], startp: int,
                endp: int) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            y = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(
                layers[i]))
            layers[i] = getattr(self, f"node_{j}")(y + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """The pyramid decoder (JAX :305): IDAUp the deepest unmerged levels
    into each shallower scale in turn; returns one output a level,
    shallowest first."""

    def __init__(self, startp: int, channels: Sequence[int],
                 scales: Sequence[int]):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = np.array(scales, dtype=int)
        for i in range(len(channels) - 1):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                (scales[j:] // scales[j]).tolist()))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(len(layers) - self.startp - 1):
            layers = getattr(self, f"ida_{i}")(layers, len(layers) - i - 2,
                                               len(layers))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA + DLAUp + the final IDAUp (JAX :331). ``ms_output`` gives the
    DLAUp pyramid (``dla2``..``dla5``); otherwise the stride-4 outputs
    ``dla0``..``dla2`` of the final IDAUp; without ``use_dla_up`` and with
    ``ms_output`` the raw trunk levels ``dla0``..``dla5``."""

    def __init__(self, num_layers: int = 34,
                 out_features: Sequence[str] = ("dla2",),
                 use_dla_up: bool = True, ms_output: bool = False):
        super().__init__()
        _, channels, _ = DLA_SPECS[num_layers]
        self.first_level = 2
        self.last_level = 6 if ms_output else 5
        self.use_dla_up = use_dla_up
        self.ms_output = ms_output
        self.out_features = tuple(out_features)
        self.base = DLA(num_layers,
                        out_features=tuple(f"level{i}" for i in range(6)))
        pyramid = list(channels[self.first_level:])
        scales = [2 ** i for i in range(len(pyramid))]
        if use_dla_up:
            self.dla_up = DLAUp(0, pyramid, scales)
        n = self.last_level - self.first_level
        if not ms_output:
            # the DLAUp outputs keep their widths: level j's IDAUp makes
            # channels[first_level + j], the deepest stays as it is
            self.ida_up = IDAUp(channels[self.first_level], pyramid[:n],
                                [2 ** i for i in range(n)])
            widths = {f"dla{i}": channels[self.first_level]
                      for i in range(n)}
        elif use_dla_up:
            widths = {f"dla{i + self.first_level}": pyramid[i]
                      for i in range(n)}
        else:
            widths = {f"dla{i}": channels[i] for i in range(self.last_level)}
        self.out_channels = {k: v for k, v in widths.items()
                             if k in self.out_features}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        base = self.base(x)
        layers = [base[f"level{i}"] for i in range(6)]
        pyramid = layers[self.first_level:]
        if self.use_dla_up:
            pyramid = self.dla_up(pyramid)
        n = self.last_level - self.first_level
        if not self.ms_output:
            y = self.ida_up(list(pyramid[:n]), 0, n)
            feats = {f"dla{i}": y[i] for i in range(n)}
        elif self.use_dla_up:
            feats = {f"dla{i + self.first_level}": pyramid[i]
                     for i in range(n)}
        else:
            feats = {f"dla{i}": layers[i] for i in range(self.last_level)}
        return {k: v for k, v in feats.items() if k in self.out_features}


def build_dla_backbone(spec) -> DLASeg:
    """``DLASeg`` from ``MODEL.DLA`` (JAX :375; ``spec`` a ``ZooSpec``).
    A norm other than BN / SyncBN raises, as in the JAX builder."""
    if spec.dla_norm not in ("BN", "SyncBN"):
        raise NotImplementedError(
            f"MODEL.DLA.NORM={spec.dla_norm!r} is not supported (BN/SyncBN "
            "only)")
    return DLASeg(spec.dla_num_layers, spec.dla_out_features,
                  spec.dla_use_dla_up, spec.dla_ms_output)


def build_dla_fpn3_backbone(spec) -> DLA:
    """The DLA-34 trunk with ``level3``..``level5`` out (JAX :395)."""
    return DLA(34, ("level3", "level4", "level5"))


def build_dlaup_backbone(spec) -> DLASeg:
    """DLA-34 with the DLAUp pyramid ``dla2``..``dla5`` out (JAX :403)."""
    return DLASeg(34, ("dla2", "dla3", "dla4", "dla5"), use_dla_up=True,
                  ms_output=True)
