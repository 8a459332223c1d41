"""BiFPN, EfficientDet's bidirectional weighted pyramid (JAX
``models/necks/bifpn.py``).

The 8-node fusion graph (``_FPN_NODES``), fast-normalized fusion weights
(ReLU, shared normalizer + 1e-4), 1x1 conv + norm + k = s maxpool or
nearest upsample to resample an edge, Swish then conv + norm (no activation
after) to refine a node, and the two extra levels off the last input: 1x1
conv + norm + maxpool, then a bare maxpool. The reference's bias quirks are
kept: a convolution has a bias only where the norm is ``''``, the depthwise
half of a separable conv never.

Module names are the reference's (``resample.{L}.conv.{conv,bn}``,
``cell.{r}.fnode.{i}.combine.resample.{off}.conv.{conv,bn}``,
``cell.{r}.fnode.{i}.combine.edge_weights``,
``cell.{r}.fnode.{i}.after_combine.conv.{conv,bn,conv_dw,conv_pw}``), so
that ``utils/weight_port.py:map_bifpn_torch_name`` applies. GroupNorm (32
groups, the default) and BatchNorm compute in float32, as the JAX norms
do, and round to the compute dtype after.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import at_least_f32

# per node (reduction, input offsets) into the running list [P3 .. P7,
# node outputs ...] (get_fpn_config(base_reduction=8), JAX :34)
_FPN_NODES = (
    (64, (3, 4)),
    (32, (2, 5)),
    (16, (1, 6)),
    (8, (0, 7)),
    (16, (1, 7, 8)),
    (32, (2, 6, 9)),
    (64, (3, 5, 10)),
    (128, (4, 11)),
)


def _norm(norm: str, channels: int):
    if norm == "GN":
        return nn.GroupNorm(32, channels, eps=1e-5)
    if norm in ("BN", "SyncBN"):
        return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    return None


def _apply_norm(norm, x: torch.Tensor) -> torch.Tensor:
    """The norm in float32 (autocast off), rounded to ``x``'s dtype."""
    if norm is None:
        return x
    with torch.autocast(x.device.type, enabled=False):
        return norm(at_least_f32(x)).to(x.dtype)


class ConvNorm(nn.Module):
    """Conv (bias iff ``norm`` is ``''``, padding k // 2) + optional norm:
    children ``conv`` and ``bn``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, norm: str):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, padding=kernel // 2,
                              bias=norm == "")
        self.bn = _norm(norm, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply_norm(self.bn, self.conv(x))


class SeparableConvNorm(nn.Module):
    """Depthwise 3x3 without bias (``conv_dw``), pointwise 1x1 (``conv_pw``,
    bias iff ``norm`` is ``''``), optional norm (``bn``)."""

    def __init__(self, c_in: int, c_out: int, norm: str):
        super().__init__()
        self.conv_dw = nn.Conv2d(c_in, c_in, 3, padding=1, groups=c_in,
                                 bias=False)
        self.conv_pw = nn.Conv2d(c_in, c_out, 1, bias=norm == "")
        self.bn = _norm(norm, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply_norm(self.bn, self.conv_pw(self.conv_dw(x)))


class Resample(nn.Module):
    """A 1x1 conv + norm where the channels differ (``conv``), then a k = s
    maxpool (ratio > 1) or nearest upsample (ratio < 1)."""

    def __init__(self, c_in: int, c_out: int, ratio: float, norm: str):
        super().__init__()
        self.conv = ConvNorm(c_in, c_out, 1, norm) if c_in != c_out else None
        self.ratio = ratio

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        if self.ratio > 1:
            k = int(self.ratio)
            return F.max_pool2d(x, k, k)
        if self.ratio < 1:
            s = int(1 // self.ratio)
            return x.repeat_interleave(s, 2).repeat_interleave(s, 3)
        return x


class Combine(nn.Module):
    """The edges into a node: each input resampled (``resample.{off}``),
    then the fast-normalized weighted sum (``edge_weights``)."""

    def __init__(self, offsets: Sequence[int], chs: Sequence[int],
                 reds: Sequence[int], target_red: int, c_out: int,
                 norm: str):
        super().__init__()
        self.offsets = tuple(offsets)
        self.resample = nn.ModuleDict({
            str(off): Resample(chs[off], c_out, target_red / reds[off], norm)
            for off in offsets})
        self.edge_weights = nn.Parameter(torch.ones(len(offsets)))

    def forward(self, x: List[torch.Tensor]) -> torch.Tensor:
        nodes = [self.resample[str(off)](x[off]) for off in self.offsets]
        w = F.relu(self.edge_weights).to(nodes[0].dtype)
        denom = w.sum() + 1e-4
        return sum(n * w[j] for j, n in enumerate(nodes)) / denom


class AfterCombine(nn.Module):
    """Swish, then conv + norm (``conv``; separable or 3x3)."""

    def __init__(self, c_out: int, norm: str, separable: bool):
        super().__init__()
        self.conv = (SeparableConvNorm(c_out, c_out, norm) if separable
                     else ConvNorm(c_out, c_out, 3, norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x * torch.sigmoid(x))


class FNode(nn.Module):
    def __init__(self, combine: Combine, after_combine: AfterCombine):
        super().__init__()
        self.combine = combine
        self.after_combine = after_combine

    def forward(self, x: List[torch.Tensor]) -> torch.Tensor:
        return self.after_combine(self.combine(x))


class BiFPNLayer(nn.Module):
    def __init__(self, fnodes: Sequence[FNode]):
        super().__init__()
        self.fnode = nn.ModuleList(fnodes)


class BiFPN(nn.Module):
    """``feat_channels``: the input levels' channels (strides 8/16/32 for
    P3-P5), extended to ``num_levels`` inside, then ``num_bifpn`` fusion
    layers. Returns ``num_levels`` maps at ``out_channels``, finest first
    (JAX :62; the JAX ``AnchorYOLO`` builds it with these defaults)."""

    def __init__(self, feat_channels: Sequence[int], out_channels: int = 160,
                 num_bifpn: int = 6, num_levels: int = 5, norm: str = "GN",
                 separable_conv: bool = False):
        super().__init__()
        self.num_levels = num_levels
        self.out_channels = out_channels
        reds = [8 * (1 << i) for i in range(len(feat_channels))]
        chs = list(feat_channels)
        self.resample = nn.ModuleDict()
        in_chs = chs[-1]
        for level in range(len(feat_channels), num_levels):
            # only the first extra level has a conv: its input is the last
            # backbone level, the next one's the first extra level
            self.resample[str(level)] = Resample(in_chs, out_channels, 2.0,
                                                 norm)
            in_chs = out_channels
            reds.append(reds[-1] * 2)
            chs.append(out_channels)
        cells = []
        for _ in range(num_bifpn):
            fnodes = []
            for target_red, offsets in _FPN_NODES:
                fnodes.append(FNode(
                    Combine(offsets, chs, reds, target_red, out_channels,
                            norm),
                    AfterCombine(out_channels, norm, separable_conv)))
                reds.append(target_red)
                chs.append(out_channels)
            reds, chs = reds[-num_levels:], chs[-num_levels:]
            cells.append(BiFPNLayer(fnodes))
        self.cell = nn.ModuleList(cells)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        x = list(feats)
        for level in range(len(feats), self.num_levels):
            x.append(self.resample[str(level)](x[-1]))
        for layer in self.cell:
            for node in layer.fnode:
                x.append(node(x))
            x = x[-self.num_levels:]
        return tuple(x)
