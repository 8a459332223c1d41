"""ConvNeXt-T/S/B/L (JAX ``models/backbones/convnext.py``): the backbone of
``configs/coco/yolox_convnext.yaml`` and ``coco/yolox/yolox_convnext.yaml``.

A 4x4 stride-4 stem with its LayerNorm, 2x2 stride-2 downsamples each
after a LayerNorm, stages of blocks (depthwise 7x7, LayerNorm over the
channels, Linear to 4x, exact GELU, Linear back, the layer scale
``gamma``, drop path, the residual), and a LayerNorm on every output.
Every LayerNorm computes in float32 (eps 1e-6, flax's default) and its
output is cast to the stream's dtype (the stem convolution's: bfloat16
under autocast), except the blocks', which feed their Linear in float32
(cast by autocast). The layer-scaled branch is float32 (``gamma`` is) and
cast back to the stream's dtype before the residual, as in the JAX block.

Module names are the reference's (``downsample_layers.{s}.{0,1}``,
``stages.{s}.{i}.{dwconv,norm,pwconv1,pwconv2,gamma}``, ``norm{s}``), so
that ``utils/weight_port.py`` ``map_convnext_torch_name`` (a copy of the
JAX map) applies.

Drop path (stochastic depth) acts in train mode at a rate that grows
linearly from 0 at the first block to ``drop_path_rate`` at the last: a
block's branch is kept for a whole sample with probability 1 - rate, and
divided by it. Its Bernoulli masks come from ``generator`` (a
``torch.Generator`` on the model's device, which the training step
reseeds from the seed and the step), as the JAX step feeds its
``droppath`` key.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.layers.transformer import LayerNorm

# (depths, dims) a size; a copy of the JAX CONVNEXT_SPECS
CONVNEXT_SPECS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}
LN_EPS = 1e-6  # flax LayerNorm's default


class LayerNorm2d(LayerNorm):
    """The float32 LayerNorm over the channels of an NCHW map (returns
    float32, NCHW)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Block(nn.Module):
    """dwconv 7x7 -> LayerNorm -> pwconv1 (4x) -> GELU -> pwconv2 ->
    ``gamma`` -> drop path -> residual (JAX :28)."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.drop_path = drop_path
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))     # NHWC, f32
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        y = y * self.gamma
        if self.training and self.drop_path > 0.0:
            keep = 1.0 - self.drop_path
            if self.generator is None:
                raise ValueError("drop path in train mode draws from an "
                                 "explicit torch.Generator; none was given")
            mask = torch.rand((y.shape[0], 1, 1, 1), generator=self.generator,
                              device=y.device) < keep
            y = y * mask / keep
        return x + y.permute(0, 3, 1, 2).to(x.dtype)


class ConvNeXt(nn.Module):
    """The stem, the downsamples, the stages of ``size`` and the output
    norms of ``out_features`` (stage indices); returns ``{"stage{s}":
    feature}`` and gives each one's width in ``out_channels`` (JAX :64).
    ``generator`` (the drop path's) is shared by every block."""

    def __init__(self, size: str = "tiny",
                 out_features: Sequence[int] = (1, 2, 3),
                 drop_path_rate: float = 0.0):
        super().__init__()
        depths, dims = CONVNEXT_SPECS[size]
        self.out_features = tuple(sorted(int(s) for s in out_features))
        self.out_channels = {f"stage{s}": dims[s] for s in self.out_features}
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(3, dims[0], 4, 4), LayerNorm2d(dims[0], eps=LN_EPS))])
        for s in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm2d(dims[s - 1], eps=LN_EPS),
                nn.Conv2d(dims[s - 1], dims[s], 2, 2)))
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.stages = nn.ModuleList()
        start = 0
        for n, d in zip(depths, dims):
            self.stages.append(nn.Sequential(*(
                Block(d, rates[start + i]) for i in range(n))))
            start += n
        for s in self.out_features:
            self.add_module(f"norm{s}", LayerNorm2d(dims[s], eps=LN_EPS))

    @property
    def generator(self) -> Optional[torch.Generator]:
        return self.stages[0][0].generator

    @generator.setter
    def generator(self, gen: Optional[torch.Generator]) -> None:
        for stage in self.stages:
            for block in stage:
                block.generator = gen

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        stem, stem_norm = self.downsample_layers[0]
        x = stem(x)
        dtype = x.dtype
        x = stem_norm(x).to(dtype)
        out = {}
        for s, stage in enumerate(self.stages):
            if s > 0:
                norm, conv = self.downsample_layers[s]
                x = conv(norm(x).to(dtype))
            x = stage(x)
            if s in self.out_features:
                out[f"stage{s}"] = getattr(self, f"norm{s}")(x).to(dtype)
        return out


def build_convnext_backbone(spec) -> ConvNeXt:
    """ConvNeXt from a ``ZooSpec`` (``MODEL.CONVNEXT``: ``TYPE``,
    ``OUT_FEATURES``, ``DROP_PATH_RATE``; JAX :101)."""
    return ConvNeXt(spec.convnext_type, spec.convnext_out_features,
                    spec.convnext_drop_path_rate)
