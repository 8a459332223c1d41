"""PVTv2 backbone, b0-b3 (JAX ``models/backbones/pvt_v2.py``): overlapping
patch embeddings, spatial-reduction attention (keys and values from a
strided convolution of the map), a convolutional FFN (a depthwise 3x3
inside the MLP).

Parameter names are the reference's (``patch_embed{1..4}.{proj, norm}``,
``block{1..4}.{i}.{norm1, attn.q, attn.kv, attn.sr, attn.norm, attn.proj,
norm2, mlp.fc1, mlp.dwconv.dwconv, mlp.fc2}``, ``norm{1..4}``), the keys
that ``map_pvt_v2_torch_name`` reads. Stages are 1-based in the names and
0-based in the outputs (``stage{s}``, s of ``out_features``), as in JAX.

As in the JAX model: every LayerNorm is flax's default eps 1e-6 and
computes in float32, its output cast to the stream's dtype (the stage's
patch embedding output dtype: bfloat16 under autocast); the reduction
convolution pads as flax's ``SAME``, the patch embeddings by k // 2. The
attention is ``F.scaled_dot_product_attention`` (no bias, no mask, one
launch on the card where the JAX expression takes two matmuls and a
softmax).

Tokens are [B, H W, C] row-major; the input and the outputs are NCHW,
the outputs channels_last.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import pad_same
from yolov7_d2_tpu_torch.models.layers.transformer import LayerNorm

PVT2_SPECS = {
    # depths, dims, heads, sr ratios, mlp ratios
    "b0": ((2, 2, 2, 2), (32, 64, 160, 256), (1, 2, 5, 8), (8, 4, 2, 1),
           (8, 8, 4, 4)),
    "b1": ((2, 2, 2, 2), (64, 128, 320, 512), (1, 2, 5, 8), (8, 4, 2, 1),
           (8, 8, 4, 4)),
    "b2": ((3, 4, 6, 3), (64, 128, 320, 512), (1, 2, 5, 8), (8, 4, 2, 1),
           (8, 8, 4, 4)),
    "b3": ((3, 4, 18, 3), (64, 128, 320, 512), (1, 2, 5, 8), (8, 4, 2, 1),
           (8, 8, 4, 4)),
}
LN_EPS = 1e-6  # flax's default


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride, patch // 2)
        self.norm = LayerNorm(dim, eps=LN_EPS)


class SRAttention(nn.Module):
    """Queries from every token, keys and values from the map reduced by an
    ``sr_ratio`` x ``sr_ratio`` strided convolution and a LayerNorm (JAX
    ``SRAttention``)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        q = self.q(x).reshape(b, n, heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            r = self.sr_ratio
            m = self.sr(pad_same(x.reshape(b, h, w, c).permute(0, 3, 1, 2),
                                 r, r))
            kv_in = self.norm(m.permute(0, 2, 3, 1).reshape(b, -1, c)).to(
                x.dtype)
        kv = self.kv(kv_in).reshape(b, -1, 2, heads, hd).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, kv[0], kv[1])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class ConvFFN(nn.Module):
    """``fc1`` -> depthwise 3x3 over the map -> exact GELU -> ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, _ = x.shape
        x = self.fc1(x)
        y = self.dwconv.dwconv(x.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        return self.fc2(F.gelu(y.permute(0, 2, 3, 1).reshape(b, n, -1)))


class PVT2Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = ConvFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x).to(x.dtype), h, w)
        return x + self.mlp(self.norm2(x).to(x.dtype), h, w)


class PVTv2(nn.Module):
    """NCHW images -> {``stage{s}``: NCHW channels_last} for the stages
    ``out_features`` (of 0-3)."""

    def __init__(self, variant: str = "b1",
                 out_features: Sequence[int] = (1, 2, 3)):
        super().__init__()
        depths, dims, heads, srs, mlps = PVT2_SPECS[variant]
        self.out_features = tuple(int(s) for s in out_features)
        for s in range(4):
            patch, stride = (7, 4) if s == 0 else (3, 2)
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                3 if s == 0 else dims[s - 1], dims[s], patch, stride))
            self.add_module(f"block{s + 1}", nn.ModuleList(
                PVT2Block(dims[s], heads[s], srs[s], mlps[s])
                for _ in range(depths[s])))
            self.add_module(f"norm{s + 1}", LayerNorm(dims[s], eps=LN_EPS))
        self.out_channels = {f"stage{s}": dims[s] for s in self.out_features}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        for s in range(4):
            embed = getattr(self, f"patch_embed{s + 1}")
            x = embed.proj(x)
            b, c, h, w = x.shape
            dtype = x.dtype
            t = embed.norm(x.permute(0, 2, 3, 1).reshape(b, h * w, c)).to(
                dtype)
            for block in getattr(self, f"block{s + 1}"):
                t = block(t, h, w)
            t = getattr(self, f"norm{s + 1}")(t).to(dtype)
            x = t.reshape(b, h, w, c).permute(0, 3, 1, 2)
            if s in self.out_features:
                outputs[f"stage{s}"] = x
        return outputs


def build_pvt_v2_backbone(cfg) -> PVTv2:
    """PVTv2 from a config with ``pvt_type`` and ``pvt_out_features``
    (``MODEL.PVT``; JAX ``build_pvt_v2_backbone``)."""
    return PVTv2(cfg.pvt_type, cfg.pvt_out_features)
