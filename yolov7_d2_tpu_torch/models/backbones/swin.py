"""Swin Transformer backbone, tiny / small / base (JAX
``models/backbones/swin.py``): patch embed, window attention with a
relative position bias, shifted windows, patch merging, a LayerNorm on each
output stage.

Parameter names are the reference's (``patch_embed.proj``,
``patch_embed.norm``, ``layers.{s}.blocks.{i}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{s}.downsample.{norm, reduction}``, ``norm{s}``; the buffer
``attn.relative_position_index``), so that a reference checkpoint loads by
name. ``PatchMerging`` concatenates the 2x2 neighbours in the reference's
order [(r, c), (r+1, c), (r, c+1), (r+1, c+1)]; the JAX model's reshape
gives [(r, c), (r, c+1), (r+1, c), (r+1, c+1)], and the weight carrier
(``utils/weight_port.py``) permutes the merging's norm and reduction
between the two.

As in the JAX model: the configured window is kept even where one window
covers the map; the normed map is padded to a multiple of the window
before the cyclic shift, and the shift mask (-100 across the rolled
borders) is computed on the padded size; the patch embedding pads as flax's
``SAME``. Every LayerNorm computes in float32 (eps 1e-5) and its output is
cast to the stream's dtype (the patch embedding's output dtype: bfloat16
under autocast), except the merging's, which feeds its reduction in
float32 (cast by autocast). Window attention is two batched matmuls and a
float32 softmax, the JAX expression.

Internally the maps are NHWC ``[B, H, W, C]``; the input and the outputs
(``stage{s}``) are NCHW views of that memory, i.e. channels_last.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import pad_same
from yolov7_d2_tpu_torch.models.layers.transformer import LayerNorm

SWIN_SPECS = {
    # depths, embed dim, heads
    "tiny": ((2, 2, 6, 2), 96, (3, 6, 12, 24)),
    "small": ((2, 2, 18, 2), 96, (3, 6, 12, 24)),
    "base": ((2, 2, 18, 2), 128, (4, 8, 16, 32)),
}
MASK_VALUE = -100.0


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws * ws, C], windows batch-major then
    row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: -> [B, h, w, C]."""
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws * ws, ws * ws] index into the bias table of (2 ws - 1)^2 rows."""
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws^2, ws^2] float32: 0 within a region, -100 between regions
    of the rolled (padded) map [h, w]."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, MASK_VALUE, 0.0).astype(np.float32)


# (h, w, ws, shift, device) -> the mask on that device, built once
_MASKS: Dict[tuple, torch.Tensor] = {}


def _shift_mask(h: int, w: int, ws: int, shift: int,
                device: torch.device) -> torch.Tensor:
    key = (h, w, ws, shift, str(device))
    if key not in _MASKS:
        _MASKS[key] = torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(
            device)
    return _MASKS[key]


class WindowAttention(nn.Module):
    """Multi-head self-attention inside windows with the relative position
    bias (JAX ``WindowAttention``): x [nW * B, ws^2, C], an additive mask
    [nW, ws^2, ws^2] or None."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nwb, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        qkv = self.qkv(x).reshape(nwb, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]              # [nW B, heads, n, hd]
        attn = torch.matmul(q, k.transpose(-2, -1)) * hd ** -0.5
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1).to(
            attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(-1, nw, heads, n, n)
                    + mask[None, :, None].to(attn.dtype)).reshape(
                        nwb, heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(nwb, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    """``fc1`` -> exact GELU -> ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """LayerNorm -> (shifted) window attention -> residual; LayerNorm ->
    MLP -> residual (JAX ``SwinBlock``), on [B, H, W, C]."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        y = self.norm1(x).to(x.dtype)
        pad_h, pad_w = (-h) % ws, (-w) % ws
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask(hp, wp, ws, shift, y.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp,
                           wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            y = y[:, :h, :w]
        x = x + y
        return x + self.mlp(self.norm2(x).to(x.dtype))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in the reference's order -> LayerNorm
    (float32) -> ``reduction`` to 2 C; an odd side is padded first."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = h + h % 2, w + w % 2
        # [B, h/2, dy, w/2, dx, C] -> (dx, dy) major: x0, x1, x2, x3
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5)


class SwinStage(nn.Module):
    """``blocks`` (every other one shifted by half a window) and the
    ``downsample`` into the next stage (None in the last)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      shift=0 if i % 2 == 0 else window_size // 2)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """NCHW images -> {``stage{s}``: NCHW channels_last} for the stages
    ``out_features`` (of 0-3), each through its ``norm{s}``."""

    def __init__(self, size: str = "tiny", patch_size: int = 4,
                 window_size: int = 7,
                 out_features: Sequence[int] = (1, 2, 3)):
        super().__init__()
        depths, embed, heads = SWIN_SPECS[size]
        dims = [embed * 2 ** s for s in range(len(depths))]
        self.out_features = tuple(int(s) for s in out_features)
        self.patch_embed = PatchEmbed(patch_size, embed)
        self.layers = nn.ModuleList(
            SwinStage(dims[s], depths[s], heads[s], window_size,
                      downsample=s < len(depths) - 1)
            for s in range(len(depths)))
        for s in self.out_features:
            self.add_module(f"norm{s}", LayerNorm(dims[s], eps=1e-5))
        self.out_channels = {f"stage{s}": dims[s] for s in self.out_features}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.patch_embed.patch_size
        x = self.patch_embed.proj(pad_same(x, p, p))
        x = x.permute(0, 2, 3, 1).contiguous()   # free for channels_last
        dtype = x.dtype
        x = self.patch_embed.norm(x).to(dtype)
        outputs = {}
        for s, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x)
            if s in self.out_features:
                out = getattr(self, f"norm{s}")(x).to(dtype)
                outputs[f"stage{s}"] = out.permute(0, 3, 1, 2)
            if stage.downsample is not None:
                x = stage.downsample(x).to(dtype)
        return outputs


def build_swin_transformer_backbone(cfg) -> SwinTransformer:
    """Swin from a config with ``swin_type``, ``swin_patch``,
    ``swin_window`` and ``swin_out_features`` (``MODEL.SWIN``; JAX
    ``build_swin_transformer_backbone``)."""
    return SwinTransformer(cfg.swin_type, cfg.swin_patch, cfg.swin_window,
                           cfg.swin_out_features)
