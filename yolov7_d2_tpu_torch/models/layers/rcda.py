"""Row-Column Decoupled Attention of AnchorDETR (JAX
``models/layers/rcda.py``).

The 2D key map is pooled to row keys (mean over H, attended along W) and
column keys (mean over W, attended along H); the output is the factored
contraction

    out[q] = sum_h A_col[q, h] * sum_w A_row[q, w] * V[h, w]

as the JAX module computes it: W first, then H. The two softmaxes run in
float32 and are cast back to the compute dtype (JAX :66-71); the
intermediate is [B, heads, Q, H, head_dim].
"""

from __future__ import annotations

import math

import torch
from torch import nn


class RCDAttention(nn.Module):
    """query (plus row / column position) -> factored attention over a 2D
    memory. The projections ``q_row``, ``q_col``, ``k_row``, ``k_col``,
    ``v`` and ``out_proj`` are plain linears (flax ``Dense``)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        for name in ("q_row", "q_col", "k_row", "k_col", "v", "out_proj"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim))

    def forward(self, query_row: torch.Tensor, query_col: torch.Tensor,
                key_row: torch.Tensor, key_col: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        """query_row / query_col [B, Q, C]; key_row, key_col, value
        [B, H, W, C] -> [B, Q, C]."""
        nh = self.num_heads
        hd = self.embed_dim // nh
        b, q, _ = query_row.shape
        _, h, w, _ = value.shape
        qr = (self.q_row(query_row) * hd ** -0.5).view(b, q, nh, hd)
        qc = (self.q_col(query_col) * hd ** -0.5).view(b, q, nh, hd)
        kr = self.k_row(key_row).mean(1).view(b, w, nh, hd)  # pool over H
        kc = self.k_col(key_col).mean(2).view(b, h, nh, hd)  # pool over W
        v = self.v(value).view(b, h, w, nh, hd)
        dt = qr.dtype
        a_row = torch.einsum("bqnd,bwnd->bnqw", qr, kr).float().softmax(
            -1).to(dt)
        a_col = torch.einsum("bqnd,bhnd->bnqh", qc, kc).float().softmax(
            -1).to(dt)
        tmp = torch.einsum("bnqw,bhwnd->bnqhd", a_row, v)
        out = torch.einsum("bnqh,bnqhd->bqnd", a_col, tmp)
        return self.out_proj(out.reshape(b, q, self.embed_dim))


def pos2posemb2d(points: torch.Tensor, num_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """Points [..., 2] (x, y in [0, 1]) -> sine embedding [..., 2 *
    num_feats], y features first (JAX :80)."""
    pts = points * (2 * math.pi)
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=points.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    pos_x = pts[..., 0:1] / dim_t
    pos_y = pts[..., 1:2] / dim_t
    lead = points.shape[:-1]
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        -1).reshape(*lead, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        -1).reshape(*lead, -1)
    return torch.cat([pos_y, pos_x], -1)
