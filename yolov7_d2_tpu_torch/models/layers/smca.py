"""SMCA-DETR's spatially modulated co-attention (JAX ``SMCADecoderLayer``,
``models/meta_arch/detr_variants.py:262-324``): a DETR decoder layer whose
cross-attention adds a Gaussian prior around each query's predicted
centre to its logits.

The prior of head n of query q at the memory position p (cell centres
``gx``, ``gy`` in [0, 1]) is ``-((gx - cx)^2 / sx + (gy - cy)^2 / sy)``
with ``sx = exp(.) + 1e-4``, ``sy`` likewise, computed in float32 and cast
to the logits' dtype before it is added (:301-309); only the softmax runs
in float32. The JAX model predicts the centres and scales from the query
embeddings alone, so every layer gets the same prior: :func:`smca_prior`
computes it once a forward and each layer adds it.

The cross-attention is written out as the JAX layer writes it: the
projections ``ca_q``, ``ca_k``, ``ca_v`` and ``ca_out`` (plain linears),
per-head logits ``q k^T / sqrt(hd)`` in the compute dtype, the prior, the
softmax, the product with ``v``. The self-attention is DETR's
(``MultiheadAttention``); no dropout anywhere, as in the JAX layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.layers.transformer import (
    LayerNorm,
    MultiheadAttention,
)


def smca_prior(centers_scales: torch.Tensor, h: int, w: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``centers_scales`` [B, Q, heads, 4] float32 (cx, cy in [0, 1], raw
    log-scales) -> the prior [B, heads, Q, h * w] in ``dtype``, positions
    in row-major order of the h x w memory."""
    dev = centers_scales.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = (g.reshape(-1) for g in torch.meshgrid(ys, xs, indexing="ij"))
    cs = centers_scales.float()
    cx, cy = cs[..., 0:1], cs[..., 1:2]                  # [B, Q, n, 1]
    sx = torch.exp(cs[..., 2:3]) + 1e-4
    sy = torch.exp(cs[..., 3:4]) + 1e-4
    gauss = -((gx - cx) ** 2 / sx + (gy - cy) ** 2 / sy)  # [B, Q, n, HW]
    return gauss.transpose(1, 2).to(dtype)


class SMCADecoderLayer(nn.Module):
    """Self-attention over the queries, the Gaussian-modulated
    cross-attention into the memory, the FFN; post-norm (JAX :262)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nhead = nhead
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.ca_q = nn.Linear(d_model, d_model)
        self.ca_k = nn.Linear(d_model, d_model)
        self.ca_v = nn.Linear(d_model, d_model)
        self.ca_out = nn.Linear(d_model, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                query_pos: torch.Tensor, pos: torch.Tensor,
                prior: torch.Tensor) -> torch.Tensor:
        """tgt, query_pos [B, Q, C]; memory, pos [B, HW, C]; prior [B,
        heads, Q, HW] (:func:`smca_prior`)."""
        dt = self.dtype
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt)).to(dt)
        b, nq, c = tgt.shape
        hw = memory.shape[1]
        nh, hd = self.nhead, c // self.nhead
        qh = self.ca_q(tgt + query_pos).view(b, nq, nh, hd)
        kh = self.ca_k(memory + pos).view(b, hw, nh, hd)
        vh = self.ca_v(memory).view(b, hw, nh, hd)
        logits = torch.einsum("bqnd,bpnd->bnqp", qh, kh) * hd ** -0.5
        logits = logits + prior.to(logits.dtype)
        attn = logits.float().softmax(-1).to(vh.dtype)
        y = torch.einsum("bnqp,bpnd->bqnd", attn, vh).reshape(b, nq, c)
        tgt = self.norm2(tgt + self.ca_out(y)).to(dt)
        y = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + y).to(dt)
