"""Transformer building blocks of the DETR family (JAX
``models/layers/transformer.py``): the 2D sine position embedding, the box
MLP, encoder and decoder layers (post-norm and pre-norm) and the DETR
encoder-decoder.

Parameter names are the original reference's (``self_attn`` /
``multihead_attn`` with ``in_proj_weight`` [3E, E], ``in_proj_bias`` and
``out_proj``; ``linear1``, ``linear2``, ``norm1``-``norm3``;
``transformer.encoder.layers.N``, ``transformer.decoder.norm``), so that a
reference checkpoint loads by name and the JAX package's name map
(``map_detr_torch_name``) applies.

Attention: :class:`MultiheadAttention` projects as flax's
``MultiHeadDotProductAttention`` does (its query, key and value kernels are
the three blocks of ``in_proj_weight``) and attends with
``F.scaled_dot_product_attention``; where dropout acts on the attention
weights (train mode, rate above 0) it computes the weights itself, since
flax draws one keep mask [Q, K] shared by the batch and the heads.

Dtypes as in the JAX layers: every LayerNorm computes in float32
(:class:`LayerNorm`, outside autocast) and the layers cast its output to
the compute dtype, so the residual stream stays in that dtype; the
decoder's shared final norm returns float32 for the float32 heads.

Dropout (:func:`dropout`) draws its masks from an explicit
``torch.Generator`` on the tensors' device and acts in train mode only.

With ``remat`` (``MODEL.DETR.REMAT``, JAX :170-205) each encoder and
decoder layer recomputes its activations in the backward
(``utils/remat.remat_call``), replaying the dropout generator so that the
recompute draws the first forward's masks, as ``nn.remat`` replays its
keys.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.utils.remat import remat_call


def sine_position_embedding(
    h: int, w: int, num_pos_feats: int = 128, temperature: float = 10000.0,
    normalize: bool = True, centered: bool = False, device=None,
) -> torch.Tensor:
    """2D sine embedding [h, w, 2 * num_pos_feats] in float32, y features
    first, sine and cosine interleaved (JAX :20). ``centered`` is d2go's
    half-pixel variant."""
    ys = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    y_embed = ys.expand(h, w)
    x_embed = xs.expand(h, w)
    if normalize:
        eps = 1e-6
        scale = 2 * math.pi
        if centered:
            y_embed = (y_embed - 0.5) / (h + eps) * scale
            x_embed = (x_embed - 0.5) / (w + eps) * scale
        else:
            y_embed = y_embed / (h + eps) * scale
            x_embed = x_embed / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        -1).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        -1).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], -1)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator],
            shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode at a rate above 0, keep each
    element with probability 1 - p and divide it by 1 - p; the keep mask
    of ``shape`` (``x.shape`` where None; a broadcast shape shares draws)
    comes from ``generator``. Otherwise ``x`` unchanged."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit "
                         "torch.Generator; none was given")
    keep = torch.rand(shape or x.shape, generator=generator,
                      device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32 whatever the input's dtype and the
    autocast state (flax ``LayerNorm(dtype=float32)``); returns float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.float())


class MLP(nn.Module):
    """The DETR FFN head: ``num_layers`` linears with ReLU between
    (``layers.N``; JAX :54)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o)
                                    for i, o in zip(dims, outs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiheadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` under the reference's names:
    q, k, v projections from ``in_proj_weight`` / ``in_proj_bias`` (the
    query, key and value blocks), per-head softmax(q k^T / sqrt(hd)) v,
    ``out_proj``. With ``dropout`` in train mode the attention weights are
    dropped with one mask [Q, K] for the whole batch and every head."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.normal_(self.in_proj_weight, 0.0, embed_dim ** -0.5)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [B, Lq, E], key and value [B, Lk, E] -> [B, Lq, E]."""
        b, lq, e = query.shape
        lk = key.shape[1]
        nh, hd = self.num_heads, e // self.num_heads
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        q = F.linear(query, w_q, b_q).view(b, lq, nh, hd).transpose(1, 2)
        k = F.linear(key, w_k, b_k).view(b, lk, nh, hd).transpose(1, 2)
        v = F.linear(value, w_v, b_v).view(b, lk, nh, hd).transpose(1, 2)
        if self.training and self.dropout > 0.0:
            attn = torch.matmul(q * hd ** -0.5, k.transpose(-2, -1))
            attn = attn.float().softmax(-1).to(q.dtype)
            attn = dropout(attn, self.dropout, True, generator,
                           (1, 1, lq, lk))
            out = torch.matmul(attn, v)
        else:
            out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, e))


class _FFN(nn.Module):
    """``linear1`` -> ReLU -> dropout -> ``linear2``, the layers' FFN."""

    def ffn(self, x: torch.Tensor, generator) -> torch.Tensor:
        y = dropout(F.relu(self.linear1(x)), self.dropout_rate,
                    self.training, generator)
        return self.linear2(y)


class EncoderLayer(_FFN):
    """Self-attention over the memory with the position added to q and k,
    then the FFN; post-norm (the default) or pre-norm (JAX :73)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 pre_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.dropout_rate = dropout
        self.pre_norm = pre_norm
        self.dtype = dtype

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(x):
            return dropout(x, self.dropout_rate, self.training, generator)

        def sa(x):
            q = x + pos
            return self.self_attn(q, q, x, generator)

        dt = self.dtype
        if self.pre_norm:
            src = src + drop(sa(self.norm1(src).to(dt)))
            return src + drop(self.ffn(self.norm2(src).to(dt), generator))
        src = self.norm1(src + drop(sa(src))).to(dt)
        return self.norm2(src + drop(self.ffn(src, generator))).to(dt)


class DecoderLayer(_FFN):
    """Self-attention over the queries, cross-attention into the memory,
    the FFN; post-norm or pre-norm (JAX :111). ``multihead_attn`` is the
    cross-attention (the flax ``cross_attn``)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 pre_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.dropout_rate = dropout
        self.pre_norm = pre_norm
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                query_pos: torch.Tensor, pos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(x):
            return dropout(x, self.dropout_rate, self.training, generator)

        def sa(x):
            q = x + query_pos
            return self.self_attn(q, q, x, generator)

        def ca(x):
            return self.multihead_attn(x + query_pos, memory + pos, memory,
                                       generator)

        dt = self.dtype
        if self.pre_norm:
            tgt = tgt + drop(sa(self.norm1(tgt).to(dt)))
            tgt = tgt + drop(ca(self.norm2(tgt).to(dt)))
            return tgt + drop(self.ffn(self.norm3(tgt).to(dt), generator))
        tgt = self.norm1(tgt + drop(sa(tgt))).to(dt)
        tgt = self.norm2(tgt + drop(ca(tgt))).to(dt)
        return self.norm3(tgt + drop(self.ffn(tgt, generator))).to(dt)


class LayerStack(nn.Module):
    """``layers`` and, where given, the stack's final ``norm``."""

    def __init__(self, layers, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class Transformer(nn.Module):
    """DETR's encoder-decoder (JAX :159). ``forward`` returns every
    decoder level through the one shared ``decoder.norm`` (float32,
    [L, B, Q, C]) and the memory. ``encoder.norm`` exists for pre-norm
    only. The decoder starts from zeros, the queries as its position.
    ``remat`` recomputes each layer in the backward."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 pre_norm: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, pre_norm, dtype)
        self.dtype = dtype
        self.remat = remat
        self.encoder = LayerStack(
            [EncoderLayer(*args) for _ in range(num_encoder_layers)],
            LayerNorm(d_model, eps=1e-5) if pre_norm else None)
        self.decoder = LayerStack(
            [DecoderLayer(*args) for _ in range(num_decoder_layers)],
            LayerNorm(d_model, eps=1e-5))

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                query_embed: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """src, pos [B, HW, C]; query_embed [Q, C]."""
        def call(layer, *args):
            if not self.remat:
                return layer(*args, generator)
            return remat_call(layer, *args, generator,
                              generators=(generator,))

        for layer in self.encoder.layers:
            src = call(layer, src, pos)
        if hasattr(self.encoder, "norm"):
            src = self.encoder.norm(src).to(self.dtype)
        b = src.shape[0]
        q = query_embed[None].expand(b, *query_embed.shape).to(self.dtype)
        tgt = torch.zeros_like(q)
        outs = []
        for layer in self.decoder.layers:
            tgt = call(layer, tgt, src, q, pos)
            outs.append(self.decoder.norm(tgt))
        return torch.stack(outs), src
