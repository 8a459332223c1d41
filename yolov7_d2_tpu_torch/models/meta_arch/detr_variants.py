"""AnchorDETR (the AnchorDETR part of JAX ``models/meta_arch/
detr_variants.py``): anchor points times patterns as queries, the RCDA
encoder (or DETR's dense encoder) and the RCDA decoder, one class head and
one box head shared by every level, the boxes' xy refined around each
query's anchor. It trains with the sigmoid-focal criterion of
``meta_arch/detr.py``; the tail ranks all (query, class) pairs.

Module names follow the flax ones under ``transformer.encoder.layers.N``
and ``transformer.decoder.layers.N`` (``utils/weight_port.py``
``map_anchor_detr_torch_name``); the anchor points and patterns are the
raw parameters ``anchor_points`` and ``pattern_embed``. The RCDA layers
have no dropout, as in the JAX package.

SMCA-DETR, DAB-DETR and the d2go DETR are not ported (ROADMAP.md Queue
A.7c′).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.detr import DetrConfig
from yolov7_d2_tpu_torch.models.backbones.resnet import RESNET_CHANNELS
from yolov7_d2_tpu_torch.models.build import META_ARCH_REGISTRY
from yolov7_d2_tpu_torch.models.layers.rcda import RCDAttention, pos2posemb2d
from yolov7_d2_tpu_torch.models.layers.transformer import (
    MLP,
    EncoderLayer,
    LayerNorm,
    LayerStack,
    MultiheadAttention,
    sine_position_embedding,
)
from yolov7_d2_tpu_torch.models.meta_arch.detr import (
    boxes_to_pixels,
    check_detr_config,
    detr_backbone,
    finish_build,
    float32_region,
    normalized_input,
    stable_top_k,
)
from yolov7_d2_tpu_torch.structures.instances import Detections


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


class RCDADecoderLayer(nn.Module):
    """Self-attention over the queries, RCDA cross-attention into the 2D
    memory (row and column keys with the x and y axis embeddings), the
    FFN; post-norm (JAX :58)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn = RCDAttention(d_model, nhead)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, memory_2d: torch.Tensor,
                query_pos: torch.Tensor, pos_row: torch.Tensor,
                pos_col: torch.Tensor) -> torch.Tensor:
        """tgt [B, Q, C]; memory_2d [B, H, W, C]; pos_row [W, C], pos_col
        [H, C]."""
        dt = self.dtype
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt)).to(dt)
        key_row = memory_2d + pos_row[None, None]
        key_col = memory_2d + pos_col[None, :, None]
        q = tgt + query_pos
        y = self.cross_attn(q, q, key_row, key_col, memory_2d)
        tgt = self.norm2(tgt + y).to(dt)
        y = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + y).to(dt)


class RCDAEncoderLayer(nn.Module):
    """RCDA self-attention over the 2D memory, every pixel a query with the
    row (x) and column (y) axis embeddings added, then the FFN; post-norm
    (JAX :99)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = RCDAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.dtype = dtype

    def forward(self, src2d: torch.Tensor, pos_row: torch.Tensor,
                pos_col: torch.Tensor) -> torch.Tensor:
        """src2d [B, H, W, C]; pos_row [W, C]; pos_col [H, C]."""
        b, h, w, c = src2d.shape
        dt = self.dtype
        with_row = src2d + pos_row[None, None]
        with_col = src2d + pos_col[None, :, None]
        y = self.self_attn(with_row.reshape(b, h * w, c),
                           with_col.reshape(b, h * w, c),
                           with_row, with_col, src2d).reshape(b, h, w, c)
        src2d = self.norm1(src2d + y).to(dt)
        y = self.linear2(F.relu(self.linear1(src2d)))
        return self.norm2(src2d + y).to(dt)


class AnchorDETR(nn.Module):
    """normalize -> ResNet res5 -> ``input_proj`` -> encoder (RCDA, or the
    dense ``EncoderLayer`` for ``attention_type`` "nn.MultiheadAttention")
    -> RCDA decoder over ``num_query_position`` anchor points times
    ``num_query_pattern`` patterns -> the shared heads on every level (JAX
    :140). The anchor points are ``sigmoid(anchor_points)`` ("learned") or
    the centres of a square grid ("grid", for a square number of
    positions). Returns the keys of :class:`DETR`'s output, logits over
    ``num_classes`` (no "no object")."""

    def __init__(self, num_classes: int = 80, hidden_dim: int = 256,
                 num_query_position: int = 300, num_query_pattern: int = 3,
                 nheads: int = 8, enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 1024, resnet_depth: int = 50,
                 spatial_prior: str = "learned",
                 attention_type: str = "RCDA",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if spatial_prior not in ("learned", "grid"):
            raise ValueError(f"spatial_prior {spatial_prior!r}: learned or "
                             "grid")
        self.dtype = dtype
        self.num_query_position = num_query_position
        self.num_query_pattern = num_query_pattern
        self.spatial_prior = spatial_prior
        self.attention_type = attention_type
        self.backbone = detr_backbone(resnet_depth)
        self.input_proj = nn.Conv2d(RESNET_CHANNELS["res5"], hidden_dim, 1)
        if attention_type == "RCDA":
            enc = [RCDAEncoderLayer(hidden_dim, nheads, dim_feedforward,
                                    dtype) for _ in range(enc_layers)]
        else:
            enc = [EncoderLayer(hidden_dim, nheads, dim_feedforward, 0.0,
                                False, dtype) for _ in range(enc_layers)]
        self.transformer = nn.Module()
        self.transformer.encoder = LayerStack(enc)
        self.transformer.decoder = LayerStack(
            [RCDADecoderLayer(hidden_dim, nheads, dim_feedforward, dtype)
             for _ in range(dec_layers)])
        if spatial_prior == "learned":
            self.anchor_points = nn.Parameter(
                torch.empty(num_query_position, 2))
        self.pattern_embed = nn.Parameter(
            torch.empty(num_query_pattern, hidden_dim))
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    def anchor_xy(self, device) -> torch.Tensor:
        """The anchor points [P, 2] (x, y) in [0, 1], float32."""
        p = self.num_query_position
        if self.spatial_prior == "learned":
            return torch.sigmoid(self.anchor_points.float())
        g = int(p ** 0.5)
        c = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
        ys, xs = torch.meshgrid(c, c, indexing="ij")
        return torch.stack([xs, ys], -1).reshape(-1, 2)[:p]

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        x = normalized_input(images, self.dtype)
        dt = self.dtype
        with torch.autocast(x.device.type, dtype=dt,
                            enabled=dt == torch.bfloat16):
            src = self.input_proj(self.backbone(x)["res5"])
            b, c, h, w = src.shape
            dev = src.device
            # 1D axis embeddings shared by the encoder and the decoder
            pos_row = sine_position_embedding(1, w, c // 2,
                                              device=dev)[0].to(dt)
            pos_col = sine_position_embedding(h, 1, c // 2,
                                              device=dev)[:, 0].to(dt)
            memory = src.permute(0, 2, 3, 1)                 # [B, H, W, C]
            if self.attention_type == "RCDA":
                for layer in self.transformer.encoder.layers:
                    memory = layer(memory, pos_row, pos_col)
            else:
                pos = sine_position_embedding(h, w, c // 2, device=dev)
                pos = pos.to(dt).reshape(1, h * w, c).expand(b, -1, -1)
                mem = memory.reshape(b, h * w, c)
                for layer in self.transformer.encoder.layers:
                    mem = layer(mem, pos)
                memory = mem.reshape(b, h, w, c)

            points = self.anchor_xy(dev)                     # [P, 2]
            npat = self.num_query_pattern
            nq = self.num_query_position * npat
            query_pos = pos2posemb2d(points, c // 2).repeat(npat, 1)
            query_pos = query_pos[None].expand(b, nq, c).to(dt)
            tgt = self.pattern_embed.repeat_interleave(
                self.num_query_position, 0)[None].expand(b, nq, c).to(dt)
            ref = inverse_sigmoid(points.repeat(npat, 1))[None]  # [1, Q, 2]
            logits, boxes = [], []
            for layer in self.transformer.decoder.layers:
                tgt = layer(tgt, memory, query_pos, pos_row, pos_col)
                with float32_region(dev):
                    o = tgt.float()
                    delta = self.bbox_embed(o)
                    xy = torch.sigmoid(delta[..., 0:2] + ref)
                    wh = torch.sigmoid(delta[..., 2:4])
                    boxes.append(torch.cat([xy, wh], -1))
                    logits.append(self.class_embed(o))
        logits, boxes = torch.stack(logits), torch.stack(boxes)
        return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
                "aux_logits": logits[:-1], "aux_boxes": boxes[:-1]}


def anchor_detr_postprocess(out: Dict[str, torch.Tensor], input_hw,
                            max_detections: int = 100) -> Detections:
    """Sigmoid scores, the top ``max_detections`` of all (query, class)
    pairs, boxes in input pixels (JAX :483)."""
    prob = torch.sigmoid(out["pred_logits"].float())          # [B, Q, C]
    b, q, c = prob.shape
    top_scores, top_idx = stable_top_k(prob.reshape(b, q * c),
                                       max_detections)
    top_q = torch.div(top_idx, c, rounding_mode="floor")
    boxes = boxes_to_pixels(out["pred_boxes"], input_hw)
    return Detections(
        boxes=boxes.gather(1, top_q[..., None].expand(-1, -1, 4)),
        scores=top_scores,
        classes=(top_idx % c).to(torch.int32),
        valid=top_scores > 0.0)


@META_ARCH_REGISTRY.register(name="AnchorDetr")
def build_anchor_detr(cfg: DetrConfig, device="cuda",
                      seed: int = 0) -> AnchorDETR:
    """AnchorDETR from a ``DetrConfig`` (JAX :505) with weights from
    ``seed``, on ``device``, channels_last, eval mode."""
    check_detr_config(cfg, "AnchorDetr")
    return finish_build(AnchorDETR(
        num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim,
        num_query_position=cfg.num_query_position,
        num_query_pattern=cfg.num_query_pattern, nheads=cfg.nheads,
        enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
        dim_feedforward=cfg.dim_feedforward,
        resnet_depth=cfg.resnet_depth, spatial_prior=cfg.spatial_prior,
        attention_type=cfg.attention_type,
        dtype=torch.bfloat16 if cfg.amp else torch.float32), device, seed)
