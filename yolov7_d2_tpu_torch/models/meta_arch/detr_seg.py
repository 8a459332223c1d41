"""DETRsegm, DETR with a mask head (JAX ``models/meta_arch/detr_seg.py``):
the model and its two tails.

``DETRsegm`` is the port's DETR (ResNet res5, the sine embedding, the
6 + 6 transformer without dropout and with the JAX model's fixed FFN of
2048, the class and box heads) that also keeps the encoder's memory, plus
``bbox_attention`` (each last-level query's attention heatmaps over the
memory, one a head, softmax in float32) and ``mask_head`` (the memory
broadcast to every query, concatenated with its heatmaps, three 3x3
conv-GN-ReLU, the last two each followed by a 2x nearest upsample, and a
3x3 to one logit): ``pred_masks`` [B, Q, H/8, W/8] float32 logits.
``postprocess_segm`` thresholds their sigmoid; ``postprocess_panoptic``
merges the kept queries' weighted masks by the pixelwise argmax.

The mask term of the loss is ``detr.detr_losses``'. ``MODEL.DETR.
FROZEN_WEIGHTS`` is read nowhere in the JAX package (ROADMAP.md C.37), and
the port trains every weight too.

Parameter names: DETR's (``utils/weight_port.py`` ``map_detr_torch_name``)
and the flax ones of the two heads (``bbox_attention.{q,k}_proj``,
``mask_head.lay{i}``, ``gn{i}``, ``out_lay``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.detr import DetrConfig
from yolov7_d2_tpu_torch.models.build import META_ARCH_REGISTRY
from yolov7_d2_tpu_torch.models.layers.blocks import AutocastReLU
from yolov7_d2_tpu_torch.models.layers.transformer import (
    sine_position_embedding,
)
from yolov7_d2_tpu_torch.models.meta_arch.detr import (
    DETR,
    check_detr_config,
    finish_build,
    float32_region,
    normalized_input,
)


class MHAttentionMap(nn.Module):
    """Per-query attention heatmaps [B, Q, heads, H, W] over the memory, no
    value projection (JAX :25); ``k_proj`` is the flax 1x1 convolution."""

    def __init__(self, hidden_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Conv2d(hidden_dim, hidden_dim, 1)

    def forward(self, queries: torch.Tensor,
                memory_2d: torch.Tensor) -> torch.Tensor:
        """queries [B, Q, E]; memory_2d [B, H, W, E]."""
        b, qn, e = queries.shape
        _, h, w, _ = memory_2d.shape
        hd = e // self.num_heads
        q = self.q_proj(queries).reshape(b, qn, self.num_heads, hd)
        k = F.linear(memory_2d, self.k_proj.weight.reshape(e, e),
                     self.k_proj.bias).reshape(b, h * w, self.num_heads, hd)
        logits = torch.einsum("bqnd,bpnd->bqnp", q, k) * (hd ** -0.5)
        with float32_region(queries.device):
            attn = torch.softmax(logits.float(), -1)
        return attn.reshape(b, qn, self.num_heads, h, w)


class MaskHeadSmallConv(nn.Module):
    """(memory, heatmaps) -> per-query mask logits at 4x the memory's size
    (JAX :48): ``lay0``-``lay2`` 3x3 conv, ``gn{i}`` GroupNorm(min(8, C))
    ReLU (rounded to the compute dtype, as in JAX), 2x nearest after the
    second and third; ``out_lay`` 3x3 to 1."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 8):
        super().__init__()
        dims = [hidden_dim, hidden_dim // 2, hidden_dim // 4]
        c_in = hidden_dim + num_heads
        for i, d in enumerate(dims):
            self.add_module(f"lay{i}", nn.Conv2d(c_in, d, 3, 1, 1))
            self.add_module(f"gn{i}", nn.GroupNorm(min(8, d), d, eps=1e-5))
            c_in = d
        self.out_lay = nn.Conv2d(c_in, 1, 3, 1, 1)
        self.relu = AutocastReLU()

    def forward(self, memory_2d: torch.Tensor,
                attn: torch.Tensor) -> torch.Tensor:
        """memory_2d [B, H, W, E]; attn [B, Q, heads, H, W]."""
        b, qn, nh, h, w = attn.shape
        mem = memory_2d.permute(0, 3, 1, 2)[:, None].expand(b, qn, -1, h, w)
        x = torch.cat([mem, attn.to(mem.dtype)], 2).reshape(b * qn, -1, h, w)
        x = x.contiguous(memory_format=torch.channels_last)
        for i in range(3):
            x = self.relu(getattr(self, f"gn{i}")(getattr(self, f"lay{i}")(x)))
            if i > 0:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        out = self.out_lay(x)
        return out.reshape(b, qn, out.shape[2], out.shape[3]).float()


class DETRsegm(DETR):
    """DETR + ``bbox_attention`` + ``mask_head`` (JAX :83); the outputs of
    DETR plus ``pred_masks``."""

    def __init__(self, num_classes: int = 80, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6,
                 resnet_depth: int = 50,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, hidden_dim, num_queries, nheads,
                         enc_layers, dec_layers, 2048, 0.0, False,
                         resnet_depth, dtype)
        self.bbox_attention = MHAttentionMap(hidden_dim, nheads)
        self.mask_head = MaskHeadSmallConv(hidden_dim, nheads)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = normalized_input(images, self.dtype)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype == torch.bfloat16):
            src = self.input_proj(self.backbone(x)["res5"])
            b, c, h, w = src.shape
            pos = sine_position_embedding(h, w, c // 2, device=src.device)
            pos = pos.to(self.dtype).reshape(1, h * w, c).expand(b, -1, -1)
            src = src.permute(0, 2, 3, 1).reshape(b, h * w, c)
            hs, memory = self.transformer(src, pos, self.query_embed.weight,
                                          self.generator)
            memory_2d = memory.reshape(b, h, w, c).to(self.dtype)
            attn = self.bbox_attention(hs[-1].to(self.dtype), memory_2d)
            masks = self.mask_head(memory_2d, attn.to(self.dtype))
        with float32_region(x.device):
            hs = hs.float()
            logits = self.class_embed(hs)
            boxes = torch.sigmoid(self.bbox_embed(hs))
        return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
                "aux_logits": logits[:-1], "aux_boxes": boxes[:-1],
                "pred_masks": masks}


def postprocess_segm(out: Dict[str, torch.Tensor],
                     mask_threshold: float = 0.5) -> torch.Tensor:
    """Each query's mask, sigmoid above ``mask_threshold`` (JAX :156)."""
    return torch.sigmoid(out["pred_masks"]) > mask_threshold


def postprocess_panoptic(out: Dict[str, torch.Tensor], num_classes: int,
                         object_threshold: float = 0.85
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pixelwise argmax over the query masks weighted by their scores,
    queries below ``object_threshold`` or of "no object" weighted 0 (JAX
    :163). Returns (segment map [B, Hm, Wm] int32 query indices, the kept
    queries [B, Q])."""
    prob = torch.softmax(out["pred_logits"].float(), -1)
    scores = prob[..., :-1].amax(-1)
    keep = (scores > object_threshold) & (prob.argmax(-1) != num_classes)
    masks = torch.sigmoid(out["pred_masks"])
    weighted = masks * torch.where(keep, scores, 0.0)[..., None, None]
    return weighted.argmax(1).to(torch.int32), keep


@META_ARCH_REGISTRY.register(name="DetrSegm")
def build_detr_segm(cfg: DetrConfig, device="cuda",
                    seed: int = 0) -> DETRsegm:
    """DETRsegm from a ``DetrConfig`` (JAX :184: the classes, widths,
    queries, heads, layers and the ResNet's depth; no dropout, FFN 2048)
    with weights from ``seed``, on ``device``, channels_last, eval mode."""
    check_detr_config(cfg, "DetrSegm")
    return finish_build(DETRsegm(
        num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim,
        num_queries=cfg.num_queries, nheads=cfg.nheads,
        enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
        resnet_depth=cfg.resnet_depth,
        dtype=torch.bfloat16 if cfg.amp else torch.float32), device, seed)
