"""The DETR variants of JAX ``models/meta_arch/detr_variants.py``:
AnchorDETR, SMCA-DETR, DAB-DETR and the d2go DETR.

* AnchorDETR: anchor points times patterns as queries, the RCDA encoder
  (or DETR's dense encoder) and the RCDA decoder, one class head and one
  box head shared by every level, the boxes' xy refined around each
  query's anchor. It trains with the sigmoid-focal criterion of
  ``meta_arch/detr.py``; the tail ranks all (query, class) pairs.
* SMCA-DETR: DETR's encoder, then decoder layers whose cross-attention
  adds a Gaussian prior around centres and scales that ``cs_head``
  predicts from the query embeddings (``models/layers/smca.py``).
* DAB-DETR: a reference box [Q, 4] a query, ``sigmoid(ref_boxes)``, whose
  centre's sine embedding (``ref_pos_proj``) is the query position of
  every DETR decoder layer; each level refines the boxes through
  ``inverse_sigmoid`` and the next takes them without gradient.
* DetrD2go: DETR or SMCA decoding (``MODEL.DETR.ATTENTION_TYPE`` "SMCA",
  else DETR), the centred sine embedding where
  ``CENTERED_POSITION_ENCODIND``, a LayerNorm a level on the DETR path,
  C logits under the focal criterion (``USE_FOCAL_LOSS``) and C + 1
  otherwise, on the registered backbone ``MODEL.BACKBONE.NAME`` names
  unless the name holds "resnet" (JAX :693-699).

SMCA-DETR and DAB-DETR build ResNet(``MODEL.RESNETS.DEPTH``) whatever
``MODEL.BACKBONE.NAME`` says, as the JAX builders do (ROADMAP.md C.28).
The encoders and decoders have no dropout, as in the JAX package. Module
names follow the flax ones under ``transformer.encoder.layers.N`` and
``transformer.decoder.layers.N`` (``utils/weight_port.py``
``map_anchor_detr_torch_name`` and ``map_detr_variant_torch_name``); the
raw parameters ``anchor_points``, ``pattern_embed`` and ``ref_boxes`` keep
their flax names.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.detr import DetrConfig
from yolov7_d2_tpu_torch.models.backbones.resnet import RESNET_CHANNELS
from yolov7_d2_tpu_torch.models.build import META_ARCH_REGISTRY
from yolov7_d2_tpu_torch.models.layers.rcda import RCDAttention, pos2posemb2d
from yolov7_d2_tpu_torch.models.layers.smca import (
    SMCADecoderLayer,
    smca_prior,
)
from yolov7_d2_tpu_torch.models.layers.transformer import (
    MLP,
    DecoderLayer,
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
    detr_postprocess,
    finish_build,
    float32_region,
    normalized_input,
    stable_top_k,
)
from yolov7_d2_tpu_torch.models.registries import build_backbone
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


class _DenseEncoderDETR(nn.Module):
    """normalize -> backbone (its ``res5``, else its last output) ->
    ``input_proj`` -> DETR's dense encoder (no dropout) over the sine
    embedding (centred with ``centered_pe``), then the decoder of the
    subclass (``decode``) and the class and box heads on every level in
    float32. Returns the keys of :class:`DETR`'s output."""

    def __init__(self, backbone: nn.Module, feat_channels: int,
                 num_logits: int, hidden_dim: int, nheads: int,
                 enc_layers: int, dim_feedforward: int,
                 centered_pe: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.nheads = nheads
        self.centered_pe = centered_pe
        self.generator: Optional[torch.Generator] = None
        self.backbone = backbone
        self.input_proj = nn.Conv2d(feat_channels, hidden_dim, 1)
        self.transformer = nn.Module()
        self.transformer.encoder = LayerStack(
            [EncoderLayer(hidden_dim, nheads, dim_feedforward, 0.0, False,
                          dtype) for _ in range(enc_layers)])
        self.class_embed = nn.Linear(hidden_dim, num_logits)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    def encode(self, x: torch.Tensor):
        """-> memory and position [B, HW, C] and the memory's (h, w)."""
        feats = self.backbone(x)
        f = feats["res5"] if "res5" in feats else list(feats.values())[-1]
        src = self.input_proj(f)
        b, c, h, w = src.shape
        pos = sine_position_embedding(h, w, c // 2, centered=self.centered_pe,
                                      device=src.device)
        pos = pos.to(self.dtype).reshape(1, h * w, c).expand(b, -1, -1)
        mem = src.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for layer in self.transformer.encoder.layers:
            mem = layer(mem, pos)
        return mem, pos, (h, w)

    def heads(self, tgt: torch.Tensor, logits: List[torch.Tensor],
              boxes: List[torch.Tensor]) -> None:
        """One level's class logits and sigmoid boxes, in float32."""
        with float32_region(tgt.device):
            o = tgt.float()
            logits.append(self.class_embed(o))
            boxes.append(torch.sigmoid(self.bbox_embed(o)))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        x = normalized_input(images, self.dtype)
        dt = self.dtype
        with torch.autocast(x.device.type, dtype=dt,
                            enabled=dt == torch.bfloat16):
            logits, boxes = self.decode(*self.encode(x))
        logits, boxes = torch.stack(logits), torch.stack(boxes)
        return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
                "aux_logits": logits[:-1], "aux_boxes": boxes[:-1]}


class DABDETR(_DenseEncoderDETR):
    """DAB-DETR (JAX :404): reference boxes ``sigmoid(ref_boxes)`` [Q, 4];
    each DETR decoder layer (no dropout) takes ``ref_pos_proj`` of the sine
    embedding of its boxes' centres (float32) as the query position; its
    level's boxes are ``sigmoid(bbox_embed + inverse_sigmoid(ref))``, which
    the next level takes detached (the JAX ``stop_gradient``). C + 1
    logits."""

    def __init__(self, num_classes: int = 80, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, resnet_depth: int = 50,
                 dtype: torch.dtype = torch.float32):
        super().__init__(detr_backbone(resnet_depth),
                         RESNET_CHANNELS["res5"], num_classes + 1,
                         hidden_dim, nheads, enc_layers, dim_feedforward,
                         dtype=dtype)
        self.ref_boxes = nn.Parameter(torch.empty(num_queries, 4))
        self.ref_pos_proj = nn.Linear(hidden_dim, hidden_dim)
        self.transformer.decoder = LayerStack(
            [DecoderLayer(hidden_dim, nheads, dim_feedforward, 0.0, False,
                          dtype) for _ in range(dec_layers)])

    def decode(self, mem, pos, hw):
        b, _, c = mem.shape
        dev = mem.device
        ref = torch.sigmoid(self.ref_boxes.float())[None].expand(b, -1, -1)
        tgt = torch.zeros(b, ref.shape[1], c, dtype=self.dtype, device=dev)
        logits, boxes = [], []
        for layer in self.transformer.decoder.layers:
            with float32_region(dev):
                query_pos = self.ref_pos_proj(
                    pos2posemb2d(ref[..., :2], c // 2)).to(self.dtype)
            tgt = layer(tgt, mem, query_pos, pos)
            with float32_region(dev):
                o = tgt.float()
                new_ref = torch.sigmoid(self.bbox_embed(o)
                                        + inverse_sigmoid(ref))
                boxes.append(new_ref)
                logits.append(self.class_embed(o))
            ref = new_ref.detach()
        return logits, boxes


class DetrD2go(_DenseEncoderDETR):
    """The d2go DETR (JAX ``DetrD2goModule`` :562), and SMCA-DETR (JAX
    :327) as its "SMCA" case on the family's ResNet with C + 1 logits and
    the plain sine embedding: ``attention_type`` "SMCA" decodes with
    ``cs_head`` (2 layers) and :class:`SMCADecoderLayer` s
    (``smca_decode``); "DETR" with DETR decoder layers
    (no dropout), each level through its own float32 LayerNorm
    (``dec_norms.N``) before the heads. ``use_focal`` gives C logits, else
    C + 1. ``backbone`` is a built registered backbone (its last output
    feeds ``input_proj``), else the family's ResNet."""

    def __init__(self, num_classes: int = 80, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, attention_type: str = "DETR",
                 centered_pe: bool = False, use_focal: bool = False,
                 backbone: Optional[nn.Module] = None,
                 resnet_depth: int = 50,
                 dtype: torch.dtype = torch.float32):
        if backbone is None:
            backbone, feat = (detr_backbone(resnet_depth),
                              RESNET_CHANNELS["res5"])
        else:
            # the feature ``encode`` takes: ``res5``, else the last
            widths = backbone.out_channels
            feat = widths.get("res5", list(widths.values())[-1])
        super().__init__(backbone, feat, num_classes + (not use_focal),
                         hidden_dim, nheads, enc_layers, dim_feedforward,
                         centered_pe, dtype)
        self.attention_type = attention_type
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        if attention_type == "SMCA":
            self.cs_head = MLP(hidden_dim, hidden_dim, nheads * 4, 2)
            layers = [SMCADecoderLayer(hidden_dim, nheads, dim_feedforward,
                                       dtype) for _ in range(dec_layers)]
        else:
            layers = [DecoderLayer(hidden_dim, nheads, dim_feedforward, 0.0,
                                   False, dtype) for _ in range(dec_layers)]
            self.dec_norms = nn.ModuleList(
                LayerNorm(hidden_dim, eps=1e-5) for _ in range(dec_layers))
        self.transformer.decoder = LayerStack(layers)

    def query_pos(self, b: int) -> torch.Tensor:
        """The query embeddings (``query_embed``) [b, Q, C] in the compute
        dtype."""
        q = self.query_embed.weight
        return q[None].expand(b, *q.shape).to(self.dtype)

    def smca_decode(self, mem, pos, hw):
        """SMCA's decoder (JAX :376-393): the queries as positions over a
        zero target, ``cs_head`` (float32) on them for each head's centre
        (sigmoid) and log-scales, one prior for every
        :class:`SMCADecoderLayer` (the JAX loop recomputes the same values
        a layer, for every image: ROADMAP.md C.32)."""
        query_pos = self.query_pos(mem.shape[0])
        nq = query_pos.shape[1]
        with float32_region(mem.device):
            cs = self.cs_head(query_pos[:1].float()).reshape(
                1, nq, self.nheads, 4)
            cs = torch.cat([torch.sigmoid(cs[..., 0:2]), cs[..., 2:]], -1)
            prior = smca_prior(cs, *hw, self.dtype)
        tgt = torch.zeros_like(query_pos)
        logits, boxes = [], []
        for layer in self.transformer.decoder.layers:
            tgt = layer(tgt, mem, query_pos, pos, prior)
            self.heads(tgt, logits, boxes)
        return logits, boxes

    def decode(self, mem, pos, hw):
        if self.attention_type == "SMCA":
            return self.smca_decode(mem, pos, hw)
        query_pos = self.query_pos(mem.shape[0])
        tgt = torch.zeros_like(query_pos)
        logits, boxes = [], []
        for layer, norm in zip(self.transformer.decoder.layers,
                               self.dec_norms):
            tgt = layer(tgt, mem, query_pos, pos)
            self.heads(norm(tgt), logits, boxes)
        return logits, boxes


def detr_tail(cfg: DetrConfig):
    """The serving tail of ``cfg``'s logits: the sigmoid top-k over (query,
    class) pairs (:func:`anchor_detr_postprocess`) for C-logit heads
    (AnchorDETR, and the d2go DETR under the focal criterion, whose C
    logits have no "no object"; JAX wires no tail for it, ROADMAP.md
    C.29), else DETR's softmax tail (``detr_postprocess``)."""
    return anchor_detr_postprocess if cfg.use_focal else detr_postprocess


def _dims(cfg: DetrConfig) -> dict:
    return dict(num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim,
                num_queries=cfg.num_queries, nheads=cfg.nheads,
                enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
                dim_feedforward=cfg.dim_feedforward,
                resnet_depth=cfg.resnet_depth,
                dtype=torch.bfloat16 if cfg.amp else torch.float32)


@META_ARCH_REGISTRY.register(name="SMCADetr")
def build_smca_detr(cfg: DetrConfig, device="cuda",
                    seed: int = 0) -> DetrD2go:
    """SMCA-DETR from a ``DetrConfig`` (JAX :529), the "SMCA" case of
    :class:`DetrD2go`, on ResNet (``resnet_depth``) whatever
    ``cfg.backbone`` says, with weights from ``seed``, on ``device``,
    channels_last, eval mode."""
    check_detr_config(cfg, "SMCADetr")
    return finish_build(DetrD2go(attention_type="SMCA", **_dims(cfg)),
                        device, seed)


@META_ARCH_REGISTRY.register(name="DABDetr")
def build_dab_detr(cfg: DetrConfig, device="cuda", seed: int = 0) -> DABDETR:
    """DAB-DETR from a ``DetrConfig`` (JAX :546), as
    :func:`build_smca_detr`."""
    check_detr_config(cfg, "DABDetr")
    return finish_build(DABDETR(**_dims(cfg)), device, seed)


@META_ARCH_REGISTRY.register(name="DetrD2go")
def build_detr_d2go(cfg: DetrConfig, device="cuda",
                    seed: int = 0) -> DetrD2go:
    """The d2go DETR from a ``DetrConfig`` (JAX :677): the registered
    backbone ``cfg.backbone`` names where the name lacks "resnet", in any
    case (``models/registries.build_backbone``: a zoo backbone, Res2Net,
    Swin, MobileViT, ..., or CSPDarknet-X at ``MODEL.YOLO``'s multipliers,
    which is what the default name gives ``detr/d2go/detr_bs16.yaml``,
    ROADMAP.md C.30), else the family's ResNet (so for
    ``build_cspresnet50d_backbone`` too, as in JAX); ConvNeXt's drop path
    draws from the model's generator."""
    check_detr_config(cfg, "DetrD2go")
    backbone = None
    if cfg.backbone and "resnet" not in cfg.backbone.lower():
        backbone = build_backbone(cfg)
    model = finish_build(DetrD2go(
        attention_type=cfg.d2go_attention, centered_pe=cfg.centered_pe,
        use_focal=cfg.use_focal_loss, backbone=backbone, **_dims(cfg)),
        device, seed)
    if hasattr(model.backbone, "generator"):
        model.backbone.generator = model.generator
    return model
