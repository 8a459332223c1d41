"""DETR (JAX ``models/meta_arch/detr.py``): the model, the Hungarian set
criterion shared by the DETR family, and its serving tail.

``DETR.forward`` takes the letterboxed NHWC batch. A uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) with the BGR
ImageNet mean and std that the JAX model hard-codes (:58-60, as
SparseInst's); then ResNet-50 (FrozenBN, stride on the 3x3) to res5, the
1x1 ``input_proj``, the sine position embedding over the whole
letterboxed grid (the JAX model passes no padding mask), the 6 + 6
transformer and the class and box heads on every decoder level, in float32
outside autocast as the JAX heads run on ``hs.astype(float32)``.

The criterion matches every decoder level in one call of the batched
auction (``ops/matchers.py``): the levels are stacked on its batch axis,
and since it treats each row on its own, the assignments are those of one
call a level, as the JAX code makes them. The tail ranks by a stable
descending sort, so that equal scores keep ``jax.lax.top_k``'s order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.detr import DetrConfig
from yolov7_d2_tpu_torch.kernels.preprocess import (
    normalize_images,
    normalize_images_plain,
)
from yolov7_d2_tpu_torch.models.backbones.resnet import (
    RESNET_CHANNELS,
    ResNet,
    ResNetSpec,
)
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.layers.transformer import (
    MLP,
    MultiheadAttention,
    Transformer,
    sine_position_embedding,
)
from yolov7_d2_tpu_torch.ops.iou import (
    generalized_box_iou,
    pairwise_generalized_box_iou,
)
from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import _resize
from yolov7_d2_tpu_torch.ops.losses import (
    dice_loss,
    sigmoid_focal_loss,
    weighted_softmax_cross_entropy,
)
from yolov7_d2_tpu_torch.ops.matchers import hungarian_match
from yolov7_d2_tpu_torch.parallel.dist import all_reduce_sum
from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy
from yolov7_d2_tpu_torch.structures.instances import Detections

# detr.py:58-59 of the JAX package (ImageNet statistics, BGR)
PIXEL_MEAN = (103.53, 116.28, 123.675)
PIXEL_STD = (57.375, 57.12, 58.395)


def float32_region(device: torch.device):
    """A region outside autocast, where the JAX model computes in f32."""
    return torch.autocast(device.type, enabled=False)


def detr_backbone(depth: int) -> ResNet:
    """The family's ResNet: FrozenBN and the stride on the 3x3 (every
    reference DETR config sets STRIDE_IN_1X1 False), res5 out."""
    return ResNet(ResNetSpec(depth=depth, out_features=("res5",),
                             frozen_bn=True, stride_in_1x1=False))


def normalized_input(images: torch.Tensor, dtype: torch.dtype):
    """uint8 through the normalize kernel, float through its plain
    version: (x - mean) / std in float32, one rounding to ``dtype``,
    channels_last."""
    norm = (normalize_images if images.dtype == torch.uint8
            else normalize_images_plain)
    return norm(images, PIXEL_MEAN, PIXEL_STD, dtype)


class DETR(nn.Module):
    """normalize -> ResNet res5 -> ``input_proj`` -> transformer -> heads
    (JAX :39). ``dtype`` is the compute dtype: bfloat16 runs under
    autocast over float32 parameters. Dropout draws from
    ``self.generator`` (set by :func:`build_detr` on the model's device).
    Returns ``pred_logits`` [B, Q, C + 1] ("no object" last),
    ``pred_boxes`` [B, Q, 4] normalized cxcywh, and the other levels as
    ``aux_logits`` / ``aux_boxes`` [L - 1, B, Q, ...], all float32."""

    def __init__(self, num_classes: int = 80, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 pre_norm: bool = False, resnet_depth: int = 50,
                 dtype: torch.dtype = torch.float32,
                 layer_remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.generator: Optional[torch.Generator] = None
        self.backbone = detr_backbone(resnet_depth)
        self.input_proj = nn.Conv2d(RESNET_CHANNELS["res5"], hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer = Transformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward,
            dropout, pre_norm, dtype, remat=layer_remat)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        x = normalized_input(images, self.dtype)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype == torch.bfloat16):
            src = self.input_proj(self.backbone(x)["res5"])
            b, c, h, w = src.shape
            pos = sine_position_embedding(h, w, c // 2, device=src.device)
            pos = pos.to(self.dtype).reshape(1, h * w, c).expand(b, -1, -1)
            src = src.permute(0, 2, 3, 1).reshape(b, h * w, c)
            hs, _ = self.transformer(src, pos, self.query_embed.weight,
                                     self.generator)
        with float32_region(x.device):
            hs = hs.float()
            logits = self.class_embed(hs)
            boxes = torch.sigmoid(self.bbox_embed(hs))
        return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
                "aux_logits": logits[:-1], "aux_boxes": boxes[:-1]}


# ---------------------------------------------------------------------------
# matching and the criterion
# ---------------------------------------------------------------------------

@torch.no_grad()
def detr_match(
    pred_logits: torch.Tensor,     # [B, Q, C'] (C + 1 softmax, C focal)
    pred_boxes: torch.Tensor,      # [B, Q, 4] normalized cxcywh
    gt_boxes_norm: torch.Tensor,   # [B, G, 4] normalized cxcywh
    gt_classes: torch.Tensor,      # [B, G]
    gt_valid: torch.Tensor,        # [B, G]
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    use_focal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The assignment that minimizes class + L1 + gIoU cost (JAX :118):
    the class cost is minus the softmax probability of the gt's class, or
    with ``use_focal`` AnchorDETR's focal cost at it (alpha 0.25, gamma
    2), the class index clipped at 0 either way. Returns ``pred_of_gt``
    [B, G] (0 where unmatched), ``ok`` [B, G] and the auction's rounds a
    row [B]. Rows are independent: several decoder levels stacked on the
    batch axis get the assignments of separate calls."""
    logits = pred_logits.float()
    boxes = pred_boxes.float()
    q = boxes.shape[1]
    idx = gt_classes.long().clamp(min=0)[:, None, :].expand(-1, q, -1)
    if use_focal:
        p = torch.sigmoid(logits).gather(2, idx).transpose(1, 2)  # [B, G, Q]
        alpha, gamma = 0.25, 2.0
        pos = alpha * (1.0 - p) ** gamma * (-torch.log(p + 1e-8))
        neg = (1.0 - alpha) * p ** gamma * (-torch.log(1.0 - p + 1e-8))
        cls_cost = pos - neg
    else:
        cls_cost = -torch.softmax(logits, -1).gather(2, idx).transpose(1, 2)
    gt = gt_boxes_norm.float()
    l1 = (gt[:, :, None, :] - boxes[:, None, :, :]).abs().sum(-1)
    giou = pairwise_generalized_box_iou(cxcywh_to_xyxy(gt),
                                        cxcywh_to_xyxy(boxes))
    cost = cost_class * cls_cost + cost_bbox * l1 - cost_giou * giou
    valid = gt_valid.bool()
    raw, _, iters = hungarian_match(
        cost, valid, torch.ones(cost.shape[0], q, dtype=torch.bool,
                                device=cost.device))
    return raw.clamp(min=0), (raw >= 0) & valid, iters


def set_targets(pred_of_gt: torch.Tensor, ok: torch.Tensor,
                gt_classes: torch.Tensor, q: int,
                num_classes: int) -> torch.Tensor:
    """Each query's class target [B, Q]: "no object" (``num_classes``)
    unless matched; an unmatched gt scatters to the spare slot ``q``,
    which is cut (the JAX scatter's mode="drop")."""
    b = pred_of_gt.shape[0]
    tgt = torch.full((b, q + 1), num_classes, dtype=torch.long,
                     device=pred_of_gt.device)
    tgt.scatter_(1, torch.where(ok, pred_of_gt, q), gt_classes.long())
    return tgt[:, :q]


def detr_set_criterion(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    gt_boxes_norm: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    match: Tuple[torch.Tensor, torch.Tensor],
    targets: torch.Tensor,
    weights: torch.Tensor,
    normalizers: torch.Tensor,
    use_focal: bool = False,
    prefix: str = "",
) -> Dict[str, torch.Tensor]:
    """One decoder level's losses (JAX :168) on its assignment ``match``
    (``(pred_of_gt, ok)`` [B, G]) and class ``targets`` [B, Q]
    (:func:`set_targets`): the class term (CE weighted by ``weights``,
    ``eos_coef`` on "no object", divided by the weights of the targets; or
    the sigmoid focal loss over the first ``num_classes`` logits, divided
    by the matched count), 5 x L1 and 2 x (1 - gIoU) of the matched boxes
    over the matched count (at least 1), and the cardinality error,
    without gradient and outside the total. ``normalizers`` [2] is the
    matched count and the targets' weight sum of the global batch (summed
    over the ranks of a process group by :func:`detr_losses`, as the JAX
    sums over a data mesh). Adds ``num_matched``, the level's matched
    count on this rank, to the JAX dict."""
    pred_of_gt, ok = match
    okf = ok.float()
    num_boxes = normalizers[0].clamp(min=1.0)
    logits = pred_logits.float()
    if use_focal:
        onehot = F.one_hot(targets,
                           num_classes + 1)[..., :num_classes].float()
        loss_ce = sigmoid_focal_loss(logits[..., :num_classes],
                                     onehot).sum() / num_boxes
    else:
        ce = weighted_softmax_cross_entropy(logits, targets, weights)
        loss_ce = ce.sum() / normalizers[1]

    gt = gt_boxes_norm.float()
    matched = pred_boxes.float().gather(
        1, pred_of_gt[..., None].expand(-1, -1, 4))            # [B, G, 4]
    loss_bbox = ((matched - gt).abs().sum(-1) * okf).sum() / num_boxes
    giou = generalized_box_iou(cxcywh_to_xyxy(matched), cxcywh_to_xyxy(gt))
    loss_giou = ((1.0 - giou) * okf).sum() / num_boxes

    with torch.no_grad():
        pred_count = (logits.argmax(-1) != num_classes).sum(-1).float()
        card_err = (pred_count - gt_valid.sum(-1).float()).abs().mean()
    return {
        f"{prefix}loss_ce": loss_ce,
        f"{prefix}loss_bbox": 5.0 * loss_bbox,
        f"{prefix}loss_giou": 2.0 * loss_giou,
        f"{prefix}cardinality_error": card_err,
        f"{prefix}num_matched": okf.sum().detach(),
    }


def normalized_gt_boxes(gt_boxes: torch.Tensor, input_hw) -> torch.Tensor:
    """xyxy boxes in input pixels -> cxcywh normalized by the input size."""
    h, w = input_hw
    xyxy = gt_boxes.float() / torch.tensor([w, h, w, h], dtype=torch.float32,
                                           device=gt_boxes.device)
    return torch.cat([(xyxy[..., 0:2] + xyxy[..., 2:4]) * 0.5,
                      xyxy[..., 2:4] - xyxy[..., 0:2]], -1)


def detr_mask_losses(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                     pred_of_gt: torch.Tensor, ok: torch.Tensor,
                     num_matched: torch.Tensor) -> Dict[str, torch.Tensor]:
    """DETRsegm's mask terms (JAX ``detr.py:261-291``): each matched
    query's mask logits [Hm, Wm] against its gt's mask, resized bilinear
    with antialiasing (``jax.image.resize``'s default) and cut at 0.5: the
    dice loss (smooth 1) of the sigmoid and the mean sigmoid focal loss
    over the pixels, each summed over the matched pairs and divided by
    ``num_matched`` (the last level's matched count, at least 1). The
    assignment is the last level's."""
    b, _, hm, wm = pred_masks.shape
    g = gt_masks.shape[1]
    gt_small = (_resize(gt_masks.float(), (hm, wm), antialias=True)
                > 0.5).float().reshape(b, g, -1)
    matched = pred_masks.float().gather(
        1, pred_of_gt[..., None, None].expand(-1, -1, hm, wm)).reshape(
        b, g, -1)
    okf = ok.float()
    num = num_matched.clamp(min=1.0)
    return {
        "loss_mask_dice": (dice_loss(torch.sigmoid(matched), gt_small)
                           * okf).sum() / num,
        "loss_mask_focal": (sigmoid_focal_loss(matched, gt_small).mean(-1)
                            * okf).sum() / num,
    }


def detr_losses(
    out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    num_classes: int,
    input_hw,
    deep_supervision: bool = True,
    eos_coef: float = 0.1,
    use_focal: bool = False,
    match: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The criterion of every decoder level (JAX :237): the last level's
    terms, and with ``deep_supervision`` the others' under ``aux{i}_``;
    ``total_loss`` sums every term but the cardinality errors. All levels
    are matched in one auction ([levels x B, G, Q]); ``match_iters`` is its
    rounds (the slowest row). ``match`` is ``(pred_of_gt, ok)`` [levels x
    B, G], the last level first, where the caller matched already
    (``match_iters`` is then 0); the dict's ``match`` is the assignment
    the terms used, in that form (not a metric: the train step keeps it as
    ``TrainState.match``). The normalizers of every level go over
    the ranks of a process group in one all-reduce; ``num_boxes`` is the
    last level's, the global batch's matched count. Where ``out`` holds
    ``pred_masks`` (DetrSegm) and ``batch`` holds ``gt_masks``, the mask
    terms of :func:`detr_mask_losses` join the last level's."""
    gt = normalized_gt_boxes(batch["gt_boxes"], input_hw)
    cls, valid = batch["gt_classes"], batch["gt_valid"]
    levels = [(out["pred_logits"], out["pred_boxes"], "")]
    if deep_supervision:
        levels += [(out["aux_logits"][i], out["aux_boxes"][i], f"aux{i}_")
                   for i in range(out["aux_logits"].shape[0])]
    n, b = len(levels), cls.shape[0]

    def rep(t):
        return t.repeat(n, *([1] * (t.dim() - 1)))

    if match is None:
        pred_of_gt, ok, iters = detr_match(
            torch.cat([lg.detach() for lg, _, _ in levels]),
            torch.cat([bx.detach() for _, bx, _ in levels]),
            rep(gt), rep(cls), rep(valid), use_focal=use_focal)
    else:
        (pred_of_gt, ok), iters = match, torch.zeros(1, device=gt.device)
    q = levels[0][0].shape[1]
    targets = set_targets(pred_of_gt, ok, rep(cls), q, num_classes)
    weights = torch.ones(num_classes + 1, device=gt.device)
    weights[num_classes] = eos_coef
    # each level's matched count and the CE term's weight sum of its
    # targets (the focal loss reads the count only), one all-reduce
    count = ok.float().reshape(n, -1).sum(1)
    den = count if use_focal else weights[targets].reshape(n, -1).sum(1)
    norms = all_reduce_sum(torch.stack([count, den], 1).detach())
    losses: Dict[str, torch.Tensor] = {}
    for i, (lg, bx, prefix) in enumerate(levels):
        rows = slice(i * b, (i + 1) * b)
        losses.update(detr_set_criterion(
            lg, bx, gt, valid, num_classes, (pred_of_gt[rows], ok[rows]),
            targets[rows], weights, norms[i], use_focal, prefix))
    if "pred_masks" in out and "gt_masks" in batch:
        losses.update(detr_mask_losses(
            out["pred_masks"], batch["gt_masks"], pred_of_gt[:b], ok[:b],
            norms[0, 0]))
    losses["total_loss"] = sum(v for k, v in losses.items() if "loss" in k)
    losses["num_boxes"] = norms[0, 0]
    losses["match_iters"] = iters.max().float()
    losses["match"] = (pred_of_gt, ok)
    return losses


# ---------------------------------------------------------------------------
# serving tail
# ---------------------------------------------------------------------------

def stable_top_k(x: torch.Tensor, k: int):
    """The ``k`` largest of the last axis, largest first, equal values in
    index order (``jax.lax.top_k``'s order): a stable descending sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def boxes_to_pixels(pred_boxes: torch.Tensor, input_hw) -> torch.Tensor:
    """Normalized cxcywh -> xyxy in input pixels."""
    h, w = input_hw
    return cxcywh_to_xyxy(pred_boxes.float()) * torch.tensor(
        [w, h, w, h], dtype=torch.float32, device=pred_boxes.device)


def detr_postprocess(out: Dict[str, torch.Tensor], input_hw,
                     max_detections: int = 100) -> Detections:
    """Softmax scores with "no object" dropped, the best class a query, the
    top ``max_detections`` queries, boxes in input pixels (JAX :312)."""
    prob = torch.softmax(out["pred_logits"].float(), -1)[..., :-1]
    scores, classes = prob.max(-1)  # the first maximum, as jnp.argmax
    boxes = boxes_to_pixels(out["pred_boxes"], input_hw)
    top_scores, top_idx = stable_top_k(scores, max_detections)
    return Detections(
        boxes=boxes.gather(1, top_idx[..., None].expand(-1, -1, 4)),
        scores=top_scores,
        classes=classes.gather(1, top_idx).to(torch.int32),
        valid=top_scores > 0.0)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_detr_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """:func:`init_weights_` for the convolutions and linears, then with the
    same ``generator``: attention in-projections N(0, 1/E), query
    embeddings N(0, 1) (flax ``normal(1.0)``) and the raw parameters of
    AnchorDETR (anchor points U[0, 2), patterns N(0, 1)) and DAB-DETR
    (reference boxes U[0, 2)); LayerNorm and FrozenBN keep their identity
    initialisation."""
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, MultiheadAttention):
            m.in_proj_weight.normal_(0.0, m.embed_dim ** -0.5,
                                     generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
    if isinstance(getattr(model, "anchor_points", None), nn.Parameter):
        model.anchor_points.uniform_(0.0, 2.0, generator=generator)
    if isinstance(getattr(model, "pattern_embed", None), nn.Parameter):
        model.pattern_embed.normal_(0.0, 1.0, generator=generator)
    if isinstance(getattr(model, "ref_boxes", None), nn.Parameter):
        model.ref_boxes.uniform_(0.0, 2.0, generator=generator)


def finish_build(model: nn.Module, device, seed: int) -> nn.Module:
    """Weights from ``seed`` (drawn on the CPU), the model on ``device``
    in channels_last and eval mode, its dropout generator (``generator``,
    which AnchorDETR, without dropout, never draws from) on ``device``
    seeded with ``seed``."""
    init_detr_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    model.generator = torch.Generator(
        device=torch.device(device)).manual_seed(seed)
    return model.eval()


def check_detr_config(cfg, arch: str) -> None:
    if not isinstance(cfg, DetrConfig):
        raise NotImplementedError(
            f"{arch} takes a DetrConfig (DetrConfig.from_cfg of a merged "
            "CfgNode)")


@META_ARCH_REGISTRY.register(name="Detr")
def build_detr(cfg: DetrConfig, device="cuda", seed: int = 0) -> DETR:
    """DETR from a ``DetrConfig`` (JAX :335) with weights from ``seed``, on
    ``device``, channels_last, eval mode; ``cfg.layer_remat``
    (``MODEL.DETR.REMAT``, read by DETR alone, as in JAX)
    recomputes each transformer layer in the backward."""
    check_detr_config(cfg, "Detr")
    return finish_build(DETR(
        num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim,
        num_queries=cfg.num_queries, nheads=cfg.nheads,
        enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
        dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout,
        pre_norm=cfg.pre_norm, resnet_depth=cfg.resnet_depth,
        dtype=torch.bfloat16 if cfg.amp else torch.float32,
        layer_remat=cfg.layer_remat), device, seed)


def detr_loss_fn(cfg: DetrConfig):
    """The training loss of ``cfg`` (JAX ``engine.py:263-279``) in the
    train step's form ``loss_fn(out, batch, use_l1)``: focal for AnchorDETR
    or ``USE_FOCAL_LOSS``, deep supervision and the no-object weight from
    the config; a batch may hold ``match``, the stacked levels' assignment
    to take in place of the matcher's."""

    def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return detr_losses(out, batch, cfg.num_classes, cfg.input_size,
                           deep_supervision=cfg.deep_supervision,
                           eos_coef=cfg.no_object_weight,
                           use_focal=cfg.use_focal, match=batch.get("match"))

    return loss_fn
