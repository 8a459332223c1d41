"""YOLOX decoupled head, grid decode, SimOTA and the losses (JAX
``models/heads/yolox_head.py``).

Module names follow the original reference (``stems.l``, ``cls_convs.l.i``,
``reg_convs.l.i``, ``{cls,reg,obj}_preds.l``).

SimOTA and the losses take the batch as a leading dimension where the JAX
package vmaps over images, and reproduce its arithmetic where the obvious
PyTorch idiom would differ: the dynamic-k top-10 and the k-th cost come
from repeated max / min extraction that removes every value tied with the
extremum at once (``torch.topk`` would count ties separately), and the
class cost rounds its logs to bf16 as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv, conv_class
from yolov7_d2_tpu_torch.ops.iou import iou_loss, pairwise_box_iou
from yolov7_d2_tpu_torch.ops.losses import sigmoid_binary_cross_entropy
from yolov7_d2_tpu_torch.parallel.dist import all_reduce_sum
from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy

WH_LOGIT_MAX = 11.09  # exp clamp of the JAX decode (yolox_head.py:119)
BIG_COST = 1e5


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int = 80, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        self.strides = tuple(strides)
        hidden = int(256 * width)
        conv = conv_class(depthwise)

        def tower():
            return nn.Sequential(conv(hidden, hidden, 3, 1, act=act),
                                 conv(hidden, hidden, 3, 1, act=act))

        self.stems = nn.ModuleList(
            BaseConv(int(c * width), hidden, 1, 1, act=act)
            for c in in_channels
        )
        self.cls_convs = nn.ModuleList(tower() for _ in in_channels)
        self.reg_convs = nn.ModuleList(tower() for _ in in_channels)
        self.cls_preds = nn.ModuleList(
            nn.Conv2d(hidden, num_classes, 1) for _ in in_channels)
        self.reg_preds = nn.ModuleList(
            nn.Conv2d(hidden, 4, 1) for _ in in_channels)
        self.obj_preds = nn.ModuleList(
            nn.Conv2d(hidden, 1, 1) for _ in in_channels)

    def level_outputs(self, lvl: int, x: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """Level ``lvl``'s raw predictions, NCHW, from its stem's output
        ``x``: ``outputs`` (tx, ty, tw, th, obj, cls...)."""
        c = self.cls_convs[lvl](x)
        r = self.reg_convs[lvl](x)
        return {"outputs": torch.cat([self.reg_preds[lvl](r),
                                      self.obj_preds[lvl](r),
                                      self.cls_preds[lvl](c)], dim=1)}

    def forward(self, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """feats: per-level features, strides 8/16/32.

        Returns ``outputs`` [B, A, 5 + C] raw (tx, ty, tw, th, obj, cls...)
        in the compute dtype, ``grids`` [A, 2] f32 cell (x, y), ``strides``
        [A] f32; anchors row-major per level, level-major overall.
        """
        flat, grids, strides = {}, [], []
        for lvl, (x, stride) in enumerate(zip(feats, self.strides)):
            x = self.stems[lvl](x)
            b, _, h, w = x.shape
            for key, out in self.level_outputs(lvl, x).items():
                flat.setdefault(key, []).append(
                    out.permute(0, 2, 3, 1).reshape(b, h * w, -1))
            grid, stride_vec = level_grid(h, w, stride, x.device)
            grids.append(grid)
            strides.append(stride_vec)
        return {
            **{key: torch.cat(outs, dim=1) for key, outs in flat.items()},
            "grids": torch.cat(grids, dim=0),
            "strides": torch.cat(strides, dim=0),
        }


def level_grid(h: int, w: int, stride: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cells (x, y) [h w, 2] of a level, row-major, and its stride
    [h w], both float32."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return (torch.stack([xs, ys], dim=-1).reshape(h * w, 2),
            torch.full((h * w,), float(stride), dtype=torch.float32,
                       device=device))


def decode_outputs(
    outputs: torch.Tensor, grids: torch.Tensor, strides: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw outputs -> (boxes cxcywh [.., A, 4], obj logits [.., A], cls
    logits [.., A, C]) in input pixels, f32."""
    outputs = outputs.float()
    xy = (outputs[..., 0:2] + grids) * strides[..., None]
    wh = torch.exp(outputs[..., 2:4].clamp(max=WH_LOGIT_MAX)) \
        * strides[..., None]
    return torch.cat([xy, wh], dim=-1), outputs[..., 4], outputs[..., 5:]


def _geometry_prior(
    grids: torch.Tensor, strides: torch.Tensor, gt_boxes_xyxy: torch.Tensor,
    center_radius: float = 2.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre prior: grids [..., A, 2], strides [..., A], gt boxes
    [..., G, 4] -> (in_box, in_center), bool [..., G, A]."""
    centers = (grids + 0.5) * strides[..., None]            # [..., A, 2]
    cx = centers[..., None, :, 0]                           # [..., 1, A]
    cy = centers[..., None, :, 1]
    x0, y0 = gt_boxes_xyxy[..., 0:1], gt_boxes_xyxy[..., 1:2]  # [..., G, 1]
    x1, y1 = gt_boxes_xyxy[..., 2:3], gt_boxes_xyxy[..., 3:4]
    in_box = (cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1)
    gcx = (x0 + x1) * 0.5
    gcy = (y0 + y1) * 0.5
    r = center_radius * strides[..., None, :]
    in_center = ((cx >= gcx - r) & (cx <= gcx + r) & (cy >= gcy - r)
                 & (cy <= gcy + r))
    return in_box, in_center


def _prefilter_key(cand_any: torch.Tensor,
                   obj_logits: torch.Tensor) -> torch.Tensor:
    """Ranking key, exact in float32: the candidate flag (2) above the
    objectness logit normalised into [0, 1] per image. [..., A]."""
    lo = obj_logits.amin(-1, keepdim=True)
    span = obj_logits.amax(-1, keepdim=True) - lo
    obj_n = (obj_logits - lo) / span.clamp(min=1e-12)
    return cand_any.float() * 2.0 + obj_n


def simota_assign(
    pred_boxes_cxcywh: torch.Tensor,  # [B, A, 4]
    obj_logits: torch.Tensor,         # [B, A]
    cls_logits: torch.Tensor,         # [B, A, C]
    grids: torch.Tensor,              # [A, 2] or [B, A, 2]
    strides: torch.Tensor,            # [A] or [B, A]
    gt_boxes_xyxy: torch.Tensor,      # [B, G, 4]
    gt_classes: torch.Tensor,         # [B, G]
    gt_valid: torch.Tensor,           # [B, G] bool
    topk_candidates: int = 10,
) -> Dict[str, torch.Tensor]:
    """SimOTA over a batch, all shapes static (JAX ``simota_assign`` with
    ``prefilter_topk=None``; ``yolox_losses`` prefilters the batch itself).
    Returns fg_mask [B, A], matched_gt [B, A] (index into G), matched_iou
    [B, A] and num_fg [B]."""
    in_box, in_center = _geometry_prior(grids, strides, gt_boxes_xyxy)
    candidate = (in_box | in_center) & gt_valid[..., None]   # [B, G, A]
    return _simota_core(
        cxcywh_to_xyxy(pred_boxes_cxcywh), obj_logits, cls_logits, candidate,
        in_box & in_center, gt_boxes_xyxy, gt_classes, gt_valid,
        topk_candidates)


def _simota_core(
    pred_xyxy: torch.Tensor,          # [B, A, 4]
    obj_logits: torch.Tensor,         # [B, A]
    cls_logits: torch.Tensor,         # [B, A, C]
    candidate: torch.Tensor,          # [B, G, A]
    both: torch.Tensor,               # [B, G, A]
    gt_boxes_xyxy: torch.Tensor,      # [B, G, 4]
    gt_classes: torch.Tensor,         # [B, G]
    gt_valid: torch.Tensor,           # [B, G]
    topk_candidates: int,
) -> Dict[str, torch.Tensor]:
    pair_iou = pairwise_box_iou(gt_boxes_xyxy, pred_xyxy)      # [B, G, A]
    pair_iou = torch.where(gt_valid[..., None], pair_iou, 0.0)
    iou_cost = -torch.log(pair_iou + 1e-8)

    # class cost: BCE(sqrt(cls_prob * obj_prob), one-hot) summed over C.
    # The JAX package rounds log p, log(1 - p) and the one-hot to bf16 and
    # contracts them with f32 accumulation. Products of bf16 values are
    # exact in f32, so the same numbers come from f32 arithmetic on the
    # rounded logs without a matrix product (and so without TF32 on the
    # card): the one-hot picks log p of the gt's class, and the sum of
    # log(1 - p) over the other classes is the sum over all of them less
    # the gt's class. Only the order of the f32 sum differs from JAX's.
    joint = torch.sqrt(torch.sigmoid(cls_logits)
                       * torch.sigmoid(obj_logits)[..., None])
    joint = joint.clamp(1e-8, 1.0 - 1e-8)                       # [B, A, C]
    log_p = torch.log(joint).to(torch.bfloat16).float()
    log_1p = torch.log1p(-joint).to(torch.bfloat16).float()
    cls_idx = gt_classes.long()[:, None, :].expand(-1, log_p.shape[1], -1)
    pos = log_p.gather(2, cls_idx).transpose(1, 2)             # [B, G, A]
    neg = log_1p.sum(-1)[:, None, :] - log_1p.gather(2, cls_idx).transpose(
        1, 2)
    cls_cost = -(pos + neg)

    cost = (cls_cost + 3.0 * iou_cost + BIG_COST * (~both).float()
            + 10.0 * BIG_COST * (~candidate).float())

    # dynamic k: k = clamp(int(sum of the top-10 candidate IoUs), 1, 10);
    # each pass removes every value tied with the max, so ties count once
    cur = torch.where(candidate, pair_iou, 0.0)
    iou_sum = torch.zeros_like(cur[..., 0])
    for _ in range(topk_candidates):
        m = cur.amax(-1)                                        # [B, G]
        iou_sum = iou_sum + m.clamp(min=0.0)
        cur = torch.where(cur >= m[..., None], float("-inf"), cur)
    dynamic_ks = iou_sum.to(torch.int32).clamp(1, topk_candidates)

    # the dynamic_k-th smallest cost of each gt by min extraction, ties
    # removed together; ``cost <= kth`` then keeps every tied anchor
    cur = cost
    mins = []
    for _ in range(topk_candidates):
        m = cur.amin(-1)
        mins.append(m)
        cur = torch.where(cur <= m[..., None], float("inf"), cur)
    kth = torch.stack(mins).gather(0, (dynamic_ks - 1).long()[None])[0]
    matching = (cost <= kth[..., None]) & candidate             # [B, G, A]

    # an anchor claimed by several gts keeps the one of least cost, the
    # first on ties
    multi = matching.sum(-2) > 1                                # [B, A]
    best_gt = torch.where(matching, cost, float("inf")).argmin(-2)
    keep = F.one_hot(best_gt, matching.shape[-2]).transpose(-1, -2).bool()
    matching = torch.where(multi[:, None, :], matching & keep, matching)

    fg_mask = matching.any(-2)                                  # [B, A]
    matched_gt = matching.to(torch.uint8).argmax(-2)            # first True
    # at most one True a column now: the masked sum is the matched IoU
    matched_iou = torch.where(matching, pair_iou, 0.0).sum(-2)
    return {
        "fg_mask": fg_mask,
        "matched_gt": matched_gt,
        "matched_iou": torch.where(fg_mask, matched_iou, 0.0),
        "num_fg": fg_mask.float().sum(-1),
    }


def yolox_losses(
    head_out: Dict[str, torch.Tensor],
    gt_boxes_xyxy: torch.Tensor,   # [B, G, 4]
    gt_classes: torch.Tensor,      # [B, G]
    gt_valid: torch.Tensor,        # [B, G]
    num_classes: int,
    use_l1: bool = False,
    prefilter_topk: Optional[int] = 2048,
) -> Dict[str, torch.Tensor]:
    """Batch loss of the JAX ``yolox_losses``: IoU (weight 5), objectness
    and class BCE, optional L1, normalised by the batch's foreground count
    (inside a process group, the global batch's). The assignment runs
    without gradient.

    With ``prefilter_topk`` K below the anchor count A, one row gather of
    the head outputs keeps each image's top K anchors by
    ``_prefilter_key``, re-sorted by position, and SimOTA and the
    per-anchor losses run on them; the objectness target is scattered back
    over all A. Exact while every candidate fits in K, as in the JAX
    package. Where ``torch.topk`` and ``jax.lax.top_k`` may keep different
    members among tied keys, those are non-candidates (a candidate's key
    is at least 2, a non-candidate's at most 1) while the candidates fit in
    K: a non-candidate is never matched, only matched anchors enter the
    IoU, class and L1 terms, and the objectness term covers all A anyway,
    so the losses do not change.
    """
    outputs = head_out["outputs"]            # [B, A, 5+C]
    grids = head_out["grids"]                # [A, 2]
    strides = head_out["strides"]            # [A]
    b, a_total, width = outputs.shape

    if prefilter_topk is not None and prefilter_topk < a_total:
        with torch.no_grad():
            in_box, in_center = _geometry_prior(grids, strides,
                                                gt_boxes_xyxy)
            cand_any = ((in_box | in_center) & gt_valid[..., None]).any(-2)
            sel = _prefilter_key(cand_any, outputs[..., 4].float())
            top_idx = torch.topk(sel, prefilter_topk, dim=-1).indices
            top_idx = top_idx.sort(dim=-1).values                # [B, K]
        out_k = outputs.gather(
            1, top_idx[..., None].expand(-1, -1, width)).float()
        grids_k = grids[top_idx]                                 # [B, K, 2]
        strides_k = strides[top_idx]                             # [B, K]
    else:
        top_idx = None
        out_k = outputs.float()
        grids_k, strides_k = grids, strides
    boxes_cxcywh, obj_logits, cls_logits = decode_outputs(out_k, grids_k,
                                                          strides_k)
    with torch.no_grad():
        assign = simota_assign(boxes_cxcywh, obj_logits, cls_logits, grids_k,
                               strides_k, gt_boxes_xyxy, gt_classes, gt_valid)

    fg_f = assign["fg_mask"].float()                             # [B, K|A]
    matched_gt = assign["matched_gt"]
    # inside a process group the count of the global batch (JAX divides by
    # the count of the batch its mesh holds): every term below is then
    # this rank's share of the global loss
    num_fg = all_reduce_sum(assign["num_fg"].sum()).clamp(min=1.0)

    # a gather is exact, as the JAX one-hot product at precision highest is
    tgt_boxes = gt_boxes_xyxy.gather(
        1, matched_gt[..., None].expand(-1, -1, 4))              # [B, K, 4]
    tgt_cls_1h = F.one_hot(gt_classes.long().gather(1, matched_gt),
                           num_classes).float()                  # [B, K, C]

    loss_iou = (iou_loss(cxcywh_to_xyxy(boxes_cxcywh), tgt_boxes, "iou")
                * fg_f).sum() / num_fg

    # objectness over all A anchors, target = fg (scattered back to A)
    if top_idx is not None:
        obj_target = torch.zeros((b, a_total), device=outputs.device).scatter(
            1, top_idx, fg_f)
        loss_obj = sigmoid_binary_cross_entropy(
            outputs[..., 4].float(), obj_target).sum() / num_fg
    else:
        loss_obj = sigmoid_binary_cross_entropy(obj_logits,
                                                fg_f).sum() / num_fg

    cls_target = tgt_cls_1h * assign["matched_iou"][..., None]
    loss_cls = (sigmoid_binary_cross_entropy(cls_logits, cls_target)
                * fg_f[..., None]).sum() / num_fg

    losses = {
        "loss_iou": 5.0 * loss_iou,
        "loss_obj": loss_obj,
        "loss_cls": loss_cls,
    }
    if use_l1:
        # L1 of the raw regression outputs against the encoded targets
        tgt_cxcywh = torch.cat([(tgt_boxes[..., 0:2] + tgt_boxes[..., 2:4])
                                * 0.5,
                                tgt_boxes[..., 2:4] - tgt_boxes[..., 0:2]],
                               dim=-1)
        l1_target = torch.cat([
            tgt_cxcywh[..., 0:2] / strides_k[..., None] - grids_k,
            torch.log(tgt_cxcywh[..., 2:4] / strides_k[..., None] + 1e-8),
        ], dim=-1)
        losses["loss_l1"] = (torch.abs(out_k[..., 0:4] - l1_target)
                             * fg_f[..., None]).sum() / num_fg
    losses["total_loss"] = sum(losses.values())
    losses["num_fg"] = num_fg
    return losses
