"""The anchor-based YOLO head, its decode, targets and losses (JAX
``models/heads/anchor_yolo_head.py``).

The targets are a fixed-shape scatter, as in the JAX package: every (gt,
candidate anchor) pair gets a flat anchor index (or the overflow slot A),
and the dense maps come from scattering the candidates. Where two
candidates claim one anchor, the JAX package's ``.at[idx].set`` lets the
last write win on the CPU, and ``index_put_`` promises no order on CUDA;
so here each anchor takes the candidate of the largest position in the
JAX package's candidate order (``scatter_reduce`` with ``amax``), and the
gt is gathered from that position. The batch is a leading dimension where
the JAX package vmaps over images.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv
from yolov7_d2_tpu_torch.ops.iou import iou_loss, pairwise_box_iou
from yolov7_d2_tpu_torch.ops.losses import sigmoid_binary_cross_entropy
from yolov7_d2_tpu_torch.parallel.dist import all_reduce_sum
from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy

WH_LOGIT_MAX = 8.0  # exp clamp of the v3 decode (JAX :110)


class AnchorYOLOHead(nn.Module):
    """Per level: a 3x3 tower conv to twice the channels, then a 1x1
    prediction of ``num_anchors * (5 + num_classes)`` channels.
    ``direct_pred`` (YOLOV7P) predicts straight off the neck, no tower.
    Module names: ``towers.{l}`` and ``preds.{l}``."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 num_anchors: int = 3, act: str = "lrelu",
                 direct_pred: bool = False):
        super().__init__()
        out = num_anchors * (5 + num_classes)
        if direct_pred:
            self.towers = None
            self.preds = nn.ModuleList(nn.Conv2d(c, out, 1)
                                       for c in in_channels)
        else:
            self.towers = nn.ModuleList(BaseConv(c, 2 * c, 3, 1, act=act)
                                        for c in in_channels)
            self.preds = nn.ModuleList(nn.Conv2d(2 * c, out, 1)
                                       for c in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-level raw maps [B, na * (5 + C), H, W] in float32."""
        outs = []
        for lvl, x in enumerate(feats):
            if self.towers is not None:
                x = self.towers[lvl](x)
            outs.append(self.preds[lvl](x).float())
        return outs


def flatten_anchor_outputs(
    level_outputs: Sequence[torch.Tensor],
    anchors: Sequence[Sequence[Sequence[float]]],
    strides: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Per-level maps [B, na * (5 + C), H, W] -> ``outputs`` [B, A, 5 + C]
    with ``grids`` [A, 2] (cell x, y), ``strides`` [A] and ``anchors``
    [A, 2] (w, h in input pixels); A runs level, cell row-major, anchor.
    ``anchors`` is in level order (strides 8, 16, 32)."""
    outs, grids, stride_v, anch_v = [], [], [], []
    for out, lvl_anchors, stride in zip(level_outputs, anchors, strides):
        b, _, h, w = out.shape
        na = len(lvl_anchors)
        dev = out.device
        outs.append(out.permute(0, 2, 3, 1).reshape(b, h * w * na, -1))
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        g = torch.stack([xs, ys], dim=-1).reshape(h * w, 1, 2)
        grids.append(g.expand(h * w, na, 2).reshape(-1, 2))
        stride_v.append(torch.full((h * w * na,), float(stride),
                                   dtype=torch.float32, device=dev))
        a = torch.tensor(lvl_anchors, dtype=torch.float32, device=dev)
        anch_v.append(a.expand(h * w, na, 2).reshape(-1, 2))
    return {
        "outputs": torch.cat(outs, dim=1),
        "grids": torch.cat(grids, dim=0),
        "strides": torch.cat(stride_v, dim=0),
        "anchors": torch.cat(anch_v, dim=0),
    }


def decode_anchor_outputs(
    flat: Dict[str, torch.Tensor], variant: str = "yolov7"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw outputs -> (boxes cxcywh [B, A, 4], obj logits [B, A], cls
    logits [B, A, C]).

    v3: xy = (sigmoid(t) + grid) * stride, wh = exp(min(t, 8)) * anchor;
    v5 / v7: xy = (2 sigmoid(t) - 0.5 + grid) * stride,
    wh = (2 sigmoid(t))^2 * anchor.
    """
    out = flat["outputs"]
    grids, strides, anchors = flat["grids"], flat["strides"], flat["anchors"]
    if variant in ("yolov5", "yolov7"):
        xy = (2.0 * torch.sigmoid(out[..., 0:2]) - 0.5 + grids) \
            * strides[:, None]
        s = 2.0 * torch.sigmoid(out[..., 2:4])
        wh = s * s * anchors
    else:
        xy = (torch.sigmoid(out[..., 0:2]) + grids) * strides[:, None]
        wh = torch.exp(out[..., 2:4].clamp(max=WH_LOGIT_MAX)) * anchors
    return torch.cat([xy, wh], dim=-1), out[..., 4], out[..., 5:]


def _level_layout(level_hw: Sequence[Tuple[int, int]], na: int):
    """Flat-index layout: per level its offset, and the anchor count A."""
    offsets, off = [], 0
    for h, w in level_hw:
        offsets.append(off)
        off += h * w * na
    return offsets, off


def _last_write_wins(idx: torch.Tensor, gt_ids: torch.Tensor,
                     num_anchors: int) -> Dict[str, torch.Tensor]:
    """idx [B, N] flat anchor of each candidate (``num_anchors`` = the
    overflow slot), gt_ids [N] its gt -> ``fg_mask`` [B, A] and
    ``matched_gt`` [B, A] (0 where no candidate): each anchor takes its
    candidate of the largest position, the last write of the JAX
    ``.at[idx].set``."""
    b, n = idx.shape
    pos = torch.arange(n, device=idx.device).expand(b, n)
    win = torch.full((b, num_anchors + 1), -1, dtype=torch.long,
                     device=idx.device).scatter_reduce(
        1, idx, pos, "amax")[:, :num_anchors]
    fg = win >= 0
    matched = torch.where(fg, gt_ids[win.clamp(min=0)], 0)
    return {"fg_mask": fg, "matched_gt": matched}


def _gt_geometry(gt_boxes_xyxy: torch.Tensor):
    x0, y0, x1, y1 = gt_boxes_xyxy.unbind(-1)
    return (x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0


def build_targets_max_iou(
    gt_boxes_xyxy: torch.Tensor,    # [B, G, 4]
    gt_classes: torch.Tensor,       # [B, G]
    gt_valid: torch.Tensor,         # [B, G]
    anchors,                        # [L, na, 2] pixel anchor shapes
    level_hw: Sequence[Tuple[int, int]],
    level_strides: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """v3 / v4 assignment (JAX :125): each valid gt claims the one anchor
    shape of largest wh-IoU, at its centre cell. Returns [B, A] ``fg_mask``
    and ``matched_gt``."""
    dev = gt_boxes_xyxy.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    _, na, _ = anchors.shape
    offsets, a_total = _level_layout(level_hw, na)
    g_cx, g_cy, g_w, g_h = _gt_geometry(gt_boxes_xyxy)

    aw = anchors.reshape(-1, 2)                             # [L*na, 2]
    inter = torch.minimum(g_w[..., None], aw[:, 0]) * torch.minimum(
        g_h[..., None], aw[:, 1])
    union = g_w[..., None] * g_h[..., None] + aw[:, 0] * aw[:, 1] - inter
    best = torch.argmax(inter / (union + 1e-9), dim=-1)     # [B, G]
    lvl, k = best // na, best % na

    strides = torch.tensor(level_strides, dtype=torch.float32,
                           device=dev)[lvl]
    ws = torch.tensor([w for _, w in level_hw], device=dev)[lvl]
    hs = torch.tensor([h for h, _ in level_hw], device=dev)[lvl]
    cx = torch.minimum((g_cx / strides).to(torch.int32).clamp(min=0), ws - 1)
    cy = torch.minimum((g_cy / strides).to(torch.int32).clamp(min=0), hs - 1)
    off = torch.tensor(offsets, device=dev)[lvl]
    idx = off + (cy * ws + cx) * na + k                     # [B, G]
    idx = torch.where(gt_valid, idx, a_total)
    gt_ids = torch.arange(gt_boxes_xyxy.shape[1], device=dev)
    return _last_write_wins(idx, gt_ids, a_total)


def build_targets_ratio(
    gt_boxes_xyxy: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    anchors,
    level_hw: Sequence[Tuple[int, int]],
    level_strides: Sequence[int],
    ratio_thresh: float = 4.0,
) -> Dict[str, torch.Tensor]:
    """v5 / v7 assignment (JAX :175): a gt matches every anchor shape whose
    wh ratio is within ``ratio_thresh``, in its centre cell and the two
    nearest neighbour cells: up to G * L * na * 3 candidates, in the JAX
    order (cell, gt, anchor shape)."""
    dev = gt_boxes_xyxy.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    b, g_num, _ = gt_boxes_xyxy.shape
    n_lvl, na, _ = anchors.shape
    offsets, a_total = _level_layout(level_hw, na)
    g_cx, g_cy, g_w, g_h = _gt_geometry(gt_boxes_xyxy)

    aw = anchors.reshape(-1, 2)                             # [L*na, 2]
    rw = g_w[..., None] / (aw[:, 0] + 1e-9)
    rh = g_h[..., None] / (aw[:, 1] + 1e-9)
    ratio = torch.maximum(torch.maximum(rw, 1.0 / (rw + 1e-9)),
                          torch.maximum(rh, 1.0 / (rh + 1e-9)))
    anchor_ok = (ratio < ratio_thresh) & gt_valid[..., None]  # [B, G, L*na]

    lvl_of = torch.arange(n_lvl, device=dev).repeat_interleave(na)
    strides = torch.tensor(level_strides, dtype=torch.float32,
                           device=dev)[lvl_of]
    ws = torch.tensor([w for _, w in level_hw], device=dev)[lvl_of]
    hs = torch.tensor([h for h, _ in level_hw], device=dev)[lvl_of]
    off = torch.tensor(offsets, device=dev)[lvl_of]
    k_of = torch.arange(na, device=dev).repeat(n_lvl)

    fx = g_cx[..., None] / strides                          # [B, G, L*na]
    fy = g_cy[..., None] / strides
    cx0 = torch.floor(fx).to(torch.int32)
    cy0 = torch.floor(fy).to(torch.int32)
    dx = torch.where(fx - cx0 < 0.5, -1, 1)
    dy = torch.where(fy - cy0 < 0.5, -1, 1)
    all_idx = []
    for ccx, ccy in ((cx0, cy0), (cx0 + dx, cy0), (cx0, cy0 + dy)):
        inside = (ccx >= 0) & (ccx < ws) & (ccy >= 0) & (ccy < hs)
        flat = off + (ccy * ws + ccx) * na + k_of
        all_idx.append(torch.where(anchor_ok & inside, flat,
                                   a_total).reshape(b, -1))
    gt_ids = torch.arange(g_num, device=dev).repeat_interleave(
        n_lvl * na).repeat(3)
    return _last_write_wins(torch.cat(all_idx, dim=1), gt_ids, a_total)


def anchor_yolo_losses(
    flat: Dict[str, torch.Tensor],
    gt_boxes_xyxy: torch.Tensor,    # [B, G, 4]
    gt_classes: torch.Tensor,       # [B, G]
    gt_valid: torch.Tensor,         # [B, G]
    anchors,                        # [L, na, 2]
    level_hw: Sequence[Tuple[int, int]],
    level_strides: Sequence[int],
    num_classes: int,
    variant: str = "yolov7",
    build_target_type: str = "default",
    iou_type: str = "ciou",
    loss_type: str = "v7",
    ignore_threshold: float = 0.7,
    lambda_iou: float = 1.1,
    lambda_conf: float = 1.0,
    lambda_cls: float = 1.0,
    lambda_xy: float = 1.0,
    lambda_wh: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """The batch's losses (JAX :247). ``loss_type`` "v7": the IoU-family
    box loss of ``iou_type``; "v4": BCE on the xy cell offsets and MSE on
    the log-wh residuals of the raw outputs. Objectness skips the
    predictions (detached) that overlap a gt above ``ignore_threshold``
    and are not foreground. Inside a process group the foreground count is
    the global batch's, and every term this rank's share."""
    boxes_cxcywh, obj_logits, cls_logits = decode_anchor_outputs(flat,
                                                                 variant)
    pred_xyxy = cxcywh_to_xyxy(boxes_cxcywh)                # [B, A, 4]

    build = (build_targets_ratio if build_target_type == "yolov5"
             else build_targets_max_iou)
    with torch.no_grad():
        targets = build(gt_boxes_xyxy, gt_classes, gt_valid, anchors,
                        level_hw, level_strides)
    fg = targets["fg_mask"]                                 # [B, A]
    matched = targets["matched_gt"]
    fg_f = fg.float()
    num_fg = all_reduce_sum(fg_f.sum()).clamp(min=1.0)

    tgt_boxes = gt_boxes_xyxy.gather(1, matched[..., None].expand(-1, -1, 4))
    tgt_classes = gt_classes.gather(1, matched)

    with torch.no_grad():
        pair = pairwise_box_iou(pred_xyxy.detach(), gt_boxes_xyxy)
        pair = torch.where(gt_valid[:, None, :], pair, 0.0)  # [B, A, G]
        ignore = (pair.amax(dim=-1) > ignore_threshold) & ~fg

    if loss_type == "v4":
        raw = flat["outputs"][..., 0:4]
        grids, strides = flat["grids"], flat["strides"]
        anchors_v = flat["anchors"]
        tcx = (tgt_boxes[..., 0] + tgt_boxes[..., 2]) * 0.5
        tcy = (tgt_boxes[..., 1] + tgt_boxes[..., 3]) * 0.5
        tw = (tgt_boxes[..., 2] - tgt_boxes[..., 0]).clamp(min=1e-3)
        th = (tgt_boxes[..., 3] - tgt_boxes[..., 1]).clamp(min=1e-3)
        # xy target: the fractional offset inside the assigned cell
        tx = (tcx / strides - grids[:, 0]).clamp(0.0, 1.0)
        ty = (tcy / strides - grids[:, 1]).clamp(0.0, 1.0)
        loss_xy = ((sigmoid_binary_cross_entropy(raw[..., 0], tx)
                    + sigmoid_binary_cross_entropy(raw[..., 1], ty))
                   * fg_f).sum() / num_fg
        tw_t = torch.log(tw / (anchors_v[:, 0] + 1e-9))
        th_t = torch.log(th / (anchors_v[:, 1] + 1e-9))
        loss_wh = (0.5 * ((raw[..., 2] - tw_t) ** 2
                          + (raw[..., 3] - th_t) ** 2)
                   * fg_f).sum() / num_fg
        loss_box = lambda_xy * loss_xy + lambda_wh * loss_wh
    else:
        loss_box = lambda_iou * (iou_loss(pred_xyxy, tgt_boxes, iou_type)
                                 * fg_f).sum() / num_fg

    obj_bce = sigmoid_binary_cross_entropy(obj_logits, fg_f)
    loss_obj = (obj_bce * torch.where(ignore, 0.0, 1.0)).sum() / num_fg

    # one-hot as jax.nn.one_hot: a class outside [0, C) is all zeros
    cls_t = (tgt_classes[..., None] == torch.arange(
        num_classes, device=tgt_classes.device)).float()
    loss_cls = (sigmoid_binary_cross_entropy(cls_logits, cls_t)
                * fg_f[..., None]).sum() / num_fg

    losses = {
        "loss_box": loss_box,
        "loss_obj": lambda_conf * loss_obj,
        "loss_cls": lambda_cls * loss_cls,
        "num_fg": num_fg,
    }
    losses["total_loss"] = (losses["loss_box"] + losses["loss_obj"]
                            + losses["loss_cls"])
    return losses
