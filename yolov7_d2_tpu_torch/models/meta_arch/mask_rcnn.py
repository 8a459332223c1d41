"""Mask R-CNN and Faster R-CNN (JAX ``models/meta_arch/mask_rcnn.py``): the
anchors and box deltas, the model, its losses in both sampling modes and
its serving tail.

``MaskRCNN.forward`` takes the letterboxed NHWC batch. A uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) with detectron2's
BGR mean and std that the JAX model hard-codes (:131-132, SparseInst's
statistics too); then ``ResNetFPN`` (FrozenBN, p2-p6, ``necks/fpn.py``), in
bf16 under autocast over float32 parameters where the config asks for AMP.
Panoptic FPN passes its own pyramid (``feats=``) and the model builds no
backbone (``with_backbone=False``).

* The RPN: one 3x3 conv + ReLU shared by p2-p6 and the 1x1 objectness and
  delta convs, their outputs in float32; three anchors a cell (aspects 0.5,
  1, 2 of sizes 32-512, :func:`level_anchors`). A level's
  ``pre_nms_topk`` best raw logits in ``jax.lax.top_k``'s order (ties by
  index, ROADMAP.md C.4), their boxes decoded and clipped to the image, the
  sigmoid, zero for a box narrower than 0.01 px, then class-agnostic NMS at
  0.7 over the 5 k candidates to ``num_proposals`` through the NMS kernel
  (``kernels/nms.py``; 1280 candidates at 1024 px). The proposals take no
  gradient.
* The box head: each proposal pooled 7x7 from its level
  (``ops/roi_align.pool_proposals``) in float32, flattened as (S, S, C)
  (the JAX order, which ``box_fc1``'s flax kernel reads), two FC-1024 +
  ReLU, ``cls_score`` (C + 1) and ``bbox_pred`` (one delta row a class, or
  one row with ``cls_agnostic_bbox_reg``), in float32 as the JAX Dense
  layers compute.
* The mask head: 14x14 pools (float32, then the compute dtype), four
  256-channel 3x3 convs + ReLU, the 2x2 stride-2 transposed conv + ReLU
  and ``mask_pred`` in float32: ``mask_logits`` [B, P, 28, 28, C].

Parameter names are the flax ones (``backbone.bottom_up`` the detectron2
ResNet, ``backbone.fpn.lateral_{i}`` / ``output_{i}``, ``rpn_conv``,
``rpn_obj``, ``rpn_delta``, ``box_fc1``, ``box_fc2``, ``cls_score``,
``bbox_pred``, ``mask_conv_{i}``, ``mask_deconv``, ``mask_pred``), so that
``utils/weight_port.py`` ``map_mask_rcnn_torch_name`` applies.

The losses (:func:`mask_rcnn_losses`, JAX :287) are batched: every image at
once where the JAX package maps one image. In ``"sampled"`` mode (the
``ROI_HEADS.SAMPLE_MODE`` default) the subsets are drawn from uniforms,
four a image (RPN positives and negatives over the anchors, ROI positives
and negatives over the proposals), which the caller passes
(``uniforms``) or which come from ``generator``. Each valid GT owns its
best anchor by an ``amax`` scatter; the JAX scatter (:337-340) also
writes anchor 0's own value for every invalid GT, which races a valid
GT whose best anchor is anchor 0 (ROADMAP.md C.39).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.rcnn import RcnnConfig
from yolov7_d2_tpu_torch.kernels.nms import nms_batched
from yolov7_d2_tpu_torch.kernels.preprocess import (
    normalize_images,
    normalize_images_plain,
)
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.meta_arch.detr import stable_top_k
from yolov7_d2_tpu_torch.models.necks.fpn import ResNetFPN
from yolov7_d2_tpu_torch.ops.iou import pairwise_box_iou
from yolov7_d2_tpu_torch.ops.losses import sigmoid_binary_cross_entropy
from yolov7_d2_tpu_torch.ops.nms import batched_nms_batched
from yolov7_d2_tpu_torch.ops.roi_align import pool_proposals, roi_align_levels
from yolov7_d2_tpu_torch.structures.instances import Detections

# detectron2's BGR statistics (JAX :131-132)
PIXEL_MEAN = (103.53, 116.28, 123.675)
PIXEL_STD = (57.375, 57.12, 58.395)
RPN_LEVELS = ("p2", "p3", "p4", "p5", "p6")
RPN_STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECTS = (0.5, 1.0, 2.0)
ROI_LEVELS = ("p2", "p3", "p4", "p5")
ROI_STRIDES = (4, 8, 16, 32)
ROI_DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
MASK_CHANNELS = 256
GT_MASK_SIZE = 28


def level_anchors(h: int, w: int, stride: int, size: int) -> np.ndarray:
    """[h*w*3, 4] xyxy float32 anchors of one level, cell-major, three
    aspects a cell (JAX ``_level_anchors``, :47)."""
    ys = (np.arange(h) + 0.5) * stride
    xs = (np.arange(w) + 0.5) * stride
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers = np.stack([cx, cy], -1).reshape(-1, 1, 2)
    whs = np.array([[size * np.sqrt(a), size / np.sqrt(a)] for a in ASPECTS],
                   np.float32).reshape(1, -1, 2)
    return np.concatenate([centers - whs / 2, centers + whs / 2],
                          -1).reshape(-1, 4).astype(np.float32)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """detectron2's Box2BoxTransform decode, dw and dh clipped to +-4 (JAX
    :65)."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, -4.0, 4.0)
    dh = torch.clamp(deltas[..., 3] / wh, -4.0, 4.0)
    cx = ax + dx * aw
    cy = ay + dy * ah
    bw = aw * torch.exp(dw)
    bh = ah * torch.exp(dh)
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       -1)


def encode_deltas(anchors: torch.Tensor, boxes: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """The inverse of :func:`decode_deltas`, widths floored at 1e-4 (JAX
    :87)."""
    wx, wy, ww, wh = weights
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1e-4)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1e-4)
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-4)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-4)
    bx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    by = (boxes[..., 1] + boxes[..., 3]) * 0.5
    return torch.stack([wx * (bx - ax) / aw, wy * (by - ay) / ah,
                        ww * torch.log(bw / aw), wh * torch.log(bh / ah)],
                       -1)


@functools.lru_cache(maxsize=None)
def _device_anchors(h: int, w: int, stride: int, size: int,
                    device: torch.device) -> torch.Tensor:
    return torch.from_numpy(level_anchors(h, w, stride, size)).to(device)


def device_anchors(h: int, w: int, stride: int, size: int,
                   device: torch.device) -> torch.Tensor:
    """:func:`level_anchors` on ``device``, made once a shape (a copy from
    the host waits for the card's queue), except while ``torch.export``
    traces (its tensors are the tracer's, and would stay in the cache)."""
    make = (_device_anchors.__wrapped__ if torch.compiler.is_compiling()
            else _device_anchors)
    return make(h, w, stride, size, device)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] at idx [B, K] -> [B, K, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class MaskRCNN(nn.Module):
    """normalize -> ResNetFPN -> RPN -> NMS -> box head (and mask head)
    (JAX :108). ``dtype`` is the compute dtype: bfloat16 runs under
    autocast over float32 parameters."""

    def __init__(self, num_classes: int = 80, resnet_depth: int = 50,
                 fpn_channels: int = 256, mask_on: bool = True,
                 num_proposals: int = 128, pre_nms_topk: int = 256,
                 roi_size: int = 7, mask_pool_size: int = 14,
                 fc_dim: int = 1024, cls_agnostic_bbox_reg: bool = False,
                 with_backbone: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.mask_on = mask_on
        self.num_proposals = num_proposals
        self.pre_nms_topk = pre_nms_topk
        self.roi_size = roi_size
        self.mask_pool_size = mask_pool_size
        self.cls_agnostic_bbox_reg = cls_agnostic_bbox_reg
        self.dtype = dtype
        # the sampled losses' source (engine.build_system reseeds it a step)
        self.generator: Optional[torch.Generator] = None
        if with_backbone:
            self.backbone = ResNetFPN(resnet_depth, fpn_channels)
        a = len(ASPECTS)
        self.rpn_conv = nn.Conv2d(fpn_channels, fpn_channels, 3, 1, 1)
        self.rpn_obj = nn.Conv2d(fpn_channels, a, 1)
        self.rpn_delta = nn.Conv2d(fpn_channels, a * 4, 1)
        self.box_fc1 = nn.Linear(roi_size * roi_size * fpn_channels, fc_dim)
        self.box_fc2 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(
            fc_dim, 4 if cls_agnostic_bbox_reg else num_classes * 4)
        if mask_on:
            for i in range(4):
                self.add_module(f"mask_conv_{i}", nn.Conv2d(
                    fpn_channels if i == 0 else MASK_CHANNELS,
                    MASK_CHANNELS, 3, 1, 1))
            self.mask_deconv = nn.ConvTranspose2d(MASK_CHANNELS,
                                                  MASK_CHANNELS, 2, 2)
            self.mask_pred = nn.Conv2d(MASK_CHANNELS, num_classes, 1)

    def _normalized(self, images: torch.Tensor) -> torch.Tensor:
        norm = (normalize_images if images.dtype == torch.uint8
                else normalize_images_plain)
        return norm(images, PIXEL_MEAN, PIXEL_STD, self.dtype)

    def forward(self, images: torch.Tensor,
                feats: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, object]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch;
        ``feats``: a precomputed pyramid (p2-p6, NCHW) in place of the
        backbone's."""
        b, img_h, img_w = images.shape[:3]
        dev = images.device
        amp = self.dtype == torch.bfloat16
        with torch.autocast(dev.type, dtype=self.dtype, enabled=amp):
            if feats is None:
                feats = self.backbone(self._normalized(images))
            obj_all, delta_all, anchor_all = [], [], []
            for name, stride, size in zip(RPN_LEVELS, RPN_STRIDES,
                                          ANCHOR_SIZES):
                f = F.relu(self.rpn_conv(feats[name]))
                fh, fw = f.shape[2:]
                obj_all.append(self.rpn_obj(f).float().permute(0, 2, 3, 1)
                               .reshape(b, -1))
                delta_all.append(self.rpn_delta(f).float()
                                 .permute(0, 2, 3, 1).reshape(b, -1, 4))
                anchor_all.append(device_anchors(fh, fw, stride, size,
                                                 dev))

        # proposals: a level's top-k -> decode -> NMS -> P a image
        top_boxes, top_scores = [], []
        with torch.no_grad():
            for obj, dl, anc in zip(obj_all, delta_all, anchor_all):
                k = min(self.pre_nms_topk, obj.shape[1])
                sc, idx = stable_top_k(obj.detach(), k)
                boxes = decode_deltas(anc[idx], _gather_rows(dl.detach(),
                                                             idx))
                top_boxes.append(torch.stack(
                    [boxes[..., 0].clamp(0, img_w), boxes[..., 1].clamp(
                        0, img_h), boxes[..., 2].clamp(0, img_w),
                     boxes[..., 3].clamp(0, img_h)], -1))
                top_scores.append(sc)
            cand_boxes = torch.cat(top_boxes, 1).contiguous()
            cand_scores = torch.sigmoid(torch.cat(top_scores, 1))
            wh_ok = ((cand_boxes[..., 2] - cand_boxes[..., 0] > 1e-2)
                     & (cand_boxes[..., 3] - cand_boxes[..., 1] > 1e-2))
            cand_scores = torch.where(wh_ok, cand_scores, 0.0).contiguous()
            keep_idx, keep_valid = nms_batched(cand_boxes, cand_scores, 0.7,
                                               self.num_proposals)
            sel = keep_idx.long().clamp(min=0)
            prop_boxes = _gather_rows(cand_boxes, sel)
            prop_scores = torch.where(keep_valid,
                                      _gather_rows(cand_scores, sel), 0.0)

        # the box head, float32 over the pooled levels
        levels = [feats[k].permute(0, 2, 3, 1) for k in ROI_LEVELS]
        sizes = (self.roi_size,) + ((self.mask_pool_size,) if self.mask_on
                                    else ())
        with torch.autocast(dev.type, enabled=False):
            pooled = pool_proposals(levels, prop_boxes, sizes, ROI_STRIDES)
            flat = pooled[0].reshape(b, self.num_proposals, -1)
            h2 = F.relu(self.box_fc2(F.relu(self.box_fc1(flat))))
            cls_logits = self.cls_score(h2)
            box_deltas = self.bbox_pred(h2)
        if not self.cls_agnostic_bbox_reg:
            box_deltas = box_deltas.reshape(b, self.num_proposals,
                                            self.num_classes, 4)
        out = {
            "rpn_obj": torch.cat(obj_all, 1),
            "rpn_deltas": torch.cat(delta_all, 1),
            "anchors": torch.cat(anchor_all, 0),
            "proposals": prop_boxes,
            "proposal_scores": prop_scores,
            "proposal_valid": keep_valid,
            "cls_logits": cls_logits,
            "box_deltas": box_deltas,
            "image_hw": (img_h, img_w),
        }
        if self.mask_on:
            s = self.mask_pool_size
            m = pooled[1].reshape(b * self.num_proposals, s, s, -1).permute(
                0, 3, 1, 2).to(self.dtype)
            with torch.autocast(dev.type, dtype=self.dtype, enabled=amp):
                for i in range(4):
                    m = F.relu(getattr(self, f"mask_conv_{i}")(m))
                m = F.relu(self.mask_deconv(m))
            with torch.autocast(dev.type, enabled=False):
                mlogits = self.mask_pred(m.float())
            out["mask_logits"] = mlogits.permute(0, 2, 3, 1).reshape(
                b, self.num_proposals, 2 * s, 2 * s, self.num_classes)
        return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def random_subset_mask(eligible: torch.Tensor, n_take: torch.Tensor,
                       uniforms: torch.Tensor) -> torch.Tensor:
    """``min(n_take, eligible.sum())`` of the True positions of each row of
    ``eligible`` [B, N], those whose uniform [B, N] ranks first: a stable
    descending sort of ``2 eligible + u`` in float32, as JAX
    ``_random_subset_mask`` (:273) sorts its negation."""
    key = -(eligible.float() * 2.0 + uniforms)
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device)
                  .expand_as(order))
    total = eligible.sum(-1)
    take = (torch.minimum(total, n_take) if torch.is_tensor(n_take)
            else total.clamp(max=n_take))
    return eligible & (rank < take[:, None])


def draw_uniforms(generator: torch.Generator, b: int, a: int, p: int,
                  device) -> Tuple[torch.Tensor, ...]:
    """The sampled mode's four uniforms: RPN positives and negatives [B,
    A], ROI positives and negatives [B, P]."""
    return tuple(torch.rand((b, n), generator=generator, device=device)
                 for n in (a, a, p, p))


def crop_gt_masks(gt_masks: torch.Tensor, gt_index: torch.Tensor,
                  boxes: torch.Tensor, size: int = GT_MASK_SIZE
                  ) -> torch.Tensor:
    """Each proposal's matched GT mask ``gt_masks[b, gt_index[b, p]]`` (any
    dtype, [B, G, H, W]) cropped at its box to ``size`` x ``size`` by
    :func:`ops.roi_align.roi_align` (scale 1) -> float32 [B, P, size,
    size] (JAX :421-426)."""
    b, g, h, w = gt_masks.shape
    p = gt_index.shape[1]
    plane = (torch.arange(b, device=boxes.device)[:, None] * g
             + gt_index.long()).reshape(-1)
    zeros = torch.zeros_like(plane)
    with torch.no_grad():
        crops = roi_align_levels([gt_masks.reshape(b * g, h, w, 1)],
                                 boxes.reshape(-1, 4), plane, zeros, [1.0],
                                 size)
    return crops.reshape(b, p, size, size)


def mask_rcnn_losses(
    out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
    num_classes: int, rpn_pos_iou: float = 0.7, rpn_neg_iou: float = 0.3,
    roi_pos_iou: float = 0.5, sample_mode: str = "expectation",
    rpn_batch: int = 256, rpn_pos_frac: float = 0.5, roi_batch: int = 512,
    roi_pos_frac: float = 0.25,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The RPN, box and mask losses (JAX :287), every image at once, each
    term the mean of the images'. ``"expectation"``: every anchor and valid
    proposal weighted by its match; ``"sampled"``: detectron2's random
    fixed-size subsets (``rpn_batch`` anchors at ``rpn_pos_frac`` positives,
    ``roi_batch`` proposals at ``roi_pos_frac``), drawn from ``uniforms``
    (:func:`draw_uniforms`'s four) or from ``generator``. Per-class
    ``box_deltas`` take the matched class's row."""
    sampled = sample_mode == "sampled"
    gt_boxes = batch["gt_boxes"].float()
    gt_classes = batch["gt_classes"].long()
    gval = batch["gt_valid"].bool()
    anchors = out["anchors"]
    b = gt_boxes.shape[0]
    rpn_obj, rpn_deltas = out["rpn_obj"], out["rpn_deltas"]
    props, prop_valid = out["proposals"], out["proposal_valid"]
    cls_logits, box_deltas = out["cls_logits"], out["box_deltas"]
    if sampled and uniforms is None:
        if generator is None:
            raise ValueError("sample_mode='sampled' requires uniforms or a "
                             "generator")
        uniforms = draw_uniforms(generator, b, anchors.shape[0],
                                 props.shape[1], anchors.device)

    # ---------------- RPN
    ious = pairwise_box_iou(anchors, gt_boxes)                # [B, A, G]
    ious = torch.where(gval[:, None, :], ious, 0.0)
    best_iou, best_gt = ious.max(-1)
    is_fg = best_iou >= rpn_pos_iou
    # every valid gt owns its best anchor
    best_anchor = ious.argmax(1)                              # [B, G]
    owned = torch.zeros_like(is_fg, dtype=torch.uint8).scatter_reduce(
        1, best_anchor, gval.to(torch.uint8), "amax")
    is_fg = is_fg | owned.bool()
    is_bg = (best_iou < rpn_neg_iou) & ~is_fg
    t_deltas = encode_deltas(anchors, _gather_rows(gt_boxes, best_gt))
    l1 = (rpn_deltas - t_deltas).abs().sum(-1)
    if sampled:
        sel_fg = random_subset_mask(is_fg, round(rpn_batch * rpn_pos_frac),
                                    uniforms[0])
        sel_bg = random_subset_mask(is_bg, rpn_batch - sel_fg.sum(-1),
                                    uniforms[1])
        norm = torch.clamp(sel_fg.sum(-1) + sel_bg.sum(-1), min=1.0)
        l_obj = (sigmoid_binary_cross_entropy(rpn_obj, sel_fg.float())
                 * (sel_fg | sel_bg)).sum(-1) / norm
        l_rpn_box = (l1 * sel_fg).sum(-1) / norm
    else:
        wsum = torch.clamp(is_fg.sum(-1) + is_bg.sum(-1), min=1.0)
        l_obj = (sigmoid_binary_cross_entropy(rpn_obj, is_fg.float())
                 * (is_fg | is_bg)).sum(-1) / wsum
        l_rpn_box = (l1 * is_fg).sum(-1) / torch.clamp(is_fg.sum(-1),
                                                       min=1.0)

    # ---------------- ROI heads
    pious = torch.where(gval[:, None, :], pairwise_box_iou(props, gt_boxes),
                        0.0)                                  # [B, P, G]
    p_best, p_gt = pious.max(-1)
    p_fg = (p_best >= roi_pos_iou) & prop_valid
    p_bg = ~p_fg & prop_valid
    if sampled:
        p_fg = random_subset_mask(p_fg, round(roi_batch * roi_pos_frac),
                                  uniforms[2])
        p_bg = random_subset_mask(p_bg, roi_batch - p_fg.sum(-1),
                                  uniforms[3])
        p_sel = p_fg | p_bg
    else:
        p_sel = prop_valid
    target_cls = torch.where(p_fg, _gather_rows(gt_classes, p_gt),
                             num_classes)
    n_sel = torch.clamp(p_sel.sum(-1), min=1.0)
    ce = -torch.log_softmax(cls_logits, -1).gather(
        -1, target_cls[..., None])[..., 0]
    l_cls = (ce * p_sel).sum(-1) / n_sel
    t_roi = encode_deltas(props, _gather_rows(gt_boxes, p_gt),
                          ROI_DELTA_WEIGHTS)
    cls_rows = target_cls.clamp(0, num_classes - 1)
    if box_deltas.dim() == 4:
        fg_deltas = box_deltas.gather(
            2, cls_rows[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    else:
        fg_deltas = box_deltas
    box_norm = n_sel if sampled else torch.clamp(p_fg.sum(-1), min=1.0)
    l_roi_box = ((fg_deltas - t_roi).abs().sum(-1) * p_fg).sum(-1) / box_norm
    losses = {"loss_rpn_cls": l_obj, "loss_rpn_loc": l_rpn_box,
              "loss_cls": l_cls, "loss_box_reg": l_roi_box}

    # ---------------- mask head
    if "gt_masks" in batch and "mask_logits" in out:
        mask_logits = out["mask_logits"]
        crops = crop_gt_masks(batch["gt_masks"], p_gt, props,
                              mask_logits.shape[2])
        logit = mask_logits.gather(-1, cls_rows[..., None, None, None].expand(
            -1, -1, mask_logits.shape[2], mask_logits.shape[3], 1))[..., 0]
        lm = sigmoid_binary_cross_entropy(logit, (crops > 0.5).float())
        losses["loss_mask"] = (lm.mean((2, 3)) * p_fg).sum(-1) / torch.clamp(
            p_fg.sum(-1), min=1.0)
    totals = {k: v.mean() for k, v in losses.items()}
    totals["total_loss"] = sum(totals.values())
    return totals


def mask_rcnn_postprocess(out: Dict[str, torch.Tensor],
                          score_threshold: float = 0.05,
                          nms_threshold: float = 0.5,
                          max_detections: int = 100,
                          nms=nms_batched) -> Detections:
    """Softmax without the background class, the best class a proposal, its
    delta row decoded with ``ROI_DELTA_WEIGHTS``, scores below the
    threshold or of invalid proposals zeroed, class-aware NMS (the class
    offset spans the whole batch, C.3) through the NMS kernel (JAX :468).
    Boxes only, as in the JAX package (ROADMAP.md C.41)."""
    props = out["proposals"]
    probs = torch.softmax(out["cls_logits"].float(), -1)[..., :-1]
    scores, classes = probs.max(-1)  # the first maximum, as jnp.argmax
    deltas = out["box_deltas"]
    if deltas.dim() == 4:
        deltas = deltas.gather(
            2, classes[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    boxes = decode_deltas(props, deltas, ROI_DELTA_WEIGHTS).contiguous()
    scores = torch.where((scores >= score_threshold) & out["proposal_valid"],
                         scores, 0.0).contiguous()
    keep_idx, keep_valid = batched_nms_batched(
        boxes, scores, classes, nms_threshold, max_detections, nms=nms)
    sel = keep_idx.long().clamp(min=0)
    return Detections(
        boxes=_gather_rows(boxes, sel),
        scores=torch.where(keep_valid, _gather_rows(scores, sel), 0.0),
        classes=_gather_rows(classes, sel).to(torch.int32),
        valid=keep_valid)


def check_rcnn_config(cfg) -> None:
    """The R-CNN builders take an ``RcnnConfig``; another raises."""
    if not isinstance(cfg, RcnnConfig):
        raise NotImplementedError(
            f"{cfg.meta_architecture} takes an RcnnConfig (RcnnConfig."
            "from_cfg of a merged CfgNode)")


def rcnn_dtype(cfg: RcnnConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.amp else torch.float32


def _build(cfg: RcnnConfig, device, seed: int, mask_on: bool) -> MaskRCNN:
    model = MaskRCNN(
        num_classes=cfg.num_classes, resnet_depth=cfg.resnet_depth,
        fpn_channels=cfg.fpn_channels, mask_on=mask_on,
        num_proposals=cfg.num_proposals,
        pre_nms_topk=cfg.rcnn_pre_nms_topk,
        cls_agnostic_bbox_reg=cfg.cls_agnostic_bbox_reg,
        dtype=rcnn_dtype(cfg))
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()


@META_ARCH_REGISTRY.register(name="MaskRCNN")
def build_mask_rcnn(cfg: RcnnConfig, device="cuda", seed: int = 0
                    ) -> MaskRCNN:
    """Mask R-CNN from an ``RcnnConfig`` (JAX :503) with weights from
    ``seed`` (drawn on the CPU), on ``device``, channels_last, eval
    mode."""
    check_rcnn_config(cfg)
    return _build(cfg, device, seed, cfg.mask_on)


@META_ARCH_REGISTRY.register(name="FasterRCNN")
def build_faster_rcnn(cfg: RcnnConfig, device="cuda", seed: int = 0
                      ) -> MaskRCNN:
    """Faster R-CNN: the same model without the mask head (JAX :518)."""
    check_rcnn_config(cfg)
    return _build(cfg, device, seed, False)


def rcnn_loss_fn(cfg: RcnnConfig, generator: torch.Generator):
    """The training loss of ``cfg`` (JAX ``engine.py:281-298``) in the
    train step's form ``loss_fn(out, batch, use_l1)``; sampled mode draws
    from ``generator``."""

    def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return mask_rcnn_losses(
            out, batch, cfg.num_classes, sample_mode=cfg.sample_mode,
            rpn_batch=cfg.rpn_batch, rpn_pos_frac=cfg.rpn_pos_frac,
            roi_batch=cfg.roi_batch, roi_pos_frac=cfg.roi_pos_frac,
            generator=generator)

    return loss_fn
