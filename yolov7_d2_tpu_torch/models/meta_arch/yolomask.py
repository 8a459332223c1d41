"""YOLOMask (OrienMask): an anchor YOLO detector and an orientation field
at 1/4 of the input (JAX ``models/meta_arch/yolomask.py``): the model, its
losses and the mask recovery.

``YOLOMask.forward`` runs the port's ``AnchorYOLO`` (CSP-Darknet53,
YOLOPAFPN at width and depth 1.0, the 3x3-tower head, SiLU, the default
anchors, as the JAX model fixes them) with its neck pyramid returned, and
``OrienHead`` on that pyramid: P4 and P5 projected to P3's width and
upsampled to it, summed, a 3x3, a 2x nearest upsample, a 3x3 and a 1x1 to
one (dx, dy) field per level and anchor, ``orien`` [B, H/4, W/4, L, na,
2] in float32. The detector's boxes serve through
``yolov7.anchor_yolo_postprocess`` (the NMS kernel).

``yolomask_recover_masks`` takes a single field [B, H/4, W/4, 2], as the
JAX function does: the JAX package has no code that gives each detection
the field of its own level and anchor (ROADMAP.md C.36), and the port adds
none.

Parameter names: ``detector.`` the anchor-YOLO family's (``utils/
weight_port.py`` ``map_anchor_yolo_torch_name``), ``orien.`` the flax ones
(``lat4``, ``lat5``, ``conv1``, ``conv2``, ``orien_pred``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.anchor_yolo import AnchorYoloConfig
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv
from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import _resize
from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import AnchorYOLO
from yolov7_d2_tpu_torch.ops.losses import (
    masked_mean,
    sigmoid_binary_cross_entropy,
)
from yolov7_d2_tpu_torch.structures.instances import Detections


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class OrienHead(nn.Module):
    """The pyramid (P3 s8, P4 s16, P5 s32) fused at s8, then up to s4 ->
    an offset field per level and anchor (JAX :36)."""

    def __init__(self, in_channels=(256, 512, 1024), up_channels: int = 64,
                 num_levels: int = 3, num_anchors: int = 3):
        super().__init__()
        c3 = in_channels[0]
        self.num_levels = num_levels
        self.num_anchors = num_anchors
        self.lat4 = BaseConv(in_channels[1], c3, 1, 1)
        self.lat5 = BaseConv(in_channels[2], c3, 1, 1)
        self.conv1 = BaseConv(c3, up_channels, 3, 1)
        self.conv2 = BaseConv(up_channels, up_channels, 3, 1)
        self.orien_pred = nn.Conv2d(up_channels,
                                    num_levels * num_anchors * 2, 1)

    def forward(self, feats) -> torch.Tensor:
        p3, p4, p5 = feats
        x = p3 + _up2(self.lat4(p4)) + _up2(_up2(self.lat5(p5)))
        x = self.conv2(_up2(self.conv1(x)))
        y = self.orien_pred(x).float().permute(0, 2, 3, 1)
        b, hq, wq, _ = y.shape
        return y.reshape(b, hq, wq, self.num_levels, self.num_anchors, 2)


class YOLOMask(nn.Module):
    """AnchorYOLO (``detector``) + OrienHead (``orien``) on the detector's
    neck pyramid (JAX :79): the detector's flattened outputs with
    ``level_hw``, and ``orien``. ``dtype`` is the compute dtype."""

    def __init__(self, num_classes: int = 80, up_channels: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.detector = AnchorYOLO(
            num_classes=num_classes, backbone_type="cspdarknet53",
            neck_type="pafpn", act="silu", dtype=dtype)
        self.orien = OrienHead((256, 512, 1024), up_channels)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        flat = self.detector(images, return_pyramid=True)
        pyramid = flat.pop("pyramid")
        with torch.autocast(images.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            flat["orien"] = self.orien(pyramid)
        return flat


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def orien_loss(orien: torch.Tensor, gt_masks: torch.Tensor,
               gt_boxes: torch.Tensor, gt_valid: torch.Tensor
               ) -> torch.Tensor:
    """The field ``orien`` [B, Hq, Wq, 2] (grid units) against the vector
    from each pixel of an instance's mask to its box centre, L1, mean over
    those pixels (JAX :105; the masks resized bilinear with antialiasing,
    as ``jax.image.resize`` does by default, and cut at 0.5)."""
    b, hq, wq, _ = orien.shape
    masks_q = (_resize(gt_masks.float(), (hq, wq), antialias=True)
               > 0.5).float()
    dev = orien.device
    ys = torch.arange(hq, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(wq, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5 / 4.0
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5 / 4.0
    tx = cx[:, :, None, None] - gx
    ty = cy[:, :, None, None] - gy
    pred = orien[:, None]
    err = (pred[..., 0] - tx).abs() + (pred[..., 1] - ty).abs()
    w = masks_q * gt_valid[:, :, None, None].float()
    return masked_mean(err, w > 0)


def yolomask_recover_masks(dets: Detections, orien: torch.Tensor,
                           stride: int = 4) -> torch.Tensor:
    """Pixel p belongs to detection d iff p + field(p), in input pixels,
    lies inside d's box (JAX :133). ``orien`` [B, Hq, Wq, 2] -> float masks
    [B, D, Hq, Wq], zero for invalid detections."""
    _, hq, wq, _ = orien.shape
    dev = orien.device
    ys = torch.arange(hq, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(wq, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px = ((gx + orien[..., 0]) * stride)[:, None]          # [B, 1, Hq, Wq]
    py = ((gy + orien[..., 1]) * stride)[:, None]
    box = dets.boxes[..., None, None]                       # [B, D, 4, 1, 1]
    inside = ((px >= box[:, :, 0]) & (px <= box[:, :, 2])
              & (py >= box[:, :, 1]) & (py <= box[:, :, 3]))
    return inside.float() * dets.valid[..., None, None].float()


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def ciou_loss_cxcywh(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """1 - CIoU of cxcywh boxes, elementwise (JAX ``_ciou_loss_cxcywh``,
    :174): the reference feeds it offset-space boxes (sigmoid xy, raw wh),
    kept as they are; the aspect term's weight takes no gradient."""
    eps = 1e-9
    px1, py1 = p[..., 0] - p[..., 2] / 2, p[..., 1] - p[..., 3] / 2
    px2, py2 = p[..., 0] + p[..., 2] / 2, p[..., 1] + p[..., 3] / 2
    tx1, ty1 = t[..., 0] - t[..., 2] / 2, t[..., 1] - t[..., 3] / 2
    tx2, ty2 = t[..., 0] + t[..., 2] / 2, t[..., 1] + t[..., 3] / 2
    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0.0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0.0)
    inter = iw * ih
    union = p[..., 2] * p[..., 3] + t[..., 2] * t[..., 3] - inter
    iou = inter / (union + eps)
    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    c2 = cw * cw + ch * ch + eps
    rho2 = (t[..., 0] - p[..., 0]) ** 2 + (t[..., 1] - p[..., 1]) ** 2
    v = (4.0 / np.pi ** 2) * (torch.atan(t[..., 2] / (t[..., 3] + eps))
                              - torch.atan(p[..., 2] / (p[..., 3] + eps))
                              ) ** 2
    alpha = (v / (1.0 - iou + v + eps)).detach()
    return 1.0 - (iou - rho2 / c2 - alpha * v)


def yolomask_level_targets(raw: torch.Tensor, gt_cxcywh: torch.Tensor,
                           gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                           gt_masks: torch.Tensor,
                           anchors_all: torch.Tensor, anchor_mask, image_hw,
                           center_region: float, valid_region: float,
                           obj_ignore_threshold: float, label_smooth: float,
                           num_classes: int) -> Dict[str, torch.Tensor]:
    """OrienMaskYOLOLoss' ``build_targets`` for one scale (JAX
    ``_yolomask_level_targets``, :206), over the batch: ``raw`` [B, na,
    nH, nW, 5 + C], gts in input pixels (cxcywh), ``gt_masks`` [B, G, H,
    W] at the input's size, ``anchors_all`` [L na, 2] pixels,
    ``anchor_mask`` this scale's anchor indices. Box targets at the cell
    of each gt matched (by its best anchor among all scales) to this
    scale, the last gt winning a slot; the ignore mask from the
    predictions' IoU with the gts; the orientation targets at full
    resolution, the gts in order, an instance pixel overwritten (count
    -1, the offset to its centre) and a background pixel of the valid
    region accumulated (count + 1), as the reference's sequential writes
    do. The loop runs to the last valid gt of the batch."""
    b, na, nh, nw, _ = raw.shape
    img_h, img_w = image_hw
    g = gt_cxcywh.shape[1]
    dev = raw.device
    scale = torch.tensor([img_w / nw, img_h / nh], dtype=torch.float32,
                         device=dev)
    amask = torch.as_tensor(anchor_mask, device=dev)
    grid_all = anchors_all / scale
    grid_anchors = grid_all[amask]                          # [na, 2]
    pixel_anchors = anchors_all[amask]
    gxy = gt_cxcywh[..., 0:2] / scale
    gwh = gt_cxcywh[..., 2:4] / scale

    inter = (torch.minimum(gwh[..., None, 0], grid_all[:, 0])
             * torch.minimum(gwh[..., None, 1], grid_all[:, 1]))
    union = (gwh[..., 0:1] * gwh[..., 1:2]
             + grid_all[:, 0] * grid_all[:, 1] - inter)
    match_index = torch.argmax(inter / union, -1)           # [B, G]
    hit = match_index[..., None] == amask
    ok = hit.any(-1) & gt_valid.bool()
    match_anchor = torch.argmax(hit.int(), -1)              # [B, G]
    gx_i = torch.floor(gxy[..., 0]).clamp(0, nw - 1).long()
    gy_i = torch.floor(gxy[..., 1]).clamp(0, nh - 1).long()

    s = na * nh * nw
    slot = torch.where(ok, (match_anchor * nh + gy_i) * nw + gx_i, s)
    writer = torch.arange(1, g + 1, device=dev).expand(b, g)
    winner = torch.zeros((b, s + 1), dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(1, slot, writer, "amax")[:, :s]
    w_gt = (winner - 1).clamp(min=0)
    pos = winner > 0
    txy_g = gxy - torch.stack([gx_i, gy_i], -1).float()
    twh_g = torch.log(gwh / grid_anchors[match_anchor] + 1e-16)
    scale_g = 2.0 - gwh[..., 0] * gwh[..., 1] / (nw * nh)

    def per_slot(v):                                        # [B, G, ...]
        idx = w_gt.reshape(b, s, *([1] * (v.dim() - 2))).expand(
            b, s, *v.shape[2:])
        return v.gather(1, idx)

    txy = torch.where(pos[..., None], per_slot(txy_g), 0.0)
    twh = torch.where(pos[..., None], per_slot(twh_g), 0.0)
    tscale = torch.where(pos, per_slot(scale_g), 0.0)
    hot = F.one_hot(per_slot(gt_classes.long()), num_classes) > 0
    tcls = torch.where(pos[..., None] & hot, 1.0 - label_smooth,
                       torch.full((b, s, num_classes), label_smooth,
                                  device=dev))

    # the ignore mask: each prediction's grid box against every gt's
    pxy = torch.sigmoid(raw[..., 0:2].detach().float())
    pwh = raw[..., 2:4].detach().float()
    my, mx = torch.meshgrid(torch.arange(nh, dtype=torch.float32,
                                         device=dev),
                            torch.arange(nw, dtype=torch.float32,
                                         device=dev), indexing="ij")
    mesh = torch.stack([mx, my], -1)
    pg = torch.cat([pxy + mesh, torch.exp(pwh)
                    * grid_anchors[:, None, None, :]], -1).reshape(b, -1, 4)
    gg = torch.cat([gxy, gwh], -1)[:, None]                 # [B, 1, G, 4]
    pgg = pg[:, :, None]                                    # [B, P, 1, 4]
    ix1 = torch.maximum(pgg[..., 0] - pgg[..., 2] / 2,
                        gg[..., 0] - gg[..., 2] / 2)
    ix2 = torch.minimum(pgg[..., 0] + pgg[..., 2] / 2,
                        gg[..., 0] + gg[..., 2] / 2)
    iy1 = torch.maximum(pgg[..., 1] - pgg[..., 3] / 2,
                        gg[..., 1] - gg[..., 3] / 2)
    iy2 = torch.minimum(pgg[..., 1] + pgg[..., 3] / 2,
                        gg[..., 1] + gg[..., 3] / 2)
    inter2 = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union2 = (pgg[..., 2] * pgg[..., 3]) + gg[..., 2] * gg[..., 3] - inter2
    iou_pg = torch.where(gt_valid.bool()[:, None, :], inter2 / union2, 0.0)
    ignore = (iou_pg > obj_ignore_threshold).any(-1)
    pos_map = pos.reshape(b, na, nh, nw)
    neg_map = ~ignore.reshape(b, na, nh, nw) & ~pos_map

    # the orientation targets at full resolution, the gts in order
    h, w = int(img_h), int(img_w)
    py_, px_ = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                           device=dev),
                              torch.arange(w, dtype=torch.float32,
                                           device=dev), indexing="ij")
    mesh_pix = torch.stack([px_, py_], -1)                  # [H, W, 2]
    centre = gxy * scale
    valid_wh = (gwh * valid_region + 0.5) * scale
    centre_wh = valid_wh / valid_region * center_region
    count = torch.zeros((b, na, h, w), dtype=torch.int32, device=dev)
    tsum = torch.zeros((b, na, h, w, 2), dtype=torch.float32, device=dev)
    anchors_idx = torch.arange(na, device=dev)
    live = ok.any(0).nonzero()
    last = int(live.max()) + 1 if live.numel() else 0
    for j in range(last):
        p_g = centre[:, j][:, None, None, :]                # [B, 1, 1, 2]
        v_g = valid_wh[:, j]
        offset = mesh_pix - p_g                             # [B, H, W, 2]
        lo = torch.round((p_g[:, 0, 0] - v_g).clamp(min=0.0).minimum(
            torch.tensor([w - 1.0, h - 1.0], device=dev)))
        hi = torch.round((p_g[:, 0, 0] + v_g).clamp(min=0.0).minimum(
            torch.tensor([w - 1.0, h - 1.0], device=dev))) + 1
        roi = ((px_ >= lo[:, 0, None, None]) & (px_ < hi[:, 0, None, None])
               & (py_ >= lo[:, 1, None, None])
               & (py_ < hi[:, 1, None, None]))              # [B, H, W]
        a1h = (anchors_idx == match_anchor[:, j, None])[:, :, None, None]
        mask_g = gt_masks[:, j]
        ok_g = ok[:, j, None, None]
        upd = a1h & (roi & (mask_g > 0) & ok_g)[:, None]
        count = torch.where(upd, -1, count)
        tsum = torch.where(upd[..., None], offset[:, None], tsum)
        not_inst = a1h & (roi & (mask_g == 0) & ok_g)[:, None] & (count >= 0)
        count = count + not_inst.int()
        off_len = offset.abs().clamp(min=1e-8)
        neg_scale = (centre_wh[:, j, None, None, :] / off_len).clamp(
            min=1.0).amin(-1) - 1.0
        neg_off = neg_scale[..., None] * torch.sign(offset) * off_len
        tsum = tsum + not_inst[..., None].float() * neg_off[:, None]
    divisor = torch.where(count == 0, 1000, count).float()
    torien = tsum / (pixel_anchors[:, None, None, :] / 2.0)
    torien = torien / divisor[..., None]
    return {
        "pos": pos_map, "neg": neg_map,
        "txy": txy.reshape(b, na, nh, nw, 2),
        "twh": twh.reshape(b, na, nh, nw, 2),
        "tscale": tscale.reshape(b, na, nh, nw),
        "tcls": tcls.reshape(b, na, nh, nw, num_classes),
        "orien_pos": count < 0, "orien_neg": count > 0, "torien": torien,
    }


def yolomask_losses(flat: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], num_classes: int,
                    anchors, image_hw, center_region: float = 0.6,
                    valid_region: float = 0.6,
                    obj_ignore_threshold: float = 0.5,
                    label_smooth: float = 0.0) -> Dict[str, torch.Tensor]:
    """OrienMaskYOLOLoss summed over the scales (JAX :364): the offset-space
    CIoU box term (x 1.2), objectness BCE split into positives and
    negatives, class BCE at the positives, and the smooth-L1 orientation
    terms over their pixels, scaled by the scale's positive boxes (the
    positive term x 1.1); every sum over the batch size. ``anchors`` [L,
    na, 2] pixels, level order; the batch holds ``gt_boxes`` xyxy,
    ``gt_classes``, ``gt_valid`` and ``gt_masks`` [B, G, H, W]."""
    level_hw = flat["level_hw"]
    anchors = np.asarray(anchors, np.float32)
    na = anchors.shape[1]
    dev = flat["outputs"].device
    anchors_flat = torch.from_numpy(anchors.reshape(-1, 2)).to(dev)
    gt_boxes = batch["gt_boxes"].float()
    gt_cxcywh = torch.cat([(gt_boxes[..., 0:2] + gt_boxes[..., 2:4]) / 2,
                           gt_boxes[..., 2:4] - gt_boxes[..., 0:2]], -1)
    b = gt_boxes.shape[0]
    nb = float(b)
    h, w = image_hw
    totals: Dict[str, torch.Tensor] = {}
    off = 0
    for lvl, (nh, nw) in enumerate(level_hw):
        n = nh * nw * na
        raw = flat["outputs"][:, off:off + n].float().reshape(
            b, nh, nw, na, -1).permute(0, 3, 1, 2, 4)
        off += n
        t = yolomask_level_targets(
            raw, gt_cxcywh, batch["gt_classes"], batch["gt_valid"],
            batch["gt_masks"], anchors_flat, range(lvl * na, (lvl + 1) * na),
            image_hw, center_region, valid_region, obj_ignore_threshold,
            label_smooth, num_classes)
        pos = t["pos"].float()
        neg = t["neg"].float()
        pxy = torch.sigmoid(raw[..., 0:2])
        pboxes = torch.cat([pxy, raw[..., 2:4]], -1)
        tboxes = torch.cat([t["txy"], t["twh"]], -1)
        lbox_sum = (ciou_loss_cxcywh(pboxes, tboxes) * t["tscale"]
                    * pos).sum()
        n_box_pos = pos.sum()
        lbox = torch.where(n_box_pos > 0, lbox_sum, 1e-8)
        obj_all = sigmoid_binary_cross_entropy(raw[..., 4], pos)
        cls_all = sigmoid_binary_cross_entropy(raw[..., 5:], t["tcls"])

        pred = flat["orien"][:, :, :, lvl]                  # [B,Hq,Wq,na,2]
        hq, wq = pred.shape[1:3]
        full = _resize(pred.permute(0, 3, 4, 1, 2).reshape(b, na * 2, hq, wq),
                       (h, w)).reshape(b, na, 2, h, w).permute(0, 1, 3, 4, 2)
        l_or = _smooth_l1(full - t["torien"])
        or_pos = t["orien_pos"].float()
        or_neg = t["orien_neg"].float()
        n_or_pos, n_or_neg = or_pos.sum(), or_neg.sum()
        l_or_pos = torch.where(
            n_or_pos > 0, (l_or * or_pos[..., None]).sum()
            / n_or_pos.clamp(min=1.0) * n_box_pos / nb, 0.0)
        l_or_neg = torch.where(
            n_or_neg > 0, (l_or * or_neg[..., None]).sum()
            / n_or_neg.clamp(min=1.0) * n_box_pos / nb, 0.0)
        items = {
            "loss_box": lbox / nb * 1.2,
            "loss_obj_pos": (obj_all * pos).sum() / nb,
            "loss_obj_neg": (obj_all * neg).sum() / nb,
            "loss_cls": (cls_all * pos[..., None]).sum() / nb,
            "loss_orien_pos": l_or_pos * 1.1,
            "loss_orien_neg": l_or_neg,
        }
        for k, v in items.items():
            totals[k] = totals[k] + v if k in totals else v
    totals["total_loss"] = sum(v for k, v in totals.items()
                               if k.startswith("loss_"))
    return totals


@META_ARCH_REGISTRY.register(name="YOLOMask")
def build_yolomask(cfg: AnchorYoloConfig, device="cuda",
                   seed: int = 0) -> YOLOMask:
    """YOLOMask from an ``AnchorYoloConfig`` (JAX :156: the classes and
    ``ORIEN_HEAD.UP_CHANNELS``; the detector is fixed) with weights from
    ``seed`` (drawn on the CPU), on ``device``, channels_last, eval
    mode."""
    if not isinstance(cfg, AnchorYoloConfig):
        raise NotImplementedError(
            "YOLOMask takes an AnchorYoloConfig (AnchorYoloConfig.from_cfg "
            "of a merged CfgNode)")
    model = YOLOMask(cfg.num_classes, cfg.orien_up_channels,
                     torch.bfloat16 if cfg.amp else torch.float32)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()


def yolomask_loss_fn(cfg: AnchorYoloConfig):
    """The training loss of ``cfg`` (JAX ``engine.py:317-333``) in the train
    step's form: ``yolomask_losses`` on the config's anchors (which the
    yamls give equal to the model's fixed ones) and an ignore threshold of
    at least 0.5."""

    def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return yolomask_losses(
            out, batch, cfg.num_classes, cfg.anchors, cfg.input_size,
            obj_ignore_threshold=max(cfg.ignore_threshold, 0.5))

    return loss_fn
