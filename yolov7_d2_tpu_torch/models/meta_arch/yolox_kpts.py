"""YOLOX-KPTS: YOLOX with a keypoint tower, end-to-end pose estimation
(JAX ``models/meta_arch/yolox_kpts.py``): the head, the keypoint decode,
the model on CSPDarknet-X, Swin-T or PVTv2-b1, the losses and the serving
tail.

``YOLOXKPTS.forward`` takes the letterboxed NHWC batch: a uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) in its identity
form, a cast to the compute dtype in channels_last (the JAX model takes
raw 0-255 pixels, transformers included); a float batch is cast.
``yolox_kpts_postprocess`` ends in the NMS kernel (``kernels/nms.py``).

Reproduced from the JAX package (ROADMAP.md C.23): the visibility logit
is multiplied by the stride in the decode, as the coordinates are, and the
loss and the tail's sigmoid read the scaled logit; the OKS loss divides by
``box area * 4 sigma`` (sigma, not sigma squared); a keypoint counts as
visible in the loss where its target x is not 0; the backbone is Swin
"tiny" or PVTv2 "b1" whatever ``MODEL.SWIN.TYPE`` / ``MODEL.PVT.TYPE``
say.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.yolox_kpts import YoloxKptsConfig
from yolov7_d2_tpu_torch.kernels.nms import nms_batched
from yolov7_d2_tpu_torch.kernels.preprocess import normalize_images
from yolov7_d2_tpu_torch.models.backbones.darknetx import CSPDarknetX
from yolov7_d2_tpu_torch.models.backbones.pvt_v2 import PVTv2
from yolov7_d2_tpu_torch.models.backbones.swin import SwinTransformer
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.heads.yolox_head import (
    YOLOXHead,
    decode_outputs,
    simota_assign,
)
from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv
from yolov7_d2_tpu_torch.models.necks.yolo_pafpn import YOLOPAFPN
from yolov7_d2_tpu_torch.ops.iou import iou_loss
from yolov7_d2_tpu_torch.ops.losses import sigmoid_binary_cross_entropy
from yolov7_d2_tpu_torch.ops.nms import batched_nms_batched
from yolov7_d2_tpu_torch.parallel.dist import all_reduce_sum
from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy
from yolov7_d2_tpu_torch.structures.instances import Detections

# the COCO keypoints' OKS constants
COCO_KPT_SIGMAS = (
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
)


class YOLOXKptsHead(YOLOXHead):
    """The YOLOX decoupled head plus a keypoint tower a level (two 3x3
    ``BaseConv`` and a 1x1 to P x 3: ``kpt_convs.{l}.{i}``,
    ``kpt_preds.{l}``; JAX ``YOLOXKptsHead``). Returns ``outputs`` [B, A,
    5 + C] and ``kpts`` [B, A, P, 3] raw, in float32, with ``grids`` and
    ``strides``."""

    def __init__(self, num_classes: int = 1, num_keypoints: int = 17,
                 width: float = 1.0, strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu"):
        super().__init__(num_classes, width, strides, in_channels, act=act)
        hidden = int(256 * width)
        self.num_keypoints = num_keypoints
        self.kpt_convs = nn.ModuleList(
            nn.Sequential(BaseConv(hidden, hidden, 3, 1, act=act),
                          BaseConv(hidden, hidden, 3, 1, act=act))
            for _ in in_channels)
        self.kpt_preds = nn.ModuleList(
            nn.Conv2d(hidden, num_keypoints * 3, 1) for _ in in_channels)

    def level_outputs(self, lvl: int, x: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        out = super().level_outputs(lvl, x)
        out["kpts"] = self.kpt_preds[lvl](self.kpt_convs[lvl](x))
        return out

    def forward(self, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = super().forward(feats)
        b, a, _ = out["outputs"].shape
        out["outputs"] = out["outputs"].float()
        out["kpts"] = out["kpts"].reshape(b, a, self.num_keypoints, 3).float()
        return out


def decode_kpts(kpts_raw: torch.Tensor, grids: torch.Tensor,
                strides: torch.Tensor) -> torch.Tensor:
    """[..., A, P, 3] raw -> xy = (raw + cell) * stride, and the visibility
    logit times the stride too (JAX ``decode_kpts``)."""
    s = strides[..., None, None]
    xy = (kpts_raw[..., 0:2] + grids[..., None, :]) * s
    return torch.cat([xy, kpts_raw[..., 2:3] * s], dim=-1)


class YOLOXKPTS(nn.Module):
    """backbone -> YOLOPAFPN -> :class:`YOLOXKptsHead`. ``backbone_type``
    "swin" (Swin-T, features ``stage1..3``), "pvt_v2" (PVTv2-b1) or
    "cspdarknetx" (``dark3..5``); the neck's ``in_channels`` are the
    features' channels over ``width_mul``, as the JAX model sets them.
    ``dtype`` is the compute dtype (bfloat16: autocast over float32
    parameters)."""

    def __init__(self, num_keypoints: int = 17, num_classes: int = 1,
                 depth_mul: float = 0.33, width_mul: float = 0.50,
                 backbone_type: str = "cspdarknetx",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if backbone_type == "swin":
            self.backbone = SwinTransformer("tiny")
            self.in_features = ("stage1", "stage2", "stage3")
        elif backbone_type == "pvt_v2":
            self.backbone = PVTv2("b1")
            self.in_features = ("stage1", "stage2", "stage3")
        else:
            self.backbone = CSPDarknetX(depth_mul, width_mul)
            self.in_features = ("dark3", "dark4", "dark5")
        feat = [self.backbone.out_channels[f] for f in self.in_features]
        in_channels = [int(c / width_mul) for c in feat]
        self.neck = YOLOPAFPN(depth_mul, width_mul, in_channels,
                              feat_channels=feat)
        self.head = YOLOXKptsHead(num_classes, num_keypoints, width_mul,
                                  in_channels=in_channels)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        if images.dtype == torch.uint8:
            x = normalize_images(images, (0.0,) * 3, (1.0,) * 3, self.dtype)
        else:
            x = images.permute(0, 3, 1, 2).to(self.dtype)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            feats = self.backbone(x)
            return self.head(self.neck([feats[f] for f in self.in_features]))


def yolox_kpts_losses(
    head_out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    num_classes: int = 1,
    num_keypoints: int = 17,
) -> Dict[str, torch.Tensor]:
    """The JAX ``yolox_kpts_losses`` on ``batch`` {"gt_boxes",
    "gt_classes", "gt_valid", "gt_keypoints" [B, G, P, 3]}: SimOTA over
    all anchors without gradient (no prefilter, as the JAX loss), IoU x 5,
    objectness and IoU-weighted class BCE; the OKS keypoint loss x 5 and
    the visibility BCE (a mean over the P keypoints) on the foreground;
    every term over the foreground count. Inside a process group the
    counts are the global batch's."""
    outputs = head_out["outputs"].float()
    grids, strides = head_out["grids"], head_out["strides"]
    boxes_cxcywh, obj_logits, cls_logits = decode_outputs(outputs, grids,
                                                          strides)
    kpts = decode_kpts(head_out["kpts"].float(), grids, strides)
    gt_boxes = batch["gt_boxes"]
    with torch.no_grad():
        assign = simota_assign(boxes_cxcywh, obj_logits, cls_logits, grids,
                               strides, gt_boxes, batch["gt_classes"],
                               batch["gt_valid"])
    fg_f = assign["fg_mask"].float()                             # [B, A]
    num_fg = all_reduce_sum(assign["num_fg"].sum()).clamp(min=1.0)
    matched = assign["matched_gt"]

    tgt_boxes = gt_boxes.gather(1, matched[..., None].expand(-1, -1, 4))
    loss_iou = (iou_loss(cxcywh_to_xyxy(boxes_cxcywh), tgt_boxes, "iou")
                * fg_f).sum() / num_fg
    loss_obj = sigmoid_binary_cross_entropy(obj_logits, fg_f).sum() / num_fg
    cls_t = (F.one_hot(batch["gt_classes"].long().gather(1, matched),
                       num_classes).float()
             * assign["matched_iou"][..., None])
    loss_cls = (sigmoid_binary_cross_entropy(cls_logits, cls_t)
                * fg_f[..., None]).sum() / num_fg

    # the matched gt's keypoints a anchor, [B, A, P, 3]
    p = num_keypoints
    tgt_kpts = batch["gt_keypoints"].float().gather(
        1, matched[..., None, None].expand(-1, -1, p, 3))
    kpt_mask = (tgt_kpts[..., 0] != 0).float()                   # [B, A, P]
    bbox_scale = ((tgt_boxes[..., 2] - tgt_boxes[..., 0])
                  * (tgt_boxes[..., 3] - tgt_boxes[..., 1]))[..., None]
    sigmas = torch.tensor(COCO_KPT_SIGMAS[:p], device=kpts.device)
    d2 = ((kpts[..., 0:2] - tgt_kpts[..., 0:2]) ** 2).sum(-1)
    oks = torch.exp(-d2 / (bbox_scale * (4.0 * sigmas) + 1e-9))
    n_entries = all_reduce_sum(fg_f.sum()) * p
    n_vis = all_reduce_sum((kpt_mask * fg_f[..., None]).sum()).clamp(min=1.0)
    lkpt = (n_entries / n_vis) * ((1.0 - oks ** 2) * kpt_mask).mean(-1)
    loss_kpt = (lkpt * fg_f).sum() / num_fg
    loss_kpt_vis = (sigmoid_binary_cross_entropy(kpts[..., 2], kpt_mask)
                    .mean(-1) * fg_f).sum() / num_fg

    losses = {
        "loss_iou": 5.0 * loss_iou,
        "loss_obj": loss_obj,
        "loss_cls": loss_cls,
        "loss_kpt": 5.0 * loss_kpt,
        "loss_kpt_vis": loss_kpt_vis,
    }
    losses["total_loss"] = sum(losses.values())
    losses["num_fg"] = num_fg
    return losses


def yolox_kpts_loss_fn(cfg: YoloxKptsConfig) -> Callable:
    """The training loss of ``build_system`` (one class, no L1 switch)."""

    def loss_fn(head_out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return yolox_kpts_losses(head_out, batch, 1, cfg.num_keypoints)

    return loss_fn


def yolox_kpts_postprocess(
    head_out: Dict[str, torch.Tensor],
    conf_threshold: float = 0.01,
    nms_threshold: float = 0.65,
    max_detections: int = 100,
    pre_nms_topk: int = 1024,
    nms: Callable = nms_batched,
) -> Detections:
    """Scores obj x max class (sigmoids), the confidence filter, the
    pre-NMS top-k, class-aware NMS, and the keypoints of the kept anchors
    with the sigmoid of their stride-scaled visibility logit as their score
    (JAX ``yolox_kpts_postprocess``). The top-k keeps ``jax.lax.top_k``'s
    members and order, score descending and the lower index first among
    equal scores, by a stable sort. ``nms`` is the batched NMS (the
    kernel's wrapper by default)."""
    grids, strides = head_out["grids"], head_out["strides"]
    boxes_cxcywh, obj_logits, cls_logits = decode_outputs(
        head_out["outputs"], grids, strides)
    boxes = cxcywh_to_xyxy(boxes_cxcywh)
    cls_prob = torch.sigmoid(cls_logits)
    best_cls = torch.argmax(cls_prob, dim=-1)          # first index on ties
    scores = torch.sigmoid(obj_logits) * cls_prob.amax(dim=-1)
    scores = torch.where(scores >= conf_threshold, scores, 0.0)

    k = min(pre_nms_topk, scores.shape[-1])
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores = top_scores[:, :k].contiguous()        # [B, K]
    top_idx = top_idx[:, :k]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = best_cls.gather(1, top_idx)

    keep_idx, keep_valid = batched_nms_batched(
        top_boxes, top_scores, top_cls, nms_threshold, max_detections,
        nms=nms)
    sel = top_idx.gather(1, keep_idx.clamp(min=0).long())  # anchors [B, M]
    raw = head_out["kpts"]
    p = raw.shape[-2]
    kpts = decode_kpts(raw.gather(1, sel[..., None, None].expand(-1, -1, p,
                                                                 3)).float(),
                       grids[sel], strides[sel])
    kpts = torch.cat([kpts[..., 0:2], torch.sigmoid(kpts[..., 2:3])], -1)
    return Detections(
        boxes=boxes.gather(1, sel[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep_valid, scores.gather(1, sel), 0.0),
        classes=best_cls.gather(1, sel).to(torch.int32),
        valid=keep_valid,
        keypoints=kpts,
    )


@META_ARCH_REGISTRY.register(name="YOLOX_KPTS")
def build_yolox_kpts(cfg: YoloxKptsConfig, device="cuda",
                     seed: int = 0) -> YOLOXKPTS:
    """YOLOX-KPTS in eval mode on ``device``, weights drawn from ``seed``
    on the CPU (JAX :304): one class, ``cfg.num_keypoints``, the backbone
    of ``cfg.backbone_type``."""
    if not isinstance(cfg, YoloxKptsConfig):
        raise NotImplementedError(
            "YOLOX_KPTS takes a YoloxKptsConfig (YoloxKptsConfig.from_cfg "
            "of a merged config)")
    model = YOLOXKPTS(
        num_keypoints=cfg.num_keypoints, num_classes=1,
        depth_mul=cfg.depth_mul, width_mul=cfg.width_mul,
        backbone_type=cfg.backbone_type,
        dtype=torch.bfloat16 if cfg.amp else torch.float32)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()
