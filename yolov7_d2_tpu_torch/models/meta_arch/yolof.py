"""YOLOF: one level, a dilated encoder and uniform matching (JAX
``models/meta_arch/yolof.py``).

``YOLOF.forward`` takes the letterboxed NHWC batch: a uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) at YOLOF's mean and
std, ``(x - mean) / std`` in float32 and one rounding to the compute dtype,
which is what the JAX model computes; a float batch (after the training
step's mixup) takes the kernel's plain version. Then ResNet ``res5``, the
encoder and the decoder. ``yolof_postprocess`` ends in the NMS kernel
(``kernels/nms.py``) over the top 1000 (anchor, class) candidates.

The encoder and decoder keep the original reference's names
(``lateral_conv``, ``dilated_encoder_blocks.{i}.conv{1,2,3}.{0,1}``,
``cls_subnet.{3i}``, ``bbox_pred`` ...), so that ``utils/weight_port.py:
map_yolof_encoder_torch_name`` and ``map_yolof_decoder_torch_name`` apply.
Their BatchNorms compute in float32 (torch momentum 0.1, eps 1e-5), as the
JAX ones do; the decoder's outputs and the objectness fold are float32.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.kernels.nms import nms_batched
from yolov7_d2_tpu_torch.kernels.preprocess import (
    normalize_images,
    normalize_images_plain,
)
from yolov7_d2_tpu_torch.models.backbones.resnet import ResNet, ResNetSpec
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.layers.blocks import at_least_f32
from yolov7_d2_tpu_torch.ops.iou import iou_loss, pairwise_box_iou
from yolov7_d2_tpu_torch.ops.losses import sigmoid_focal_loss
from yolov7_d2_tpu_torch.ops.nms import batched_nms_batched
from yolov7_d2_tpu_torch.parallel.dist import all_reduce_sum
from yolov7_d2_tpu_torch.structures.boxes import (
    cxcywh_to_xyxy,
    xyxy_to_cxcywh,
)
from yolov7_d2_tpu_torch.structures.instances import Detections

# the JAX model's constants (yolof.py:171-172), BGR
PIXEL_MEAN = (103.53, 116.28, 123.675)
PIXEL_STD = (57.375, 57.12, 58.395)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
STRIDE = 32
SCALE_CLAMP = math.log(1000.0 / 16)  # box_regression.py:6
BLOCK_DILATIONS = (2, 4, 6, 8)
# UniformMatcher: top-k anchors a gt by each cost, the ignore thresholds
MATCH_TOPK = 4
NEG_IGNORE_THRESH = 0.7
POS_IGNORE_THRESH = 0.15


def _bn32(bn: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """``bn`` in float32, rounded to ``y``'s dtype (the JAX BatchNorm with
    ``dtype`` float32, then the cast to the compute dtype)."""
    return bn(at_least_f32(y)).to(y.dtype)


def _conv_bn_relu(c_in: int, c_out: int, k: int = 3,
                  dilation: int = 1) -> nn.Sequential:
    """Conv (with bias) -> BatchNorm -> ReLU, as the reference's Sequential
    (indices 0, 1, 2)."""
    return nn.Sequential(
        nn.Conv2d(c_in, c_out, k, padding=dilation * (k - 1) // 2,
                  dilation=dilation),
        nn.BatchNorm2d(c_out, eps=1e-5, momentum=0.1), nn.ReLU())


def _run(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    conv, bn, act = seq
    return act(_bn32(bn, conv(x)))


class EncoderBottleneck(nn.Module):
    """1x1 reduce, dilated 3x3, 1x1 project, each conv + BN + ReLU; the
    block adds its input (JAX :52-57)."""

    def __init__(self, channels: int, mid: int, dilation: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(channels, mid, 1)
        self.conv2 = _conv_bn_relu(mid, mid, 3, dilation)
        self.conv3 = _conv_bn_relu(mid, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _run(self.conv3, _run(self.conv2, _run(self.conv1, x)))


class DilatedEncoder(nn.Module):
    """C5 -> ``channels``: lateral 1x1 + BN, 3x3 + BN, then bottlenecks at
    dilations 2/4/6/8 (JAX :30); the convolutions keep their biases."""

    def __init__(self, in_channels: int = 2048, channels: int = 512):
        super().__init__()
        self.lateral_conv = nn.Conv2d(in_channels, channels, 1)
        self.lateral_norm = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
        self.fpn_conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.fpn_norm = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
        self.dilated_encoder_blocks = nn.ModuleList(
            EncoderBottleneck(channels, channels // 4, d)
            for d in BLOCK_DILATIONS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _bn32(self.lateral_norm, self.lateral_conv(x))
        x = _bn32(self.fpn_norm, self.fpn_conv(x))
        for block in self.dilated_encoder_blocks:
            x = block(x)
        return x


class YOLOFDecoder(nn.Module):
    """Two class convs and four box convs (conv + BN + ReLU), then 3x3
    predictions; the class logits get the implicit objectness fold
    ``cls + obj - logsumexp{0, cls, obj}`` in float32 (JAX :62). Returns
    logits [B, H W A, C] and deltas [B, H W A, 4], float32, anchors
    row-major by cell then size."""

    def __init__(self, channels: int = 512, num_classes: int = 80):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors = len(ANCHOR_SIZES)
        self.cls_subnet = nn.Sequential(*[
            m for _ in range(2) for m in _conv_bn_relu(channels, channels)])
        self.bbox_subnet = nn.Sequential(*[
            m for _ in range(4) for m in _conv_bn_relu(channels, channels)])
        self.cls_score = nn.Conv2d(channels, num_anchors * num_classes, 3,
                                   padding=1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 3, padding=1)
        self.object_pred = nn.Conv2d(channels, num_anchors, 3, padding=1)

    @staticmethod
    def _tower(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for i in range(0, len(seq), 3):
            x = _run(seq[i:i + 3], x)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cls = self.cls_score(self._tower(self.cls_subnet, x))
        reg = self._tower(self.bbox_subnet, x)
        b, _, h, w = cls.shape
        n = h * w * self.num_anchors

        def flat(t, last):
            return t.permute(0, 2, 3, 1).reshape(b, n, last).float()

        cls = flat(cls, self.num_classes)
        obj = flat(self.object_pred(reg), 1)
        deltas = flat(self.bbox_pred(reg), 4)
        stacked = torch.stack([torch.zeros_like(cls), cls,
                               obj.expand_as(cls)], dim=0)
        return cls + obj - torch.logsumexp(stacked, dim=0), deltas


@functools.lru_cache(maxsize=16)
def _anchors_cpu(h: int, w: int, stride: int,
                 sizes: Tuple[int, ...]) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    cx = ((xs + 0.5) * stride)[..., None]
    cy = ((ys + 0.5) * stride)[..., None]
    half = torch.tensor(sizes, dtype=torch.float64) / 2
    boxes = torch.stack([cx - half, cy - half, cx + half, cy + half], -1)
    return boxes.reshape(-1, 4).float()


def yolof_anchors(h: int, w: int, device="cpu") -> torch.Tensor:
    """Anchors xyxy [h w 5, 4] float32 of ``ANCHOR_SIZES`` centred on the
    cells of a stride-32 map, cell-major then size (JAX :116; the same
    float64 arithmetic, one rounding)."""
    return _anchors_cpu(h, w, STRIDE, ANCHOR_SIZES).to(device)


def decode_deltas(anchors: torch.Tensor,
                  deltas: torch.Tensor) -> torch.Tensor:
    """(dx, dy, dw, dh) on cxcywh anchors -> xyxy boxes, dw and dh clamped
    at log(1000 / 16), no centre clamp (JAX :131 with its default, which no
    config changes)."""
    a = xyxy_to_cxcywh(anchors)
    cx = a[..., 0] + deltas[..., 0] * a[..., 2]
    cy = a[..., 1] + deltas[..., 1] * a[..., 3]
    w = a[..., 2] * torch.exp(deltas[..., 2].clamp(max=SCALE_CLAMP))
    h = a[..., 3] * torch.exp(deltas[..., 3].clamp(max=SCALE_CLAMP))
    return cxcywh_to_xyxy(torch.stack([cx, cy, w, h], dim=-1))


class YOLOF(nn.Module):
    """ResNet ``res5`` -> DilatedEncoder -> YOLOFDecoder (JAX :157).
    Returns ``logits``, ``deltas`` and the ``anchors`` of the stride-32
    map. ``dtype`` is the compute dtype: bfloat16 runs under autocast over
    float32 parameters."""

    def __init__(self, num_classes: int = 80, resnet_depth: int = 50,
                 encoder_channels: int = 512,
                 frozen_bn: bool = True, stride_in_1x1: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet(ResNetSpec(
            depth=resnet_depth, out_features=("res5",), frozen_bn=frozen_bn,
            stride_in_1x1=stride_in_1x1))
        self.encoder = DilatedEncoder(self.backbone.out_channels["res5"],
                                      encoder_channels)
        self.decoder = YOLOFDecoder(encoder_channels, num_classes)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch, BGR."""
        norm = (normalize_images if images.dtype == torch.uint8
                else normalize_images_plain)
        x = norm(images, PIXEL_MEAN, PIXEL_STD, self.dtype)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            enc = self.encoder(self.backbone(x)["res5"])
            logits, deltas = self.decoder(enc)
        anchors = yolof_anchors(enc.shape[2], enc.shape[3],
                                device=enc.device)
        return {"logits": logits, "deltas": deltas, "anchors": anchors}


def _l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L1 distance over the last axis of 4, summed left to right: the same
    float32 sums on every device (a reduction kernel's order differs
    between the card and the CPU, and near-equal costs then swap)."""
    d = (x - y).abs()
    return ((d[..., 0] + d[..., 1]) + d[..., 2]) + d[..., 3]


def _smallest_k(cost: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest of the last axis, ascending, the lower
    index first among equal costs (``jax.lax.top_k`` of ``-cost``; a
    stable sort, since ``torch.topk`` promises no order among ties)."""
    return torch.sort(cost, dim=-1, stable=True).indices[..., :k]


def uniform_match(
    pred_boxes: torch.Tensor,   # [B, A, 4] xyxy, decoded
    anchors: torch.Tensor,      # [A, 4]
    gt_boxes: torch.Tensor,     # [B, G, 4]
    gt_valid: torch.Tensor,     # [B, G]
    num_classes: int = 80,
) -> Dict[str, torch.Tensor]:
    """UniformMatcher and the criterion's bookkeeping over a batch (JAX
    :189, which vmaps it over images). Each gt claims its ``MATCH_TOPK``
    nearest anchors by L1 distance in cxcywh, once by the predicted boxes
    and once by the anchors: 2 k occurrences a gt, laid out [k, 2, G]. An
    occurrence is pos-ignored where the anchor's IoU with its gt is below
    ``POS_IGNORE_THRESH``; ``base_cls`` is background, or -1 (ignore)
    where the predicted box overlaps a gt above ``NEG_IGNORE_THRESH``.
    Where occurrences share an anchor the last one wins (``winner``):
    each anchor's highest occurrence rank by an ``amax`` scatter, which
    has one answer on every device, where a plain scatter with repeated
    indices has none."""
    b, a, _ = pred_boxes.shape
    g = gt_boxes.shape[1]
    g_c = xyxy_to_cxcywh(gt_boxes)
    cost_p = _l1(g_c[:, :, None], xyxy_to_cxcywh(pred_boxes)[:, None])
    cost_a = _l1(g_c[:, :, None], xyxy_to_cxcywh(anchors)[None, None])
    idx_p = _smallest_k(cost_p, MATCH_TOPK)                  # [B, G, k]
    idx_a = _smallest_k(cost_a, MATCH_TOPK)
    occ_anchor = torch.stack([idx_p.transpose(1, 2), idx_a.transpose(1, 2)],
                             dim=2).reshape(b, -1)           # [B, 2kG]
    occ_gt = torch.arange(g, device=gt_boxes.device).expand(
        MATCH_TOPK, 2, g).reshape(-1).expand(b, -1)          # [B, 2kG]
    occ_valid = gt_valid.gather(1, occ_gt)

    iou_p = torch.where(gt_valid[..., None],
                        pairwise_box_iou(gt_boxes, pred_boxes), 0.0)
    iou_a = pairwise_box_iou(gt_boxes, anchors[None])        # [B, G, A]
    occ_pos_ignore = iou_a.reshape(b, g * a).gather(
        1, occ_gt * a + occ_anchor) < POS_IGNORE_THRESH

    base = torch.where(iou_p.amax(1) > NEG_IGNORE_THRESH, -1, num_classes)
    n = occ_anchor.shape[1]
    occ_rank = torch.arange(n, device=gt_boxes.device).expand(b, -1)
    slot = torch.where(occ_valid, occ_anchor, a)
    last_rank = torch.full((b, a + 1), -1, dtype=torch.long,
                           device=gt_boxes.device).scatter_reduce(
        1, slot, occ_rank, "amax")
    winner = occ_valid & (occ_rank == last_rank.gather(1, slot))
    return {
        "occ_anchor": occ_anchor,
        "occ_gt": occ_gt,
        "occ_valid": occ_valid,
        "occ_pos_ignore": occ_pos_ignore,
        "winner": winner,
        "base_cls": base.to(torch.int32),
    }


def class_map(m: Dict[str, torch.Tensor], gt_classes: torch.Tensor,
              num_anchors: int) -> torch.Tensor:
    """Each anchor's class target [B, A] int32: ``base_cls``, then every
    winning occurrence's class (-1 where it is pos-ignored). The winners
    are one an anchor, so the scatter has no repeated index but the
    dropped slot ``num_anchors``."""
    occ_cls = torch.where(m["occ_pos_ignore"], -1,
                          gt_classes.long().gather(1, m["occ_gt"]))
    slot = torch.where(m["winner"], m["occ_anchor"], num_anchors)
    base = F.pad(m["base_cls"].long(), (0, 1))
    return base.scatter(1, slot, occ_cls)[:, :num_anchors].to(torch.int32)


def yolof_losses(
    out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    num_classes: int,
) -> Dict[str, torch.Tensor]:
    """YOLOF's criterion (JAX :259): focal class loss over the anchors that
    are not ignored against the one-hot of foreground classes, GIoU on
    every occurrence that is valid and not pos-ignored (a shared anchor
    counts once an occurrence), both over the batch's foreground count
    (inside a process group, the global batch's). The matching runs
    without gradient."""
    logits, deltas, anchors = out["logits"], out["deltas"], out["anchors"]
    pred_boxes = decode_deltas(anchors[None], deltas)               # [B, A, 4]
    a = anchors.shape[0]
    with torch.no_grad():
        m = uniform_match(pred_boxes.detach(), anchors, batch["gt_boxes"],
                          batch["gt_valid"], num_classes=num_classes)
        cls_map = class_map(m, batch["gt_classes"], a).long()
    fg = (cls_map >= 0) & (cls_map != num_classes)
    valid = cls_map >= 0
    num_fg = all_reduce_sum(fg.float().sum()).clamp(min=1.0)
    cls_t = F.one_hot(torch.where(fg, cls_map, num_classes),
                      num_classes + 1)[..., :num_classes].float()
    loss_cls = (sigmoid_focal_loss(logits, cls_t)
                * valid[..., None]).sum() / num_fg
    occ_pred = pred_boxes.gather(
        1, m["occ_anchor"][..., None].expand(-1, -1, 4))
    occ_tgt = batch["gt_boxes"].gather(
        1, m["occ_gt"][..., None].expand(-1, -1, 4))
    occ_ok = (m["occ_valid"] & ~m["occ_pos_ignore"]).float()
    loss_box = (iou_loss(occ_pred, occ_tgt, "giou") * occ_ok).sum() / num_fg
    return {"loss_cls": loss_cls, "loss_box": loss_box, "num_fg": num_fg,
            "total_loss": loss_cls + loss_box}


def yolof_loss_fn(cfg):
    """The training loss of a ``YolofConfig`` (JAX ``engine.py:216``): the
    loss takes no L1 switch."""

    def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return yolof_losses(out, batch, cfg.num_classes)

    return loss_fn


def yolof_postprocess(
    out: Dict[str, torch.Tensor],
    score_thresh: float = 0.05,
    nms_thresh: float = 0.6,
    topk_candidates: int = 1000,
    max_detections: int = 100,
    nms: Callable = nms_batched,
) -> Detections:
    """YOLOF's inference (JAX :328): the sigmoid of every (anchor, class)
    pair, zero at or below ``score_thresh``, the top ``topk_candidates``
    by a stable sort (score descending, the lower index first among equal
    scores, as ``jax.lax.top_k`` keeps them), their deltas decoded, then
    class-aware NMS (the kernel's wrapper by default) and
    ``max_detections`` out."""
    logits, deltas, anchors = out["logits"], out["deltas"], out["anchors"]
    b, a, c = logits.shape
    probs = torch.sigmoid(logits.float()).reshape(b, a * c)
    probs = torch.where(probs > score_thresh, probs, 0.0)
    k = min(topk_candidates, a * c)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k].contiguous(), top_i[:, :k]
    anchor_i = top_i // c
    class_i = (top_i % c).to(torch.int32)
    cand_deltas = deltas.gather(1, anchor_i[..., None].expand(-1, -1, 4))
    boxes = decode_deltas(anchors[anchor_i], cand_deltas).contiguous()
    keep_idx, keep_valid = batched_nms_batched(
        boxes, top_p, class_i, nms_thresh, max_detections, nms=nms)
    gi = keep_idx.clamp(0, k - 1).long()
    return Detections(
        boxes=boxes.gather(1, gi[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep_valid, top_p.gather(1, gi), 0.0),
        classes=class_i.gather(1, gi),
        valid=keep_valid,
    )


@META_ARCH_REGISTRY.register(name="YOLOF")
def build_yolof(cfg, device="cuda", seed: int = 0) -> YOLOF:
    """YOLOF in eval mode on ``device`` from a ``YolofConfig`` (JAX :317),
    weights drawn from ``seed`` on the CPU. Like the JAX builder it reads
    ``MODEL.RESNETS.DEPTH``, ``NORM`` and ``STRIDE_IN_1X1`` only: res5
    stays at stride 32 whatever ``RES5_DILATION`` says, and the backbone
    is a ResNet whatever ``MODEL.BACKBONE.NAME`` says (ROADMAP.md C.24). A
    norm other than FrozenBN or BN raises: the JAX builder maps every other
    name to a trainable BatchNorm without a word (JAX :322)."""
    if cfg.resnet_norm not in ("FrozenBN", "BN"):
        raise NotImplementedError(
            f"YOLOF with MODEL.RESNETS.NORM {cfg.resnet_norm!r}: the port "
            "builds FrozenBN or BN only (the JAX build_yolof, meta_arch/"
            "yolof.py:322, silently takes any other norm for BN; ROADMAP.md "
            "C.2)")
    model = YOLOF(num_classes=cfg.num_classes,
                  resnet_depth=cfg.resnet_depth,
                  frozen_bn=cfg.resnet_norm == "FrozenBN",
                  stride_in_1x1=cfg.stride_in_1x1,
                  dtype=torch.bfloat16 if cfg.amp else torch.float32)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()
