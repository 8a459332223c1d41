"""YOLOv6: EfficientRep + RepPAN + EffiDeHead, and its loss (JAX
``models/meta_arch/yolov6.py``).

``YOLOV6.forward`` takes the letterboxed NHWC batch: a uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) in its identity
form, a cast into the model's channels_last layout (the JAX model casts,
nothing more); a float batch (after the training step's mixup) is cast.
The head's outputs have YOLOX's layout ``[reg 4 | obj 1 | cls C]`` with
its grids and strides, so the model serves through
``models/meta_arch/yolox.py:yolox_postprocess`` and the NMS kernel, as the
JAX package's YOLOX-layout tools serve it.

``EffiDeHead`` keeps the original reference's names (``stems.{l}``,
``cls_convs.{l}``, ``reg_convs.{l}``, ``{cls,reg,obj}_preds.{l}``), so that
``utils/weight_port.py:map_effidehead_torch_name`` applies.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.kernels.preprocess import normalize_images
from yolov7_d2_tpu_torch.models.backbones.efficientrep import EfficientRep
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.heads.yolox_head import (
    decode_outputs,
    level_grid,
    simota_assign,
)
from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv, at_least_f32
from yolov7_d2_tpu_torch.models.necks.reppan import RepPANNeck
from yolov7_d2_tpu_torch.ops.iou import iou_loss
from yolov7_d2_tpu_torch.ops.losses import sigmoid_binary_cross_entropy
from yolov7_d2_tpu_torch.parallel.dist import all_reduce_sum
from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy


class EffiDeHead(nn.Module):
    """Per level (JAX :29): a 1x1 stem, one 3x3 conv for the classes and
    one for the box, then 1x1 predictions; SiLU. Returns ``outputs`` [B,
    A, 5 + C] float32 (reg 4, obj 1, cls C), ``grids`` [A, 2] and
    ``strides`` [A], as ``YOLOXHead`` does."""

    strides = (8, 16, 32)

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80):
        super().__init__()
        self.stems = nn.ModuleList(BaseConv(c, c, 1, 1) for c in in_channels)
        self.cls_convs = nn.ModuleList(BaseConv(c, c, 3, 1)
                                       for c in in_channels)
        self.reg_convs = nn.ModuleList(BaseConv(c, c, 3, 1)
                                       for c in in_channels)
        self.cls_preds = nn.ModuleList(nn.Conv2d(c, num_classes, 1)
                                       for c in in_channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(c, 4, 1)
                                       for c in in_channels)
        self.obj_preds = nn.ModuleList(nn.Conv2d(c, 1, 1)
                                       for c in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        outs, grids, strides = [], [], []
        for lvl, (x, stride) in enumerate(zip(feats, self.strides)):
            x = self.stems[lvl](x)
            c = self.cls_convs[lvl](x)
            r = self.reg_convs[lvl](x)
            out = torch.cat([self.reg_preds[lvl](r), self.obj_preds[lvl](r),
                             self.cls_preds[lvl](c)], dim=1)
            b, _, h, w = out.shape
            outs.append(at_least_f32(
                out.permute(0, 2, 3, 1).reshape(b, h * w, -1)))
            grid, stride_vec = level_grid(h, w, stride, x.device)
            grids.append(grid)
            strides.append(stride_vec)
        return {"outputs": torch.cat(outs, dim=1),
                "grids": torch.cat(grids, dim=0),
                "strides": torch.cat(strides, dim=0)}


class YOLOV6(nn.Module):
    """backbone -> neck -> head (JAX :75). ``dtype`` is the compute dtype:
    bfloat16 runs under autocast over float32 parameters, with the RepVGG
    blocks' BatchNorms in float32 (``models/layers/blocks.py``)."""

    def __init__(self, num_classes: int = 80, width_mul: float = 0.5,
                 depth_mul: float = 0.33,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = EfficientRep(width_mul, depth_mul)
        feat = [self.backbone.out_channels[k]
                for k in ("erep3", "erep4", "erep5")]
        self.neck = RepPANNeck(feat, width_mul, depth_mul)
        self.head = EffiDeHead(self.neck.out_channels, num_classes)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        if images.dtype == torch.uint8:
            x = normalize_images(images, (0.0,) * 3, (1.0,) * 3, self.dtype)
        else:
            # NHWC memory seen as [B, 3, H, W] is channels_last already
            x = images.permute(0, 3, 1, 2).to(self.dtype)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            feats = self.backbone(x)
            neck_out = self.neck([feats["erep3"], feats["erep4"],
                                  feats["erep5"]])
            return self.head(neck_out)


def yolov6_losses(
    head_out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    num_classes: int,
) -> Dict[str, torch.Tensor]:
    """YOLOv6's loss (JAX :97): SimOTA over every anchor (no objectness
    prefilter, as the JAX function calls ``simota_assign`` directly), the
    CIoU box loss times 5, an L1 term on the raw box
    outputs that is always on, objectness BCE against the foreground and
    class BCE against the IoU-scaled one-hot; each term summed and divided
    by the batch's foreground count (inside a process group, the global
    batch's). The assignment runs without gradient."""
    outputs = at_least_f32(head_out["outputs"])       # [B, A, 5 + C]
    grids, strides = head_out["grids"], head_out["strides"]
    gt_boxes, gt_classes = batch["gt_boxes"], batch["gt_classes"]
    boxes_cxcywh, obj_logits, cls_logits = decode_outputs(outputs, grids,
                                                          strides)
    with torch.no_grad():
        assign = simota_assign(boxes_cxcywh, obj_logits, cls_logits, grids,
                               strides, gt_boxes, gt_classes,
                               batch["gt_valid"])
    fg_f = assign["fg_mask"].float()
    matched_gt = assign["matched_gt"]
    num_fg = all_reduce_sum(assign["num_fg"].sum()).clamp(min=1.0)
    tgt_boxes = gt_boxes.gather(1, matched_gt[..., None].expand(-1, -1, 4))
    tgt_classes = gt_classes.long().gather(1, matched_gt)

    loss_iou = (iou_loss(cxcywh_to_xyxy(boxes_cxcywh), tgt_boxes, "ciou")
                * fg_f).sum() / num_fg
    tgt_cxcywh = torch.cat([(tgt_boxes[..., 0:2] + tgt_boxes[..., 2:4]) / 2,
                            tgt_boxes[..., 2:4] - tgt_boxes[..., 0:2]], -1)
    s = strides[None, :, None]
    l1_t = torch.cat([tgt_cxcywh[..., 0:2] / s - grids[None],
                      torch.log(tgt_cxcywh[..., 2:4] / s + 1e-8)], -1)
    loss_l1 = (torch.abs(outputs[..., 0:4] - l1_t)
               * fg_f[..., None]).sum() / num_fg
    loss_obj = sigmoid_binary_cross_entropy(obj_logits, fg_f).sum() / num_fg
    cls_t = (F.one_hot(tgt_classes, num_classes).float()
             * assign["matched_iou"][..., None])
    loss_cls = (sigmoid_binary_cross_entropy(cls_logits, cls_t)
                * fg_f[..., None]).sum() / num_fg
    losses = {
        "loss_iou": 5.0 * loss_iou,
        "loss_l1": loss_l1,
        "loss_obj": loss_obj,
        "loss_cls": loss_cls,
        "num_fg": num_fg,
    }
    losses["total_loss"] = (losses["loss_iou"] + loss_l1 + loss_obj
                            + loss_cls)
    return losses


def yolov6_loss_fn(cfg):
    """The training loss of a ``Yolov6Config`` (JAX ``engine.py:211``): the
    loss takes no L1 switch."""

    def loss_fn(head_out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return yolov6_losses(head_out, batch, cfg.num_classes)

    return loss_fn


@META_ARCH_REGISTRY.register(name="YOLOV6")
def build_yolov6(cfg, device="cuda", seed: int = 0) -> YOLOV6:
    """YOLOV6 in eval mode on ``device`` (JAX :174): ``num_classes``,
    ``width_mul``, ``depth_mul`` and the compute dtype of ``cfg``; weights
    drawn from ``seed`` on the CPU."""
    model = YOLOV6(num_classes=cfg.num_classes, width_mul=cfg.width_mul,
                   depth_mul=cfg.depth_mul,
                   dtype=torch.bfloat16 if cfg.amp else torch.float32)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()
