"""YOLOX meta-architecture, its loss and its serving tail (JAX
``models/meta_arch/yolox.py:36-199``).

``YOLOX.forward`` takes the letterboxed NHWC batch: a uint8 batch goes
through the fused normalize kernel (``kernels/preprocess.py``) into the
model's layout, a float batch (after the training step's mixup) is cast
into it; then backbone, neck and head, in train or eval mode as the module
is. ``yolox_loss_fn`` is the training loss; ``yolox_postprocess`` ends in
the NMS kernel (``kernels/nms.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.kernels.nms import nms_batched
from yolov7_d2_tpu_torch.kernels.preprocess import normalize_images
from yolov7_d2_tpu_torch.models.backbones.darknetx import CSPDarknetX
from yolov7_d2_tpu_torch.models.backbones.zoo import (
    build_zoo_backbone,
    zoo_backbone_type,
)
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.heads.yolox_head import (
    WH_LOGIT_MAX,
    YOLOXHead,
    yolox_losses,
)
from yolov7_d2_tpu_torch.models.necks.yolo_pafpn import YOLOPAFPN
from yolov7_d2_tpu_torch.ops.nms import batched_nms_batched
from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy
from yolov7_d2_tpu_torch.structures.instances import Detections


class YOLOX(nn.Module):
    """backbone -> neck -> head; returns the raw head outputs with their
    grids and strides. ``dtype`` is the compute dtype: bfloat16 runs the
    convolutions under autocast over float32 parameters (the JAX
    ``dtype``/``param_dtype`` pair). A built ``backbone`` (with
    ``out_channels``; the zoo of ``models/backbones/zoo.py``) replaces
    CSPDarknet-X, and the neck takes its widths, which flax infers."""

    def __init__(self, num_classes: int = 80, depth_mul: float = 0.33,
                 width_mul: float = 0.50,
                 in_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 depthwise: bool = False, act: str = "silu",
                 normalize_input: bool = False,
                 backbone: Optional[nn.Module] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.in_features = tuple(in_features)
        self.dtype = dtype
        # NORMALIZE_INPUT divides by 255 (JAX yolox.py:58); otherwise the
        # normalize kernel is the cast to the compute dtype
        self.input_std = (255.0,) * 3 if normalize_input else (1.0,) * 3
        feat_channels = None
        if backbone is None:
            backbone = CSPDarknetX(depth_mul, width_mul, in_features,
                                   depthwise, act)
        else:
            feat_channels = [backbone.out_channels[f]
                             for f in self.in_features]
        self.backbone = backbone
        self.neck = YOLOPAFPN(depth_mul, width_mul, depthwise=depthwise,
                              act=act, feat_channels=feat_channels)
        self.head = YOLOXHead(num_classes, width_mul, depthwise=depthwise,
                              act=act)

    @property
    def generator(self) -> Optional[torch.Generator]:
        """The backbone's drop-path generator (ConvNeXt), else None."""
        return getattr(self.backbone, "generator", None)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        # channels_last: cuDNN's bf16 convolutions on Hopper are NHWC
        if images.dtype == torch.uint8:
            x = normalize_images(images, (0.0, 0.0, 0.0), self.input_std,
                                 self.dtype)
        else:
            # NHWC memory seen as [B, 3, H, W] is channels_last already;
            # the JAX model casts to the compute dtype, then divides
            x = images.permute(0, 3, 1, 2).to(self.dtype)
            if self.input_std[0] != 1.0:
                x = x / self.input_std[0]
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            feats = self.backbone(x)
            fpn_outs = self.neck([feats[f] for f in self.in_features])
            return self.head(fpn_outs)


def yolox_loss_fn(
    head_out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    num_classes: int,
    use_l1: bool = False,
    prefilter_topk: Optional[int] = 2048,
) -> Dict[str, torch.Tensor]:
    """The losses of a batch ``{"gt_boxes", "gt_classes", "gt_valid"}``."""
    return yolox_losses(
        head_out, batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
        num_classes, use_l1=use_l1, prefilter_topk=prefilter_topk)


def yolox_postprocess(
    head_out: Dict[str, torch.Tensor],
    conf_threshold: float = 0.01,
    nms_threshold: float = 0.65,
    max_detections: int = 100,
    pre_nms_topk: int = 1024,
    nms: Callable = nms_batched,
) -> Detections:
    """Confidence filter, pre-NMS top-k, decode and class-aware NMS, in the
    order of the JAX ``yolox_postprocess``. ``nms`` is the batched NMS
    (the kernel's wrapper by default)."""
    out = head_out["outputs"]                          # [B, A, 5+C]
    grids = head_out["grids"]                          # [A, 2]
    strides = head_out["strides"]                      # [A]
    # best class on the raw logits: sigmoid is monotone
    best_logit, best_cls = out[..., 5:].max(dim=-1)    # first index on ties
    obj = torch.sigmoid(out[..., 4].float())
    scores = obj * torch.sigmoid(best_logit.float())
    scores = torch.where(scores >= conf_threshold, scores, 0.0)

    k = min(pre_nms_topk, scores.shape[-1])
    top_idx = torch.topk(scores, k, dim=-1).indices.sort(dim=-1).values
    top_scores = scores.gather(1, top_idx)             # [B, K]
    top_cls = best_cls.gather(1, top_idx)              # [B, K]
    top_raw = out[..., :4].gather(
        1, top_idx[..., None].expand(-1, -1, 4)).float()
    top_grids = grids[top_idx]                         # [B, K, 2]
    top_strides = strides[top_idx][..., None]          # [B, K, 1]

    # decode after the gather: only the K kept rows
    xy = (top_raw[..., 0:2] + top_grids) * top_strides
    wh = torch.exp(top_raw[..., 2:4].clamp(max=WH_LOGIT_MAX)) * top_strides
    top_boxes = cxcywh_to_xyxy(torch.cat([xy, wh], dim=-1)).contiguous()

    keep_idx, keep_valid = batched_nms_batched(
        top_boxes, top_scores.contiguous(), top_cls, nms_threshold,
        max_detections, nms=nms)
    sel = keep_idx.clamp(min=0).long()                 # [B, M]
    return Detections(
        boxes=top_boxes.gather(1, sel[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep_valid, top_scores.gather(1, sel), 0.0),
        classes=top_cls.gather(1, sel).to(torch.int32),
        valid=keep_valid,
    )


@META_ARCH_REGISTRY.register(name="YOLOX")
def build_yolox(cfg: YoloxConfig, device="cuda", seed: int = 0) -> YOLOX:
    """YOLOX in eval mode on ``device``, weights drawn from ``seed`` (on
    the CPU, so that every device starts from the same numbers). A zoo
    backbone's name (JAX :183-188 resolves any registered one) builds it
    from ``cfg.zoo``; ConvNeXt's drop-path generator goes on ``device``,
    seeded with ``seed``."""
    backbone = None
    if cfg.backbone != "build_cspdarknetx_backbone":
        if zoo_backbone_type(cfg.backbone) is None:
            raise NotImplementedError(
                f"backbone {cfg.backbone!r} is not ported yet (ROADMAP.md "
                "Queue A.8e)")
        backbone = build_zoo_backbone(cfg)
    model = YOLOX(
        num_classes=cfg.num_classes, depth_mul=cfg.depth_mul,
        width_mul=cfg.width_mul, in_features=cfg.in_features,
        depthwise=cfg.depthwise, normalize_input=cfg.normalize_input,
        backbone=backbone,
        dtype=torch.bfloat16 if cfg.amp else torch.float32,
    )
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    if hasattr(model.backbone, "generator"):
        model.backbone.generator = torch.Generator(
            device=torch.device(device)).manual_seed(seed)
    return model.eval()
