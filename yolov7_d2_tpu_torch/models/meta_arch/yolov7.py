"""The anchor-based YOLO meta-architectures: ``YOLO`` (v3), ``YOLOV7`` (the
flagship) and ``YOLOV7P``, their loss and their serving tail (JAX
``models/meta_arch/yolov7.py``).

``AnchorYOLO.forward`` takes the letterboxed NHWC batch: a uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) in its identity
form, a cast into the model's channels_last layout; a float batch (after
the training step's mixup) is cast. YOLOV7P then applies its pixel mean and
std as the JAX model does, ``(x / 255 - mean) / std`` in the compute dtype.
``anchor_yolo_postprocess`` ends in the NMS kernel (``kernels/nms.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.config.anchor_yolo import (
    AnchorYoloConfig,
    anchors_from_cfg as _anchors_from_cfg,  # noqa: F401 (the JAX name)
)
from yolov7_d2_tpu_torch.kernels.nms import nms_batched
from yolov7_d2_tpu_torch.kernels.preprocess import normalize_images
from yolov7_d2_tpu_torch.models.backbones.darknet import Darknet53
from yolov7_d2_tpu_torch.models.backbones.darknetx import CSPDarknetX
from yolov7_d2_tpu_torch.models.backbones.yolov5 import (
    build_yolov5_backbone,
)
from yolov7_d2_tpu_torch.models.build import (
    META_ARCH_REGISTRY,
    init_weights_,
)
from yolov7_d2_tpu_torch.models.heads.anchor_yolo_head import (
    AnchorYOLOHead,
    anchor_yolo_losses,
    decode_anchor_outputs,
    flatten_anchor_outputs,
)
from yolov7_d2_tpu_torch.models.necks.yolo_fpn import (
    OUT_CHANNELS as FPN_CHANNELS,
)
from yolov7_d2_tpu_torch.models.necks.bifpn import BiFPN
from yolov7_d2_tpu_torch.models.necks.reppan import PPYOLOPAN
from yolov7_d2_tpu_torch.models.necks.yolo_fpn import YOLOFPN
from yolov7_d2_tpu_torch.models.necks.yolo_pafpn import YOLOPAFPN
from yolov7_d2_tpu_torch.models.registries import build_backbone
from yolov7_d2_tpu_torch.ops.nms import batched_nms_batched
from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy
from yolov7_d2_tpu_torch.structures.instances import Detections

LEVEL_STRIDES = (8, 16, 32)
DEFAULT_ANCHORS = AnchorYoloConfig.anchors


class AnchorYOLO(nn.Module):
    """backbone -> neck -> anchor head; returns the flattened outputs
    (``flatten_anchor_outputs``) and ``level_hw``. ``dtype`` is the compute
    dtype: bfloat16 runs under autocast over float32 parameters. A built
    ``backbone`` (with ``out_channels``) overrides ``backbone_type``. The
    neck is YOLOPAFPN (``pafpn``), BiFPN at its defaults (``bifpn``: 160
    channels, the head on the first three of its five levels), PP-YOLO's
    PAN (``pan`` / ``ppyolo_pan``, whose DropBlocks draw from
    ``generator`` in train mode) or YOLOFPN (any other name), as the JAX
    model chooses (JAX :104-122)."""

    def __init__(self, num_classes: int = 80,
                 anchors: Tuple = DEFAULT_ANCHORS,
                 backbone_type: str = "darknet53",
                 neck_type: str = "yolov3",
                 in_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 with_spp: bool = False, width_mul: float = 1.0,
                 depth_mul: float = 1.0, act: str = "lrelu",
                 backbone: Optional[nn.Module] = None,
                 head_style: str = "tower",
                 pixel_mean: Optional[Sequence[float]] = None,
                 pixel_std: Optional[Sequence[float]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.anchors = tuple(anchors)
        self.in_features = tuple(in_features)
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.dtype = dtype
        if backbone is None:
            if backbone_type == "cspdarknetx":
                backbone = CSPDarknetX(depth_mul, width_mul, in_features,
                                       act="silu")
            else:
                backbone = Darknet53(out_features=in_features,
                                     with_csp=backbone_type == "cspdarknet53",
                                     act=act)
        self.backbone = backbone
        feat_channels = [backbone.out_channels[f] for f in self.in_features]
        if neck_type == "pafpn":
            self.neck = YOLOPAFPN(depth_mul, width_mul, act="silu",
                                  feat_channels=feat_channels)
            neck_channels = [int(c * width_mul) for c in (256, 512, 1024)]
        elif neck_type == "bifpn":
            # the head takes the stride-8/16/32 levels of the five
            self.neck = BiFPN(feat_channels)
            neck_channels = [self.neck.out_channels] * 3
        elif neck_type in ("pan", "ppyolo_pan"):
            self.neck = PPYOLOPAN(feat_channels, with_spp=with_spp)
            neck_channels = list(self.neck.out_channels)
        else:
            self.neck = YOLOFPN(feat_channels, with_spp=with_spp, act=act)
            neck_channels = list(FPN_CHANNELS)
        self.head = AnchorYOLOHead(neck_channels, num_classes,
                                   len(self.anchors[0]), act=act,
                                   direct_pred=head_style == "direct")

    @property
    def generator(self) -> Optional[torch.Generator]:
        """The generator of PP-YOLO's DropBlocks or ConvNeXt's drop path
        (one, :func:`_finish`), else None."""
        return (getattr(self.neck, "generator", None)
                or getattr(self.backbone, "generator", None))

    def forward(self, images: torch.Tensor,
                return_pyramid: bool = False) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch. With
        ``return_pyramid`` the neck's levels come out too, as ``pyramid``
        (YOLOMask's orientation head taps them, JAX :88-101)."""
        if images.dtype == torch.uint8:
            x = normalize_images(images, (0.0,) * 3, (1.0,) * 3, self.dtype)
        else:
            # NHWC memory seen as [B, 3, H, W] is channels_last already
            x = images.permute(0, 3, 1, 2).to(self.dtype)
        if self.pixel_mean is not None:
            shape = (1, 3, 1, 1)
            mean = torch.tensor(self.pixel_mean, dtype=self.dtype,
                                device=x.device).reshape(shape)
            std = torch.tensor(self.pixel_std, dtype=self.dtype,
                               device=x.device).reshape(shape)
            x = (x / 255.0 - mean) / std
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            feats = self.backbone(x)
            neck_out = self.neck([feats[f] for f in self.in_features])
            level_outputs = self.head(neck_out[:3])
        flat = flatten_anchor_outputs(level_outputs, self.anchors,
                                      LEVEL_STRIDES)
        flat["level_hw"] = tuple((o.shape[2], o.shape[3])
                                 for o in level_outputs)
        if return_pyramid:
            flat["pyramid"] = tuple(neck_out)
        return flat


def anchor_yolo_loss_fn(
    flat: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    anchors,
    num_classes: int,
    variant: str = "yolov7",
    build_target_type: str = "default",
    iou_type: str = "ciou",
    loss_type: str = "v7",
    ignore_threshold: float = 0.7,
    lambdas: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """The losses of a batch ``{"gt_boxes", "gt_classes", "gt_valid"}``."""
    return anchor_yolo_losses(
        flat, batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
        anchors=anchors, level_hw=flat["level_hw"],
        level_strides=LEVEL_STRIDES, num_classes=num_classes,
        variant=variant, build_target_type=build_target_type,
        iou_type=iou_type, loss_type=loss_type,
        ignore_threshold=ignore_threshold, **(lambdas or {}))


def yolo_nms_postprocess(
    boxes: torch.Tensor,            # [B, A, 4] xyxy
    obj: torch.Tensor,              # [B, A] probabilities
    cls_prob: torch.Tensor,         # [B, A, C] probabilities
    conf_threshold: float = 0.01,
    nms_threshold: float = 0.5,
    max_detections: int = 100,
    pre_nms_topk: int = 1024,
    v5_gate: bool = False,
    nms: Callable = nms_batched,
) -> Detections:
    """Best class per anchor, the confidence gate (obj * class_conf, or obj
    alone for ``v5_gate``), the pre-NMS top-k and class-aware greedy NMS
    ranked by obj * class_conf (JAX :166). The top-k keeps
    ``jax.lax.top_k``'s order, score descending and the lower index first
    among equal scores, by a stable sort: ``torch.topk`` promises no order
    among ties, and the greedy NMS takes the first of equal scores.
    ``nms`` is the batched NMS (the kernel's wrapper by default)."""
    best_cls = torch.argmax(cls_prob, dim=-1)          # first index on ties
    combined = obj * cls_prob.amax(dim=-1)
    gate = (obj >= conf_threshold) if v5_gate else (
        combined >= conf_threshold)
    scores = torch.where(gate, combined, 0.0)

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
    sel = keep_idx.clamp(min=0).long()
    return Detections(
        boxes=top_boxes.gather(1, sel[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep_valid, top_scores.gather(1, sel), 0.0),
        classes=top_cls.gather(1, sel).to(torch.int32),
        valid=keep_valid,
    )


def anchor_yolo_postprocess(
    flat: Dict[str, torch.Tensor],
    variant: str = "yolov7",
    conf_threshold: float = 0.01,
    nms_threshold: float = 0.5,
    max_detections: int = 100,
    pre_nms_topk: int = 1024,
    nms: Callable = nms_batched,
) -> Detections:
    """Decode, then :func:`yolo_nms_postprocess` (JAX :209); the v5 arch
    gates on objectness alone."""
    boxes_cxcywh, obj_logits, cls_logits = decode_anchor_outputs(flat,
                                                                 variant)
    return yolo_nms_postprocess(
        cxcywh_to_xyxy(boxes_cxcywh), torch.sigmoid(obj_logits),
        torch.sigmoid(cls_logits), conf_threshold=conf_threshold,
        nms_threshold=nms_threshold, max_detections=max_detections,
        pre_nms_topk=pre_nms_topk, v5_gate=(variant == "yolov5"), nms=nms)


# the builtin darknets (JAX :240); every other registered name comes from
# ``models/registries.build_backbone`` (JAX :301-304, :328-331)
_BACKBONE_NAME_MAP = {
    "build_darknet_backbone": "darknet53",
    "build_cspdarknet_backbone": "cspdarknet53",
    "build_cspdarknetx_backbone": "cspdarknetx",
}


def _backbone(cfg: AnchorYoloConfig):
    """(backbone type, built backbone): a builtin darknet's type and None
    (``AnchorYOLO`` builds it), else the registered backbone
    ``cfg.backbone`` names (its ResNet from ``cfg.resnet``, Res2Net from
    ``cfg.r2type``, Swin and PVTv2 from their fields, the zoo from
    ``cfg.zoo``, the others from the config's ``CfgNode``)."""
    if cfg.backbone in _BACKBONE_NAME_MAP:
        return _BACKBONE_NAME_MAP[cfg.backbone], None
    return "registered", build_backbone(cfg)


def _finish(model: AnchorYOLO, device, seed: int) -> AnchorYOLO:
    """Weights from ``seed`` (drawn on the CPU, so that every device starts
    from the same numbers), on ``device``, channels_last, eval mode; with
    PP-YOLO's PAN (DropBlock) or ConvNeXt (drop path), one generator for
    their masks on ``device`` seeded with ``seed``."""
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    if isinstance(model.neck, PPYOLOPAN):
        model.neck.generator = gen
    if hasattr(model.backbone, "generator"):
        model.backbone.generator = gen
    return model.eval()


def _dtype(cfg: AnchorYoloConfig) -> torch.dtype:
    """The compute dtype; a config without the anchor fields raises (the
    CLIs read a ``YoloxConfig``: they train and serve YOLOX only, as the
    JAX ``train_det.py`` and ``demo.py`` do)."""
    if not isinstance(cfg, AnchorYoloConfig):
        raise NotImplementedError(
            f"{cfg.meta_architecture} takes an AnchorYoloConfig; the CLIs "
            "build YOLOX only: train this family with engine.build_system "
            "and serve it with build_model + anchor_yolo_postprocess")
    return torch.bfloat16 if cfg.amp else torch.float32


@META_ARCH_REGISTRY.register(name="YOLO")
def build_yolo(cfg: AnchorYoloConfig, device="cuda",
               seed: int = 0) -> AnchorYOLO:
    """YOLO v3 (JAX :248): Darknet53 (CSP if ``darknet_with_csp``),
    YOLOFPN, leaky ReLU."""
    dtype = _dtype(cfg)
    return _finish(AnchorYOLO(
        num_classes=cfg.num_classes, anchors=cfg.anchors,
        backbone_type=("cspdarknet53" if cfg.darknet_with_csp
                       else "darknet53"),
        neck_type="yolov3", in_features=cfg.in_features,
        with_spp=cfg.with_spp, dtype=dtype), device, seed)


@META_ARCH_REGISTRY.register(name="YOLOV5")
def build_yolov5(cfg: AnchorYoloConfig, device="cuda",
                 seed: int = 0) -> AnchorYOLO:
    """YOLOV5 (JAX :261): the YOLOv5 backbone of ``width_mul``'s size,
    YOLOPAFPN on c3/c4/c5, the 3x3-tower head, SiLU. It trains with the
    ratio target builder and serves with the objectness gate
    (``anchor_yolo_postprocess`` variant ``yolov5``)."""
    dtype = _dtype(cfg)
    return _finish(AnchorYOLO(
        num_classes=cfg.num_classes, anchors=cfg.anchors,
        backbone=build_yolov5_backbone(cfg), neck_type="pafpn",
        in_features=("c3", "c4", "c5"), width_mul=cfg.width_mul,
        depth_mul=cfg.depth_mul, act="silu", dtype=dtype), device, seed)


@META_ARCH_REGISTRY.register(name="YOLOV7P")
def build_yolov7p(cfg: AnchorYoloConfig, device="cuda",
                  seed: int = 0) -> AnchorYOLO:
    """YOLOV7P (JAX :284): PAFPN, the direct 1x1 head, pixel mean and
    std. The width and depth multipliers stay 1.0, as in the JAX builder.
    ``configs/coco/r50.yaml`` gives it a ResNet-50 (FrozenBN)."""
    dtype = _dtype(cfg)
    backbone_type, backbone = _backbone(cfg)
    return _finish(AnchorYOLO(
        num_classes=cfg.num_classes, anchors=cfg.anchors,
        backbone_type=backbone_type, backbone=backbone, neck_type="pafpn",
        in_features=cfg.in_features, act="silu", head_style="direct",
        pixel_mean=cfg.pixel_mean, pixel_std=cfg.pixel_std,
        dtype=dtype), device, seed)


@META_ARCH_REGISTRY.register(name="YOLOV7")
def build_yolov7(cfg: AnchorYoloConfig, device="cuda",
                 seed: int = 0) -> AnchorYOLO:
    """YOLOV7 (JAX :308): a darknet backbone, the neck of ``neck_type``
    (``pafpn``; any other name but ``bifpn`` / ``pan`` / ``ppyolo_pan`` is
    YOLOFPN), the 3x3-tower head, SiLU."""
    dtype = _dtype(cfg)
    neck = cfg.neck_type if cfg.neck_type in (
        "pafpn", "bifpn", "pan", "ppyolo_pan") else "yolov3"
    backbone_type, backbone = _backbone(cfg)
    return _finish(AnchorYOLO(
        num_classes=cfg.num_classes, anchors=cfg.anchors,
        backbone_type=backbone_type, backbone=backbone, neck_type=neck,
        in_features=cfg.in_features, with_spp=cfg.with_spp,
        width_mul=cfg.width_mul, depth_mul=cfg.depth_mul, act="silu",
        dtype=dtype), device, seed)
