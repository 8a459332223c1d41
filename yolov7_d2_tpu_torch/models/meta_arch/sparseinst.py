"""SparseInst, NMS-free instance segmentation (JAX
``models/meta_arch/sparseinst.py``): the model, its loss and its serving
tail.

``SparseInst.forward`` takes the letterboxed NHWC batch. A uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) with SparseInst's
ImageNet mean and std, which the JAX model hard-codes (:255-257,
independent of ``MODEL.PIXEL_MEAN``); the kernel computes the JAX line's
``(x - mean) / std`` in float32 and rounds once to the compute dtype. Then
ResNet (``backbones/resnet.py``, FrozenBN), the FPN-PPM encoder and the IAM
decoder, in bf16 under autocast over float32 parameters where the config
asks for AMP. The JAX model computes some parts in float32 whatever its
dtype; so does this one, outside autocast: the IAM sigmoid, the
aggregation of instance features, the ``fc`` / ``cls_score`` /
``mask_kernel`` / ``objectness`` layers on them, the mask features and the
mask-logit product.

Parameter names are the original reference's (``encoder.fpn_laterals.N``
deepest first, ``encoder.ppm.stages.i.1``, ``decoder.inst_branch.
inst_convs.2k``, ``decoder.mask_branch.projection``, ...), so that the
JAX package's name maps apply (``utils/weight_port.py``).

The loss matches predictions to ground truths with the batched auction
(``ops/matchers.py``); the tail ranks the 100 proposals by a stable
descending sort, so that equal scores keep ``jax.lax.top_k``'s order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.sparseinst import SparseInstConfig
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
from yolov7_d2_tpu_torch.ops.losses import (
    sigmoid_binary_cross_entropy,
    sigmoid_focal_loss,
)
from yolov7_d2_tpu_torch.ops.matchers import hungarian_match
from yolov7_d2_tpu_torch.parallel.dist import all_reduce_sum
from yolov7_d2_tpu_torch.structures.instances import Detections

# sparseinst.py:255-256 of the JAX package (ImageNet statistics, BGR)
PIXEL_MEAN = (103.53, 116.28, 123.675)
PIXEL_STD = (57.375, 57.12, 58.395)


def _float32(device: torch.device):
    """A region outside autocast, where the JAX model computes in f32."""
    return torch.autocast(device.type, enabled=False)


def _resize(x: torch.Tensor, size, antialias: bool = False) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` on NCHW: half-pixel centres
    (``align_corners=False``). Where ``x`` takes a gradient the backward is
    :class:`_BilinearResize`'s, in a fixed order."""
    if x.requires_grad and not antialias and torch.is_grad_enabled():
        return _BilinearResize.apply(x, tuple(size))
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=antialias)


def bilinear_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """[n_out, n_in] float32: row i holds the two weights with which
    ``F.interpolate(mode="bilinear", align_corners=False)`` mixes the
    input along one axis into output i (source ``(i + 0.5) * n_in / n_out
    - 0.5``, clamped at 0; the upper neighbour clamped at the edge)."""
    scale = torch.tensor(n_in, dtype=torch.float32) / n_out
    src = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * scale
           - 0.5).clamp(min=0.0)
    i0 = src.long()
    lam = src - i0
    i1 = (i0 + 1).clamp(max=n_in - 1)
    rows = torch.arange(n_out)
    m = torch.zeros(n_out, n_in)
    m.index_put_((rows, i0), 1.0 - lam)
    m.index_put_((rows, i1), lam, accumulate=True)
    return m.to(device)


class _BilinearResize(torch.autograd.Function):
    """``F.interpolate`` bilinear forward (the same values); the backward
    as two products with the axes' interpolation matrices
    (:func:`bilinear_matrix`), in float32: every input's gradient summed in
    a fixed order.
    CUDA's own bilinear backward adds into each input with atomics, in
    whatever order the threads run, so two runs of a step part there
    (ROADMAP.md C.14)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size) -> torch.Tensor:
        ctx.in_hw = x.shape[-2:]
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (h, w), (ho, wo) = ctx.in_hw, grad.shape[-2:]
        mh = bilinear_matrix(ho, h, grad.device)
        mw = bilinear_matrix(wo, w, grad.device)
        return (mh.t() @ grad.float() @ mw).to(grad.dtype), None


class CeilAvgPool(nn.Module):
    """The reference's adaptive pool to ``size``: window and stride
    ``ceil(H / size)`` (at least 1), no padding. Not
    ``AdaptiveAvgPool2d``: a 20x20 map pools to 2x2 at size 3."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh = max(math.ceil(x.shape[2] / self.size), 1)
        kw = max(math.ceil(x.shape[3] / self.size), 1)
        return F.avg_pool2d(x, (kh, kw), (kh, kw))


class PyramidPoolingModule(nn.Module):
    """PPM on C5 (JAX :39): for each pool size, pool, 1x1 to C/4, ReLU and
    bilinear back to the input's size in float32; concat with the input
    last; 1x1 ``bottleneck`` to C, ReLU."""

    def __init__(self, channels: int, pool_sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(CeilAvgPool(ps), nn.Conv2d(channels, channels // 4, 1))
            for ps in pool_sizes)
        self.bottleneck = nn.Conv2d(channels + len(pool_sizes) * (channels // 4),
                                    channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        outs = []
        for stage in self.stages:
            p = F.relu(stage(x).float())
            with _float32(x.device):
                outs.append(_resize(p, (h, w)).to(x.dtype))
        outs.append(x)
        return F.relu(self.bottleneck(torch.cat(outs, 1)).float()).to(x.dtype)


class InstanceContextEncoder(nn.Module):
    """FPN over (res3, res4, res5) with the PPM on the res5 lateral, fused
    at 1/8 (JAX :75): ``fusion`` over [out3, up(out4), up(out5)]."""

    def __init__(self, in_channels: Sequence[int], channels: int = 256):
        super().__init__()
        c3, c4, c5 = in_channels
        self.fpn_laterals = nn.ModuleList(
            nn.Conv2d(c, channels, 1) for c in (c5, c4, c3))
        self.fpn_outputs = nn.ModuleList(
            nn.Conv2d(channels, channels, 3, padding=1) for _ in range(3))
        self.ppm = PyramidPoolingModule(channels)
        self.fusion = nn.Conv2d(3 * channels, channels, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        c3, c4, c5 = feats
        p5 = self.ppm(self.fpn_laterals[0](c5))
        p4 = self.fpn_laterals[1](c4) + F.interpolate(p5, scale_factor=2)
        p3 = self.fpn_laterals[2](c3) + F.interpolate(p4, scale_factor=2)
        o5, o4, o3 = (conv(p) for conv, p in zip(self.fpn_outputs,
                                                  (p5, p4, p3)))
        size = o3.shape[2:]
        fused = torch.cat([o3, _resize(o4, size).to(o3.dtype),
                           _resize(o5, size).to(o3.dtype)], 1)
        return self.fusion(fused)


def coord_features(x: torch.Tensor) -> torch.Tensor:
    """Prepend the normalized coordinates, x then y, in [-1, 1] (JAX
    :124)."""
    b, _, h, w = x.shape
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([xx, yy])[None].expand(b, 2, h, w).to(x.dtype)
    return torch.cat([coords, x], 1)


def _conv_relu_stack(c_in: int, dim: int, n: int) -> nn.Sequential:
    """n 3x3 convolutions, each followed by a ReLU (at indices 2k, 2k+1)."""
    layers = []
    for i in range(n):
        layers += [nn.Conv2d(c_in if i == 0 else dim, dim, 3, padding=1),
                   nn.ReLU()]
    return nn.Sequential(*layers)


class InstanceBranch(nn.Module):
    """The instance convolutions, the (grouped) IAM convolution and the
    linear heads on the aggregated instance features; ``fc`` only for
    more than one group, at the expanded width ``dim * groups``."""

    def __init__(self, c_in: int, dim: int, convs: int, num_masks: int,
                 groups: int, num_classes: int, kernel_dim: int):
        super().__init__()
        self.inst_convs = _conv_relu_stack(c_in, dim, convs)
        self.iam_conv = nn.Conv2d(dim, num_masks * groups, 3, padding=1,
                                  groups=groups)
        expand = dim * groups
        if groups > 1:
            self.fc = nn.Linear(expand, expand)
        self.cls_score = nn.Linear(expand, num_classes)
        self.mask_kernel = nn.Linear(expand, kernel_dim)
        self.objectness = nn.Linear(expand, 1)


class MaskBranch(nn.Module):
    def __init__(self, c_in: int, dim: int, convs: int, kernel_dim: int):
        super().__init__()
        self.mask_convs = _conv_relu_stack(c_in, dim, convs)
        self.projection = nn.Conv2d(dim, kernel_dim, 1)


class IAMDecoder(nn.Module):
    """``BaseIAMDecoder`` (groups 1) and ``GroupIAMDecoder`` (JAX :141).
    Returns ``cls_logits`` [B, N, C], ``obj_logits`` [B, N],
    ``mask_logits`` [B, N, Hm, Wm] (float32, ``scale_factor`` times the
    input's size) and ``iam`` [B, G*N, H, W] (the activation maps'
    probabilities, NCHW)."""

    def __init__(self, in_channels: int = 256, num_masks: int = 100,
                 num_classes: int = 80, kernel_dim: int = 128,
                 inst_dim: int = 256, inst_convs: int = 4,
                 mask_dim: int = 256, mask_convs: int = 4, groups: int = 1,
                 scale_factor: float = 2.0):
        super().__init__()
        self.num_masks = num_masks
        self.groups = groups
        self.scale_factor = scale_factor
        self.inst_branch = InstanceBranch(
            in_channels + 2, inst_dim, inst_convs, num_masks, groups,
            num_classes, kernel_dim)
        self.mask_branch = MaskBranch(in_channels + 2, mask_dim, mask_convs,
                                      kernel_dim)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, _, h, w = features.shape
        x = coord_features(features)
        ib, mb = self.inst_branch, self.mask_branch
        y = ib.inst_convs(x)
        iam = ib.iam_conv(y)
        with _float32(x.device):
            iam_prob = torch.sigmoid(iam.float())
            iam_flat = iam_prob.flatten(2)                     # [B, GN, P]
            norm = iam_flat.sum(-1, keepdim=True).clamp(
                min=1e-6, max=1e5 if self.groups > 1 else None)
            inst = torch.bmm(iam_flat / norm,
                             y.float().flatten(2).transpose(1, 2))
            if self.groups > 1:
                inst = inst.reshape(b, self.groups, self.num_masks, -1)
                inst = inst.transpose(1, 2).reshape(b, self.num_masks, -1)
                inst = F.relu(ib.fc(inst))
            cls_logits = ib.cls_score(inst)
            kernels = ib.mask_kernel(inst)
            obj_logits = ib.objectness(inst)[..., 0]
        mask_features = mb.projection(mb.mask_convs(x))
        with _float32(x.device):
            mask_logits = torch.bmm(
                kernels, mask_features.float().flatten(2)).reshape(
                b, self.num_masks, h, w)
            if self.scale_factor != 1.0:
                mask_logits = _resize(mask_logits,
                                      (int(h * self.scale_factor),
                                       int(w * self.scale_factor)))
        return {"cls_logits": cls_logits, "obj_logits": obj_logits,
                "mask_logits": mask_logits, "iam": iam_prob}


class SparseInst(nn.Module):
    """normalize -> ResNet (res3-res5) -> encoder -> IAM decoder (JAX
    :233). ``dtype`` is the compute dtype: bfloat16 runs under autocast
    over float32 parameters."""

    def __init__(self, num_classes: int = 80, num_masks: int = 100,
                 kernel_dim: int = 128, groups: int = 1,
                 encoder_channels: int = 256,
                 resnet: ResNetSpec = ResNetSpec(),
                 in_features: Sequence[str] = ("res3", "res4", "res5"),
                 scale_factor: float = 2.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = tuple(in_features)
        self.dtype = dtype
        # the JAX SparseInst always freezes its BN and returns in_features
        self.backbone = ResNet(ResNetSpec(
            depth=resnet.depth, vd=resnet.vd, out_features=self.in_features,
            frozen_bn=True, stride_in_1x1=resnet.stride_in_1x1,
            deform_on_per_stage=resnet.deform_on_per_stage))
        self.encoder = InstanceContextEncoder(
            [RESNET_CHANNELS[f] for f in self.in_features], encoder_channels)
        self.decoder = IAMDecoder(
            encoder_channels, num_masks=num_masks, num_classes=num_classes,
            kernel_dim=kernel_dim, groups=groups, scale_factor=scale_factor)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        norm = (normalize_images if images.dtype == torch.uint8
                else normalize_images_plain)
        x = norm(images, PIXEL_MEAN, PIXEL_STD, self.dtype)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype == torch.bfloat16):
            feats = self.backbone(x)
            fused = self.encoder([feats[f] for f in self.in_features])
            return self.decoder(fused)


# ---------------------------------------------------------------------------
# matcher and criterion
# ---------------------------------------------------------------------------

@torch.no_grad()
def sparseinst_match(out: Dict[str, torch.Tensor], gt_masks: torch.Tensor,
                     gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                     alpha: float = 0.8, beta: float = 0.2):
    """The assignment that maximizes dice^alpha * prob^beta (JAX :293):
    ``gt_masks`` [B, G, Hm, Wm] at the mask logits' size. Returns
    ``pred_of_gt`` [B, G] (0 where unmatched), ``match_ok`` [B, G] and the
    auction's rounds an image [B]."""
    pm = torch.sigmoid(out["mask_logits"].float()).flatten(2)  # [B, N, P]
    gm = gt_masks.flatten(2).float()                           # [B, G, P]
    n = pm.shape[1]
    inter2 = 2.0 * torch.bmm(pm, gm.transpose(1, 2))           # [B, N, G]
    den2 = ((pm * pm).sum(-1)[:, :, None]
            + (gm * gm).sum(-1)[:, None, :])
    dice = inter2 / (den2 + 1e-4)
    prob = torch.sigmoid(out["cls_logits"].float())            # [B, N, C]
    cls_prob = prob.gather(
        2, gt_classes.long().clamp(min=0)[:, None, :].expand(-1, n, -1))
    score = dice ** alpha * cls_prob ** beta
    cost = -score.transpose(1, 2)                              # [B, G, N]
    col_valid = torch.ones(cost.shape[0], n, dtype=torch.bool,
                           device=cost.device)
    pred_of_gt, _, iters = hungarian_match(cost, gt_valid.bool(), col_valid)
    match_ok = (pred_of_gt >= 0) & gt_valid.bool()
    return pred_of_gt.clamp(min=0), match_ok, iters


def sparseinst_losses(
    out: Dict[str, torch.Tensor],
    gt_masks_full: torch.Tensor,   # [B, G, H, W] binary, input resolution
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    class_weight: float = 2.0,
    mask_pixel_weight: float = 5.0,
    mask_dice_weight: float = 2.0,
    objectness_weight: float = 1.0,
    match: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """SparseInstCriterion (JAX :330): the gt masks resized bilinear (no
    antialias) to the logits' size as float32 soft targets; focal loss over
    every proposal, dice, pixel BCE and the IoU-aware objectness on the
    matched pairs; each divided by the matched count of the global batch
    (summed over the ranks of a process group, as the JAX count over a
    data mesh). ``match`` is ``(pred_of_gt, match_ok)`` [B, G] where the
    caller matched already (the one-process reference of the data-parallel
    checks takes the ranks'). Adds ``match_iters``, the auction's rounds
    for the batch (its slowest image; 0 with ``match``), and ``match``,
    the assignment the terms used (not a metric: the train step keeps it
    as ``TrainState.match``), to the JAX dict."""
    mask_logits = out["mask_logits"]
    b, n, hm, wm = mask_logits.shape
    g = gt_masks_full.shape[1]
    gt_small = _resize(gt_masks_full.float(), (hm, wm))        # [B, G, Hm, Wm]
    if match is None:
        pred_of_gt, match_ok, iters = sparseinst_match(
            out, gt_small, gt_classes, gt_valid)
    else:
        (pred_of_gt, match_ok) = match
        iters = torch.zeros(1, device=mask_logits.device)
    ok = match_ok.float()
    num_inst = all_reduce_sum(ok.sum()).clamp(min=1.0)

    onehot = F.one_hot(gt_classes.long().clamp(min=0),
                       num_classes).float() * ok[..., None]
    onehot = torch.where(gt_classes[..., None] >= 0, onehot, 0.0)
    rows = torch.arange(b, device=mask_logits.device)[:, None]
    cls_target = torch.zeros((b, n, num_classes), device=mask_logits.device)
    cls_target = cls_target.index_put((rows, pred_of_gt), onehot,
                                      accumulate=True).clamp(0.0, 1.0)
    loss_cls = sigmoid_focal_loss(out["cls_logits"].float(), cls_target,
                                  alpha=0.25, gamma=2.0).sum() / num_inst

    matched_logits = mask_logits[rows, pred_of_gt]             # [B, G, Hm, Wm]
    mp = torch.sigmoid(matched_logits).reshape(b, g, -1)
    mt = gt_small.reshape(b, g, -1)
    dnum = 2.0 * (mp * mt).sum(-1)
    dden = (mp * mp).sum(-1) + (mt * mt).sum(-1)
    loss_dice = ((1.0 - dnum / (dden + 1e-4)) * ok).sum() / num_inst
    bce = sigmoid_binary_cross_entropy(matched_logits.reshape(b, g, -1),
                                       mt).mean(-1)
    loss_pix = (bce * ok).sum() / num_inst

    with torch.no_grad():
        bp = (mp >= 0.4).float()
        bt = (mt > 0.5).float()
        inter = (bp * bt).sum(-1)
        union = bt.sum(-1) + bp.sum(-1) - inter
        iou_t = inter / (union + 1e-6)
    matched_obj = out["obj_logits"].float().gather(1, pred_of_gt)
    loss_obj = (sigmoid_binary_cross_entropy(matched_obj, iou_t)
                * ok).sum() / num_inst

    losses = {
        "loss_ce": class_weight * loss_cls,
        "loss_dice": mask_dice_weight * loss_dice,
        "loss_mask": mask_pixel_weight * loss_pix,
        "loss_objectness": objectness_weight * loss_obj,
        "num_inst": num_inst,
    }
    losses["total_loss"] = (losses["loss_ce"] + losses["loss_dice"]
                            + losses["loss_mask"]
                            + losses["loss_objectness"])
    losses["match_iters"] = iters.max().float()
    losses["match"] = (pred_of_gt, match_ok)
    return losses


# ---------------------------------------------------------------------------
# serving tail
# ---------------------------------------------------------------------------

def sparseinst_postprocess(out: Dict[str, torch.Tensor],
                           cls_threshold: float = 0.005,
                           mask_threshold: float = 0.45,
                           max_detections: int = 100) -> Detections:
    """NMS-free inference (JAX :412): score sqrt(cls_prob * obj_prob), the
    best class a proposal, the top ``max_detections`` by a stable
    descending sort (equal scores keep the lower index first, as
    ``jax.lax.top_k``), soft masks at the logits' size, maskness
    rescoring, boxes from the masks' extent (mask pixels)."""
    cls_prob = torch.sigmoid(out["cls_logits"].float())
    obj = torch.sigmoid(out["obj_logits"].float())[..., None]
    scores_all = torch.sqrt(cls_prob * obj)
    scores, classes = scores_all.max(-1)
    # max returns the first index of a maximum, as jnp.argmax
    scores = torch.where(scores >= cls_threshold, scores, 0.0)
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores = top_scores[:, :max_detections]
    top_idx = top_idx[:, :max_detections]
    top_classes = classes.gather(1, top_idx)
    rows = torch.arange(top_idx.shape[0], device=top_idx.device)[:, None]
    masks = torch.sigmoid(out["mask_logits"][rows, top_idx].float())
    binary = (masks > mask_threshold).float()
    maskness = (masks * binary).sum((-2, -1)) / (binary.sum((-2, -1)) + 1e-6)
    top_scores = top_scores * maskness
    valid = top_scores > 0
    binm = masks > mask_threshold
    hm, wm = binm.shape[-2:]
    ys = torch.arange(hm, dtype=torch.float32, device=masks.device)
    xs = torch.arange(wm, dtype=torch.float32, device=masks.device)
    rows_any = binm.any(-1)                                    # [B, K, Hm]
    cols_any = binm.any(-2)                                    # [B, K, Wm]
    big = 1e9
    x0 = torch.where(cols_any, xs, big).amin(-1)
    y0 = torch.where(rows_any, ys, big).amin(-1)
    x1 = torch.where(cols_any, xs, -big).amax(-1) + 1
    y1 = torch.where(rows_any, ys, -big).amax(-1) + 1
    any_px = cols_any.any(-1)
    boxes = torch.where(any_px[..., None],
                        torch.stack([x0, y0, x1, y1], -1), 0.0)
    return Detections(boxes=boxes,
                      scores=torch.where(valid, top_scores, 0.0),
                      classes=top_classes.to(torch.int32),
                      valid=valid & any_px, masks=masks)


def upsample_masks_two_stage(masks: torch.Tensor, input_hw, image_hw,
                             orig_hw,
                             mask_threshold: float = 0.45) -> torch.Tensor:
    """The reference's two-stage mask upsampling (JAX :468): soft masks
    [N, Hm, Wm] bilinear to the padded input size, cropped to the
    letterboxed image, bilinear to the original size, thresholded.
    ``jax.image.resize`` antialiases by default, which changes only a
    shrink (the second stage, where the letterbox enlarged the image):
    both stages antialias here too."""
    (ih, iw), (vh, vw), (oh, ow) = input_hw, image_hw, orig_hw
    up = _resize(masks[None].float(), (ih, iw), antialias=True)
    up = _resize(up[:, :, :vh, :vw], (oh, ow), antialias=True)
    return up[0] > mask_threshold


@META_ARCH_REGISTRY.register(name="SparseInst")
def build_sparseinst(cfg: SparseInstConfig, device="cuda",
                     seed: int = 0) -> SparseInst:
    """SparseInst from a ``SparseInstConfig`` (JAX :491) with weights from
    ``seed`` (drawn on the CPU), on ``device``, channels_last, eval mode.
    The DCN configs run deformable convolutions in res4 and res5
    (``cfg.resnet.deform_on_per_stage``), their offsets zero at init."""
    if not isinstance(cfg, SparseInstConfig):
        raise NotImplementedError(
            "SparseInst takes a SparseInstConfig (SparseInstConfig.from_cfg "
            "of a merged CfgNode)")
    model = SparseInst(
        num_classes=cfg.num_classes, num_masks=cfg.num_masks,
        kernel_dim=cfg.kernel_dim, groups=cfg.groups,
        encoder_channels=cfg.encoder_channels, resnet=cfg.resnet,
        in_features=cfg.in_features, scale_factor=cfg.scale_factor,
        dtype=torch.bfloat16 if cfg.amp else torch.float32)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()


def sparseinst_eval_masks(dets: Detections, input_hw, image_hw, orig_hw,
                          mask_threshold: float = 0.45):
    """One image's valid detections as numpy arrays for
    ``COCOMaskEvaluator``: (scores, classes, boxes, masks at the original
    size). ``dets`` holds one image (no batch dimension)."""
    keep = dets.valid
    masks = upsample_masks_two_stage(dets.masks[keep], input_hw, image_hw,
                                     orig_hw, mask_threshold)
    return (dets.scores[keep].cpu().numpy(),
            dets.classes[keep].cpu().numpy(),
            dets.boxes[keep].cpu().numpy(), masks.cpu().numpy())


def sparseinst_loss_fn(cfg: SparseInstConfig):
    """The training loss of ``cfg`` (JAX ``engine.py:221``), in the train
    step's form ``loss_fn(out, batch, use_l1)``; the batch holds
    ``gt_masks``, ``gt_classes`` and ``gt_valid``, and may hold ``match``,
    the assignment to take in place of the matcher's."""

    def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return sparseinst_losses(
            out, batch["gt_masks"], batch["gt_classes"], batch["gt_valid"],
            num_classes=cfg.num_classes, class_weight=cfg.class_weight,
            mask_pixel_weight=cfg.mask_pixel_weight,
            mask_dice_weight=cfg.mask_dice_weight,
            objectness_weight=cfg.objectness_weight,
            match=batch.get("match"))

    return loss_fn
