"""SOLOv2, grid-cell kernel-prediction instance segmentation (JAX
``models/meta_arch/solov2.py``): the model, its targets and losses, and its
matrix-NMS serving tail.

``SOLOv2.forward`` takes the letterboxed NHWC batch. A uint8 batch goes
through the normalize kernel (``kernels/preprocess.py``) with the ImageNet
mean and std that the JAX model hard-codes (:156-157, SparseInst's too);
then ResNet (FrozenBN, the stride in the 1x1, res2-res5), the FPN with its
max-pool P6 (``necks/fpn.py``), the instance head on each of P2-P6 at its
grid and the mask head on P2-P5, in bf16 under autocast over float32
parameters where the config asks for AMP. The heads' GroupNorms run in
float32 (autocast's own rule, the JAX ``GroupNorm(dtype=float32)``) and
their ReLUs round to the compute dtype, as the JAX ``.astype(dtype)``
does; the predictions come out in float32, channels last: ``cate_preds``
[B, S, S, C] and ``kernel_preds`` [B, S, S, E] a level, ``mask_feats``
[B, H/4, W/4, E].

Every resize is ``jax.image.resize``'s bilinear without antialiasing, which
is ``F.interpolate`` bilinear with half-pixel centres: the head's resize to
the grid (the JAX head passes ``antialias=False``), the mask head's 2x
upsamples (an enlargement, where antialiasing does nothing) and
``solov2_upsample_masks``.

Parameter names: the ResNet's are detectron2's, the FPN's the flax ones
(``fpn.lateral_{i}``, ``fpn.output_{i}``), the heads' the reference's
(``ins_head.{cate,kernel}_tower.{3i,3i+1}``, ``ins_head.{cate,kernel}_
pred``, ``mask_head.convs_all_levels.{i}.conv{j}.{0,1}``,
``mask_head.conv_pred.{0,1}``), so that ``utils/weight_port.py``
``map_solov2_torch_name`` (on copies of the JAX maps) applies.

The losses and the tail use the JAX package's constants: ``SCALE_RANGES``
(a copy) and the tail's defaults. ``MODEL.SOLOV2.FPN_SCALE_RANGES``,
``SCORE_THR``, ``MASK_THR``, ``UPDATE_THR``, ``NMS_PRE``, ``NMS_KERNEL``
and ``NMS_SIGMA`` are read nowhere in the JAX package, and the port reads
them nowhere either (ROADMAP.md C.35). The losses sum over this process's
batch only: the JAX package trains SOLOv2 through ``build_system`` alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.config.solov2 import Solov2Config
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
from yolov7_d2_tpu_torch.models.layers.blocks import AutocastReLU
from yolov7_d2_tpu_torch.models.meta_arch.detr import stable_top_k
from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import (
    PIXEL_MEAN,
    PIXEL_STD,
    _resize,
)
from yolov7_d2_tpu_torch.models.necks.fpn import FPN
from yolov7_d2_tpu_torch.ops.deform_conv import DeformConv
from yolov7_d2_tpu_torch.ops.losses import sigmoid_focal_loss
from yolov7_d2_tpu_torch.ops.nms import matrix_nms_masks
from yolov7_d2_tpu_torch.structures.instances import Detections

# a copy of the JAX SCALE_RANGES (solov2.py:192): the gt sizes of each level
SCALE_RANGES = ((1, 96), (48, 192), (96, 384), (192, 768), (384, 2048))
INSTANCE_STRIDES = (8, 8, 16, 32, 32)


def coord_append(x: torch.Tensor) -> torch.Tensor:
    """Append the normalized (x, y) coordinate channels, -1 to 1 over the
    map (JAX ``_coord_append``, :92: SOLOv2 appends, SparseInst
    prepends)."""
    b, _, h, w = x.shape
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([xx, yy])[None].expand(b, 2, h, w).to(x.dtype)
    return torch.cat([x, coords], 1)


def _conv_gn_relu(c_in: int, c_out: int, kernel: int = 3) -> List[nn.Module]:
    return [nn.Conv2d(c_in, c_out, kernel, 1, (kernel - 1) // 2),
            nn.GroupNorm(min(32, c_out), c_out, eps=1e-5), AutocastReLU()]


class SOLOv2InsHead(nn.Module):
    """The category and kernel towers (JAX :33): the level with its
    coordinates appended, resized to the grid; the category tower without
    the coordinates. ``num_convs`` conv-GN-ReLU a tower, the last one
    deformable with ``use_dcn``; ``cate_pred`` (bias -4.6, prior 0.01) and
    ``kernel_pred``."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 num_kernels: int = 256, channels: int = 512,
                 num_convs: int = 4, use_dcn: bool = False):
        super().__init__()
        for kind, c0 in (("cate", in_channels), ("kernel", in_channels + 2)):
            mods = []
            for i in range(num_convs):
                c_in = c0 if i == 0 else channels
                if use_dcn and i == num_convs - 1:
                    mods += [DeformConv(c_in, channels),
                             *_conv_gn_relu(c_in, channels)[1:]]
                else:
                    mods += _conv_gn_relu(c_in, channels)
            self.add_module(f"{kind}_tower", nn.Sequential(*mods))
        self.cate_pred = nn.Conv2d(channels, num_classes, 3, 1, 1)
        self.kernel_pred = nn.Conv2d(channels, num_kernels, 3, 1, 1)
        self.init_fixed_()

    @torch.no_grad()
    def init_fixed_(self) -> None:
        self.cate_pred.bias.fill_(-4.6)

    def forward(self, x: torch.Tensor, grid: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _resize(coord_append(x), (grid, grid))
        cate = self.cate_tower(x[:, :-2])
        kernel = self.kernel_tower(x)
        return (self.cate_pred(cate).float().permute(0, 2, 3, 1),
                self.kernel_pred(kernel).float().permute(0, 2, 3, 1))


class _MaskLevel(nn.Module):
    """One level of the mask head: ``conv{j}`` a conv-GN-ReLU each, a 2x
    bilinear upsample after each but at level 0."""

    def __init__(self, level: int, c_in: int, channels: int):
        super().__init__()
        self.level = level
        for j in range(max(level, 1)):
            self.add_module(f"conv{j}", nn.Sequential(
                *_conv_gn_relu(c_in if j == 0 else channels, channels)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.level == 0:
            return self.conv0(x)
        for j in range(self.level):
            x = getattr(self, f"conv{j}")(x)
            x = _resize(x, (x.shape[2] * 2, x.shape[3] * 2))
        return x


class SOLOv2MaskHead(nn.Module):
    """The unified mask features (JAX :106): level i (i conv-GN-ReLU and 2x
    upsamples, level 3 with coordinates appended) summed at P2, then 1x1
    conv -> GN -> ReLU, float32 out."""

    def __init__(self, in_channels: int = 256, channels: int = 128,
                 num_masks: int = 256, num_levels: int = 4):
        super().__init__()
        self.convs_all_levels = nn.ModuleList([
            _MaskLevel(i, in_channels + (2 if i == 3 else 0), channels)
            for i in range(num_levels)])
        self.conv_pred = nn.Sequential(
            nn.Conv2d(channels, num_masks, 1),
            nn.GroupNorm(min(32, num_masks), num_masks, eps=1e-5), nn.ReLU())

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        acc = None
        for i, (f, level) in enumerate(zip(feats, self.convs_all_levels)):
            y = level(coord_append(f) if i == 3 else f)
            acc = y if acc is None else acc + y
        return self.conv_pred(acc).float()


class SOLOv2(nn.Module):
    """normalize -> ResNet (res2-res5) -> FPN (P2-P6) -> instance head a
    level, mask head on P2-P5 (JAX :144). ``dtype`` is the compute dtype:
    bfloat16 runs under autocast over float32 parameters."""

    def __init__(self, num_classes: int = 80,
                 num_grids: Sequence[int] = (40, 36, 24, 16, 12),
                 num_kernels: int = 256, instance_channels: int = 512,
                 mask_channels: int = 128, resnet_depth: int = 50,
                 use_dcn_in_instance: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_grids = tuple(num_grids)
        self.dtype = dtype
        feats = ("res2", "res3", "res4", "res5")
        self.backbone = ResNet(ResNetSpec(depth=resnet_depth,
                                          out_features=feats))
        self.fpn = FPN([RESNET_CHANNELS[f] for f in feats], 256, "maxpool")
        self.ins_head = SOLOv2InsHead(256, num_classes, num_kernels,
                                      instance_channels,
                                      use_dcn=use_dcn_in_instance)
        self.mask_head = SOLOv2MaskHead(256, mask_channels, num_kernels)

    def forward(self, images: torch.Tensor) -> Dict[str, object]:
        """images: uint8 or float [B, H, W, 3] letterboxed batch."""
        norm = (normalize_images if images.dtype == torch.uint8
                else normalize_images_plain)
        x = norm(images, PIXEL_MEAN, PIXEL_STD, self.dtype)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype == torch.bfloat16):
            feats = self.backbone(x)
            pyr = self.fpn([feats[f] for f in ("res2", "res3", "res4",
                                                "res5")])
            pyramid = [pyr[f"p{i}"] for i in range(2, 7)]
            cate_preds, kernel_preds = [], []
            for lvl, grid in enumerate(self.num_grids):
                c, k = self.ins_head(pyramid[lvl], grid)
                cate_preds.append(c)
                kernel_preds.append(k)
            mask_feats = self.mask_head(pyramid[:4])
        return {"cate_preds": cate_preds, "kernel_preds": kernel_preds,
                "mask_feats": mask_feats.permute(0, 2, 3, 1)}


# ---------------------------------------------------------------------------
# targets and losses
# ---------------------------------------------------------------------------

def level_targets(grid: int, scale_range: Tuple[int, int], input_hw,
                  gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                  gt_valid: torch.Tensor, gt_centers: torch.Tensor,
                  mask_valid: torch.Tensor,
                  sigma: float = 0.2) -> Dict[str, torch.Tensor]:
    """One level's static targets for a batch (JAX ``_level_targets``,
    :195): the grid cell of each gt's mass centre, its centre region
    (centre +- sigma times the box's half extent, clipped to the 3x3 cells
    around the centre cell), in range of the level's scale and with a
    non-empty mask; where regions overlap the last gt wins. Returns
    ``cate_target`` [B, S, S] (0 background, class + 1), ``pos_cell`` [B,
    G*9] (S*S where unused), ``pos_gt`` [G*9] and ``pos_ok`` [B, G*9]."""
    h, w = input_hw
    b, g = gt_classes.shape
    dev = gt_boxes.device
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    scale = torch.sqrt(torch.clamp(gw * gh, min=0.0))
    in_range = ((scale >= scale_range[0]) & (scale <= scale_range[1])
                & gt_valid.bool() & mask_valid)
    cx, cy = gt_centers[..., 0], gt_centers[..., 1]
    half_w = 0.5 * gw * sigma
    half_h = 0.5 * gh * sigma

    def q(v, size):
        return torch.floor((v / size) / (1.0 / grid)).long()

    ccx, ccy = q(cx, w), q(cy, h)
    top = torch.maximum(q(cy - half_h, h).clamp(min=0), ccy - 1)
    down = torch.minimum(q(cy + half_h, h).clamp(max=grid - 1), ccy + 1)
    left = torch.maximum(q(cx - half_w, w).clamp(min=0), ccx - 1)
    right = torch.minimum(q(cx + half_w, w).clamp(max=grid - 1), ccx + 1)
    offs = torch.arange(-1, 2, device=dev)
    oy = offs.repeat_interleave(3)
    ox = offs.repeat(3)
    cand_y = ccy[..., None] + oy                              # [B, G, 9]
    cand_x = ccx[..., None] + ox
    ok = (in_range[..., None]
          & (cand_y >= top[..., None]) & (cand_y <= down[..., None])
          & (cand_x >= left[..., None]) & (cand_x <= right[..., None]))
    s2 = grid * grid
    flat = torch.where(ok, cand_y * grid + cand_x, s2).reshape(b, g * 9)
    # the last gt in order wins a cell: the largest gt index among writers
    writer = torch.arange(1, g + 1, device=dev).repeat_interleave(9)
    winner = torch.zeros((b, s2 + 1), dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(1, flat, writer.expand(b, -1), "amax")
    winner = winner[:, :s2]
    cls = gt_classes.long().gather(1, (winner - 1).clamp(min=0))
    cate = torch.where(winner > 0, cls + 1, 0)
    return {
        "cate_target": cate.reshape(b, grid, grid),
        "pos_cell": flat,
        "pos_gt": torch.arange(g, device=dev).repeat_interleave(9),
        "pos_ok": ok.reshape(b, g * 9),
    }


def solov2_losses(out: Dict[str, object], gt_masks: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                  gt_valid: torch.Tensor, input_hw, num_classes: int,
                  num_grids: Sequence[int] = (40, 36, 24, 16, 12),
                  focal_weight: float = 1.0,
                  dice_weight: float = 3.0) -> Dict[str, torch.Tensor]:
    """The focal category loss over every cell and the dice mask loss of
    every (gt, positive cell) pair (JAX :269). The mask target is the
    reference's cv2 1/4 rescale of the uint8 mask: 1 iff at least 2 of the
    2x2 taps at offset (1, 1) of each 4x4 block are set; the grid cell comes
    from each mask's mass centre at the gt's resolution. The category loss
    is over the positive cells + 1, the dice over the pairs (at least
    1)."""
    mask_feats = out["mask_feats"]                        # [B, Hm, Wm, E]
    b, hm, wm, e = mask_feats.shape
    gm = gt_masks[:, :, :4 * hm, :4 * wm]
    taps = (gm[..., 1::4, 1::4].int() + gm[..., 1::4, 2::4]
            + gm[..., 2::4, 1::4] + gm[..., 2::4, 2::4])
    gt_small = (taps >= 2).float()                        # [B, G, Hm, Wm]

    # mass centres and empty masks: row and column sums are exact
    gmf = gt_masks.float()
    col = gmf.sum(-2)                                     # [B, G, W]
    row = gmf.sum(-1)                                     # [B, G, H]
    area = col.sum(-1)
    m00 = area.clamp(min=1e-6)
    xs = torch.arange(col.shape[-1], dtype=torch.float32,
                      device=gmf.device)
    ys = torch.arange(row.shape[-1], dtype=torch.float32,
                      device=gmf.device)
    centers = torch.stack([(col * xs).sum(-1) / m00,
                           (row * ys).sum(-1) / m00], -1)
    mask_valid = area > 0
    up_hw = (4 * hm, 4 * wm)

    total_pos = mask_feats.new_zeros(())
    cate_sum = mask_feats.new_zeros(())
    dice_sum = mask_feats.new_zeros(())
    pairs = mask_feats.new_zeros(())
    for lvl, grid in enumerate(num_grids):
        t = level_targets(grid, SCALE_RANGES[lvl], up_hw, gt_boxes.float(),
                          gt_classes, gt_valid, centers, mask_valid)
        cate_t = t["cate_target"]
        onehot = (F.one_hot((cate_t - 1).clamp(min=0), num_classes)
                  * (cate_t > 0)[..., None]).float()
        cate_sum = cate_sum + sigmoid_focal_loss(out["cate_preds"][lvl],
                                                 onehot).sum()
        total_pos = total_pos + (cate_t > 0).float().sum()
        kernels = out["kernel_preds"][lvl].reshape(b, grid * grid, e)
        cell = t["pos_cell"].clamp(max=grid * grid - 1)
        sel = kernels.gather(1, cell[..., None].expand(-1, -1, e))
        pred = torch.sigmoid(torch.einsum("bpe,bhwe->bphw", sel, mask_feats))
        tgt = gt_small[:, t["pos_gt"]]
        okf = t["pos_ok"].float()
        p2 = pred.reshape(b, -1, hm * wm)
        t2 = tgt.reshape(b, -1, hm * wm)
        a = (p2 * t2).sum(-1)
        den = (p2 * p2).sum(-1) + 0.001 + (t2 * t2).sum(-1) + 0.001
        dice_sum = dice_sum + ((1.0 - 2.0 * a / den) * okf).sum()
        pairs = pairs + okf.sum()
    loss_cate = focal_weight * cate_sum / (total_pos + 1.0)
    loss_mask = dice_weight * dice_sum / pairs.clamp(min=1.0)
    return {"loss_cate": loss_cate, "loss_mask": loss_mask,
            "num_pos": total_pos.detach(),
            "total_loss": loss_cate + loss_mask}


# ---------------------------------------------------------------------------
# serving tail
# ---------------------------------------------------------------------------

def point_nms(heat: torch.Tensor) -> torch.Tensor:
    """Keep a cell's score iff it is the max of the 2x2 window reaching one
    cell up and left (JAX ``_point_nms``, :365); ``heat`` [B, S, S, C]."""
    x = heat.permute(0, 3, 1, 2)
    hmax = F.max_pool2d(x, 2, 1, 1)[:, :, :-1, :-1].permute(0, 2, 3, 1)
    return heat * (hmax == heat).to(heat.dtype)


def mask_boxes(binary: torch.Tensor, plus_one: bool) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """xyxy boxes of binary masks [..., H, W] (0 where a mask is empty)
    and whether each has a pixel; ``plus_one`` adds 1 to the maxima."""
    h, w = binary.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=binary.device)
    xs = torch.arange(w, dtype=torch.float32, device=binary.device)
    rows, cols = binary.any(-1), binary.any(-2)
    big = 1e9
    x0 = torch.where(cols, xs, big).amin(-1)
    y0 = torch.where(rows, ys, big).amin(-1)
    x1 = torch.where(cols, xs, -big).amax(-1) + float(plus_one)
    y1 = torch.where(rows, ys, -big).amax(-1) + float(plus_one)
    any_px = cols.any(-1)
    boxes = torch.where(any_px[..., None], torch.stack([x0, y0, x1, y1], -1),
                        0.0)
    return boxes, any_px


def solov2_postprocess(out: Dict[str, object], score_thr: float = 0.1,
                       mask_thr: float = 0.5, update_thr: float = 0.05,
                       max_per_img: int = 100, nms_pre: int = 500,
                       kernel: str = "gaussian", sigma: float = 2.0,
                       instance_strides: Sequence[int] = INSTANCE_STRIDES
                       ) -> Detections:
    """Matrix-NMS serving (JAX :376): point NMS on each level's sigmoid
    category map; the top ``nms_pre`` (cell, class) pairs above
    ``score_thr``; their dynamic-conv masks; the area filter (pixels above
    ``mask_thr`` more than the level's stride); maskness rescoring; matrix
    NMS on the candidates sorted by the rescored score; the top
    ``max_per_img``, valid from ``update_thr`` and a non-empty mask.
    Masks [B, K, Hm, Wm] stay at mask-feature resolution, their boxes
    from the binary masks there (max + 1). Every top-k is a stable
    descending sort, ``jax.lax.top_k``'s order among equal scores."""
    mask_feats = out["mask_feats"]
    b, hm, wm, e = mask_feats.shape
    scores, kernels, strides = [], [], []
    for lvl, (cate, kern) in enumerate(zip(out["cate_preds"],
                                           out["kernel_preds"])):
        s = point_nms(torch.sigmoid(cate))
        scores.append(s.reshape(b, -1, s.shape[-1]))
        kernels.append(kern.reshape(b, -1, e))
        strides.append(torch.full((scores[-1].shape[1],),
                                  float(instance_strides[lvl]),
                                  device=mask_feats.device))
    scores = torch.cat(scores, 1)                         # [B, A, C]
    kernels = torch.cat(kernels, 1)                       # [B, A, E]
    strides = torch.cat(strides)
    num_classes = scores.shape[2]

    flat = torch.where(scores > score_thr, scores, 0.0).reshape(b, -1)
    top_scores, top_idx = stable_top_k(flat, nms_pre)
    top_cell = top_idx // num_classes
    top_class = (top_idx % num_classes).to(torch.int32)
    top_kern = kernels.gather(1, top_cell[..., None].expand(-1, -1, e))
    masks = torch.sigmoid(torch.einsum("bpe,bhwe->bphw", top_kern,
                                       mask_feats))
    binm = masks > mask_thr
    area = binm.sum((-2, -1)).float()
    top_scores = torch.where(area > strides[top_cell], top_scores, 0.0)
    maskness = (masks * binm).sum((-2, -1)) / area.clamp(min=1.0)
    top_scores = top_scores * maskness

    # matrix NMS on the candidates sorted by the rescored score
    order = stable_top_k(top_scores, top_scores.shape[1])[1]
    masks = masks.gather(1, order[..., None, None].expand(-1, -1, hm, wm))
    binm = binm.gather(1, order[..., None, None].expand(-1, -1, hm, wm))
    labels = top_class.gather(1, order)
    sc = top_scores.gather(1, order)
    bf = binm.reshape(b, binm.shape[1], -1).float()
    inter = bf @ bf.transpose(1, 2)
    a = bf.sum(-1)
    union = a[:, :, None] + a[:, None, :] - inter
    ious = inter / union.clamp(min=1.0)
    new_scores = matrix_nms_masks(ious, labels, sc, kernel, sigma)
    new_scores = torch.where(sc > 0, new_scores, 0.0)
    keep_scores, keep = stable_top_k(new_scores, max_per_img)
    masks_out = masks.gather(1, keep[..., None, None].expand(-1, -1, hm, wm))
    classes = labels.gather(1, keep)
    valid = keep_scores >= update_thr
    boxes, any_px = mask_boxes(masks_out > mask_thr, plus_one=True)
    valid = valid & any_px
    return Detections(boxes=boxes,
                      scores=torch.where(valid, keep_scores, 0.0),
                      classes=classes.to(torch.int32), valid=valid,
                      masks=masks_out)


def solov2_upsample_masks(masks: torch.Tensor, cur_hw, ori_hw,
                          mask_thr: float = 0.5):
    """The reference's final resizes (JAX :478): bilinear to the mask size
    times ``ceil(h / Hm)``, cropped to the network input ``cur_hw``, then
    bilinear to the original size ``ori_hw``, thresholded; both without
    antialiasing. ``masks`` [P, Hm, Wm] probabilities -> (binary masks
    [P, oh, ow], boxes xyxy [P, 4] from them, without the + 1)."""
    p, fh, fw = masks.shape
    h, w = cur_hw
    ratio = math.ceil(h / fh)
    up = _resize(masks[None].float(), (fh * ratio, fw * ratio))[
        :, :, :h, :w]
    seg = _resize(up, tuple(ori_hw))[0]
    bm = seg > mask_thr
    boxes, _ = mask_boxes(bm, plus_one=False)
    return bm, boxes


@META_ARCH_REGISTRY.register(name="SOLOv2")
def build_solov2(cfg: Solov2Config, device="cuda", seed: int = 0) -> SOLOv2:
    """SOLOv2 from a ``Solov2Config`` (JAX :517) with weights from ``seed``
    (drawn on the CPU), on ``device``, channels_last, eval mode."""
    if not isinstance(cfg, Solov2Config):
        raise NotImplementedError(
            "SOLOv2 takes a Solov2Config (Solov2Config.from_cfg of a merged "
            "CfgNode)")
    model = SOLOv2(
        num_classes=cfg.num_classes, num_grids=cfg.num_grids,
        num_kernels=cfg.num_kernels,
        instance_channels=cfg.instance_channels,
        mask_channels=cfg.mask_channels, resnet_depth=cfg.resnet_depth,
        use_dcn_in_instance=cfg.use_dcn_in_instance,
        dtype=torch.bfloat16 if cfg.amp else torch.float32)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval()


def solov2_loss_fn(cfg: Solov2Config):
    """The training loss of ``cfg`` (JAX ``engine.py:250-259``) in the train
    step's form ``loss_fn(out, batch, use_l1)``; the batch holds
    ``gt_masks`` [B, G, H, W] uint8, ``gt_boxes``, ``gt_classes`` and
    ``gt_valid``."""

    def loss_fn(out, batch, use_l1: bool) -> Dict[str, torch.Tensor]:
        return solov2_losses(
            out, batch["gt_masks"], batch["gt_boxes"], batch["gt_classes"],
            batch["gt_valid"], cfg.input_size, cfg.num_classes,
            cfg.num_grids)

    return loss_fn
