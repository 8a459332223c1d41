"""RoIAlign (JAX ``ops/roi_align.py``): ``bilinear_sample`` (:22),
``roi_align`` (:45) and ``multilevel_roi_align`` (:77), and the batched
pooling of Mask R-CNN's proposals, :func:`roi_align_levels`.

The JAX package's semantics, which are not detectron2's ROIAlignV2:
``aligned=True`` (the box scaled, then shifted by half a pixel), a
``sampling_ratio`` of 2 (an r x r grid of samples a bin, at
``x0 + (i + 0.5) bw / (S r)``), each sample clamped to ``[0, h - 1]`` x
``[0, w - 1]`` (d2 zeroes a sample outside ``[-1, h]``), bilinear from the
four neighbours (the upper ones clamped at the border), and the mean of a
bin's r x r samples. The FPN level of a box is
``clip(floor(2 + log2(sqrt(area) / 224 + 1e-8)) - 2, 0, 3)``, two levels
finer than d2's ROIPooler (ROADMAP.md C.39); the port keeps it.

The JAX ``multilevel_roi_align`` pools every box from every level and keeps
its own level's; :func:`roi_align_levels` samples each box from its own
level only, the same numbers for a quarter of the work: the levels are one
flat channels-last buffer, and each box's samples index its level's block.
Samples are gathered in the buffer's dtype and interpolated in float32
(the JAX model casts the levels to float32 first: the same values). The
boxes go through in chunks, so that a chunk's samples (4 corners x S r x
S r x C a box) stay near :data:`CHUNK_ELEMENTS`. The gradient with respect
to the features is summed in a fixed order (``ops/fixed_order.py``); the
boxes take none (Mask R-CNN's proposals and the GT masks' crops take
none).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from yolov7_d2_tpu_torch.ops.fixed_order import (
    corner_weights,
    fold_corners,
    key_lengths,
)

# the samples a chunk of boxes gathers, per corner (a float32 tensor of
# 2**26 elements is 256 MB)
CHUNK_ELEMENTS = 1 << 26
CANONICAL_SIZE = 224
CANONICAL_LEVEL = 2


def bilinear_sample(feat: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """feat [H, W, C]; ``ys``, ``xs`` float grids of one shape -> [...,
    C], coordinates clamped to the border (JAX :22)."""
    h, w, _ = feat.shape
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i, y1i, x0i, x1i = (v.long() for v in (y0, y1, x0, x1))
    top = feat[y0i, x0i] * (1 - wx) + feat[y0i, x1i] * wx
    bot = feat[y1i, x0i] * (1 - wx) + feat[y1i, x1i] * wx
    return top * (1 - wy) + bot * wy


def box_levels(boxes: torch.Tensor, num_levels: int = 4) -> torch.Tensor:
    """The level index (0 = the finest) of each xyxy box [..., 4] (JAX
    :90-97)."""
    areas = torch.clamp((boxes[..., 2] - boxes[..., 0])
                        * (boxes[..., 3] - boxes[..., 1]), min=1e-4)
    target = torch.floor(CANONICAL_LEVEL + torch.log2(
        torch.sqrt(areas) / CANONICAL_SIZE + 1e-8))
    return torch.clamp(target - CANONICAL_LEVEL, 0,
                       num_levels - 1).long()


def _sample_grid(boxes: torch.Tensor, scale: torch.Tensor,
                 s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The S r sample coordinates of each box [N, 4] along y and x [N, s]
    at ``scale`` [N] (aligned: scaled, then shifted by half a pixel)."""
    x0 = boxes[:, 0] * scale - 0.5
    y0 = boxes[:, 1] * scale - 0.5
    x1 = boxes[:, 2] * scale - 0.5
    y1 = boxes[:, 3] * scale - 0.5
    bw = torch.clamp(x1 - x0, min=1e-4)
    bh = torch.clamp(y1 - y0, min=1e-4)
    t = torch.arange(s, dtype=torch.float32, device=boxes.device) + 0.5
    xs = x0[:, None] + t * (bw / s)[:, None]
    ys = y0[:, None] + t * (bh / s)[:, None]
    return ys, xs


class _Geometry:
    """Where each box's samples lie: per box its level's height and width,
    its block's offset in the flat buffer of the levels, and its plane's
    offset on the levels' maps padded by a row and a column (the keys of
    ``ops/fixed_order.py``)."""

    def __init__(self, shapes: Sequence[Tuple[int, int, int]],
                 plane: torch.Tensor, level: torch.Tensor,
                 scales: Sequence[float]):
        dev = plane.device
        self.shapes = list(shapes)                  # (planes, h, w) a level
        self.offs, self.poffs = [], []
        total = padded = 0
        for p, h, w in shapes:
            self.offs.append(total)
            self.poffs.append(padded)
            total += p * h * w
            padded += p * (h + 1) * (w + 1)
        self.total, self.padded = total, padded
        lvl = level.long()
        plane = plane.long()

        def per_box(values, dtype=torch.long):
            # each box's level's value, selected on the card: a table
            # copied from the host would wait for the card's queue
            out = torch.zeros(lvl.shape, dtype=dtype, device=dev)
            for i, v in enumerate(values):
                out = torch.where(lvl == i, v, out)
            return out

        self.h = per_box([h for _, h, _ in shapes])
        self.w = per_box([w for _, _, w in shapes])
        self.base = per_box(self.offs) + plane * self.h * self.w
        self.pbase = per_box(self.poffs) + plane * (self.h + 1) * (self.w + 1)
        self.scale = per_box(list(scales), torch.float32)

    def corners(self, boxes: torch.Tensor, s: int, sl: slice):
        """For the boxes ``sl``: the clamped sample coordinates [n, s] (y
        and x), their floors, and the flat index [n, s, s] of each
        sample's four neighbours."""
        ys, xs = _sample_grid(boxes[sl], self.scale[sl], s)
        h = self.h[sl].float()[:, None]
        w = self.w[sl].float()[:, None]
        ys = torch.minimum(ys.clamp(min=0.0), h - 1.0)
        xs = torch.minimum(xs.clamp(min=0.0), w - 1.0)
        y0, x0 = torch.floor(ys), torch.floor(xs)
        y1 = torch.minimum(y0 + 1, h - 1)
        x1 = torch.minimum(x0 + 1, w - 1)
        wl = self.w[sl][:, None, None]
        base = self.base[sl][:, None, None]
        rows0 = y0.long()[:, :, None] * wl
        rows1 = y1.long()[:, :, None] * wl
        cols0, cols1 = x0.long()[:, None, :], x1.long()[:, None, :]
        idx = (base + rows0 + cols0, base + rows0 + cols1,
               base + rows1 + cols0, base + rows1 + cols1)
        return ys, xs, y0, x0, idx

    def keys(self, y0: torch.Tensor, x0: torch.Tensor,
             sl: slice) -> torch.Tensor:
        """The samples' keys [n, s, s]: their floor cells on the padded
        maps (never outside: the samples are clamped into the level)."""
        w1 = (self.w[sl] + 1)[:, None, None]
        return (self.pbase[sl][:, None, None]
                + (y0.long()[:, :, None] + 1) * w1
                + x0.long()[:, None, :] + 1)


def _pool_chunk(flat: torch.Tensor, geo: _Geometry, boxes: torch.Tensor,
                out_size: int, r: int, sl: slice) -> torch.Tensor:
    s = out_size * r
    ys, xs, y0, x0, idx = geo.corners(boxes, s, sl)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    v = [flat[i].float() for i in idx]                # [n, s, s, C] each
    top = v[0] * (1 - wx) + v[1] * wx
    bot = v[2] * (1 - wx) + v[3] * wx
    samples = top * (1 - wy) + bot * wy
    n, c = samples.shape[0], samples.shape[-1]
    return samples.reshape(n, out_size, r, out_size, r, c).mean(dim=(2, 4))


def _chunks(n: int, per_box: int):
    step = max(1, CHUNK_ELEMENTS // max(per_box, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _pool(flat, geo, boxes, out_size, r) -> torch.Tensor:
    c = flat.shape[-1]
    outs = [_pool_chunk(flat, geo, boxes, out_size, r, sl)
            for sl in _chunks(boxes.shape[0], (out_size * r) ** 2 * c)]
    return torch.cat(outs) if outs else flat.new_zeros(
        (0, out_size, out_size, c), dtype=torch.float32)


class _RoIAlign(torch.autograd.Function):
    """The pooled boxes [N, S, S, C] of ``flat`` [T, C]; the gradient with
    respect to ``flat`` in a fixed order: the samples sorted once by key,
    then a block of channels at a time gathered in that order, weighted,
    summed a key's run (``segment_sum``'s steps) and folded a level."""

    @staticmethod
    def forward(ctx, flat, boxes, geo, out_size, r):
        ctx.geo, ctx.out_size, ctx.r = geo, out_size, r
        ctx.flat_meta = (flat.shape, flat.dtype)
        ctx.save_for_backward(boxes)
        return _pool(flat, geo, boxes, out_size, r)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        geo, out_size, r = ctx.geo, ctx.out_size, ctx.r
        (t, c), dtype = ctx.flat_meta
        s = out_size * r
        n = boxes.shape[0]
        dev = grad.device
        keys, wts = [], []
        for sl in _chunks(n, s * s * 4):
            ys, xs, y0, x0, _ = geo.corners(boxes, s, sl)
            keys.append(geo.keys(y0, x0, sl).reshape(-1))
            m = ys.shape[0]
            wts.append(corner_weights(
                (ys - y0)[:, :, None].expand(m, s, s),
                (xs - x0)[:, None, :].expand(m, s, s)).reshape(-1, 4))
        key = torch.cat(keys)
        order = torch.sort(key, stable=True).indices
        lengths = key_lengths(key, geo.padded)
        wts = torch.cat(wts)[order]                          # [M, 4]
        # sample (box, i, j) takes its bin's gradient / r^2
        i = torch.arange(s, device=dev) // r
        bins = (torch.arange(n, device=dev)[:, None, None] * out_size
                + i[None, :, None]) * out_size + i[None, None, :]
        bins = bins.reshape(-1)[order]
        g = (grad.float() / (r * r)).reshape(-1, c)
        out = torch.empty((t, c), dtype=torch.float32, device=dev)
        step = max(1, CHUNK_ELEMENTS // max(4 * key.numel(), 1))
        for c0 in range(0, c, step):
            c1 = min(c, c0 + step)
            rows = (g[bins, c0:c1][:, None, :] * wts[:, :, None])
            sums = torch.segment_reduce(rows.reshape(-1, 4 * (c1 - c0)),
                                        "sum", lengths=lengths, axis=0,
                                        unsafe=True)
            for (planes, h, w), off, poff in zip(geo.shapes, geo.offs,
                                                 geo.poffs):
                num = planes * (h + 1) * (w + 1)
                out[off:off + planes * h * w, c0:c1] = fold_corners(
                    sums[poff:poff + num].reshape(planes, h + 1, w + 1, 4,
                                                  c1 - c0)
                ).reshape(-1, c1 - c0)
        return out.to(dtype), None, None, None, None


def roi_align_levels(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                     plane: torch.Tensor, level: torch.Tensor,
                     scales: Sequence[float], out_size: int,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """Pool each box from one plane of one level: ``feats`` a level each
    [P_l, H_l, W_l, C] (channels last, any float dtype; a mask as C = 1),
    ``boxes`` [N, 4] xyxy in image pixels, ``plane`` [N] the plane of its
    level, ``level`` [N] its level, ``scales`` a level each (1 / stride)
    -> float32 [N, out_size, out_size, C]."""
    r = max(sampling_ratio, 1)
    c = feats[0].shape[-1]
    shapes = [tuple(f.shape[:3]) for f in feats]
    geo = _Geometry(shapes, plane, level, scales)
    flat = torch.cat([f.reshape(-1, c) for f in feats])
    return _apply(flat, geo, boxes.detach().float(), out_size, r)


def _apply(flat, geo, boxes, out_size, r) -> torch.Tensor:
    if torch.is_grad_enabled() and flat.requires_grad:
        return _RoIAlign.apply(flat, boxes, geo, out_size, r)
    with torch.no_grad():
        return _pool(flat, geo, boxes, out_size, r)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int,
              spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """feat [H, W, C]; boxes [N, 4] xyxy in image pixels -> [N, S, S, C]
    (JAX :45)."""
    n = boxes.shape[0]
    zeros = torch.zeros(n, dtype=torch.long, device=boxes.device)
    return roi_align_levels([feat[None]], boxes, zeros, zeros,
                            [spatial_scale], out_size, sampling_ratio)


def multilevel_roi_align(
        feats: Dict[str, torch.Tensor], boxes: torch.Tensor, out_size: int,
        strides: Sequence[int] = (4, 8, 16, 32),
        level_names: Sequence[str] = ("p2", "p3", "p4", "p5"),
) -> torch.Tensor:
    """feats {name: [H, W, C]} of one image, boxes [N, 4] -> [N, S, S, C],
    each box from its level (JAX :77)."""
    n = boxes.shape[0]
    return roi_align_levels(
        [feats[k][None] for k in level_names], boxes,
        torch.zeros(n, dtype=torch.long, device=boxes.device),
        box_levels(boxes, len(level_names)),
        [1.0 / s for s in strides], out_size)


def pool_proposals(levels: Sequence[torch.Tensor], boxes: torch.Tensor,
                   out_sizes: Sequence[int],
                   strides: Sequence[int] = (4, 8, 16, 32)
                   ) -> List[torch.Tensor]:
    """Mask R-CNN's pooling: ``levels`` [B, H_l, W_l, C] channels last,
    ``boxes`` [B, P, 4] -> float32 [B, P, S, S, C] for each size S of
    ``out_sizes`` (one buffer of the levels for all), each box from its
    image's plane of its own level."""
    b, p = boxes.shape[:2]
    flat_boxes = boxes.reshape(b * p, 4).detach().float()
    plane = torch.arange(b, device=boxes.device).repeat_interleave(p)
    c = levels[0].shape[-1]
    geo = _Geometry([tuple(f.shape[:3]) for f in levels], plane,
                    box_levels(flat_boxes, len(levels)),
                    [1.0 / s for s in strides])
    flat = torch.cat([f.reshape(-1, c) for f in levels])
    return [_apply(flat, geo, flat_boxes, s, 2).reshape(b, p, s, s, c)
            for s in out_sizes]
