"""The training step's photometric stage on the device (JAX
``data/device_aug.py:453, 503, 642-768``, with GridMask from
``data/transforms/augment.py:117-140``).

Batches arrive pre-augmented in geometry (mosaic, affine) and letterboxed,
as uint8 NHWC. On the device: in-batch MixUp (a 0.5 / 0.5 blend with a
permuted partner and the union of the two box sets), then the HSV
distortion (:func:`hsv_distort`, plain PyTorch: it is XLA code in JAX),
then GridMask (the kernel of ``kernels/grid_mask.py``), then the
horizontal flip, then the boxes packed valid-first into ``max_boxes``
slots. HSV and GridMask sit after mixup and before the flip, in the
mapper's order (``yolov7_d2_tpu/data/detection_utils.py:66-112``:
distortion, then GridMask).

The random draws (permutation, coins, GridMask parameters, HSV gains) are
made on the host from a ``torch.Generator`` and moved to the card; torch's
generator gives other numbers than ``jax.random``, so the tests hand both
packages the same draws. With mixup and the distortion off the image stays
uint8 and the model takes it through the normalize kernel (GridMask's
uint8 instance); the values are the JAX package's float32 ones either way.

The geometry stage on the device (JAX ``data/device_aug.py:51-629``,
771-795), the feed of ``INPUT.MOSAIC_AND_MIXUP.DEVICE``: the host only
decodes and letterboxes each image to a square uint8 tile
(``mappers.TileDatasetMapper``); :class:`DeviceAug` then runs mosaic4,
the perspective warp, MixUp, HSV, GridMask and the flip over the batch
of tiles. The mosaic paste and the warp compose into one gather: for each
output pixel the inverse warp gives canvas coordinates, the mosaic
centre picks the tile that owns the point, and four taps read the uint8
pool ``[B * S * S, 3]`` by a flat index (no 2S x 2S canvas). The boxes
ride the same transforms analytically, in fixed slots with validity
masks. The 3x3 matrices are built from elementwise products and inverted
by their adjugate, so that the result does not depend on TF32 matmuls
and nothing loads a solver library. All of it is plain PyTorch: the JAX
stage is XLA code, with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from yolov7_d2_tpu_torch.kernels.grid_mask import grid_mask

IDENTITY_GRID = (1, 1, 0, 0, 0)  # mode 0 with keep = d: zeroes nothing
GRAY = 114.0  # the mosaic's fill (JAX :42)


def sample_grid_mask_params(generator: torch.Generator, batch: int, h: int,
                            w: int, prob: float = 0.3,
                            mode: int = 1) -> torch.Tensor:
    """int32 [batch, 5] (d, keep, off_y, off_x, mode) on the host. Each
    image is masked with probability ``prob``: d in [2, max(min(h, w) // 4,
    3)), keep = max(int(d * 0.5 + 0.5), 1), offsets in [0, d); an image
    not drawn gets :data:`IDENTITY_GRID`."""
    drawn = torch.rand(batch, generator=generator) < prob
    d = torch.randint(2, max(min(h, w) // 4, 3), (batch,),
                      generator=generator)
    keep = ((d + 1) // 2).clamp(min=1)       # int(d * 0.5 + 0.5), d >= 2
    off_y = (torch.rand(batch, generator=generator) * d).long()
    off_x = (torch.rand(batch, generator=generator) * d).long()
    params = torch.stack([d, keep, off_y, off_x,
                          torch.full_like(d, mode)], dim=-1)
    identity = torch.tensor(IDENTITY_GRID).expand(batch, 5)
    return torch.where(drawn[:, None], params, identity).to(torch.int32)


def hsv_distort(img: torch.Tensor, dhue: torch.Tensor, dsat: torch.Tensor,
                dexp: torch.Tensor) -> torch.Tensor:
    """JAX ``device_aug.py:453`` over a batch: float BGR [B, H, W, 3] in
    0..255 -> HSV on cv2's uint8 scale (H in [0, 180)), the hue shifted by
    ``dhue * 180`` (mod 180), S and V scaled by ``dsat`` / ``dexp`` and
    clipped, -> BGR. ``dhue`` / ``dsat`` / ``dexp`` are float32 [B]. The
    JAX expression step by step: ``jnp.mod`` is a floor modulo
    (``torch.remainder``), the hue's branch is the first of ``v == r``,
    ``v == g`` that holds, exactly."""
    dhue, dsat, dexp = (t.float()[:, None, None] for t in (dhue, dsat, dexp))
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    safe = diff.clamp(min=1e-6)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff <= 0, 0.0, torch.remainder(h, 360.0)) / 2.0
    s = torch.where(v > 0, 255.0 * diff / v.clamp(min=1e-6), 0.0)

    h = torch.remainder(h + dhue * 180.0, 180.0)
    s = (s * dsat).clamp(0.0, 255.0)
    v = (v * dexp).clamp(0.0, 255.0)

    h6 = h * 2.0 / 60.0                       # the sector, in [0, 6)
    i = torch.floor(h6)
    f = h6 - i
    sf = s / 255.0
    p = v * (1.0 - sf)
    q = v * (1.0 - sf * f)
    t = v * (1.0 - sf * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*values):
        out = values[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out

    return torch.stack([select(p, p, t, v, v, q), select(t, v, v, q, p, p),
                        select(v, q, p, p, t, v)], dim=-1)


def pack_boxes(boxes: torch.Tensor, classes: torch.Tensor,
               valid: torch.Tensor, max_out: int):
    """Valid-first stable pack of [B, N] slots into the first ``max_out``
    (truncation beyond them, as the mapper's densify does)."""
    order = torch.sort((~valid).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :max_out]
    return (boxes.gather(1, order[..., None].expand(-1, -1, 4)),
            classes.gather(1, order), valid.gather(1, order))


def flip_and_pack(img: torch.Tensor, boxes: torch.Tensor,
                  classes: torch.Tensor, valid: torch.Tensor,
                  do_flip: torch.Tensor, max_boxes: int
                  ) -> Dict[str, torch.Tensor]:
    """The stages' last step: the images [B, H, W, 3] and their boxes
    flipped horizontally where ``do_flip``, the boxes packed valid-first
    into ``max_boxes`` slots, zero where invalid (JAX :611-627)."""
    img = torch.where(do_flip[:, None, None, None], img.flip(2), img)
    ow = img.shape[2]
    x1 = torch.where(do_flip[:, None], ow - boxes[..., 2], boxes[..., 0])
    x2 = torch.where(do_flip[:, None], ow - boxes[..., 0], boxes[..., 2])
    boxes = torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)
    gb, gc, gv = pack_boxes(boxes, classes, valid, max_boxes)
    return {
        "image": img,
        "gt_boxes": torch.where(gv[..., None], gb, 0.0),
        "gt_classes": torch.where(gv, gc, 0),
        "gt_valid": gv,
    }


@dataclasses.dataclass
class PhotoDraws:
    """The random draws of one batch; tensors on the host or the card."""

    perm: torch.Tensor           # [B] mixup partner of each image
    do_mix: torch.Tensor         # [B] bool
    grid_params: torch.Tensor    # [B, 5] int32
    do_flip: torch.Tensor        # [B] bool
    # the HSV gains (float32 [B]), drawn where the distortion is on
    dhue: Optional[torch.Tensor] = None
    dsat: Optional[torch.Tensor] = None
    dexp: Optional[torch.Tensor] = None

    def to(self, device) -> "PhotoDraws":
        return PhotoDraws(*(None if t is None
                            else t.to(device, non_blocking=True)
                            for t in dataclasses.astuple(self)))


class DevicePhotometric:
    """MixUp blend, HSV distortion, GridMask and horizontal flip over a
    batch on the card. The kernel masks both bands always, so a GridMask
    without ``grid_mask_use_height`` or ``grid_mask_use_width`` raises.
    """

    def __init__(self, cfg):
        if cfg.grid_mask and not (cfg.grid_mask_use_height
                                  and cfg.grid_mask_use_width):
            raise NotImplementedError(
                "GridMask with one band only: the kernel masks both")
        self.mixup = cfg.mixup
        self.distortion = cfg.distortion
        self.hue = cfg.distortion_hue
        self.saturation = cfg.distortion_saturation
        self.exposure = cfg.distortion_exposure
        self.grid_mask = cfg.grid_mask
        self.grid_mask_prob = cfg.grid_mask_prob
        self.grid_mask_mode = cfg.grid_mask_mode
        self.flip_prob = cfg.flip_prob
        self.max_boxes = cfg.max_boxes
        self.disable_at = cfg.aug_disable_at_iter

    def draw(self, generator: torch.Generator, batch: int, h: int,
             w: int) -> PhotoDraws:
        perm = torch.randperm(batch, generator=generator)
        do_mix = torch.rand(batch, generator=generator) < 0.5
        if self.grid_mask:
            grid = sample_grid_mask_params(generator, batch, h, w,
                                           self.grid_mask_prob,
                                           self.grid_mask_mode)
        else:
            grid = torch.tensor(IDENTITY_GRID,
                                dtype=torch.int32).expand(batch, 5)
        do_flip = torch.rand(batch, generator=generator) < self.flip_prob
        if not self.distortion:
            return PhotoDraws(perm, do_mix, grid, do_flip)

        def gain(top):
            # U(1, top), or its reciprocal on a coin below 0.5 (JAX :703-714)
            g = 1.0 + torch.rand(batch, generator=generator) * (top - 1.0)
            coin = torch.rand(batch, generator=generator) < 0.5
            return torch.where(coin, g, 1.0 / g)

        dhue = -self.hue + torch.rand(batch, generator=generator) * (
            2.0 * self.hue)
        return PhotoDraws(perm, do_mix, grid, do_flip, dhue,
                          gain(self.saturation), gain(self.exposure))

    def batch_draws(self, generator: torch.Generator,
                    images: torch.Tensor) -> PhotoDraws:
        """:meth:`draw` for a batch of ``images`` [B, H, W, 3]."""
        b, h, w, _ = images.shape
        return self.draw(generator, b, h, w)

    def apply(self, batch: Dict[str, torch.Tensor],
              draws: PhotoDraws) -> Dict[str, torch.Tensor]:
        img = batch["image"]
        draws = draws.to(img.device)
        gb = batch["gt_boxes"].float()
        gc = batch["gt_classes"].to(torch.int32)
        gv = batch["gt_valid"]
        if self.mixup:
            img = img.float()
            perm = draws.perm
            mixed = img * 0.5 + img[perm] * 0.5
            img = torch.where(draws.do_mix[:, None, None, None], mixed, img)
            gb = torch.cat([gb, gb[perm]], dim=1)
            gc = torch.cat([gc, gc[perm]], dim=1)
            gv = torch.cat([gv, gv[perm] & draws.do_mix[:, None]], dim=1)
        if self.distortion:
            # float32 from here on: GridMask takes its float32 instance
            img = hsv_distort(img.float(), draws.dhue, draws.dsat,
                              draws.dexp)
        if self.grid_mask:
            img = grid_mask(img.contiguous(), draws.grid_params.contiguous())
        return flip_and_pack(img, gb, gc, gv, draws.do_flip, self.max_boxes)

    def passthrough(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The branch after ``aug_disable_at_iter``: no augmentation."""
        k = self.max_boxes
        return {
            "image": batch["image"],
            "gt_boxes": batch["gt_boxes"][:, :k].float(),
            "gt_classes": batch["gt_classes"][:, :k].to(torch.int32),
            "gt_valid": batch["gt_valid"][:, :k],
        }


def draw_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of the draws of ``step`` on ``rank``: ``seed * 2**32 +
    step`` on rank 0 (so that one-process runs and resumes repeat as they
    always did), a mix of the three on the other ranks."""
    if rank == 0:
        return seed * 2 ** 32 + step
    return int(np.random.SeedSequence([seed, step, rank]).generate_state(
        1, np.uint64)[0])


def make_packed_photo_step(cfg, train_step: Callable, seed: int = 0,
                           rank: Optional[int] = None) -> Callable:
    """Wrap ``train_step`` so that it takes a uint8 batch (on the host or
    the card): the batch moves to the model's device and goes through
    :class:`DevicePhotometric` until ``cfg.aug_disable_at_iter`` steps,
    then through its passthrough. The draws of step s come from a generator
    seeded with (seed, s, rank) (:func:`draw_seed`), so that a run repeats;
    ``rank`` is the data rank (by default the grid's, ``parallel.dist.
    get_data_rank``): each data rank draws for its own batch, so MixUp
    pairs images within a data rank's share (the reference's per-GPU
    mapper; the JAX mesh permutes the global batch), and the model ranks
    of a data slice draw alike, so that their replicated activations stay
    equal. The metrics gain ``grid_masked``, the number of images
    GridMask masked in the rank's step. A batch with ``gt_keypoints``
    raises: the flip and MixUp would not move them (the JAX package has no
    device photometric stage for keypoints)."""
    return _staged_step(DevicePhotometric(cfg), train_step, seed, rank)


def _staged_step(aug: DevicePhotometric, train_step: Callable, seed: int,
                 rank: Optional[int]) -> Callable:
    """``train_step`` behind the stage ``aug`` (:func:`make_packed_photo_step`,
    :func:`make_device_aug_step`)."""
    disable_at = int(aug.disable_at)
    if rank is None:
        from yolov7_d2_tpu_torch.parallel.dist import get_data_rank

        rank = get_data_rank()

    def step(state, batch: Dict[str, torch.Tensor]):
        if "gt_keypoints" in batch:
            raise NotImplementedError(
                "the device augmentation stages do not move keypoints: "
                "train YOLOX_KPTS with build_system's step on the batch")
        dev = next(state.model.parameters()).device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        masked = 0
        if state.step < disable_at:
            gen = torch.Generator().manual_seed(
                draw_seed(seed, state.step, rank))
            draws = aug.batch_draws(gen, batch["image"])
            if aug.grid_mask:
                masked = int((draws.grid_params[:, 0] > 1).sum())
            batch = aug.apply(batch, draws)
        else:
            batch = aug.passthrough(batch)
        state, metrics = train_step(state, batch)
        metrics["grid_masked"] = masked
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# the geometry stage: mosaic4, perspective, MixUp over a batch of tiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AugDraws:
    """The random draws of one batch for :class:`DeviceAug` (JAX
    ``AugParams``, :51), each with the batch first; tensors on the host or
    the card."""

    tile_idx: torch.Tensor     # [B, 4] int64: the sample, then 3 partners
    canvas_hw: torch.Tensor    # [B, 2] half canvas (ch, cw)
    center_yx: torch.Tensor    # [B, 2] mosaic centre on the canvas
    angle: torch.Tensor        # [B] degrees
    pscale: torch.Tensor       # [B]
    shear: torch.Tensor        # [B, 2] degrees (x, y)
    translate: torch.Tensor    # [B, 2] fractions of the output (x, y)
    persp: torch.Tensor        # [B, 2]
    do_mixup: torch.Tensor     # [B] bool
    mix_idx: torch.Tensor      # [B] int64, the MixUp partner
    mix_jit: torch.Tensor      # [B] the partner's scale jitter
    mix_flip: torch.Tensor     # [B] bool
    dhue: torch.Tensor         # [B]
    dsat: torch.Tensor         # [B]
    dexp: torch.Tensor         # [B]
    do_flip: torch.Tensor      # [B] bool
    grid_params: torch.Tensor  # [B, 5] int32

    def to(self, device) -> "AugDraws":
        return AugDraws(**{f.name: getattr(self, f.name).to(
            device, non_blocking=True) for f in dataclasses.fields(self)})


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as elementwise products summed over k in
    order: no matmul, so no TF32 whatever ``allow_tf32`` says."""
    return (a[..., :, 0, None] * b[..., None, 0, :]
            + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


def _matrix(rows) -> torch.Tensor:
    """Nine [B] tensors, row by row -> [B, 3, 3]."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def inverse3(m: torch.Tensor) -> torch.Tensor:
    """The inverse of each [3, 3] of ``m`` [B, 3, 3] by its adjugate over
    its determinant (``torch.linalg.inv`` would load a solver library at
    its first call on the card)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    c00, c01, c02 = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * c00 + b * c01 + c * c02
    adj = _matrix([(c00, -(b * i - c * h), b * f - c * e),
                   (c01, a * i - c * g, -(a * f - c * d)),
                   (c02, -(a * h - b * g), a * e - b * d)])
    return adj / det[:, None, None]


def perspective_matrix(out_hw: Tuple[int, int], canvas_hw: torch.Tensor,
                       angle: torch.Tensor, pscale: torch.Tensor,
                       shear_xy: torch.Tensor, translate_xy: torch.Tensor,
                       persp_xy: torch.Tensor) -> torch.Tensor:
    """M = T S R P C of the reference's ``random_perspective`` for each
    image (JAX :166), [B, 3, 3]: ``canvas_hw`` [B, 2] is the half canvas,
    so C moves by (-cw, -ch); R is cv2's rotation at (0, 0) scaled by
    ``pscale``; the shears in degrees; T in fractions of ``out_hw``."""
    oh, ow = out_hw
    ch, cw = canvas_hw[:, 0], canvas_hw[:, 1]
    rad = angle * (math.pi / 180.0)
    cos, sin = torch.cos(rad) * pscale, torch.sin(rad) * pscale
    shx = torch.tan(shear_xy[:, 0] * math.pi / 180.0)
    shy = torch.tan(shear_xy[:, 1] * math.pi / 180.0)
    one, zero = torch.ones_like(cos), torch.zeros_like(cos)
    C = _matrix([(one, zero, -cw), (zero, one, -ch), (zero, zero, one)])
    P = _matrix([(one, zero, zero), (zero, one, zero),
                 (persp_xy[:, 0], persp_xy[:, 1], one)])
    R = _matrix([(cos, sin, zero), (-sin, cos, zero), (zero, zero, one)])
    S = _matrix([(one, shx, zero), (shy, one, zero), (zero, zero, one)])
    T = _matrix([(one, zero, translate_xy[:, 0] * ow),
                 (zero, one, translate_xy[:, 1] * oh), (zero, zero, one)])
    return _mm3(_mm3(_mm3(_mm3(T, S), R), P), C)


def mosaic_placement(canvas_hw: torch.Tensor, center_yx: torch.Tensor,
                     tile_hw: torch.Tensor):
    """Each tile's paste rectangle on the canvas and its offset (JAX :223,
    the host mosaic4's formulas). ``tile_hw`` [B, 4, 2]: the tiles' scaled
    sizes, quadrants top-left, top-right, bottom-left, bottom-right.
    Returns (rect [B, 4, 4] x1a, y1a, x2a, y2a; pad [B, 4, 2] padw,
    padh)."""
    ch, cw = canvas_hw[:, 0], canvas_hw[:, 1]
    yc, xc = center_yx[:, 0], center_yx[:, 1]
    h, w = tile_hw[..., 0], tile_hw[..., 1]
    zero = torch.zeros_like(xc)
    x1a = torch.stack([(xc - w[:, 0]).clamp(min=0.0), xc,
                       (xc - w[:, 2]).clamp(min=0.0), xc], 1)
    y1a = torch.stack([(yc - h[:, 0]).clamp(min=0.0),
                       (yc - h[:, 1]).clamp(min=0.0), yc, yc], 1)
    x2a = torch.stack([xc, torch.minimum(xc + w[:, 1], 2.0 * cw), xc,
                       torch.minimum(xc + w[:, 3], 2.0 * cw)], 1)
    y2a = torch.stack([yc, yc, torch.minimum(yc + h[:, 2], 2.0 * ch),
                       torch.minimum(yc + h[:, 3], 2.0 * ch)], 1)
    x1b = torch.stack([w[:, 0] - (x2a[:, 0] - x1a[:, 0]), zero,
                       w[:, 2] - (x2a[:, 2] - x1a[:, 2]), zero], 1)
    y1b = torch.stack([h[:, 0] - (y2a[:, 0] - y1a[:, 0]),
                       h[:, 1] - (y2a[:, 1] - y1a[:, 1]), zero, zero], 1)
    rect = torch.stack([x1a, y1a, x2a, y2a], -1)
    pad = torch.stack([x1a - x1b, y1a - y1b], -1)
    return rect, pad


def bilinear_flat(pool_flat: torch.Tensor, base: torch.Tensor,
                  u: torch.Tensor, v: torch.Tensor, size: int,
                  inside: torch.Tensor, fill: float = GRAY) -> torch.Tensor:
    """Bilinear taps at pixel coordinates (``u``, ``v``) of the tile whose
    flat offset is ``base`` in ``pool_flat`` [B * S * S, 3] uint8 (JAX
    :262): four reads by a flat int64 index, the coordinates clipped into
    the tile; ``fill`` where not ``inside``. Returns float32 [..., 3]."""
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0, v0 = u0.long(), v0.long()
    top = size - 1

    def tap(vi, ui):
        flat = base + vi.clamp(0, top) * size + ui.clamp(0, top)
        return pool_flat[flat].float()

    val = (tap(v0, u0) * ((1 - fu) * (1 - fv))[..., None]
           + tap(v0, u0 + 1) * (fu * (1 - fv))[..., None]
           + tap(v0 + 1, u0) * ((1 - fu) * fv)[..., None]
           + tap(v0 + 1, u0 + 1) * (fu * fv)[..., None])
    return torch.where(inside[..., None], val, fill)


def _pixel_grid(out_hw: Tuple[int, int], device):
    oh, ow = out_hw
    ys = torch.arange(oh, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(ow, dtype=torch.float32, device=device)[None, :]
    return ys, xs


def mosaic_perspective_image(pool_flat: torch.Tensor, tile_size: int,
                             out_hw: Tuple[int, int], tile_idx: torch.Tensor,
                             tile_pre_hw: torch.Tensor,
                             tile_canvas_hw: torch.Tensor,
                             rect: torch.Tensor, pad: torch.Tensor,
                             m: torch.Tensor) -> torch.Tensor:
    """The mosaic paste and the perspective warp as one gather (JAX :297)
    for a batch: ``tile_idx`` [B, 4] the tiles of each mosaic in the pool,
    ``tile_pre_hw`` [B, 4, 2] their sizes in the pool, ``tile_canvas_hw``
    [B, 4, 2] on the canvas, ``rect`` / ``pad`` from
    :func:`mosaic_placement`, ``m`` [B, 3, 3]. Each output pixel maps to
    the canvas by M^-1 (warpPerspective's convention), to its quadrant's
    tile by the paste offset and cv2.resize's pixel centres, and takes
    four bilinear taps. Returns float32 [B, oh, ow, 3]."""
    minv = inverse3(m)
    ys, xs = _pixel_grid(out_hw, m.device)

    def row(i):
        return (minv[:, i, 0, None, None] * xs
                + minv[:, i, 1, None, None] * ys + minv[:, i, 2, None, None])

    cz = row(2)
    cx, cy = row(0) / cz, row(1) / cz
    q = ((cx >= rect[:, 0, 2, None, None]).long()
         + 2 * (cy >= rect[:, 0, 3, None, None]).long())
    flat_q = q.flatten(1)

    def take(per_tile):
        """[B, 4] -> the value of each pixel's quadrant, [B, oh, ow]."""
        return per_tile.gather(1, flat_q).view_as(q)

    inside = ((cx >= take(rect[..., 0])) & (cx < take(rect[..., 2]))
              & (cy >= take(rect[..., 1])) & (cy < take(rect[..., 3])))
    ratio_x = tile_canvas_hw[..., 1] / tile_pre_hw[..., 1].clamp(min=1e-6)
    ratio_y = tile_canvas_hw[..., 0] / tile_pre_hw[..., 0].clamp(min=1e-6)
    u = (cx - take(pad[..., 0]) + 0.5) / take(ratio_x) - 0.5
    v = (cy - take(pad[..., 1]) + 0.5) / take(ratio_y) - 0.5
    base = take(tile_idx) * (tile_size * tile_size)
    return bilinear_flat(pool_flat, base, u, v, tile_size, inside)


def box_candidates(b: torch.Tensor, min_wh: float = 2.0,
                   max_ar: float = 20.0) -> torch.Tensor:
    """Boxes wider and taller than ``min_wh`` with an aspect below
    ``max_ar`` (JAX :395)."""
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    ar = torch.maximum(w / (h + 1e-16), h / (w + 1e-16))
    return (w > min_wh) & (h > min_wh) & (ar < max_ar)


def _clip(x: torch.Tensor, hi) -> torch.Tensor:
    """``jnp.clip(x, 0, hi)``, ``hi`` a number or a tensor that
    broadcasts."""
    return torch.minimum(x.clamp(min=0.0), torch.as_tensor(hi, dtype=x.dtype,
                                                           device=x.device))


def transform_boxes(boxes4: torch.Tensor, valid4: torch.Tensor,
                    scale4: torch.Tensor, pad: torch.Tensor,
                    canvas_hw: torch.Tensor, m: torch.Tensor,
                    out_hw: Tuple[int, int], min_wh: float = 2.0,
                    max_ar: float = 20.0):
    """The mosaic's boxes (JAX :345) for a batch: ``boxes4`` [B, 4, M, 4]
    in the tiles' pool coordinates, scaled by ``scale4`` [B, 4] and moved
    by ``pad``, clipped to the canvas and filtered, their four corners
    through ``m``, the hull clipped to the output and filtered again.
    Returns ([B, 4M, 4], [B, 4M] valid)."""
    oh, ow = out_hw
    b = boxes4 * scale4[..., None, None]
    shift = pad[:, :, None, :].repeat(1, 1, 1, 2)     # padw, padh, padw, padh
    b = (b + shift).flatten(1, 2)
    valid = valid4.flatten(1, 2)
    cw2 = 2.0 * canvas_hw[:, 1, None]
    ch2 = 2.0 * canvas_hw[:, 0, None]
    b = torch.stack([_clip(b[..., 0], cw2), _clip(b[..., 1], ch2),
                     _clip(b[..., 2], cw2), _clip(b[..., 3], ch2)], -1)
    valid = valid & box_candidates(b, min_wh, max_ar)
    x = torch.stack([b[..., 0], b[..., 2], b[..., 0], b[..., 2]], -1)
    y = torch.stack([b[..., 1], b[..., 3], b[..., 3], b[..., 1]], -1)

    def row(i):
        return (m[:, i, 0, None, None] * x + m[:, i, 1, None, None] * y
                + m[:, i, 2, None, None])

    z = row(2)
    px, py = row(0) / z, row(1) / z
    warped = torch.stack([_clip(px.amin(-1), ow), _clip(py.amin(-1), oh),
                          _clip(px.amax(-1), ow), _clip(py.amax(-1), oh)],
                         -1)
    return warped, valid & box_candidates(warped, min_wh, max_ar)


def mixup_image(pool_flat: torch.Tensor, tile_size: int,
                out_hw: Tuple[int, int], img: torch.Tensor,
                partner_idx: torch.Tensor, partner_pre_hw: torch.Tensor,
                partner_orig_hw: torch.Tensor, jit: torch.Tensor,
                flip: torch.Tensor):
    """YOLOX MixUp (JAX :402) for a batch: each partner resized by its
    jitter onto a gray canvas of the output size, flipped where ``flip``,
    blended 0.5 / 0.5 with ``img``. Returns (the blend, r [B] the partner's
    original-to-canvas scale, (nh, nw) its size on the canvas)."""
    oh, ow = out_hw
    h0, w0 = partner_orig_hw[:, 0], partner_orig_hw[:, 1]
    r = torch.minimum(oh / h0, ow / w0) * jit
    nh, nw = h0 * r, w0 * r
    ry = nh / partner_pre_hw[:, 0].clamp(min=1e-6)
    rx = nw / partner_pre_hw[:, 1].clamp(min=1e-6)
    ys, xs = _pixel_grid(out_hw, img.device)
    b = (slice(None), None, None)
    xr = torch.where(flip[b], nw[b] - 1.0 - xs, xs)
    u = (xr + 0.5) / rx[b] - 0.5
    v = (ys + 0.5) / ry[b] - 0.5
    inside = ((xs < torch.clamp(nw, max=ow)[b])
              & (ys < torch.clamp(nh, max=oh)[b]))
    base = (partner_idx * (tile_size * tile_size))[b]
    canvas = bilinear_flat(pool_flat, base, u, v, tile_size, inside)
    return img * 0.5 + canvas * 0.5, r, (nh, nw)


def mixup_boxes(boxes: torch.Tensor, valid: torch.Tensor,
                pre_scale: torch.Tensor, r: torch.Tensor, nhw,
                flip: torch.Tensor, out_hw: Tuple[int, int],
                min_wh: float = 2.0, max_ar: float = 20.0):
    """The partners' boxes [B, M, 4] (pool coordinates) through MixUp's
    resize and flip, clipped and filtered (JAX :432)."""
    oh, ow = out_hw
    b = boxes * (r / pre_scale)[:, None, None]
    nw = nhw[1][:, None]
    f = flip[:, None]
    x1 = torch.where(f, nw - b[..., 2], b[..., 0])
    x2 = torch.where(f, nw - b[..., 0], b[..., 2])
    b = torch.stack([_clip(x1, ow), _clip(b[..., 1], oh), _clip(x2, ow),
                     _clip(b[..., 3], oh)], -1)
    return b, valid & box_candidates(b, min_wh, max_ar)


def _uniform(generator: torch.Generator, shape, lo: float,
             hi: float) -> torch.Tensor:
    return lo + torch.rand(shape, generator=generator) * (hi - lo)


class DeviceAug(DevicePhotometric):
    """mosaic4, the perspective warp, MixUp, HSV, GridMask and the flip
    over a batch of tiles (JAX ``DeviceAug``, :520), from a
    ``YoloxConfig``. Tiles (``mappers.TileDatasetMapper``): ``image``
    [B, S, S, 3] uint8 BGR letterboxed to fit S at the top left, gray pad;
    ``gt_boxes`` [B, M, 4] in the tiles' coordinates, ``gt_classes``,
    ``gt_valid``; ``orig_hw`` [B, 2] the images' sizes before the
    letterbox. GridMask (K3, ``kernels/grid_mask.py``) runs after HSV and
    before the flip, where :meth:`DevicePhotometric.apply` runs it (the
    JAX DEVICE path has none: ROADMAP.md C.48); the passthrough is
    :meth:`DevicePhotometric.passthrough`."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.cfg = cfg
        self.out_hw = tuple(cfg.input_size)

    def draw(self, generator: torch.Generator, batch: int) -> AugDraws:
        """Every draw of a batch on the host, in the JAX ranges (:72-158):
        3 partners a sample without replacement from the batch (the sample
        itself among the candidates), the half canvas in half the mosaic
        ranges and its centre at 0.5-1.5 of it, the warp's angle, scale,
        shears, translation and perspective, MixUp's coin (0.5, where
        mixup is on), partner, jitter and flip, the HSV gains (U(1, s) or
        its reciprocal on a coin), the flip and GridMask's parameters."""
        c = self.cfg
        if batch < 3:
            raise ValueError(f"mosaic4 takes 3 partners from the batch: a "
                             f"batch of {batch} has too few")
        g, n = generator, batch
        others = torch.rand((n, n), generator=g).argsort(1)[:, :3]
        tile_idx = torch.cat([torch.arange(n)[:, None], others], 1)
        ch = _uniform(g, n, c.mosaic_height_range[0] / 2.0,
                      c.mosaic_height_range[1] / 2.0)
        cw = _uniform(g, n, c.mosaic_width_range[0] / 2.0,
                      c.mosaic_width_range[1] / 2.0)
        yc = _uniform(g, n, 0.5, 1.5) * ch
        xc = _uniform(g, n, 0.5, 1.5) * cw
        angle = _uniform(g, n, -c.mosaic_degrees, c.mosaic_degrees)
        pscale = _uniform(g, n, *c.mosaic_scale)
        shear = _uniform(g, (n, 2), -c.mosaic_shear, c.mosaic_shear)
        translate = _uniform(g, (n, 2), 0.5 - c.mosaic_translate,
                             0.5 + c.mosaic_translate)
        persp = _uniform(g, (n, 2), -c.mosaic_perspective,
                         c.mosaic_perspective)
        coin = torch.rand(n, generator=g) < 0.5
        do_mixup = coin & self.mixup
        mix_idx = torch.randint(0, n, (n,), generator=g)
        mix_jit = _uniform(g, n, *c.mixup_scale)
        mix_flip = torch.rand(n, generator=g) < 0.5

        def gain(top):
            v = _uniform(g, n, 1.0, top)
            return torch.where(torch.rand(n, generator=g) < 0.5, v, 1.0 / v)

        dhue = _uniform(g, n, -c.distortion_hue, c.distortion_hue)
        dsat = gain(c.distortion_saturation)
        dexp = gain(c.distortion_exposure)
        do_flip = torch.rand(n, generator=g) < c.flip_prob
        if self.grid_mask:
            grid = sample_grid_mask_params(g, n, *self.out_hw,
                                           c.grid_mask_prob,
                                           c.grid_mask_mode)
        else:
            grid = torch.tensor(IDENTITY_GRID,
                                dtype=torch.int32).expand(n, 5)
        return AugDraws(
            tile_idx=tile_idx, canvas_hw=torch.stack([ch, cw], -1),
            center_yx=torch.stack([yc, xc], -1), angle=angle, pscale=pscale,
            shear=shear, translate=translate, persp=persp,
            do_mixup=do_mixup, mix_idx=mix_idx, mix_jit=mix_jit,
            mix_flip=mix_flip, dhue=dhue, dsat=dsat, dexp=dexp,
            do_flip=do_flip, grid_params=grid)

    def batch_draws(self, generator: torch.Generator,
                    images: torch.Tensor) -> AugDraws:
        return self.draw(generator, images.shape[0])

    def apply(self, tiles: Dict[str, torch.Tensor],
              draws: AugDraws) -> Dict[str, torch.Tensor]:
        """The augmented batch (JAX ``__call__``, :555): float32 ``image``
        [B, oh, ow, 3] and ``max_boxes`` valid-first box slots."""
        images = tiles["image"]
        n, s = images.shape[0], images.shape[1]
        if images.shape[1] != images.shape[2]:
            raise ValueError(f"tiles must be square: {tuple(images.shape)}")
        draws = draws.to(images.device)
        out_hw = self.out_hw
        pool = images.reshape(n * s * s, images.shape[-1])
        gt_boxes = tiles["gt_boxes"].float()
        gt_classes = tiles["gt_classes"].to(torch.int32)
        gt_valid = tiles["gt_valid"]
        orig_hw = tiles["orig_hw"].float()
        pre_scale = torch.minimum(s / orig_hw[:, 0], s / orig_hw[:, 1])
        pre_hw = orig_hw * pre_scale[:, None]

        idx = draws.tile_idx
        t_orig = orig_hw[idx]                           # [B, 4, 2]
        ch, cw = draws.canvas_hw[:, 0, None], draws.canvas_hw[:, 1, None]
        s_c = torch.minimum(ch / t_orig[..., 0], cw / t_orig[..., 1])
        t_canvas = t_orig * s_c[..., None]
        rect, pad = mosaic_placement(draws.canvas_hw, draws.center_yx,
                                     t_canvas)
        m = perspective_matrix(out_hw, draws.canvas_hw, draws.angle,
                               draws.pscale, draws.shear, draws.translate,
                               draws.persp)
        img = mosaic_perspective_image(pool, s, out_hw, idx, pre_hw[idx],
                                       t_canvas, rect, pad, m)
        bx, bv = transform_boxes(gt_boxes[idx], gt_valid[idx],
                                 s_c / pre_scale[idx], pad, draws.canvas_hw,
                                 m, out_hw)
        # the partner's slots follow the mosaic's, empty with mixup off
        j = draws.mix_idx
        if self.mixup:
            mixed, r_mix, nhw = mixup_image(
                pool, s, out_hw, img, j, pre_hw[j], orig_hw[j],
                draws.mix_jit, draws.mix_flip)
            img = torch.where(draws.do_mixup[:, None, None, None], mixed, img)
            mbx, mbv = mixup_boxes(gt_boxes[j], gt_valid[j], pre_scale[j],
                                   r_mix, nhw, draws.mix_flip, out_hw)
            mbv = mbv & draws.do_mixup[:, None]
        else:
            mbx, mbv = torch.zeros_like(gt_boxes), torch.zeros_like(gt_valid)
        bx, bv = torch.cat([bx, mbx], 1), torch.cat([bv, mbv], 1)
        cls = torch.cat([gt_classes[idx].flatten(1, 2), gt_classes[j]], 1)
        if self.distortion:
            img = hsv_distort(img, draws.dhue, draws.dsat, draws.dexp)
        if self.grid_mask:
            img = grid_mask(img.contiguous(), draws.grid_params.contiguous())
        return flip_and_pack(img, bx, cls, bv, draws.do_flip, self.max_boxes)


def make_device_aug_step(cfg, train_step: Callable, seed: int = 0,
                         rank: Optional[int] = None) -> Callable:
    """Wrap ``train_step`` so that it takes a batch of uint8 tiles with
    ``orig_hw`` (JAX :771): the tiles move to the model's device and go
    through :class:`DeviceAug` until ``cfg.aug_disable_at_iter`` steps,
    then through its passthrough. The draws of step s come from a
    generator seeded with :func:`draw_seed` (seed, s, data rank), so that a
    run and its resume repeat, each data rank mixes its own tiles, and the
    model ranks of a data slice draw alike (as
    :func:`make_packed_photo_step`). The metrics gain ``grid_masked``. A
    batch with ``gt_keypoints`` raises: the geometry does not move them."""
    return _staged_step(DeviceAug(cfg), train_step, seed, rank)
