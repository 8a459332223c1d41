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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from yolov7_d2_tpu_torch.kernels.grid_mask import grid_mask

IDENTITY_GRID = (1, 1, 0, 0, 0)  # mode 0 with keep = d: zeroes nothing


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
        do_flip = draws.do_flip
        img = torch.where(do_flip[:, None, None, None], img.flip(2), img)
        ow = img.shape[2]
        fx1 = torch.where(do_flip[:, None], ow - gb[..., 2], gb[..., 0])
        fx2 = torch.where(do_flip[:, None], ow - gb[..., 0], gb[..., 2])
        gb = torch.stack([fx1, gb[..., 1], fx2, gb[..., 3]], dim=-1)
        gb, gc, gv = pack_boxes(gb, gc, gv, self.max_boxes)
        return {
            "image": img,
            "gt_boxes": torch.where(gv[..., None], gb, 0.0),
            "gt_classes": torch.where(gv, gc, 0),
            "gt_valid": gv,
        }

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
                           rank: int = 0) -> Callable:
    """Wrap ``train_step`` so that it takes a uint8 batch (on the host or
    the card): the batch moves to the model's device and goes through
    :class:`DevicePhotometric` until ``cfg.aug_disable_at_iter`` steps,
    then through its passthrough. The draws of step s come from a generator
    seeded with (seed, s, rank) (:func:`draw_seed`), so that a run repeats.
    Each rank draws for its own batch, so MixUp pairs images within a
    rank's share (the reference's per-GPU mapper; the JAX mesh permutes the
    global batch). The metrics gain ``grid_masked``, the number of images
    GridMask masked in the rank's step. A batch with ``gt_keypoints``
    raises: the flip and MixUp would not move them (the JAX package has no
    device photometric stage for keypoints)."""
    aug = DevicePhotometric(cfg)
    disable_at = int(cfg.aug_disable_at_iter)

    def step(state, batch: Dict[str, torch.Tensor]):
        if "gt_keypoints" in batch:
            raise NotImplementedError(
                "the device photometric stage does not move keypoints: "
                "train YOLOX_KPTS with build_system's step on the batch")
        dev = next(state.model.parameters()).device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        masked = 0
        if state.step < disable_at:
            b, h, w, _ = batch["image"].shape
            gen = torch.Generator().manual_seed(
                draw_seed(seed, state.step, rank))
            draws = aug.draw(gen, b, h, w)
            if aug.grid_mask:
                masked = int((draws.grid_params[:, 0] > 1).sum())
            batch = aug.apply(batch, draws)
        else:
            batch = aug.passthrough(batch)
        state, metrics = train_step(state, batch)
        metrics["grid_masked"] = masked
        return state, metrics

    return step
