"""Bilinear sampling whose backward sums in a fixed order: the deformable
convolution's ``F.grid_sample`` (``ops/deform_conv.py``) and RoIAlign's
gathers (``ops/roi_align.py``).

CUDA's own backward of both adds each sample's share into the input
gradient with atomics (``grid_sample``'s backward, ``index_add_``,
``scatter_add_``, ``index_put_`` with accumulate), in whatever order the
threads run, so two runs of a training step differ in the last bits there
(ROADMAP.md C.14). Here a sample's four shares all go to the 2x2 cell whose
top-left corner is the floor of its coordinate, so each sample carries one
key, that cell's position on a map padded by one row and column above and
left ((H + 1) x (W + 1) a plane, the floor -1 included). The samples are
sorted by key (a stable sort: equal keys keep the samples' order) and each
key's run of rows is summed in that order (``torch.segment_reduce``, one
thread an output that walks its run). The four corner planes are then
added, shifted onto the map, in a fixed order. Corners that fall outside
the map are dropped: zero padding (``grid_sample``), or a weight that is 0
at a clamped border (RoIAlign).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def corner_weights(wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The four bilinear weights [..., 4] of fractions ``wy``, ``wx``, in
    the corner order (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    return torch.stack([(1.0 - wy) * (1.0 - wx), (1.0 - wy) * wx,
                        wy * (1.0 - wx), wy * wx], -1)


def corner_keys(y0: torch.Tensor, x0: torch.Tensor, plane: torch.Tensor,
                h: int, w: int, planes: int) -> torch.Tensor:
    """Each sample's key: its floor cell (``y0``, ``x0`` integer-valued
    floats or ints) on plane ``plane`` of a map of ``planes`` planes of
    (h + 1) x (w + 1); ``planes (h + 1) (w + 1)`` (the trash key) where
    every corner lies outside the plane."""
    y0 = y0.clamp(-2, h).long()
    x0 = x0.clamp(-2, w).long()
    inside = (y0 >= -1) & (y0 < h) & (x0 >= -1) & (x0 < w)
    key = plane.long() * ((h + 1) * (w + 1)) + (y0 + 1) * (w + 1) + (x0 + 1)
    return torch.where(inside, key,
                       torch.full_like(key, planes * (h + 1) * (w + 1)))


def key_lengths(key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """How many of ``key`` [N] fall on each of ``num_keys`` (integer adds:
    exact in any order; ``bincount`` would read the largest key back to
    the host)."""
    return torch.zeros(num_keys, dtype=torch.long,
                       device=key.device).index_add_(
        0, key, torch.ones_like(key))


def segment_sum(rows: torch.Tensor, key: torch.Tensor,
                num_keys: int) -> torch.Tensor:
    """rows [N, D], key [N] in [0, num_keys) -> [num_keys, D]: each key's
    rows summed in their order in ``rows``, the same order on every run."""
    key = key.reshape(-1)
    order = torch.sort(key, stable=True).indices
    return torch.segment_reduce(rows[order], "sum",
                                lengths=key_lengths(key, num_keys), axis=0,
                                unsafe=True)


def fold_corners(sums: torch.Tensor) -> torch.Tensor:
    """[P, H + 1, W + 1, 4, C] corner sums by floor cell -> the gradient
    [P, H, W, C]: pixel (y, x) takes corner (y0, x0) of the cell at (y, x),
    (y0, x1) of (y, x - 1), (y1, x0) of (y - 1, x), (y1, x1) of (y - 1,
    x - 1), added in that order."""
    return (((sums[:, 1:, 1:, 0] + sums[:, 1:, :-1, 1])
             + sums[:, :-1, 1:, 2]) + sums[:, :-1, :-1, 3])


def scatter_bilinear(grad: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                     plane: torch.Tensor, planes: int, h: int,
                     w: int) -> torch.Tensor:
    """The input gradient of bilinear samples, in a fixed order: ``grad``
    [N, C] the samples' output gradients, ``y``, ``x`` [N] their (already
    clamped where the op clamps) float32 pixel coordinates, ``plane`` [N]
    their plane -> [planes, h, w, C] float32."""
    c = grad.shape[-1]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wts = corner_weights(y - y0, x - x0)                        # [N, 4]
    rows = (grad.float()[:, None, :] * wts[:, :, None]).reshape(-1, 4 * c)
    key = corner_keys(y0, x0, plane, h, w, planes)
    sums = segment_sum(rows, key, planes * (h + 1) * (w + 1) + 1)
    return fold_corners(sums[:-1].reshape(planes, h + 1, w + 1, 4, c))


def grid_sample_source(grid: torch.Tensor, h: int,
                       w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``F.grid_sample``'s pixel coordinates of a normalized grid
    (``align_corners=False``): ``((g + 1) size - 1) / 2``."""
    x = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
    y = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    return y, x


class _GridSample(torch.autograd.Function):
    """``F.grid_sample`` (bilinear, zero padding, ``align_corners=False``)
    with the input gradient of :func:`scatter_bilinear`; the grid's
    gradient is ``grid_sampler_2d_backward``'s own, which a thread an
    output computes without atomics (its input gradient is not asked
    for)."""

    @staticmethod
    def forward(ctx, img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(img, grid)
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        img, grid = ctx.saved_tensors
        grad_img: Optional[torch.Tensor] = None
        grad_grid: Optional[torch.Tensor] = None
        grad = grad.contiguous()
        if ctx.needs_input_grad[1]:
            _, grad_grid = torch.ops.aten.grid_sampler_2d_backward(
                grad, img, grid, 0, 0, False, [False, True])
        if ctx.needs_input_grad[0]:
            b, c, h, w = img.shape
            y, x = grid_sample_source(grid.float(), h, w)       # [B, Ho, Wo]
            plane = torch.arange(b, device=img.device)[:, None, None]
            g = scatter_bilinear(
                grad.permute(0, 2, 3, 1).reshape(-1, c), y.reshape(-1),
                x.reshape(-1), plane.expand_as(y).reshape(-1), b, h, w)
            grad_img = g.permute(0, 3, 1, 2).to(img.dtype)
        return grad_img, grad_grid


def grid_sample_fixed_order(img: torch.Tensor,
                            grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(img, grid, "bilinear", "zeros", align_corners=
    False)``, the same values, with the fixed-order input gradient."""
    if torch.is_grad_enabled() and (img.requires_grad or grid.requires_grad):
        return _GridSample.apply(img, grid)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)
