"""Bipartite matching by a Jacobi auction (Bertsekas), batched over images
(JAX ``ops/matchers.py``): the matcher of SparseInst's loss, and of
DETR's when that family comes.

The JAX package runs the auction as a ``while_loop`` that it ``vmap``s over
the batch. Here one loop runs every image at once: an image is active while
it has an unassigned valid row (for at most ``max_iters`` rounds), and
only active images change, so an image's result does not depend on the
others. A converged image's round would change nothing anyway (no row
bids). The host reads whether any image is still active every
``check_every`` rounds only; the rounds in between, after the last image
converged, change nothing, so the result is the JAX one.

Kept from the JAX code, since they decide the assignment:

* ``jax.lax.top_k(vals, 2)`` puts the lowest index first among equal
  values: the best column is ``argmax`` (first maximum), the second value
  the maximum with that one column masked out;
* ``.at[j].max`` is ``scatter_reduce("amax")`` from ``NEG``; the winner
  among equal bids is the lowest row (``"amin"`` into a spare slot ``C``
  that is then dropped, as ``mode="drop"`` drops index ``C``);
* the row priority ``tie = arange(R) * eps * 1e-3`` and, in
  :func:`hungarian_match`, ``scale = max(max|cost|, 1)`` an image.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e18
CHECK_EVERY = 8


def auction_lap(
    benefit: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    eps: float = 1e-3,
    max_iters: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximize the sum of ``benefit[b, i, col_of(i)]`` over distinct
    columns, for each image b.

    benefit [B, R, C] float32; row_valid [B, R] rows to assign; col_valid
    [B, C] columns allowed; at most as many valid rows as valid columns.
    Returns ``col_of_row`` [B, R] int64 (-1 for unassigned and invalid
    rows), ``row_of_col`` [B, C] int64 (-1 for free columns) and the
    rounds each image took [B] int64."""
    bsz, r, c = benefit.shape
    dev = benefit.device
    b = torch.where(col_valid[:, None, :], benefit.float(),
                    torch.full((), NEG, device=dev))
    tie = torch.arange(r, dtype=torch.float32, device=dev) * (eps * 1e-3)
    rows = torch.arange(r, device=dev).expand(bsz, r)
    cols = torch.arange(c, device=dev).expand(bsz, c)
    prices = torch.zeros((bsz, c), device=dev)
    col_of = torch.full((bsz, r), -1, dtype=torch.long, device=dev)
    row_of = torch.full((bsz, c), -1, dtype=torch.long, device=dev)
    iters = torch.zeros((bsz,), dtype=torch.long, device=dev)
    neg = torch.full((bsz, c), NEG, device=dev)

    for it in range(max_iters):
        unassigned = (col_of < 0) & row_valid
        active = unassigned.any(1)
        if it % CHECK_EVERY == 0 and not bool(active.any()):
            break
        vals = b - prices[:, None, :]                         # [B, R, C]
        j_best = vals.argmax(-1)                              # first max
        top1 = vals.gather(-1, j_best[..., None])
        top2 = vals.scatter(-1, j_best[..., None],
                            float("-inf")).amax(-1)
        bid_incr = top1[..., 0] - top2 + eps
        bids = prices.gather(1, j_best) + bid_incr - tie
        bids = torch.where(unassigned, bids, NEG)

        obj_best_bid = neg.scatter_reduce(1, j_best, bids, "amax")
        is_winner = (unassigned & (bids > NEG * 0.5)
                     & (bids >= obj_best_bid.gather(1, j_best)))
        winner_row = torch.full((bsz, c + 1), r, dtype=torch.long,
                                device=dev).scatter_reduce(
            1, torch.where(is_winner, j_best, c),
            torch.where(is_winner, rows, r), "amin")[:, :c]
        has_winner = winner_row < r

        # evict the previous owner of each won column, assign the winners
        prev_owner = torch.where(has_winner, row_of, -1)
        evict = torch.zeros((bsz, r + 1), dtype=torch.bool,
                            device=dev).scatter(
            1, torch.where(prev_owner >= 0, prev_owner, r),
            True)[:, :r]
        new_col_of = torch.where(evict, -1, col_of)
        new_col_of = torch.cat([new_col_of, new_col_of[:, :1]], 1).scatter(
            1, torch.where(has_winner, winner_row, r),
            torch.where(has_winner, cols, -1))[:, :r]
        new_row_of = torch.where(has_winner, winner_row, row_of)
        new_prices = torch.where(has_winner, obj_best_bid, prices)

        act = active[:, None]
        col_of = torch.where(act, new_col_of, col_of)
        row_of = torch.where(act, new_row_of, row_of)
        prices = torch.where(act, new_prices, prices)
        iters = iters + active.long()
    col_of = torch.where(row_valid, col_of, -1)
    return col_of, row_of, iters


def hungarian_match(
    cost: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    eps: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize the total cost (``scipy.optimize.linear_sum_assignment``
    within ``R * eps * scale``) for each image: cost [B, R, C], divided by
    ``scale = max(max|cost|, 1)`` of its image. Returns what
    :func:`auction_lap` returns."""
    scale = cost.abs().flatten(1).amax(1).clamp(min=1.0)[:, None, None]
    return auction_lap(-cost / scale, row_valid, col_valid, eps=eps)
