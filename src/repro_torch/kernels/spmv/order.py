"""Space-filling-curve tile orders for the blocked SpMV grid (host side).

The blocked kernel streams one edge tile per grid step with a *single*
resident x window: a new x-block DMA is issued exactly when consecutive
steps name different source blocks.  Under the default ``'dest'`` order
(tiles sorted by destination block, then source block) the source block
changes at almost every step, so on a skewed graph the hub columns' x
blocks are re-fetched once per destination row they appear in — the
GraphMP observation that *ordering* edge blocks for cache reuse, not just
skipping them, is what closes the gap to in-memory execution.

A space-filling curve over the (dst_block, src_block) grid keeps
consecutive tiles adjacent in BOTH coordinates, so a large fraction of
steps reuse the resident x block (and revisit the same accumulator block
in short order):

  * ``'morton'`` — Z-order with the destination block on the LOW
    (fastest-varying) bits: within every 2x2 quad the curve moves along
    the destination axis first, which is precisely the move that keeps
    the x block resident.  Cheap to compute, but quad boundaries jump.
  * ``'hilbert'`` — the Hilbert curve: every consecutive pair of grid
    cells is Manhattan-adjacent (no jumps at any scale), giving the best
    worst-case locality of the three orders.

Both functions are vectorized numpy over int64 coordinates and are called
once at graph-build time (``ops.build_blocked``); nothing here runs on
device.  The price of a curve order is that one destination block's tiles
now form multiple non-contiguous *runs* in the schedule, which is why the
kernel's flush accumulates per run instead of overwriting (see
``ops.build_blocked`` and ``kernel.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["TILE_ORDERS", "curve_bits", "hilbert_key", "morton_key", "tile_curve_key"]

#: Recognized values of ``ExecutionPolicy.tile_order`` / ``build_blocked``.
TILE_ORDERS = ("dest", "morton", "hilbert")


def curve_bits(n_dst_blocks: int, n_src_blocks: int) -> int:
    """Bits per axis of the smallest pow2 grid covering the tile grid."""
    side = max(2, int(n_dst_blocks), int(n_src_blocks))
    return int(np.ceil(np.log2(side)))


def morton_key(db: np.ndarray, sb: np.ndarray, bits: int) -> np.ndarray:
    """Z-order key with the destination block on the even (low) bits.

    Putting ``db`` on the fast axis makes the finest-scale moves walk down
    a source column, the direction that keeps the x block resident.
    """
    db = np.asarray(db, np.int64)
    sb = np.asarray(sb, np.int64)
    key = np.zeros(db.shape, np.int64)
    for b in range(bits):
        key |= ((db >> b) & 1) << (2 * b)
        key |= ((sb >> b) & 1) << (2 * b + 1)
    return key


def hilbert_key(db: np.ndarray, sb: np.ndarray, bits: int) -> np.ndarray:
    """Hilbert d-index of each (db, sb) cell on the 2^bits x 2^bits grid.

    Vectorized form of the classic xy2d bit-twiddle: walk the quadrant
    bits from the top, accumulate the quadrant's rank along the curve,
    and rotate/reflect the remaining low bits into the quadrant's frame.
    Consecutive d-indices are Manhattan-adjacent cells — the invariant
    ``tests/test_tile_order.py`` checks.
    """
    x = np.asarray(db, np.int64).copy()
    y = np.asarray(sb, np.int64).copy()
    d = np.zeros(x.shape, np.int64)
    s = np.int64(1) << (bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate the quadrant: reflect when rx == 1, then swap axes —
        # only where ry == 0 (the two lower quadrants of the U).
        flip = (ry == 0) & (rx == 1)
        xf = np.where(flip, s - 1 - x, x)
        yf = np.where(flip, s - 1 - y, y)
        swap = ry == 0
        x = np.where(swap, yf, xf)
        y = np.where(swap, xf, yf)
        s >>= 1
    return d


def tile_curve_key(
    db: np.ndarray, sb: np.ndarray, n_dst_blocks: int, n_src_blocks: int,
    tile_order: str,
) -> np.ndarray:
    """Sort key realizing ``tile_order`` over (db, sb) tile coordinates."""
    if tile_order == "dest":
        return np.asarray(db, np.int64) * int(n_src_blocks) + np.asarray(
            sb, np.int64
        )
    bits = curve_bits(n_dst_blocks, n_src_blocks)
    if tile_order == "morton":
        return morton_key(db, sb, bits)
    if tile_order == "hilbert":
        return hilbert_key(db, sb, bits)
    raise ValueError(
        f"unknown tile_order {tile_order!r}; expected one of {TILE_ORDERS}"
    )
