"""Plain torch oracle for the blocked SpMV (twin of ``repro.kernels.spmv.ref``).

Computes the kernel's contract — including the frontier *block*
granularity (a tile is applied iff its block holds an active vertex) — as
one batched product over all tiles plus a segment combine, independent of
the run schedule.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ops import BlockedGraph, tile_activity

__all__ = ["blocked_spmv_ref"]


def blocked_spmv_ref(
    bg: BlockedGraph,
    x: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    *,
    active_on: str = "src",
) -> torch.Tensor:
    """Same tile-level math as the kernel, as one einsum + segment combine."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = x.shape[1]
    n, bd, bs = bg.n, bg.bd, bg.bs
    minp = bg.semiring == "min_plus"
    ident = float("inf") if minp else 0.0
    xp = torch.full((bg.n_src_blocks * bs, k), ident, dtype=torch.float32,
                    device=x.device)
    xp[:n] = x
    x_blocks = xp.view(bg.n_src_blocks, bs, k)
    if active is None:
        act_tile = torch.ones(bg.num_tiles, dtype=torch.bool, device=x.device)
    else:
        act_tile = tile_activity(bg, active, active_on).bool()

    xin = x_blocks[bg.sbid.long()]  # [T, bs, k]
    dbid = bg.dbid.long()
    if not minp:  # plus_times and bool occupancy tiles
        contrib = torch.einsum("tds,tsk->tdk", bg.tiles, xin)
        contrib = torch.where(act_tile[:, None, None], contrib, 0.0)
        y_blocks = torch.zeros((bg.n_dst_blocks, bd, k), dtype=torch.float32,
                               device=x.device).index_add_(0, dbid, contrib)
    else:
        cand = (bg.tiles[:, :, :, None] + xin[:, None, :, :]).amin(dim=2)
        cand = torch.where(act_tile[:, None, None], cand, float("inf"))
        y_blocks = torch.full((bg.n_dst_blocks, bd, k), float("inf"),
                              dtype=torch.float32, device=x.device)
        y_blocks.scatter_reduce_(0, dbid[:, None, None].expand_as(cand), cand,
                                 "amin", include_self=True)
    y = y_blocks.reshape(-1, k)[:n]
    return y[:, 0] if squeeze else y
