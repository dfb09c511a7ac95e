"""Host-side blocked-graph format + the blocked SpMV entry point (torch port
of ``repro.kernels.spmv.ops``).

``build_blocked`` converts a CSR :class:`repro_torch.graph.csr.Graph` into
the dense-tile format the kernel streams: vertices are split into
destination blocks of ``Bd`` rows and source blocks of ``Bs`` columns, and
every (dst_block, src_block) pair holding at least one edge becomes one
dense ``(Bd, Bs)`` weight tile.  ``tile_order`` picks the streaming
schedule ('dest', or a Morton/Hilbert curve, see :mod:`.order`); under a
curve order a destination block occupies several *runs*, and a run whose
block was already flushed carries ``accum=1``.  The tiles and the schedule
are byte-identical to the reference tiler's.  Each view also carries its
non-absent slots twice (:func:`row_payload`): as a CSR by destination row
(the *row payload*, which the full-schedule kernels B1/B3 read on the
card) and tile by tile in schedule order (the *tile-major payload*, which
the compacted-work-list kernels B2/B4 read).  No card kernel reads the
dense tiles.

:func:`blocked_spmv` counts fetched/skipped tiles so the kernel path
reports the same I/O metrics as the scan engine.  On a CUDA tensor it runs
the hand-written kernels of :mod:`.kernel`; on a CPU tensor their plain
torch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..._device import resolve_device
from ...graph.csr import Graph
from .kernel import spmv_blocked, spmv_blocked_compact
from .order import TILE_ORDERS, tile_curve_key

__all__ = [
    "BlockedGraph",
    "PAYLOAD",
    "REFERENCE_FIELDS",
    "SEG_ENTRIES",
    "TILE_ORDERS",
    "blocked_graph",
    "build_blocked",
    "build_blocked_arrays",
    "build_payload_arrays",
    "blocked_spmv",
    "compact_grid_size",
    "compact_tile_order",
    "row_payload",
    "tile_activity",
    "tile_byte_size",
    "x_fetch_count",
]


#: The reference view's tensors (its dense tiles and six schedule arrays),
#: and the payloads the port holds beside them.
REFERENCE_FIELDS = ("tiles", "dbid", "sbid", "first", "last", "accum", "nnz")
PAYLOAD = ("row_ptr", "ent_tile", "ent_src", "ent_w", "seg_ptr", "row_seg",
           "tile_ptr", "tent_row", "tent_src", "tent_w")


@dataclasses.dataclass(frozen=True)
class BlockedGraph:
    """Dense-tile blocked view of a graph (edges as (Bd, Bs) tiles).

    The first seven tensors are the reference's.  The rest hold every slot
    that does not hold the semiring's absent value (0, or +inf under
    min_plus) in two orders, which the card kernels read in place of the
    dense tiles.  The *row payload* (B1/B3) is a CSR by destination row
    of the view (``row = dbid * Bd + slot row``).  Entry ``e`` of row ``r``
    (``row_ptr[r] <= e < row_ptr[r+1]``) is the slot of schedule position
    ``ent_tile[e]`` that reads row ``ent_src[e]`` of ``x_blocks.view(-1,
    K)`` with weight ``ent_w[e]``; a row's entries go in ascending
    schedule position, then column.  Rows are cut into segments of at
    most :data:`SEG_ENTRIES` entries (``seg_ptr``: each segment's first
    entry; ``row_seg``: each row's first segment), so a hub row spreads
    over many lane groups.  The *tile-major payload* (B2/B4) holds the
    same slots tile by tile in schedule order, each tile's row-major:
    tile ``t``'s entries are ``tile_ptr[t] <= e < tile_ptr[t+1]``, at row
    ``tent_row[e]`` of its destination block, reading row ``tent_src[e]``
    of ``x_blocks.view(-1, K)`` with weight ``tent_w[e]``.  Both are built
    from the tiles themselves (:func:`row_payload`), so a view carried
    across from the reference gets the same payloads.
    """

    tiles: torch.Tensor  # [T, Bd, Bs] f32 edge weights (0 or +inf = absent)
    dbid: torch.Tensor  # [T] int32 destination block ids (schedule order)
    sbid: torch.Tensor  # [T] int32 source block ids
    first: torch.Tensor  # [T] int32 — tile starts a run of its dst block
    last: torch.Tensor  # [T] int32 — tile ends a run of its dst block
    accum: torch.Tensor  # [T] int32 — run's flush combines into y
    nnz: torch.Tensor  # [T] int32 — edge records baked into each tile
    row_ptr: torch.Tensor  # [nDB * Bd + 1] int32
    ent_tile: torch.Tensor  # [E] int32 schedule position of each entry
    ent_src: torch.Tensor  # [E] int32 row of x_blocks.view(-1, K) it reads
    ent_w: torch.Tensor  # [E] f32 the tile's value at that slot
    seg_ptr: torch.Tensor  # [S + 1] int32 first entry of each segment
    row_seg: torch.Tensor  # [nDB * Bd + 1] int32 first segment of each row
    tile_ptr: torch.Tensor  # [T + 1] int32 first tile-major entry of a tile
    tent_row: torch.Tensor  # [E] int32 row within the destination block
    tent_src: torch.Tensor  # [E] int32 row of x_blocks.view(-1, K) it reads
    tent_w: torch.Tensor  # [E] f32 the tile's value at that slot
    n: int
    bd: int
    bs: int
    semiring: str
    tile_order: str = "dest"

    @property
    def num_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def payload_nbytes(self) -> int:
        """Bytes of the row and tile-major payloads: what this view holds
        beyond the reference's tiles and schedule, which ``memory_report``
        counts alone (ROADMAP §C P14)."""
        return int(sum(getattr(self, name).nbytes for name in PAYLOAD))

    @property
    def n_dst_blocks(self) -> int:
        return -(-self.n // self.bd)

    @property
    def n_src_blocks(self) -> int:
        return -(-self.n // self.bs)


def _run_flags(dbid: np.ndarray, n_dst_blocks: int):
    """(first, last, accum) int32 run flags over a tile schedule.

    A *run* is a maximal stretch of consecutive tiles sharing a destination
    block; ``accum`` marks runs whose block an earlier run already flushed.
    """
    T = len(dbid)
    first = np.ones(T, np.int32)
    first[1:] = (dbid[1:] != dbid[:-1]).astype(np.int32)
    last = np.ones(T, np.int32)
    last[:-1] = (dbid[1:] != dbid[:-1]).astype(np.int32)
    starts = np.flatnonzero(first)
    run_db = dbid[starts].astype(np.int64)
    n_runs = len(starts)
    first_run = np.full(max(1, n_dst_blocks), n_runs, np.int64)
    np.minimum.at(first_run, run_db, np.arange(n_runs))
    accum_run = (np.arange(n_runs) > first_run[run_db]).astype(np.int32)
    accum = accum_run[np.cumsum(first) - 1]
    return first, last, accum


def _tile_layout(g: Graph, *, bd: int, bs: int, direction: str,
                 semiring: str, reverse: bool, tile_order: str) -> dict:
    """The tiler without the dense array: the schedule plus each occupied
    tile slot's flat index and value.

    The reference tiler fills one tile at a time in a Python loop; here
    every edge gets its flat slot index ``tile * Bd * Bs + row * Bs + col``
    and duplicate slots are combined with one ``np.add.at`` /
    ``np.minimum.at`` in the same edge order, so the values are the
    reference's bit for bit.  Curve orders then renumber the tiles.
    """
    if tile_order not in TILE_ORDERS:
        raise ValueError(
            f"unknown tile_order {tile_order!r}; expected one of {TILE_ORDERS}"
        )
    if direction == "out":
        indptr, indices, w = g.indptr, g.indices, g.weights
    else:
        if g.in_indptr is None:
            raise ValueError("graph was built without the in-edge view")
        indptr, indices, w = g.in_indptr, g.in_indices, g.in_weights
    n = g.n
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = indices.astype(np.int64)
    if direction == "in":  # in-CSR rows are destinations
        src, dst = dst, src
    if w is None or semiring == "bool":
        # Unweighted edges carry the semiring's edge_op identity: 1 under
        # plus_times, 0 under min_plus; 'bool' tiles hold occupancy only.
        fill = 0.0 if semiring == "min_plus" else 1.0
        wv = np.full(len(src), fill, np.float32)
    else:
        wv = w.astype(np.float32)

    # Tile coordinates: rows are the scatter side, columns the gather side.
    row, col = (src, dst) if reverse else (dst, src)
    db, sb = row // bd, col // bs
    n_src_blocks = -(-n // bs)
    n_dst_blocks = -(-n // bd)
    key = db * n_src_blocks + sb
    order = np.argsort(key, kind="stable")
    db, sb, row, col, wv = db[order], sb[order], row[order], col[order], wv[order]
    uniq, start, tile_of = np.unique(key[order], return_index=True,
                                     return_inverse=True)

    T = max(1, len(uniq))
    dbid = np.zeros(T, np.int32)
    sbid = np.zeros(T, np.int32)
    nnz = np.zeros(T, np.int32)
    if len(uniq):
        dbid[: len(uniq)] = db[start]
        sbid[: len(uniq)] = sb[start]
        nnz[: len(uniq)] = np.diff(np.append(start, len(db)))
    area = bd * bs
    slot = (tile_of.astype(np.int64) * area + (row - db * bd) * bs
            + (col - sb * bs))
    uslot, slot_of = np.unique(slot, return_inverse=True)
    if semiring == "min_plus":
        val = np.full(len(uslot), np.inf, np.float32)
        np.minimum.at(val, slot_of, wv)
    elif semiring == "bool":
        val = np.ones(len(uslot), np.float32)  # occupancy, multi-edges idempotent
    else:
        val = np.zeros(len(uslot), np.float32)
        np.add.at(val, slot_of, wv)
    if tile_order != "dest" and T > 1:
        # Re-schedule the SAME tiles along the curve: only the stream order
        # (and hence the run structure) changes.
        ck = tile_curve_key(dbid, sbid, n_dst_blocks, n_src_blocks, tile_order)
        p = np.argsort(ck, kind="stable")
        dbid, sbid, nnz = dbid[p], sbid[p], nnz[p]
        new_pos = np.empty(T, np.int64)
        new_pos[p] = np.arange(T)
        uslot = new_pos[uslot // area] * area + uslot % area
    first, last, accum = _run_flags(dbid, n_dst_blocks)
    return dict(
        T=T, dbid=dbid, sbid=sbid, first=first, last=last, accum=accum,
        nnz=nnz, slot=uslot, val=val,
        absent=np.inf if semiring == "min_plus" else 0.0,
        n=n, bd=bd, bs=bs, semiring=semiring, tile_order=tile_order,
    )


# The host arrays of a tile view besides its tiles or payload.
_SCHEDULE = ("dbid", "sbid", "first", "last", "accum", "nnz", "n", "bd", "bs",
             "semiring", "tile_order")


def build_blocked_arrays(
    g: Graph,
    *,
    bd: int = 128,
    bs: int = 128,
    direction: str = "out",
    semiring: str = "plus_times",
    reverse: bool = False,
    tile_order: str = "dest",
) -> dict:
    """The tile arrays as plain host arrays (byte-identical to the
    reference's ``build_blocked_arrays``)."""
    lay = _tile_layout(g, bd=bd, bs=bs, direction=direction,
                       semiring=semiring, reverse=reverse,
                       tile_order=tile_order)
    tiles = np.full((lay["T"], bd, bs), lay["absent"], np.float32)
    tiles.reshape(-1)[lay["slot"]] = lay["val"]
    out = {k: lay[k] for k in _SCHEDULE}
    out["tiles"] = tiles
    return out


def build_payload_arrays(
    g: Graph,
    *,
    bd: int = 128,
    bs: int = 128,
    direction: str = "out",
    semiring: str = "plus_times",
    reverse: bool = False,
    tile_order: str = "dest",
) -> dict:
    """The schedule of :func:`build_blocked_arrays` and, in place of the
    dense tiles, the tile-major payload (``tile_ptr``, ``tent_row``,
    ``tent_src``, ``tent_w``, as in :class:`BlockedGraph`), as plain host
    arrays read from the same layout."""
    lay = _tile_layout(g, bd=bd, bs=bs, direction=direction,
                       semiring=semiring, reverse=reverse,
                       tile_order=tile_order)
    keep = lay["val"] != lay["absent"]
    order = np.argsort(lay["slot"][keep], kind="stable")
    slot, val = lay["slot"][keep][order], lay["val"][keep][order]
    t, rc = np.divmod(slot, bd * bs)
    row, col = np.divmod(rc, bs)
    tile_ptr = np.zeros(lay["T"] + 1, np.int64)
    tile_ptr[1:] = np.cumsum(np.bincount(t, minlength=lay["T"]))
    out = {k: lay[k] for k in _SCHEDULE}
    out.update(tile_ptr=tile_ptr.astype(np.int32),
               tent_row=row.astype(np.int32),
               tent_src=(lay["sbid"][t].astype(np.int64) * bs
                         + col).astype(np.int32),
               tent_w=val)
    return out


#: Most entries in one segment of the row payload: one pass of a 16-lane
#: group of B1/B3 (16 lanes x 8 entries, ``csrc/spmv.cu``).
SEG_ENTRIES = 128
_PAYLOAD_CHUNK_SLOTS = 1 << 27  # tile slots compared per step of the build


def row_payload(tiles: torch.Tensor, dbid: torch.Tensor, sbid: torch.Tensor,
                *, n: int, bd: int, bs: int, semiring: str) -> dict:
    """The row and tile-major payloads of a tile view (fields as in
    :class:`BlockedGraph`), read from the dense tiles.

    The tiles are compared with the absent value a chunk of tiles at a
    time, so no index over the whole tensor (up to 2**32 slots and more)
    is formed and coordinates stay (tile, row, column).  The chunks come
    in schedule order and each in row-major order: that is the tile-major
    payload as it stands, and one stable sort by destination row leaves
    every row's entries in schedule order, then column.
    """
    absent = float("inf") if semiring == "min_plus" else 0.0
    n_rows = -(-n // bd) * bd
    db, sb = dbid.long(), sbid.long()
    step = max(1, _PAYLOAD_CHUNK_SLOTS // (bd * bs))
    rows, ts, trows, srcs, ws = [], [], [], [], []
    for t0 in range(0, tiles.shape[0], step):
        chunk = tiles[t0:t0 + step]
        t, r, c = (chunk != absent).nonzero(as_tuple=True)
        ws.append(chunk[t, r, c])
        t = t + t0
        ts.append(t)
        trows.append(r)
        rows.append(db[t] * bd + r)
        srcs.append(sb[t] * bs + c)
    row = torch.cat(rows)
    tile = torch.cat(ts)
    src = torch.cat(srcs)
    w = torch.cat(ws)
    tile_ptr = torch.zeros(tiles.shape[0] + 1, dtype=torch.int64,
                           device=tiles.device)
    tile_ptr[1:] = torch.cumsum(torch.bincount(tile,
                                               minlength=tiles.shape[0]), 0)
    order = torch.sort(row, stable=True).indices
    counts = torch.bincount(row, minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=tiles.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    # Segments: row r's entries cut into ceil(count / SEG_ENTRIES) pieces.
    n_seg = (counts + SEG_ENTRIES - 1) // SEG_ENTRIES
    row_seg = torch.zeros_like(row_ptr)
    row_seg[1:] = torch.cumsum(n_seg, 0)
    seg_row = torch.repeat_interleave(
        torch.arange(n_rows, device=tiles.device), n_seg)
    piece = (torch.arange(seg_row.numel(), device=tiles.device)
             - row_seg[seg_row])
    seg_ptr = torch.cat([row_ptr[seg_row] + piece * SEG_ENTRIES,
                         row_ptr[-1:]])
    i32 = torch.int32
    return dict(row_ptr=row_ptr.to(i32), ent_tile=tile[order].to(i32),
                ent_src=src[order].to(i32), ent_w=w[order],
                seg_ptr=seg_ptr.to(i32), row_seg=row_seg.to(i32),
                tile_ptr=tile_ptr.to(i32), tent_row=torch.cat(trows).to(i32),
                tent_src=src.to(i32), tent_w=w)


def blocked_graph(tiles, dbid, sbid, first, last, accum, nnz, *, n, bd, bs,
                  semiring, tile_order="dest", device=None) -> BlockedGraph:
    """A :class:`BlockedGraph` on ``device`` (None: the CUDA device) from its
    arrays (numpy or torch), deriving the row payload from the tiles."""
    device = resolve_device(device)

    def t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.array(a))
        return a.to(device)

    tiles_t = t(tiles).to(torch.float32)
    dbid_t = t(dbid).to(torch.int32)
    sbid_t = t(sbid).to(torch.int32)
    payload = row_payload(tiles_t, dbid_t, sbid_t, n=int(n), bd=int(bd),
                          bs=int(bs), semiring=str(semiring))
    return BlockedGraph(
        tiles=tiles_t,
        dbid=dbid_t,
        sbid=sbid_t,
        first=t(first).to(torch.int32),
        last=t(last).to(torch.int32),
        accum=t(accum).to(torch.int32),
        nnz=t(nnz).to(torch.int32),
        **payload,
        n=int(n), bd=int(bd), bs=int(bs), semiring=str(semiring),
        tile_order=str(tile_order),
    )


def build_blocked(
    g: Graph,
    *,
    bd: int = 128,
    bs: int = 128,
    direction: str = "out",
    semiring: str = "plus_times",
    reverse: bool = False,
    tile_order: str = "dest",
    device=None,
) -> BlockedGraph:
    """Tile ``g``'s edges into dense (bd, bs) blocks on ``device`` (None:
    the CUDA device).

    The dense tile array is filled on the device from the occupied slots,
    so the host never holds the O(T * Bd * Bs) array.  Arguments as in the
    reference's ``build_blocked``.
    """
    device = resolve_device(device)
    lay = _tile_layout(g, bd=bd, bs=bs, direction=direction,
                       semiring=semiring, reverse=reverse,
                       tile_order=tile_order)
    tiles = torch.full((lay["T"], bd, bs), lay["absent"], dtype=torch.float32,
                       device=device)
    tiles.view(-1)[torch.as_tensor(lay["slot"]).to(device)] = (
        torch.as_tensor(lay["val"]).to(device))
    return blocked_graph(tiles, lay["dbid"], lay["sbid"], lay["first"],
                         lay["last"], lay["accum"], lay["nnz"], n=lay["n"],
                         bd=bd, bs=bs, semiring=semiring,
                         tile_order=tile_order, device=device)


def compact_tile_order(bg: BlockedGraph, act_tile: torch.Tensor):
    """Compact live tiles to the grid front; returns the permuted schedule.

    Semantics of the reference's ``compact_tile_order``: live tiles keep
    their schedule order; tail slots (``pos >= nact``) repeat the last live
    tile with ``first``/``last``/``accum`` forced to 0; run boundaries key on
    the ORIGINAL run id, and ``accum`` is recomputed over the live runs.

    Returns ``(perm, dbid, sbid, first, last, accum, nact)`` — int32[T]
    tensors plus the live count as a Python int (the ``nonzero`` that finds
    the live tiles synchronises with the device once).
    """
    T = bg.num_tiles
    dev = bg.dbid.device
    ids = torch.nonzero(act_tile).flatten()
    nact = int(ids.numel())
    run = (torch.cumsum(bg.first.long(), 0) - 1)[ids]  # original run id
    change = run[1:] != run[:-1]
    one = torch.ones(min(nact, 1), dtype=torch.bool, device=dev)
    first = torch.cat([one, change])
    # the last live step flushes even though the tail repeats its run.
    last = torch.cat([change, one])
    dbid = bg.dbid[ids].long()
    # accum over live runs: a run combines iff it is not the live run that
    # holds its dst block's first live position.
    first_pos = torch.full((bg.n_dst_blocks,), T, dtype=torch.int64, device=dev)
    first_pos.scatter_reduce_(0, dbid, torch.arange(nact, device=dev), "amin",
                              include_self=True)
    live_run = torch.cumsum(first, 0) - 1
    accum = live_run[first_pos[dbid]] != live_run
    # tail slots repeat the last live tile with every flag 0.
    tail = T - nact
    last_live = ids[-1:] if nact else torch.zeros(1, dtype=torch.int64,
                                                  device=dev)
    perm = torch.cat([ids, last_live.expand(tail)])
    zeros = torch.zeros(tail, dtype=torch.int32, device=dev)
    i32 = torch.int32
    return (perm.to(i32), bg.dbid[perm], bg.sbid[perm],
            torch.cat([first.to(i32), zeros]), torch.cat([last.to(i32), zeros]),
            torch.cat([accum.to(i32), zeros]), nact)


def compact_grid_size(num_tiles: int, num_active: int) -> int:
    """Smallest power-of-two grid covering ``num_active``, capped at T."""
    g = 1
    while g < max(1, num_active):
        g *= 2
    return min(g, max(1, num_tiles))


def x_fetch_count(sbid: torch.Tensor, act_tile: torch.Tensor) -> torch.Tensor:
    """int64 scalar: x-block fetches the LIVE schedule issues — one where
    consecutive live steps name different source blocks, plus one for the
    first live step (the counter ``tile_order`` moves)."""
    s = sbid[act_tile.bool()]
    return (s[1:] != s[:-1]).sum() + min(int(s.numel()), 1)


def tile_activity(
    bg: BlockedGraph, active: torch.Tensor, active_on: str = "src"
) -> torch.Tensor:
    """int32[T] 0/1 — which tiles a frontier would fetch: tiles whose source
    block (``'src'``, push) or destination block (``'dst'``, pull)
    intersects the frontier."""
    if active_on == "src":
        nb, blk, bid = bg.n_src_blocks, bg.bs, bg.sbid
    elif active_on == "dst":
        nb, blk, bid = bg.n_dst_blocks, bg.bd, bg.dbid
    else:
        raise ValueError(f"active_on must be 'src' or 'dst', got {active_on!r}")
    ap = torch.zeros(nb * blk, dtype=torch.bool, device=active.device)
    ap[: bg.n] = active
    return ap.view(nb, blk).any(dim=1)[bid.long()].to(torch.int32)


def tile_byte_size(bg: BlockedGraph) -> int:
    """Bytes one tile ships: dense f32 slots, or a 1-bit-per-slot bitmap for
    'bool' occupancy tiles."""
    if bg.semiring == "bool":
        return (bg.bd * bg.bs) // 8
    return bg.bd * bg.bs * 4


def blocked_spmv(
    bg: BlockedGraph,
    x: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    *,
    active_on: str = "src",
    compact: bool = False,
) -> tuple[torch.Tensor, dict]:
    """y = A (.) x over the blocked tiles, with frontier tile skipping.

    ``x``: [n] or [n, K]; ``active``: optional bool[n] frontier on the
    source (``'src'``) or destination (``'dst'``) side — skipping is block
    granular.  ``compact=True`` runs the frontier-compacted work-list
    (kernel B2) sized to the power-of-two bucket over the live count;
    otherwise the full schedule (kernel B1).  Both give the same values
    (B1 up to f32 summation order on the card).

    Every tile order is taken.  On the card B1 reads the view's row
    payload (each row's entries, tiles inactive under the frontier
    skipped), and B2 the tile-major payload of the live tiles only,
    grouped by destination block, so a block split over several curve
    runs sums all its live entries as the reference's runs do.

    Returns ``(y, stats)`` with ``tiles_fetched``, ``tiles_skipped``,
    ``tile_bytes``, ``messages`` (edge records in fetched tiles) and
    ``x_fetches`` — int64 scalar tensors.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = x.shape[1]
    n, bd, bs = bg.n, bg.bd, bg.bs
    ident = float("inf") if bg.semiring == "min_plus" else 0.0
    xp = torch.full((bg.n_src_blocks * bs, k), ident, dtype=torch.float32,
                    device=x.device)
    xp[:n] = x
    x_blocks = xp.view(bg.n_src_blocks, bs, k)

    if active is None:
        act_tile = torch.ones(bg.num_tiles, dtype=torch.int32, device=x.device)
    else:
        act_tile = tile_activity(bg, active, active_on)

    if compact:
        (perm, dbid_p, sbid_p, first_p, last_p, accum_p,
         nact) = compact_tile_order(bg, act_tile)
        G = compact_grid_size(bg.num_tiles, nact)
        y_blocks = spmv_blocked_compact(
            bg, perm[:G], dbid_p[:G], sbid_p[:G], first_p[:G], last_p[:G],
            accum_p[:G], nact, x_blocks)
        # Blocks with no LIVE tile are never flushed: the accumulate identity.
        flushed = torch.zeros(bg.n_dst_blocks, dtype=torch.int32,
                              device=x.device)
        flushed.scatter_reduce_(0, bg.dbid.long(), act_tile, "amax")
        keep = flushed > 0
    else:
        y_blocks = spmv_blocked(bg, act_tile, x_blocks)
        # A destination block owning NO tiles is never flushed.
        keep = torch.zeros(bg.n_dst_blocks, dtype=torch.bool, device=x.device)
        keep[bg.dbid.long()] = True
    y_blocks = torch.where(keep[:, None, None], y_blocks, ident)
    y = y_blocks.reshape(bg.n_dst_blocks * bd, k)[:n]
    if squeeze:
        y = y[:, 0]
    fetched = act_tile.sum()
    stats = {
        "tiles_fetched": fetched,
        "tiles_skipped": bg.num_tiles - fetched,
        "tile_bytes": fetched * tile_byte_size(bg),
        "messages": (bg.nnz.long() * act_tile).sum(),
        "x_fetches": x_fetch_count(bg.sbid, act_tile),
    }
    return y, stats
