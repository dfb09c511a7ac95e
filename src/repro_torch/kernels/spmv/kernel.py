"""Blocked semiring SpMV kernels B1-B4: CUDA for Hopper, plain torch beside.

The reference streams dense ``(Bd, Bs)`` edge tiles through a sequential
Pallas grid (``repro/kernels/spmv/kernel.py``: ``spmv_pallas``, bodies
``_kernel_plus_times`` lines 86-110 and ``_kernel_min_plus`` lines 113-136,
and ``spmv_pallas_compact``, bodies ``_kernel_plus_times_compact`` lines
199-224 and ``_kernel_min_plus_compact`` lines 227-250), carrying a
``(Bd, K)`` accumulator from one grid step to the next and flushing it at
each run's end::

    plus_times: y[dst_block] (+)= tile (Bd, Bs) @ x[src_block] (Bs, K)
    min_plus:   y[dst_block] (min)= min_s(tile[:, s] + x[src_block][s, :])

On the GPU the thread blocks run in parallel and in no order, and most
slots of a 128x128 tile are empty (a few edges a tile on an RMAT graph),
so the kernels in ``repro_torch/csrc/spmv.cu`` (see the source for the
design and its bound) read only a view's non-absent slots, 12 bytes an
entry, and never its dense tiles:

  * :func:`spmv_blocked` (B1, B3 on min_plus tiles) — every tile of the
    schedule, over the view's *row payload* (``BlockedGraph.row_ptr``,
    ``ent_tile``/``ent_src``/``ent_w`` and the segment table
    ``seg_ptr``/``row_seg``): segments of at most 128 of a destination
    row's entries, entries of tiles inactive under the frontier skipped,
    then the segments of each row combined in order.  At K=1 a 16-lane
    group takes a segment; at K > 1 a group of up to 32 threads takes it,
    loads each entry once, shares it by shuffles and runs the lanes across
    its threads (thread t: lanes t, t + 32, ...), each lane keeping the
    K=1 pass's 16 partials and tree, so a column's bits equal the K=1
    call's on that column.  Its plain version is
    :func:`blocked_spmv_plain_rows`.
  * :func:`spmv_blocked_compact` (B2, B4 on min_plus tiles) — only the
    live tiles ``perm[:nact]`` of the compacted schedule, over the
    *tile-major payload* (``tile_ptr``, ``tent_row``/``tent_src``/
    ``tent_w``): the live list grouped by destination block (a stable sort
    on the device under a curve order; 'dest' already is), cut into
    windows of 32 live tiles, each row's entries folded in list order,
    and the blocks spread over several windows combined in window order.
    At K=1 a thread a row folds its window's staged values; at K > 1 a
    window stages its entries once and sorts them by row, and then, a
    block of rows at a time, all its threads gather the entries' values
    (float4 chunks of x's row where K % 4 == 0, else words) and a thread
    a (row, chunk) folds its row's entries, so a lane's bits do not
    depend on K.  It also takes a :class:`TileBatch`, the
    batch-local payload that host residency stages per batch.  The
    wrapper does not synchronise with the device.  Its plain version is
    :func:`blocked_spmv_plain_compact_rows`.

Both follow the reference on an ``x`` holding +-inf or NaN: the dense
product's NaN on absent slots (0 * inf, +inf + -inf) is reproduced where
the reference has it (ROADMAP §C P12).

On a CPU tensor each wrapper runs its plain torch version over the dense
tiles (:func:`blocked_spmv_plain`, :func:`blocked_spmv_plain_compact`; a
:class:`TileBatch`'s tiles are rebuilt from its payload), which keeps the
reference's per-run summation structure: per-run sums of the tile
products, combined into the block in run order, so the full and the
compacted schedule, and host and device residency, agree bit for bit.  On
a CUDA tensor it launches the kernel or raises; ``launches`` counts kernel
launches, one key per kernel.  'bool' occupancy tiles run the plus_times
kernels.

The shared library is built with ``nvcc`` at first use into
``build/kernels/`` at the repository root (git-ignored), keyed by the
source's hash (:mod:`repro_torch.kernels.build`), and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from .. import build

__all__ = [
    "TileBatch",
    "blocked_spmv_plain",
    "blocked_spmv_plain_compact",
    "blocked_spmv_plain_compact_rows",
    "blocked_spmv_plain_rows",
    "build_library",
    "entry_rows",
    "launches",
    "reset_launches",
    "spmv_blocked",
    "spmv_blocked_compact",
]

# Lanes one launch takes; more are split into lane groups.  B1/B3's pass
# at K > 1 holds 16 partials a lane in registers, a thread takes every 32nd
# lane, and it is compiled for up to 6 lanes a thread (96 partial
# registers, no spill: ``chip_smoke.py`` checks ptxas's report), so 192.
# B2/B4 hold one float4 a thread whatever K is (more lanes take more
# passes); they take the same groups, which also bound their scratch.
_MAX_K = 192
_PLAIN_CHUNK = 512  # tiles per batched product in the plain versions
_WINDOW = 32  # live tiles a B2/B4 window (kWin in csrc/spmv.cu)

#: Kernel launches since the last :func:`reset_launches`: B1, B2, B3, B4.
launches = {"spmv_blocked": 0, "spmv_blocked_compact": 0,
            "spmv_blocked_min_plus": 0, "spmv_blocked_compact_min_plus": 0}
# launch key -> the function spmv.cu exports for it
_ENTRY = {"spmv_blocked": "spmv_rows",
          "spmv_blocked_compact": "spmv_compact",
          "spmv_blocked_min_plus": "spmv_rows_min_plus",
          "spmv_blocked_compact_min_plus": "spmv_compact_min_plus"}

_lib = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


@dataclasses.dataclass(frozen=True)
class TileBatch:
    """A batch-local tile view for :func:`spmv_blocked_compact`: the
    tile-major payload of the tiles staged for one batch (fields as in
    ``BlockedGraph``, with tile ids local to the batch) and ``sbid`` the
    global source block of each staged tile, so entry ``e`` reads row
    ``tent_src[e]`` of ``x_blocks.view(-1, K)``.  ``n`` sizes the output's
    destination blocks as in the graph's own view.  The staged tiles come
    grouped by destination block, as under the 'dest' order."""

    tile_ptr: torch.Tensor
    tent_row: torch.Tensor
    tent_src: torch.Tensor
    tent_w: torch.Tensor
    sbid: torch.Tensor
    n: int
    bd: int
    bs: int
    semiring: str
    tile_order = "dest"  # the staging order (a class constant)

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ptr.numel()) - 1

    @property
    def n_dst_blocks(self) -> int:
        return -(-self.n // self.bd)

    @property
    def n_src_blocks(self) -> int:
        return -(-self.n // self.bs)


def build_library() -> Path:
    """Compile ``csrc/spmv.cu`` for ``sm_90a`` (once per source hash) and
    return the shared library's path (see :mod:`repro_torch.kernels.build`)."""
    return build.build_library("spmv")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("spmv_rows", "spmv_rows_min_plus"):
            getattr(lib, fn).argtypes = [p] * 16 + [i] * 7 + [p]
            getattr(lib, fn).restype = i
        for fn in ("spmv_compact", "spmv_compact_min_plus"):
            getattr(lib, fn).argtypes = [p] * 11 + [i] * 6 + [p]
            getattr(lib, fn).restype = i
        _lib = lib
    return _lib


def _on_cpu(x_blocks: torch.Tensor) -> bool:
    """True for a CPU tensor (plain path), False for CUDA (kernel path)."""
    if x_blocks.device.type == "cpu":
        return True
    if x_blocks.device.type != "cuda":
        raise ValueError(f"no blocked SpMV for device {x_blocks.device}")
    return False


def _check_cuda(bg, x_blocks: torch.Tensor) -> None:
    """Refuse what the CUDA kernels do not take (no fallback)."""
    if bg.tent_w.device != x_blocks.device:
        raise ValueError("the tile view and x_blocks lie on different devices")
    if bg.tent_w.dtype != torch.float32 or x_blocks.dtype != torch.float32:
        raise TypeError("the blocked kernels take float32 weights and x")
    if not x_blocks.is_contiguous():
        raise ValueError("the blocked kernels take a contiguous x")
    if x_blocks.shape[-1] < 1:
        raise ValueError("the blocked kernels take at least one lane")
    if tuple(x_blocks.shape[:2]) != (bg.n_src_blocks, bg.bs):
        raise ValueError(f"x_blocks shape {tuple(x_blocks.shape)} does not "
                         f"match the tile view")


def _i32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor (no copy when it already is)."""
    return t.to(torch.int32).contiguous()


def _stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (the call
    that skips building a ``torch.cuda.Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _kernel_name(base: str, bg) -> str:
    return base + ("_min_plus" if bg.semiring == "min_plus" else "")


def _call(name: str, *args) -> None:
    err = getattr(_library(), _ENTRY[name])(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def spmv_blocked(bg, act: torch.Tensor, x_blocks: torch.Tensor) -> torch.Tensor:
    """B1 (B3 on min_plus tiles): y_blocks [nDB, Bd, K] f32 over the full
    tile schedule.

    A row none of whose entries lies in an active tile gets the identity
    (0, or +inf under min_plus), as a block whose tiles are all inactive
    flushes it; a block with no tile at all is left for the caller to fill
    (``ops.blocked_spmv``).  On the card the kernel reads the row payload,
    the tile-major payload's rows and columns (for a non-finite ``x``
    only) and ``x_blocks``.
    """
    if _on_cpu(x_blocks):
        return blocked_spmv_plain(bg, act, x_blocks)
    _check_cuda(bg, x_blocks)
    act = _i32(act.to(x_blocks.device))
    return _lane_groups(lambda xg: _launch_rows(bg, act, xg), bg, x_blocks)


def _lane_groups(launch, bg, x_blocks: torch.Tensor) -> torch.Tensor:
    """``launch(x)`` over ``x_blocks`` in groups of at most ``_MAX_K``
    lanes, one launch a group on the current stream, each group's result
    copied into its own columns of y.  A lane's arithmetic does not depend
    on the others or on K (B1/B3 keep the K=1 pass's 16 partials and tree
    in every lane; B2/B4 fold a row's entries in one order), so a lane's
    bits equal a K=1 call's on that column, whatever its group."""
    k = x_blocks.shape[-1]
    if k <= _MAX_K:
        return launch(x_blocks)
    y = torch.empty((bg.n_dst_blocks, bg.bd, k), dtype=torch.float32,
                    device=x_blocks.device)
    for lo in range(0, k, _MAX_K):
        hi = min(lo + _MAX_K, k)
        y[..., lo:hi] = launch(x_blocks[..., lo:hi].contiguous())
    return y


def _launch_rows(bg, act: torch.Tensor, x_blocks: torch.Tensor
                 ) -> torch.Tensor:
    name = _kernel_name("spmv_blocked", bg)
    k = x_blocks.shape[-1]
    dev = x_blocks.device
    n_rows = bg.row_ptr.numel() - 1
    n_segs = bg.seg_ptr.numel() - 1
    # y, the segment partials and the int32 poisoning counts (a source
    # block's per lane, then whether it has any) in one allocation (both
    # 4-byte types).
    out = torch.empty((n_rows + n_segs + bg.n_src_blocks) * k
                      + bg.n_src_blocks, dtype=torch.float32, device=dev)
    base = out.data_ptr()
    pois = base + (n_rows + n_segs) * k * 4
    _call(name, x_blocks.data_ptr(), base, base + n_rows * k * 4, pois,
          pois + bg.n_src_blocks * k * 4, bg.row_seg.data_ptr(),
          bg.seg_ptr.data_ptr(), bg.ent_tile.data_ptr(),
          bg.ent_src.data_ptr(), bg.ent_w.data_ptr(), act.data_ptr(),
          bg.dbid.data_ptr(), bg.sbid.data_ptr(), bg.tile_ptr.data_ptr(),
          bg.tent_row.data_ptr(), bg.tent_src.data_ptr(), n_rows, n_segs,
          bg.num_tiles, bg.bd, bg.n_src_blocks, bg.bs, k, _stream(dev))
    return out[: n_rows * k].view(bg.n_dst_blocks, bg.bd, k)


def spmv_blocked_compact(bg, perm, dbid, sbid, first, last, accum, nact: int,
                         x_blocks: torch.Tensor) -> torch.Tensor:
    """B2 (B4 on min_plus tiles): the same over the compacted work-list
    ``perm[:nact]`` (arguments as returned by ``ops.compact_tile_order``,
    sliced to the grid bucket).  ``bg`` is a ``BlockedGraph`` or a
    :class:`TileBatch`.  A block with no live tile gets the identity and
    is left for the caller to fill.  On the card only ``perm``, ``dbid``
    and ``nact`` are read, with no synchronisation."""
    if _on_cpu(x_blocks):
        return blocked_spmv_plain_compact(bg, perm, dbid, sbid, first, last,
                                          accum, nact, x_blocks)
    _check_cuda(bg, x_blocks)
    nact = int(nact)
    lst, ldb = perm[:nact], dbid[:nact]
    if bg.tile_order != "dest":  # group the live tiles by block, stably
        ldb, order = torch.sort(ldb, stable=True)
        lst = lst[order]
    lst, ldb = _i32(lst), _i32(ldb)
    return _lane_groups(lambda xg: _launch_compact(bg, lst, ldb, nact, xg),
                        bg, x_blocks)


def _launch_compact(bg, lst, ldb, nact: int, x_blocks: torch.Tensor
                    ) -> torch.Tensor:
    name = _kernel_name("spmv_blocked_compact", bg)
    k = x_blocks.shape[-1]
    dev = x_blocks.device
    n_y = bg.n_dst_blocks * bg.bd * k
    n_part = 2 * (-(-nact // _WINDOW)) * bg.bd * k
    n_int = bg.n_src_blocks * (k + 1) + 2 * bg.n_dst_blocks
    # y, the window partials and the int32 scratch in one allocation.
    out = torch.empty(n_y + n_part + n_int, dtype=torch.float32, device=dev)
    base = out.data_ptr()
    _call(name, x_blocks.data_ptr(), base, base + n_y * 4,
          base + (n_y + n_part) * 4, lst.data_ptr(), ldb.data_ptr(),
          bg.sbid.data_ptr(), bg.tile_ptr.data_ptr(), bg.tent_row.data_ptr(),
          bg.tent_src.data_ptr(), bg.tent_w.data_ptr(), nact,
          bg.n_dst_blocks, bg.bd, bg.n_src_blocks, bg.bs, k, _stream(dev))
    return out[:n_y].view(bg.n_dst_blocks, bg.bd, k)


# ------------------------------------------------------------ plain torch
def _identity(bg) -> float:
    return float("inf") if bg.semiring == "min_plus" else 0.0


def _batch_tiles(tb: TileBatch) -> torch.Tensor:
    """The dense tiles [tiles, Bd, Bs] of a batch, rebuilt from its
    payload."""
    tiles = torch.full((tb.num_tiles, tb.bd, tb.bs), _identity(tb),
                       dtype=torch.float32, device=tb.tent_w.device)
    t = torch.repeat_interleave(
        torch.arange(tb.num_tiles, device=tiles.device),
        torch.diff(tb.tile_ptr.long()), output_size=tb.tent_w.numel())
    tiles[t, tb.tent_row.long(),
          tb.tent_src.long() - tb.sbid[t].long() * tb.bs] = tb.tent_w
    return tiles


def _runs_into_blocks(bg, tiles, ids, runs, run_db, x_blocks) -> torch.Tensor:
    """Plain core: sum each listed tile's product into its run (in list
    order), then combine the runs into their blocks in run order."""
    k = x_blocks.shape[-1]
    minp = bg.semiring == "min_plus"
    fill = _identity(bg)
    acc = torch.full((run_db.numel(), bg.bd, k), fill, dtype=torch.float32,
                     device=x_blocks.device)
    for s in range(0, ids.numel(), _PLAIN_CHUNK):
        i = ids[s:s + _PLAIN_CHUNK].long()
        r = runs[s:s + _PLAIN_CHUNK].long()
        xin = x_blocks[bg.sbid[i].long()]  # [c, Bs, K]
        tl = tiles[i]  # [c, Bd, Bs]
        if minp:
            cand = (tl[:, :, :, None] + xin[:, None, :, :]).amin(dim=2)
            acc.scatter_reduce_(0, r[:, None, None].expand_as(cand), cand,
                                "amin", include_self=True)
        else:
            acc.index_add_(0, r, torch.bmm(tl, xin))
    y = torch.full((bg.n_dst_blocks, bg.bd, k), fill, dtype=torch.float32,
                   device=x_blocks.device)
    rdb = run_db.long()
    if minp:
        y.scatter_reduce_(0, rdb[:, None, None].expand_as(acc), acc, "amin",
                          include_self=True)
    else:
        y.index_add_(0, rdb, acc)
    return y


def blocked_spmv_plain(bg, act: torch.Tensor,
                       x_blocks: torch.Tensor) -> torch.Tensor:
    """Plain torch version of B1 (and of B3 on min_plus tiles)."""
    runs = torch.cumsum(bg.first.long(), 0) - 1
    ids = torch.nonzero(act).flatten()
    return _runs_into_blocks(bg, bg.tiles, ids, runs[ids],
                             bg.dbid[bg.first == 1], x_blocks)


def blocked_spmv_plain_compact(bg, perm, dbid, sbid, first, last, accum,
                               nact: int, x_blocks: torch.Tensor
                               ) -> torch.Tensor:
    """Plain torch version of B2 (and of B4 on min_plus tiles) over the
    dense tiles, as the reference computes it; a :class:`TileBatch`'s
    tiles are rebuilt from its payload first."""
    f = first[:nact].long()
    runs = torch.cumsum(f, 0) - 1
    tiles = _batch_tiles(bg) if isinstance(bg, TileBatch) else bg.tiles
    return _runs_into_blocks(bg, tiles, perm[:nact], runs,
                             dbid[:nact][f == 1], x_blocks)


def entry_rows(bg) -> torch.Tensor:
    """int64[E]: the destination row of each row-payload entry."""
    n_rows = bg.row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n_rows, device=bg.row_ptr.device),
        torch.diff(bg.row_ptr.long()), output_size=bg.ent_tile.numel())


def _tile_entries(bg, tiles: torch.Tensor):
    """``(j, e)``: for each tile-major entry of the listed ``tiles`` (in
    list order, then row-major), its list index and its entry index."""
    tp = bg.tile_ptr.long()
    beg = tp[tiles]
    cnt = tp[tiles + 1] - beg
    j = torch.repeat_interleave(torch.arange(tiles.numel(),
                                             device=tiles.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    e = beg[j] + torch.arange(j.numel(), device=tiles.device) - start[j]
    return j, e


def _poison(bg, tiles, db, x_blocks, y) -> torch.Tensor:
    """Write NaN into ``y`` [nDB * Bd, K] where the reference's dense
    product has it (ROADMAP §C P12): row r of the block of a live tile
    (``tiles``, blocks ``db``) whose source block holds a value of x in a
    column where r's slot is absent and the semiring turns it into NaN
    (+-inf or NaN under plus_times: 0 * x; -inf or NaN under min_plus:
    +inf + x).  Row r is such a row when fewer of its entries in the tile
    read such a value than the source block holds."""
    k = x_blocks.shape[-1]
    if bg.semiring == "min_plus":
        bad = torch.isnan(x_blocks) | (x_blocks == float("-inf"))
    else:
        bad = ~torch.isfinite(x_blocks)
    want = bad.sum(1)  # [nSB, K]
    sb = bg.sbid[tiles].long()
    hit = (want[sb] > 0).any(1)
    if not bool(hit.any()):
        return y
    tiles, db, sb = tiles[hit], db[hit], sb[hit]
    j, e = _tile_entries(bg, tiles)
    have = torch.zeros((tiles.numel() * bg.bd, k), dtype=torch.int64,
                       device=y.device)
    have.index_add_(0, j * bg.bd + bg.tent_row[e].long(),
                    bad.reshape(-1, k)[bg.tent_src[e].long()].long())
    p, r, kk = (have.view(-1, bg.bd, k) < want[sb][:, None, :]).nonzero(
        as_tuple=True)
    y[db[p] * bg.bd + r, kk] = float("nan")
    return y


def _fold_rows(bg, rows, w, xin, n_rows: int) -> torch.Tensor:
    """y [n_rows, K]: the identity, folded with ``w (x) xin`` by row."""
    minp = bg.semiring == "min_plus"
    y = torch.full((n_rows, xin.shape[1]), _identity(bg),
                   dtype=torch.float32, device=xin.device)
    if minp:
        val = w + xin
        y.scatter_reduce_(0, rows[:, None].expand_as(val), val, "amin",
                          include_self=True)
    else:
        y.index_add_(0, rows, w * xin)
    return y


def blocked_spmv_plain_rows(bg, act: torch.Tensor,
                            x_blocks: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the card's B1/B3 arithmetic: over the row
    payload's entries in live tiles (``act[ent_tile] != 0``), one
    ``index_add_`` (plus_times) or ``scatter_reduce_('amin')`` (min_plus)
    by destination row of ``w * x[src]`` or ``w + x[src]``.  A row with no
    live entry gets the identity; NaN where the dense form has it."""
    k = x_blocks.shape[-1]
    live = act[bg.ent_tile.long()] != 0
    xin = x_blocks.reshape(-1, k)[bg.ent_src[live].long()]
    y = _fold_rows(bg, entry_rows(bg)[live], bg.ent_w[live][:, None], xin,
                   bg.n_dst_blocks * bg.bd)
    tiles = torch.nonzero(act).flatten()
    y = _poison(bg, tiles, bg.dbid[tiles].long(), x_blocks, y)
    return y.view(bg.n_dst_blocks, bg.bd, k)


def blocked_spmv_plain_compact_rows(bg, perm, dbid, sbid, first, last, accum,
                                    nact: int, x_blocks: torch.Tensor
                                    ) -> torch.Tensor:
    """Plain torch version of the card's B2/B4 arithmetic: over the
    tile-major entries of the live tiles ``perm[:nact]`` (in list order,
    each tile row-major), one ``index_add_`` (plus_times) or
    ``scatter_reduce_('amin')`` (min_plus) by destination row.  ``bg`` is a
    ``BlockedGraph`` or a :class:`TileBatch`.  A row with no live entry
    gets the identity; NaN where the dense form has it."""
    k = x_blocks.shape[-1]
    tiles = perm[:nact].long()
    db = dbid[:nact].long()
    j, e = _tile_entries(bg, tiles)
    xin = x_blocks.reshape(-1, k)[bg.tent_src[e].long()]
    y = _fold_rows(bg, db[j] * bg.bd + bg.tent_row[e].long(),
                   bg.tent_w[e][:, None], xin, bg.n_dst_blocks * bg.bd)
    y = _poison(bg, tiles, db, x_blocks, y)
    return y.view(bg.n_dst_blocks, bg.bd, k)
