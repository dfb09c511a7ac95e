"""Host residency: the semi-external-memory path (torch port of
``repro.core.residency``).

A :class:`HostGraph` keeps the O(m) edge arrays in host RAM as plain numpy
(:class:`HostChunkStore` / :class:`HostBlockedStore`, built by the same
choppers as the device views — :func:`repro_torch.core.sem.build_store_arrays`
and :func:`repro_torch.kernels.spmv.build_blocked_arrays` — so both
residencies stream byte-identical data in the same schedule).  Only the
degree vectors live on the device.  Each superstep ships only its live
work-list:

  1. plan on the host — the frontier's chunk/tile activity is mirrored in
     numpy (the formulas of ``chunk_activity`` / ``tile_activity``), giving
     the live ids in schedule order;
  2. batch — live units are grouped into ``ExecutionPolicy.stream_buffer``-
     sized batches (tile batches also respect run boundaries, see
     :func:`_stream_tiles`);
  3. double-buffer — on a CUDA device a batch is gathered into one of two
     pinned staging buffers and copied with ``non_blocking=True`` on a side
     stream; the compute stream waits on that copy's event only when it
     uses the batch, and a pinned buffer is refilled only after its
     previous copy's event has completed.  So batch k+1 crosses the host
     link while batch k computes, and the device holds O(n) vertex state
     plus O(stream_buffer) staging, never O(m).  On the CPU the batches
     are plain arrays.

``IOStats.host_bytes`` is the ``.nbytes`` of every payload shipped, padding
included — the reference's arrays, so the counter equals the reference's.
Every other IOStats field and the values equal the device residency's:
chunk batches pad with chunk 0 marked invalid (its records scatter the
identity to the sentinel row ``n``); tile batches never split a run and
give a block that flushed in an earlier batch at most one run per later
batch, so the host-side carry ``(+)=`` / ``min=`` repeats the kernel's
flush sequence; the p2p arm ships the same ``ecap`` lanes as the device
gather.  Tile batches run kernel B2 (plus_times and 'bool' tiles) or B4
(min_plus tiles) on the card.

The executors are eager Python: the live work-list is planned from the
concrete frontier every superstep.  :func:`run_program_host` is the port's
superstep loop over a host view.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..graph.csr import Graph
from .engine import (
    ExecutionPolicy,
    PolicyError,
    ResidencyError,
    _blocked_post,
    _blocked_pre_mask,
    _check_blocked_semiring,
    batched_union_frontier,
    check_residency,
    beamer_use_pull,
)
from .program import ProgramResult, bsp_loop
from .sem import (
    EDGE_RECORD_BYTES,
    IOStats,
    _fetch,
    _pad_y_init,
    _stats,
    _store_record_bytes,
    build_store_arrays,
    frontier_edge_mass,
    pad_state,
)
from .semiring import Semiring

__all__ = [
    "HostBlockedStore",
    "HostChunkStore",
    "HostGraph",
    "StreamFailure",
    "host_graph",
    "host_traverse",
    "inject_stream_faults",
    "run_program_host",
]

_BLOCKED = ("blocked", "blocked_compact")
_ALIGN = 16  # byte alignment of each array inside a staging buffer


# --------------------------------------------------------------------------
# host-link fault tolerance
# --------------------------------------------------------------------------
class StreamFailure(RuntimeError):
    """A host-to-device staging batch failed ``stream_retries + 1`` times in
    a row.  Transient failures never surface — the executor retries with
    exponential backoff and counts them in ``IOStats.retries`` — so this
    exception means the link is persistently down."""


# Test injection point: a callable run once per staging attempt, before the
# batch is staged; raising from it simulates a transient host-link failure.
_FAULT_HOOK = None


@contextlib.contextmanager
def inject_stream_faults(hook):
    """Install ``hook()`` to run before every host-to-device staging batch
    for the duration of the ``with`` block.  A raising hook simulates a
    transient link failure; the executors' bounded retry must absorb it
    (or raise :class:`StreamFailure` once the budget is spent)."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = hook
    try:
        yield
    finally:
        _FAULT_HOOK = prev


def _staged(pol: ExecutionPolicy, fn):
    """Run ``fn`` (one batch's staging) under the policy's bounded retry
    with backoff.  Returns ``(result, n_retries)``; raises
    :class:`StreamFailure` when ``stream_retries + 1`` attempts all fail.
    Staging only reads the host store, so a retry is always safe."""
    attempts = int(pol.stream_retries) + 1
    last = None
    for a in range(attempts):
        try:
            if _FAULT_HOOK is not None:
                _FAULT_HOOK()
            return fn(), a
        except Exception as e:  # noqa: BLE001 — any staging error is retryable
            last = e
            if a + 1 < attempts and pol.stream_backoff_s > 0:
                time.sleep(pol.stream_backoff_s * (2 ** a))
    raise StreamFailure(
        f"host->device stream failed after {attempts} attempts "
        f"(stream_retries={pol.stream_retries}): {last!r}"
    ) from last


def _pow2_at_least(k: int) -> int:
    g = 1
    while g < max(1, k):
        g *= 2
    return g


# --------------------------------------------------------------------------
# host stores
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HostChunkStore:
    """:class:`~repro_torch.core.sem.EdgeChunkStore` twin whose arrays are
    plain numpy in (pageable) host RAM."""

    major: np.ndarray
    minor: np.ndarray
    w: Optional[np.ndarray]
    lo: np.ndarray
    hi: np.ndarray
    n: int
    chunk_size: int
    sorted_by: str

    @property
    def num_chunks(self) -> int:
        return int(self.major.shape[0])

    @property
    def nbytes(self) -> int:
        return int(
            self.major.nbytes + self.minor.nbytes + self.lo.nbytes
            + self.hi.nbytes + (self.w.nbytes if self.w is not None else 0)
        )


@dataclasses.dataclass(frozen=True)
class HostBlockedStore:
    """:class:`~repro_torch.kernels.spmv.BlockedGraph` twin in host RAM
    (same tiles, schedule and run flags)."""

    tiles: np.ndarray
    dbid: np.ndarray
    sbid: np.ndarray
    first: np.ndarray
    last: np.ndarray
    accum: np.ndarray
    nnz: np.ndarray
    n: int
    bd: int
    bs: int
    semiring: str
    tile_order: str

    @property
    def num_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_dst_blocks(self) -> int:
        return -(-self.n // self.bd)

    @property
    def n_src_blocks(self) -> int:
        return -(-self.n // self.bs)

    @property
    def nbytes(self) -> int:
        return int(sum(
            a.nbytes for a in (self.tiles, self.dbid, self.sbid, self.first,
                               self.last, self.accum, self.nnz)
        ))


class _Staged:
    """One batch on its way to the device: the payload's tensors, and the
    event the compute stream waits on before it reads them (None on the
    CPU)."""

    def __init__(self, arrays, event):
        self.arrays = arrays
        self._event = event

    def ready(self) -> "_Staged":
        if self._event is not None:
            torch.cuda.current_stream(self.arrays[0].device).wait_event(
                self._event)
        return self


class _Stager:
    """Ships payloads host -> device.

    On a CUDA device: two pinned host buffers used in turn and one side
    stream.  :meth:`stage` waits until the chosen buffer's previous copy has
    completed, lets ``fill`` write the payload straight into it, and issues
    one ``non_blocking`` copy into a fresh device buffer on the side stream;
    ``record_stream`` keeps the allocator from reusing that device buffer
    before the compute stream is done with it.  On the CPU the payload is
    filled into fresh numpy arrays, which the tensors share."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.bufs = [None, None]
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
            self.turn = 0

    def stage(self, layout, fill) -> _Staged:
        """``layout``: [(dtype, shape)]; ``fill(arrays)`` writes the numpy
        arrays in place.  Returns the staged tensors, in layout order."""
        if not self.cuda:
            arrays = [np.empty(shape, dtype) for dtype, shape in layout]
            fill(arrays)
            return _Staged([torch.from_numpy(a) for a in arrays], None)
        offs, total = [], 0
        for dtype, shape in layout:
            offs.append(total)
            nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
            total += -(-nb // _ALIGN) * _ALIGN
        slot = self.turn
        self.turn ^= 1
        self.events[slot].synchronize()  # its previous copy has landed
        buf = self.bufs[slot]
        if buf is None or buf.numel() < total:
            buf = torch.empty(total + total // 4, dtype=torch.uint8,
                              pin_memory=True)
            self.bufs[slot] = buf
        host = buf.numpy()
        views = []
        for (dtype, shape), off in zip(layout, offs):
            nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
            views.append(host[off:off + nb].view(dtype).reshape(shape))
        fill(views)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            dev.copy_(buf[:total], non_blocking=True)
            self.events[slot].record(self.stream)
        dev.record_stream(torch.cuda.current_stream(self.device))
        tensors = []
        for (dtype, shape), off in zip(layout, offs):
            nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
            tensors.append(dev[off:off + nb].view(_TORCH_DTYPE[np.dtype(dtype)])
                           .view(shape))
        return _Staged(tensors, self.events[slot])


_TORCH_DTYPE = {np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.bool_): torch.bool}


class HostGraph:
    """Host-resident SEM view: the ``residency='host'`` twin of
    :class:`~repro_torch.core.sem.SemGraph`.

    The device holds only the degree vectors (the graph arrays the vertex
    programs read); edges stay in numpy stores and are shipped per
    superstep.  ``peak_stage_bytes`` records the largest in-flight staging
    footprint (at most two batches, by construction); ``streamed_bytes``
    counts every payload shipped, as a Python int that does not wrap
    (``IOStats.host_bytes`` keeps the reference's int32 wrap).
    """

    is_host_view = True

    def __init__(self, host: Graph, *, chunk_size: int = 4096,
                 bd: int = 128, bs: int = 128, device=None):
        self._device = resolve_device(device)
        self.host = host
        self.n = host.n
        self.m = host.m
        self.chunk_size = chunk_size
        self.bd, self.bs = bd, bs
        self.out_store = HostChunkStore(
            **build_store_arrays(host, sorted_by="src", chunk_size=chunk_size)
        )
        has_in = host.in_indptr is not None
        self.in_store = (
            HostChunkStore(**build_store_arrays(host, sorted_by="dst",
                                                chunk_size=chunk_size))
            if has_in else None
        )
        # The one O(n) device footprint (plus transient staging buffers).
        self.out_degree = torch.as_tensor(host.out_degree).to(self._device)
        self.in_degree = (torch.as_tensor(host.in_degree).to(self._device)
                          if has_in else None)
        self._blocked: dict = {}  # (semiring, reverse, tile_order) -> store
        self.peak_stage_bytes = 0
        self.streamed_bytes = 0
        self._stager: Optional[_Stager] = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def weighted(self) -> bool:
        return self.host.weights is not None

    def __repr__(self) -> str:
        return (f"HostGraph(n={self.n}, m={self.m}, "
                f"chunk_size={self.chunk_size}, device={self._device}, "
                f"host_bytes={self.store_nbytes})")

    @property
    def store_nbytes(self) -> int:
        """Host edge-store bytes (chunk + tile stores)."""
        total = self.out_store.nbytes
        if self.in_store is not None:
            total += self.in_store.nbytes
        total += sum(s.nbytes for s in self._blocked.values())
        return total

    def blocked_store(self, semiring: str, *, reverse: bool,
                      tile_order: str) -> HostBlockedStore:
        """The host tile store for one (encoding, direction, order), built
        once per key like the session's device tile cache."""
        key = (semiring, bool(reverse), tile_order)
        if key not in self._blocked:
            from ..kernels.spmv import build_blocked_arrays

            self._blocked[key] = HostBlockedStore(**build_blocked_arrays(
                self.host, bd=self.bd, bs=self.bs, direction="out",
                semiring=semiring, reverse=reverse, tile_order=tile_order,
            ))
        return self._blocked[key]

    def stager(self) -> _Stager:
        if self._stager is None:
            self._stager = _Stager(self._device)
        return self._stager

    def _note_stage(self, nbytes: int) -> None:
        if nbytes > self.peak_stage_bytes:
            self.peak_stage_bytes = int(nbytes)


def host_graph(g: Graph, *, chunk_size: int = 4096, bd: int = 128,
               bs: int = 128, device=None) -> HostGraph:
    """The host-resident SEM view of ``g`` (the ``residency='host'``
    analogue of :func:`~repro_torch.core.sem.device_graph`); ``device``
    (None: the CUDA device) holds its vertex state.  Chunk stores are built
    now, tile stores per (encoding, direction, tile_order) at first use."""
    return HostGraph(g, chunk_size=chunk_size, bd=bd, bs=bs, device=device)


def _nbytes(layout) -> int:
    return sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
               for dtype, shape in layout)


def _ship(hg: HostGraph, pol: ExecutionPolicy, layout, fill):
    """Stage one payload under the retry ladder: ``(staged, nbytes,
    retries)``."""
    staged, r = _staged(pol, lambda: hg.stager().stage(layout, fill))
    nbytes = _nbytes(layout)
    hg.streamed_bytes += nbytes
    return staged, nbytes, r


def _double_buffered(batches, ship, compute) -> tuple[int, int, int]:
    """Ship batch i+1 while batch i computes.  Returns ``(host_bytes,
    peak_stage_bytes, retries)`` with the reference's accounting: the peak
    is the in-flight pair (current + next), or the last batch alone."""
    host_bytes = peak = retr = 0
    if not batches:
        return 0, 0, 0
    cur, cur_nb, r = ship(batches[0])
    retr += r
    for i in range(len(batches)):
        host_bytes += cur_nb
        compute(i, cur.ready())
        if i + 1 < len(batches):
            nxt, nxt_nb, r = ship(batches[i + 1])
            retr += r
            peak = max(peak, cur_nb + nxt_nb)
            cur, cur_nb = nxt, nxt_nb
        else:
            peak = max(peak, cur_nb)
    return host_bytes, peak, retr


def _host_active(active: torch.Tensor) -> np.ndarray:
    return active.detach().cpu().numpy()


# --------------------------------------------------------------------------
# streaming executors
# --------------------------------------------------------------------------
def _stream_chunks(hg: HostGraph, store: HostChunkStore, x, active,
                   sr: Semiring, *, reverse: bool, y_init,
                   pol: ExecutionPolicy):
    """The scan/compact backends on a host store: numpy activity plan ->
    ascending live chunk ids -> ``stream_buffer``-sized batches, double
    buffered; each batch is one masked gather + scatter."""
    n, S = store.n, store.chunk_size
    C = store.num_chunks
    gather_on_major = (store.sorted_by == "src") != reverse
    has_w = store.w is not None
    xp = pad_state(x, sr)
    y = _pad_y_init(sr, xp, y_init, n)
    msgs = torch.zeros((), dtype=torch.int64, device=x.device)

    # numpy mirror of chunk_activity: frontier prefix sums over [lo, hi].
    cs = np.cumsum(_host_active(active).astype(np.int64))
    prefix = np.concatenate([np.zeros(1, np.int64), cs, cs[-1:]])
    per_chunk = prefix[store.hi + 1] - prefix[store.lo]
    live = np.flatnonzero(per_chunk > 0)

    B = int(pol.stream_buffer)
    # The reference's payload: major, minor (+ w) and one valid flag per
    # slot; padding slots repeat chunk 0 and are marked invalid.
    layout = [(np.int32, (B, S)), (np.int32, (B, S))]
    if has_w:
        layout.append((np.float32, (B, S)))
    layout.append((np.bool_, (B,)))

    def ship(ids):
        def fill(arrs):
            idx = np.zeros(B, np.int64)
            idx[:len(ids)] = ids
            np.take(store.major, idx, axis=0, out=arrs[0])
            np.take(store.minor, idx, axis=0, out=arrs[1])
            if has_w:
                np.take(store.w, idx, axis=0, out=arrs[2])
            arrs[-1][:] = False
            arrs[-1][:len(ids)] = True

        return _ship(hg, pol, layout, fill)

    def compute(_, staged):
        nonlocal y, msgs
        major, minor = staged.arrays[0], staged.arrays[1]
        w = staged.arrays[2].reshape(-1) if has_w else None
        valid = staged.arrays[-1][:, None].expand(B, S).reshape(-1)
        y, m = _fetch(sr, xp, active, n, gather_on_major, major.reshape(-1),
                      minor.reshape(-1), w, y, valid=valid)
        msgs = msgs + m

    batches = [live[i:i + B] for i in range(0, len(live), B)]
    host_bytes, peak, retr = _double_buffered(batches, ship, compute)
    hg._note_stage(peak)

    n_live = int(live.size)
    st = _stats(
        x.device,
        requests=int(per_chunk[live].sum()),
        records=n_live * S,
        chunks_skipped=C - n_live,
        messages=msgs,
        bytes_moved=n_live * S * _store_record_bytes(store.w),
        host_bytes=host_bytes,
        retries=retr,
    )
    return y[:n], st


def _tile_encoding(sr: Semiring, weighted: bool) -> str:
    """The session's encoding rule: boolean frontiers ride plus_times tiles
    unless real weights could corrupt the y>0 threshold."""
    if sr.name == "or_and":
        return "bool" if weighted else "plus_times"
    if sr.name == "min_plus":
        return "min_plus"
    return "plus_times"


def _host_select_blocked(hg: HostGraph, direction: str, reverse: bool):
    """(reverse view?, active_on, major_degree) — the host mirror of
    :func:`~repro_torch.core.engine._select_blocked`."""
    if direction == "out" and not reverse:
        return False, "src", hg.out_degree
    if direction == "out" and reverse:
        return True, "dst", hg.out_degree
    if direction == "in" and not reverse:
        if hg.in_degree is None:
            raise ResidencyError(
                "host graph has no in-edge view; pull ('in') blocked "
                "dispatch needs a graph built with its in-CSR"
            )
        return False, "dst", hg.in_degree
    raise NotImplementedError("blocked backend: direction='in' with reverse")


def _tile_batches(store: HostBlockedStore, live: np.ndarray, B: int):
    """Group the live schedule positions into batches that never split a
    run (rule 1) and give a block that flushed in an earlier batch at most
    one run per later batch (rule 2); a run longer than ``B`` becomes a
    batch of its own.  Returns ``(batches, run_id)``: each batch is
    ``(positions, blocks it flushes)``."""
    # live runs: consecutive live steps keyed on the ORIGINAL run id, as
    # compact_tile_order does, so runs that become adjacent when the tiles
    # between them go inactive are not merged.
    run_id = np.cumsum(store.first) - 1
    lr = run_id[live]
    starts = np.flatnonzero(np.concatenate([[True], lr[1:] != lr[:-1]]))
    ends = np.append(starts[1:], live.size)
    batches = []
    cur, cur_blocks, cur_count = [], set(), 0
    earlier: set = set()
    for s, e in zip(starts, ends):
        r = live[s:e]
        b = int(store.dbid[r[0]])
        split = cur and (
            cur_count + len(r) > B                   # buffer budget
            or (b in earlier and b in cur_blocks)    # rule 2
        )
        if split:
            batches.append((np.concatenate(cur), frozenset(cur_blocks)))
            earlier |= cur_blocks
            cur, cur_blocks, cur_count = [], set(), 0
        cur.append(r)
        cur_blocks.add(b)
        cur_count += len(r)
    batches.append((np.concatenate(cur), frozenset(cur_blocks)))
    return batches, run_id


def _stream_tiles(hg: HostGraph, x, active, sr: Semiring, *, direction: str,
                  reverse: bool, y_init, pol: ExecutionPolicy):
    """The blocked backends on a host tile store.

    Each batch ships the reference's compact-grid payload ``(tiles, perm,
    dbid, sbid, first, last, accum, nact)`` padded to a power of two ``G``,
    with batch-local run flags, and runs kernel B2 or B4 on it through a
    :class:`~repro_torch.kernels.spmv.TileBatch` view.  The host-side carry
    combines the batches: a block's first flush writes it, later ones add
    (or take the min), exactly the kernel's own flush sequence.
    """
    from ..kernels.spmv import TileBatch, spmv_blocked_compact, tile_byte_size

    use_rev, active_on, deg = _host_select_blocked(hg, direction, reverse)
    store = hg.blocked_store(_tile_encoding(sr, hg.weighted),
                             reverse=use_rev, tile_order=pol.tile_order)
    boolean = _check_blocked_semiring(sr, store.semiring, hg.weighted)

    n, bd, bs = hg.n, store.bd, store.bs
    nDB, nSB = store.n_dst_blocks, store.n_src_blocks
    dev = x.device
    xv = _blocked_pre_mask(store.semiring, active_on, active, x, boolean)
    squeeze = xv.ndim == 1
    if squeeze:
        xv = xv[:, None]
    k = xv.shape[1]
    minp = store.semiring == "min_plus"
    ident = float("inf") if minp else 0.0
    xp = torch.full((nSB * bs, k), ident, dtype=torch.float32, device=dev)
    xp[:n] = xv
    x_blocks = xp.view(nSB, bs, k)

    # numpy mirror of tile_activity.
    if active_on == "src":
        blk, nb_blocks, bid = bs, nSB, store.sbid
    else:
        blk, nb_blocks, bid = bd, nDB, store.dbid
    ap = np.zeros(nb_blocks * blk, bool)
    ap[:n] = _host_active(active)
    act_blk = ap.reshape(nb_blocks, blk).any(axis=1)
    live = np.flatnonzero(act_blk[bid])

    carry = torch.full((nDB, bd, k), ident, dtype=torch.float32, device=dev)
    host_bytes = peak = retr = 0
    if live.size:
        batches, run_id = _tile_batches(store, live, int(pol.stream_buffer))
        # per batch and block: 1 = first flush (write), 2 = later flush
        # (combine), 0 = untouched — one small copy per superstep.
        modes = np.zeros((len(batches), nDB), np.int8)
        flushed = np.zeros(nDB, bool)
        for i, (_, blocks) in enumerate(batches):
            bf = np.zeros(nDB, bool)
            bf[list(blocks)] = True
            modes[i][bf & ~flushed] = 1
            modes[i][bf & flushed] = 2
            flushed |= bf
        modes_t = torch.as_tensor(modes).to(dev)

        def ship(batch):
            pos = batch[0]
            kk = len(pos)
            G = _pow2_at_least(kk)
            layout = [(np.float32, (G, bd, bs))] + [(np.int32, (G,))] * 6 \
                + [(np.int32, (1,))]

            def fill(arrs):
                tiles, perm, dbid_b, sbid_b, first_b, last_b, accum_b, nact \
                    = arrs
                np.take(store.tiles, pos, axis=0, out=tiles[:kk])
                tiles[kk:] = 0
                # tail steps replay the last live step with every flag 0.
                perm[:kk] = np.arange(kk, dtype=np.int32)
                perm[kk:] = kk - 1
                db = store.dbid[pos]
                dbid_b[:kk] = db
                dbid_b[kk:] = db[-1]
                sbid_b[:kk] = store.sbid[pos]
                sbid_b[kk:] = sbid_b[kk - 1]
                rb = run_id[pos]
                brk = (rb[1:] != rb[:-1]).astype(np.int32)
                first_b[:] = 0
                first_b[0] = 1
                first_b[1:kk] = brk
                last_b[:] = 0
                last_b[:kk - 1] = brk
                last_b[kk - 1] = 1
                # batch-local accum: a run combines iff its block already
                # flushed earlier in THIS batch (the carry does the rest).
                rstarts = np.flatnonzero(first_b[:kk])
                rblk = db[rstarts]
                _, first_of = np.unique(rblk, return_index=True)
                acc_run = np.ones(len(rstarts), np.int32)
                acc_run[first_of] = 0
                accum_b[:] = 0
                accum_b[:kk] = acc_run[np.cumsum(first_b[:kk]) - 1]
                nact[0] = kk

            return _ship(hg, pol, layout, fill)

        def compute(i, staged):
            nonlocal carry
            tiles, perm, dbid_b, sbid_b, first_b, last_b, accum_b, _ = \
                staged.arrays
            view = TileBatch(tiles=tiles, sbid=sbid_b, n=n, bd=bd, bs=bs,
                             semiring=store.semiring)
            y_b = spmv_blocked_compact(view, perm, dbid_b, sbid_b, first_b,
                                       last_b, accum_b, len(batches[i][0]),
                                       x_blocks)
            mode = modes_t[i][:, None, None]
            both = torch.minimum(carry, y_b) if minp else carry + y_b
            carry = torch.where(mode == 1, y_b,
                                torch.where(mode == 2, both, carry))

        host_bytes, peak, retr = _double_buffered(batches, ship, compute)
    hg._note_stage(peak)

    y = carry.reshape(nDB * bd, k)[:n]
    if squeeze:
        y = y[:, 0]
    y = _blocked_post(sr, active_on, active, y, y_init, boolean, x.dtype)

    # ---- IOStats (numpy mirrors of the device formulas) ----
    fetched = int(live.size)
    tile_bytes = tile_byte_size(store)
    has_tiles = np.zeros(nb_blocks, bool)
    has_tiles[bid] = True
    per_block_cnt = ap.reshape(nb_blocks, blk).sum(axis=1, dtype=np.int64)
    sb_live = store.sbid[live]
    xf = 0 if fetched == 0 else \
        1 + int(np.count_nonzero(sb_live[1:] != sb_live[:-1]))
    st = _stats(
        dev,
        requests=int(per_block_cnt[has_tiles].sum()),
        records=fetched * (tile_bytes // EDGE_RECORD_BYTES),
        chunks_skipped=store.num_tiles - fetched,
        messages=frontier_edge_mass(deg, active),
        bytes_moved=fetched * tile_bytes,
        x_fetches=xf,
        host_bytes=host_bytes,
        retries=retr,
    )
    return y, st


def _host_p2p(hg: HostGraph, x, active, sr: Semiring, *, direction: str,
              y_init, ecap: int, pol: ExecutionPolicy):
    """Point-to-point on a host view: the row-exact gather plan is built in
    numpy and shipped as ``ecap`` lanes (the device path's gather shape);
    the device does the gather, mask and scatter of
    :func:`~repro_torch.core.sem.p2p_spmv`."""
    n = hg.n
    host = hg.host
    if direction == "out":
        indptr, indices, w = host.indptr, host.indices, host.weights
    else:
        if host.in_indptr is None:
            raise ResidencyError("host graph has no 'in' CSR view")
        indptr, indices, w = host.in_indptr, host.in_indices, host.in_weights
    if hg.m == 0:  # no edges, nothing to fetch
        y = sr.neutral_like(pad_state(x, sr), n) if y_init is None else y_init
        return y, IOStats.zero(x.device)
    xp = pad_state(x, sr)
    y0 = _pad_y_init(sr, xp, y_init, n)

    act_idx = np.flatnonzero(_host_active(active))
    deg = (indptr[act_idx + 1] - indptr[act_idx]).astype(np.int64)
    total = int(deg.sum())
    E = int(ecap)
    has_w = w is not None
    layout = [(np.int32, (E,)), (np.int32, (E,)), (np.bool_, (E,))]
    if has_w:
        layout.append((np.float32, (E,)))

    def fill(arrs):
        major, minor, valid = arrs[:3]
        major[:] = n
        minor[:] = n
        valid[:] = False
        if has_w:
            arrs[3][:] = 0
        t = min(total, E)  # the gate guarantees total <= ecap; mirror the
        if t:              # device's lane truncation if it ever doesn't
            offs = np.cumsum(deg)
            row_start = offs - deg
            p = np.arange(t, dtype=np.int64)
            kix = np.searchsorted(offs, p, side="right")
            e = indptr[act_idx[kix]].astype(np.int64) + (p - row_start[kix])
            major[:t] = np.repeat(act_idx.astype(np.int32), deg)[:t]
            minor[:t] = np.asarray(indices)[e]
            if has_w:
                arrs[3][:t] = np.asarray(w, np.float32)[e]
            valid[:t] = True

    staged, nb, retr = _ship(hg, pol, layout, fill)
    hg._note_stage(nb)
    major, minor, valid = staged.ready().arrays[:3]
    ew = staged.arrays[3] if has_w else None
    gather_idx = major if direction == "out" else minor
    key = minor if direction == "out" else major
    contrib = sr.edge_op(xp[gather_idx.long()], ew)
    v2 = valid.reshape((-1,) + (1,) * (contrib.ndim - 1))
    contrib = torch.where(v2, contrib, torch.tensor(
        sr.identity, dtype=contrib.dtype, device=contrib.device))
    key = torch.where(valid, key, n).long()
    y = sr.scatter(y0, key, contrib)[:n]

    st = _stats(
        x.device,
        requests=len(act_idx),
        records=total,
        messages=total,
        bytes_moved=total * _store_record_bytes(w),
        host_bytes=nb,
        retries=retr,
    )
    return y, st


# --------------------------------------------------------------------------
# dispatch + traverse (the engine's control flow)
# --------------------------------------------------------------------------
def _host_multicast(hg, x, active, sr, *, direction, reverse, y_init, pol):
    """Multicast arm: the host always streams exactly the live work-list,
    which gives the values and IOStats of both the device's dense and
    compact arms, so no density split is needed here."""
    if pol.backend in _BLOCKED:
        return _stream_tiles(hg, x, active, sr, direction=direction,
                             reverse=reverse, y_init=y_init, pol=pol)
    if pol.backend not in ("scan", "compact"):
        raise PolicyError(f"unknown backend {pol.backend!r}")
    store = hg.out_store if direction == "out" else hg.in_store
    if store is None:
        raise ResidencyError(f"host graph has no {direction!r} store")
    return _stream_chunks(hg, store, x, active, sr, reverse=reverse,
                          y_init=y_init, pol=pol)


def _host_dispatch(hg, x, active, sr, *, direction, reverse, y_init, pol):
    """The density three-way for one direction; the p2p gate is the
    device ``_dispatch``'s formula, so both residencies choose alike."""
    if pol.switch_fraction is None or reverse:
        return _host_multicast(hg, x, active, sr, direction=direction,
                               reverse=reverse, y_init=y_init, pol=pol)
    deg = hg.out_degree if direction == "out" else hg.in_degree
    if deg is None:  # no in view: let the multicast arm raise its error
        return _host_multicast(hg, x, active, sr, direction=direction,
                               reverse=reverse, y_init=y_init, pol=pol)
    vcap = pol.vcap if pol.vcap is not None else hg.n
    ecap = pol.ecap if pol.ecap is not None else max(int(hg.m), 1)
    act_edges = int(frontier_edge_mass(deg, active))
    n_act = int(active.sum())
    use_p2p = (act_edges <= int(pol.switch_fraction * hg.m)
               and act_edges <= ecap and n_act <= vcap)
    if use_p2p:
        return _host_p2p(hg, x, active, sr, direction=direction,
                         y_init=y_init, ecap=ecap, pol=pol)
    return _host_multicast(hg, x, active, sr, direction=direction,
                           reverse=reverse, y_init=y_init, pol=pol)


def _host_pull_available(hg: HostGraph, pol: ExecutionPolicy) -> bool:
    """Host mirror of ``engine._pull_available`` (the tile store is always
    buildable here: it needs only the out-CSR)."""
    if hg.in_degree is None:
        return False
    if pol.backend not in _BLOCKED and hg.in_store is None:
        return False
    if pol.switch_fraction is not None and hg.host.in_indptr is None:
        return False
    return True


def host_traverse(
    hg: HostGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    policy: Optional[ExecutionPolicy] = None,
    unexplored: Optional[torch.Tensor] = None,
    reverse: bool = False,
    y_init: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, IOStats]:
    """One streamed superstep on a host view — the ``residency='host'``
    execution of :func:`~repro_torch.core.engine.traverse`, with its
    dispatch structure and its values and IOStats (``host_bytes`` and
    ``retries`` aside)."""
    pol = policy if policy is not None else ExecutionPolicy(residency="host")
    if active.ndim > 1:
        # Query lanes: stream the union of the frontiers once, each lane's
        # x identity-masked by its own frontier.
        xm, union, un_union, mass = batched_union_frontier(
            hg, x, active, sr, unexplored=unexplored, reverse=reverse,
            direction=pol.direction,
        )
        y, st = host_traverse(hg, xm, union, sr, policy=pol,
                              unexplored=un_union, reverse=reverse,
                              y_init=y_init)
        return y, st._replace(messages=mass)
    if reverse or unexplored is None:
        direction = pol.direction if pol.direction in ("out", "in") else "out"
        return _host_dispatch(hg, x, active, sr, direction=direction,
                              reverse=reverse, y_init=y_init, pol=pol)

    mf = frontier_edge_mass(hg.out_degree, active)
    mode = pol.direction
    if mode != "out" and not _host_pull_available(hg, pol):
        if mode == "in":
            raise ResidencyError(
                "direction='in' needs the graph's pull views (in-store / "
                "in_degree; blocked backends also need the forward tile "
                "view) — build the graph with its in-CSR"
            )
        mode = "out"  # 'auto' without pull views: push is the only option
    if mode == "auto":
        use_pull = beamer_use_pull(
            mf,
            frontier_edge_mass(hg.out_degree, unexplored),
            active.sum(),
            hg.n,
            alpha=pol.alpha,
            beta=pol.beta,
        )
        mode = "in" if bool(use_pull) else "out"
    if mode == "out":
        y, st = _host_dispatch(hg, x, active, sr, direction="out",
                               reverse=False, y_init=y_init, pol=pol)
    else:
        mask = active.reshape((-1,) + (1,) * (x.ndim - 1))
        xm = torch.where(mask, x, torch.tensor(sr.identity, dtype=x.dtype,
                                               device=x.device))
        y, st = _host_dispatch(hg, xm, unexplored, sr, direction="in",
                               reverse=False, y_init=y_init, pol=pol)
    return y, st._replace(messages=mf)


# --------------------------------------------------------------------------
# the host BSP driver
# --------------------------------------------------------------------------
def run_program_host(
    sg,
    prog,
    policy: Optional[ExecutionPolicy] = None,
    *,
    seeds=None,
    max_supersteps: Optional[int] = None,
    checkpoint=None,
    resume: bool = False,
) -> ProgramResult:
    """:func:`~repro_torch.core.program.run_program` on a host view: the
    same superstep loop, each superstep streaming its live edges.  Values,
    supersteps and IOStats (``host_bytes`` and ``retries`` aside) equal the
    device residency's."""
    if checkpoint is not None or resume:
        raise NotImplementedError("checkpointed runs: ROADMAP A12")
    pol = policy if policy is not None else prog.default_policy
    pol = pol if pol is not None else ExecutionPolicy()
    check_residency(sg, pol.with_(residency="host"))  # a host view ...
    check_residency(sg, pol)  # ... under a host policy
    return bsp_loop(sg, prog, prog.prepare_policy(sg, pol), seeds=seeds,
                    max_supersteps=max_supersteps)
