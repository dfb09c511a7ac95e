"""Semi-external-memory edge store: blocked, streamable, skippable (torch
port of ``repro.core.sem``).

O(n) dense vertex state and O(m) edge records in fixed-size *chunks*
sorted by a major vertex, streamed with **chunk-activity skipping**: a chunk
is fetched only if the frontier intersects its contiguous major-vertex
range.  Every fetch/skip decision is counted in :class:`IOStats`, with the
reference's units and its int32 wrap contract.

The reference walks the chunks with a ``lax.scan`` and a per-chunk
``lax.cond``.  Here :func:`sem_spmv` is one masked gather and one scatter
over every edge record: an inactive chunk holds no active major vertex, so
its records are masked out exactly as the skipped fetch would have left
them, and the counters are computed from the chunk-activity vector.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..graph.csr import Graph
from .semiring import Semiring

__all__ = [
    "EDGE_RECORD_BYTES",
    "IOStats",
    "EdgeChunkStore",
    "SemGraph",
    "bucket_index",
    "build_store",
    "build_store_arrays",
    "chunk_activity",
    "compact_spmv",
    "device_graph",
    "frontier_edge_mass",
    "i32",
    "pad_state",
    "pow2_buckets",
    "sem_spmv",
    "p2p_spmv",
]

# One edge record = (major:int32, minor:int32). Weighted stores add 4 bytes.
EDGE_RECORD_BYTES = 8


def _store_record_bytes(w) -> int:
    """Bytes per edge record: 8 for the (major, minor) int32 pair, +4 when
    a float32 weight rides along."""
    return EDGE_RECORD_BYTES + (4 if w is not None else 0)


def i32(value) -> torch.Tensor:
    """An integer tensor (or int) as an int32 counter, wrapping mod 2^32.

    The reference's counters are JAX int32 and wrap on overflow; torch sums
    integers in int64, so every counter is computed wide and narrowed here,
    which keeps the low 32 bits exactly as the int32 arithmetic would."""
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(int(value), dtype=torch.int64)
    return value.to(torch.int64).to(torch.int32)


class IOStats(NamedTuple):
    """I/O accounting: the reference's ten int32 counters (see
    ``repro.core.sem.IOStats`` for each field's meaning).

    ``x_fetches`` is the one schedule-sensitive field (it moves with
    ``tile_order``); ``host_bytes`` and ``retries`` stay 0 on the
    device-resident paths of this package; ``queries`` is a batch-width
    label, 0 on every run of :func:`repro_torch.core.run_program`.  All
    counters wrap at 2^31 of their unit, as in the reference.
    """

    requests: torch.Tensor
    records: torch.Tensor
    chunks_skipped: torch.Tensor
    messages: torch.Tensor
    supersteps: torch.Tensor
    bytes_moved: torch.Tensor
    x_fetches: torch.Tensor
    host_bytes: torch.Tensor
    retries: torch.Tensor
    queries: torch.Tensor

    @staticmethod
    def zero(device=None) -> "IOStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return IOStats(*([z] * 10))

    def __add__(self, other: "IOStats") -> "IOStats":  # type: ignore[override]
        return IOStats(*(i32(a.to(torch.int64) + b.to(torch.int64))
                         for a, b in zip(self, other)))


def _stats(device, **fields) -> IOStats:
    """An IOStats with the named counters (int32-wrapped) and zeros elsewhere."""
    z = IOStats.zero(device)
    return z._replace(**{k: i32(v).to(device) for k, v in fields.items()})


@dataclasses.dataclass(frozen=True)
class EdgeChunkStore:
    """Fixed-size edge chunks sorted by a major vertex.

    major/minor: int32[C, S] (padding holds the sentinel ``n``); w: optional
    float32[C, S]; lo/hi: int32[C] inclusive major-vertex range per chunk
    (``lo == hi == n`` for all-padding chunks).
    """

    major: torch.Tensor
    minor: torch.Tensor
    w: Optional[torch.Tensor]
    lo: torch.Tensor
    hi: torch.Tensor
    n: int
    chunk_size: int
    sorted_by: str

    @property
    def num_chunks(self) -> int:
        return int(self.major.shape[0])


@dataclasses.dataclass(frozen=True)
class SemGraph:
    """Device-resident SEM view of a graph (fields as in the reference).

    ``indptr``/``in_indptr`` are padded to length n+2 so the sentinel vertex
    ``n`` has a valid empty row.  ``out_blocked``/``out_blocked_rev`` are the
    optional dense-tile views of the blocked backends
    (:class:`repro_torch.kernels.spmv.BlockedGraph`).
    """

    out_store: Optional[EdgeChunkStore]
    in_store: Optional[EdgeChunkStore]
    indptr: torch.Tensor
    indices: torch.Tensor
    w: Optional[torch.Tensor]
    in_indptr: Optional[torch.Tensor]
    in_indices: Optional[torch.Tensor]
    in_w: Optional[torch.Tensor]
    out_degree: torch.Tensor
    in_degree: Optional[torch.Tensor]
    n: int
    m: int
    out_blocked: Optional[object] = None
    out_blocked_rev: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.indptr.device


def build_store_arrays(
    g: Graph, *, sorted_by: str, chunk_size: int = 4096
) -> dict:
    """Chop a CSR/CSC view into fixed-size streamable chunks, as plain host
    arrays (a copy of the reference's chopper, byte-identical output)."""
    if sorted_by not in ("src", "dst"):
        raise ValueError(f"sorted_by must be 'src' or 'dst', got {sorted_by!r}")
    if sorted_by == "src":
        indptr, minor, w = g.indptr, g.indices, g.weights
    else:
        if g.in_indptr is None:
            raise ValueError("graph lacks the in-edge view needed for a pull store")
        indptr, minor, w = g.in_indptr, g.in_indices, g.in_weights
    n, m = g.n, int(minor.shape[0])
    major = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))

    num_chunks = max(1, -(-m // chunk_size))
    pad = num_chunks * chunk_size - m
    majp = np.concatenate([major, np.full(pad, n, np.int32)]).reshape(
        num_chunks, chunk_size
    )
    minp = np.concatenate([minor.astype(np.int32), np.full(pad, n, np.int32)]).reshape(
        num_chunks, chunk_size
    )
    wp = None
    if w is not None:
        wp = np.concatenate([np.asarray(w, np.float32), np.zeros(pad, np.float32)]
                            ).reshape(num_chunks, chunk_size)
    valid = majp < n
    any_valid = valid.any(axis=1)
    lo = np.where(any_valid, majp.min(axis=1, where=valid, initial=n), n)
    hi = np.where(any_valid, majp.max(axis=1, where=valid, initial=-1), n)
    return dict(
        major=majp,
        minor=minp,
        w=wp,
        lo=lo.astype(np.int32),
        hi=hi.astype(np.int32),
        n=n,
        chunk_size=chunk_size,
        sorted_by=sorted_by,
    )


def _t(a, device) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(np.asarray(a)).to(device)


def build_store(
    g: Graph, *, sorted_by: str, chunk_size: int = 4096, device=None
) -> EdgeChunkStore:
    """Chop a CSR/CSC view into chunks and place them on ``device`` (None:
    the CUDA device)."""
    device = resolve_device(device)
    a = build_store_arrays(g, sorted_by=sorted_by, chunk_size=chunk_size)
    return EdgeChunkStore(
        major=_t(a["major"], device),
        minor=_t(a["minor"], device),
        w=_t(a["w"], device),
        lo=_t(a["lo"], device),
        hi=_t(a["hi"], device),
        n=a["n"],
        chunk_size=a["chunk_size"],
        sorted_by=a["sorted_by"],
    )


def _pad_indptr(ip: np.ndarray) -> np.ndarray:
    return np.concatenate([ip, ip[-1:]]).astype(np.int32)


def device_graph(
    g: Graph,
    *,
    device=None,
    chunk_size: int = 4096,
    pull: bool = True,
    push: bool = True,
    blocked: bool = False,
    blocked_reverse: bool = False,
    bd: int = 128,
    bs: int = 128,
    blocked_semiring: str = "plus_times",
    tile_order: str = "dest",
) -> SemGraph:
    """Build the full device-resident SEM view of ``g`` on ``device`` (None:
    the CUDA device; other arguments as in the reference's
    ``device_graph``)."""
    device = resolve_device(device)
    out_blocked = out_blocked_rev = None
    if blocked:
        from ..kernels.spmv import build_blocked

        out_blocked = build_blocked(
            g, bd=bd, bs=bs, direction="out", semiring=blocked_semiring,
            tile_order=tile_order, device=device,
        )
        if blocked_reverse:
            out_blocked_rev = build_blocked(
                g, bd=bd, bs=bs, direction="out", semiring=blocked_semiring,
                reverse=True, tile_order=tile_order, device=device,
            )

    has_in = g.in_indptr is not None
    return SemGraph(
        out_store=build_store(g, sorted_by="src", chunk_size=chunk_size,
                              device=device) if push else None,
        in_store=build_store(g, sorted_by="dst", chunk_size=chunk_size,
                             device=device) if (pull and has_in) else None,
        indptr=_t(_pad_indptr(g.indptr), device),
        indices=_t(g.indices, device),
        w=_t(g.weights, device),
        in_indptr=_t(_pad_indptr(g.in_indptr), device) if has_in else None,
        in_indices=_t(g.in_indices, device) if has_in else None,
        in_w=_t(g.in_weights, device) if has_in else None,
        out_degree=_t(g.out_degree, device),
        in_degree=_t(g.in_degree, device) if has_in else None,
        n=g.n,
        m=g.m,
        out_blocked=out_blocked,
        out_blocked_rev=out_blocked_rev,
    )


def pad_state(x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Append the sentinel row ``n`` holding the semiring identity."""
    return torch.cat([x, sr.neutral_like(x, 1)], dim=0)


def _active_prefix(active: torch.Tensor) -> torch.Tensor:
    """prefix[i] = #active in [0, i); length n+2 so sentinel hi=n is safe."""
    c = torch.cumsum(active.to(torch.int64), 0)
    z = torch.zeros(1, dtype=torch.int64, device=active.device)
    return torch.cat([z, c, c[-1:]])


def _chunk_counts(store: EdgeChunkStore, active: torch.Tensor) -> torch.Tensor:
    """int64[C]: active major vertices in each chunk's [lo, hi] range."""
    prefix = _active_prefix(active)
    return prefix[store.hi.long() + 1] - prefix[store.lo.long()]


def chunk_activity(store: EdgeChunkStore, active: torch.Tensor) -> torch.Tensor:
    """bool[C]: which chunks the frontier would fetch (activity is over the
    store's *major* vertex, on push and pull stores alike)."""
    return _chunk_counts(store, active) > 0


def frontier_edge_mass(degree: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """int32 scalar: total degree over the active set (summed over every
    live (vertex, lane) pair when ``active`` carries query lanes)."""
    deg = degree.reshape(tuple(degree.shape) + (1,) * (active.ndim - degree.ndim))
    return i32(torch.where(active, deg.to(torch.int64), 0).sum())


def pow2_buckets(cap: int) -> tuple:
    """(1, 2, 4, ..., cap): the work-list capacities."""
    out, c = [], 1
    while c < cap:
        out.append(c)
        c *= 2
    out.append(int(max(1, cap)))
    return tuple(out)


def bucket_index(count, buckets: tuple) -> int:
    """Index of the smallest bucket >= ``count``."""
    return sum(int(count) > b for b in buckets[:-1])


def _fetch(sr, xp, active, n, gather_on_major, major, minor, w, y,
           valid=None):
    """The SEM hot loop over a batch of edge records: gather, mask,
    scatter-combine.  ``valid`` (bool per record) additionally masks
    records out, as host residency does with its padding chunks.  Returns
    ``(y, messages)``."""
    gather_idx = major if gather_on_major else minor
    key = minor if gather_on_major else major
    xv = xp[gather_idx.long()]
    mask = active[torch.clamp(major, max=n - 1).long()] & (major < n)
    if valid is not None:
        mask = mask & valid
    contrib = sr.edge_op(xv, w)
    m2 = mask.reshape((-1,) + (1,) * (contrib.ndim - 1))
    ident = torch.tensor(sr.identity, dtype=contrib.dtype, device=contrib.device)
    contrib = torch.where(m2, contrib, ident)
    key = torch.where(mask, key, n).long()  # sentinel row for masked lanes
    return sr.scatter(y, key, contrib), mask.sum()


def _pad_y_init(sr, xp, y_init, n):
    if y_init is None:
        return sr.neutral_like(xp, n + 1)
    return torch.cat([y_init, sr.neutral_like(y_init, 1)], dim=0)


def sem_spmv(
    store: EdgeChunkStore,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    y_init: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
) -> tuple[torch.Tensor, IOStats]:
    """Streamed, chunk-skipping semiring SpMV — the SEM hot loop.

    Over every edge whose **major** endpoint is active,
    ``y[key] = combine(y[key], edge_op(x[gather], w))`` (push store:
    gather=src=major, key=dst=minor; pull store: the reverse).
    ``reverse=True`` swaps gather and key, keeping the activity mask on the
    major vertex.  Returns ``(y[n, ...], IOStats)``.
    """
    n = store.n
    xp = pad_state(x, sr)
    y0 = _pad_y_init(sr, xp, y_init, n)
    gather_on_major = (store.sorted_by == "src") != reverse
    counts = _chunk_counts(store, active)
    act_chunk = counts > 0
    n_act_chunks = act_chunk.sum()
    y, msgs = _fetch(sr, xp, active, n, gather_on_major,
                     store.major.reshape(-1), store.minor.reshape(-1),
                     None if store.w is None else store.w.reshape(-1), y0)
    st = _stats(
        x.device,
        requests=counts[act_chunk].sum(),
        records=n_act_chunks * store.chunk_size,
        chunks_skipped=store.num_chunks - n_act_chunks,
        messages=msgs,
        bytes_moved=n_act_chunks * store.chunk_size
        * _store_record_bytes(store.w),
    )
    return y[:n], st


def compact_spmv(
    store: EdgeChunkStore,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    y_init: Optional[torch.Tensor] = None,
    *,
    chunk_cap: int,
    reverse: bool = False,
    assume_fits: bool = False,
) -> tuple[torch.Tensor, IOStats]:
    """Frontier-compacted SpMV: gathers only the live chunks' records.

    The live chunk ids come from ``nonzero`` of the activity vector (one
    device-to-host sync for the count).  When the count overflows
    ``chunk_cap`` the call falls back to :func:`sem_spmv`;
    ``assume_fits=True`` skips that test for callers that already proved
    the fit.  Values and IOStats equal :func:`sem_spmv`'s.
    """
    n = store.n
    C = store.num_chunks
    cap = max(1, min(int(chunk_cap), C))
    counts = _chunk_counts(store, active)
    act_chunk = counts > 0
    ids = torch.nonzero(act_chunk).flatten()
    n_act_chunks = int(ids.numel())
    if not assume_fits and n_act_chunks > cap:
        return sem_spmv(store, x, active, sr, y_init, reverse=reverse)
    ids = ids[:cap]
    xp = pad_state(x, sr)
    y0 = _pad_y_init(sr, xp, y_init, n)
    gather_on_major = (store.sorted_by == "src") != reverse
    y, msgs = _fetch(sr, xp, active, n, gather_on_major,
                     store.major[ids].reshape(-1), store.minor[ids].reshape(-1),
                     None if store.w is None else store.w[ids].reshape(-1), y0)
    st = _stats(
        x.device,
        requests=counts[act_chunk].sum(),
        records=n_act_chunks * store.chunk_size,
        chunks_skipped=C - n_act_chunks,
        messages=msgs,
        bytes_moved=n_act_chunks * store.chunk_size
        * _store_record_bytes(store.w),
    )
    return y[:n], st


def p2p_spmv(
    sg: SemGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    direction: str = "out",
    vcap: int,
    ecap: int,
    y_init: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, IOStats]:
    """Point-to-point path: fetch exactly the adjacency rows of the first
    ``vcap`` active vertices, at most ``ecap`` edge slots (one request per
    row, no chunk over-fetch).  Active rows are the *major* side: out-rows
    push to dst, in-rows pull from src onto the active dst."""
    n = sg.n
    dev = x.device
    if direction == "out":
        indptr, indices, w = sg.indptr, sg.indices, sg.w
    else:
        indptr, indices, w = sg.in_indptr, sg.in_indices, sg.in_w
    if sg.m == 0:  # no edges, nothing to fetch
        y = sr.neutral_like(pad_state(x, sr), n) if y_init is None else y_init
        return y, IOStats.zero(dev)
    xp = pad_state(x, sr)
    y0 = _pad_y_init(sr, xp, y_init, n)

    ids = torch.nonzero(active).flatten()[:vcap]
    act_idx = torch.full((vcap,), n, dtype=torch.int64, device=dev)
    act_idx[: ids.numel()] = ids
    num_act = min(int(ids.numel()), vcap)
    ip = indptr.long()
    deg = ip[act_idx + 1] - ip[act_idx]
    offs = torch.cumsum(deg, 0)
    starts = offs - deg
    total_edges = offs[-1] if vcap > 0 else torch.zeros((), dtype=torch.int64,
                                                        device=dev)

    p = torch.arange(ecap, dtype=torch.int64, device=dev)
    k = torch.searchsorted(offs, p, right=True)
    kc = torch.clamp(k, max=vcap - 1)
    valid = (p < total_edges) & (k < vcap)
    major = torch.where(valid, act_idx[kc], n)
    e = torch.where(valid, ip[torch.clamp(major, max=n)] + (p - starts[kc]), 0)
    e = torch.clamp(e, max=sg.m - 1)
    minor = torch.where(valid, indices[e].long(), n)
    ew = None
    if w is not None:
        ew = torch.where(valid, w[e], 0.0)

    gather_idx = major if direction == "out" else minor
    key = minor if direction == "out" else major
    contrib = sr.edge_op(xp[gather_idx], ew)
    v2 = valid.reshape((-1,) + (1,) * (contrib.ndim - 1))
    ident = torch.tensor(sr.identity, dtype=contrib.dtype, device=dev)
    contrib = torch.where(v2, contrib, ident)
    key = torch.where(valid, key, n)
    y = sr.scatter(y0, key, contrib)
    st = _stats(
        dev,
        requests=num_act,
        records=total_edges,
        messages=total_edges,
        bytes_moved=total_edges * _store_record_bytes(w),
    )
    return y[:n], st
