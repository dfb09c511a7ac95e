"""Louvain modularity — a numpy copy of ``repro.algs.louvain`` (paper §4.6).

Principle P6b — *avoid graph structure modification*.

The classic two-phase Louvain alternates (1) greedy local moves and
(2) *aggregation*: collapsing communities into super-vertices.  Phase 2
traditionally **rewrites the graph** — ruinous in SEM, where edge data lives
on slow storage (the paper shows even a RAMDisk materialization loses 2x).

Graphyti's design, reproduced here:
  * a ``comm[n]`` indirection vector (vertex -> community representative),
  * lazy deletion via an ``alive`` bitmap,
  * all later levels aggregate through the indirection — every edge (u, v)
    contributes to (comm*[u], comm*[v]) where comm* is the transitive
    mapping — so the original edge store is immutable.

``louvain(..., materialize=True)`` is the traditional path: it physically
rebuilds the edge arrays at each level (we count the bytes written, the
paper's Fig. 8b "best case" RAMDisk cost); ``materialize=False`` is the
Graphyti path (no writes; extra per-edge gather = the messaging/metadata
overhead that grows at deeper levels, Fig. 8a).

Everything runs on the host (numpy), as in the reference: FlashGraph's
per-vertex `run()` is host C++ as well.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..graph.csr import Graph

__all__ = ["LouvainResult", "louvain", "modularity"]


@dataclasses.dataclass
class LouvainResult:
    comm: np.ndarray  # final community of every original vertex
    modularity: float
    levels: int
    bytes_written: int  # edge bytes rewritten (materialize path only)
    gather_ops: int  # per-edge indirection gathers (Graphyti path overhead)
    level_times: list


def modularity(src, dst, w, comm, two_m: float) -> float:
    """Q = (1/2m) * sum_c (in_c/2m - (tot_c/2m)^2) for an undirected edge
    list that contains both directions of every edge."""
    return _modularity_edges(src, dst, w, comm, two_m)


def _local_moves(src, dst, w, comm, two_m, max_sweeps=10):
    """Greedy sequential sweeps (classic Louvain phase 1). Returns comm."""
    n = len(comm)
    deg = np.zeros(n)
    np.add.at(deg, src, w)
    tot = np.zeros(n)
    np.add.at(tot, comm, deg)
    # CSR-ish view for the sweep
    order = np.argsort(src, kind="stable")
    s_s, s_d, s_w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s_s, minlength=n), out=indptr[1:])
    improved_any = False
    for _ in range(max_sweeps):
        moved = 0
        for u in range(n):
            beg, end = indptr[u], indptr[u + 1]
            if beg == end:
                continue
            cu = comm[u]
            nbr_c = comm[s_d[beg:end]]
            nbr_w = s_w[beg:end]
            # weights to each neighboring community
            cands, inv = np.unique(nbr_c, return_inverse=True)
            wc = np.zeros(len(cands))
            np.add.at(wc, inv, nbr_w)
            tot[cu] -= deg[u]
            k_in_cu = wc[cands == cu].sum()
            # gain of moving u into community c
            gain = wc - deg[u] * tot[cands] / two_m
            gain_stay = k_in_cu - deg[u] * tot[cu] / two_m
            best = int(np.argmax(gain))
            if gain[best] > gain_stay + 1e-12 and cands[best] != cu:
                comm[u] = cands[best]
                moved += 1
            tot[comm[u]] += deg[u]
        improved_any |= moved > 0
        if moved == 0:
            break
    return comm, improved_any


def louvain(
    g: Graph,
    *,
    materialize: bool,
    max_levels: int = 10,
    max_sweeps: int = 10,
) -> LouvainResult:
    """Two-phase Louvain on an undirected (symmetrized) graph.

    materialize=True : physically rebuild the community graph per level
                       (traditional; counts bytes_written).
    materialize=False: Graphyti path — immutable edges + comm indirection
                       (counts gather_ops instead).
    """
    src0, dst0 = g.edges()
    w0 = g.weights if g.weights is not None else np.ones(g.m, np.float32)
    w0 = w0.astype(np.float64)
    two_m = float(w0.sum())  # both directions counted

    n = g.n
    # comm_orig: original vertex -> current community label (indirection).
    comm_orig = np.arange(n, dtype=np.int64)
    bytes_written = 0
    gather_ops = 0
    level_times = []

    # Level-local edge view (materialize path replaces these per level).
    src, dst, w = src0.astype(np.int64), dst0.astype(np.int64), w0
    nn = n  # level vertex count (NOT derivable from edges: isolated
    #         super-vertices have no edges but still own a community label)

    levels = 0
    for _ in range(max_levels):
        t0 = time.perf_counter()
        if not materialize and levels > 0:
            # Graphyti path: aggregate THROUGH the indirection each level —
            # two gathers per original edge (comm of each endpoint).
            src_l = comm_orig[src0]
            dst_l = comm_orig[dst0]
            gather_ops += 2 * len(src0)
            src, dst, w = _compress(src_l, dst_l, w0)
            nn = int(comm_orig.max()) + 1
        comm = np.arange(nn, dtype=np.int64)
        comm, improved = _local_moves(src, dst, w, comm, two_m, max_sweeps)
        levels += 1
        if not improved:
            level_times.append(time.perf_counter() - t0)
            break
        # Relabel communities densely.
        uniq, comm_dense = np.unique(comm, return_inverse=True)
        if materialize:
            comm_orig = comm_dense[comm_orig]
            # Physically rebuild the level graph (the expensive write).
            src, dst, w = _compress(comm_dense[src], comm_dense[dst], w)
            bytes_written += (src.nbytes + dst.nbytes + w.nbytes)
            nn = len(uniq)
        else:
            # Update only the O(n) indirection vector; edges untouched.
            comm_orig = comm_dense[comm_orig]
        level_times.append(time.perf_counter() - t0)
        if len(uniq) == nn:  # nothing merged
            break

    q = _modularity_edges(src0, dst0, w0, comm_orig, two_m)
    return LouvainResult(
        comm=comm_orig,
        modularity=q,
        levels=levels,
        bytes_written=int(bytes_written),
        gather_ops=int(gather_ops),
        level_times=level_times,
    )


def _compress(src, dst, w):
    """Aggregate parallel edges (community multigraph -> weighted graph)."""
    nn = int(max(src.max(initial=0), dst.max(initial=0)) + 1)
    key = src * nn + dst
    uniq, inv = np.unique(key, return_inverse=True)
    ws = np.zeros(len(uniq))
    np.add.at(ws, inv, w)
    return (uniq // nn).astype(np.int64), (uniq % nn).astype(np.int64), ws


def _modularity_edges(src, dst, w, comm, two_m) -> float:
    internal = float(np.sum(w[comm[src] == comm[dst]]))
    deg = np.zeros(len(comm))
    np.add.at(deg, src, w)
    tot = np.zeros(int(comm.max()) + 1)
    np.add.at(tot, comm, deg)
    return internal / two_m - float(np.sum((tot / two_m) ** 2))
