"""Triangle counting — torch port of ``repro.algs.triangles``.

The host variants (a numpy copy of the reference's ladder) differ only in
the in-memory intersection of two adjacency lists:

  * ``scan``        — linear merge of two sorted lists (baseline);
  * ``binary``      — binary search of each element of the smaller list;
  * ``restarted``   — binary search restarted from the previous hit;
  * ``hash``        — lists longer than a threshold probed as hash sets;
  * ``ordered``     — any of them after orienting edges from lower- to
                      higher-degree endpoints (each triangle found once).

All count comparisons and adjacency-row requests.  The dense tile form
(:func:`triangles_blocked_mxu`) computes ``sum(A * (A @ A)) / 6`` over
0/1 f32 tiles with ``torch.matmul`` on the device, with the reference's
f32 arithmetic (no TF32; the total summed in f32 in the reference's tile
order, so above 2^24 it rounds as the reference's does).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..graph.csr import Graph

__all__ = ["TriangleResult", "count_triangles", "triangles_blocked_mxu"]


@dataclasses.dataclass
class TriangleResult:
    triangles: int
    comparisons: int  # in-memory comparison ops (the Fig. 7 x-axis proxy)
    row_requests: int  # adjacency rows fetched (SEM I/O requests)
    records: int  # adjacency entries fetched


def _orient(g: Graph) -> tuple[np.ndarray, list[np.ndarray]]:
    """Orient each undirected edge from lower to higher (degree, id) rank.

    Returns (rank, oriented adjacency lists), where adj[u] holds only
    neighbors w with rank[w] > rank[u], sorted by rank.  Every triangle
    {a,b,c} survives as exactly one directed wedge, and the heavy vertices
    sit at the top of the order — fewer fetches of low-degree rows.
    """
    deg = g.out_degree.astype(np.int64)
    rank = np.lexsort((np.arange(g.n), deg))  # position -> vertex
    pos = np.empty(g.n, np.int64)
    pos[rank] = np.arange(g.n)
    # Adjacency in *position space*, so list elements and list indices share
    # one key space and sorted-merge/binary-search compare like with like.
    adj = [None] * g.n
    for u in range(g.n):
        nbrs = g.indices[g.indptr[u] : g.indptr[u + 1]]
        pu = pos[u]
        keep = pos[nbrs]
        adj[pu] = np.sort(keep[keep > pu])
    return pos, adj


def _merge_count(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """Sorted-merge intersection size + comparison count."""
    i = j = hits = comps = 0
    la, lb = len(a), len(b)
    while i < la and j < lb:
        comps += 1
        if a[i] == b[j]:
            hits += 1
            i += 1
            j += 1
        elif a[i] < b[j]:
            i += 1
        else:
            j += 1
    return hits, comps


def _binary_count(small: np.ndarray, big: np.ndarray, restarted: bool) -> tuple[int, int]:
    """Binary-search each element of ``small`` in ``big``.

    ``restarted`` resumes each search from the previous hit's right
    endpoint — sorted queries never re-scan the prefix already passed.
    """
    hits = comps = 0
    lo = 0
    for x in small:
        l, r = (lo, len(big)) if restarted else (0, len(big))
        while l < r:
            comps += 1
            mid = (l + r) // 2
            if big[mid] < x:
                l = mid + 1
            else:
                r = mid
        if l < len(big) and big[l] == x:
            hits += 1
            comps += 1
            if restarted:
                lo = l + 1
        elif restarted:
            lo = l
    return hits, comps


def count_triangles(
    g: Graph,
    *,
    variant: str = "restarted",
    ordered: bool = True,
    hash_threshold: int = 0,
    policy=None,
    device=None,
) -> TriangleResult:
    """Count triangles of an undirected (symmetrized) graph on the host.

    ``hash_threshold > 0`` enables the paper's hash-table optimization: a
    list longer than the threshold is probed as a hash set (O(1) per
    element, one "comparison" per probe) instead of searched — the
    high-degree-vertex fast path of §4.5.

    ``policy`` (an engine :class:`~repro_torch.core.ExecutionPolicy`)
    selects the execution the same way it does for the SpMV algorithms: a
    blocked backend routes to :func:`triangles_blocked_mxu` on ``device``
    (the dense tile path, which has no comparison/request ledger — those
    fields come back 0); anything else runs this host path.
    """
    if policy is not None and policy.backend in ("blocked", "blocked_compact"):
        return TriangleResult(triangles_blocked_mxu(g, device=device), 0, 0,
                              0)
    assert variant in ("scan", "binary", "restarted", "hash")
    if ordered:
        _, adj = _orient(g)
    else:
        adj = [
            np.sort(g.indices[g.indptr[u] : g.indptr[u + 1]]) for u in range(g.n)
        ]
    hash_sets = {}
    if variant == "hash":
        thresh = hash_threshold or 32
        hash_sets = {
            u: set(adj[u].tolist())
            for u in range(g.n)
            if len(adj[u]) > thresh
        }
    tri = comps = reqs = recs = 0
    for u in range(g.n):
        au = adj[u]
        if len(au) < (1 if ordered else 2):
            continue
        for w in au:
            aw = adj[w]
            reqs += 1
            recs += len(aw)
            if not ordered:
                # unordered double-counts every direction; filter w > u and
                # count common neighbors v > w to keep each triangle once
                if w <= u:
                    continue
            if variant == "scan":
                h, c = _merge_count(au, aw)
            elif variant == "hash" and (
                u in hash_sets or w in hash_sets
            ):
                # probe the smaller list against the bigger hash set
                big_u = len(au) >= len(aw)
                table = hash_sets.get(u if big_u else w)
                small = aw if big_u else au
                if table is None:  # the bigger side wasn't tabled
                    table = hash_sets[w if big_u else u]
                    small = au if big_u else aw
                h = sum(1 for x in small if x in table)
                c = len(small)
            else:
                small, big = (au, aw) if len(au) <= len(aw) else (aw, au)
                h, c = _binary_count(
                    small, big, restarted=(variant in ("restarted", "hash"))
                )
            tri += h
            comps += c
    if not ordered:
        tri //= 3  # each triangle found from each of its 3 lowest vertices
    return TriangleResult(int(tri), int(comps), int(reqs), int(recs))


def _dense_blocks(g: Graph, block: int, device) -> torch.Tensor:
    """The adjacency as a dense 0/1 f32 matrix padded to whole
    ``block``-sized tiles, on ``device``."""
    nb = -(-g.n // block)
    a = torch.zeros((nb * block, nb * block), dtype=torch.float32,
                    device=device)
    src, dst = g.edges()
    a[torch.as_tensor(src, dtype=torch.long, device=device),
      torch.as_tensor(dst, dtype=torch.long, device=device)] = 1.0
    return a


def triangles_blocked_mxu(g: Graph, *, block: int = 256, device=None) -> int:
    """Dense tile triangle count: ``sum(A * (A @ A)) / 6`` for a symmetric
    0/1 adjacency with zero diagonal.

    For each tile row i, ``A[i] @ A`` gives every tile C_ij of the tile
    row (f32, TF32 off: sums of 0/1 products, exact below 2^24), and
    ``sum(A_ij * C_ij)`` each tile's term.  As in the reference, the terms
    are added into an f32 total one tile at a time in (i, j) order and
    ``total / 6`` is rounded.  O(n^3) operations; ``device`` (None: the
    CUDA device) holds the dense matrix.
    """
    a = _dense_blocks(g, block, resolve_device(device))
    nb = a.shape[0] // block
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        terms = []
        for i in range(nb):
            rows = a[i * block:(i + 1) * block]
            c = torch.matmul(rows, a)  # C_ij for every j, [block, n]
            terms.append((rows * c).view(block, nb, block).sum(dim=(0, 2)))
        terms = torch.cat(terms).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    total = np.float32(0.0)
    for t in terms:  # the reference's scan: one f32 add a tile
        total = np.float32(total + t)
    return int(round(float(total / np.float32(6.0))))
