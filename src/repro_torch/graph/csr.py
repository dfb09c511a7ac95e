"""Compressed sparse row/column graph containers.

Host-side (numpy) graph construction, a copy of ``repro.graph.csr`` kept
in the port so that ``repro_torch`` never imports the JAX package.  The
SEM engine (``repro_torch.core.sem``) consumes these to build its blocked external-memory edge stores; everything
here is plain numpy so that graph ingest never touches the accelerator —
exactly FlashGraph's split between the (host) graph image and the (device)
compute engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Graph", "from_edges", "reverse", "degree_order"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """An immutable directed graph in CSR form (out-edges).

    ``indptr``/``indices`` encode out-adjacency;  ``in_indptr``/``in_indices``
    encode in-adjacency (the transpose / CSC view) and are built lazily by
    :func:`from_edges` because pull-mode algorithms need them.

    Attributes:
      n: number of vertices.
      indptr: int64[n+1] CSR row pointers (out-edges).
      indices: int32[m] CSR column indices, sorted within each row.
      weights: optional float32[m] edge weights aligned with ``indices``.
      in_indptr / in_indices / in_weights: the transposed (in-edge) view.
    """

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    weights: Optional[np.ndarray] = None
    in_indptr: Optional[np.ndarray] = None
    in_indices: Optional[np.ndarray] = None
    in_weights: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @property
    def in_degree(self) -> np.ndarray:
        if self.in_indptr is None:
            raise ValueError("graph was built without the in-edge view")
        return np.diff(self.in_indptr).astype(np.int32)

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (src, dst) arrays in CSR order."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.out_degree)
        return src, self.indices

    def validate(self) -> None:
        assert self.indptr.shape == (self.n + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.m
        assert np.all(np.diff(self.indptr) >= 0)
        if self.m:
            assert self.indices.min() >= 0 and self.indices.max() < self.n
        if self.in_indptr is not None:
            assert self.in_indptr[-1] == self.m


def _to_csr(src: np.ndarray, dst: np.ndarray, w: Optional[np.ndarray], n: int):
    """Sort COO by (src, dst) and compress. Within-row dst order is sorted."""
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if w is not None:
        w = w[order]
    counts = np.bincount(src, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, dst.astype(np.int32), w


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n: Optional[int] = None,
    weights: Optional[np.ndarray] = None,
    *,
    symmetrize: bool = False,
    dedup: bool = True,
    drop_self_loops: bool = True,
    build_in_edges: bool = True,
) -> Graph:
    """Build a :class:`Graph` from a COO edge list.

    Args:
      symmetrize: add the reverse of every edge (undirected graphs).
      dedup: remove duplicate (src, dst) pairs (weights of dups are summed).
      drop_self_loops: remove (v, v) edges.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    w = None if weights is None else np.asarray(weights, dtype=np.float32)

    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if w is not None:
            w = np.concatenate([w, w])
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    if dedup and src.size:
        key = src * n + dst
        if w is None:
            key = np.unique(key)
            src, dst = key // n, key % n
        else:
            uniq, inv = np.unique(key, return_inverse=True)
            wsum = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(wsum, inv, w)
            src, dst, w = uniq // n, uniq % n, wsum.astype(np.float32)

    src = src.astype(np.int32)
    dst = dst.astype(np.int32)
    indptr, indices, w_sorted = _to_csr(src, dst, w, n)
    g = Graph(n=n, indptr=indptr, indices=indices, weights=w_sorted)
    if build_in_edges:
        in_indptr, in_indices, in_w = _to_csr(dst, src, w, n)
        g = dataclasses.replace(
            g, in_indptr=in_indptr, in_indices=in_indices, in_weights=in_w
        )
    g.validate()
    return g


def reverse(g: Graph) -> Graph:
    """The transpose graph (out-edges become in-edges)."""
    if g.in_indptr is None:
        raise ValueError("graph was built without the in-edge view")
    return Graph(
        n=g.n,
        indptr=g.in_indptr,
        indices=g.in_indices,
        weights=g.in_weights,
        in_indptr=g.indptr,
        in_indices=g.indices,
        in_weights=g.weights,
    )


def degree_order(g: Graph) -> np.ndarray:
    """Permutation that relabels vertices by decreasing total degree.

    Graphyti's triangle counting orients intersection work so that high-degree
    vertices do the discovery ("reverse iteration leads to a 1.7x
    improvement") — here the same principle is realized by relabelling so
    degree decreases with vertex id, which concentrates dense adjacency tiles
    in the low-id corner of the blocked layout.
    """
    deg = g.out_degree.astype(np.int64)
    if g.in_indptr is not None:
        deg = deg + g.in_degree
    return np.argsort(-deg, kind="stable").astype(np.int32)
