"""Deterministic synthetic graph generators (numpy, host-side).

RMAT matches the skewed degree distributions of the paper's Twitter graph;
Erdos-Renyi and structured graphs (path / cycle / star / grid) are used by
the unit tests because their properties are known in closed form.
"""
from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges

__all__ = [
    "rmat",
    "erdos_renyi",
    "path_graph",
    "cycle_graph",
    "star_graph",
    "clique_ladder",
]


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    *,
    symmetrize: bool = False,
) -> Graph:
    """R-MAT power-law graph with 2**scale vertices (Graph500 parameters)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    # Recursive quadrant descent, vectorized over all edges per bit.
    for _ in range(scale):
        r = rng.random(m)
        src_bit = (r >= a + b).astype(np.int64)
        # Conditional distribution of the dst bit given the src bit.
        p_dst = np.where(src_bit == 0, b / (a + b), 1.0 - (c / (1.0 - a - b)))
        dst_bit = (rng.random(m) < p_dst).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    # Permute vertex ids so locality is not an artifact of the generator.
    perm = rng.permutation(n)
    return from_edges(perm[src], perm[dst], n=n, symmetrize=symmetrize)


def erdos_renyi(n: int, m: int, seed: int = 0, *, symmetrize: bool = False) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return from_edges(src, dst, n=n, symmetrize=symmetrize)


def path_graph(n: int) -> Graph:
    v = np.arange(n - 1)
    return from_edges(v, v + 1, n=n, symmetrize=True)


def cycle_graph(n: int) -> Graph:
    v = np.arange(n)
    return from_edges(v, (v + 1) % n, n=n, symmetrize=True)


def star_graph(n: int) -> Graph:
    """Vertex 0 connected to all others."""
    leaves = np.arange(1, n)
    return from_edges(np.zeros(n - 1, dtype=np.int64), leaves, n=n, symmetrize=True)


def clique_ladder(sizes=(8, 32, 128), bridge: int = 2, seed: int = 0) -> Graph:
    """Disjoint cliques of the given sizes plus a few bridge edges.

    A c-clique has coreness c-1, so the coreness spectrum has large GAPS
    between clique sizes — the workload where k-pruning (paper P3, §4.2)
    legitimately skips whole ranges of k.  Real social graphs show the same
    structure at the top of their core hierarchy (the paper's Twitter run);
    RMAT at bench scale does not, which understates pruning.
    """
    rng = np.random.default_rng(seed)
    src, dst = [], []
    offset = 0
    anchors = []
    for c in sizes:
        idx = np.arange(offset, offset + c)
        iu, ju = np.triu_indices(c, k=1)
        src.append(idx[iu])
        dst.append(idx[ju])
        anchors.append(offset)
        offset += c
    for a, b in zip(anchors[:-1], anchors[1:]):
        for _ in range(bridge):
            src.append(np.asarray([a + int(rng.integers(0, 2))]))
            dst.append(np.asarray([b + int(rng.integers(0, 2))]))
    return from_edges(
        np.concatenate(src), np.concatenate(dst), n=offset, symmetrize=True
    )
