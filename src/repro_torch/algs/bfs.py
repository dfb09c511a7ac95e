"""Breadth-first search: uni-source, multi-source, direction-optimizing —
torch port of ``repro.algs.bfs``.

K searches advance in one superstep: every vertex carries a K-lane
reachability vector and every streamed chunk or tile serves all K lanes.
The frontier carries an ``unexplored`` candidate set, so a
``direction='auto'`` policy gets Beamer push/pull switching.
``bfs_multi``/``bfs_uni`` are deprecated shims; new code goes through
``repro_torch.Graph.bfs()``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import (
    ExecutionPolicy,
    Frontier,
    SemGraph,
    VertexProgram,
    legacy_policy,
    run_program,
)
from ..core.semiring import OR_AND

__all__ = ["BFSProgram", "UNREACHED", "bfs_multi", "bfs_uni"]

UNREACHED = np.int32(np.iinfo(np.int32).max)

# Historical BFS behavior: pure multicast (no p2p arm) static push.
_BFS_DEFAULT = ExecutionPolicy(switch_fraction=None)


class BFSState(NamedTuple):
    reached: torch.Tensor  # bool[n, K]
    frontier: torch.Tensor  # bool[n, K] newly reached last superstep
    dist: torch.Tensor  # int32[n, K]
    level: int


class BFSProgram(VertexProgram):
    """K concurrent BFS over the out-edges (or_and frontier expansion).

    ``seeds``: int[K] source vertex ids.  ``values``: int32[n, K]
    distances, :data:`UNREACHED` where a lane never arrives.
    """

    semiring = OR_AND
    default_policy = _BFS_DEFAULT

    def init(self, sg: SemGraph, seeds) -> BFSState:
        dev = sg.device
        sources = torch.as_tensor(seeds).to(dev, torch.int64).reshape(-1)
        n, K = sg.n, int(sources.shape[0])
        lanes = torch.arange(K, device=dev)
        reached = torch.zeros((n, K), dtype=torch.bool, device=dev)
        reached[sources, lanes] = True
        dist = torch.full((n, K), int(UNREACHED), dtype=torch.int32, device=dev)
        dist[sources, lanes] = 0
        return BFSState(reached, reached, dist, 0)

    def frontier(self, sg: SemGraph, s: BFSState) -> Frontier:
        return Frontier(x=s.frontier, active=s.frontier, unexplored=~s.reached)

    def apply(self, sg: SemGraph, s: BFSState, nxt):
        newly = nxt & ~s.reached
        reached = s.reached | newly
        dist = torch.where(newly, s.level + 1, s.dist)
        return BFSState(reached, newly, dist, s.level + 1), newly

    def finalize(self, sg: SemGraph, s: BFSState) -> torch.Tensor:
        return s.dist


def bfs_multi(
    sg: SemGraph,
    sources,
    *,
    max_iters: Optional[int] = None,
    backend: Optional[str] = None,
    chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim over :class:`BFSProgram` — use
    ``repro_torch.Graph.bfs()``.  Returns (dist int32[n, K], UNREACHED
    where not reached; IOStats; supersteps)."""
    pol = legacy_policy("bfs_multi", "repro.Graph.bfs(policy=...)",
                        policy, _BFS_DEFAULT,
                        backend=backend, chunk_cap=chunk_cap)
    res = run_program(sg, BFSProgram(), pol, seeds=sources,
                      max_supersteps=max_iters)
    return res.values, res.iostats, res.supersteps


def bfs_uni(
    sg: SemGraph, source: int, *, max_iters: Optional[int] = None,
    backend: Optional[str] = None, chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated single-source shim (the K=1 case of :class:`BFSProgram`)."""
    pol = legacy_policy("bfs_uni", "repro.Graph.bfs(policy=...)",
                        policy, _BFS_DEFAULT,
                        backend=backend, chunk_cap=chunk_cap)
    res = run_program(sg, BFSProgram(), pol, seeds=[int(source)],
                      max_supersteps=max_iters)
    return res.values[:, 0], res.iostats, res.supersteps
