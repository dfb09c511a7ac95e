"""Breadth-first search: uni-source, multi-source, direction-optimizing —
torch port of ``repro.algs.bfs``.

K searches advance in one superstep: every vertex carries a K-lane
reachability vector and every streamed chunk or tile serves all K lanes.
The frontier carries an ``unexplored`` candidate set, so a
``direction='auto'`` policy gets Beamer push/pull switching.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import ExecutionPolicy, Frontier, SemGraph, VertexProgram
from ..core.semiring import OR_AND

__all__ = ["BFSProgram", "UNREACHED"]

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
