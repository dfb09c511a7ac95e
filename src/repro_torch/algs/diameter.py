"""Graph diameter estimation by pseudo-peripheral multi-source BFS — torch
port of ``repro.algs.diameter``.

A double-sweep estimator: a BFS from the highest-degree vertex finds the
farthest frontier; each sweep then runs K BFS from the K farthest vertices
of the last one.  The estimate is the largest eccentricity seen, a lower
bound on the diameter.  ``multi=True`` runs a sweep as one K-lane
:class:`~repro_torch.algs.bfs.BFSProgram` (one fetch serves every source);
``multi=False`` as K single-source runs (the same answer, K times the
fetches).  Sources are chosen on the host between the searches; ties go to
the lower vertex id, as the reference's stable sort and ``argmax`` give.
``diameter_multisource``/``diameter_unisource`` are deprecated shims; new
code goes through ``repro_torch.Graph.diameter()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import (
    ExecutionPolicy,
    IOStats,
    SemGraph,
    legacy_policy,
    run_program,
)
from .bfs import _BFS_DEFAULT, UNREACHED, BFSProgram

__all__ = ["diameter_multisource", "diameter_unisource"]

_UNREACHED = int(UNREACHED)


def _farthest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k reachable vertices with the largest BFS distance,
    ties to the lower id (a stable sort)."""
    d = torch.where(dist == _UNREACHED, -1, dist)
    return torch.argsort(-d, stable=True)[:k].to(torch.int32)


def _max_dist(dist: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.where(dist == _UNREACHED, -1, dist))


def _bfs(sg, sources, pol):
    """(dist[n, K], IOStats, supersteps) of one BFS program run."""
    res = run_program(sg, BFSProgram(), pol, seeds=sources)
    return res.values, res.iostats, res.supersteps


def _diameter(
    sg: SemGraph,
    pol: Optional[ExecutionPolicy],
    *,
    num_sources: int,
    sweeps: int,
    seed_vertex: Optional[int],
    multi: bool,
) -> tuple[torch.Tensor, IOStats, torch.Tensor]:
    """The sweeps (the façade calls this): ``(estimate, IOStats,
    supersteps)`` summed over every BFS run."""
    if seed_vertex is None:
        seed_vertex = int(torch.argmax(sg.out_degree))  # the first maximum
    dist, io, total_steps = _bfs(sg, [seed_vertex], pol)
    dist = dist[:, 0]
    estimate = _max_dist(dist)
    for _ in range(sweeps):
        sources = _farthest(dist, num_sources)
        if multi:
            dist_k, io_k, iters_k = _bfs(sg, sources, pol)
            estimate = torch.maximum(estimate, _max_dist(dist_k))
            io = io + io_k
            total_steps = total_steps + iters_k
            # farthest from any source drives the next sweep (finite only)
            best = torch.where(dist_k == _UNREACHED, -1, dist_k).amax(dim=1)
        else:
            best = torch.full((sg.n,), -1, dtype=torch.int32,
                              device=dist.device)
            for i in range(num_sources):
                d_i, io_i, it_i = _bfs(sg, sources[i:i + 1], pol)
                d_i = d_i[:, 0]
                estimate = torch.maximum(estimate, _max_dist(d_i))
                io = io + io_i
                total_steps = total_steps + it_i
                best = torch.maximum(best,
                                     torch.where(d_i == _UNREACHED, -1, d_i))
        dist = torch.where(best < 0, _UNREACHED, best)
    return estimate, io, total_steps


def diameter_multisource(
    sg: SemGraph,
    *,
    num_sources: int = 32,
    sweeps: int = 2,
    seed_vertex: Optional[int] = None,
    backend: Optional[str] = None,
    chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim — use ``repro_torch.Graph.diameter()``.  Returns
    (estimate, IOStats, supersteps)."""
    pol = legacy_policy("diameter_multisource",
                        "repro.Graph.diameter(policy=...)",
                        policy, _BFS_DEFAULT,
                        backend=backend, chunk_cap=chunk_cap)
    return _diameter(sg, pol, num_sources=num_sources, sweeps=sweeps,
                     seed_vertex=seed_vertex, multi=True)


def diameter_unisource(
    sg: SemGraph,
    *,
    num_sources: int = 32,
    sweeps: int = 2,
    seed_vertex: Optional[int] = None,
    backend: Optional[str] = None,
    chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim: the same sweeps, one full BFS per source."""
    pol = legacy_policy("diameter_unisource",
                        "repro.Graph.diameter(mode='uni', policy=...)",
                        policy, _BFS_DEFAULT,
                        backend=backend, chunk_cap=chunk_cap)
    return _diameter(sg, pol, num_sources=num_sources, sweeps=sweeps,
                     seed_vertex=seed_vertex, multi=False)
