"""Betweenness centrality (Brandes) — torch port of
``repro.algs.betweenness``.

Three variants, as in the reference:

  * 'multi' — K sources advance together: every forward level (a K-lane
    BFS with path counts, :class:`BCForwardProgram`), then every backward
    level (:class:`BCBackwardProgram`, a reverse push over the levels);
  * 'uni' — one source (or one group of ``batch`` sources) at a time;
  * 'fused' — :class:`FusedBCProgram`: each source runs its own phase and
    level, so one superstep advances forward and backward lanes at once,
    and a chunk both phases touch is charged once (shared-fetch
    accounting over the chunk store).

Under a blocked backend the K source lanes are the kernels' K lanes (one
tile fetch serves every source); the backward phase runs the reverse tile
view.  ``bc_multisource``/``bc_unisource``/``bc_fused`` are deprecated
shims; new code goes through ``repro_torch.Graph.betweenness()``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import (
    ExecutionPolicy,
    Frontier,
    IOStats,
    SemGraph,
    VertexProgram,
    legacy_policy,
    run_program,
    sem_spmv,
    warn_legacy,
)
from ..core.sem import _store_record_bytes, chunk_activity, i32
from ..core.semiring import PLUS_TIMES

__all__ = ["BCBackwardProgram", "BCForwardProgram", "FusedBCProgram",
           "bc_fused", "bc_multisource", "bc_unisource"]

# Historical BC behaviour: pure multicast (no p2p arm), static push.
_BC_DEFAULT = ExecutionPolicy(switch_fraction=None)


def _seeded(sg, sources):
    """sigma (1 at each source), dist (0 there, -1 elsewhere) and the
    frontier (the sources), all [n, K]."""
    src = torch.as_tensor(sources).to(sg.device, torch.int64)
    n, K = sg.n, src.numel()
    ar = torch.arange(K, device=sg.device)
    sigma = torch.zeros((n, K), dtype=torch.float32, device=sg.device)
    sigma[src, ar] = 1.0
    dist = torch.full((n, K), -1, dtype=torch.int32, device=sg.device)
    dist[src, ar] = 0
    frontier = torch.zeros((n, K), dtype=torch.bool, device=sg.device)
    frontier[src, ar] = True
    return sigma, dist, frontier


class _FwdState(NamedTuple):
    sigma: torch.Tensor  # f32[n, K] shortest-path counts
    dist: torch.Tensor  # int32[n, K] (-1 = unreached)
    frontier: torch.Tensor  # bool[n, K]
    level: int


class BCForwardProgram(VertexProgram):
    """Synchronous multi-source BFS with path counting.  A frontier
    expansion, so ``direction='auto'`` gets Beamer push/pull switching."""

    semiring = PLUS_TIMES
    default_policy = _BC_DEFAULT

    def init(self, sg: SemGraph, seeds) -> _FwdState:
        sigma, dist, frontier = _seeded(sg, seeds)
        return _FwdState(sigma, dist, frontier, 0)

    def frontier(self, sg: SemGraph, s: _FwdState) -> Frontier:
        return Frontier(
            x=torch.where(s.frontier, s.sigma, 0.0),
            active=torch.any(s.frontier, dim=1),
            unexplored=torch.any(s.dist < 0, dim=1),
        )

    def apply(self, sg: SemGraph, s: _FwdState, recv):
        newly = (recv > 0) & (s.dist < 0)
        sigma = torch.where(newly, recv, s.sigma)
        dist = torch.where(newly, s.level + 1, s.dist)
        return _FwdState(sigma, dist, newly, s.level + 1), newly


class _BwdState(NamedTuple):
    delta: torch.Tensor  # f32[n, K] dependency scores
    sigma: torch.Tensor  # f32[n, K] (constant through the loop)
    dist: torch.Tensor  # int32[n, K] (constant through the loop)
    level: torch.Tensor  # int32 0-d current receiving level


def _dependency_x(delta, sigma, send_mask):
    """What a sender at the next level pushes back: (1 + delta) / sigma."""
    return torch.where(send_mask,
                       (1.0 + delta) / torch.clamp(sigma, min=1e-30), 0.0)


class BCBackwardProgram(VertexProgram):
    """Synchronous dependency accumulation, level = max_level-1 .. 0.
    Messages flow against the edges (a reverse push).  ``seeds``:
    ``(sigma, dist, max_level)`` of the forward phase."""

    semiring = PLUS_TIMES
    default_policy = _BC_DEFAULT
    reverse = True
    check_initial_convergence = True  # max_level 0 -> zero supersteps

    def prepare_policy(self, sg: SemGraph, policy: ExecutionPolicy):
        return policy.with_(direction="out")

    def init(self, sg: SemGraph, seeds) -> _BwdState:
        sigma, dist, max_level = seeds
        level = torch.as_tensor(max_level).to(sigma.device, torch.int32) - 1
        return _BwdState(torch.zeros_like(sigma), sigma, dist, level)

    def frontier(self, sg: SemGraph, s: _BwdState) -> Frontier:
        x = _dependency_x(s.delta, s.sigma, s.dist == s.level + 1)
        return Frontier(x=x, active=torch.any(s.dist == s.level, dim=1))

    def apply(self, sg: SemGraph, s: _BwdState, recv):
        recv_mask = s.dist == s.level
        delta = torch.where(recv_mask, s.delta + s.sigma * recv, s.delta)
        return s._replace(delta=delta, level=s.level - 1), recv_mask

    def converged(self, sg: SemGraph, s: _BwdState, activated):
        return s.level < 0

    def max_supersteps(self, sg: SemGraph) -> int:
        return sg.n + 2

    def finalize(self, sg: SemGraph, s: _BwdState) -> torch.Tensor:
        return s.delta


def _finish(delta: torch.Tensor, sources) -> torch.Tensor:
    """BC: the dependencies summed over source lanes, each source's own
    entry left out."""
    src = torch.as_tensor(sources).to(delta.device, torch.int64)
    delta = delta.clone()
    delta[src, torch.arange(src.numel(), device=delta.device)] = 0.0
    return torch.sum(delta, dim=1)


def _bc_sync(sg: SemGraph, sources, max_iters, pol, *, checkpoint=None,
             resume: bool = False):
    """Forward then backward phase through :func:`run_program`:
    ``(bc[n], IOStats, supersteps)``.

    With ``checkpoint``, each phase snapshots into its own fingerprinted
    subtree (``fwd/`` and ``bwd/``): a kill during the backward sweep
    resumes there, replaying the finished forward phase from its final
    snapshot."""
    sources = torch.as_tensor(sources, dtype=torch.int32)
    max_iters = max_iters or sg.n + 1
    ck_f = checkpoint.child("fwd") if checkpoint is not None else None
    ck_b = checkpoint.child("bwd") if checkpoint is not None else None
    fwd = run_program(sg, BCForwardProgram(), pol, seeds=sources,
                      max_supersteps=max_iters, checkpoint=ck_f,
                      resume=resume)
    dist = fwd.state.dist
    max_level = int(torch.max(torch.where(dist < 0, -1, dist)))
    bwd = run_program(sg, BCBackwardProgram(), pol,
                      seeds=(fwd.state.sigma, dist, max_level),
                      checkpoint=ck_b, resume=resume)
    return (_finish(bwd.values, sources), fwd.iostats + bwd.iostats,
            fwd.supersteps + max(max_level, 0))


class _FusedState(NamedTuple):
    sigma: torch.Tensor  # f32[n, K]
    dist: torch.Tensor  # int32[n, K]
    frontier: torch.Tensor  # bool[n, K] forward frontier
    delta: torch.Tensor  # f32[n, K]
    phase: torch.Tensor  # int32[K] 0=forward 1=backward 2=done
    level: torch.Tensor  # int32[K] per-source current level
    shared: torch.Tensor  # int32 chunks saved by fwd/bwd fetch overlap


class FusedBCProgram(VertexProgram):
    """Phase-fused multi-source Brandes (the paper's asynchronous variant).

    A source flips to its backward phase the superstep its frontier
    drains, while other sources still search.  ``gather`` runs both
    phases' multicasts over the out chunk store (``sem_spmv``, forward and
    reverse) and charges a chunk both touch once (``state.shared`` counts
    them).
    """

    semiring = PLUS_TIMES

    def init(self, sg: SemGraph, seeds) -> _FusedState:
        sigma, dist, frontier = _seeded(sg, seeds)
        K = sigma.shape[1]
        zk = torch.zeros(K, dtype=torch.int32, device=sg.device)
        return _FusedState(sigma, dist, frontier, torch.zeros_like(sigma),
                           zk, zk.clone(),
                           torch.zeros((), dtype=torch.int32,
                                       device=sg.device))

    def frontier(self, sg: SemGraph, s: _FusedState) -> Frontier:
        fwd_front = s.frontier & (s.phase == 0)[None, :]
        return Frontier(x=torch.where(fwd_front, s.sigma, 0.0),
                        active=torch.any(fwd_front, dim=1))

    def gather(self, sg: SemGraph, s: _FusedState, fr: Frontier, policy):
        store = sg.out_store
        bwd_lane = (s.phase == 1)[None, :]
        # forward sub-step (lanes in phase 0)
        recv, st_f = sem_spmv(store, fr.x, fr.active, PLUS_TIMES)
        # backward sub-step (lanes in phase 1, each at its own level)
        x = _dependency_x(s.delta, s.sigma,
                          (s.dist == s.level[None, :] + 1) & bwd_lane)
        bwd_active = torch.any((s.dist == s.level[None, :]) & bwd_lane,
                               dim=1)
        brecv, st_b = sem_spmv(store, x, bwd_active, PLUS_TIMES,
                               reverse=True)
        # shared-fetch accounting: a chunk both phases touch is read once
        both = torch.sum(chunk_activity(store, fr.active)
                         & chunk_activity(store, bwd_active))
        saved = both * store.chunk_size
        st = (st_f + st_b)._replace(
            records=i32(st_f.records.long() + st_b.records.long() - saved),
            bytes_moved=i32(st_f.bytes_moved.long() + st_b.bytes_moved.long()
                            - saved * _store_record_bytes(store.w)),
        )
        return (recv, brecv, i32(both)), st

    def apply(self, sg: SemGraph, s: _FusedState, gathered):
        recv, brecv, both = gathered
        fwd_lane = s.phase == 0
        bwd_lane = s.phase == 1

        newly = (recv > 0) & (s.dist < 0) & fwd_lane[None, :]
        sigma = torch.where(newly, recv, s.sigma)
        dist = torch.where(newly, s.level[None, :] + 1, s.dist)

        recv_mask = (s.dist == s.level[None, :]) & bwd_lane[None, :]
        delta = torch.where(recv_mask, s.delta + s.sigma * brecv, s.delta)

        # per-source phase and level transitions
        lane_has_new = torch.any(newly, dim=0)
        fwd_to_bwd = fwd_lane & ~lane_has_new
        deepest = torch.amax(dist, dim=0)  # senders of the first bwd step
        level = torch.where(fwd_to_bwd, torch.clamp(deepest - 1, min=-1),
                            s.level)
        phase = torch.where(fwd_to_bwd & (level < 0), 2,
                            torch.where(fwd_to_bwd, 1, s.phase))
        stepped_down = torch.where(bwd_lane, s.level - 1, level)
        level = torch.where(bwd_lane, stepped_down, level)
        phase = torch.where(bwd_lane & (stepped_down < 0), 2, phase)
        level = torch.where(fwd_lane & lane_has_new, s.level + 1, level)

        s = _FusedState(sigma, dist, newly, delta, phase.to(torch.int32),
                        level.to(torch.int32), i32(s.shared.long() + both))
        return s, newly

    def converged(self, sg: SemGraph, s: _FusedState, activated):
        return torch.all(s.phase == 2)

    def max_supersteps(self, sg: SemGraph) -> int:
        return 2 * (sg.n + 2)

    def finalize(self, sg: SemGraph, s: _FusedState) -> torch.Tensor:
        return s.delta


def bc_multisource(
    sg: SemGraph, sources, *, max_iters: Optional[int] = None,
    backend: Optional[str] = None, chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim over the forward/backward programs — use
    ``repro_torch.Graph.betweenness()``.  Returns (bc[n], IOStats,
    supersteps)."""
    pol = legacy_policy("bc_multisource",
                        "repro.Graph.betweenness(policy=...)",
                        policy, _BC_DEFAULT,
                        backend=backend, chunk_cap=chunk_cap)
    return _bc_sync(sg, sources, max_iters, pol)


def bc_unisource(
    sg: SemGraph, sources, *, max_iters: Optional[int] = None,
    backend: Optional[str] = None, chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim: K separate single-source runs (the uni-source
    baseline).  Returns (bc[n], IOStats, supersteps)."""
    pol = legacy_policy("bc_unisource",
                        "repro.Graph.betweenness(mode='uni', policy=...)",
                        policy, _BC_DEFAULT,
                        backend=backend, chunk_cap=chunk_cap)
    sources = torch.as_tensor(sources, dtype=torch.int32)
    bc = torch.zeros(sg.n, dtype=torch.float32, device=sg.device)
    io = IOStats.zero(sg.device)
    steps = torch.zeros((), dtype=torch.int32)
    for i in range(int(sources.shape[0])):
        b, st, it = _bc_sync(sg, sources[i:i + 1], max_iters, pol)
        bc, io, steps = bc + b, io + st, steps + it
    return bc, io, steps


def bc_fused(sg: SemGraph, sources, *, max_iters: Optional[int] = None):
    """Deprecated shim over :class:`FusedBCProgram` — use
    ``repro_torch.Graph.betweenness(mode='fused')``.  Returns (bc[n],
    IOStats, supersteps, shared_chunks)."""
    warn_legacy("bc_fused", "repro.Graph.betweenness(mode='fused')")
    sources = torch.as_tensor(sources, dtype=torch.int32)
    res = run_program(sg, FusedBCProgram(), seeds=sources,
                      max_supersteps=max_iters)
    return (_finish(res.values, sources), res.iostats, res.supersteps,
            res.state.shared)
