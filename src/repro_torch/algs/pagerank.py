"""PageRank: PR-pull (Pregel style) vs PR-push (Graphyti, paper §4.1) —
torch port of ``repro.algs.pagerank``.

Both iterate ``R(u) = (1 - c)/n + c * sum_{v in B_u} R(v) / N_v``; PR-push
sends only deltas above the threshold, so its active set and its edge I/O
shrink as ranks converge.  :class:`PersonalizedPageRankProgram` is PR-push
with a query axis: Q reset distributions in one (n, Q) state.  State is
pinned to float32.  ``pagerank_pull``/``pagerank_push`` are deprecated
shims (new code goes through ``repro_torch.Graph.pagerank()``);
``pagerank_inmem`` is the flat in-memory baseline.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import (
    ExecutionPolicy,
    Frontier,
    SemGraph,
    VertexProgram,
    flat_spmv,
    legacy_policy,
    run_program,
    traverse,
)
from ..core.semiring import OR_AND, PLUS_TIMES

__all__ = ["PPRState", "PageRankPullProgram", "PageRankPushProgram",
           "PersonalizedPageRankProgram", "pagerank_inmem", "pagerank_pull",
           "pagerank_push"]

# PR-pull's historical execution: pure multicast, no p2p arm.
_PULL_DEFAULT = ExecutionPolicy(switch_fraction=None)


def _out_contrib(sg: SemGraph, values: torch.Tensor) -> torch.Tensor:
    """values / out_degree, dangling vertices contributing nothing."""
    deg = torch.clamp(sg.out_degree, min=1)
    shape = tuple(deg.shape) + (1,) * (values.ndim - 1)
    return torch.where((sg.out_degree > 0).reshape(shape),
                       values / deg.reshape(shape), 0.0)


class PRPullState(NamedTuple):
    rank: torch.Tensor
    prev: torch.Tensor  # previous rank
    active: torch.Tensor  # gatherers this superstep
    changed: torch.Tensor  # moved beyond threshold (drives activation)


class PageRankPullProgram(VertexProgram):
    """Pregel/Turi-style PR-pull: activated vertices gather over ALL
    in-edges (direction pinned to 'in'), and vertices that moved beyond the
    threshold multicast an activation along their out-edges."""

    semiring = PLUS_TIMES
    default_policy = _PULL_DEFAULT

    def __init__(self, *, damping: float = 0.85, tol: float = 1e-3):
        self.damping = damping
        self.tol = tol

    def init(self, sg: SemGraph, seeds) -> PRPullState:
        n, dev = sg.n, sg.device
        return PRPullState(
            rank=torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev),
            prev=torch.zeros(n, dtype=torch.float32, device=dev),
            active=torch.ones(n, dtype=torch.bool, device=dev),
            changed=torch.zeros(n, dtype=torch.bool, device=dev),
        )

    def frontier(self, sg: SemGraph, s: PRPullState) -> Frontier:
        return Frontier(x=_out_contrib(sg, s.rank), active=s.active)

    def gather(self, sg, s, fr, policy):
        return traverse(sg, fr.x, fr.active, PLUS_TIMES,
                        policy=policy.with_(direction="in"))

    def apply(self, sg: SemGraph, s: PRPullState, acc):
        base = (1.0 - self.damping) / sg.n
        thresh = self.tol / sg.n
        new_rank = torch.where(s.active, base + self.damping * acc, s.rank)
        changed = s.active & (torch.abs(new_rank - s.rank) > thresh)
        return PRPullState(new_rank, s.rank, s.active, changed), changed

    def activate(self, sg: SemGraph, s: PRPullState, policy):
        woke, io = traverse(sg, s.changed, s.changed, OR_AND,
                            policy=policy.with_(direction="out"))
        return s._replace(active=woke), io

    def max_supersteps(self, sg: SemGraph) -> int:
        return 100

    def finalize(self, sg: SemGraph, s: PRPullState) -> torch.Tensor:
        return s.rank


class PRPushState(NamedTuple):
    rank: torch.Tensor
    pending: torch.Tensor  # accumulated residual not yet propagated
    active: torch.Tensor


class PageRankPushProgram(VertexProgram):
    """Graphyti's delta PR-push: per superstep only vertices whose pending
    residual exceeds the threshold push it along their out-edges.
    ``prepare_policy`` pins the push direction and the reference's p2p
    capacity defaults."""

    semiring = PLUS_TIMES

    def __init__(self, *, damping: float = 0.85, tol: float = 1e-3):
        self.damping = damping
        self.tol = tol

    def prepare_policy(self, sg: SemGraph, policy: ExecutionPolicy):
        pol = policy.with_(direction="out")
        if pol.vcap is None:
            pol = pol.with_(vcap=sg.n)
        if pol.ecap is None:
            pol = pol.with_(ecap=max(4096, sg.m // 8))
        return pol

    def init(self, sg: SemGraph, seeds) -> PRPushState:
        base = (1.0 - self.damping) / sg.n
        n, dev = sg.n, sg.device
        return PRPushState(
            rank=torch.full((n,), base, dtype=torch.float32, device=dev),
            pending=torch.full((n,), base, dtype=torch.float32, device=dev),
            active=torch.ones(n, dtype=torch.bool, device=dev),
        )

    def frontier(self, sg: SemGraph, s: PRPushState) -> Frontier:
        send = torch.where(s.active, s.pending, 0.0)
        return Frontier(x=self.damping * _out_contrib(sg, send),
                        active=s.active)

    def apply(self, sg: SemGraph, s: PRPushState, recv):
        thresh = self.tol / sg.n
        send = torch.where(s.active, s.pending, 0.0)
        rank = s.rank + recv
        pending = (s.pending - send) + recv
        active = torch.abs(pending) > thresh
        return PRPushState(rank, pending, active), active

    def max_supersteps(self, sg: SemGraph) -> int:
        return 100

    def finalize(self, sg: SemGraph, s: PRPushState) -> torch.Tensor:
        return s.rank


class PPRState(NamedTuple):
    rank: torch.Tensor  # f32[n, Q]
    pending: torch.Tensor  # f32[n, Q] residual not yet propagated
    active: torch.Tensor  # bool[n, Q]


class PersonalizedPageRankProgram(VertexProgram):
    """Q-query personalized PageRank (delta push with a query axis).

    The fixed point of :class:`PageRankPushProgram` with the uniform
    teleport ``(1-c)/n`` replaced per query by a reset distribution r_q::

        R_q(u) = (1 - c) * r_q(u) + c * sum_{v in B_u} R_q(v) / N_v

    ``seeds`` selects the resets: integer vertex ids ``[Q]`` (a one-hot
    restart at each) or a float ``(n, Q)`` matrix of reset distributions
    (each column normalized to sum 1).  The engine fetches the union of
    the Q frontiers once a superstep, every streamed tile multiplied
    against the whole ``(tile, Q)`` x block.  Built for
    :func:`~repro_torch.core.run_program_batched`; on the plain driver a
    run converges when every query has.
    """

    semiring = PLUS_TIMES

    def __init__(self, *, damping: float = 0.85, tol: float = 1e-3):
        self.damping = damping
        self.tol = tol

    def prepare_policy(self, sg: SemGraph, policy: ExecutionPolicy):
        pol = policy.with_(direction="out")
        if pol.vcap is None:
            pol = pol.with_(vcap=sg.n)
        if pol.ecap is None:
            pol = pol.with_(ecap=max(4096, sg.m // 8))
        return pol

    def init(self, sg: SemGraph, seeds) -> PPRState:
        dev = sg.device
        r = torch.as_tensor(seeds).to(dev)
        if r.ndim == 1 and not torch.is_floating_point(r):
            q = r.shape[0]
            one_hot = torch.zeros((sg.n, q), dtype=torch.float32, device=dev)
            one_hot[r.long(), torch.arange(q, device=dev)] = 1.0
            r = one_hot
        else:
            r = r.to(torch.float32)
            if r.ndim == 1:
                r = r[:, None]
            r = r / torch.clamp(r.sum(dim=0, keepdim=True), min=1e-30)
        base = (1.0 - self.damping) * r
        thresh = self.tol / sg.n
        return PPRState(base, base, torch.abs(base) > thresh)

    def frontier(self, sg: SemGraph, s: PPRState) -> Frontier:
        send = torch.where(s.active, s.pending, 0.0)
        return Frontier(x=self.damping * _out_contrib(sg, send),
                        active=s.active)

    def apply(self, sg: SemGraph, s: PPRState, recv):
        thresh = self.tol / sg.n
        send = torch.where(s.active, s.pending, 0.0)
        rank = s.rank + recv
        pending = (s.pending - send) + recv
        active = torch.abs(pending) > thresh
        return PPRState(rank, pending, active), active

    def max_supersteps(self, sg: SemGraph) -> int:
        return 100

    def finalize(self, sg: SemGraph, s: PPRState) -> torch.Tensor:
        return s.rank


def pagerank_pull(
    sg: SemGraph,
    *,
    damping: float = 0.85,
    tol: float = 1e-3,
    max_iters: int = 100,
    backend: Optional[str] = None,
    chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim over :class:`PageRankPullProgram` — use
    ``repro_torch.Graph.pagerank(mode='pull')``.  Returns (rank, IOStats,
    supersteps)."""
    pol = legacy_policy("pagerank_pull",
                        "repro.Graph.pagerank(mode='pull', policy=...)",
                        policy, _PULL_DEFAULT,
                        backend=backend, chunk_cap=chunk_cap)
    res = run_program(sg, PageRankPullProgram(damping=damping, tol=tol), pol,
                      max_supersteps=max_iters)
    return res.values, res.iostats, res.supersteps


def pagerank_push(
    sg: SemGraph,
    *,
    damping: float = 0.85,
    tol: float = 1e-3,
    max_iters: int = 100,
    ecap: Optional[int] = None,
    switch_fraction: Optional[float] = None,
    backend: Optional[str] = None,
    chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim over :class:`PageRankPushProgram` — use
    ``repro_torch.Graph.pagerank()``.  Returns (rank, IOStats,
    supersteps)."""
    pol = legacy_policy("pagerank_push", "repro.Graph.pagerank(policy=...)",
                        policy, None, backend=backend, chunk_cap=chunk_cap,
                        ecap=ecap, switch_fraction=switch_fraction)
    res = run_program(sg, PageRankPushProgram(damping=damping, tol=tol), pol,
                      max_supersteps=max_iters)
    return res.values, res.iostats, res.supersteps


def pagerank_inmem(
    sg: SemGraph,
    *,
    damping: float = 0.85,
    tol: float = 1e-3,
    max_iters: int = 100,
):
    """In-memory baseline: flat unchunked pull iteration over all m edges
    (:func:`~repro_torch.core.engine.flat_spmv`, no SEM machinery).
    Returns (rank, iterations); the delta test reads the device once an
    iteration."""
    n = sg.n
    base = (1.0 - damping) / n
    allv = torch.ones(n, dtype=torch.bool, device=sg.device)
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=sg.device)
    it, more = 0, True
    while more and it < max_iters:
        acc = flat_spmv(sg, _out_contrib(sg, rank), allv, PLUS_TIMES,
                        direction="in")
        new = base + damping * acc
        more = bool(torch.max(torch.abs(new - rank)) * n > tol)
        rank, it = new, it + 1
    return rank, torch.tensor(it, dtype=torch.int32)
