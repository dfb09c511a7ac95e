"""PageRank: PR-pull (Pregel style) vs PR-push (Graphyti, paper §4.1) —
torch port of ``repro.algs.pagerank``.

Both iterate ``R(u) = (1 - c)/n + c * sum_{v in B_u} R(v) / N_v``; PR-push
sends only deltas above the threshold, so its active set and its edge I/O
shrink as ranks converge.  State is pinned to float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import ExecutionPolicy, Frontier, SemGraph, VertexProgram, traverse
from ..core.semiring import OR_AND, PLUS_TIMES

__all__ = ["PageRankPullProgram", "PageRankPushProgram"]

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
