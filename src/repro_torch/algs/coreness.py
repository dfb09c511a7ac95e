"""Coreness (k-core) decomposition — torch port of ``repro.algs.coreness``.

Peeling removes every live vertex whose current degree is at most k and
multicasts a decrement to its neighbours; a round that removes nothing
advances k, to k+1 or, pruned, straight to the least live degree (the
levels between cannot remove anything).  ``messaging`` keeps the
reference's benchmark triple: 'dense' is pure multicast, 'p2p' always
row-exact fetches, 'hybrid' the engine's density dispatch.  Works on
undirected (symmetrized) graphs, where out-degree is the degree.

The loop is a :class:`CorenessProgram` on the shared driver.  Its
``gather`` skips the engine on a round that removes nothing, so empty
rounds cost no I/O, as in the reference (whose ``lax.cond`` is a Python
branch here).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import (
    ExecutionPolicy,
    Frontier,
    IOStats,
    SemGraph,
    VertexProgram,
    p2p_spmv,
    traverse,
)
from ..core.semiring import PLUS_TIMES

__all__ = ["CoreState", "CorenessProgram"]

_INT_MAX = torch.iinfo(torch.int32).max


class CoreState(NamedTuple):
    deg: torch.Tensor  # int32[n] current (decremented) degree
    alive: torch.Tensor  # bool[n]
    core: torch.Tensor  # int32[n] assigned coreness (valid once removed)
    k: int  # current peeling level


class CorenessProgram(VertexProgram):
    """k-core peeling.  ``values``: int32[n] core numbers.

    The policy refines the 'dense'/'hybrid' execution (a ``chunk_cap``
    routes mid-density removals through the compact scan); 'p2p' always
    fetches exact rows.
    """

    semiring = PLUS_TIMES

    def __init__(self, *, prune: bool = True, messaging: str = "hybrid"):
        if messaging not in ("dense", "p2p", "hybrid"):
            raise ValueError(f"unknown coreness messaging {messaging!r}")
        self.prune = prune
        self.messaging = messaging

    def prepare_policy(self, sg: SemGraph, policy: ExecutionPolicy):
        pol = policy.with_(direction="out")
        if self.messaging == "dense":
            pol = pol.with_(switch_fraction=None)
        else:
            pol = pol.with_(
                vcap=pol.vcap if pol.vcap is not None else sg.n,
                ecap=pol.ecap if pol.ecap is not None else max(int(sg.m), 1),
            )
        return pol

    def init(self, sg: SemGraph, seeds) -> CoreState:
        dev = sg.device
        return CoreState(
            deg=sg.out_degree.to(torch.int32),
            alive=torch.ones(sg.n, dtype=torch.bool, device=dev),
            core=torch.zeros(sg.n, dtype=torch.int32, device=dev),
            k=0,
        )

    def frontier(self, sg: SemGraph, s: CoreState) -> Frontier:
        removed = s.alive & (s.deg <= s.k)
        return Frontier(x=torch.where(removed, -1.0, 0.0), active=removed)

    def gather(self, sg: SemGraph, s: CoreState, fr: Frontier, policy):
        """Push -1 along the out-edges of removed vertices, only when the
        round removes anything; an advance round does no I/O."""
        if not bool(torch.any(fr.active)):
            return (torch.zeros(sg.n, dtype=torch.float32, device=sg.device),
                    IOStats.zero(sg.device))
        if self.messaging != "p2p":
            return traverse(sg, fr.x, fr.active, PLUS_TIMES, policy=policy)
        cap = dict(vcap=sg.n, ecap=max(int(sg.m), 1))
        if getattr(sg, "is_host_view", False):
            # The raw p2p gather has no host form: force the host
            # dispatcher's p2p arm with the same caps (capacity-invariant,
            # so values and IOStats equal the direct call).
            return traverse(sg, fr.x, fr.active, PLUS_TIMES,
                            policy=policy.with_(switch_fraction=1.0, **cap))
        return p2p_spmv(sg, fr.x, fr.active, PLUS_TIMES, direction="out",
                        **cap)

    def apply(self, sg: SemGraph, s: CoreState, delta):
        removed = s.alive & (s.deg <= s.k)
        if bool(torch.any(removed)):
            s = CoreState(s.deg + delta.to(torch.int32), s.alive & ~removed,
                          torch.where(removed, s.k, s.core), s.k)
        else:
            live_deg = torch.where(s.alive, s.deg, _INT_MAX)
            next_k = int(torch.min(live_deg)) if self.prune else s.k + 1
            s = s._replace(k=max(next_k, s.k + 1))
        return s, s.alive

    def converged(self, sg: SemGraph, s: CoreState, activated):
        return ~torch.any(s.alive)

    def max_supersteps(self, sg: SemGraph) -> int:
        return 4 * sg.n + 64

    def finalize(self, sg: SemGraph, s: CoreState) -> torch.Tensor:
        return s.core
