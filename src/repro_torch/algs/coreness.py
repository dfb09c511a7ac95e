"""Coreness (k-core) decomposition — torch port of ``repro.algs.coreness``.

Peeling removes every live vertex whose current degree is at most k and
multicasts a decrement to its neighbours; a round that removes nothing
advances k, to k+1 or, pruned, straight to the least live degree (the
levels between cannot remove anything).  ``messaging`` keeps the
reference's benchmark triple: 'dense' is pure multicast, 'p2p' always
row-exact fetches, 'hybrid' the engine's density dispatch.  Works on
undirected (symmetrized) graphs, where out-degree is the degree.

The loop is a :class:`CorenessProgram` on the shared driver.  Its hooks
never read the device from the host: ``gather`` always calls the engine
and zeroes the round's IOStats and result when nothing was removed, so
empty rounds count no I/O, as in the reference; ``apply``
computes the remove and the advance branch of the reference's
``lax.cond`` and selects the level with ``torch.where``.
``coreness`` is a deprecated shim; new code goes through
``repro_torch.Graph.coreness()``.
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
    traverse,
)
from ..core.semiring import PLUS_TIMES

__all__ = ["CoreState", "CorenessProgram", "coreness"]

_INT_MAX = torch.iinfo(torch.int32).max


class CoreState(NamedTuple):
    deg: torch.Tensor  # int32[n] current (decremented) degree
    alive: torch.Tensor  # bool[n]
    core: torch.Tensor  # int32[n] assigned coreness (valid once removed)
    k: torch.Tensor  # int32 0-d current peeling level


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
            k=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def frontier(self, sg: SemGraph, s: CoreState) -> Frontier:
        removed = s.alive & (s.deg <= s.k)
        return Frontier(x=torch.where(removed, -1.0, 0.0), active=removed)

    def gather(self, sg: SemGraph, s: CoreState, fr: Frontier, policy):
        """Push -1 along the out-edges of removed vertices.  A round that
        removes nothing still calls the engine on its empty frontier, and
        its result and IOStats are zeroed, so an advance round counts no
        I/O.  Where a p2p arm may run, adaptive capacities (value- and
        IOStats-neutral) size its buckets to the frontier: at the
        reference's caps an empty round would cost a full O(n + m) p2p
        pass, while an empty multicast is cheap as it stands."""
        pol = policy.with_(adaptive_cap=self.messaging != "dense")
        if self.messaging == "p2p":
            # Always row-exact: the p2p arm at the reference's caps (it is
            # capacity-invariant, so values and IOStats equal the direct
            # p2p gather's; on a host view it is the host p2p arm).
            pol = pol.with_(switch_fraction=1.0, vcap=sg.n,
                            ecap=max(int(sg.m), 1))
        y, st = traverse(sg, fr.x, fr.active, PLUS_TIMES, policy=pol)
        fetched = torch.any(fr.active)
        # field by field: a stacked mask would mix x_fetches into the
        # order-invariant counters (rule R4 follows taint per tensor)
        return (torch.where(fetched, y, 0.0),
                IOStats(*(torch.where(fetched, f, 0) for f in st)))

    def apply(self, sg: SemGraph, s: CoreState, delta):
        """The reference's ``lax.cond(any(removed), remove, advance)`` with
        no host read: the remove branch's degree, liveness and core
        updates are the identity when nothing is removed (``delta`` is
        then zero), so only the level selects between the branches, on
        the device."""
        removed = s.alive & (s.deg <= s.k)
        # advance: the next level, pruned to the least live degree
        live_deg = torch.where(s.alive, s.deg, _INT_MAX)
        next_k = torch.amin(live_deg) if self.prune else s.k + 1
        next_k = torch.maximum(next_k, s.k + 1)
        s = CoreState(s.deg + delta.to(torch.int32), s.alive & ~removed,
                      torch.where(removed, s.k, s.core),
                      torch.where(torch.any(removed), s.k, next_k))
        return s, s.alive

    def converged(self, sg: SemGraph, s: CoreState, activated):
        return ~torch.any(s.alive)

    def max_supersteps(self, sg: SemGraph) -> int:
        return 4 * sg.n + 64

    def finalize(self, sg: SemGraph, s: CoreState) -> torch.Tensor:
        return s.core


def coreness(
    sg: SemGraph,
    *,
    prune: bool = True,
    messaging: str = "hybrid",
    switch_fraction: Optional[float] = None,
    max_supersteps: Optional[int] = None,
    chunk_cap: Optional[int] = None,
    policy: Optional[ExecutionPolicy] = None,
):
    """Deprecated shim over :class:`CorenessProgram` — use
    ``repro_torch.Graph.coreness()``.  Returns (core_number[n], IOStats,
    supersteps)."""
    pol = legacy_policy("coreness", "repro.Graph.coreness(policy=...)",
                        policy, None, chunk_cap=chunk_cap,
                        switch_fraction=switch_fraction)
    res = run_program(sg, CorenessProgram(prune=prune, messaging=messaging),
                      pol, max_supersteps=max_supersteps)
    return res.values, res.iostats, res.supersteps
