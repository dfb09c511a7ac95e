"""The vertex-program layer (torch port of ``repro.core.program``).

A :class:`VertexProgram` says WHAT one superstep means (frontier, apply,
convergence); :func:`run_program` owns HOW supersteps execute — a Python
loop over supersteps, each asking the program for its frontier, executing
the multicast through :func:`repro_torch.core.engine.traverse`, applying
the update, accumulating :class:`~repro_torch.core.sem.IOStats` and
testing convergence.  The convergence test reads one device scalar per
superstep.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .engine import ExecutionPolicy, traverse
from .sem import IOStats, SemGraph, i32
from .semiring import PLUS_TIMES, Semiring

__all__ = ["Frontier", "ProgramResult", "VertexProgram", "run_program"]

State = Any


class Frontier(NamedTuple):
    """One superstep's logical multicast: ``active`` vertices send ``x``;
    ``unexplored`` (optional) marks candidate receivers and makes the step
    a frontier expansion (what lets ``direction='auto'`` pull)."""

    x: torch.Tensor
    active: torch.Tensor
    unexplored: Optional[torch.Tensor] = None


class ProgramResult(NamedTuple):
    """Uniform result of every program (and every ``repro_torch.Graph``
    method): ``values`` (``finalize`` of the final state), ``supersteps``
    (int32 scalar), ``iostats``, and the final ``state``."""

    values: Any
    supersteps: torch.Tensor
    iostats: IOStats
    state: Any = None


class VertexProgram:
    """Base class / protocol for vertex-centric programs.

    Required hooks: ``init(sg, seeds)``, ``frontier(sg, state)``,
    ``apply(sg, state, gathered) -> (state, activated)``.  Optional:
    ``converged``, ``gather``, ``activate``, ``prepare_policy``,
    ``max_supersteps``, ``finalize`` (defaults as in the reference).
    """

    semiring: Semiring = PLUS_TIMES
    default_policy: Optional[ExecutionPolicy] = None
    reverse: bool = False
    check_initial_convergence: bool = False

    def init(self, sg: SemGraph, seeds) -> State:
        raise NotImplementedError

    def frontier(self, sg: SemGraph, state: State) -> Frontier:
        raise NotImplementedError

    def apply(self, sg: SemGraph, state: State, gathered):
        raise NotImplementedError

    def converged(self, sg: SemGraph, state: State, activated) -> torch.Tensor:
        """Scalar bool: stop after this superstep.  Default: no activations."""
        return ~torch.any(activated)

    def gather(self, sg: SemGraph, state: State, fr: Frontier,
               policy: ExecutionPolicy):
        """Execute the frontier's multicast.  Default: one engine traverse."""
        return traverse(sg, fr.x, fr.active, self.semiring, policy=policy,
                        unexplored=fr.unexplored, reverse=self.reverse)

    def activate(self, sg: SemGraph, state: State, policy: ExecutionPolicy):
        """Optional post-apply activation multicast: ``(state', IOStats|None)``."""
        return state, None

    def prepare_policy(self, sg: SemGraph,
                       policy: ExecutionPolicy) -> ExecutionPolicy:
        return policy

    def max_supersteps(self, sg: SemGraph) -> int:
        return sg.n + 1

    def finalize(self, sg: SemGraph, state: State):
        return state


def run_program(
    sg: SemGraph,
    prog: VertexProgram,
    policy: Optional[ExecutionPolicy] = None,
    *,
    seeds=None,
    max_supersteps: Optional[int] = None,
    checkpoint=None,
) -> ProgramResult:
    """The BSP driver: one loop iteration is one superstep::

        fr                = prog.frontier(sg, state)
        gathered, io_g    = prog.gather(sg, state, fr, policy)   # traverse()
        state, activated  = prog.apply(sg, state, gathered)
        state, io_a       = prog.activate(sg, state, policy)
        done              = prog.converged(sg, state, activated)

    The semantics are the reference's inline ``lax.while_loop``: the loop
    runs while not converged and under the budget (``max_supersteps``, else
    ``prog.max_supersteps``), ``check_initial_convergence`` may stop it
    before the first superstep, and ``IOStats.supersteps`` counts the
    iterations.  ``policy`` falls back to ``prog.default_policy``, then to
    a plain :class:`ExecutionPolicy`; ``prog.prepare_policy`` pins the
    fields the algorithm owns.  A ``residency='host'`` policy or a host
    view runs :func:`repro_torch.core.residency.run_program_host`, the same
    loop over streamed supersteps.
    """
    if checkpoint is not None:
        raise NotImplementedError("checkpointed runs: ROADMAP A12")
    pol = policy if policy is not None else prog.default_policy
    pol = pol if pol is not None else ExecutionPolicy()
    if pol.residency == "host" or getattr(sg, "is_host_view", False):
        # run_program_host validates the policy/view pairing.
        from .residency import run_program_host

        return run_program_host(sg, prog, pol, seeds=seeds,
                                max_supersteps=max_supersteps)
    return bsp_loop(sg, prog, prog.prepare_policy(sg, pol), seeds=seeds,
                    max_supersteps=max_supersteps)


def bsp_loop(sg, prog: VertexProgram, pol: ExecutionPolicy, *, seeds,
             max_supersteps: Optional[int]) -> ProgramResult:
    """The superstep loop of :func:`run_program` under a prepared policy,
    on a device or a host view alike (the traverse inside ``gather`` and
    ``activate`` routes by residency)."""
    state = prog.init(sg, seeds)
    budget = max_supersteps if max_supersteps is not None \
        else prog.max_supersteps(sg)
    io = IOStats.zero(sg.device)
    done = (bool(prog.converged(sg, state, None))
            if prog.check_initial_convergence else False)
    it = 0
    while not done and it < budget:
        fr = prog.frontier(sg, state)
        gathered, st = prog.gather(sg, state, fr, pol)
        state, activated = prog.apply(sg, state, gathered)
        state, st_act = prog.activate(sg, state, pol)
        io = io + st
        if st_act is not None:
            io = io + st_act
        io = io._replace(supersteps=i32(io.supersteps.to(torch.int64) + 1))
        done = bool(prog.converged(sg, state, activated))
        it += 1
    return ProgramResult(prog.finalize(sg, state),
                         torch.tensor(it, dtype=torch.int32), io, state)
