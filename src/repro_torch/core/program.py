"""The vertex-program layer (torch port of ``repro.core.program``).

A :class:`VertexProgram` says WHAT one superstep means (frontier, apply,
convergence); :func:`run_program` owns HOW supersteps execute — a Python
loop over supersteps, each asking the program for its frontier, executing
the multicast through :func:`repro_torch.core.engine.traverse`, applying
the update, accumulating :class:`~repro_torch.core.sem.IOStats` and
testing convergence.  The convergence test reads one device scalar per
superstep.  :func:`run_program_batched` runs the same superstep over Q
query columns, retiring converged columns as it goes.
"""
from __future__ import annotations

import functools
import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .engine import ExecutionPolicy, as_policy, check_residency, traverse
from .sem import IOStats, SemGraph, i32
from .semiring import PLUS_TIMES, Semiring

__all__ = ["Frontier", "ProgramResult", "VertexProgram", "legacy_policy",
           "run_program", "run_program_batched", "warn_legacy"]

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
    (int32 scalar), ``iostats``, the final ``state``, and
    ``query_supersteps``: int32[Q], set only by :func:`run_program_batched`
    (entry q is the superstep at which query column q converged, equal to
    the supersteps of q's solo run, or the total when the budget ran out
    first); ``None`` on unbatched runs."""

    values: Any
    supersteps: torch.Tensor
    iostats: IOStats
    state: Any = None
    query_supersteps: Any = None


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

    def converged_cols(self, sg: SemGraph, state: State,
                       activated) -> torch.Tensor:
        """bool[Q]: which query columns converged this superstep (used by
        :func:`run_program_batched`).  Default: the column activated
        nothing, the column-wise form of ``converged``."""
        return ~torch.any(activated, dim=0)

    def take_cols(self, state: State, cols, width: int) -> State:
        """Query columns ``cols`` of an (n, ``width``)-batched state: every
        tensor leaf whose last dimension is ``width`` is sliced, anything
        else (scalars, O(n) vectors) passes through.  A program whose state
        has a non-query axis of size ``width`` must override this."""
        return _map_leaves(lambda a: _slice_cols(a, cols, width), state)

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
    resume: bool = False,
    _plan=None,
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

    ``checkpoint=CheckpointSpec(...)`` snapshots the run every ``every_k``
    supersteps (state, frontier, accumulated IOStats, superstep) through
    :mod:`repro_torch.core.recovery`; ``resume=True`` restores the newest
    complete snapshot and continues, bitwise-equal to an uninterrupted run
    on every backend and both residencies.  ``_plan`` is the supervisor's
    fault-injection channel (:func:`~repro_torch.core.recovery.
    run_supervised`); user code leaves it None.
    """
    from .recovery import checkpoint_ctx

    pol = policy if policy is not None else prog.default_policy
    pol = pol if pol is not None else ExecutionPolicy()
    if pol.residency == "host" or getattr(sg, "is_host_view", False):
        # run_program_host validates the policy/view pairing.
        from .residency import run_program_host

        return run_program_host(sg, prog, pol, seeds=seeds,
                                max_supersteps=max_supersteps,
                                checkpoint=checkpoint, resume=resume,
                                _plan=_plan)
    pol = prog.prepare_policy(sg, pol)
    return bsp_loop(sg, prog, pol, seeds=seeds, max_supersteps=max_supersteps,
                    ctx=checkpoint_ctx(checkpoint, sg, prog, pol, seeds),
                    resume=resume, plan=_plan)


def superstep(sg, prog: VertexProgram, pol: ExecutionPolicy, state, io):
    """One superstep of every driver: frontier, gather, apply, activate,
    with the IOStats of both multicasts and one more superstep counted.
    Returns ``(state', io', activated)``."""
    fr = prog.frontier(sg, state)
    gathered, st = prog.gather(sg, state, fr, pol)
    state, activated = prog.apply(sg, state, gathered)
    state, st_act = prog.activate(sg, state, pol)
    io = io + st
    if st_act is not None:
        io = io + st_act
    io = io._replace(supersteps=i32(io.supersteps.to(torch.int64) + 1))
    return state, io, activated


def bsp_loop(sg, prog: VertexProgram, pol: ExecutionPolicy, *, seeds,
             max_supersteps: Optional[int], ctx=None, resume: bool = False,
             plan=None) -> ProgramResult:
    """The superstep loop of :func:`run_program` under a prepared policy,
    on a device or a host view alike (the traverse inside ``gather`` and
    ``activate`` routes by residency).

    ``ctx`` (a :mod:`~repro_torch.core.recovery` checkpoint channel)
    snapshots the run when due and, with ``resume``, restores the newest
    snapshot first; ``plan`` injects failures before supersteps."""
    from .recovery import maybe_fail

    state = prog.init(sg, seeds)
    budget = max_supersteps if max_supersteps is not None \
        else prog.max_supersteps(sg)
    io = IOStats.zero(sg.device)
    done = (bool(prog.converged(sg, state, None))
            if prog.check_initial_convergence else False)
    it = 0
    if resume and ctx is not None:
        hit = ctx.try_restore(sg, state)
        if hit is not None:
            state, io, it, finished = hit
            if finished:
                return ProgramResult(prog.finalize(sg, state),
                                     torch.tensor(it, dtype=torch.int32), io,
                                     state)
            done = False  # an unfinished snapshot is mid-loop by definition
    try:
        while not done and it < budget:
            maybe_fail(plan, it)
            state, io, activated = superstep(sg, prog, pol, state, io)
            done = bool(prog.converged(sg, state, activated))
            it += 1
            finished = done or it >= budget
            if ctx is not None and ctx.due(it, finished):
                ctx.save(it, finished, state, io,
                         _union(prog.frontier(sg, state).active))
    except BaseException:
        if ctx is not None:
            ctx.wait()  # drain any in-flight async save before unwinding
        raise
    if ctx is not None:
        ctx.close(sg, it, state, io)
    return ProgramResult(prog.finalize(sg, state),
                         torch.tensor(it, dtype=torch.int32), io, state)


def _union(active: torch.Tensor) -> torch.Tensor:
    """The 1-D union of a (possibly (n, Q)-batched) frontier mask."""
    return torch.any(active, dim=-1) if active.ndim > 1 else active


# --------------------------------------------------------------------------
# the batched multi-source driver
# --------------------------------------------------------------------------
def _map_leaves(fn, *trees):
    """``fn`` over the leaves of equally shaped trees (NamedTuples, tuples,
    lists and dicts are nodes, anything else a leaf), as
    ``jax.tree_util.tree_map`` walks a state."""
    t = trees[0]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_map_leaves(fn, *c) for c in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_map_leaves(fn, *c) for c in zip(*trees))
    if isinstance(t, dict):
        return {k: _map_leaves(fn, *(tr[k] for tr in trees)) for k in t}
    return fn(*trees)


def _is_cols(a, width: int) -> bool:
    """True for a tensor leaf whose last dimension is the query axis."""
    return isinstance(a, torch.Tensor) and a.ndim >= 1 \
        and a.shape[-1] == width


def _slice_cols(a, cols, width: int):
    if _is_cols(a, width):
        return a[..., torch.as_tensor(cols, dtype=torch.long,
                                      device=a.device)]
    return a


def _pow2_at_least(k: int) -> int:
    g = 1
    while g < max(1, k):
        g *= 2
    return g


def _reassemble_values(parts, Q: int):
    """Stitch per-part finalized values (each with a trailing column axis)
    back into original column order.  ``parts`` is a list of
    ``(orig_cols, values)``; leaves whose trailing dim is not the part's
    column count (per-run scalars) take the last part's value."""
    order = np.concatenate([np.asarray(c, np.int64) for c, _ in parts])
    perm = torch.as_tensor(np.argsort(order), dtype=torch.long)
    widths = [len(c) for c, _ in parts]

    def cat(*leaves):
        if all(_is_cols(a, w) for a, w in zip(leaves, widths)):
            return torch.cat(leaves, dim=-1)[..., perm.to(leaves[0].device)]
        return leaves[-1]

    return _map_leaves(cat, *(v for _, v in parts))


def run_program_batched(
    sg: SemGraph,
    prog: VertexProgram,
    policy: Optional[ExecutionPolicy] = None,
    *,
    seeds=None,
    max_supersteps: Optional[int] = None,
    checkpoint=None,
    resume: bool = False,
    _plan=None,
) -> ProgramResult:
    """The Q-query driver: one superstep loop serving Q query columns, each
    streamed chunk or tile serving all of them.

    The program's state and frontier carry a trailing query axis
    (``frontier().active`` is (n, Q)); each superstep is
    :func:`run_program`'s, plus:

      * per-query convergence: ``prog.converged_cols`` gives a bool[Q]
        mask per superstep, and ``ProgramResult.query_supersteps[q]`` is
        the superstep at which column q converged (its solo run's count:
        a column's frontier evolves as its solo frontier, the union fetch
        only adds identity contributions from other lanes);
      * retirement: once the live columns fit a smaller power of two they
        are compacted into it (``prog.take_cols``), padded with a
        converged column (inactive, so it adds no fetch); retired columns'
        values are captured then and stitched back into source order at
        the end.  So the kernels see at most ``log2(Q) + 1`` lane widths;
      * ``IOStats.queries`` is stamped Q at exit, so any counter over
        ``queries`` is the per-query cost the batching amortizes.

    On a host view under a host policy the same superstep streams the
    union of the live frontiers from host RAM (the traverse routes to
    :func:`repro_torch.core.residency.host_traverse`); a mismatched view
    and policy raise :class:`~repro_torch.core.engine.ResidencyError`.
    ``ProgramResult.state`` is the final full-width state when no column
    retired, ``None`` otherwise.

    ``checkpoint``/``resume``/``_plan`` are :func:`run_program`'s.  With
    ``checkpoint`` set, retirement is off (snapshots need a fixed (n, Q)
    schema): the run stays at width Q, converged columns ride along
    inactive, and each snapshot holds the state, ``done_at`` and the 1-D
    union of the live frontiers.
    """
    from .recovery import checkpoint_ctx, maybe_fail

    pol = policy if policy is not None else prog.default_policy
    pol = pol if pol is not None else ExecutionPolicy()
    check_residency(sg, pol)  # a host view runs under a host policy only
    pol = prog.prepare_policy(sg, pol)
    step = functools.partial(superstep, sg, prog, pol)
    state = prog.init(sg, seeds)
    active0 = prog.frontier(sg, state).active
    if active0.ndim != 2:
        raise ValueError(
            "run_program_batched needs an (n, Q)-batched program: "
            f"frontier().active has shape {tuple(active0.shape)}"
        )
    Q = int(active0.shape[-1])
    budget = int(max_supersteps if max_supersteps is not None
                 else prog.max_supersteps(sg))
    ctx = checkpoint_ctx(checkpoint, sg, prog, pol, seeds)

    def wrap(state, done_at):
        return {"done_at": torch.as_tensor(done_at.astype(np.int32)),
                "state": state}

    done_at = np.full(Q, -1, np.int64)
    io = IOStats.zero(sg.device)
    it = 0
    done = (bool(prog.converged(sg, state, None))
            if prog.check_initial_convergence else False)
    if done:
        done_at[:] = 0
    if resume and ctx is not None:
        hit = ctx.try_restore(sg, wrap(state, done_at))
        if hit is not None:
            wrapped, io, it, finished = hit
            state = wrapped["state"]
            done_at = wrapped["done_at"].numpy().astype(np.int64)
            if finished:
                return ProgramResult(
                    prog.finalize(sg, state),
                    torch.tensor(it, dtype=torch.int32),
                    io._replace(queries=i32(Q).to(sg.device)), state,
                    torch.as_tensor(done_at.astype(np.int32)))
            done = False  # an unfinished snapshot is mid-loop by definition
    retire = ctx is None  # snapshots need a fixed (n, Q) schema
    cur = list(range(Q))  # original column at each live position
    width = Q  # current (pow2-padded) column count of `state`
    parts = []  # (orig cols, finalized values) captured at retirement
    try:
        while not done and it < budget:
            maybe_fail(_plan, it)
            state, io, activated = step(state, io)
            conv = prog.converged_cols(sg, state, activated).cpu().numpy()
            it += 1
            for i, q in enumerate(cur):
                if conv[i] and done_at[q] < 0:
                    done_at[q] = it
            live = [i for i, q in enumerate(cur) if done_at[q] < 0]
            done = not live
            g = _pow2_at_least(len(live))
            if retire and not done and g < width:
                dropped = [i for i, q in enumerate(cur) if done_at[q] >= 0]
                parts.append(([cur[i] for i in dropped], prog.finalize(
                    sg, prog.take_cols(state, dropped, width))))
                state = prog.take_cols(
                    state, live + [dropped[0]] * (g - len(live)), width)
                cur = [cur[i] for i in live]
                width = g
            finished = done or it >= budget
            if finished:
                done_at[done_at < 0] = it  # budget-exhausted columns
            if ctx is not None and ctx.due(it, finished):
                ctx.save(it, finished, wrap(state, done_at), io,
                         _union(prog.frontier(sg, state).active))
    except BaseException:
        if ctx is not None:
            ctx.wait()  # drain any in-flight async save before unwinding
        raise
    done_at[done_at < 0] = it  # zero-superstep exits
    if ctx is not None:
        ctx.close(sg, it, wrap(state, done_at), io)

    io = io._replace(queries=i32(Q).to(sg.device))
    if parts:
        parts.append((cur, prog.finalize(
            sg, prog.take_cols(state, list(range(len(cur))), width))))
        values, final_state = _reassemble_values(parts, Q), None
    else:
        values, final_state = prog.finalize(sg, state), state
    return ProgramResult(values, torch.tensor(it, dtype=torch.int32), io,
                         final_state, torch.as_tensor(done_at.astype(np.int32)))


# --------------------------------------------------------------------------
# deprecation plumbing of the pre-façade entry points
# --------------------------------------------------------------------------
def warn_legacy(entry: str, replacement: str, *, kwargs: Optional[dict] = None,
                stacklevel: int = 3) -> None:
    """The library's one :class:`DeprecationWarning`, worded as the
    reference's: every deprecated shim (``bfs_multi``, ``pagerank_push``,
    ``bc_*``, ``coreness``, ``diameter_*``) funnels through here.
    ``kwargs`` are the deprecated keyword arguments the caller passed
    (non-``None`` values), named with their :class:`ExecutionPolicy`
    replacement; ``stacklevel`` lands the warning on the user's call."""
    dead = sorted(k for k, v in (kwargs or {}).items() if v is not None)
    msg = f"{entry} is deprecated; use {replacement}"
    if dead:
        msg += (
            f" (deprecated kwarg{'s' if len(dead) > 1 else ''} "
            f"{', '.join(dead)}: set the ExecutionPolicy field instead)"
        )
    warnings.warn(msg, DeprecationWarning, stacklevel=stacklevel)


def legacy_policy(
    entry: str,
    replacement: str,
    policy: Optional[ExecutionPolicy],
    default: Optional[ExecutionPolicy],
    **deprecated,
) -> ExecutionPolicy:
    """Warn (:func:`warn_legacy`) and merge a legacy call's kwargs into a
    policy (:func:`~repro_torch.core.engine.as_policy`)."""
    warn_legacy(entry, replacement, kwargs=deprecated, stacklevel=4)
    return as_policy(policy, default, **deprecated)
