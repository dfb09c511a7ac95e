"""Fault-tolerant BSP: superstep checkpointing, resume-exact runs, and an
injected-failure supervisor (torch port of ``repro.core.recovery``).

  * **CheckpointSpec** — a frozen description of the checkpoint cadence.
    ``run_program(..., checkpoint=spec)`` snapshots ``(superstep, frontier
    active mask, program state, accumulated IOStats, finished flag)``
    every ``every_k`` supersteps through the atomic
    :class:`~repro_torch.checkpoint.CheckpointManager` (tmp+rename,
    optionally written by a background thread), and ``resume=True``
    restores the newest complete superstep and continues.

  * **Resume-exactness** — a resumed run is *bitwise-equal* (values, total
    supersteps, full IOStats including ``host_bytes``) to an uninterrupted
    run, on every backend and both residencies.  The port's driver is one
    eager loop over :func:`~repro_torch.core.program.superstep` (the
    reference needs segments of one traced ``lax.while_loop`` for this;
    the eager loop is already the one body), so the checkpointed driver is
    that loop with a save hook and :func:`maybe_fail`.  Every superstep is
    a deterministic function of the state (the sum scatter adds in a fixed
    order on the card, :meth:`~repro_torch.core.semiring.Semiring.scatter`),
    and the accumulated ledger is part of the snapshot: work done between
    the restored checkpoint and the crash is replayed, not double-counted.

  * **Fingerprinting** — every snapshot carries a fingerprint of the
    (graph, policy, program, seeds) identity in its ``extra.json``;
    ``resume=True`` against a directory written by another run raises
    :class:`CheckpointMismatchError` naming the mismatched component.

  * **Supervision** — :func:`run_supervised` drives a run through the
    ``FailurePlan``/``DeviceFailure`` injections of
    :mod:`repro_torch.distributed.fault`: the driver raises at injected
    supersteps, the supervisor replays from the newest checkpoint.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, latest_step, load_extra
from ..checkpoint.store import _flatten
from ..distributed.fault import DeviceFailure, FailurePlan
from .engine import ExecutionPolicy
from .sem import IOStats

__all__ = [
    "CheckpointMismatchError",
    "CheckpointSpec",
    "DeviceFailure",
    "FailurePlan",
    "RecoveryReport",
    "maybe_fail",
    "run_fingerprint",
    "run_program_checkpointed",
    "run_supervised",
]


class CheckpointMismatchError(RuntimeError):
    """``resume=True`` met a checkpoint written by a *different* run —
    another graph, policy, program, or seed set.  Restoring it would
    silently produce garbage, so the mismatch is an error naming the
    offending component(s)."""


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """How (and how often) a BSP run checkpoints.

    Attributes:
      directory: checkpoint root for this run (one run per directory —
        the fingerprint guard enforces it on resume).
      every_k: snapshot cadence in supersteps.  Convergence and budget
        exhaustion always snapshot (with ``finished=True``).
      keep: newest complete snapshots retained.
      async_save: hand serialization to a background thread (the copy of
        the state off the live tensors is the only synchronous part).  The
        final (finished) snapshot is always written blocking.
      max_shard_bytes: stream snapshots out in fsync'd shards of at most
        this many bytes each.
      delta: skip state pieces unchanged since the previous complete step.
      telemetry: optional mutable dict the driver fills with ``sync_s``
        (seconds of the checkpoint layer on the hot path: snapshot,
        serialize, wait) and ``saves``; shared across ``child()`` phases,
        excluded from equality/repr.
    """

    directory: str | Path
    every_k: int = 8
    keep: int = 3
    async_save: bool = True
    max_shard_bytes: Optional[int] = None
    delta: bool = False
    telemetry: Optional[dict] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if int(self.every_k) < 1:
            raise ValueError("every_k must be >= 1")
        if int(self.keep) < 1:
            raise ValueError("keep must be >= 1")
        if self.max_shard_bytes is not None and int(self.max_shard_bytes) < 1:
            raise ValueError("max_shard_bytes must be >= 1 (or None)")

    def child(self, name: str) -> "CheckpointSpec":
        """A sub-spec rooted at ``directory/name`` (betweenness phases,
        per-group sweeps)."""
        return dataclasses.replace(self, directory=Path(self.directory) / name)


@dataclasses.dataclass
class RecoveryReport:
    """What :func:`run_supervised` lived through."""

    restarts: int = 0
    resumed_steps: list = dataclasses.field(default_factory=list)
    log: list = dataclasses.field(default_factory=list)


# --------------------------------------------------------------------------
# fingerprinting
# --------------------------------------------------------------------------
def _sha(*parts: bytes) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(p)
    return h.hexdigest()


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _config_item(value):
    """A program attribute as fingerprint text: tensors and arrays by
    their bytes (``repr`` of a card tensor syncs and truncates)."""
    if isinstance(value, (torch.Tensor, np.ndarray)):
        a = _np(value)
        return ("array", str(a.dtype), a.shape,
                _sha(np.ascontiguousarray(a).tobytes()))
    return value


def run_fingerprint(sg, prog, pol: ExecutionPolicy, seeds) -> dict:
    """Identity of a BSP run, per component.  The ``graph`` (n, m and the
    int32 degree vectors) and ``seeds`` components hash the same bytes as
    the reference's; ``policy`` and ``program`` hash their config text."""
    gparts = [np.int64(sg.n).tobytes(), np.int64(sg.m).tobytes(),
              _np(sg.out_degree).astype(np.int32).tobytes()]
    in_deg = getattr(sg, "in_degree", None)
    if in_deg is not None:
        gparts.append(_np(in_deg).astype(np.int32).tobytes())
    sparts = []
    for leaf in _flatten(seeds)[0]:  # JAX's leaf order
        a = _np(leaf)
        sparts += [str(a.dtype).encode(), np.asarray(a.shape).tobytes(),
                   a.tobytes()]
    config = sorted((k, _config_item(v)) for k, v in prog.__dict__.items())
    return {
        "graph": _sha(*gparts),
        "policy": _sha(repr(pol).encode()),
        "program": _sha(
            type(prog).__module__.encode(),
            type(prog).__qualname__.encode(),
            repr(config).encode(),
        ),
        "seeds": _sha(*sparts) if sparts else "none",
    }


# --------------------------------------------------------------------------
# checkpoint context (shared by the device and host drivers)
# --------------------------------------------------------------------------
class _CheckpointCtx:
    """One run's checkpoint channel: manager + fingerprint + snapshot
    schema.  The snapshot tree is ``{finished, frontier, io, it, state}``
    (the reference's), so restore targets rebuild from ``prog.init``."""

    def __init__(self, spec: CheckpointSpec, fp: dict):
        self.spec = spec
        self.fp = fp
        self.mgr = CheckpointManager(
            spec.directory, keep=spec.keep,
            max_shard_bytes=spec.max_shard_bytes, delta=spec.delta,
            telemetry=spec.telemetry)
        if spec.telemetry is not None:
            spec.telemetry.setdefault("sync_s", 0.0)
            spec.telemetry.setdefault("saves", 0)

    def due(self, it: int, finished: bool) -> bool:
        return finished or (it % self.spec.every_k == 0 and it > 0)

    def _clock(self, t0: float) -> None:
        if self.spec.telemetry is not None:
            self.spec.telemetry["sync_s"] += time.perf_counter() - t0

    def save(self, it: int, finished: bool, state, io: IOStats,
             frontier_active) -> None:
        t0 = time.perf_counter()
        tree = {
            "finished": np.asarray(bool(finished)),
            "frontier": frontier_active,
            "io": io,
            "it": np.asarray(int(it), np.int32),
            "state": state,
        }
        extra = dict(self.fp, superstep=int(it), finished=bool(finished))
        self.mgr.save(int(it), tree,
                      blocking=bool(finished) or not self.spec.async_save,
                      extra=extra)
        if self.spec.telemetry is not None:
            self.spec.telemetry["saves"] += 1
        self._clock(t0)

    def try_restore(self, sg, state_template):
        """Newest complete snapshot -> (state, io, it, finished), or None
        when the directory holds none.  The fingerprint is checked BEFORE
        any array is read."""
        step = latest_step(self.spec.directory)
        if step is None:
            return None
        extra = load_extra(self.spec.directory, step) or {}
        bad = [k for k in ("graph", "policy", "program", "seeds")
               if extra.get(k) != self.fp[k]]
        if bad:
            raise CheckpointMismatchError(
                f"checkpoint at {self.spec.directory} (step {step}) was "
                f"written by a different run: {', '.join(bad)} "
                f"fingerprint(s) differ.  Resuming it would silently "
                f"produce garbage; point `checkpoint` at a fresh directory "
                f"or pass resume=False to start over."
            )
        dev = sg.device
        target = {
            "finished": np.zeros((), bool),
            "frontier": torch.zeros(sg.n, dtype=torch.bool, device=dev),
            "io": IOStats.zero(dev),
            "it": np.zeros((), np.int32),
            "state": state_template,
        }
        tree, _ = self.mgr.restore(target)
        return (tree["state"], tree["io"], int(tree["it"]),
                bool(tree["finished"]))

    def wait(self) -> None:
        t0 = time.perf_counter()
        self.mgr.wait()
        self._clock(t0)

    def close(self, sg, it: int, state, io: IOStats) -> None:
        """End of a run: a zero-superstep run still leaves a restorable
        (finished) record; then drain the in-flight save."""
        if it == 0:
            self.save(0, True, state, io, torch.zeros(
                sg.n, dtype=torch.bool, device=sg.device))
        self.wait()


def maybe_fail(plan: Optional[FailurePlan], it: int) -> None:
    """Raise the injected :class:`DeviceFailure` scheduled for superstep
    ``it`` (fires once).  The injection point of every BSP driver.

    Kind ``'sigkill'`` kills the *process* with an uncatchable SIGKILL, as
    an OOM kill or a ``kill -9`` would: no unwind runs, and whatever the
    checkpoint layer had not yet published is lost."""
    if plan is None:
        return
    kind = plan.pop(it)
    if kind is None:
        return
    if kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    raise DeviceFailure(f"injected at superstep {it}")


def checkpoint_ctx(checkpoint: Optional[CheckpointSpec], sg, prog, pol,
                   seeds) -> Optional[_CheckpointCtx]:
    """The run's checkpoint channel under its prepared policy, or None."""
    if checkpoint is None:
        return None
    return _CheckpointCtx(checkpoint, run_fingerprint(sg, prog, pol, seeds))


# --------------------------------------------------------------------------
# the checkpointed driver
# --------------------------------------------------------------------------
def run_program_checkpointed(
    sg,
    prog,
    policy: Optional[ExecutionPolicy] = None,
    *,
    seeds=None,
    max_supersteps: Optional[int] = None,
    checkpoint: Optional[CheckpointSpec] = None,
    resume: bool = False,
    _plan: Optional[FailurePlan] = None,
):
    """The reference's name for :func:`~repro_torch.core.program.
    run_program` with ``checkpoint=``, which carries recovery itself."""
    from .program import run_program

    return run_program(sg, prog, policy, seeds=seeds,
                       max_supersteps=max_supersteps, checkpoint=checkpoint,
                       resume=resume, _plan=_plan)


# --------------------------------------------------------------------------
# the supervisor
# --------------------------------------------------------------------------
def run_supervised(
    sg,
    prog,
    policy: Optional[ExecutionPolicy] = None,
    *,
    seeds=None,
    max_supersteps: Optional[int] = None,
    checkpoint: CheckpointSpec,
    plan: Optional[FailurePlan] = None,
    max_restarts: int = 16,
):
    """Drive a BSP run to completion through injected failures.

    Each :class:`DeviceFailure` (from ``plan``, or a real one surfacing
    out of the driver) triggers a replay from the newest complete
    checkpoint; the final :class:`~repro_torch.core.ProgramResult` is
    bitwise-identical to an uninterrupted run.

    Returns ``(ProgramResult, RecoveryReport)``.
    """
    from .program import run_program

    rep = RecoveryReport()
    plan = plan if plan is not None else FailurePlan({})
    for attempt in range(max_restarts + 1):
        try:
            res = run_program(sg, prog, policy, seeds=seeds,
                              max_supersteps=max_supersteps,
                              checkpoint=checkpoint, resume=(attempt > 0),
                              _plan=plan)
            return res, rep
        except DeviceFailure as e:
            rep.restarts += 1
            step = latest_step(checkpoint.directory)
            rep.resumed_steps.append(step)
            rep.log.append(f"{e}; replaying from "
                           f"{'scratch' if step is None else f'step {step}'}")
    raise DeviceFailure(
        f"gave up after {max_restarts} restarts ({rep.log[-1] if rep.log else ''})"
    )
