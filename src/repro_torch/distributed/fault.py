"""Fault tolerance: supervisor loop, elastic re-mesh, straggler mitigation
(torch port of ``repro.distributed.fault``).

Events are *injected* so the recovery machinery itself is exercised end to
end by tests and ``chip_smoke.py``:

  * **Crash-restart** — any step may raise :class:`DeviceFailure`.  The
    supervisor restores the newest complete checkpoint and replays from
    there; with a pure ``batch_fn(step)`` replay is exact.
  * **Elastic re-mesh** — recovery may come up at another ``scale`` (a
    node lost).  ``make_step(scale)`` rebuilds the step; checkpoints store
    whole arrays, so restore needs no knowledge of the old layout.
  * **Straggler mitigation** — per-step deadline from a moving median.
    A step exceeding ``straggler_factor`` x median is logged; after
    ``straggler_patience`` consecutive violations the supervisor evicts
    the slow node through the elastic path.

:func:`supervise_workers` runs real OS worker processes over a
:class:`~repro_torch.core.workqueue.DurableWorkQueue`.  They start from a
``multiprocessing`` *spawn* context: the parent may hold a live CUDA
context, which a forked child must not inherit.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Optional

from ..checkpoint import CheckpointManager

__all__ = ["ChaosReport", "DeviceFailure", "FailurePlan", "Supervisor",
           "SupervisorReport", "supervise_workers"]


class DeviceFailure(RuntimeError):
    """Simulated loss of a device/node during a step."""


@dataclasses.dataclass
class FailurePlan:
    """Injected events: {step: kind} with kind in 'crash' | 'crash_shrink'
    | 'straggle' | 'sigkill'.  Each event fires once.

    'crash'/'crash_shrink'/'straggle' raise/flag inside the process (the
    unwind still runs — async checkpoint waits, context managers close).
    'sigkill' (interpreted by ``recovery.maybe_fail``) kills the process
    with an uncatchable signal — no unwind, no flush — modelling the OOM
    killer / ``kill -9`` that multi-process fault tolerance must survive;
    pair it with OS-level workers (``run_workers(processes=...)``) and
    the :func:`supervise_workers` chaos harness."""

    events: dict

    def pop(self, step: int) -> Optional[str]:
        return self.events.pop(step, None)


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    remesh_events: int = 0
    straggler_events: int = 0
    evictions: int = 0
    final_scale: float = 1.0
    log: list = dataclasses.field(default_factory=list)


class Supervisor:
    """Drives a train loop to ``total_steps`` through injected failures.

    Args:
      ckpt: CheckpointManager for the run.
      make_step: scale -> step_fn(state, batch) -> (state, metrics).  Called
        again after every re-mesh.
      init_state: scale -> fresh state (used only when no checkpoint exists).
      batch_fn: step -> batch (pure; the stateless pipeline).
      mesh_factory: scale -> mesh-like handle passed through to make_step.
    """

    def __init__(
        self,
        ckpt: CheckpointManager,
        make_step: Callable[[float], Callable],
        init_state: Callable[[float], Any],
        batch_fn: Callable[[int], Any],
        *,
        checkpoint_every: int = 10,
        straggler_factor: float = 3.0,
        straggler_patience: int = 3,
        plan: Optional[FailurePlan] = None,
    ):
        self.ckpt = ckpt
        self.make_step = make_step
        self.init_state = init_state
        self.batch_fn = batch_fn
        self.checkpoint_every = checkpoint_every
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.plan = plan or FailurePlan({})

    def run(self, total_steps: int) -> tuple[Any, SupervisorReport]:
        rep = SupervisorReport()
        scale = 1.0
        state, start = self._restore_or_init(scale, rep)
        step_fn = self.make_step(scale)
        durations: list = []
        slow_streak = 0
        step = start
        while step < total_steps:
            batch = self.batch_fn(step)
            event = self.plan.pop(step)
            t0 = time.perf_counter()
            try:
                if event in ("crash", "crash_shrink"):
                    raise DeviceFailure(f"injected at step {step}")
                state, metrics = step_fn(state, batch)
                if event == "straggle":  # injected slow step
                    time.sleep(min(self._deadline(durations), 0.2) * 1.5 + 0.01)
            except DeviceFailure as e:
                rep.restarts += 1
                rep.log.append(f"step {step}: {e}; restoring")
                if event == "crash_shrink":
                    scale *= 0.5  # lost a node: come back degraded
                    rep.remesh_events += 1
                    rep.log.append(f"elastic re-mesh at scale {scale}")
                self.ckpt.wait()
                state, step = self._restore_or_init(scale, rep)
                step_fn = self.make_step(scale)
                durations.clear()
                slow_streak = 0
                continue
            dt = time.perf_counter() - t0
            # --- straggler detection on a moving median ---
            if len(durations) >= 5 and dt > self._deadline(durations):
                rep.straggler_events += 1
                slow_streak += 1
                rep.log.append(f"step {step}: straggler ({dt * 1e3:.1f} ms)")
                if slow_streak >= self.straggler_patience:
                    rep.evictions += 1
                    rep.remesh_events += 1
                    scale *= 0.5
                    rep.log.append(
                        f"step {step}: evicting persistent straggler; "
                        f"re-mesh at scale {scale}"
                    )
                    self.ckpt.save(step + 1, state)
                    state, step = self._restore_or_init(scale, rep)
                    step_fn = self.make_step(scale)
                    durations.clear()
                    slow_streak = 0
                    continue
            else:
                slow_streak = 0
                durations.append(dt)
                if len(durations) > 50:
                    durations.pop(0)
            step += 1
            rep.steps_run += 1
            if step % self.checkpoint_every == 0:
                self.ckpt.save(step, state, blocking=False)
        self.ckpt.wait()
        self.ckpt.save(total_steps, state)
        rep.final_scale = scale
        return state, rep

    def _deadline(self, durations: list) -> float:
        if len(durations) < 5:
            return float("inf")
        return self.straggler_factor * statistics.median(durations)

    def _restore_or_init(self, scale: float, rep: SupervisorReport):
        target = self.init_state(scale)
        try:
            state, step = self.ckpt.restore(target)
            rep.log.append(f"restored step {step} at scale {scale}")
            return state, step
        except FileNotFoundError:
            return target, 0


# --------------------------------------------------------------------------
# multi-process chaos supervision (OS workers over the durable queue)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ChaosReport:
    """What a :func:`supervise_workers` pool lived through.

    ``stale_rejections`` aggregates the workers' refused late commits —
    the chaos gate asserts it is >0 under stall injection (proof the
    token check actually fired, not that the race never happened);
    ``kills`` counts abnormal child exits (SIGKILL shows as -9)."""

    num_workers: int = 0
    spawned: int = 0
    restarts: int = 0
    kills: int = 0
    completed: int = 0
    stale_rejections: int = 0
    leases: int = 0
    dead_letters: list = dataclasses.field(default_factory=list)
    finished: bool = False
    log: list = dataclasses.field(default_factory=list)


def supervise_workers(
    queue,
    work_fn: Callable[[Any], Any],
    *,
    num_workers: int = 3,
    faults: Optional[dict] = None,
    poll: float = 0.05,
    max_spawns: Optional[int] = None,
    timeout: float = 300.0,
) -> ChaosReport:
    """Run ``num_workers`` real OS processes over a ``DurableWorkQueue``
    and keep the pool at strength until the queue finishes: any child
    that exits abnormally (SIGKILL'd by a fault injection, OOM-killed,
    crashed) is replaced with a fresh worker, which resumes from the
    filesystem state alone — the supervisor holds NO sweep progress.

    Spawn context, not fork: a forked child would inherit the parent's
    CUDA context and threads mid-flight; spawned workers re-import and
    rebuild their own sessions from the picklable task payloads.

    ``max_spawns`` bounds total process creation (default: enough for
    every task to fail ``max_attempts`` times); ``timeout`` bounds the
    whole run — on expiry the pool is terminated and the report says
    ``finished=False`` rather than hanging a test suite forever.
    """
    import multiprocessing as mp

    from ..core.workqueue import DurableWorkQueue, _durable_worker_main

    if not isinstance(queue, DurableWorkQueue):
        raise TypeError("supervise_workers needs a DurableWorkQueue")
    ctx = mp.get_context("spawn")
    cfg = {
        "lease_timeout": queue.lease_timeout,
        "max_attempts": queue.max_attempts,
        "result_template": queue.result_template,
    }
    if max_spawns is None:
        max_spawns = num_workers + queue.num_tasks * queue.max_attempts
    rep = ChaosReport(num_workers=num_workers)

    def spawn(wid: str):
        p = ctx.Process(
            target=_durable_worker_main,
            args=(str(queue.root), queue.tasks, cfg, work_fn, wid,
                  faults or {}, poll),
            daemon=True,
        )
        p.start()
        rep.spawned += 1
        rep.log.append(f"spawned {wid} (pid {p.pid})")
        return p

    procs = {f"w{i}": spawn(f"w{i}") for i in range(num_workers)}
    deadline = time.monotonic() + timeout
    try:
        while procs and time.monotonic() < deadline:
            for wid, p in list(procs.items()):
                p.join(timeout=poll)
                if p.is_alive():
                    continue
                del procs[wid]
                if p.exitcode != 0:
                    rep.kills += 1
                    rep.log.append(f"{wid} died (exit {p.exitcode})")
                    if not queue.finished and rep.spawned < max_spawns:
                        rep.restarts += 1
                        nwid = f"{wid}r{rep.restarts}"
                        procs[nwid] = spawn(nwid)
                else:
                    rep.log.append(f"{wid} exited clean")
    finally:
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            p.join(timeout=5.0)
    rep.finished = queue.finished
    rep.dead_letters = queue.dead_letters
    for stats in queue.read_stats().values():
        rep.completed += int(stats.get("completed", 0))
        rep.stale_rejections += int(stats.get("stale", 0))
        rep.leases += int(stats.get("leases", 0))
    return rep
