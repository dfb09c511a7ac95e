"""Lease-based work queue for multi-source sweeps (torch port of
``repro.core.workqueue``: the same protocol, marker names and snapshots).

Exact betweenness and diameter sweeps are embarrassingly parallel across
source sets — and therefore the natural unit of *elasticity*: a sweep over
512 sources should survive any individual worker dying mid-shard, and
should resume after a full crash without recomputing finished shards.
Following the grandiso-cloud pattern (isolate ALL growing state in one
dropout-resilient queue so unsupervised workers can join, die, and resume
freely), this module keeps every byte of sweep progress in a
:class:`WorkQueue`:

  * **leases, not assignments** — a worker *leases* a task for a bounded
    time; completing it needs the lease token ``(tid, attempt)``, so a
    worker presumed dead whose result arrives late is simply ignored
    (stale token), and a lease that expires puts the task back on the
    queue for anyone else.  Tasks failing ``max_attempts`` times move to
    the dead-letter list instead of wedging the sweep.
  * **order-invariant merge** — per-task results are stored by task id
    and folded in canonical id order, so the merged result is a pure
    function of the task set: bitwise-identical whatever the completion
    order, worker count, or number of mid-sweep deaths.  (The fold order
    is fixed even for non-associative float combines.)
  * **checkpointable** — the queue's growing state (completed mask,
    attempt counts, dead-letter mask, stacked results) is a fixed-shape
    pytree snapshotted through the same atomic store as the BSP drivers
    (:mod:`repro_torch.checkpoint`), with a task-set digest in ``extra.json``
    guarding resume against a different sharding.  Leases are
    deliberately NOT checkpointed: they are promises by workers that died
    with the process, so restart re-issues them — at-least-once execution
    with idempotent (replace-on-complete) results.

Time is injectable (:class:`ManualClock`) so lease expiry is testable
without sleeping.

:class:`DurableWorkQueue` is the multi-process realization of the same
contract: every transition lives on a shared filesystem as an atomic
``os.rename`` (no fcntl locks — rename-with-unique-source is the one
primitive that is atomic-and-exclusive on POSIX *and* NFS), so the queue
survives workers that are real OS processes dying by SIGKILL.  See the
class docstring for the disk layout and the commit protocol.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..checkpoint import (
    CheckpointManager,
    latest_step,
    load_extra,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "DurableWorkQueue",
    "durable_worker_loop",
    "Lease",
    "ManualClock",
    "QueueMismatchError",
    "WorkQueue",
    "run_workers",
    "shard_sources",
]


class QueueMismatchError(RuntimeError):
    """A queue checkpoint was written for a *different* task set (other
    sources, other sharding).  Restoring it would mis-attribute results
    to tasks, so the digest mismatch is an error."""


class ManualClock:
    """A deterministic clock for tests: time moves only when told to."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclasses.dataclass(frozen=True)
class Lease:
    """A worker's bounded claim on one task.  ``(tid, attempt)`` is the
    token: :meth:`WorkQueue.complete` rejects any other attempt's token,
    which is what makes a late result from a presumed-dead worker
    harmless."""

    tid: int
    attempt: int
    payload: Any
    expires: float


class WorkQueue:
    """In-process lease/retry/dead-letter queue over a fixed task list.

    ``tasks`` is a sequence of payloads (for source sweeps: numpy arrays
    of source vertex ids — see :func:`shard_sources`).  ``result_template``
    is a zeros-like array of one task's result shape/dtype; required for
    :meth:`checkpoint`/:meth:`resume` (results stack into one fixed-shape
    array) and for :meth:`merge`'s identity.

    **Clock contract.** ``clock`` defaults to ``time.monotonic``: lease
    expiry is measured on the *real* wall clock unless a test injects a
    :class:`ManualClock`.  A worker that stops calling in (crashed, hung,
    GC-paused past ``lease_timeout``) has its task re-issued by the very
    next ``lease()`` after the timeout elapses — no background reaper
    thread is needed, expiry is evaluated lazily at lease time.  The flip
    side of lazy expiry: a late :meth:`complete` from an expired-but-not-
    yet-reaped lease still commits (nothing observed the expiry), while
    one that arrives after re-issue is rejected by the ``(tid, attempt)``
    token.  Both outcomes are safe because tasks are idempotent; tests
    cover the real-clock path with a tiny ``lease_timeout``.
    """

    def __init__(
        self,
        tasks: Sequence[Any],
        *,
        lease_timeout: float = 30.0,
        max_attempts: int = 3,
        result_template: Optional[np.ndarray] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.tasks = list(tasks)
        self.lease_timeout = float(lease_timeout)
        self.max_attempts = int(max_attempts)
        self.result_template = (
            None if result_template is None else np.asarray(result_template)
        )
        self._clock = clock
        T = len(self.tasks)
        self.completed = np.zeros(T, bool)
        self.attempts = np.zeros(T, np.int32)
        self.dead = np.zeros(T, bool)
        self._results: dict = {}
        self._leases: dict = {}  # tid -> Lease (at most one live per task)
        self._saves = 0

    # ---------------------------------------------------------------- state
    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    @property
    def finished(self) -> bool:
        """Nothing left to lease, now or after any expiry."""
        return bool(np.all(self.completed | self.dead))

    @property
    def dead_letters(self) -> list:
        return [int(t) for t in np.flatnonzero(self.dead)]

    def _expire(self) -> None:
        now = self._clock()
        for tid in [t for t, l in self._leases.items() if l.expires <= now]:
            del self._leases[tid]
            if self.attempts[tid] >= self.max_attempts:
                self.dead[tid] = True

    # ---------------------------------------------------------------- lease
    def lease(self) -> Optional[Lease]:
        """Claim the lowest-id available task, or None when every pending
        task is currently leased (or the queue is finished).  Expired
        leases are reaped first, so a crashed worker's task is re-issued
        by the very next ``lease()`` after its timeout."""
        self._expire()
        for tid in range(len(self.tasks)):
            if (self.completed[tid] or self.dead[tid]
                    or tid in self._leases):
                continue
            self.attempts[tid] += 1
            lease = Lease(tid, int(self.attempts[tid]), self.tasks[tid],
                          self._clock() + self.lease_timeout)
            self._leases[tid] = lease
            return lease
        return None

    def complete(self, lease: Lease, result) -> bool:
        """Commit ``result`` for the leased task.  Returns False (and
        commits nothing) for a stale token — an expired/re-issued lease,
        or a task already completed by another attempt."""
        cur = self._leases.get(lease.tid)
        if (cur is None or cur.attempt != lease.attempt
                or self.completed[lease.tid]):
            return False
        del self._leases[lease.tid]
        self._results[lease.tid] = np.asarray(result)
        self.completed[lease.tid] = True
        self.dead[lease.tid] = False
        return True

    def fail(self, lease: Lease) -> bool:
        """Explicitly give a lease back (worker noticed its own trouble)
        instead of waiting out the timeout.  Same staleness rules as
        :meth:`complete`."""
        cur = self._leases.get(lease.tid)
        if cur is None or cur.attempt != lease.attempt:
            return False
        del self._leases[lease.tid]
        if self.attempts[lease.tid] >= self.max_attempts:
            self.dead[lease.tid] = True
        return True

    # ---------------------------------------------------------------- merge
    def merge(self, combine: Callable[[Any, Any], Any], init=None):
        """Fold completed results in canonical task-id order.

        The fold order is a property of the task SET, never of the
        completion order, so the merge is deterministic across worker
        counts and death schedules even for non-associative float
        combines.  ``init`` defaults to ``zeros_like(result_template)``.
        """
        if init is None:
            if self.result_template is None:
                raise ValueError("merge needs init= or a result_template")
            init = np.zeros_like(self.result_template)
        out = init
        for tid in range(len(self.tasks)):
            if self.completed[tid]:
                out = combine(out, self._results[tid])
        return out

    # ------------------------------------------------------------ persistence
    def _digest(self) -> str:
        h = hashlib.sha1()
        h.update(np.int64(len(self.tasks)).tobytes())
        for t in self.tasks:
            a = np.asarray(t)
            h.update(str(a.dtype).encode())
            h.update(np.asarray(a.shape).tobytes())
            h.update(a.tobytes())
        return h.hexdigest()

    def _require_template(self, what: str) -> np.ndarray:
        if self.result_template is None:
            raise ValueError(f"{what} needs result_template= at construction")
        return self.result_template

    def _state_tree(self) -> dict:
        tpl = self._require_template("checkpoint()")
        stacked = np.zeros((len(self.tasks),) + tpl.shape, tpl.dtype)
        for tid, r in self._results.items():
            stacked[tid] = r
        return {
            "attempts": self.attempts.copy(),
            "completed": self.completed.copy(),
            "dead": self.dead.copy(),
            "results": stacked,
        }

    def checkpoint(self, directory: str | Path, *, keep: int = 2) -> None:
        """Snapshot queue progress through the atomic checkpoint store
        (tmp+rename; a crash mid-save leaves the previous snapshot
        intact).  Live leases are NOT saved — see the module docstring."""
        mgr = CheckpointManager(directory, keep=keep)
        self._saves += 1
        mgr.save(self._saves, self._state_tree(),
                 extra={"tasks": self._digest(),
                        "n_completed": int(self.completed.sum())})

    def resume(self, directory: str | Path) -> bool:
        """Restore progress from the newest snapshot under ``directory``.
        Returns False when none exists (fresh start); raises
        :class:`QueueMismatchError` when the snapshot belongs to a
        different task set."""
        tpl = self._require_template("resume()")
        step = latest_step(directory)
        if step is None:
            return False
        extra = load_extra(directory, step) or {}
        if extra.get("tasks") != self._digest():
            raise QueueMismatchError(
                f"queue checkpoint at {directory} (step {step}) was written "
                f"for a different task set/sharding; refusing to resume"
            )
        T = len(self.tasks)
        target = {
            "attempts": np.zeros(T, np.int32),
            "completed": np.zeros(T, bool),
            "dead": np.zeros(T, bool),
            "results": np.zeros((T,) + tpl.shape, tpl.dtype),
        }
        tree, _ = restore_checkpoint(directory, target, step, as_numpy=True)
        self.attempts = np.asarray(tree["attempts"]).copy()
        self.completed = np.asarray(tree["completed"]).copy()
        self.dead = np.asarray(tree["dead"]).copy()
        self._results = {
            int(tid): np.asarray(tree["results"][tid])
            for tid in np.flatnonzero(self.completed)
        }
        self._leases = {}  # ephemeral: holders died with the process
        self._saves = step
        return True


# --------------------------------------------------------------------------
# the durable (multi-process, shared-filesystem) queue
# --------------------------------------------------------------------------
def _marker(tid: int, attempt: int) -> str:
    return f"{tid:05d}.{attempt:04d}"


def _parse_marker(name: str) -> tuple[int, int]:
    tid, attempt = name.split(".")
    return int(tid), int(attempt)


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_json(path: Path, obj: dict) -> None:
    """tmp+rename JSON write; unique tmp name so concurrent writers of the
    same path never interleave partial content."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


class DurableWorkQueue:
    """The :class:`WorkQueue` contract on a shared filesystem, safe for
    real OS worker processes that die by SIGKILL.

    Disk layout under ``root`` (every transition is one ``os.rename``)::

        tasks.json                  task-set digest + config (bootstrap commit)
        pending/<tid>.<k>           claimable; k = attempts already consumed
        claims/<tid>.<a>            leased as attempt a (= k+1)
        heartbeats/<tid>.<a>        {"expires": wall-clock, "pid": holder}
        done/<tid>.<a>              committed by attempt a (terminal)
        dead/<tid>.<a>              dead-lettered after max_attempts (terminal)
        results/t<tid>/step_<a>/    attempt a's result (atomic fsync'd store)
        stats/<worker>.json         per-worker counters for the chaos report

    **Why rename, not fcntl.**  POSIX ``rename`` is atomic but *clobbers*
    an existing destination, so renaming *onto* a claim path would not be
    exclusive.  Exclusivity comes from the unique **source**: claiming is
    ``rename(pending/<tid>.<k> -> claims/<tid>.<k+1>)`` — of N racers
    exactly one finds the source present; the rest get ``FileNotFoundError``
    and move on.  The attempt counter travels *in the filename*, so it
    moves atomically with the rename (a counter stored in file content
    would have a stale-read window between reap and re-claim).  No fcntl /
    flock means the protocol also holds on NFS mounts where POSIX locks
    are unreliable.

    **Lease lifecycle.**  A claimer writes ``heartbeats/<tid>.<a>``
    *before* renaming the pending marker (so a claim is never observable
    without an expiry), then renews it every ``lease_timeout/3`` while
    computing.  ``lease()`` reaps first: any claim whose heartbeat has
    expired (fallback: claim mtime + timeout, covering a crash between
    heartbeat write and claim rename... which leaves no claim at all, and
    a crash right after the rename) is renamed back to ``pending`` — or to
    ``dead/`` once ``max_attempts`` is consumed.  A live-but-paused worker
    that outsleeps its lease is indistinguishable from a dead one; its
    late :meth:`complete` is then refused by the commit rename (below),
    which is the stale-token rejection that makes at-least-once safe.

    **Commit protocol.**  :meth:`complete` first *publishes* the result
    through ``checkpoint.store.save_checkpoint`` (fsync'd tmp+rename into
    ``results/t<tid>``, step = attempt — idempotent, crash-safe), then
    *commits* with ``rename(claims/<tid>.<a> -> done/<tid>.<a>)``.  That
    one rename is simultaneously the stale-token check (the filename
    carries the attempt; a reaped/re-issued claim means the source is
    gone) and the commit — the kernel arbitrates complete-vs-reap races,
    so at most one ``done`` marker can ever exist per task and a
    publish-then-crash leaves only an orphan result step that the next
    attempt's publish supersedes.  :meth:`merge` folds, in canonical tid
    order, exactly the attempt named by each task's ``done`` marker.

    **Bootstrap.**  The first constructor for a ``root`` writes the
    pending markers and then ``tasks.json`` (the commit point); later
    constructors *attach* — they verify the task-set digest
    (:class:`QueueMismatchError` on mismatch) and touch nothing, which is
    also how a restarted run resumes: progress IS the filesystem state, no
    separate checkpoint/resume step exists.  Bootstrap once (in the
    parent) before spawning workers.

    Time is the shared wall clock (``time.time``) — heartbeat expiries
    must be comparable *across processes*; injectable for tests.
    """

    def __init__(
        self,
        root: str | Path,
        tasks: Sequence[Any],
        *,
        lease_timeout: float = 30.0,
        max_attempts: int = 3,
        result_template: Optional[np.ndarray] = None,
        clock: Callable[[], float] = time.time,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.root = Path(root)
        self.tasks = list(tasks)
        self.lease_timeout = float(lease_timeout)
        self.max_attempts = int(max_attempts)
        self.result_template = (
            None if result_template is None else np.asarray(result_template)
        )
        self._clock = clock
        self.stale_rejections = 0
        self.completions = 0
        for sub in ("pending", "claims", "heartbeats", "done", "dead",
                    "results", "stats"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)
        meta = self.root / "tasks.json"
        if meta.exists():
            cfg = json.loads(meta.read_text())
            if cfg.get("digest") != self._digest():
                raise QueueMismatchError(
                    f"durable queue at {self.root} was bootstrapped for a "
                    f"different task set/sharding; refusing to attach"
                )
        else:
            for tid in range(len(self.tasks)):
                (self.root / "pending" / _marker(tid, 0)).touch(exist_ok=True)
            _fsync_dir(self.root / "pending")
            _atomic_json(meta, {
                "digest": self._digest(),
                "num_tasks": len(self.tasks),
                "lease_timeout": self.lease_timeout,
                "max_attempts": self.max_attempts,
            })
            _fsync_dir(self.root)

    # ---------------------------------------------------------------- state
    _digest = WorkQueue._digest
    _require_template = WorkQueue._require_template

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def _tids(self, sub: str) -> dict:
        """{tid: attempt} for one marker directory (highest attempt wins,
        though terminal dirs only ever hold one entry per tid)."""
        out: dict = {}
        d = self.root / sub
        for p in d.iterdir():
            if p.name.startswith("."):
                continue
            try:
                tid, attempt = _parse_marker(p.name)
            except ValueError:
                continue
            if tid not in out or attempt > out[tid]:
                out[tid] = attempt
        return out

    @property
    def finished(self) -> bool:
        """Every task has reached a terminal marker (done or dead)."""
        done = self._tids("done")
        dead = self._tids("dead")
        return len(set(done) | set(dead)) >= len(self.tasks)

    @property
    def dead_letters(self) -> list:
        return sorted(self._tids("dead"))

    @property
    def completed(self) -> np.ndarray:
        mask = np.zeros(len(self.tasks), bool)
        for tid in self._tids("done"):
            mask[tid] = True
        return mask

    # ---------------------------------------------------------------- leases
    def _heartbeat_path(self, tid: int, attempt: int) -> Path:
        return self.root / "heartbeats" / _marker(tid, attempt)

    def _write_heartbeat(self, tid: int, attempt: int) -> float:
        expires = self._clock() + self.lease_timeout
        _atomic_json(self._heartbeat_path(tid, attempt),
                     {"expires": expires, "pid": os.getpid()})
        return expires

    def renew(self, lease: "Lease") -> None:
        """Extend the lease by another timeout (heartbeat). Harmless if
        the claim was already reaped — the commit rename still decides."""
        self._write_heartbeat(lease.tid, lease.attempt)

    def _expiry(self, claim: Path, tid: int, attempt: int) -> float:
        hb = self._heartbeat_path(tid, attempt)
        try:
            return float(json.loads(hb.read_text())["expires"])
        except (OSError, ValueError, KeyError):
            # no/torn heartbeat: fall back to claim mtime + timeout
            try:
                return claim.stat().st_mtime + self.lease_timeout
            except OSError:
                return float("inf")  # claim vanished: nothing to reap

    def _reap(self) -> None:
        now = self._clock()
        for claim in list((self.root / "claims").iterdir()):
            try:
                tid, attempt = _parse_marker(claim.name)
            except ValueError:
                continue
            if self._expiry(claim, tid, attempt) > now:
                continue
            dest = ("dead" if attempt >= self.max_attempts else "pending")
            try:
                os.rename(claim, self.root / dest / _marker(tid, attempt))
            except FileNotFoundError:
                continue  # lost the race to another reaper/completer
            self._heartbeat_path(tid, attempt).unlink(missing_ok=True)

    def lease(self) -> Optional[Lease]:
        """Reap expired claims, then claim the lowest-id pending task via
        the rename protocol.  None when nothing is claimable right now."""
        self._reap()
        pending = sorted(
            p.name for p in (self.root / "pending").iterdir()
            if not p.name.startswith(".")
        )
        for name in pending:
            try:
                tid, consumed = _parse_marker(name)
            except ValueError:
                continue
            if consumed >= self.max_attempts:
                try:  # belt and braces; _reap normally dead-letters first
                    os.rename(self.root / "pending" / name,
                              self.root / "dead" / name)
                except FileNotFoundError:
                    pass
                continue
            attempt = consumed + 1
            # heartbeat BEFORE the claim rename: a claim must never be
            # observable without an expiry.  If we lose the race below, a
            # concurrent claimer wrote (or will renew) this same path —
            # both contents carry ~now+timeout, so not unlinking is safe.
            expires = self._write_heartbeat(tid, attempt)
            try:
                os.rename(self.root / "pending" / name,
                          self.root / "claims" / _marker(tid, attempt))
            except FileNotFoundError:
                continue  # another worker won this task
            return Lease(tid, attempt, self.tasks[tid], expires)
        return None

    def complete(self, lease: Lease, result) -> bool:
        """Publish the result (fsync'd atomic store write), then commit by
        renaming the claim to ``done`` — the rename IS the stale-token
        check.  False (result publish superseded, nothing committed) for a
        reaped/re-issued lease."""
        claim = self.root / "claims" / _marker(lease.tid, lease.attempt)
        if claim.exists():  # cheap fast-path; the rename below decides
            save_checkpoint(
                self.root / "results" / f"t{lease.tid:05d}",
                lease.attempt,
                {"result": np.asarray(result)},
                extra={"tid": lease.tid, "attempt": lease.attempt},
            )
        try:
            os.rename(claim, self.root / "done" / _marker(lease.tid, lease.attempt))
        except FileNotFoundError:
            self.stale_rejections += 1
            return False
        _fsync_dir(self.root / "done")
        self._heartbeat_path(lease.tid, lease.attempt).unlink(missing_ok=True)
        self.completions += 1
        return True

    def fail(self, lease: Lease) -> bool:
        """Give the lease back early (or dead-letter it when attempts are
        exhausted).  Same rename-arbitrated staleness as complete."""
        dest = ("dead" if lease.attempt >= self.max_attempts else "pending")
        try:
            os.rename(self.root / "claims" / _marker(lease.tid, lease.attempt),
                      self.root / dest / _marker(lease.tid, lease.attempt))
        except FileNotFoundError:
            return False
        self._heartbeat_path(lease.tid, lease.attempt).unlink(missing_ok=True)
        return True

    # ---------------------------------------------------------------- merge
    def merge(self, combine: Callable[[Any, Any], Any], init=None):
        """Fold committed results in canonical task-id order — for each
        task, exactly the attempt its ``done`` marker names.  Bitwise-
        deterministic whatever the completion order, worker count, or
        SIGKILL schedule (same contract as :meth:`WorkQueue.merge`)."""
        if init is None:
            tpl = self._require_template("merge()")
            init = np.zeros_like(tpl)
        done = self._tids("done")
        out = init
        for tid in range(len(self.tasks)):
            if tid not in done:
                continue
            tpl = self._require_template("merge()")
            target = {"result": np.zeros_like(tpl)}
            tree, _ = restore_checkpoint(
                self.root / "results" / f"t{tid:05d}", target,
                done[tid], as_numpy=True)
            out = combine(out, tree["result"])
        return out

    # ---------------------------------------------------------------- stats
    def write_stats(self, worker_id: str, stats: dict) -> None:
        _atomic_json(self.root / "stats" / f"{worker_id}.json", stats)

    def read_stats(self) -> dict:
        out = {}
        for p in (self.root / "stats").iterdir():
            if p.name.startswith(".") or not p.name.endswith(".json"):
                continue
            try:
                out[p.stem] = json.loads(p.read_text())
            except (json.JSONDecodeError, OSError):
                continue  # torn stats are advisory, never load-bearing
        return out


class _HeartbeatThread:
    """Renews a lease's heartbeat every ``lease_timeout/3`` until stopped.
    Daemonized: a SIGKILL'd worker takes its heartbeat thread with it,
    which is exactly what lets the reaper detect the death."""

    def __init__(self, queue: DurableWorkQueue, lease: Lease):
        self._queue = queue
        self._lease = lease
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        period = self._queue.lease_timeout / 3.0
        while not self._stop.wait(period):
            self._queue.renew(self._lease)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def durable_worker_loop(
    queue: DurableWorkQueue,
    work_fn: Callable[[Any], Any],
    *,
    worker_id: str = "w0",
    faults: Optional[dict] = None,
    poll: float = 0.05,
) -> dict:
    """One worker's life: lease, heartbeat while computing, publish+commit;
    repeat until the queue is finished.  Returns this worker's counters
    (also mirrored to ``stats/<worker_id>.json`` after every task, so a
    supervisor can aggregate across SIGKILL'd workers).

    ``faults`` maps ``(tid, attempt)`` to an injection applied *after* the
    task's result is computed but before commit:

      * ``"sigkill"`` — uncatchable process death mid-lease (no unwind);
        the heartbeat dies too, so the task re-issues after the timeout.
      * a number — a *stall*: stop heartbeating and sleep that many
        seconds.  Outsleeping the lease gets the task reaped and re-run
        elsewhere; the staller's late commit must then be refused — the
        stale-token rejection the chaos gate asserts is >0.
    """
    faults = faults or {}
    stats = {"leases": 0, "completed": 0, "stale": 0, "pid": os.getpid()}
    while not queue.finished:
        lease = queue.lease()
        if lease is None:
            time.sleep(poll)
            continue
        stats["leases"] += 1
        hb = _HeartbeatThread(queue, lease)
        try:
            result = work_fn(lease.payload)
        except BaseException:
            hb.stop()
            queue.fail(lease)
            raise
        fault = faults.get((lease.tid, lease.attempt))
        if fault == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        if isinstance(fault, (int, float)):
            hb.stop()  # heartbeat goes silent: simulate a long pause
            time.sleep(float(fault))
        else:
            hb.stop()
        if queue.complete(lease, result):
            stats["completed"] += 1
        else:
            stats["stale"] += 1
        queue.write_stats(worker_id, stats)
    queue.write_stats(worker_id, stats)
    return stats


def _durable_worker_main(root, tasks, cfg: dict, work_fn, worker_id: str,
                         faults: Optional[dict], poll: float) -> None:
    """Spawn-context entry point (module-level, picklable args only): the
    worker attaches to the durable queue by root and runs the loop."""
    queue = DurableWorkQueue(
        root, tasks,
        lease_timeout=cfg["lease_timeout"],
        max_attempts=cfg["max_attempts"],
        result_template=cfg.get("result_template"),
    )
    durable_worker_loop(queue, work_fn, worker_id=worker_id,
                        faults=faults, poll=poll)


def shard_sources(sources, shard_size: Optional[int] = None, *,
                  batch: Optional[int] = None) -> list:
    """Split a source vertex set into queue task payloads.

    ``shard_size=S``: payloads of at most S sources each, the classic
    work unit — one BSP run per source inside the shard.

    ``batch=Q``: payloads are Q-source *groups* meant to run as ONE
    batched multi-source pass each (``run_program_batched`` /
    ``Graph.bfs(sources=group)``), so a lease amortizes every streamed
    edge chunk across its whole group.  The slicing is canonical either
    way (contiguous, in source order), so the queue's task-id merge fold
    stays order- and death-invariant over batched results: a group's
    result commits under one tid exactly like a shard's.

    Exactly one of ``shard_size`` / ``batch`` must be given.
    """
    src = np.asarray(sources).reshape(-1)
    if (shard_size is None) == (batch is None):
        raise ValueError("pass exactly one of shard_size= or batch=")
    size = int(shard_size if shard_size is not None else batch)
    if size < 1:
        raise ValueError("shard_size/batch must be >= 1")
    return [src[i:i + size] for i in range(0, len(src), size)]


def run_workers(
    queue: WorkQueue,
    work_fn: Callable[[Any], Any],
    *,
    deaths: Sequence[tuple] = (),
    checkpoint_dir: Optional[str | Path] = None,
    checkpoint_every: int = 1,
    processes: int | bool = False,
    faults: Optional[dict] = None,
    poll: float = 0.05,
    max_spawns: Optional[int] = None,
    timeout: float = 300.0,
):
    """Drive ``queue`` to completion through injected worker deaths.

    With ``processes=N`` (requires a :class:`DurableWorkQueue`), the pool
    is N *real OS processes* (multiprocessing spawn context — fork is
    unsafe under a live CUDA context) each running
    :func:`durable_worker_loop`, supervised and restarted on abnormal
    exit by :func:`repro_torch.distributed.fault.supervise_workers`; ``faults``
    maps ``(tid, attempt)`` to ``"sigkill"``/stall injections and the
    return value is that supervisor's ``ChaosReport``.  ``work_fn`` must
    then be a module-level picklable callable.  The in-process simulation
    below is unchanged and remains the deterministic fast path.

    A deterministic simulation of a worker pool: tasks are leased one at
    a time; a lease whose ``(tid, attempt)`` is in ``deaths`` simulates a
    worker dying mid-task — its computed result is DISCARDED and the
    lease is left to expire (the queue's clock must be a
    :class:`ManualClock`, which this driver advances past the timeout
    when only orphaned leases remain).  Everything else completes
    normally.  With ``checkpoint_dir``, the queue snapshots after every
    ``checkpoint_every`` completions.

    Because results merge in canonical task order, the final
    :meth:`WorkQueue.merge` is bitwise-identical with any ``deaths``
    schedule whose tasks still complete within ``max_attempts`` — the
    property ``tests/test_torch_workqueue.py`` and ``chip_smoke.py`` assert.
    """
    if processes:
        if not isinstance(queue, DurableWorkQueue):
            raise TypeError(
                "processes= needs a DurableWorkQueue: OS workers share "
                "progress through the filesystem, not this process's heap"
            )
        from ..distributed.fault import supervise_workers

        return supervise_workers(
            queue, work_fn,
            num_workers=int(processes) if processes is not True else 3,
            faults=faults, poll=poll, max_spawns=max_spawns, timeout=timeout,
        )
    deaths = set((int(t), int(a)) for t, a in deaths)
    since_save = 0
    while not queue.finished:
        lease = queue.lease()
        if lease is None:
            # Only orphaned leases remain: let them time out.
            if isinstance(queue._clock, ManualClock):
                queue._clock.advance(queue.lease_timeout * 1.001)
            else:  # pragma: no cover - real-clock fallback
                time.sleep(queue.lease_timeout * 0.1)
            continue
        if (lease.tid, lease.attempt) in deaths:
            continue  # worker died holding the lease; result lost
        if queue.complete(lease, work_fn(lease.payload)):
            since_save += 1
            if checkpoint_dir is not None and since_save >= checkpoint_every:
                queue.checkpoint(checkpoint_dir)
                since_save = 0
    if checkpoint_dir is not None:
        queue.checkpoint(checkpoint_dir)
    return queue
