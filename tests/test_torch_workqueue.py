"""The port's work queues and supervisors (``repro_torch.core.workqueue``,
``repro_torch.distributed.fault``) against the reference's.

The same tasks, the same injected worker deaths and the same numpy
``work_fn`` give identical merges, attempt counts, dead letters and
``done/`` marker names under ``repro.core`` and under the port; the
reference's in-process queue and durable-queue protocol tests are ported
case for case; and the chaos gate runs 3 spawned CPU worker processes
(two SIGKILLed mid-lease, two stalled past their lease) whose merged
result must be bitwise the single-process run.  Tolerances: exact.

The reference package is imported inside the tests that use it, so that
the spawned chaos workers, which import this module to find
:func:`chaos_work`, load only the port.
"""
import time

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (
    DurableWorkQueue,
    ExecutionPolicy,
    ManualClock,
    QueueMismatchError,
    WorkQueue,
    run_workers,
    shard_sources,
)
from repro_torch.distributed.fault import (
    FailurePlan,
    Supervisor,
    supervise_workers,
)
from repro_torch.graph.generators import rmat


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's small tensors on one intra-op thread: torch's
    thread pool only slows tiny ops, and under parallel test workers its
    threads oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _work(src):
    out = np.zeros(16)
    for s in np.asarray(src).reshape(-1):
        out[int(s) % 16] += 0.1 * float(s) + 1.0
    return out


def _vec_work(payload):
    out = np.zeros(4, np.float64)
    out[:2] = np.asarray(payload, np.float64)
    return out


def _add(a, b):
    return a + b


# ------------------------------------------------- parity with the reference
DEATHS = ([], [(1, 1), (3, 1), (3, 2), (4, 1)], [(0, 1), (0, 2)])


@pytest.mark.parametrize("deaths", range(len(DEATHS)))
@pytest.mark.parametrize("max_attempts", [2, 3])
def test_in_process_queue_matches_reference(tmp_path, deaths, max_attempts):
    """Same shards, deaths schedule and work_fn: equal merge bits,
    attempts, dead letters and queue snapshots."""
    from repro import checkpoint as rck
    from repro.core import workqueue as rwq

    def run(mod, root):
        q = mod.WorkQueue(mod.shard_sources(np.arange(23), 5),
                          result_template=np.zeros(16), clock=mod.ManualClock(),
                          lease_timeout=5.0, max_attempts=max_attempts)
        mod.run_workers(q, _work, deaths=DEATHS[deaths], checkpoint_dir=root)
        return q

    port = run(repro_torch.core.workqueue, tmp_path / "port")
    ref = run(rwq, tmp_path / "ref")
    assert np.array_equal(port.merge(_add), ref.merge(_add))
    assert np.array_equal(port.attempts, ref.attempts)
    assert port.dead_letters == ref.dead_letters
    assert np.array_equal(port.completed, ref.completed)
    # each package resumes the other's snapshot
    for mod, root in ((rwq, tmp_path / "port"),
                      (repro_torch.core.workqueue, tmp_path / "ref")):
        q = mod.WorkQueue(mod.shard_sources(np.arange(23), 5),
                          result_template=np.zeros(16), clock=mod.ManualClock(),
                          max_attempts=max_attempts)
        assert q.resume(root) and q.finished
        assert np.array_equal(q.merge(_add), port.merge(_add))
    assert rck.latest_step(tmp_path / "port") == \
        rck.latest_step(tmp_path / "ref")


def test_durable_queue_matches_reference(tmp_path):
    """One scripted schedule of leases, expiries, stale commits, failures
    and dead letters on both packages' durable queues: the same marker
    names in every directory after every step, and the same merge."""
    from repro.core import workqueue as rwq

    queues, clocks = {}, {}
    for name, mod in (("port", repro_torch.core.workqueue), ("ref", rwq)):
        clocks[name] = mod.ManualClock()
        queues[name] = mod.DurableWorkQueue(
            tmp_path / name, [np.array([i, i + 1]) for i in range(6)],
            result_template=np.zeros(4), lease_timeout=5.0, max_attempts=2,
            clock=clocks[name])

    def markers(root):
        return {sub: sorted(p.name for p in (root / sub).iterdir())
                for sub in ("pending", "claims", "done", "dead")}

    def step(fn):
        out = {name: fn(q, clocks[name]) for name, q in queues.items()}
        assert markers(tmp_path / "port") == markers(tmp_path / "ref")
        return out

    leases = step(lambda q, c: [q.lease() for _ in range(3)])
    step(lambda q, c: q.complete(leases[_name(q, queues)][1],
                                 _vec_work(leases[_name(q, queues)][1]
                                           .payload)))
    step(lambda q, c: c.advance(6.0))
    late = step(lambda q, c: q.lease())  # reaps 0 and 2, re-issues 0
    stale = step(lambda q, c: q.complete(leases[_name(q, queues)][0],
                                         _vec_work(np.array([0, 1]))))
    assert stale == {"port": False, "ref": False}
    step(lambda q, c: q.fail(late[_name(q, queues)]))  # 0 dead-lettered
    while not queues["port"].finished:
        step(lambda q, c: _finish_one(q))
    assert queues["port"].dead_letters == queues["ref"].dead_letters == [0]
    assert np.array_equal(queues["port"].merge(_add),
                          queues["ref"].merge(_add))


def _name(q, queues):
    return next(k for k, v in queues.items() if v is q)


def _finish_one(q):
    lease = q.lease()
    if lease is not None:
        q.complete(lease, _vec_work(lease.payload))


def test_supervisor_matches_reference(tmp_path):
    """The same numpy step function, batches and injected crashes (one
    shrinking the scale) through both packages' ``Supervisor``."""
    from repro.checkpoint import CheckpointManager as RManager
    from repro.distributed import fault as rfault

    from repro_torch.checkpoint import CheckpointManager

    def make_step(scale):
        def step(state, batch):
            w = np.asarray(state["w"]) * np.float32(0.5) + np.float32(
                batch * scale)
            return {"w": w.astype(np.float32),
                    "n": np.asarray(state["n"]) + 1}, {}
        return step

    def init(scale):
        return {"w": np.zeros(8, np.float32), "n": np.zeros((), np.int32)}

    def batch(step):
        return np.float32(step % 5)

    out = {}
    for name, sup_cls, plan_cls, mgr in (
        ("port", Supervisor, FailurePlan,
         CheckpointManager(tmp_path / "port", keep=2)),
        ("ref", rfault.Supervisor, rfault.FailurePlan,
         RManager(tmp_path / "ref", keep=2)),
    ):
        # no straggler evictions: they follow wall-clock step times
        sup = sup_cls(mgr, make_step, init, batch, checkpoint_every=4,
                      straggler_factor=float("inf"),
                      plan=plan_cls({6: "crash", 13: "crash_shrink",
                                     14: "crash"}))
        state, rep = sup.run(20)
        out[name] = ({k: np.asarray(v) for k, v in state.items()}, rep)
    (ps, pr), (rs, rr) = out["port"], out["ref"]
    for k in ps:
        assert np.array_equal(ps[k], rs[k]) and ps[k].dtype == rs[k].dtype
    for field in ("steps_run", "restarts", "remesh_events", "final_scale",
                  "log"):
        assert getattr(pr, field) == getattr(rr, field), field
    assert pr.restarts == 3 and pr.final_scale == 0.5


# ------------------------------------------------- the in-process queue
class TestWorkQueue:
    def make(self, **kw):
        kw.setdefault("result_template", np.zeros(16))
        kw.setdefault("clock", ManualClock())
        kw.setdefault("lease_timeout", 5.0)
        return WorkQueue(shard_sources(np.arange(23), 5), **kw)

    def test_lease_expiry_reissues(self):
        q = self.make()
        l1 = q.lease()
        assert (l1.tid, l1.attempt) == (0, 1)
        q._clock.advance(6.0)
        l2 = q.lease()
        assert (l2.tid, l2.attempt) == (0, 2)
        assert not q.complete(l1, _work(l1.payload))
        assert not q.completed[0]
        assert q.complete(l2, _work(l2.payload))

    def test_dead_letter_after_max_attempts(self):
        q = self.make(max_attempts=2)
        run_workers(q, _work, deaths=[(0, 1), (0, 2)])
        assert q.dead_letters == [0]
        assert q.finished
        assert q.completed[1:].all()

    def test_merge_is_death_invariant(self):
        m0 = run_workers(self.make(), _work).merge(_add)
        dead = run_workers(self.make(), _work,
                           deaths=[(1, 1), (3, 1), (3, 2), (4, 1)])
        assert np.array_equal(m0, dead.merge(_add))
        assert dead.attempts[3] == 3

    def test_merge_order_is_canonical(self):
        fwd = run_workers(self.make(), _work)
        q = self.make()
        leases = [q.lease() for _ in range(q.num_tasks)]
        for l in reversed(leases):
            assert q.complete(l, _work(l.payload))
        assert np.array_equal(fwd.merge(_add), q.merge(_add))

    def test_checkpoint_resume_mid_sweep(self, tmp_path):
        full = run_workers(self.make(), _work).merge(_add)
        q = self.make()
        for _ in range(2):
            l = q.lease()
            q.complete(l, _work(l.payload))
        q.checkpoint(tmp_path)
        q2 = self.make()
        assert q2.resume(tmp_path)
        assert int(q2.completed.sum()) == 2
        run_workers(q2, _work)
        assert np.array_equal(full, q2.merge(_add))

    def test_resume_rejects_different_sharding(self, tmp_path):
        q = self.make()
        l = q.lease()
        q.complete(l, _work(l.payload))
        q.checkpoint(tmp_path)
        other = WorkQueue(shard_sources(np.arange(23), 4),
                          result_template=np.zeros(16), clock=ManualClock())
        with pytest.raises(QueueMismatchError):
            other.resume(tmp_path)

    def test_resume_empty_dir_is_fresh_start(self, tmp_path):
        assert not self.make().resume(tmp_path / "nothing_here")

    def test_resume_survives_torn_newest_snapshot(self, tmp_path):
        shards = shard_sources(np.arange(23), 5)
        full = run_workers(WorkQueue(shards, result_template=np.zeros(16),
                                     clock=ManualClock()), _work).merge(_add)
        q = WorkQueue(shards, result_template=np.zeros(16),
                      clock=ManualClock())
        for _ in range(3):
            l = q.lease()
            q.complete(l, _work(l.payload))
            q.checkpoint(tmp_path, keep=5)
        torn = tmp_path / "step_00000003" / "extra.json"
        torn.write_text(torn.read_text()[:10])
        q2 = WorkQueue(shards, result_template=np.zeros(16),
                       clock=ManualClock())
        assert q2.resume(tmp_path)
        assert int(q2.completed.sum()) == 2
        run_workers(q2, _work)
        assert np.array_equal(full, q2.merge(_add))

    def test_bc_sweep_through_queue(self, tmp_path):
        """Betweenness sharded over the queue on the port: injected worker
        deaths change the merged centrality by exactly nothing."""
        s = repro_torch.Graph(rmat(6, edge_factor=6, seed=3, symmetrize=True),
                              chunk_size=64, bd=32, bs=32, device="cpu")
        pol = ExecutionPolicy(backend="scan")
        shards = shard_sources(np.arange(6), 2)
        tpl = np.zeros(s.n, np.float32)

        def bc_shard(src):
            return s.betweenness(src, policy=pol).values.numpy()

        def sweep(deaths):
            q = WorkQueue(shards, result_template=tpl, clock=ManualClock(),
                          lease_timeout=5.0)
            run_workers(q, bc_shard, deaths=deaths,
                        checkpoint_dir=tmp_path / f"q{len(deaths)}")
            return q.merge(_add)

        clean = sweep([])
        assert np.array_equal(clean, sweep([(0, 1), (2, 1)]))
        q3 = WorkQueue(shards, result_template=tpl, clock=ManualClock())
        assert q3.resume(tmp_path / "q0") and q3.finished
        assert np.array_equal(q3.merge(_add), clean)

    def test_dead_worker_task_reissued_on_real_clock(self):
        q = WorkQueue(shard_sources(np.arange(6), 3), lease_timeout=0.1,
                      result_template=np.zeros(16))
        assert q._clock is time.monotonic
        l1 = q.lease()
        time.sleep(0.25)
        l2 = q.lease()
        assert (l2.tid, l2.attempt) == (0, 2)
        assert q.complete(l2, _work(l2.payload))
        assert not q.complete(l1, _work(l1.payload))

    def test_late_complete_before_reap_still_commits(self):
        q = WorkQueue(shard_sources(np.arange(3), 3), lease_timeout=0.05,
                      result_template=np.zeros(16))
        l1 = q.lease()
        time.sleep(0.1)
        assert q.complete(l1, _work(l1.payload))


# ------------------------------------------------- the durable protocol
class TestDurableQueueProtocol:
    def make(self, root, **kw):
        kw.setdefault("result_template", np.zeros(4, np.float64))
        kw.setdefault("lease_timeout", 5.0)
        kw.setdefault("clock", ManualClock())
        return DurableWorkQueue(root, [np.array([i, i + 1])
                                       for i in range(5)], **kw)

    def test_claim_is_exclusive_across_attached_queues(self, tmp_path):
        q1 = self.make(tmp_path / "q")
        q2 = self.make(tmp_path / "q")
        l1, l2 = q1.lease(), q2.lease()
        assert {l1.tid, l2.tid} == {0, 1}
        assert q1.complete(l1, _vec_work(l1.payload))
        assert q2.complete(l2, _vec_work(l2.payload))

    def test_expiry_reissue_and_stale_rejection(self, tmp_path):
        clock = ManualClock()
        q = self.make(tmp_path / "q", clock=clock)
        l1 = q.lease()
        assert (l1.tid, l1.attempt) == (0, 1)
        clock.advance(6.0)
        l2 = q.lease()
        assert (l2.tid, l2.attempt) == (0, 2)
        assert q.complete(l2, _vec_work(l2.payload))
        assert not q.complete(l1, _vec_work(l1.payload))
        assert q.stale_rejections == 1

    def test_renew_extends_lease(self, tmp_path):
        clock = ManualClock()
        q = self.make(tmp_path / "q", clock=clock, lease_timeout=5.0)
        l1 = q.lease()
        clock.advance(4.0)
        q.renew(l1)
        clock.advance(4.0)
        others = [q.lease() for _ in range(4)]
        assert all(l is not None and l.tid != 0 for l in others)
        assert q.complete(l1, _vec_work(l1.payload))

    def test_dead_letter_after_max_attempts(self, tmp_path):
        clock = ManualClock()
        q = self.make(tmp_path / "q", clock=clock, max_attempts=2)
        for expect in (1, 2):
            l = q.lease()
            assert (l.tid, l.attempt) == (0, expect)
            clock.advance(6.0)
        q.lease()
        assert q.dead_letters == [0]

    def test_fail_gives_back_early(self, tmp_path):
        q = self.make(tmp_path / "q")
        l1 = q.lease()
        assert q.fail(l1)
        l2 = q.lease()
        assert (l2.tid, l2.attempt) == (0, 2)

    def test_attach_resumes_progress_from_filesystem(self, tmp_path):
        q = self.make(tmp_path / "q")
        for _ in range(2):
            l = q.lease()
            q.complete(l, _vec_work(l.payload))
        q2 = self.make(tmp_path / "q")
        assert int(q2.completed.sum()) == 2
        while not q2.finished:
            l = q2.lease()
            q2.complete(l, _vec_work(l.payload))
        ref = np.zeros(4)
        for t in q.tasks:
            ref[:2] += t
        assert np.array_equal(q2.merge(_add), ref)

    def test_attach_rejects_different_task_set(self, tmp_path):
        self.make(tmp_path / "q")
        with pytest.raises(QueueMismatchError):
            DurableWorkQueue(tmp_path / "q", [np.array([9, 9])],
                             result_template=np.zeros(4))

    def test_merge_folds_committed_attempt_in_canonical_order(self, tmp_path):
        q = self.make(tmp_path / "q")
        leases = [q.lease() for _ in range(5)]
        for l in reversed(leases):
            assert q.complete(l, _vec_work(l.payload))
        fwd = self.make(tmp_path / "q2")
        while not fwd.finished:
            l = fwd.lease()
            fwd.complete(l, _vec_work(l.payload))
        assert np.array_equal(q.merge(_add), fwd.merge(_add))

    def test_wall_clock_expiry_with_real_processes_semantics(self, tmp_path):
        q = DurableWorkQueue(tmp_path / "q", [np.array([1, 2])],
                             lease_timeout=0.15, result_template=np.zeros(4))
        l1 = q.lease()
        time.sleep(0.3)
        l2 = q.lease()
        assert (l2.tid, l2.attempt) == (0, 2)
        assert q.complete(l2, _vec_work(l2.payload))
        assert not q.complete(l1, _vec_work(l1.payload))

    def test_run_workers_processes_requires_durable_queue(self):
        q = WorkQueue([np.array([0, 1])], result_template=np.zeros(4),
                      clock=ManualClock())
        with pytest.raises(TypeError, match="DurableWorkQueue"):
            run_workers(q, _vec_work, processes=2)

    def test_supervise_workers_requires_durable_queue(self):
        q = WorkQueue([np.array([0, 1])], result_template=np.zeros(4),
                      clock=ManualClock())
        with pytest.raises(TypeError):
            supervise_workers(q, _vec_work)


# ------------------------------------------------- the chaos gate (CPU)
COMBOS = tuple((b, r) for b in ("scan", "compact", "blocked")
               for r in ("device", "host"))
_SCALE = 6
_SHARD = 2
_SOURCES = np.arange(8)
_IO_FIELDS = 10
_session_cache: dict = {}


def _slot_len(n: int) -> int:
    return n * _SHARD + _IO_FIELDS


def chaos_work(payload):
    """One task: a batched BFS of two sources on one (backend, residency)
    combo, on the CPU.  The result is a float64 vector, zero outside the
    combo's slot, holding the (n, 2) levels and the task's IOStats, so the
    queue's additive merge sums values and counters per combo.
    Module-level: spawned workers import it by reference."""
    p = np.asarray(payload, np.int64)
    backend, residency = COMBOS[int(p[0])]
    s = _session_cache.get("g")
    if s is None:  # first task of this worker process
        torch.set_num_threads(1)
        s = _session_cache["g"] = repro_torch.Graph(
            rmat(_SCALE, edge_factor=6, seed=3, symmetrize=True),
            chunk_size=64, bd=32, bs=32, device="cpu")
    r = s.bfs(p[1:].tolist(), policy=ExecutionPolicy(backend=backend,
                                                     residency=residency))
    vals = r.values.numpy().astype(np.float64).reshape(-1)
    io = np.asarray([float(v) for v in r.iostats], np.float64)
    out = np.zeros(len(COMBOS) * _slot_len(s.n), np.float64)
    a = int(p[0]) * _slot_len(s.n)
    out[a:a + vals.size] = vals
    out[a + s.n * _SHARD:a + s.n * _SHARD + io.size] = io
    return out


def test_sigkill_chaos_bitwise_parity(tmp_path):
    """3 spawned workers, 2 SIGKILLs and 2 stalls mid-sweep, restarted by
    the supervisor: the merge is bitwise the crash-free single-process
    run's, no task lost or committed twice, and stale commits refused."""
    tasks = [np.concatenate([[ci], grp]).astype(np.int64)
             for ci in range(len(COMBOS))
             for grp in shard_sources(_SOURCES, _SHARD)]
    tpl = np.zeros(len(COMBOS) * _slot_len(2 ** _SCALE), np.float64)
    clean = DurableWorkQueue(tmp_path / "clean", tasks, lease_timeout=10.0,
                             result_template=tpl)
    t0 = time.perf_counter()
    rep0 = run_workers(clean, chaos_work, processes=1, timeout=120.0)
    clean_s = time.perf_counter() - t0
    assert rep0.finished and rep0.completed == len(tasks)
    assert rep0.kills == 0 and rep0.stale_rejections == 0
    ref = clean.merge(_add)

    # kills on the first two tasks leased (so both workers are restarted
    # while the queue is pending); stalls on the last two, each longer
    # than its lease plus twice the single-process run's wall (which
    # bounds a worker's start), so that a restarted worker reaps and
    # reruns the stalled task before the late commit
    last = len(tasks) - 1
    stall_s = 1.5 + 2.0 * clean_s + 3.0
    faults = {(0, 1): "sigkill", (1, 1): "sigkill",
              (last - 1, 1): stall_s, (last, 1): stall_s}
    chaos = DurableWorkQueue(tmp_path / "chaos", tasks, lease_timeout=1.5,
                             max_attempts=4, result_template=tpl)
    rep = run_workers(chaos, chaos_work, processes=3, faults=faults,
                      timeout=120.0)
    assert rep.finished, rep.log
    assert rep.kills >= 2 and rep.restarts >= 2
    assert rep.stale_rejections > 0
    assert rep.dead_letters == []
    done = sorted(p.name for p in (tmp_path / "chaos" / "done").iterdir())
    assert len(done) == len(tasks)
    assert len({m.split(".")[0] for m in done}) == len(tasks)
    assert np.array_equal(chaos.merge(_add), ref)
    # each combo's slot holds the sum of its groups' batched BFS levels
    n = 2 ** _SCALE
    g = repro_torch.Graph(rmat(_SCALE, edge_factor=6, seed=3,
                               symmetrize=True), device="cpu")
    want = sum(g.bfs(grp.tolist()).values.numpy().astype(np.float64)
               for grp in shard_sources(_SOURCES, _SHARD)).reshape(-1)
    for ci in range(len(COMBOS)):
        a = ci * _slot_len(n)
        assert np.array_equal(ref[a:a + n * _SHARD], want), COMBOS[ci]
