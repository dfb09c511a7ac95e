"""Resume-exact BSP runs of the port (``repro_torch.core.recovery``).

A port run killed at any superstep and resumed is *bitwise-equal* —
values, superstep count and all ten IOStats fields, ``host_bytes`` and
``retries`` included — to the port's uninterrupted run, on all four
backends and both residencies, for PageRank, BFS, batched BFS,
personalized PageRank and betweenness.  The reference's checkpointed
drivers are dead on JAX 0.9.0 (``jax.core.jaxpr_as_fun``, ROADMAP §C R1),
so each uninterrupted port run is held against the reference's inline
``run_program`` instead: BFS exact, PageRank within ``atol=1e-6,
rtol=1e-5``, IOStats equal but for the residency's own fields.  Same
graph as the reference's ``tests/test_recovery.py``.
"""
import numpy as np
import pytest
import torch

import repro
from repro.algs.bfs import BFSProgram as RBFS
from repro.algs.pagerank import PageRankPullProgram as RPull
from repro.algs.pagerank import PersonalizedPageRankProgram as RPPR
from repro.graph.generators import rmat

import repro_torch
from repro_torch.algs.bfs import BFSProgram
from repro_torch.algs.pagerank import (
    PageRankPullProgram,
    PageRankPushProgram,
    PersonalizedPageRankProgram,
)
from repro_torch.checkpoint import latest_step, load_extra
from repro_torch.core import (
    CheckpointMismatchError,
    CheckpointSpec,
    DeviceFailure,
    ExecutionPolicy,
    FailurePlan,
    StreamFailure,
    inject_stream_faults,
    run_program,
    run_program_batched,
    run_supervised,
)
from repro_torch.core.semiring import PLUS_TIMES, _ordered_add

BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
RESIDENCIES = ("device", "host")
PR_TOL = dict(atol=1e-6, rtol=1e-5)
RESIDENCY_FIELDS = ("host_bytes", "retries")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's small tensors on one intra-op thread: the runs
    are thousands of tiny ops, which torch's thread pool only slows, and
    under parallel test workers its threads oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def host():
    return rmat(6, edge_factor=6, seed=3, symmetrize=True)


def session(host):
    return repro_torch.Graph(host, chunk_size=64, bd=32, bs=32, device="cpu")


def ref_session(host):
    return repro.Graph(host, chunk_size=64, bd=32, bs=32)


def views(host):
    s = session(host)
    return s.device(), s.host_view()


def assert_identical(a, b, *, skip=()):
    """Full bitwise equality: values, supersteps, EVERY IOStats field."""
    assert torch.equal(a.values, b.values)
    assert int(a.supersteps) == int(b.supersteps)
    assert len(a.iostats) == 10
    for name, x, y in zip(a.iostats._fields, a.iostats, b.iostats):
        if name not in skip:
            assert int(x) == int(y), f"IOStats.{name}: {int(x)} != {int(y)}"
    if a.query_supersteps is not None or b.query_supersteps is not None:
        assert torch.equal(a.query_supersteps, b.query_supersteps)


def assert_matches_reference(port, ref, *, approx: bool):
    """An uninterrupted port run against the reference's inline run.
    PageRank (``approx``) is held on its values and supersteps: its
    counters follow which vertices cross the ``tol`` threshold, which the
    f32 summation order can move (ROADMAP §C P2, P5)."""
    got, want = port.values.numpy(), np.asarray(ref.values)
    if approx:
        np.testing.assert_allclose(got, want, **PR_TOL)
    else:
        np.testing.assert_array_equal(got, want)
    assert int(port.supersteps) == int(ref.supersteps)
    if approx:
        return
    for name, x, y in zip(port.iostats._fields, port.iostats, ref.iostats):
        if name not in RESIDENCY_FIELDS:
            assert int(x) == int(y), f"IOStats.{name}: {int(x)} != {int(y)}"


def reference_run(host, backend, prog, **kw):
    """The reference's inline device run (its host driver is dead, R1)."""
    s = ref_session(host)
    pol = repro.ExecutionPolicy(backend=backend)
    return repro.run_program(s._sem(pol, prog), prog, pol, **kw)


# ------------------------------------------------------------ resume-exact
def test_kill_at_every_superstep(host, tmp_path):
    """Crash at superstep k for EVERY k, resume, bitwise the same —
    wherever k falls relative to every_k."""
    sem, _ = views(host)
    prog = PageRankPullProgram(tol=1e-4)
    base = run_program(sem, prog, max_supersteps=30)
    assert_matches_reference(
        base, reference_run(host, "scan", RPull(tol=1e-4), max_supersteps=30),
        approx=True)
    total = int(base.supersteps)
    assert total > 5
    for k in range(total):
        res, rep = run_supervised(
            sem, prog, max_supersteps=30,
            checkpoint=CheckpointSpec(tmp_path / f"kill_{k}", every_k=3),
            plan=FailurePlan({k: "crash"}))
        assert rep.restarts == 1
        assert_identical(base, res)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("residency", RESIDENCIES)
def test_backends_and_residencies(host, tmp_path, backend, residency):
    """Spot kills on every backend x residency: PageRank pull killed twice
    (once off-cadence), BFS killed once."""
    s = session(host)
    pol = ExecutionPolicy(backend=backend, residency=residency)
    prog = PageRankPullProgram(tol=1e-4)
    sem = s._sem(pol, prog)
    base = run_program(sem, prog, pol, max_supersteps=25)
    assert_matches_reference(
        base, reference_run(host, backend, RPull(tol=1e-4),
                            max_supersteps=25), approx=True)
    res, rep = run_supervised(
        sem, prog, pol, max_supersteps=25,
        checkpoint=CheckpointSpec(tmp_path / "pr", every_k=2),
        plan=FailurePlan({3: "crash", 7: "crash"}))
    assert rep.restarts == 2 and rep.resumed_steps == [2, 6]
    assert_identical(base, res)
    if residency == "host":
        assert int(res.iostats.host_bytes) > 0

    bfs = BFSProgram()
    seeds = torch.tensor([0], dtype=torch.int32)
    sem = s._sem(pol, bfs)
    base_b = run_program(sem, bfs, pol, seeds=seeds)
    assert_matches_reference(
        base_b, reference_run(host, backend, RBFS(),
                              seeds=np.asarray([0], np.int32)), approx=False)
    res_b, rep_b = run_supervised(
        sem, bfs, pol, seeds=seeds,
        checkpoint=CheckpointSpec(tmp_path / "bfs", every_k=2),
        plan=FailurePlan({2: "crash"}))
    assert rep_b.restarts == 1
    assert_identical(base_b, res_b)


def _killed_then_resumed(run, spec, kill_at: int):
    """``run(checkpoint=, resume=, _plan=)`` killed at superstep
    ``kill_at``, then resumed from its newest snapshot."""
    with pytest.raises(DeviceFailure):
        run(checkpoint=spec, _plan=FailurePlan({kill_at: "crash"}))
    assert latest_step(spec.directory) is not None
    return run(checkpoint=spec, resume=True)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("residency", RESIDENCIES)
def test_batched_bfs_and_ppr(host, tmp_path, backend, residency):
    """Checkpointed batched BFS and one-hot PPR, killed and resumed:
    bitwise the uninterrupted batched run (which retires columns; the
    checkpointed run keeps all Q), and each column equals its solo run."""
    s = session(host)
    pol = ExecutionPolicy(backend=backend, residency=residency)
    seeds = np.asarray([0, 3, 11, 40], np.int32)
    for name, prog, kill in (("bfs", BFSProgram(), 2),
                             ("ppr", PersonalizedPageRankProgram(tol=1e-4), 5)):
        sem = s._sem(pol, prog)

        def run(**kw):
            return run_program_batched(sem, prog, pol, seeds=seeds,
                                       max_supersteps=60, **kw)

        base = run()
        res = _killed_then_resumed(
            run, CheckpointSpec(tmp_path / name, every_k=2), kill)
        assert_identical(base, res)
        assert res.state is not None  # no column retired under checkpoints
        assert int(res.iostats.queries) == len(seeds)
        for q, src in enumerate(seeds):
            solo = run_program_batched(sem, prog, pol, seeds=seeds[q:q + 1],
                                       max_supersteps=60)
            if name == "bfs":
                assert torch.equal(res.values[:, q], solo.values[:, 0])
            else:
                torch.testing.assert_close(res.values[:, q],
                                           solo.values[:, 0], **PR_TOL)
            assert int(res.query_supersteps[q]) == int(solo.supersteps)
        # the uninterrupted batch against the reference's inline K-lane run
        rprog = (repro.algs.BFSProgram() if name == "bfs" else
                 RPPR(tol=1e-4))
        ref = reference_run(host, backend, rprog, seeds=seeds,
                            max_supersteps=60)
        np.testing.assert_allclose(base.values.numpy(),
                                   np.asarray(ref.values),
                                   **(PR_TOL if name == "ppr" else
                                      dict(atol=0, rtol=0)))


@pytest.mark.parametrize("residency", RESIDENCIES)
def test_betweenness_phase_checkpoints(host, tmp_path, residency):
    """A checkpointed betweenness run snapshots each phase under its own
    subtree and equals the plain run; resuming the finished run replays
    both phases from their final snapshots."""
    s_base, s_ck = session(host), session(host)
    pol = ExecutionPolicy(backend="scan", residency=residency)
    src = [0, 1, 2]
    base = s_base.betweenness(src, policy=pol)
    ref = ref_session(host).betweenness(np.asarray(src),
                                        policy=repro.ExecutionPolicy(
                                            backend="scan"))
    np.testing.assert_allclose(base.values.numpy(), np.asarray(ref.values),
                               rtol=1e-5, atol=1e-5)
    spec = CheckpointSpec(tmp_path / "bc", every_k=2)
    ck = s_ck.betweenness(src, policy=pol, checkpoint=spec)
    assert_identical(base, ck)
    assert (tmp_path / "bc" / "fwd").is_dir()
    assert (tmp_path / "bc" / "bwd").is_dir()
    again = s_ck.betweenness(src, policy=pol, checkpoint=spec, resume=True)
    assert_identical(base, again)


def test_betweenness_backward_kill_resumes_there(host, tmp_path):
    """A crash in the backward sweep: the resumed call replays the forward
    phase from its final snapshot and resumes the backward one."""
    s = session(host)
    pol = ExecutionPolicy(backend="blocked")
    src = [0, 5]
    base = s.betweenness(src, policy=pol)
    spec = CheckpointSpec(tmp_path / "bc", every_k=1, async_save=False)
    from repro_torch.algs import betweenness as bcmod

    real = bcmod.run_program
    calls = []

    def crashing(*a, **kw):  # the second phase dies at its superstep 2
        calls.append(kw.get("checkpoint"))
        if len(calls) == 2:
            kw["_plan"] = FailurePlan({2: "crash"})
        return real(*a, **kw)

    bcmod.run_program = crashing
    try:
        with pytest.raises(DeviceFailure):
            s.betweenness(src, policy=pol, checkpoint=spec)
    finally:
        bcmod.run_program = real
    assert latest_step(tmp_path / "bc" / "bwd") == 2
    res = s.betweenness(src, policy=pol, checkpoint=spec, resume=True)
    assert_identical(base, res)


def test_betweenness_uni_groups_and_fused(host, tmp_path):
    s = session(host)
    pol = ExecutionPolicy(backend="compact")
    src = [0, 1, 2, 3, 4]
    base = s.betweenness(src, mode="uni", batch=2, policy=pol)
    spec = CheckpointSpec(tmp_path / "uni", every_k=2)
    ck = s.betweenness(src, mode="uni", batch=2, policy=pol, checkpoint=spec)
    assert_identical(base, ck)
    assert sorted(p.name for p in (tmp_path / "uni").iterdir()) == [
        "src_00000", "src_00002", "src_00004"]
    fused = s.betweenness(src, mode="fused")
    fspec = CheckpointSpec(tmp_path / "fused", every_k=2)
    assert_identical(fused, s.betweenness(src, mode="fused",
                                          checkpoint=fspec))
    assert_identical(fused, s.betweenness(src, mode="fused",
                                          checkpoint=fspec, resume=True))


@pytest.mark.parametrize("residency", RESIDENCIES)
def test_facade_threads_checkpoints(host, tmp_path, residency):
    """``Graph.run``/``bfs``/``pagerank`` take ``checkpoint``/``resume``:
    a killed façade call's directory resumes to the uninterrupted bits."""
    s = session(host)
    pol = ExecutionPolicy(backend="blocked", residency=residency)
    for name, call in (
        ("push", lambda **kw: s.pagerank(policy=pol, tol=1e-4, **kw)),
        ("bfs", lambda **kw: s.bfs([0, 9], policy=pol, **kw)),
        ("run", lambda **kw: s.run(BFSProgram(), seeds=[0, 9, 17], batch=3,
                                   policy=pol, **kw)),
        ("ppr", lambda **kw: s.pagerank(reset=[0, 9], policy=pol, **kw)),
    ):
        base = call()
        spec = CheckpointSpec(tmp_path / name, every_k=2)
        first = call(checkpoint=spec)
        assert_identical(base, first)
        assert_identical(base, call(checkpoint=spec, resume=True))


def test_checkpoint_overhead_free_parity(host, tmp_path):
    """checkpoint= with no crash perturbs nothing, on every backend."""
    s = session(host)
    prog = PageRankPushProgram(tol=1e-4)
    for backend in BACKENDS:
        pol = ExecutionPolicy(backend=backend)
        sem = s._sem(pol, prog)
        base = run_program(sem, prog, pol, max_supersteps=25)
        res = run_program(
            sem, prog, pol, max_supersteps=25,
            checkpoint=CheckpointSpec(tmp_path / backend, every_k=4))
        assert_identical(base, res)


def test_finished_run_resumes_instantly(host, tmp_path):
    sem, _ = views(host)
    prog = PageRankPullProgram(tol=1e-4)
    spec = CheckpointSpec(tmp_path, every_k=4)
    first = run_program(sem, prog, max_supersteps=25, checkpoint=spec)
    again = run_program(sem, prog, max_supersteps=25, checkpoint=spec,
                        resume=True, _plan=FailurePlan({0: "crash"}))
    assert_identical(first, again)  # no superstep ran: the plan never fired


def test_fingerprint_mismatch_raises(host, tmp_path):
    sem, _ = views(host)
    spec = CheckpointSpec(tmp_path, every_k=2)
    run_program(sem, PageRankPullProgram(tol=1e-3), max_supersteps=10,
                checkpoint=spec)
    with pytest.raises(CheckpointMismatchError, match="program"):
        run_program(sem, PageRankPullProgram(tol=1e-5), max_supersteps=10,
                    checkpoint=spec, resume=True)
    with pytest.raises(CheckpointMismatchError, match="program"):
        run_program(sem, BFSProgram(), seeds=torch.tensor([0]),
                    checkpoint=spec, resume=True)
    spec2 = CheckpointSpec(tmp_path / "s", every_k=2)
    run_program(sem, BFSProgram(), seeds=torch.tensor([0]), checkpoint=spec2)
    with pytest.raises(CheckpointMismatchError, match="seeds"):
        run_program(sem, BFSProgram(), seeds=torch.tensor([1]),
                    checkpoint=spec2, resume=True)
    other = session(rmat(6, edge_factor=6, seed=4, symmetrize=True)).device()
    with pytest.raises(CheckpointMismatchError, match="graph"):
        run_program(other, BFSProgram(), seeds=torch.tensor([0]),
                    checkpoint=spec2, resume=True)
    with pytest.raises(CheckpointMismatchError, match="policy"):
        run_program(sem, BFSProgram(), ExecutionPolicy(backend="compact"),
                    seeds=torch.tensor([0]), checkpoint=spec2, resume=True)


class _ResetPageRank(PersonalizedPageRankProgram):
    """A program whose ``__dict__`` holds a tensor: its restart weights."""

    def __init__(self, reset: torch.Tensor):
        super().__init__(tol=1e-3)
        self.reset = reset

    def init(self, sg, seeds):
        return super().init(sg, self.reset)


def test_program_tensor_field_is_fingerprinted(host, tmp_path):
    """Two programs that differ only in a tensor attribute are two runs:
    the fingerprint hashes the tensor's bytes, not its repr."""
    sem, _ = views(host)
    n = sem.n
    r1 = torch.zeros((n, 1))
    r1[:, 0] = 1.0 / n
    r2 = r1.clone()
    r2[n // 2, 0] += 1e-7  # below repr()'s four printed decimals
    assert repr(r1) == repr(r2) and not torch.equal(r1, r2)
    spec = CheckpointSpec(tmp_path, every_k=2)
    run_program_batched(sem, _ResetPageRank(r1), checkpoint=spec,
                        max_supersteps=8)
    with pytest.raises(CheckpointMismatchError, match="program"):
        run_program_batched(sem, _ResetPageRank(r2), checkpoint=spec,
                            resume=True, max_supersteps=8)
    same = run_program_batched(sem, _ResetPageRank(r1.clone()),
                               checkpoint=spec, resume=True,
                               max_supersteps=8)
    assert_identical(same, run_program_batched(sem, _ResetPageRank(r1),
                                               max_supersteps=8))


def test_ppr_reset_lives_in_seeds(host, tmp_path):
    """Personalized PageRank keeps its resets in ``seeds`` (as the
    reference does): another reset set is refused by the seeds
    fingerprint."""
    s = session(host)
    spec = CheckpointSpec(tmp_path, every_k=2)
    s.pagerank(reset=[0, 3], checkpoint=spec)
    with pytest.raises(CheckpointMismatchError, match="seeds"):
        s.pagerank(reset=[0, 4], checkpoint=spec, resume=True)


# ------------------------------------------------------------ supervisor
def test_gives_up_after_max_restarts(host, tmp_path):
    sem, _ = views(host)
    plan = FailurePlan({k: "crash" for k in range(0, 40)})
    with pytest.raises(DeviceFailure, match="gave up"):
        run_supervised(sem, PageRankPullProgram(tol=1e-4), max_supersteps=25,
                       checkpoint=CheckpointSpec(tmp_path, every_k=2),
                       plan=plan, max_restarts=3)


def test_report_records_resume_points(host, tmp_path):
    sem, _ = views(host)
    _, rep = run_supervised(
        sem, PageRankPullProgram(tol=1e-4), max_supersteps=25,
        checkpoint=CheckpointSpec(tmp_path, every_k=4),
        plan=FailurePlan({1: "crash", 9: "crash"}))
    assert rep.restarts == 2
    assert rep.resumed_steps == [None, 8]  # crash@1 pre-dates any save
    assert len(rep.log) == 2


def test_sync_odometer(host, tmp_path):
    sem, _ = views(host)
    tele = {}
    spec = CheckpointSpec(tmp_path / "t", every_k=2, telemetry=tele)
    run_program(sem, PageRankPullProgram(tol=1e-4), max_supersteps=10,
                checkpoint=spec)
    assert tele["saves"] >= 2
    assert tele["sync_s"] > 0.0
    assert spec.child("fwd").telemetry is tele
    assert spec == CheckpointSpec(tmp_path / "t", every_k=2)


def test_spec_threads_streaming_delta_through_driver(host, tmp_path):
    import json

    sem, _ = views(host)
    prog = PageRankPullProgram(tol=1e-4)
    base = run_program(sem, prog, max_supersteps=25)
    res, rep = run_supervised(
        sem, prog, max_supersteps=25,
        checkpoint=CheckpointSpec(tmp_path / "d", every_k=3,
                                  max_shard_bytes=2048, delta=True,
                                  async_save=False),
        plan=FailurePlan({7: "crash"}))
    assert rep.restarts == 1
    assert_identical(base, res)
    steps = sorted((tmp_path / "d").glob("step_*/manifest.json"))
    assert steps
    assert json.loads(steps[-1].read_text()).get("format") == 2


def test_spec_validation(tmp_path):
    for bad in (dict(every_k=0), dict(keep=0), dict(max_shard_bytes=0)):
        with pytest.raises(ValueError):
            CheckpointSpec(tmp_path, **bad)


# ------------------------------------------------- stream retry + checkpoints
def test_transient_faults_absorbed_bitwise_per_query(host):
    _, hv = views(host)
    prog = BFSProgram()
    pol = ExecutionPolicy(residency="host", stream_backoff_s=0.0)
    seeds = np.asarray([0, 3, 11], np.int32)
    base = run_program_batched(hv, prog, pol, seeds=seeds)
    assert int(base.iostats.retries) == 0
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] in (2, 4):
            raise OSError("transient link drop")

    with inject_stream_faults(flaky):
        res = run_program_batched(hv, prog, pol, seeds=seeds)
    assert int(res.iostats.retries) == 2
    assert_identical(base, res, skip=("retries",))


def test_exhaustion_leaves_no_half_committed_checkpoint(host, tmp_path):
    """StreamFailure after retry exhaustion mid-(n, Q) run: the checkpoint
    directory holds only complete snapshots, and resuming from it gives
    the fault-free result."""
    _, hv = views(host)
    prog = BFSProgram()
    seeds = np.asarray([0, 3, 11], np.int32)
    pol = ExecutionPolicy(residency="host", stream_retries=1,
                          stream_backoff_s=0.0)
    base = run_program_batched(hv, prog, pol, seeds=seeds)
    calls = [0]

    def dies_later():
        calls[0] += 1
        if calls[0] >= 3:
            raise OSError("link down")

    d = tmp_path / "b"
    spec = CheckpointSpec(d, every_k=1, async_save=False)
    with inject_stream_faults(dies_later):
        with pytest.raises(StreamFailure):
            run_program_batched(hv, prog, pol, seeds=seeds, checkpoint=spec)
    step = latest_step(d)
    assert step is not None and load_extra(d, step)["finished"] is False
    assert not list(d.glob("*.tmp"))
    res = run_program_batched(hv, prog, pol, seeds=seeds, checkpoint=spec,
                              resume=True)
    assert_identical(base, res, skip=("retries",))


# ------------------------------------------------------------ P17
@pytest.mark.parametrize("lanes", [None, 1, 5])
def test_ordered_add_is_index_add_from_zero(lanes):
    """The card's fixed-order sum (run here on the CPU) adds each key's
    terms one after another in edge order: from a zero ``y`` it gives
    the CPU ``index_add`` bits on every row but the sentinel (the last,
    which takes masked terms and which callers drop); interleaved +0.0
    terms change nothing."""
    g = torch.Generator().manual_seed(0)
    shape = (400,) if lanes is None else (400, lanes)
    keys = torch.randint(0, 38, (400,), generator=g)  # 37 is the sentinel
    contrib = torch.randn(shape, generator=g)
    y = PLUS_TIMES.neutral_like(contrib, 38)
    want = y.index_add(0, keys, contrib)
    got = _ordered_add(y, keys, contrib)
    assert torch.equal(got[:-1], want[:-1]) and not got[-1].any()
    # the same terms with 200 +0.0 terms interleaved, edge order kept
    order = torch.sort(torch.randperm(600, generator=g)[:400]).values
    k3 = torch.randint(0, 38, (600,), generator=g)
    c3 = torch.zeros((600,) + shape[1:])
    k3[order], c3[order] = keys, contrib
    assert torch.equal(_ordered_add(y, k3, c3)[:-1], want[:-1])


@pytest.mark.parametrize("lanes", [None, 1, 5])
def test_ordered_add_with_no_terms(lanes):
    """No terms at all (a compact gather that finds no live chunk) leave
    ``y``'s bits as they are, in a copy, as ``index_add`` does."""
    shape = (38,) if lanes is None else (38, lanes)
    y = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    keys = torch.zeros(0, dtype=torch.int64)
    got = _ordered_add(y, keys, torch.zeros((0,) + shape[1:]))
    assert torch.equal(got, y.index_add(0, keys, torch.zeros((0,) + shape[1:])))
    assert got.data_ptr() != y.data_ptr()


def test_sink_ppr_with_the_ordered_add(host, monkeypatch):
    """One-hot personalized PageRank from a sink that lies outside every
    chunk's [lo, hi] (an extra vertex with no edges): its first compact
    gather finds no live chunk.  With the card's fixed-order add put in
    place of ``index_add`` here on the CPU, the run matches the
    ``index_add`` run."""
    from repro_torch.core import semiring
    from repro_torch.graph.csr import from_edges

    src = np.repeat(np.arange(host.n), np.diff(host.indptr))
    G = repro_torch.Graph(from_edges(src, host.indices, n=host.n + 1),
                          chunk_size=64, bd=32, bs=32, device="cpu")
    pol = ExecutionPolicy(backend="compact", switch_fraction=None)
    want = G.pagerank(reset=[host.n], policy=pol)
    empty = []
    plain = semiring.Semiring.scatter

    def ordered(self, y, keys, contrib):
        if self.combine != "add" or not y.is_floating_point():
            return plain(self, y, keys, contrib)
        empty.append(keys.numel() == 0)
        return _ordered_add(y, keys, contrib.to(y.dtype))

    monkeypatch.setattr(semiring.Semiring, "scatter", ordered)
    got = G.pagerank(reset=[host.n], policy=pol)
    assert any(empty)
    torch.testing.assert_close(got.values, want.values, **PR_TOL)
    assert int(got.supersteps) == int(want.supersteps)
    assert [int(v) for v in got.iostats] == [int(v) for v in want.iostats]
