"""The batched (n, Q) driver of the port against the reference.

The reference's own batched driver (``repro.core.run_program_batched``)
cannot run on the installed JAX (its superstep needs
``jax.core.jaxpr_as_fun``), so the port's is held against what its
docstring promises, on the reference's ``tests/test_multisource.py``
workload (``rmat(8, edge_factor=8, seed=2, symmetrize=True)``, 128-edge
chunks, 32x32 tiles):

  * each batched column equals its solo run of ``repro.run_program``
    (values exact; ``query_supersteps[q]`` its superstep count; the total
    their max), on all four backends and both residencies;
  * the union fetch's counters equal the reference's own K-lane
    ``run_program`` (one inline loop over the same (n, Q) program) where
    no column retires mid-run, ``messages`` equals the solo runs' sum, and
    ``iostats.queries == Q``;
  * permuting the sources permutes the columns; retirement reassembles
    equal columns; personalized PageRank columns lie within ``atol=1e-6,
    rtol=1e-5`` of width-one reference runs;
  * ``benchmarks/bench_multisource.py``'s counters (``BENCH_PR8.json``)
    are reproduced.

Tolerances: integers exact, f32 ``atol=1e-6, rtol=1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.algs.bfs import BFSProgram as RBFSProgram
from repro.algs.pagerank import PersonalizedPageRankProgram as RPPR
from repro.graph.generators import rmat

import repro_torch
from repro_torch.algs import BFSProgram, PersonalizedPageRankProgram
from repro_torch.core import program as tprog
from repro_torch.core import run_program_batched
from repro_torch.kernels import spmv as tk

BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
SOURCES = (0, 5, 17, 99)
PR_TOL = dict(atol=1e-6, rtol=1e-5)
KW = dict(chunk_size=128, bd=32, bs=32)
RESIDENCY_FIELDS = ("host_bytes", "retries")


@pytest.fixture(scope="module")
def sessions():
    g = rmat(8, edge_factor=8, seed=2, symmetrize=True)
    return repro.Graph(g, **KW), repro_torch.Graph(g, device="cpu", **KW)


def _pols(backend, residency="device"):
    kw = dict(backend=backend, chunk_cap=8, switch_fraction=None)
    return (repro.ExecutionPolicy(**kw),
            repro_torch.ExecutionPolicy(residency=residency, **kw))


def _io(io, skip=("queries",)):
    return {f: int(v) for f, v in zip(io._fields, io) if f not in skip}


def _ref_solo(ref, rpol, prog, seeds):
    return repro.run_program(ref._sem(rpol, prog), prog, rpol, seeds=seeds)


@pytest.mark.parametrize("residency", ["device", "host"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs_batched_equals_q_solo_runs(sessions, backend, residency):
    ref, port = sessions
    rpol, tpol = _pols(backend, residency)
    prog = BFSProgram()
    res = run_program_batched(port._sem(tpol, prog), prog, tpol,
                              seeds=list(SOURCES))
    assert int(res.iostats.queries) == len(SOURCES)
    solo_steps, solo_msgs = [], 0
    for q, s in enumerate(SOURCES):
        solo = _ref_solo(ref, rpol, RBFSProgram(), jnp.asarray([s], jnp.int32))
        np.testing.assert_array_equal(res.values[:, q].numpy(),
                                      np.asarray(solo.values[:, 0]))
        assert int(res.query_supersteps[q]) == int(solo.supersteps)
        solo_steps.append(int(solo.supersteps))
        solo_msgs += int(solo.iostats.messages)
    assert int(res.supersteps) == max(solo_steps)
    assert int(res.iostats.messages) == solo_msgs
    # The union fetch: the reference's K-lane run of the same program.
    lanes = _ref_solo(ref, rpol, RBFSProgram(),
                      jnp.asarray(SOURCES, jnp.int32))
    skip = ("queries",) + (RESIDENCY_FIELDS if residency == "host" else ())
    assert _io(res.iostats, skip) == _io(lanes.iostats, skip)
    if residency == "host":
        assert int(res.iostats.host_bytes) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_host_equals_batched_device(sessions, backend):
    _, port = sessions
    _, dpol = _pols(backend)
    _, hpol = _pols(backend, "host")
    prog = BFSProgram()
    d = run_program_batched(port._sem(dpol, prog), prog, dpol,
                            seeds=list(SOURCES))
    h = run_program_batched(port._sem(hpol, prog), prog, hpol,
                            seeds=list(SOURCES))
    assert torch.equal(d.values, h.values)
    assert torch.equal(d.query_supersteps, h.query_supersteps)
    skip = RESIDENCY_FIELDS
    assert _io(d.iostats, skip) == _io(h.iostats, skip)


def test_order_invariance(sessions):
    _, port = sessions
    _, pol = _pols("compact")
    sem = port._sem(pol, BFSProgram())
    perm = [2, 0, 3, 1]
    a = run_program_batched(sem, BFSProgram(), pol, seeds=list(SOURCES))
    b = run_program_batched(sem, BFSProgram(), pol,
                            seeds=[SOURCES[p] for p in perm])
    assert torch.equal(b.values, a.values[:, perm])
    assert torch.equal(b.query_supersteps, a.query_supersteps[perm])
    assert _io(a.iostats, ()) == _io(b.iostats, ())


def test_batched_equals_plain_driver(sessions):
    """The plain driver runs the same (n, Q) program: equal values and
    counters, the batch label aside."""
    _, port = sessions
    _, pol = _pols("scan")
    sem = port._sem(pol, BFSProgram())
    batched = run_program_batched(sem, BFSProgram(), pol, seeds=list(SOURCES))
    plain = repro_torch.run_program(sem, BFSProgram(), pol,
                                    seeds=list(SOURCES))
    assert torch.equal(batched.values, plain.values)
    assert int(batched.supersteps) == int(plain.supersteps)
    assert _io(batched.iostats) == _io(plain.iostats)
    assert int(plain.iostats.queries) == 0 and plain.query_supersteps is None


def _mixed_resets(n):
    """Reset distributions of very different support: the queries converge
    at different supersteps, which forces retirement."""
    rng = np.random.default_rng(0)
    resets = np.zeros((n, 5), np.float32)
    resets[0, 0] = 1.0
    resets[:, 1] = 1.0
    resets[rng.choice(n, 7, replace=False), 2] = 1.0
    resets[5, 3] = 1.0
    resets[:128, 4] = 1.0
    return resets


@pytest.mark.parametrize("backend", ["scan", "blocked"])
def test_retirement_reassembles_solo_columns(sessions, backend):
    """Columns retire into pow2 widths mid-run (the kernels see 8, 4, ...
    lanes); every column equals its own width-one run of the port bit for
    bit, and the width-one reference run (on the scan backend, which the
    reference runs without its interpreted kernels) within tolerance."""
    ref, port = sessions
    _, tpol = _pols(backend)
    rpol, _ = _pols("scan")
    prog = PersonalizedPageRankProgram(tol=1e-3)
    sem = port._sem(tpol, prog)
    resets = _mixed_resets(port.n)
    widths = []
    take = prog.take_cols

    def spy(state, cols, width):
        widths.append((width, len(cols)))
        return take(state, cols, width)

    prog.take_cols = spy
    res = run_program_batched(sem, prog, tpol, seeds=resets)
    del prog.take_cols
    steps = res.query_supersteps.numpy()
    assert steps.min() < steps.max()
    assert any(w > c for w, c in widths), "no column retired"
    assert res.state is None
    assert int(res.supersteps) == steps.max()
    for q in range(resets.shape[1]):
        solo = run_program_batched(sem, PersonalizedPageRankProgram(tol=1e-3),
                                   tpol, seeds=resets[:, q:q + 1])
        assert torch.equal(res.values[:, q], solo.values[:, 0]), q
        assert steps[q] == int(solo.supersteps)
        want = _ref_solo(ref, rpol, RPPR(tol=1e-3),
                         jnp.asarray(resets[:, q:q + 1]))
        np.testing.assert_allclose(res.values[:, q].numpy(),
                                   np.asarray(want.values[:, 0]), **PR_TOL)
        if backend == "scan":
            assert steps[q] == int(want.supersteps)


@pytest.mark.parametrize("residency", ["device", "host"])
def test_ppr_one_hot_equals_width_one_reference(sessions, residency):
    ref, port = sessions
    rpol, tpol = _pols("scan", residency)
    res = port.pagerank(reset=list(SOURCES), policy=tpol)
    assert res.values.shape == (port.n, len(SOURCES))
    assert int(res.iostats.queries) == len(SOURCES)
    for q, s in enumerate(SOURCES):
        want = _ref_solo(ref, rpol, RPPR(), jnp.asarray([s], jnp.int32))
        np.testing.assert_allclose(res.values[:, q].numpy(),
                                   np.asarray(want.values[:, 0]), **PR_TOL)
        assert int(res.query_supersteps[q]) == int(want.supersteps)


@pytest.mark.parametrize("backend", ["blocked", "blocked_compact"])
def test_ppr_matrix_reset(sessions, backend):
    """A float (n, Q) reset matrix (columns normalized to sum 1) through
    the blocked kernels' plain versions, against the reference's scan."""
    ref, port = sessions
    rpol, _ = _pols("scan")
    _, tpol = _pols(backend)
    reset = np.random.default_rng(3).random((port.n, 3))
    res = port.pagerank(reset=reset, policy=tpol)
    for q in range(3):
        want = _ref_solo(ref, rpol, RPPR(), jnp.asarray(reset[:, q:q + 1]))
        np.testing.assert_allclose(res.values[:, q].numpy(),
                                   np.asarray(want.values[:, 0]), **PR_TOL)
    with pytest.raises(ValueError, match="push"):
        port.pagerank(reset=[0], mode="pull")


def test_run_batch(sessions):
    _, port = sessions
    _, pol = _pols("blocked")
    via_run = port.run(BFSProgram(), seeds=list(SOURCES), batch=4, policy=pol)
    via_bfs = port.bfs(list(SOURCES), policy=pol)
    assert torch.equal(via_run.values, via_bfs.values)
    assert torch.equal(via_run.query_supersteps, via_bfs.query_supersteps)
    assert _io(via_run.iostats, ()) == _io(via_bfs.iostats, ())
    with pytest.raises(ValueError, match="batch=3"):
        port.run(BFSProgram(), seeds=list(SOURCES), batch=3)


def test_unbatched_program_is_refused(sessions):
    _, port = sessions
    prog = repro_torch.algs.PageRankPushProgram()
    with pytest.raises(ValueError, match=r"\(n, Q\)"):
        run_program_batched(port.device(), prog)


def test_take_cols_walks_nested_state():
    """Tuples, lists, dicts and NamedTuples are walked; only tensors whose
    last dim is the width are sliced."""
    st = {"a": (torch.arange(8).view(2, 4), [torch.ones(3), 7]),
          "b": torch.zeros(4, 4)}
    out = repro_torch.VertexProgram().take_cols(st, [3, 1], 4)
    assert torch.equal(out["a"][0], torch.tensor([[3, 1], [7, 5]]))
    assert torch.equal(out["a"][1][0], torch.ones(3)) and out["a"][1][1] == 7
    assert out["b"].shape == (4, 2)
    parts = [([2], torch.tensor([[20.0]])), ([0, 1], torch.tensor([[0.0, 10.0]]))]
    assert torch.equal(tprog._reassemble_values(parts, 3),
                       torch.tensor([[0.0, 10.0, 20.0]]))
    assert [tprog._pow2_at_least(k) for k in (0, 1, 3, 8, 9)] == [1, 1, 4, 8, 16]


def test_193_lanes_through_the_plain_version():
    """More lanes than one card launch takes (192) run on the CPU's plain
    version unchanged: each lane equals its own width-one product."""
    g = rmat(8, edge_factor=8, seed=2)
    bg = tk.build_blocked(g, bd=32, bs=32, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).random((g.n, 193)),
                        dtype=torch.float32)
    act = torch.arange(g.n) % 3 == 0
    for compact in (False, True):
        y, _ = tk.blocked_spmv(bg, x, active=act, compact=compact)
        assert y.shape == (g.n, 193)
        for lane in (0, 96, 192):
            y1, _ = tk.blocked_spmv(bg, x[:, lane], active=act,
                                    compact=compact)
            assert torch.equal(y[:, lane], y1)


def test_bench_multisource_counters():
    """``benchmarks/bench_multisource.py``'s workload (Q=8, scan, p2p arm
    off) reproduces the counters ``BENCH_PR8.json`` recorded: host Q=8
    host_bytes 2,294,880 against a solo mean of 1,356,438 (4.73x fewer
    bytes a query) and device Q=8 records 273,664 against 156,448; the
    device records also equal the reference's K-lane run."""
    g = rmat(12, edge_factor=16, seed=2, symmetrize=True)
    kw = dict(chunk_size=256, bd=32, bs=32)
    port = repro_torch.Graph(g, device="cpu", **kw)
    ref = repro.Graph(g, **kw)
    sources = np.random.default_rng(7).choice(g.n, 8, replace=False)
    want = {"host": ("host_bytes", 2_294_880, 1_356_438),
            "device": ("records", 273_664, 156_448)}
    for residency, (meter, batched, solo_mean) in want.items():
        pol = repro_torch.ExecutionPolicy(backend="scan", switch_fraction=None,
                                          residency=residency)
        sem = port._sem(pol, BFSProgram())
        res = run_program_batched(sem, BFSProgram(), pol, seeds=sources)
        solo = [repro_torch.run_program(sem, BFSProgram(), pol,
                                        seeds=sources[i:i + 1])
                for i in range(8)]
        assert int(getattr(res.iostats, meter)) == batched
        mean = np.mean([int(getattr(r.iostats, meter)) for r in solo])
        assert mean == solo_mean
        for i, r in enumerate(solo):
            assert torch.equal(res.values[:, i], r.values[:, 0])
            assert int(res.query_supersteps[i]) == int(r.supersteps)
        if residency == "host":
            assert solo_mean / (batched / 8) >= 4.0
    rpol = repro.ExecutionPolicy(backend="scan", switch_fraction=None)
    lanes = repro.run_program(ref._sem(rpol, RBFSProgram()), RBFSProgram(),
                              rpol, seeds=jnp.asarray(sources, jnp.int32))
    assert int(lanes.iostats.records) == 273_664
