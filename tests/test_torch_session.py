"""The slice end to end: ``repro_torch.Graph`` against ``repro.Graph``.

PageRank (push and pull) and BFS run through both façades on every
backend.  Tolerances: BFS levels and every IOStats field exact; PageRank
``atol=1e-6, rtol=1e-5`` in f32 (the scatter and tile sums add in another
order).  K-lane BFS is held against the reference's ``run_program`` with
``seeds`` of shape [K] — the reference façade routes a multi-source call
to its batched driver, which the installed JAX cannot run; the port's
batched driver stamps ``iostats.queries`` K where that inline run leaves
it 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.algs import BFSProgram as RBFSProgram
from repro.graph.generators import rmat

import repro_torch

BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
PR_TOL = dict(atol=1e-6, rtol=1e-5)


def _io_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert int(x) == int(y), f"IOStats.{name}: {int(x)} != {int(y)}"


@pytest.fixture(scope="module")
def sessions():
    g = rmat(8, edge_factor=8, seed=2)
    kw = dict(chunk_size=128, bd=32, bs=32)
    return (repro.Graph(g, **kw), repro_torch.Graph(g, device="cpu", **kw))


def _pols(backend, **kw):
    return (repro.ExecutionPolicy(backend=backend, **kw),
            repro_torch.ExecutionPolicy(backend=backend, **kw))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["push", "pull"])
@pytest.mark.parametrize("chunk_cap", [None, 8])
def test_pagerank(sessions, backend, mode, chunk_cap):
    ref, port = sessions
    rpol, tpol = _pols(backend, chunk_cap=chunk_cap)
    want = ref.pagerank(mode=mode, tol=1e-4, policy=rpol)
    got = port.pagerank(mode=mode, tol=1e-4, policy=tpol)
    assert got.values.dtype == torch.float32
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **PR_TOL)
    assert int(got.supersteps) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs_single_source(sessions, backend):
    ref, port = sessions
    rpol, tpol = _pols(backend)
    want = ref.bfs(0, policy=rpol)
    got = port.bfs(0, policy=tpol)
    assert got.values.shape == (port.n,)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert int(got.supersteps) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", ["out", "auto"])
def test_bfs_k_lanes(sessions, backend, direction):
    ref, port = sessions
    rpol, tpol = _pols(backend, direction=direction, switch_fraction=None)
    sources = [0, 5, 17, 99]
    prog = RBFSProgram()
    want = repro.run_program(ref._sem(rpol, prog), prog, rpol,
                             seeds=jnp.asarray(sources, jnp.int32))
    got = port.bfs(sources, policy=tpol)
    assert got.values.shape == (port.n, len(sources))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert int(got.supersteps) == int(want.supersteps)
    assert got.query_supersteps.shape == (len(sources),)
    assert int(got.query_supersteps.max()) == int(got.supersteps)
    # the batched driver's label: K queries
    _io_equal(got.iostats, want.iostats._replace(
        queries=jnp.asarray(len(sources), jnp.int32)))


def test_hilbert_tile_order(sessions):
    """A curve-ordered tile view: same values, its own x-fetch count."""
    ref, port = sessions
    rpol, tpol = _pols("blocked", tile_order="hilbert")
    want = ref.pagerank(tol=1e-4, policy=rpol)
    got = port.pagerank(tol=1e-4, policy=tpol)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **PR_TOL)
    _io_equal(got.iostats, want.iostats)


def test_views_are_cached(sessions):
    _, port = sessions
    pol = repro_torch.ExecutionPolicy(backend="blocked")
    port.pagerank(policy=pol)
    view = port.device(blocked=True)
    port.bfs(0, policy=pol)
    assert port.device(blocked=True) is view
    report = port.memory_report()
    tiles = report["device_views"]["tiles:plus_times:fwd:dest"]
    assert tiles >= view.out_blocked.tiles.nbytes
    assert report["device_total"] == sum(report["device_views"].values())
    assert report["device_edge_total"] <= report["device_total"]


def test_device_memory_report_equals_the_reference():
    """Device tile views (``blocked`` and ``blocked_compact``, a reverse
    view for pull, a curve order) reported field for field as the
    reference's own ``memory_report`` reports them: the payloads the port
    holds beside the tiles are not in it (ROADMAP §C P14)."""
    g = rmat(8, edge_factor=8, seed=2)
    kw = dict(chunk_size=128, bd=32, bs=32)
    ref, port = repro.Graph(g, **kw), repro_torch.Graph(g, device="cpu", **kw)
    for backend, mode, order in (("blocked", "push", "dest"),
                                 ("blocked_compact", "pull", "dest"),
                                 ("blocked_compact", "push", "hilbert")):
        rpol, tpol = _pols(backend, tile_order=order)
        ref.pagerank(mode=mode, tol=1e-3, policy=rpol)
        port.pagerank(mode=mode, tol=1e-3, policy=tpol)
    for backend in ("blocked", "blocked_compact", "scan"):
        rpol, tpol = _pols(backend)
        want, got = ref.memory_report(rpol), port.memory_report(tpol)
        assert len(got["device_views"]) >= 3
        assert got == want
    bg = port.device(blocked=True).out_blocked
    assert bg.payload_nbytes > 0


def test_later_slices_raise(sessions, tmp_path):
    """``checkpoint=`` (A12) and ``analyze=True`` (A13), which raised here
    before they were ported, now run and change nothing."""
    _, port = sessions
    host = repro_torch.ExecutionPolicy(residency="host")
    spec = repro_torch.CheckpointSpec(tmp_path / "pr", every_k=3)
    got = port.pagerank(policy=host, checkpoint=spec)
    assert torch.equal(got.values, port.pagerank(policy=host).values)
    got = port.bfs(0, checkpoint=repro_torch.CheckpointSpec(tmp_path / "b"))
    assert torch.equal(got.values, port.bfs(0).values)
    got = port.run(repro_torch.algs.BFSProgram(), seeds=[0], analyze=True)
    want = port.run(repro_torch.algs.BFSProgram(), seeds=[0])
    assert torch.equal(got.values, want.values)
    _io_equal(got.iostats, want.iostats)


def test_pagerank_reset_runs(sessions):
    """Personalized PageRank (once a later slice) now runs: each column
    within tolerance of the reference's width-one run."""
    from repro.algs.pagerank import PersonalizedPageRankProgram as RPPR

    ref, port = sessions
    got = port.pagerank(reset=[0, 1])
    assert got.values.shape == (port.n, 2) and int(got.iostats.queries) == 2
    for q in (0, 1):
        prog = RPPR()
        want = repro.run_program(ref.device(), prog,
                                 seeds=jnp.asarray([q], jnp.int32))
        np.testing.assert_allclose(got.values[:, q].numpy(),
                                   np.asarray(want.values[:, 0]), **PR_TOL)
        assert int(got.query_supersteps[q]) == int(want.supersteps)


def test_run_batch_runs(sessions):
    """``run(batch=1)`` (once a later slice) now runs the batched driver:
    values and counters of the reference's run, labelled one query."""
    ref, port = sessions
    got = port.run(repro_torch.algs.BFSProgram(), seeds=[0], batch=1)
    want = ref.run(RBFSProgram(), seeds=jnp.asarray([0], jnp.int32))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert int(got.query_supersteps[0]) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats._replace(
        queries=jnp.asarray(1, jnp.int32)))


def test_run_custom_program_matches_bfs(sessions):
    _, port = sessions
    via_run = port.run(repro_torch.algs.BFSProgram(), seeds=[3])
    via_bfs = port.bfs(3)
    assert torch.equal(via_run.values[:, 0], via_bfs.values)


def test_from_csr_and_from_edges(sessions):
    """Both constructors build the host image the reference's do."""
    ref, port = sessions
    g = ref.host
    a = repro_torch.Graph.from_csr(g.indptr, g.indices, device="cpu")
    b = repro.Graph.from_csr(g.indptr, g.indices)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    c = repro_torch.Graph.from_edges(src, g.indices, n=g.n, device="cpu")
    for name in ("indptr", "indices", "in_indptr", "in_indices"):
        want = getattr(b.host, name)
        assert np.array_equal(getattr(a.host, name), want), name
        assert np.array_equal(getattr(c.host, name), want), name
    np.testing.assert_array_equal(a.bfs(0).values.numpy(),
                                  np.asarray(b.bfs(0).values))
