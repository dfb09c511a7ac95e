"""The remaining algorithms of the port against ``repro.Graph``.

Coreness, betweenness, diameter, triangles and Louvain through
``repro_torch.Graph(g, device="cpu")`` and ``repro.Graph(g)`` on the
graphs of ``tests/test_algorithms.py``.  Tolerances: integer results and
every IOStats counter exact (the reference's counters here are all
order-invariant: these runs have one tile order); betweenness, an f32 sum
over source lanes, within ``rtol=1e-5`` (``atol=1e-6`` for the zeros).
The host variants of triangle counting and Louvain are numpy copies and
must agree field for field.
"""
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import repro
from repro.algs import triangles_blocked_mxu as r_mxu
from repro.graph import cycle_graph, erdos_renyi, from_edges, path_graph

import repro_torch
from repro_torch.algs import diameter as tdiam
from repro_torch.algs import triangles_blocked_mxu as t_mxu

BC_TOL = dict(rtol=1e-5, atol=1e-6)


def _sessions(g, chunk_size):
    kw = dict(chunk_size=chunk_size, bd=32, bs=32)
    return repro.Graph(g, **kw), repro_torch.Graph(g, device="cpu", **kw)


def _pols(backend=None, residency="device", **kw):
    if backend is None:
        return None, None
    return (repro.ExecutionPolicy(backend=backend, **kw),
            repro_torch.ExecutionPolicy(backend=backend, residency=residency,
                                        **kw))


def _io_equal(got, want, skip=()):
    for name, x, y in zip(got._fields, got, want):
        if name not in skip:
            assert int(x) == int(y), f"IOStats.{name}: {int(x)} != {int(y)}"


@pytest.fixture(scope="module")
def ugraph():
    return _sessions(erdos_renyi(250, 1000, seed=2, symmetrize=True), 256)


@pytest.fixture(scope="module")
def small():
    return _sessions(erdos_renyi(48, 180, seed=3, symmetrize=True), 64)


# ---------------------------------------------------------------- coreness
@pytest.mark.parametrize("messaging", ["dense", "p2p", "hybrid"])
@pytest.mark.parametrize("prune", [False, True])
def test_coreness(ugraph, messaging, prune):
    ref, port = ugraph
    want = ref.coreness(prune=prune, messaging=messaging)
    got = port.coreness(prune=prune, messaging=messaging)
    assert got.values.dtype == torch.int32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert int(got.supersteps) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats)


@pytest.mark.parametrize("messaging,backend,residency", [
    ("dense", "blocked", "device"),
    ("hybrid", "blocked_compact", "device"),
    ("p2p", "scan", "host"),
    ("hybrid", "compact", "host"),
    ("dense", "blocked_compact", "host"),
])
def test_coreness_backends(ugraph, messaging, backend, residency):
    """Coreness on the blocked kernels' plain versions and on host
    residency (IOStats but host_bytes and retries against the reference's
    device residency)."""
    ref, port = ugraph
    rpol, tpol = _pols(backend, residency)
    want = ref.coreness(messaging=messaging, policy=rpol)
    got = port.coreness(messaging=messaging, policy=tpol)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    skip = ("host_bytes", "retries") if residency == "host" else ()
    _io_equal(got.iostats, want.iostats, skip)


@pytest.fixture(scope="module")
def ref_coreness(ugraph):
    """The reference's device coreness per (backend, messaging), computed
    once for both residencies of the port."""
    ref, _ = ugraph
    memo = {}

    def get(backend, messaging):
        if (backend, messaging) not in memo:
            memo[backend, messaging] = ref.coreness(
                messaging=messaging, policy=_pols(backend)[0])
        return memo[backend, messaging]

    return get


@pytest.mark.parametrize("messaging", ["dense", "p2p", "hybrid"])
@pytest.mark.parametrize("backend", ["scan", "compact", "blocked",
                                     "blocked_compact"])
@pytest.mark.parametrize("residency", ["device", "host"])
def test_coreness_sync_free_grid(ugraph, ref_coreness, messaging, backend,
                                 residency):
    """Coreness's hooks read nothing to the host (their rounds that remove
    nothing still call the engine and zero its counters): values,
    supersteps and the ten IOStats fields equal the reference's on every
    backend, residency and messaging mode (host_bytes and retries aside
    on host, against the reference's device driver), and the analyzer
    finds nothing, R2 included."""
    from repro_torch import analysis
    from repro_torch.algs import CorenessProgram

    _, port = ugraph
    tpol = _pols(backend, residency)[1]
    want = ref_coreness(backend, messaging)
    got = port.coreness(messaging=messaging, policy=tpol)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert int(got.supersteps) == int(want.supersteps)
    skip = ("host_bytes", "retries") if residency == "host" else ()
    _io_equal(got.iostats, want.iostats, skip)
    assert got.state.k.dtype == torch.int32 and got.state.k.ndim == 0
    rep = analysis.check(port, CorenessProgram(messaging=messaging), tpol)
    assert rep.ok, rep.render()


def test_coreness_matches_networkx(ugraph):
    ref, port = ugraph
    want = nx.core_number(nx.Graph(list(zip(*ref.host.edges()))))
    got = port.coreness().values.numpy()
    assert all(got[v] == c for v, c in want.items())
    with pytest.raises(ValueError, match="messaging"):
        port.coreness(messaging="bogus")


# ------------------------------------------------------------- betweenness
BC_SOURCES = [0, 3, 7, 12, 30, 47]


@pytest.mark.parametrize("backend", [None, "compact", "blocked",
                                     "blocked_compact"])
def test_betweenness_multi(small, backend):
    ref, port = small
    rpol, tpol = _pols(backend)
    want = ref.betweenness(jnp.asarray(BC_SOURCES, jnp.int32), policy=rpol)
    got = port.betweenness(BC_SOURCES, policy=tpol)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **BC_TOL)
    assert int(got.supersteps) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats)


@pytest.mark.parametrize("backend,batch", [
    (None, None), (None, 1), (None, 4), ("blocked", 4)])
def test_betweenness_uni(small, backend, batch):
    ref, port = small
    rpol, tpol = _pols(backend)
    want = ref.betweenness(jnp.asarray(BC_SOURCES, jnp.int32), mode="uni",
                           batch=batch, policy=rpol)
    got = port.betweenness(BC_SOURCES, mode="uni", batch=batch, policy=tpol)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **BC_TOL)
    assert int(got.supersteps) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats)  # queries: K when batch is given


def test_betweenness_fused(small):
    ref, port = small
    want = ref.betweenness(jnp.asarray(BC_SOURCES, jnp.int32), mode="fused")
    got = port.betweenness(BC_SOURCES, mode="fused")
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **BC_TOL)
    assert int(got.supersteps) == int(want.supersteps)
    assert int(got.state.shared) == int(want.state.shared)
    np.testing.assert_array_equal(got.state.phase.numpy(),
                                  np.asarray(want.state.phase))
    _io_equal(got.iostats, want.iostats)


def test_betweenness_host_and_full(small):
    """Exact BC (every vertex a source) against networkx, and host
    residency against the device run."""
    ref, port = small
    g = ref.host
    want = nx.betweenness_centrality(nx.Graph(list(zip(*g.edges()))),
                                     normalized=False)
    got = port.betweenness(range(g.n)).values.numpy()
    # a symmetrized digraph counts each undirected path twice
    np.testing.assert_allclose([got[v] / 2 for v in want],
                               list(want.values()), atol=1e-3)
    _, hpol = _pols("blocked_compact", "host")
    dev = port.betweenness(BC_SOURCES, policy=_pols("blocked_compact")[1])
    host = port.betweenness(BC_SOURCES, policy=hpol)
    assert torch.equal(host.values, dev.values)
    _io_equal(host.iostats, dev.iostats, ("host_bytes", "retries"))


def test_betweenness_errors(small):
    _, port = small
    with pytest.raises(ValueError, match="sources"):
        port.betweenness()
    with pytest.raises(ValueError, match="uni"):
        port.betweenness([0], batch=2)
    with pytest.raises(ValueError, match="policy"):
        port.betweenness([0], mode="fused",
                         policy=repro_torch.ExecutionPolicy())
    with pytest.raises(ValueError, match="mode"):
        port.betweenness([0], mode="bogus")


# ---------------------------------------------------------------- diameter
@pytest.mark.parametrize("mode,backend", [
    ("multi", None), ("uni", None), ("multi", "blocked_compact")])
def test_diameter(ugraph, mode, backend):
    ref, port = ugraph
    rpol, tpol = _pols(backend)
    want = ref.diameter(num_sources=8, sweeps=2, mode=mode, policy=rpol)
    got = port.diameter(num_sources=8, sweeps=2, mode=mode, policy=tpol)
    assert int(got.values) == int(want.values)
    assert int(got.supersteps) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats)


@pytest.mark.parametrize("graph,mode,want", [
    (path_graph(64), "multi", 63),
    (cycle_graph(50), "multi", 25),
    (cycle_graph(50), "uni", 25),
])
def test_diameter_ties(graph, mode, want):
    """Every vertex of a cycle or path ties with others on degree and on
    distance: the stable sort (and the first maximum) pick the same
    sources in both packages, so the counters of every sweep agree."""
    ref, port = _sessions(graph, 64)
    w = ref.diameter(num_sources=3, sweeps=2, mode=mode)
    got = port.diameter(num_sources=3, sweeps=2, mode=mode)
    assert int(got.values) == int(w.values) == want
    assert int(got.supersteps) == int(w.supersteps)
    _io_equal(got.iostats, w.iostats)


def test_farthest_breaks_ties_to_the_lower_id():
    unreached = int(repro_torch.algs.UNREACHED)
    dist = torch.tensor([3, 5, unreached, 5, 1, 5], dtype=torch.int32)
    assert tdiam._farthest(dist, 2).tolist() == [1, 3]
    assert tdiam._farthest(dist, 4).tolist() == [1, 3, 5, 0]


# --------------------------------------------------------------- triangles
@pytest.fixture(scope="module")
def tri():
    return _sessions(erdos_renyi(120, 700, seed=4, symmetrize=True), 64)


@pytest.mark.parametrize("variant", ["scan", "binary", "restarted", "hash"])
@pytest.mark.parametrize("ordered", [False, True])
def test_triangles_ladder(tri, variant, ordered):
    ref, port = tri
    kw = dict(variant=variant, ordered=ordered,
              hash_threshold=8 if variant == "hash" else 0)
    want, got = ref.triangles(**kw), port.triangles(**kw)
    assert got.values == want.values
    assert (got.state.comparisons, got.state.row_requests,
            got.state.records) == (want.state.comparisons,
                                   want.state.row_requests,
                                   want.state.records)
    _io_equal(got.iostats, want.iostats)


@pytest.mark.parametrize("block", [32, 64, 256])
def test_triangles_blocked_mxu(tri, block):
    ref, port = tri
    g = ref.host
    assert t_mxu(g, block=block, device="cpu") == r_mxu(g, block=block)
    pol = _pols("blocked")
    assert port.triangles(policy=pol[1]).values == \
        ref.triangles(policy=pol[0]).values
    with pytest.raises(ValueError, match="residency"):
        port.triangles(policy=pol[1].with_(residency="host"))


# ----------------------------------------------------------------- louvain
@pytest.fixture(scope="module")
def sbm():
    sizes = [40, 40, 40]
    P = [[0.35, 0.01, 0.01], [0.01, 0.35, 0.01], [0.01, 0.01, 0.35]]
    G = nx.stochastic_block_model(sizes, P, seed=5)
    e = np.array(G.edges())
    return _sessions(from_edges(e[:, 0], e[:, 1], n=120, symmetrize=True), 64)


@pytest.mark.parametrize("materialize", [False, True])
def test_louvain(sbm, materialize):
    ref, port = sbm
    want = ref.louvain(materialize=materialize)
    got = port.louvain(materialize=materialize)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    r, w = got.state, want.state
    assert (r.modularity, r.levels, r.bytes_written, r.gather_ops) == \
        (w.modularity, w.levels, w.bytes_written, w.gather_ops)
    assert int(got.supersteps) == int(want.supersteps)
    _io_equal(got.iostats, want.iostats)


def test_host_counters_saturate():
    """Host ledgers beyond int32 clamp instead of raising."""
    from repro_torch.graph.session import _host_result

    res = _host_result(1, records=2**40)
    assert int(res.iostats.records) == 2**31 - 1
