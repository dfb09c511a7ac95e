"""Host residency of the port (``repro_torch.core.residency``) against the
reference.

  * One superstep: the port's ``host_traverse`` against the reference's
    ``repro.core.residency.host_traverse`` on the same graph, for every
    backend, semiring, ``stream_buffer`` and direction.  ``y`` must be
    equal (plus_times within ``atol=1e-6, rtol=1e-5``: the tile products
    sum in another order), and so must all ten IOStats fields — the
    field rules of ``tests/test_api.py::assert_io_equal``, ``host_bytes``
    and ``retries`` included — and ``peak_stage_bytes``.
  * Whole runs: ``repro_torch.Graph(g, device="cpu")`` under a host policy
    against the reference's device residency ``repro.Graph(g)`` (the
    reference's own host driver needs ``jax.core.jaxpr_as_fun``, which the
    installed JAX lacks; its device driver is documented as identical
    apart from ``host_bytes`` and ``retries``), and against the port's own
    device residency: ints exact, PageRank ``atol=1e-6, rtol=1e-5``, and
    IOStats equal except ``host_bytes`` and ``retries``.
  * Guards, session caching, ``memory_report`` and the retry ladder.

Nothing in ``jax`` or ``repro`` is patched here.  Sizes are small
(``rmat(8)``, 32x32 tiles, 256-edge chunks): the reference's Pallas
kernels run in interpret mode.
"""
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import engine as reng
from repro.core import residency as rres
from repro.core import semiring as rsr
from repro.graph.generators import rmat

import repro_torch
from repro_torch.core import engine as teng
from repro_torch.core import residency as tres
from repro_torch.core import semiring as tsr
from repro_torch.core.sem import device_graph as t_device_graph

BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
SEMIRINGS = ("plus_times", "min_plus", "or_and")
PR_TOL = dict(atol=1e-6, rtol=1e-5)
KW = dict(chunk_size=256, bd=32, bs=32)
# counters that depend on residency, not on the traversal
RESIDENCY_FIELDS = ("host_bytes", "retries", "queries")


class WCCState(NamedTuple):
    labels: torch.Tensor
    active: torch.Tensor


class WCCProgram(repro_torch.VertexProgram):
    """Weakly connected components by min-label propagation
    (``examples/custom_program.py``, written against the port's API)."""

    semiring = tsr.MIN_PLUS

    def init(self, sg, seeds):
        return WCCState(
            labels=torch.arange(sg.n, dtype=torch.float32, device=sg.device),
            active=torch.ones(sg.n, dtype=torch.bool, device=sg.device))

    def frontier(self, sg, s):
        return repro_torch.Frontier(x=s.labels, active=s.active)

    def apply(self, sg, s, gathered):
        labels = torch.minimum(s.labels, gathered)
        changed = labels < s.labels
        return WCCState(labels, changed), changed

    def finalize(self, sg, s):
        return s.labels.to(torch.int32)


class RefWCCState(NamedTuple):
    labels: jnp.ndarray
    active: jnp.ndarray


class RefWCCProgram(repro.VertexProgram):
    """The same program against the reference's API."""

    semiring = rsr.MIN_PLUS

    def init(self, sg, seeds):
        return RefWCCState(labels=jnp.arange(sg.n, dtype=jnp.float32),
                           active=jnp.ones(sg.n, bool))

    def frontier(self, sg, s):
        return repro.Frontier(x=s.labels, active=s.active)

    def apply(self, sg, s, gathered):
        labels = jnp.minimum(s.labels, gathered)
        changed = labels < s.labels
        return RefWCCState(labels, changed), changed

    def finalize(self, sg, s):
        return s.labels.astype(jnp.int32)


def _sr(mod, name):
    return {"plus_times": mod.PLUS_TIMES, "min_plus": mod.MIN_PLUS,
            "or_and": mod.OR_AND}[name]


def _io_equal(got, want, skip=("queries",)):
    for name, a, b in zip(got._fields, got, want):
        if name not in skip:
            assert int(a) == int(b), f"IOStats.{name}: {int(a)} != {int(b)}"


def _values_equal(got, want, approx=False):
    got = got.cpu().numpy()
    want = np.asarray(want)
    if approx:
        np.testing.assert_allclose(got, want, **PR_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def graph():
    return rmat(8, edge_factor=8, seed=1)


@pytest.fixture(scope="module")
def sym_graph():
    return rmat(8, edge_factor=8, seed=1, symmetrize=True)


def _superstep_inputs(n, sr_name, seed, lanes=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if lanes is None else (n, lanes)
    if sr_name == "or_and":
        x = rng.random(shape) < 0.3
    else:
        x = rng.random(shape).astype(np.float32)
    return x, rng.random(shape) < 0.3, rng.random(shape) < 0.7


def _one_superstep(g, backend, sr_name, stream_buffer, direction,
                   tile_order="dest", unexplored=False, lanes=None):
    """(port y, port IOStats, port peak, ref y, ref IOStats, ref peak)."""
    x, act, un = _superstep_inputs(g.n, sr_name, seed=stream_buffer,
                                   lanes=lanes)
    kw = dict(backend=backend, residency="host", direction=direction,
              stream_buffer=stream_buffer, tile_order=tile_order)
    rhg = rres.host_graph(g, **KW)
    thg = tres.host_graph(g, device="cpu", **KW)
    extra_r = dict(unexplored=jnp.asarray(un)) if unexplored else {}
    extra_t = dict(unexplored=torch.as_tensor(un)) if unexplored else {}
    y_r, st_r = rres.host_traverse(rhg, jnp.asarray(x), jnp.asarray(act),
                                   _sr(rsr, sr_name),
                                   policy=reng.ExecutionPolicy(**kw), **extra_r)
    y_t, st_t = tres.host_traverse(thg, torch.as_tensor(x),
                                   torch.as_tensor(act), _sr(tsr, sr_name),
                                   policy=teng.ExecutionPolicy(**kw), **extra_t)
    return y_t, st_t, thg.peak_stage_bytes, y_r, st_r, rhg.peak_stage_bytes


@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("stream_buffer", [1, 4, 16])
@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_host_traverse_matches_reference(graph, backend, sr_name,
                                         stream_buffer, direction):
    y_t, st_t, peak_t, y_r, st_r, peak_r = _one_superstep(
        graph, backend, sr_name, stream_buffer, direction)
    _values_equal(y_t, y_r, approx=sr_name == "plus_times")
    _io_equal(st_t, st_r, skip=())
    assert int(st_t.host_bytes) > 0
    assert peak_t == peak_r > 0


@pytest.mark.parametrize("stream_buffer", [1, 4])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
@pytest.mark.parametrize("backend", ["blocked", "blocked_compact"])
def test_host_traverse_curve_order(graph, backend, sr_name, stream_buffer):
    """A Hilbert schedule gives a block several runs, so batches must split
    at a block's second run (rule 2) and the carry combines across them."""
    y_t, st_t, peak_t, y_r, st_r, peak_r = _one_superstep(
        graph, backend, sr_name, stream_buffer, "out", tile_order="hilbert")
    _values_equal(y_t, y_r, approx=sr_name == "plus_times")
    _io_equal(st_t, st_r, skip=())
    assert peak_t == peak_r


@pytest.mark.parametrize("backend", BACKENDS)
def test_host_traverse_lanes_and_auto(graph, backend):
    """K query lanes with an unexplored set under direction='auto': the
    union is streamed once and Beamer's switch decides alike."""
    y_t, st_t, peak_t, y_r, st_r, peak_r = _one_superstep(
        graph, backend, "or_and", 4, "auto", unexplored=True, lanes=3)
    _values_equal(y_t, y_r)
    _io_equal(st_t, st_r, skip=())
    assert peak_t == peak_r


def test_host_traverse_p2p_arm(graph):
    """A sparse frontier takes the p2p arm: its ecap lanes ship in one
    payload, whose bytes both packages count alike."""
    x = np.random.default_rng(3).random(graph.n).astype(np.float32)
    act = np.zeros(graph.n, bool)
    act[[1, 7, 30]] = True
    kw = dict(residency="host", switch_fraction=0.5, ecap=512)
    rhg = rres.host_graph(graph, **KW)
    thg = tres.host_graph(graph, device="cpu", **KW)
    for direction in ("out", "in"):
        y_r, st_r = rres.host_traverse(
            rhg, jnp.asarray(x), jnp.asarray(act), rsr.PLUS_TIMES,
            policy=reng.ExecutionPolicy(direction=direction, **kw))
        y_t, st_t = tres.host_traverse(
            thg, torch.as_tensor(x), torch.as_tensor(act), tsr.PLUS_TIMES,
            policy=teng.ExecutionPolicy(direction=direction, **kw))
        _values_equal(y_t, y_r)
        _io_equal(st_t, st_r, skip=())
        assert int(st_t.host_bytes) == 512 * 9
    assert thg.peak_stage_bytes == rhg.peak_stage_bytes


# ------------------------------------------------------------ whole runs
def _sessions(g):
    return (repro.Graph(g, **KW), repro_torch.Graph(g, device="cpu", **KW),
            repro_torch.Graph(g, device="cpu", **KW))


RUNS = {
    "pr_push": (lambda G, pol: G.pagerank(tol=1e-4, policy=pol), True),
    "pr_pull": (lambda G, pol: G.pagerank(mode="pull", tol=1e-4,
                                          policy=pol), True),
    "bfs": (lambda G, pol: G.bfs(0, policy=pol), False),
    "bfs_auto": (lambda G, pol: G.bfs(0, policy=pol.with_(direction="auto")),
                 False),
}


def _check_run(ref_res, dev_res, host_res, approx):
    for other in (ref_res, dev_res):
        _values_equal(host_res.values, other.values, approx=approx)
        assert int(host_res.supersteps) == int(other.supersteps)
        _io_equal(host_res.iostats, other.iostats, skip=RESIDENCY_FIELDS)
    assert int(host_res.iostats.host_bytes) > 0
    assert int(dev_res.iostats.host_bytes) == 0


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_runs_match_device(graph, backend, run):
    ref, dev, host = _sessions(graph)
    call, approx = RUNS[run]
    pol = dict(backend=backend)
    _check_run(call(ref, repro.ExecutionPolicy(**pol)),
               call(dev, repro_torch.ExecutionPolicy(**pol)),
               call(host, repro_torch.ExecutionPolicy(residency="host",
                                                      **pol)),
               approx)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pagerank_pull_host_equals_port_device(sym_graph, backend):
    """On the symmetrised graph the port's scan/compact PageRank pull takes
    one superstep more than the reference (ranks within 1.1e-7: f32
    rounding moves a vertex across the threshold ``tol / n``; ROADMAP §C
    P5).  Host residency equals the port's device residency bit for bit
    there too, and the reference's values within the tolerance."""
    ref, dev, host = _sessions(sym_graph)
    call, _ = RUNS["pr_pull"]
    want = call(ref, repro.ExecutionPolicy(backend=backend))
    got_dev = call(dev, repro_torch.ExecutionPolicy(backend=backend))
    got = call(host, repro_torch.ExecutionPolicy(backend=backend,
                                                 residency="host"))
    assert torch.equal(got.values, got_dev.values)
    assert int(got.supersteps) == int(got_dev.supersteps)
    _io_equal(got.iostats, got_dev.iostats, skip=RESIDENCY_FIELDS)
    _values_equal(got.values, want.values, approx=True)


@pytest.mark.parametrize("stream_buffer", [1, 16])
@pytest.mark.parametrize("backend", BACKENDS)
def test_wcc_matches_device(sym_graph, backend, stream_buffer):
    ref, dev, host = _sessions(sym_graph)
    want = ref.run(RefWCCProgram(),
                   policy=repro.ExecutionPolicy(backend=backend))
    got_dev = dev.run(WCCProgram(),
                      policy=repro_torch.ExecutionPolicy(backend=backend))
    got = host.run(WCCProgram(), policy=repro_torch.ExecutionPolicy(
        backend=backend, residency="host", stream_buffer=stream_buffer))
    _check_run(want, got_dev, got, approx=False)
    # every component carries its smallest vertex id
    labels = got.values.numpy()
    assert np.all(labels <= np.arange(sym_graph.n))
    assert np.array_equal(labels[labels], labels)


@pytest.mark.parametrize("backend", BACKENDS)
def test_weighted_graph(backend):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 90, 600)
    dst = rng.integers(0, 90, 600)
    w = rng.integers(1, 5, 600).astype(np.float32)
    hw = repro.Graph.from_edges(src, dst, weights=w, symmetrize=True).host
    ref, dev, host = _sessions(hw)
    pol = dict(backend=backend)
    hpol = repro_torch.ExecutionPolicy(residency="host", stream_buffer=2,
                                       **pol)
    for call, approx in (RUNS["pr_push"], RUNS["bfs"]):
        _check_run(call(ref, repro.ExecutionPolicy(**pol)),
                   call(dev, repro_torch.ExecutionPolicy(**pol)),
                   call(host, hpol), approx)
    _check_run(ref.run(RefWCCProgram(), policy=repro.ExecutionPolicy(**pol)),
               dev.run(WCCProgram(),
                       policy=repro_torch.ExecutionPolicy(**pol)),
               host.run(WCCProgram(), policy=hpol), approx=False)


# ------------------------------------------------------------ guards
def test_policy_validation():
    with pytest.raises(teng.PolicyError, match="residency"):
        teng.ExecutionPolicy(residency="ssd")
    with pytest.raises(teng.PolicyError, match="stream_buffer"):
        teng.ExecutionPolicy(stream_buffer=0)
    with pytest.raises(teng.PolicyError, match="stream_retries"):
        teng.ExecutionPolicy(stream_retries=-1)


def test_host_policy_on_device_graph(sym_graph):
    sg = t_device_graph(sym_graph, chunk_size=256, device="cpu")
    x, act = torch.zeros(sg.n), torch.ones(sg.n, dtype=torch.bool)
    host = teng.ExecutionPolicy(residency="host")
    with pytest.raises(teng.ResidencyError, match="device-resident graph"):
        teng.traverse(sg, x, act, tsr.OR_AND, policy=host)
    with pytest.raises(teng.ResidencyError, match="device-resident graph"):
        repro_torch.run_program(sg, WCCProgram(), host)


def test_device_policy_on_host_graph(sym_graph):
    hg = tres.host_graph(sym_graph, chunk_size=256, device="cpu")
    x, act = torch.zeros(hg.n), torch.ones(hg.n, dtype=torch.bool)
    with pytest.raises(teng.ResidencyError, match="host-resident graph view"):
        teng.traverse(hg, x, act, tsr.OR_AND,
                      policy=teng.ExecutionPolicy())
    with pytest.raises(teng.ResidencyError, match="host-resident graph view"):
        repro_torch.run_program(hg, WCCProgram(), teng.ExecutionPolicy())


def test_traverse_routes_host_view(sym_graph):
    """The generic traverse on a host view streams, and equals the device
    traverse."""
    sg = t_device_graph(sym_graph, chunk_size=256, device="cpu")
    hg = tres.host_graph(sym_graph, chunk_size=256, device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).random(sym_graph.n),
                        dtype=torch.float32)
    act = torch.ones(sym_graph.n, dtype=torch.bool)
    pol = teng.ExecutionPolicy(switch_fraction=None)
    yd, std = teng.traverse(sg, x, act, tsr.PLUS_TIMES, policy=pol)
    yh, sth = teng.traverse(hg, x, act, tsr.PLUS_TIMES,
                            policy=pol.with_(residency="host"))
    assert torch.equal(yd, yh)
    _io_equal(sth, std, skip=RESIDENCY_FIELDS)
    assert int(sth.host_bytes) > 0


def test_later_slices_still_raise(sym_graph):
    host = repro_torch.Graph(sym_graph, device="cpu", **KW)
    pol = repro_torch.ExecutionPolicy(residency="host")
    with pytest.raises(NotImplementedError, match="A12"):
        host.bfs(0, policy=pol, checkpoint=object())
    with pytest.raises(NotImplementedError, match="A12"):
        tres.run_program_host(host.host_view(), WCCProgram(), pol,
                              checkpoint=object())
    with pytest.raises(NotImplementedError, match="A10"):
        host.pagerank(policy=pol, reset=[0, 1])


def test_host_graph_defaults_to_cuda(sym_graph):
    """Like every view builder, the host view's vertex state goes to the
    card unless the caller passes ``device='cpu'``."""
    if torch.cuda.is_available():
        assert tres.host_graph(sym_graph).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tres.host_graph(sym_graph)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Graph(sym_graph).bfs(
            0, policy=repro_torch.ExecutionPolicy(residency="host"))


# ------------------------------------------------------------ sessions
def test_host_run_builds_no_device_view(sym_graph):
    host = repro_torch.Graph(sym_graph, device="cpu", **KW)
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend, residency="host")
        host.bfs(0, policy=pol)
        host.run(WCCProgram(), policy=pol)
    assert host._base is None and host._tiles == {} and host._views == {}
    hv = host.host_view()
    host.pagerank(policy=repro_torch.ExecutionPolicy(residency="host"))
    assert host.host_view() is hv
    assert set(hv._blocked) == {("plus_times", False, "dest"),
                                ("min_plus", False, "dest")}
    report = host.memory_report(
        repro_torch.ExecutionPolicy(residency="host"))
    assert report["device_edge_total"] == 0 and report["device_views"] == {}


def test_device_runs_unaffected_by_host_runs(sym_graph):
    G = repro_torch.Graph(sym_graph, device="cpu", **KW)
    r1 = G.bfs(0)
    G.bfs(0, policy=repro_torch.ExecutionPolicy(residency="host"))
    r2 = G.bfs(0)
    assert torch.equal(r1.values, r2.values)
    _io_equal(r1.iostats, r2.iostats, skip=())


@pytest.mark.parametrize("backend", ["scan", "blocked_compact"])
def test_memory_report_matches_reference(graph, backend):
    """After one streamed superstep on each side the reports agree field
    for field; a device session reports its O(m) edges.  ``stream_buffer``
    is ceil(n / bs) = 8, the longest run a tile schedule can hold, so the
    double-buffering bound holds on every backend."""
    ref = repro.Graph(graph, **KW)
    port = repro_torch.Graph(graph, device="cpu", **KW)
    pol_kw = dict(backend=backend, residency="host", stream_buffer=8)
    x, act, _ = _superstep_inputs(graph.n, "plus_times", seed=2)
    rres.host_traverse(ref.host_view(), jnp.asarray(x), jnp.asarray(act),
                       rsr.PLUS_TIMES,
                       policy=reng.ExecutionPolicy(**pol_kw))
    tres.host_traverse(port.host_view(), torch.as_tensor(x),
                       torch.as_tensor(act), tsr.PLUS_TIMES,
                       policy=teng.ExecutionPolicy(**pol_kw))
    for batch in (1, 8):
        want = ref.memory_report(reng.ExecutionPolicy(**pol_kw), batch=batch)
        got = port.memory_report(teng.ExecutionPolicy(**pol_kw), batch=batch)
        assert got == want
    assert 0 < got["peak_stage_bytes"] <= 2 * got["stream_buffer_bytes"]
    port.pagerank(max_iters=2)
    dev = port.memory_report()
    assert dev["residency"] == "device"
    assert dev["device_edge_total"] >= graph.m * 8


# ------------------------------------------------------------ retries
def test_stream_faults_are_retried_and_counted(graph):
    x, act, _ = _superstep_inputs(graph.n, "plus_times", seed=5)
    pol_kw = dict(backend="blocked_compact", residency="host", stream_buffer=2,
                  stream_backoff_s=0.0)

    def flaky(calls):
        def hook():
            calls.append(1)
            if len(calls) % 2:
                raise OSError("transient")
        return hook

    clean_y, clean_st = tres.host_traverse(
        tres.host_graph(graph, device="cpu", **KW), torch.as_tensor(x),
        torch.as_tensor(act), tsr.PLUS_TIMES,
        policy=teng.ExecutionPolicy(**pol_kw))
    t_calls, r_calls = [], []
    with tres.inject_stream_faults(flaky(t_calls)):
        y_t, st_t = tres.host_traverse(
            tres.host_graph(graph, device="cpu", **KW), torch.as_tensor(x),
            torch.as_tensor(act), tsr.PLUS_TIMES,
            policy=teng.ExecutionPolicy(**pol_kw))
    with rres.inject_stream_faults(flaky(r_calls)):
        _, st_r = rres.host_traverse(
            rres.host_graph(graph, **KW), jnp.asarray(x), jnp.asarray(act),
            rsr.PLUS_TIMES, policy=reng.ExecutionPolicy(**pol_kw))
    assert torch.equal(y_t, clean_y)
    assert int(st_t.retries) == len(t_calls) // 2 > 1
    _io_equal(st_t, st_r, skip=())
    _io_equal(st_t, clean_st, skip=("retries",))


def test_stream_failure_after_retry_budget(graph):
    calls = []

    def down():
        calls.append(1)
        raise OSError("link down")

    hg = tres.host_graph(graph, device="cpu", **KW)
    pol = teng.ExecutionPolicy(residency="host", stream_retries=2,
                               stream_backoff_s=0.0, switch_fraction=None)
    with tres.inject_stream_faults(down):
        with pytest.raises(tres.StreamFailure, match="3 attempts"):
            tres.host_traverse(hg, torch.ones(graph.n),
                               torch.ones(graph.n, dtype=torch.bool),
                               tsr.PLUS_TIMES, policy=pol)
    assert len(calls) == 3
