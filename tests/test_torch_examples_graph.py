"""The graph twins of ``examples/`` (``examples_torch/custom_program.py``,
``quickstart.py``, ``graph_analytics.py``, ``batched_queries.py``) on the
CPU, held against the reference's same calls wherever the reference runs
on JAX 0.9.0, and elsewhere against the port's own device and solo runs.

What the reference cannot run here (ROADMAP §C R1: ``jax.core.jaxpr_as_fun``
is gone): host residency, its batched driver and the façade's multi-source
calls.  So quickstart's step 6 and graph_analytics' host rerun are held to
the port's device run, and all of ``batched_queries`` to the port's solo
runs.  The reference's own scripts are run as far as they get: quickstart
and graph_analytics print every device line and then stop at that
``AttributeError``, which the tests require.

Also here: ``IOStats.bytes()`` against the reference's, and the host
stream's running sums (``Semiring.fold``) against one scatter of every
batch's terms, with the card's fixed-order float add run on the CPU.
"""
import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch.core import semiring
from repro_torch.graph.generators import rmat
from torch_examples_common import (  # noqa: F401 (one_thread: fixture)
    PR_TOL, Recorded, assert_io_equal, io_fields, load_example, one_thread)

GRAPH_METHODS = ("run", "bfs", "pagerank", "coreness", "diameter",
                 "betweenness", "triangles", "louvain", "memory_report")
CPU = ["--device", "cpu"]
# ROADMAP §C P2/P5: PageRank pull's counters move when f32 sums run in
# another order (messages by up to 1.1%, supersteps by one).
P2_REL, P5_STEPS = 0.011, 1
RESIDENCY_FIELDS = ("host_bytes", "retries")
MODULARITY_ABS = 1e-12  # both packages sum it in float64 numpy


def _run_twin(name, argv):
    """(exit code, stdout, recorded Graph calls) of a twin's ``main``."""
    out = io.StringIO()
    with Recorded(repro_torch.Graph, GRAPH_METHODS) as rec, \
            contextlib.redirect_stdout(out):
        rc = load_example(name).main(argv)
    return rc, out.getvalue(), rec.calls


def _run_reference(name, argv):
    """(stdout, recorded Graph calls) of the reference's script, run
    until R1 stops it at its host-residency step."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            Recorded(repro.Graph, GRAPH_METHODS) as rec, \
            contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", [f"{name}.py"] + argv)
        with pytest.raises(AttributeError, match="jaxpr_as_fun"):
            mod = load_example(name, "examples")
            mod.main()  # quickstart stops while it loads
    return out.getvalue(), rec.calls


def _names(calls):
    return [c.name for c in calls]


def _np(values):
    return values.numpy() if isinstance(values, torch.Tensor) else \
        np.asarray(values)


# ------------------------------------------------------------ custom_program
def test_custom_program_matches_reference(capsys):
    """The twin's WCC (rewritten in torch) prints the reference's lines;
    its labels, supersteps and IOStats equal the reference
    ``WCCProgram`` through ``repro.Graph.run`` on the same graph."""
    rc, out, calls = _run_twin("custom_program", CPU)
    assert rc == 0
    with Recorded(repro.Graph, ("run",)) as ref:
        assert load_example("custom_program", "examples").main() == 0
    assert out == capsys.readouterr().out
    (got,), (want,) = calls, ref.calls
    np.testing.assert_array_equal(_np(got.result.values),
                                  _np(want.result.values))
    assert int(got.result.supersteps) == int(want.result.supersteps)
    assert_io_equal(got.result.iostats, want.result.iostats)


# ------------------------------------------------------------ quickstart
QUICKSTART_CALLS = ["pagerank", "pagerank", "bfs", "coreness", "run",
                    "pagerank", "memory_report", "memory_report", "pagerank"]


@pytest.fixture(scope="module")
def quickstart():
    """The twin's run and the reference script's steps 1-5."""
    rc, out, calls = _run_twin("quickstart", CPU)
    assert rc == 0
    assert _names(calls) == QUICKSTART_CALLS
    ref_out, ref_calls = _run_reference("quickstart", [])
    assert _names(ref_calls) == QUICKSTART_CALLS[:5]
    return out, calls, ref_out, ref_calls


def test_quickstart_prints_the_reference_lines(quickstart):
    """Steps 1-5 print the reference's lines, but for pull's request count
    (P2/P5, held in ``test_quickstart_pagerank_pull``); step 6 prints its
    own line after them."""
    out, _, ref_out, _ = quickstart
    got, want = out.splitlines(), ref_out.splitlines()
    assert len(got) == len(want) + 1
    assert got[-1].startswith("host residency: ")
    for a, b in zip(got, want):
        if b.startswith("  pull: "):
            a, b = (re.sub(r"\d+ requests", "", s) for s in (a, b))
        assert a == b


def test_iostats_bytes_equals_reference(quickstart):
    """``IOStats.bytes()`` on quickstart's PageRank push run equals the
    reference's; ``weighted`` changes nothing."""
    _, calls, _, ref_calls = quickstart
    got, want = calls[0].result.iostats, ref_calls[0].result.iostats
    assert got.bytes() == want.bytes() == 19_928_152
    assert got.bytes(weighted=True) == got.bytes(weighted=False) == \
        got.bytes()
    assert isinstance(got.bytes(), int)


def test_quickstart_pagerank_push(quickstart):
    """Supersteps, top vertex, ``bytes()``, requests and every IOStats
    field equal; ranks within PageRank's tolerance."""
    _, calls, _, ref_calls = quickstart
    got, want = calls[0].result, ref_calls[0].result
    assert int(got.supersteps) == int(want.supersteps) == 54
    assert int(got.values.argmax()) == int(want.values.argmax())
    assert got.iostats.bytes() == want.iostats.bytes()
    assert_io_equal(got.iostats, want.iostats)
    np.testing.assert_allclose(_np(got.values), _np(want.values), **PR_TOL)


def test_quickstart_pagerank_pull(quickstart):
    """Pull's ``bytes()`` and records (so the printed push/pull ratio)
    equal the reference's; requests and messages within P2's 1.1%,
    supersteps within P5's one: f32 sums in another order move a vertex
    across the ``tol / n`` threshold."""
    _, calls, _, ref_calls = quickstart
    got, want = calls[1].result, ref_calls[1].result
    assert calls[1].kwargs == ref_calls[1].kwargs == {"mode": "pull"}
    assert abs(int(got.supersteps) - int(want.supersteps)) <= P5_STEPS
    assert got.iostats.bytes() == want.iostats.bytes()
    fg, fw = io_fields(got.iostats), io_fields(want.iostats)
    assert fg["records"] == fw["records"]
    for f in ("requests", "messages"):
        assert abs(fg[f] - fw[f]) <= P2_REL * fw[f], f
    np.testing.assert_allclose(_np(got.values), _np(want.values), **PR_TOL)


@pytest.mark.parametrize("index,what", [(2, "bfs"), (3, "coreness"),
                                        (4, "wcc")])
def test_quickstart_exact_steps(quickstart, index, what):
    """BFS (the compact auto policy), coreness and the inline WCC program:
    values, supersteps and every IOStats field equal the reference's; so
    chunk fetches skipped, kmax and the component count."""
    _, calls, _, ref_calls = quickstart
    got, want = calls[index].result, ref_calls[index].result
    np.testing.assert_array_equal(_np(got.values), _np(want.values))
    assert int(got.supersteps) == int(want.supersteps)
    assert_io_equal(got.iostats, want.iostats)
    if what == "wcc":
        assert torch.unique(got.values).numel() == np.unique(
            _np(want.values)).size


def test_quickstart_host_residency(quickstart):
    """Step 6 against the port's device run (the reference's host run is
    dead, R1): ranks bit-equal (the twin asserts it), supersteps and
    IOStats equal but for host_bytes and retries, no device edge bytes,
    staging within two stream buffers."""
    _, calls, _, _ = quickstart
    host, mr_host, mr_dev, dev = (c.result for c in calls[5:])
    assert calls[5].kwargs["policy"].residency == "host"
    assert torch.equal(host.values, dev.values)
    assert int(host.supersteps) == int(dev.supersteps)
    assert_io_equal(host.iostats, dev.iostats,
                    skip=("queries",) + RESIDENCY_FIELDS)
    assert int(host.iostats.host_bytes) > 0
    assert mr_host["device_edge_total"] == 0 < mr_dev["device_edge_total"]
    assert 0 < mr_host["peak_stage_bytes"] <= 2 * mr_host[
        "stream_buffer_bytes"]


# ------------------------------------------------------------ graph_analytics
ANALYTICS = ("pagerank", "coreness", "diameter", "betweenness", "triangles",
             "louvain")
SUMMARY = {"coreness": "kmax", "diameter": "estimate",
           "betweenness": "shared fetches", "triangles": "count",
           "louvain": "modularity"}


def _ledger(out):
    """{row name: (MB, requests, steps)} and the summary lines, with the
    time column dropped."""
    rows, summaries = {}, {}
    last = None
    for line in out.splitlines():
        m = re.match(r"  (\S+)\s+([\d.]+) MB\s+(\d+) req\s+(\d+) steps", line)
        if m:
            last = m.group(1)
            rows[last] = m.groups()[1:]
        elif line.startswith("    ") and last is not None:
            summaries[last] = line
    return rows, summaries


@pytest.fixture(scope="module")
def analytics():
    rc, out, calls = _run_twin("graph_analytics", ["--scale", "8"] + CPU)
    assert rc == 0
    assert _names(calls) == list(ANALYTICS) + ["pagerank", "memory_report",
                                               "memory_report"]
    ref_out, ref_calls = _run_reference("graph_analytics", ["--scale", "8"])
    assert _names(ref_calls) == list(ANALYTICS)
    return out, calls, ref_out, ref_calls


@pytest.mark.parametrize("i,name", list(enumerate(ANALYTICS)))
def test_analytics_row_equals_reference(analytics, i, name):
    """Each ledger row's MB, requests and supersteps (printed and
    recorded) equal the reference's."""
    out, calls, ref_out, ref_calls = analytics
    assert _ledger(out)[0][name] == _ledger(ref_out)[0][name]
    got, want = calls[i].result, ref_calls[i].result
    assert got.iostats.bytes() == want.iostats.bytes()
    assert int(got.iostats.requests) == int(want.iostats.requests)
    assert int(got.supersteps) == int(want.supersteps)


@pytest.mark.parametrize("name", sorted(SUMMARY))
def test_analytics_summary_equals_reference(analytics, name):
    """kmax, the diameter estimate, betweenness' shared fetches and the
    triangle count equal the reference's; Louvain's modularity within
    ``MODULARITY_ABS`` and its rewritten bytes equal."""
    out, calls, ref_out, ref_calls = analytics
    assert _ledger(out)[1][name] == _ledger(ref_out)[1][name]
    got = calls[ANALYTICS.index(name)].result
    want = ref_calls[ANALYTICS.index(name)].result
    if name == "coreness":
        assert int(got.values.max()) == int(np.asarray(want.values).max())
        np.testing.assert_array_equal(_np(got.values), _np(want.values))
    elif name == "diameter" or name == "triangles":
        assert int(got.values) == int(want.values)
    elif name == "betweenness":
        assert int(got.state.shared) == int(want.state.shared)
    else:
        assert got.state.modularity == pytest.approx(want.state.modularity,
                                                     abs=MODULARITY_ABS)
        assert int(got.iostats.bytes_moved) == int(want.iostats.bytes_moved)


def test_analytics_host_row_equals_device_row(analytics):
    """The host rerun against the port's device row (the reference's host
    run is dead, R1): ranks bit-equal, MB, requests and supersteps equal,
    no device edge bytes."""
    out, calls, _, _ = analytics
    rows = _ledger(out)[0]
    assert rows["pagerank/host"] == rows["pagerank"]
    dev, host = calls[0].result, calls[6].result
    assert torch.equal(host.values, dev.values)
    assert_io_equal(host.iostats, dev.iostats,
                    skip=("queries",) + RESIDENCY_FIELDS)
    mr_h, mr_d = calls[7].result, calls[8].result
    assert mr_h["device_edge_total"] == 0 < mr_d["device_edge_total"]


# ------------------------------------------------------------ batched_queries
SEEDS = [0, 3, 17, 42, 99, 256, 1024, 2048]


@pytest.fixture(scope="module")
def batched():
    """The twin's run.  The reference's batched driver and host residency
    are dead on JAX 0.9.0 (R1), so its columns are held to the port's
    solo runs, which the twin makes itself for BFS."""
    rc, out, calls = _run_twin("batched_queries", CPU)
    assert rc == 0
    assert _names(calls) == (["pagerank"] + ["bfs"] * (len(SEEDS) + 1)
                             + ["memory_report"] * 3)
    return out, calls


@pytest.mark.parametrize("q", range(len(SEEDS)))
def test_batched_bfs_column_equals_solo(batched, q):
    """Column q of the batched BFS equals the solo run from ``SEEDS[q]``,
    and its query supersteps the solo run's supersteps."""
    _, calls = batched
    solo, multi = calls[1 + q], calls[1 + len(SEEDS)]
    assert solo.args == (SEEDS[q],) and multi.args == (SEEDS,)
    assert torch.equal(multi.result.values[:, q], solo.result.values)
    assert int(multi.result.query_supersteps[q]) == int(
        solo.result.supersteps)


@pytest.mark.parametrize("q", range(len(SEEDS)))
def test_batched_ppr_column_within_p17(batched, q):
    """Column q of the batched personalized PageRank within P17's
    ``atol=1e-6, rtol=1e-5`` of its solo run (host residency, one
    reset)."""
    _, calls = batched
    ppr = calls[0]
    solo = ppr.owner.pagerank(reset=[SEEDS[q]], policy=ppr.kwargs["policy"])
    torch.testing.assert_close(ppr.result.values[:, q], solo.values[:, 0],
                               **PR_TOL)
    assert int(ppr.result.iostats.queries) == len(SEEDS)


def test_batched_host_bytes_and_state(batched):
    """One batched BFS moves fewer host bytes than the eight solo runs
    together, and ``query_state_bytes`` is n x Q x 6."""
    out, calls = batched
    solo = sum(int(c.result.iostats.host_bytes) for c in calls[1:9])
    assert 0 < int(calls[9].result.iostats.host_bytes) < solo
    n = calls[0].owner.n
    for c, q in zip(calls[10:], (1, 8, 64)):
        assert c.kwargs["batch"] == q
        assert c.result["query_state_bytes"] == n * q * 6
    assert "fewer bytes per query" in out


# ------------------------------------------------- host batches, card order
@pytest.mark.parametrize("batch", [7, 700])
def test_fold_over_batches_equals_one_scatter(batch):
    """``Semiring.fold`` batch by batch, then ``y + part``, has the bits of
    one fixed-order scatter (the card's float add, run here on the CPU) of
    every batch's terms; one ordered scatter a batch does not.  Batches of
    7 terms leave most rows without a term in a batch."""
    gen = torch.Generator().manual_seed(0)
    n, e, lanes = 50, 4000, 3
    keys = torch.randint(0, n + 1, (e,), generator=gen)
    contrib = torch.exp(8 * torch.randn((e, lanes), generator=gen))
    y0 = torch.randn((n + 1, lanes), generator=gen)
    want = semiring._ordered_add(y0, keys, contrib)
    part, y = torch.zeros_like(y0), y0
    for lo in range(0, e, batch):
        part = semiring.PLUS_TIMES.fold(part, keys[lo:lo + batch],
                                        contrib[lo:lo + batch])
        y = semiring._ordered_add(y, keys[lo:lo + batch],
                                  contrib[lo:lo + batch])
    assert torch.equal((y0 + part)[:n], want[:n])
    assert not torch.equal(y[:n], want[:n])


@pytest.mark.parametrize("chunk_size", [1024, 4096])
def test_host_pagerank_bits_with_the_cards_add(monkeypatch, chunk_size):
    """With the card's fixed-order float add run on the CPU, host
    PageRank over several stream batches has the device run's bits, as
    the twins assert on the card (quickstart step 6's graph)."""
    monkeypatch.setattr(semiring, "_ordered", lambda y: y.is_floating_point())
    g = rmat(12, edge_factor=16, seed=7, symmetrize=True)
    dev = repro_torch.Graph(g, chunk_size=chunk_size,
                            device="cpu").pagerank()
    host_session = repro_torch.Graph(g, chunk_size=chunk_size, device="cpu")
    host = host_session.pagerank(
        policy=repro_torch.ExecutionPolicy(residency="host"))
    assert host_session.host_view().out_store.num_chunks > 16  # > 1 batch
    assert torch.equal(host.values, dev.values)
    assert int(host.supersteps) == int(dev.supersteps)
