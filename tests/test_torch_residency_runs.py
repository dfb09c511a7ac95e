"""Whole host-residency runs of the port against the reference and against
the port's own device residency: PageRank push and pull, BFS and
direction-optimising BFS on ``rmat(8)`` over the four backends, and
PageRank pull on the symmetrised graph.  Split from
``tests/test_torch_residency.py`` (whose docstring states the contract) so
that the two halves run on two workers; the shared set-up is
``tests/torch_residency_common.py``.
"""
import pytest
import torch

import repro
import repro_torch
from torch_residency_common import (  # noqa: F401 (graph, sym_graph: fixtures)
    BACKENDS, RESIDENCY_FIELDS, RUNS, _check_run, _io_equal, _sessions,
    _values_equal, graph, sym_graph)


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
