"""Shared set-up of the host-residency parity tests
(``tests/test_torch_residency.py`` and ``tests/test_torch_residency_runs.py``):
the WCC program in both packages' APIs, the IOStats and value comparisons,
the graphs, and the whole-run sessions and calls.  The tests live in two
files so that ``--dist loadfile`` can run them on two workers.
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
