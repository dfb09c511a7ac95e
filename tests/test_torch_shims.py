"""The deprecated shims of the port against the reference's.

Every pre-façade entry point (``bfs_multi``, ``bfs_uni``,
``pagerank_pull``/``push``/``inmem``, ``bc_multisource``/``unisource``/
``fused``, ``coreness``, ``diameter_multisource``/``unisource``) and
``core``'s ``as_policy``, ``legacy_policy``, ``warn_legacy``,
``hybrid_spmv`` and ``bsp_run`` get the same numpy graph in both packages.
Each shim must return what the reference's returns (integers and every
IOStats counter exact; PageRank within ``atol=1e-6, rtol=1e-5``,
betweenness within ``rtol=1e-5, atol=1e-6``) and warn with the
reference's ``DeprecationWarning`` text, attributed to the caller.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.algs as ralgs
import repro.core as rcore
from repro.graph.generators import erdos_renyi, rmat

import repro_torch
import repro_torch.algs as talgs
import repro_torch.core as tcore

PR_TOL = dict(atol=1e-6, rtol=1e-5)
BC_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def views():
    """(reference, port) device views of one directed and one symmetrized
    graph, with blocked tiles."""
    kw = dict(chunk_size=128, bd=32, bs=32)
    out = {}
    for name, g in (("directed", rmat(8, edge_factor=8, seed=2)),
                    ("sym", erdos_renyi(200, 800, seed=2, symmetrize=True))):
        r, t = repro.Graph(g, **kw), repro_torch.Graph(g, device="cpu", **kw)
        out[name] = (r.device(blocked=True), t.device(blocked=True))
    return out


def _io_equal(got, want):
    for name, x, y in zip(got._fields, got, want):
        assert int(x) == int(y), f"IOStats.{name}: {int(x)} != {int(y)}"


def _call(fn, *args, **kw):
    """``fn(*args, **kw)`` and the DeprecationWarning texts it emitted
    (each checked to point at this file)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    msgs = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    return out, msgs


def _same_warning(got, want):
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert got and all(w.filename == __file__ for w in got), \
        [(w.filename, w.lineno) for w in got]


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ BFS
@pytest.mark.parametrize("kw", [{}, {"backend": "blocked"},
                                {"backend": "compact", "chunk_cap": 4}])
def test_bfs_multi(views, kw):
    rsg, tsg = views["directed"]
    (rd, rio, rit), rw = _call(ralgs.bfs_multi, rsg,
                               jnp.asarray([0, 5, 9], jnp.int32), **kw)
    (td, tio, tit), tw = _call(talgs.bfs_multi, tsg, [0, 5, 9], **kw)
    _same_warning(tw, rw)
    np.testing.assert_array_equal(_arr(td), _arr(rd))
    assert int(tit) == int(rit)
    _io_equal(tio, rio)


def test_bfs_uni(views):
    rsg, tsg = views["directed"]
    (rd, rio, rit), rw = _call(ralgs.bfs_uni, rsg, 3, max_iters=4)
    (td, tio, tit), tw = _call(talgs.bfs_uni, tsg, 3, max_iters=4)
    _same_warning(tw, rw)
    assert td.shape == (tsg.n,)
    np.testing.assert_array_equal(_arr(td), _arr(rd))
    assert int(tit) == int(rit)
    _io_equal(tio, rio)


# ------------------------------------------------------------- PageRank
@pytest.mark.parametrize("shim,kw", [
    ("pagerank_pull", {}),
    ("pagerank_pull", {"backend": "blocked", "tol": 1e-4}),
    ("pagerank_push", {}),
    ("pagerank_push", {"switch_fraction": 0.3, "ecap": 512,
                       "backend": "compact", "chunk_cap": 8}),
])
def test_pagerank_shims(views, shim, kw):
    rsg, tsg = views["directed"]
    (rr, rio, rit), rw = _call(getattr(ralgs, shim), rsg, **kw)
    (tr, tio, tit), tw = _call(getattr(talgs, shim), tsg, **kw)
    _same_warning(tw, rw)
    np.testing.assert_allclose(_arr(tr), _arr(rr), **PR_TOL)
    assert int(tit) == int(rit)
    _io_equal(tio, rio)


def test_pagerank_inmem(views):
    """The flat in-memory baseline (no warning in either package)."""
    rsg, tsg = views["directed"]
    (rr, rit), rw = _call(ralgs.pagerank_inmem, rsg, tol=1e-5)
    (tr, tit), tw = _call(talgs.pagerank_inmem, tsg, tol=1e-5)
    assert rw == [] and tw == []
    np.testing.assert_allclose(_arr(tr), _arr(rr), **PR_TOL)
    assert int(tit) == int(rit)


# ---------------------------------------------------------- betweenness
@pytest.mark.parametrize("shim,kw", [
    ("bc_multisource", {}),
    ("bc_multisource", {"backend": "compact", "chunk_cap": 4}),
    ("bc_unisource", {}),
])
def test_bc_shims(views, shim, kw):
    rsg, tsg = views["sym"]
    src = [0, 17, 42]
    (rb, rio, rit), rw = _call(getattr(ralgs, shim), rsg,
                               jnp.asarray(src, jnp.int32), **kw)
    (tb, tio, tit), tw = _call(getattr(talgs, shim), tsg, src, **kw)
    _same_warning(tw, rw)
    np.testing.assert_allclose(_arr(tb), _arr(rb), **BC_TOL)
    assert int(tit) == int(rit)
    _io_equal(tio, rio)


def test_bc_fused(views):
    rsg, tsg = views["sym"]
    src = [0, 17, 42]
    (rb, rio, rit, rsh), rw = _call(ralgs.bc_fused, rsg,
                                    jnp.asarray(src, jnp.int32))
    (tb, tio, tit, tsh), tw = _call(talgs.bc_fused, tsg, src)
    _same_warning(tw, rw)
    np.testing.assert_allclose(_arr(tb), _arr(rb), **BC_TOL)
    assert (int(tit), int(tsh)) == (int(rit), int(rsh))
    _io_equal(tio, rio)


# ------------------------------------------------ coreness and diameter
@pytest.mark.parametrize("kw", [
    {},
    {"prune": False, "messaging": "p2p"},
    {"messaging": "dense", "chunk_cap": 4},
    {"switch_fraction": 0.5, "max_supersteps": 7},
])
def test_coreness_shim(views, kw):
    rsg, tsg = views["sym"]
    (rc, rio, rit), rw = _call(ralgs.coreness, rsg, **kw)
    (tc, tio, tit), tw = _call(talgs.coreness, tsg, **kw)
    _same_warning(tw, rw)
    np.testing.assert_array_equal(_arr(tc), _arr(rc))
    assert int(tit) == int(rit)
    _io_equal(tio, rio)


@pytest.mark.parametrize("shim", ["diameter_multisource",
                                  "diameter_unisource"])
@pytest.mark.parametrize("kw", [{}, {"backend": "blocked"}])
def test_diameter_shims(views, shim, kw):
    rsg, tsg = views["sym"]
    args = dict(num_sources=4, sweeps=2, **kw)
    (re_, rio, rit), rw = _call(getattr(ralgs, shim), rsg, **args)
    (te, tio, tit), tw = _call(getattr(talgs, shim), tsg, **args)
    _same_warning(tw, rw)
    assert int(te) == int(re_)
    assert int(tit) == int(rit)
    _io_equal(tio, rio)


# ----------------------------------------------------------------- core
def test_warn_legacy_and_policy_merge():
    for kwargs in (None, {"backend": "blocked"},
                   {"backend": "scan", "chunk_cap": 8, "ecap": None}):
        _, rw = _call(rcore.warn_legacy, "old", "new()", kwargs=kwargs,
                      stacklevel=2)
        _, tw = _call(tcore.warn_legacy, "old", "new()", kwargs=kwargs,
                      stacklevel=2)
        _same_warning(tw, rw)
    base = tcore.ExecutionPolicy(backend="compact", vcap=9)
    assert tcore.as_policy(None) == tcore.ExecutionPolicy()
    assert tcore.as_policy(None, base) is base
    assert tcore.as_policy(base, None, chunk_cap=None) is base
    assert tcore.as_policy(base, None, chunk_cap=4, backend="scan") == \
        base.with_(chunk_cap=4, backend="scan")
    pol, tw = _call(tcore.legacy_policy, "x", "y()", None, base,
                    chunk_cap=4, backend=None)
    _, rw = _call(rcore.legacy_policy, "x", "y()", None,
                  rcore.ExecutionPolicy(backend="compact", vcap=9),
                  chunk_cap=4, backend=None)
    assert pol == base.with_(chunk_cap=4)
    assert [str(w.message) for w in tw] == [str(w.message) for w in rw]


@pytest.mark.parametrize("kw", [
    {},
    {"backend": "compact", "chunk_cap": 8},
    {"switch_fraction": 0.9},
    {"backend": "blocked", "switch_fraction": 0.0},
])
def test_hybrid_spmv(views, kw):
    """One superstep of the pre-policy dispatch on a sparse frontier."""
    from repro.core.semiring import PLUS_TIMES as RPT

    from repro_torch.core.semiring import PLUS_TIMES as TPT

    rsg, tsg = views["directed"]
    rng = np.random.default_rng(0)
    x = rng.random(tsg.n).astype(np.float32)
    act = rng.random(tsg.n) < 0.1
    ry, rst = rcore.hybrid_spmv(rsg, jnp.asarray(x), jnp.asarray(act), RPT,
                                **kw)
    ty, tst = tcore.hybrid_spmv(tsg, torch.from_numpy(x),
                                torch.from_numpy(act), TPT, **kw)
    np.testing.assert_allclose(_arr(ty), _arr(ry), **PR_TOL)
    _io_equal(tst, rst)


def test_bsp_run():
    """The loop contract: stop when ``step`` says done or at the budget;
    the superstep count is int32."""

    def rstep(s):
        return s + 1, s + 1 >= 5

    def tstep(s):
        return s + 1, s + 1 >= 5

    for budget in (3, 10):
        rs, rit = rcore.bsp_run(rstep, jnp.zeros((), jnp.int32), budget)
        ts, tit = tcore.bsp_run(tstep, torch.zeros((), dtype=torch.int32),
                                budget)
        assert tit.dtype == torch.int32
        assert (int(ts), int(tit)) == (int(rs), int(rit))


@pytest.mark.parametrize("mod", ["algs", "core", "analysis"])
def test_exports_cover_reference(mod):
    """The port's ``algs`` and ``analysis`` export every public name of
    the reference's (the shims included), and ``core`` its five shims."""
    import importlib

    ref = importlib.import_module(f"repro.{mod}").__all__
    port = importlib.import_module(f"repro_torch.{mod}").__all__
    if mod == "core":
        ref = ["as_policy", "bsp_run", "hybrid_spmv", "legacy_policy",
               "warn_legacy"]
    assert sorted(set(ref) - set(port)) == []
