"""The port's host-side graph layer against the reference, array for array.

Both packages get the same numpy inputs; every array the port builds on
the host (CSR images, generators, chunk stores, tile views and schedules)
must be byte-identical to the reference's.  Also pinned here: the port
imports neither ``jax`` nor ``repro``, and its entry points refuse to fall
back to the CPU by themselves.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.graph.csr as rcsr
import repro.graph.generators as rgen
from repro.core.sem import build_store_arrays as r_build_store_arrays
from repro.core.sem import device_graph as r_device_graph
from repro.kernels.spmv import build_blocked_arrays as r_build_blocked_arrays

import repro_torch
import repro_torch.graph.csr as tcsr
import repro_torch.graph.generators as tgen
from repro_torch import convert
from repro_torch.core.sem import (build_store, build_store_arrays,
                                  device_graph)
from repro_torch.kernels.spmv import build_blocked, build_blocked_arrays

SRC = Path(__file__).resolve().parents[1] / "src"


def _graph_arrays_equal(a, b):
    assert a.n == b.n
    for name in ("indptr", "indices", "weights", "in_indptr", "in_indices",
                 "in_weights"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("symmetrize", [False, True])
def test_from_edges_and_reverse_identical(weighted, symmetrize):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 300, 2000)
    dst = rng.integers(0, 300, 2000)
    w = rng.random(2000).astype(np.float32) if weighted else None
    a = rcsr.from_edges(src, dst, n=300, weights=w, symmetrize=symmetrize)
    b = tcsr.from_edges(src, dst, n=300, weights=w, symmetrize=symmetrize)
    _graph_arrays_equal(a, b)
    _graph_arrays_equal(rcsr.reverse(a), tcsr.reverse(b))


@pytest.mark.parametrize("gen,args", [
    ("rmat", dict(scale=9, edge_factor=8, seed=1)),
    ("rmat", dict(scale=8, edge_factor=16, seed=2, symmetrize=True)),
    ("erdos_renyi", dict(n=200, m=1500, seed=3)),
    ("path_graph", dict(n=50)),
    ("star_graph", dict(n=40)),
])
def test_generators_identical(gen, args):
    _graph_arrays_equal(getattr(rgen, gen)(**args), getattr(tgen, gen)(**args))


@pytest.mark.parametrize("sorted_by", ["src", "dst"])
@pytest.mark.parametrize("chunk_size", [64, 4096])
def test_store_arrays_identical(sorted_by, chunk_size):
    g = rgen.erdos_renyi(200, 1500, seed=1)
    a = r_build_store_arrays(g, sorted_by=sorted_by, chunk_size=chunk_size)
    b = build_store_arrays(g, sorted_by=sorted_by, chunk_size=chunk_size)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("tile_order", ["dest", "morton", "hilbert"])
@pytest.mark.parametrize("semiring,weighted,reverse", [
    ("plus_times", False, False),
    ("plus_times", True, False),
    ("plus_times", True, True),
    ("bool", True, False),
    ("min_plus", True, False),
])
def test_tiler_byte_identical(tile_order, semiring, weighted, reverse):
    g = rgen.rmat(8, edge_factor=8, seed=4)
    if weighted:
        rng = np.random.default_rng(5)
        src = np.repeat(np.arange(g.n), np.diff(g.indptr))
        g = rcsr.from_edges(src, g.indices, n=g.n,
                            weights=rng.normal(size=g.m).astype(np.float32))
    kw = dict(bd=32, bs=16, semiring=semiring, reverse=reverse,
              tile_order=tile_order)
    a = r_build_blocked_arrays(g, **kw)
    b = build_blocked_arrays(g, **kw)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k
    # the device build fills the same tiles without the host array
    bg = build_blocked(g, device="cpu", **kw)
    assert bg.tiles.numpy().tobytes() == a["tiles"].tobytes()


def test_tiler_sums_duplicate_edges_in_edge_order():
    """Multi-edges (dedup=False) land in one slot: summed in edge order, as
    the reference's per-tile ``np.add.at`` does."""
    rng = np.random.default_rng(9)
    src = rng.integers(0, 64, 3000)
    dst = rng.integers(0, 64, 3000)
    w = rng.normal(size=3000).astype(np.float32)
    g = rcsr.from_edges(src, dst, n=64, weights=w, dedup=False)
    a = r_build_blocked_arrays(g, bd=16, bs=16)
    b = build_blocked_arrays(g, bd=16, bs=16)
    assert a["tiles"].tobytes() == b["tiles"].tobytes()


def test_convert_matches_own_build():
    """A reference SemGraph carried across equals the port's own build."""
    g = rgen.rmat(8, edge_factor=8, seed=2)
    ref = r_device_graph(g, chunk_size=128, blocked=True, bd=32, bs=32,
                         blocked_reverse=True, tile_order="hilbert")
    got = convert.sem_graph(ref, device="cpu")
    own = device_graph(g, chunk_size=128, blocked=True, bd=32, bs=32,
                       blocked_reverse=True, tile_order="hilbert",
                       device="cpu")
    for name in ("indptr", "indices", "in_indptr", "in_indices", "out_degree",
                 "in_degree"):
        assert torch.equal(getattr(got, name), getattr(own, name)), name
    for store in ("out_store", "in_store"):
        for name in ("major", "minor", "lo", "hi"):
            assert torch.equal(getattr(getattr(got, store), name),
                               getattr(getattr(own, store), name))
    for view in ("out_blocked", "out_blocked_rev"):
        a, b = getattr(got, view), getattr(own, view)
        for name in ("tiles", "dbid", "sbid", "first", "last", "accum", "nnz",
                     "row_ptr", "ent_tile", "ent_src", "ent_w", "seg_ptr",
                     "row_seg"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (view, name)
        assert (a.n, a.bd, a.bs, a.semiring, a.tile_order) == (
            b.n, b.bd, b.bs, b.semiring, b.tile_order)


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax or repro."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_needs_cuda():
    """Without ``device=`` the façade wants the card and never carries on
    on the CPU by itself."""
    g = tgen.path_graph(8)
    if torch.cuda.is_available():
        assert repro_torch.Graph(g).torch_device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Graph(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Graph.from_edges([0, 1], [1, 2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_graph(g)
    assert repro_torch.Graph(g, device="cpu").torch_device.type == "cpu"
    assert device_graph(g, device="cpu").indptr.device.type == "cpu"


@pytest.mark.parametrize("builder", [
    "build_store", "build_blocked", "edge_store", "blocked_view", "sem_graph",
])
def test_builders_default_to_cuda(builder):
    """Every builder of device views resolves ``device=None`` as the façade
    does: the card, or an error that names ``device='cpu'``."""
    g = rgen.rmat(6, edge_factor=4, seed=1)
    ref = r_device_graph(g, chunk_size=64, blocked=True, bd=32, bs=32)
    call = {
        "build_store": lambda **kw: build_store(g, sorted_by="src", **kw),
        "build_blocked": lambda **kw: build_blocked(g, bd=32, bs=32, **kw),
        "edge_store": lambda **kw: convert.edge_store(ref.out_store, **kw),
        "blocked_view": lambda **kw: convert.blocked_view(ref.out_blocked,
                                                          **kw),
        "sem_graph": lambda **kw: convert.sem_graph(ref, **kw),
    }[builder]
    if torch.cuda.is_available():
        assert _any_tensor(call()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert _any_tensor(call(device="cpu")).device.type == "cpu"


def _any_tensor(view) -> torch.Tensor:
    for name in ("major", "tiles", "indptr"):
        if hasattr(view, name):
            return getattr(view, name)
    raise AssertionError(f"no tensor field on {type(view).__name__}")
