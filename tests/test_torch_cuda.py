"""The port's CUDA kernels on the card (no JAX here, so this file also runs
where only torch is installed):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each test needs a CUDA device and skips without one (the kernels have no
CPU mode).  Kernels B1/B2 are held against their plain torch versions on
the same inputs (``atol=rtol=1e-5``: a tile row's dot product sums in
another order), B3/B4 with ``torch.equal`` (min is order-free), and the
card's façade results against the CPU's and host residency against device
residency (BFS, WCC and their IOStats exact, PageRank ``atol=1e-6,
rtol=1e-5``).
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.semiring import MIN_PLUS
from repro_torch.graph.generators import rmat
from repro_torch.kernels import spmv as tk

pytestmark = pytest.mark.cuda

BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
NO_LAUNCH = {"spmv_blocked": 0, "spmv_blocked_compact": 0,
             "spmv_blocked_min_plus": 0, "spmv_blocked_compact_min_plus": 0}


class WCCState(NamedTuple):
    labels: torch.Tensor
    active: torch.Tensor


class WCCProgram(repro_torch.VertexProgram):
    """Weakly connected components by min-label propagation
    (``examples/custom_program.py`` against the port's API)."""

    semiring = MIN_PLUS

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


def _compact_args(bg, act):
    args = tk.compact_tile_order(bg, act)
    G = tk.compact_grid_size(bg.num_tiles, args[6])
    return [a[:G] for a in args[:6]] + [args[6]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("bd,bs", [(128, 128), (48, 32)])
def test_kernels_match_plain(card, order, k, bd, bs):
    g = rmat(10, edge_factor=16, seed=1)
    bg = tk.build_blocked(g, bd=bd, bs=bs, tile_order=order, device=card)
    gen = torch.Generator(device=card).manual_seed(k)
    x_blocks = torch.rand((bg.n_src_blocks, bg.bs, k), generator=gen,
                          device=card)
    for density in (1.0, 0.1, 0.0):
        mask = np.random.default_rng(k).random(g.n) < density
        act = tk.tile_activity(bg, torch.as_tensor(mask, device=card))
        tk.reset_launches()
        torch.testing.assert_close(tk.spmv_blocked(bg, act, x_blocks),
                                   tk.blocked_spmv_plain(bg, act, x_blocks),
                                   **F32_TOL)
        sl = _compact_args(bg, act)
        torch.testing.assert_close(
            tk.spmv_blocked_compact(bg, *sl, x_blocks),
            tk.blocked_spmv_plain_compact(bg, *sl, x_blocks), **F32_TOL)
        assert tk.launches == dict(NO_LAUNCH, spmv_blocked=1,
                                   spmv_blocked_compact=1)


@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("bd,bs", [(128, 128), (48, 32)])
def test_min_plus_kernels_match_plain(card, order, k, bd, bs):
    """B3/B4 equal their plain versions bit for bit: min is order-free and
    each w + x rounds once.  Labels include +inf (unreached)."""
    g = rmat(10, edge_factor=16, seed=1, symmetrize=True)
    bg = tk.build_blocked(g, bd=bd, bs=bs, tile_order=order,
                          semiring="min_plus", device=card)
    rng = np.random.default_rng(k)
    x = rng.integers(0, g.n, (bg.n_src_blocks, bg.bs, k)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.inf
    x_blocks = torch.as_tensor(x, device=card)
    for density in (1.0, 0.1, 0.0):
        mask = rng.random(g.n) < density
        act = tk.tile_activity(bg, torch.as_tensor(mask, device=card))
        tk.reset_launches()
        assert torch.equal(tk.spmv_blocked(bg, act, x_blocks),
                           tk.blocked_spmv_plain(bg, act, x_blocks))
        sl = _compact_args(bg, act)
        assert torch.equal(tk.spmv_blocked_compact(bg, *sl, x_blocks),
                           tk.blocked_spmv_plain_compact(bg, *sl, x_blocks))
        assert tk.launches == dict(NO_LAUNCH, spmv_blocked_min_plus=1,
                                   spmv_blocked_compact_min_plus=1)


def test_unsupported_shape_raises(card):
    bg = tk.build_blocked(rmat(8, edge_factor=8, seed=1), bd=32, bs=256,
                          device=card)
    with pytest.raises(ValueError, match="bs"):
        tk.blocked_spmv(bg, torch.ones(bg.n, device=card))


@pytest.mark.parametrize("backend", BACKENDS)
def test_card_matches_cpu(card, backend):
    g = rmat(10, edge_factor=8, seed=3)
    on = {"card": repro_torch.Graph(g, device=card),
          "cpu": repro_torch.Graph(g, device="cpu")}
    pol = repro_torch.ExecutionPolicy(backend=backend, chunk_cap=64)
    pr = {d: G.pagerank(tol=1e-4, policy=pol) for d, G in on.items()}
    torch.testing.assert_close(pr["card"].values.cpu(), pr["cpu"].values,
                               atol=1e-6, rtol=1e-5)
    bf = {d: G.bfs([0, 1, 2], policy=pol.with_(direction="auto"))
          for d, G in on.items()}
    assert torch.equal(bf["card"].values.cpu(), bf["cpu"].values)
    for name, a, b in zip(bf["cpu"].iostats._fields, bf["card"].iostats,
                          bf["cpu"].iostats):
        assert int(a) == int(b), name


@pytest.mark.parametrize("backend", BACKENDS)
def test_host_matches_device_on_card(card, backend):
    """Host residency on the card (pinned staging, side-stream copies)
    against device residency, with one chunk or tile per batch so every
    superstep double-buffers many batches."""
    g = rmat(10, edge_factor=8, seed=3, symmetrize=True)
    dev = repro_torch.Graph(g, device=card)
    host = repro_torch.Graph(g, device=card)
    pol = repro_torch.ExecutionPolicy(backend=backend, chunk_cap=64)
    hpol = pol.with_(residency="host", stream_buffer=1)
    tk.reset_launches()
    # PageRank: values only, as its counters move with f32 summation order
    # (CUDA atomics) between any two runs on the card.
    torch.testing.assert_close(host.pagerank(tol=1e-4, policy=hpol).values,
                               dev.pagerank(tol=1e-4, policy=pol).values,
                               atol=1e-6, rtol=1e-5)
    for call in (
        lambda G, p: G.bfs(0, policy=p.with_(direction="auto")),
        lambda G, p: G.run(WCCProgram(), policy=p),
    ):
        want, got = call(dev, pol), call(host, hpol)
        assert torch.equal(got.values, want.values)
        assert int(got.supersteps) == int(want.supersteps)
        for name, a, b in zip(want.iostats._fields, got.iostats,
                              want.iostats):
            if name not in ("host_bytes", "retries"):
                assert int(a) == int(b), name
        assert int(got.iostats.host_bytes) > 0
    if backend.startswith("blocked"):
        assert tk.launches["spmv_blocked_compact"] > 0
        assert tk.launches["spmv_blocked_compact_min_plus"] > 0
    report = host.memory_report(hpol)
    assert report["device_edge_total"] == 0
    assert report["peak_stage_bytes"] > 0
