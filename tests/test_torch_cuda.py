"""The port's CUDA kernels on the card (no JAX here, so this file also runs
where only torch is installed):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each test needs a CUDA device and skips without one (the kernels have no
CPU mode).  Kernels B1/B2 are held against their plain torch versions on
the same inputs (``atol=rtol=1e-5``: a tile row's dot product sums in
another order), and the card's façade results against the CPU's (BFS and
its IOStats exact, PageRank ``atol=1e-6, rtol=1e-5``).
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.graph.generators import rmat
from repro_torch.kernels import spmv as tk

pytestmark = pytest.mark.cuda

BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
F32_TOL = dict(atol=1e-5, rtol=1e-5)


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
        args = tk.compact_tile_order(bg, act)
        G = tk.compact_grid_size(bg.num_tiles, args[6])
        sl = [a[:G] for a in args[:6]] + [args[6]]
        torch.testing.assert_close(
            tk.spmv_blocked_compact(bg, *sl, x_blocks),
            tk.blocked_spmv_plain_compact(bg, *sl, x_blocks), **F32_TOL)
        assert tk.launches == {"spmv_blocked": 1, "spmv_blocked_compact": 1}


def test_min_plus_raises(card):
    bg = tk.build_blocked(rmat(8, edge_factor=8, seed=1), semiring="min_plus",
                          device=card)
    with pytest.raises(NotImplementedError, match="B3/B4"):
        tk.blocked_spmv(bg, torch.ones(bg.n, device=card))


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
