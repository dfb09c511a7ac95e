"""The port's CUDA kernels on the card (no JAX here, so this file also runs
where only torch is installed):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each test needs a CUDA device and skips without one (the kernels have no
CPU mode).  Kernels B1/B2 are held against their plain torch versions on
the same inputs (``atol=rtol=1e-5``: a tile row's dot product sums in
another order), B3/B4 with ``torch.equal`` (min is order-free); each also
against the plain version of its payload arithmetic (B1/B3 the row
payload, B2/B4 the tile-major payload), two launches must give the same
bits, B2/B4's wrapper must not synchronise (and so can be captured in a
CUDA graph), and on an ``x`` holding +-inf or NaN all four must put NaN
where the reference's dense product has it; past 192 lanes the wrappers
launch lane groups, each lane bit-equal to its group run alone; the
batched driver's BFS equals its solo runs on the card; and the
card's façade results against the CPU's and host residency against device
residency (BFS, WCC and their IOStats exact, PageRank ``atol=1e-6,
rtol=1e-5``).  Kernel B5 (decode attention) is held against its plain
version within ``atol=rtol=1e-4``, two launches must give the same bits
and a CUDA graph must capture it, and the LM serve path on the card must
launch it on every layer of every step.  The sum scatter adds in a fixed
order on the card (two runs bit-equal, batched PPR columns bit-equal to
their solo runs), an asynchronous checkpoint copies the state before the
next superstep writes it, and a killed run resumes to the same bits.  The
contract checker on a CUDA view flags a host read as R2, finds nothing in
a clean WCC whose recorded superstep launches B3/B4, and leaves
``run(analyze=True)`` bit-equal to ``run()``.  The chunked attention's
backward is held against autograd through the dense f32 softmax, and a
one-layer gemma-2b train step runs twice from one state.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.semiring import MIN_PLUS
from repro_torch.graph import csr as tcsr
from repro_torch.graph.generators import rmat, star_graph
from repro_torch.configs import get_smoke
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import spmv as tk
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build_model

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
        y = tk.spmv_blocked(bg, act, x_blocks)
        torch.testing.assert_close(y, tk.blocked_spmv_plain(bg, act, x_blocks),
                                   **F32_TOL)
        torch.testing.assert_close(
            y, tk.blocked_spmv_plain_rows(bg, act, x_blocks), **F32_TOL)
        sl = _compact_args(bg, act)
        y2 = tk.spmv_blocked_compact(bg, *sl, x_blocks)
        torch.testing.assert_close(
            y2, tk.blocked_spmv_plain_compact(bg, *sl, x_blocks), **F32_TOL)
        torch.testing.assert_close(
            y2, tk.blocked_spmv_plain_compact_rows(bg, *sl, x_blocks),
            **F32_TOL)
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
        y = tk.spmv_blocked(bg, act, x_blocks)
        assert torch.equal(y, tk.blocked_spmv_plain(bg, act, x_blocks))
        assert torch.equal(y, tk.blocked_spmv_plain_rows(bg, act, x_blocks))
        sl = _compact_args(bg, act)
        y2 = tk.spmv_blocked_compact(bg, *sl, x_blocks)
        assert torch.equal(y2, tk.blocked_spmv_plain_compact(bg, *sl,
                                                             x_blocks))
        assert torch.equal(y2, tk.blocked_spmv_plain_compact_rows(bg, *sl,
                                                                  x_blocks))
        assert tk.launches == dict(NO_LAUNCH, spmv_blocked_min_plus=1,
                                   spmv_blocked_compact_min_plus=1)


def test_b1_is_deterministic(card):
    """No atomics and a fixed reduction order: two launches of B1 on the
    same inputs give the same bits, at K=1 and K=4."""
    g = rmat(12, edge_factor=16, seed=2)
    bg = tk.build_blocked(g, tile_order="hilbert", device=card)
    act = torch.ones(bg.num_tiles, dtype=torch.int32, device=card)
    for k in (1, 4):
        gen = torch.Generator(device=card).manual_seed(k)
        x_blocks = torch.randn((bg.n_src_blocks, bg.bs, k), generator=gen,
                               device=card)
        assert torch.equal(tk.spmv_blocked(bg, act, x_blocks),
                           tk.spmv_blocked(bg, act, x_blocks))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_star_hub_row_splits_on_card(card, semiring):
    """A hub row of 20,000 entries runs as ceil(20,000 / SEG_ENTRIES)
    segments combined by the second pass; B1/B3 against both plain
    versions."""
    n = 20_001
    bg = tk.build_blocked(star_graph(n), semiring=semiring, device=card)
    assert int(bg.row_seg[1] - bg.row_seg[0]) > 1
    x_blocks = torch.rand((bg.n_src_blocks, bg.bs, 1), device=card)
    act = torch.ones(bg.num_tiles, dtype=torch.int32, device=card)
    y = tk.spmv_blocked(bg, act, x_blocks)
    for plain in (tk.blocked_spmv_plain, tk.blocked_spmv_plain_rows):
        if semiring == "min_plus":
            assert torch.equal(y, plain(bg, act, x_blocks))
        else:
            torch.testing.assert_close(y, plain(bg, act, x_blocks),
                                       **F32_TOL)


def test_unsupported_shape_raises(card):
    """The kernels read payloads, so any tile shape runs (bs=256 here); K
    past ``_MAX_K`` lanes, once refused, now runs in lane groups."""
    bg = tk.build_blocked(rmat(8, edge_factor=8, seed=1), bd=32, bs=256,
                          device=card)
    x = torch.rand(bg.n, device=card)
    for compact in (False, True):
        torch.testing.assert_close(
            tk.blocked_spmv(bg, x, compact=compact)[0],
            tk.blocked_spmv(tk.build_blocked(
                rmat(8, edge_factor=8, seed=1), bd=32, bs=256, device="cpu"),
                x.cpu(), compact=compact)[0].to(card), **F32_TOL)
    y, _ = tk.blocked_spmv(bg, torch.ones(bg.n, 193, device=card))
    torch.testing.assert_close(y, tk.blocked_spmv(
        bg, torch.ones(bg.n, 1, device=card))[0].expand(-1, 193), **F32_TOL)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("k", [192, 193, 256, 400])
def test_lane_groups_on_card(card, semiring, k):
    """More lanes than one launch takes (192) run as launches of at most
    192 lanes, one a group (each counted): within ``atol=rtol=1e-5`` of
    the plain versions (B3/B4 bit for bit), two calls bit-equal, and each
    lane bit-equal to the same lane run in a launch of its own group
    alone (a lane's bits do not depend on its group)."""
    g = rmat(10, edge_factor=16, seed=1, symmetrize=semiring == "min_plus")
    bg = tk.build_blocked(g, semiring=semiring, device=card)
    x_blocks = _x_for(bg, k, seed=k, card=card)
    mask = np.random.default_rng(k).random(g.n) < 0.3
    act = tk.tile_activity(bg, torch.as_tensor(mask, device=card))
    sl = _compact_args(bg, act)
    groups = -(-k // 192)
    full = "spmv_blocked" + ("_min_plus" if semiring == "min_plus" else "")
    comp = "spmv_blocked_compact" + ("_min_plus" if semiring == "min_plus"
                                     else "")
    tk.reset_launches()
    y1 = tk.spmv_blocked(bg, act, x_blocks)
    y2 = tk.spmv_blocked_compact(bg, *sl, x_blocks)
    assert tk.launches == dict(NO_LAUNCH, **{full: groups, comp: groups})
    for y, plain in ((y1, tk.blocked_spmv_plain(bg, act, x_blocks)),
                     (y2, tk.blocked_spmv_plain_compact(bg, *sl, x_blocks))):
        if semiring == "min_plus":
            assert torch.equal(y, plain)
        else:
            torch.testing.assert_close(y, plain, **F32_TOL)
    assert torch.equal(y1, tk.spmv_blocked(bg, act, x_blocks))
    assert torch.equal(y2, tk.spmv_blocked_compact(bg, *sl, x_blocks))
    last = slice(192 * (groups - 1), k)
    xg = x_blocks[..., last].contiguous()
    assert torch.equal(y1[..., last], tk.spmv_blocked(bg, act, xg))
    assert torch.equal(y2[..., last], tk.spmv_blocked_compact(bg, *sl, xg))


def test_batched_bfs_and_ppr_on_card(card):
    """The batched driver on the card: BFS at Q=32 equals 32 solo runs
    (values, query supersteps) on both blocked backends and both
    residencies, and personalized PageRank's columns lie within
    ``atol=1e-6, rtol=1e-5`` of width-one runs."""
    g = rmat(10, edge_factor=16, seed=1)
    G = repro_torch.Graph(g, device=card, bd=64, bs=64)
    sources = list(range(0, 64, 2))
    for backend in ("blocked", "blocked_compact"):
        for residency in ("device", "host"):
            pol = repro_torch.ExecutionPolicy(backend=backend,
                                              residency=residency)
            tk.reset_launches()
            res = G.bfs(sources, policy=pol)
            b1 = (backend, residency) == ("blocked", "device")
            assert tk.launches["spmv_blocked" if b1
                               else "spmv_blocked_compact"] > 0
            assert int(res.iostats.queries) == len(sources)
            for q in (0, 7, 31):
                solo = G.bfs(sources[q], policy=pol)
                assert torch.equal(res.values[:, q], solo.values)
                assert int(res.query_supersteps[q]) == int(solo.supersteps)
        ppr = G.pagerank(reset=sources[:8], policy=pol.with_(
            residency="device"))
        for q in (0, 5):
            solo = G.pagerank(reset=sources[q:q + 1], policy=pol.with_(
                residency="device"))
            torch.testing.assert_close(ppr.values[:, q], solo.values[:, 0],
                                       atol=1e-6, rtol=1e-5)


ORDERS = ("dest", "morton", "hilbert")


def _x_for(bg, k, seed, card):
    """Random x blocks: floats (plus_times) or integer labels with a fifth
    of them +inf (min_plus)."""
    rng = np.random.default_rng(seed)
    shape = (bg.n_src_blocks, bg.bs, k)
    if bg.semiring == "min_plus":
        x = rng.integers(0, bg.n, shape).astype(np.float32)
        x[rng.random(shape) < 0.2] = np.inf
    else:
        x = rng.random(shape).astype(np.float32)
    return torch.as_tensor(x, device=card)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "bool"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bd,bs", [(128, 128), (48, 32)])
def test_compact_kernels_match_plain(card, semiring, order, k, bd, bs):
    """B2/B4 over the tile-major payload against the plain version of
    their arithmetic and the dense plain version: B2 within
    ``atol=rtol=1e-5`` (sums of 0/1 on 'bool' tiles exactly), B4 bit for
    bit, on full, sparse and empty frontiers."""
    g = rmat(10, edge_factor=16, seed=1, symmetrize=semiring == "min_plus")
    bg = tk.build_blocked(g, bd=bd, bs=bs, tile_order=order,
                          semiring=semiring, device=card)
    x_blocks = _x_for(bg, k, seed=k, card=card)
    if semiring == "bool":
        x_blocks = (x_blocks > 0.5).float()
    exact = semiring != "plus_times"
    for density in (1.0, 0.1, 0.0):
        mask = np.random.default_rng(k).random(g.n) < density
        act = tk.tile_activity(bg, torch.as_tensor(mask, device=card))
        sl = _compact_args(bg, act)
        y = tk.spmv_blocked_compact(bg, *sl, x_blocks)
        for plain in (tk.blocked_spmv_plain_compact_rows,
                      tk.blocked_spmv_plain_compact):
            want = plain(bg, *sl, x_blocks)
            if exact:
                assert torch.equal(y, want), plain.__name__
            else:
                torch.testing.assert_close(y, want, **F32_TOL)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("k", [2, 3, 4, 8, 16, 32, 33, 70, 97, 150, 192, 256])
def test_lanes_match_plain_and_k1_columns(card, semiring, order, k):
    """B1/B2 (B3/B4 on min_plus tiles) at K lanes: every lane group of the
    K > 1 pass of B1 (2, 4, 8, 16 or 32 threads a segment; 1 to 6 lanes a
    thread) and B2's word and float4 chunks, odd widths, widths that are
    not multiples of 4 and two lane groups (256): within ``atol=rtol=1e-5``
    of both plain versions (min_plus bit for bit), two launches bit-equal,
    and every column ``torch.equal`` to the K=1 call on that column."""
    minp = semiring == "min_plus"
    g = rmat(10, edge_factor=16, seed=1, symmetrize=minp)
    bg = tk.build_blocked(g, tile_order=order, semiring=semiring,
                          device=card)
    x_blocks = _x_for(bg, k, seed=k, card=card)
    for density in (1.0, 0.1):
        mask = np.random.default_rng(k).random(g.n) < density
        act = tk.tile_activity(bg, torch.as_tensor(mask, device=card))
        sl = _compact_args(bg, act)
        y1 = tk.spmv_blocked(bg, act, x_blocks)
        y2 = tk.spmv_blocked_compact(bg, *sl, x_blocks)
        assert torch.equal(y1, tk.spmv_blocked(bg, act, x_blocks))
        assert torch.equal(y2, tk.spmv_blocked_compact(bg, *sl, x_blocks))
        for got, plains in (
                (y1, (tk.blocked_spmv_plain(bg, act, x_blocks),
                      tk.blocked_spmv_plain_rows(bg, act, x_blocks))),
                (y2, (tk.blocked_spmv_plain_compact(bg, *sl, x_blocks),
                      tk.blocked_spmv_plain_compact_rows(bg, *sl,
                                                         x_blocks)))):
            for want in plains:
                if minp:
                    assert torch.equal(got, want)
                else:
                    torch.testing.assert_close(got, want, **F32_TOL)
        for q in range(k):
            xq = x_blocks[..., q:q + 1].contiguous()
            assert torch.equal(y1[..., q:q + 1],
                               tk.spmv_blocked(bg, act, xq)), q
            assert torch.equal(y2[..., q:q + 1],
                               tk.spmv_blocked_compact(bg, *sl, xq)), q


def _tile_batch(bg, ids):
    """The batch-local tile-major payload of the view's tiles ``ids``, as
    host residency stages it."""
    tp = bg.tile_ptr.long()
    cnt = tp[ids + 1] - tp[ids]
    local = torch.zeros(ids.numel() + 1, dtype=torch.int64, device=ids.device)
    local[1:] = torch.cumsum(cnt, 0)
    e = (torch.repeat_interleave(tp[ids] - local[:-1], cnt)
         + torch.arange(int(local[-1]), device=ids.device))
    return tk.TileBatch(tile_ptr=local.to(torch.int32),
                        tent_row=bg.tent_row[e], tent_src=bg.tent_src[e],
                        tent_w=bg.tent_w[e], sbid=bg.sbid[ids], n=bg.n,
                        bd=bg.bd, bs=bg.bs, semiring=bg.semiring)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_tile_batch_lanes_on_card(card, semiring):
    """B2/B4 through a :class:`TileBatch` (host residency's batch-local
    payload) at K=8, as the host batched runs give it: bit-equal to the
    full view's call on the same live list (the same windows and order),
    within ``atol=rtol=1e-5`` of the payload plain version (min_plus bit
    for bit), and every column equal to its K=1 call."""
    minp = semiring == "min_plus"
    g = rmat(11, edge_factor=16, seed=5, symmetrize=minp)
    bg = tk.build_blocked(g, semiring=semiring, device=card)
    act = tk.tile_activity(bg, torch.as_tensor(
        np.random.default_rng(3).random(g.n) < 0.4, device=card))
    perm, dbid, sbid, first, last, accum, nact = _compact_args(bg, act)
    x_blocks = _x_for(bg, 8, seed=9, card=card)
    args = (dbid, sbid, first, last, accum, nact)
    want = tk.spmv_blocked_compact(bg, perm, *args, x_blocks)
    view = _tile_batch(bg, perm[:nact].long())
    local = torch.arange(nact, dtype=torch.int32, device=card)
    tk.reset_launches()
    got = tk.spmv_blocked_compact(view, local, *args, x_blocks)
    assert sum(tk.launches.values()) == 1
    assert torch.equal(got, want)
    plain = tk.blocked_spmv_plain_compact_rows(view, local, *args, x_blocks)
    if minp:
        assert torch.equal(got, plain)
    else:
        torch.testing.assert_close(got, plain, **F32_TOL)
    for q in range(8):
        xq = x_blocks[..., q:q + 1].contiguous()
        assert torch.equal(got[..., q:q + 1],
                           tk.spmv_blocked_compact(view, local, *args, xq))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_compact_is_deterministic(card, semiring):
    """No atomics and a fixed order: two launches of B2/B4 give the same
    bits, at K=1 and K=4, on a curve order."""
    g = rmat(12, edge_factor=16, seed=2, symmetrize=True)
    bg = tk.build_blocked(g, tile_order="hilbert", semiring=semiring,
                          device=card)
    act = tk.tile_activity(bg, torch.arange(g.n, device=card) < g.n // 3)
    sl = _compact_args(bg, act)
    for k in (1, 4):
        x_blocks = _x_for(bg, k, seed=k, card=card)
        assert torch.equal(tk.spmv_blocked_compact(bg, *sl, x_blocks),
                           tk.spmv_blocked_compact(bg, *sl, x_blocks))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_star_hub_block_splits_on_card(card, semiring):
    """The hub block of a star with 20,000 in-edges holds 157 live tiles:
    five windows, combined in window order by the second pass."""
    n = 20_001
    bg = tk.build_blocked(star_graph(n), semiring=semiring, device=card)
    x_blocks = torch.rand((bg.n_src_blocks, bg.bs, 1), device=card)
    act = torch.ones(bg.num_tiles, dtype=torch.int32, device=card)
    sl = _compact_args(bg, act)
    assert int((sl[1][:sl[6]] == 0).sum()) > 4 * 32
    y = tk.spmv_blocked_compact(bg, *sl, x_blocks)
    for plain in (tk.blocked_spmv_plain_compact_rows,
                  tk.blocked_spmv_plain_compact):
        if semiring == "min_plus":
            assert torch.equal(y, plain(bg, *sl, x_blocks))
        else:
            torch.testing.assert_close(y, plain(bg, *sl, x_blocks),
                                       **F32_TOL)


def test_compact_edge_cases_on_card(card):
    """An empty live set gives the identity everywhere; an edgeless view
    too."""
    g = rmat(9, edge_factor=8, seed=3)
    for semiring, ident in (("plus_times", 0.0), ("min_plus", float("inf"))):
        bg = tk.build_blocked(g, semiring=semiring, tile_order="hilbert",
                              bd=32, bs=16, device=card)
        x_blocks = _x_for(bg, 2, seed=0, card=card)
        act = torch.zeros(bg.num_tiles, dtype=torch.int32, device=card)
        sl = _compact_args(bg, act)
        assert sl[6] == 0
        y = tk.spmv_blocked_compact(bg, *sl, x_blocks)
        assert torch.equal(y, torch.full_like(y, ident))
    empty = tk.build_blocked(
        tcsr.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), n=40),
        bd=32, bs=16, device=card)
    act = torch.ones(empty.num_tiles, dtype=torch.int32, device=card)
    sl = _compact_args(empty, act)
    y = tk.spmv_blocked_compact(empty, *sl, torch.ones(
        (empty.n_src_blocks, 16, 2), device=card))
    assert torch.equal(y, torch.zeros_like(y))


@pytest.mark.parametrize("order", ["dest", "hilbert"])
def test_compact_wrapper_never_syncs(card, order):
    """``spmv_blocked_compact`` adds no device-to-host sync: it runs under
    ``set_sync_debug_mode('error')`` and inside a CUDA-graph capture, and
    the replay gives the eager call's bits."""
    g = rmat(11, edge_factor=16, seed=4)
    bg = tk.build_blocked(g, tile_order=order, device=card)
    act = tk.tile_activity(bg, torch.arange(g.n, device=card) < g.n // 8)
    sl = _compact_args(bg, act)
    x_blocks = _x_for(bg, 1, seed=5, card=card)
    want = tk.spmv_blocked_compact(bg, *sl, x_blocks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tk.spmv_blocked_compact(bg, *sl, x_blocks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = tk.spmv_blocked_compact(bg, *sl, x_blocks)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("poison", ["inf", "-inf", "nan"])
def test_non_finite_x_matches_dense_form_on_card(card, semiring, poison):
    """ROADMAP §C P12: on an x holding +inf, -inf or NaN, B1-B4 put NaN
    exactly where the dense product (and the reference) has it and the
    same infinities elsewhere: equal to the dense plain versions, NaN for
    NaN (min_plus bit for bit)."""
    g = rmat(10, edge_factor=8, seed=6, symmetrize=True)
    bg = tk.build_blocked(g, semiring=semiring, tile_order="hilbert", bd=48,
                          bs=32, device=card)
    x_blocks = _x_for(bg, 2, seed=7, card=card)
    rng = np.random.default_rng(8)
    hit = torch.as_tensor(rng.random(tuple(x_blocks.shape)) < 0.002,
                          device=card)
    x_blocks = torch.where(hit, float(poison), x_blocks)
    mask = torch.as_tensor(rng.random(g.n) < 0.5, device=card)
    act = tk.tile_activity(bg, mask)
    sl = _compact_args(bg, act)
    tol = (dict(atol=0, rtol=0) if semiring == "min_plus" else F32_TOL)
    y1 = tk.spmv_blocked(bg, act, x_blocks)
    y2 = tk.spmv_blocked_compact(bg, *sl, x_blocks)
    want1 = tk.blocked_spmv_plain(bg, act, x_blocks)
    want2 = tk.blocked_spmv_plain_compact(bg, *sl, x_blocks)
    if poison != "inf" or semiring == "plus_times":
        assert torch.isnan(want1).any()
    for got, want, rows in (
            (y1, want1, tk.blocked_spmv_plain_rows(bg, act, x_blocks)),
            (y2, want2, tk.blocked_spmv_plain_compact_rows(bg, *sl,
                                                           x_blocks))):
        torch.testing.assert_close(got, want, equal_nan=True, **tol)
        torch.testing.assert_close(got, rows, equal_nan=True, **tol)


@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("stream_buffer", [1, 16])
def test_host_tiles_match_device_on_card(card, order, stream_buffer):
    """Host tile batches (the staged tile-major payload through B2/B4)
    against device residency on the card: BFS levels and WCC labels and
    their IOStats exact, PageRank values within ``atol=1e-6, rtol=1e-5``;
    the bytes really copied are the staged payload's."""
    g = rmat(11, edge_factor=8, seed=3, symmetrize=True)
    dev = repro_torch.Graph(g, device=card)
    host = repro_torch.Graph(g, device=card)
    pol = repro_torch.ExecutionPolicy(backend="blocked_compact",
                                      tile_order=order)
    hpol = pol.with_(residency="host", stream_buffer=stream_buffer)
    torch.testing.assert_close(host.pagerank(tol=1e-4, policy=hpol).values,
                               dev.pagerank(tol=1e-4, policy=pol).values,
                               atol=1e-6, rtol=1e-5)
    for call in (lambda G, p: G.bfs(0, policy=p),
                 lambda G, p: G.run(WCCProgram(), policy=p)):
        want, got = call(dev, pol), call(host, hpol)
        assert torch.equal(got.values, want.values)
        for name, a, b in zip(want.iostats._fields, got.iostats,
                              want.iostats):
            if name not in ("host_bytes", "retries"):
                assert int(a) == int(b), name


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


# ------------------------------------------------ B5: decode attention
def _decode_inputs(card, b, kv, g, hd, t, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, kv * g, hd), generator=gen, device=card).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device=card).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device=card).to(dtype)
    perm = torch.randperm(t, generator=gen, device=card)
    pos = perm[None].repeat(b, 1).to(torch.int32)  # rotated slot order
    return q, k, v, pos


@pytest.mark.parametrize("b,kv,g,hd,t,dtype,window", [
    (2, 1, 8, 256, 256, torch.bfloat16, 0),  # gemma-2b's heads
    (3, 2, 4, 80, 96, torch.float32, 0),  # danube's head_dim, T % 128 != 0
    (2, 4, 2, 64, 512, torch.bfloat16, 100),  # a window, gemma3's grouping
    (2, 1, 16, 256, 256, torch.bfloat16, 0),  # G=16: every mma row a head
    (2, 2, 4, 128, 512, torch.bfloat16, 0),  # command-r's head_dim
    (3, 1, 8, 256, 1000, torch.bfloat16, 0),  # bt=125: ragged chunks
    (2, 32, 1, 80, 2112, torch.bfloat16, 0),  # zamba2: hd=80, KV=32, G=1
    (2, 4, 16, 128, 1088, torch.bfloat16, 0),  # qwen3-moe: G=16, bt=68
    (4, 8, 1, 64, 1564, torch.bfloat16, 0),  # whisper: KV=8, G=1, bt=92
])
def test_decode_attn_kernel_matches_plain(card, b, kv, g, hd, t, dtype,
                                          window):
    """B5 against its plain version on the same inputs, ``atol=rtol=1e-4``
    (the same f32 math over the same bf16/f32 inputs in another summation
    order); the last row's cache is empty and must give 0."""
    q, k, v, pos = _decode_inputs(card, b, kv, g, hd, t, dtype, seed=hd)
    pos[-1] = -1
    cur = torch.tensor([t // 2 + i for i in range(b)], dtype=torch.int32,
                       device=card)
    tda.reset_launches()
    got = tda.decode_attention(q, k, v, pos, cur, window=window)
    torch.cuda.synchronize()
    assert tda.launches["decode_attention"] == 1
    want = tda.decode_attention_plain(q, k, v, pos, cur, window=window)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.count_nonzero(got[-1]) == 0


def test_decode_attn_kernel_is_deterministic(card):
    """Two launches give the same bits: the warps and the splits merge in
    a fixed order (the serve shape splits each row over 16 blocks)."""
    q, k, v, pos = _decode_inputs(card, 4, 1, 8, 256, 1024, torch.bfloat16, 5)
    cur = torch.tensor([1023, 700, 200, 5], dtype=torch.int32, device=card)
    a = tda.decode_attention(q, k, v, pos, cur)
    b = tda.decode_attention(q, k, v, pos, cur)
    assert torch.equal(a, b)


def test_decode_attn_kernel_captures_in_a_cuda_graph(card):
    """The call neither synchronises nor allocates beyond its output, so a
    CUDA graph captures it; a replay after new inputs are copied in gives
    the eager call's bits."""
    q, k, v, pos = _decode_inputs(card, 4, 1, 8, 256, 1024, torch.bfloat16, 6)
    cur = torch.full((4,), 1023, dtype=torch.int32, device=card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tda.decode_attention(q, k, v, pos, cur)  # workspace made outside
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = tda.decode_attention(q, k, v, pos, cur)
    torch.cuda.current_stream().wait_stream(stream)
    q2, k2, v2, pos2 = _decode_inputs(card, 4, 1, 8, 256, 1024,
                                      torch.bfloat16, 7)
    for dst, src in ((q, q2), (k, k2), (v, v2), (pos, pos2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, tda.decode_attention(q, k, v, pos, cur))


def test_decode_attn_kernel_refuses_what_it_does_not_take(card):
    q, k, v, pos = _decode_inputs(card, 1, 1, 32, 16, 64, torch.float32, 1)
    cur = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="query heads"):
        tda.decode_attention(q, k, v, pos, cur)  # G = 32 > 16
    q, k, v, pos = _decode_inputs(card, 1, 1, 4, 16, 64, torch.float32, 1)
    with pytest.raises(TypeError, match="int32"):
        tda.decode_attention(q, k, v, pos.long(), cur)
    with pytest.raises(TypeError, match="share"):
        tda.decode_attention(q, k.to(torch.bfloat16), v, pos, cur)


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-4b"])
def test_serve_batch_on_card_launches_b5(card, arch):
    """A smoke-size ``serve_batch`` on the card runs every layer's
    attention through B5, and its schedule is the CPU run's."""
    tda.reset_launches()
    res = serve_batch(arch, n_requests=4, max_batch=2, max_new=4,
                      max_len=32, device=card)
    n_layers = get_smoke(arch).n_layers
    assert tda.launches["decode_attention"] == n_layers * res["decode_steps"]
    cpu = serve_batch(arch, n_requests=4, max_batch=2, max_new=4,
                      max_len=32, device="cpu")
    assert res["decode_steps"] == cpu["decode_steps"]
    assert res["tokens"] == cpu["tokens"] == 16


def test_decode_step_kernel_matches_plain_route(card):
    """Teacher-forced steps of one model through B5 and through the plain
    attention: logits within 0.05 * max|logits| (the bound of
    ``tests/test_serving_parity.py``)."""
    cfg = get_smoke("gemma3-4b")
    fast = build_model(cfg, card)
    plain = build_model(cfg, card, attention=tda.decode_attention_plain)
    params = fast.init(torch.Generator(device=card).manual_seed(2))
    a, b = fast.init_cache(2, 12), plain.init_cache(2, 12)
    tokens = np.random.default_rng(4).integers(1, cfg.vocab, (16, 2, 1))
    for s in range(16):
        tok = torch.as_tensor(tokens[s], device=card)
        la, a = fast.decode_step(params, a, tok)
        lb, b = plain.decode_step(params, b, tok)
        scale = max(float(lb.abs().max()), 1.0)
        assert float((la - lb).abs().max()) < 0.05 * scale


# ------------------------------------------------- fixed-order sums (P17)
def test_scatter_add_fixed_order_on_card(card):
    """``Semiring.scatter``'s add on the card equals the CPU's
    ``index_add`` within ``atol=1e-6, rtol=1e-5`` (bit for bit from a zero
    ``y``: both add each key's terms one after another in edge order) on
    every row but the sentinel (the last, which callers drop), and gives
    the same bits on every call, at one and at 16 lanes."""
    from repro_torch.core.semiring import PLUS_TIMES

    g = torch.Generator().manual_seed(0)
    for lanes in (None, 16):
        shape = (200_000,) if lanes is None else (200_000, lanes)
        keys = torch.randint(0, 5001, (200_000,), generator=g)
        keys[:5000] = 77  # one hub key with a long run
        keys[-90_000:] = 5000  # masked terms, into the sentinel row
        contrib = torch.randn(shape, generator=g)
        y = torch.zeros((5001,) + shape[1:])
        want = y.index_add(0, keys, contrib)
        first = PLUS_TIMES.scatter(y.to(card), keys.to(card),
                                   contrib.to(card))
        got = first.cpu()[:-1]
        torch.testing.assert_close(got, want[:-1], atol=1e-6, rtol=1e-5)
        assert torch.equal(got, want[:-1])
        for _ in range(10):
            again = PLUS_TIMES.scatter(y.to(card), keys.to(card),
                                       contrib.to(card))
            assert torch.equal(again, first)


def test_scan_and_compact_pagerank_repeat_bitwise_on_card(card):
    """Two PageRank push runs on scan and on compact give the same bits,
    and so do two one-hot personalized PageRank batches, whose columns
    also equal their solo runs bit for bit (the +0.0 terms of inactive
    lanes leave a fixed-order sum unchanged)."""
    g = rmat(10, edge_factor=16, seed=1)
    G = repro_torch.Graph(g, device=card, bd=64, bs=64)
    sources = [0, 2, 4, 6, 8, 10, 12, 14]
    for backend in ("scan", "compact"):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        a, b = G.pagerank(policy=pol), G.pagerank(policy=pol)
        assert torch.equal(a.values, b.values)
        p, q = (G.pagerank(reset=sources, policy=pol) for _ in range(2))
        assert torch.equal(p.values, q.values)
        for col in range(len(sources)):
            solo = G.pagerank(reset=sources[col:col + 1], policy=pol)
            assert torch.equal(p.values[:, col], solo.values[:, 0])


def test_no_live_chunk_on_card(card):
    """A frontier of sinks that lie outside every chunk's [lo, hi] gives
    the compact gather no edge terms: the card's add scatter then returns
    ``y`` as the CPU's ``index_add`` does, and one-hot personalized
    PageRank from such a sink (an extra vertex with no edges) on compact
    matches the CPU's run."""
    from repro_torch.core.semiring import PLUS_TIMES

    y = torch.randn(38, 5, generator=torch.Generator().manual_seed(1))
    keys = torch.zeros(0, dtype=torch.int64)
    got = PLUS_TIMES.scatter(y.to(card), keys.to(card),
                             torch.zeros(0, 5, device=card))
    assert torch.equal(got.cpu(), y)
    base = rmat(10, edge_factor=8, seed=3)
    src = np.repeat(np.arange(base.n), np.diff(base.indptr))
    g = tcsr.from_edges(src, base.indices, n=base.n + 1)
    pol = repro_torch.ExecutionPolicy(backend="compact", switch_fraction=None)
    on = {d: repro_torch.Graph(g, device=d).pagerank(reset=[base.n],
                                                     policy=pol)
          for d in (card, "cpu")}
    torch.testing.assert_close(on[card].values.cpu(), on["cpu"].values,
                               atol=1e-6, rtol=1e-5)
    assert int(on[card].supersteps) == int(on["cpu"].supersteps)


def test_async_save_snapshots_before_the_next_superstep(card, tmp_path):
    """A background checkpoint taken just before a superstep mutates the
    card's state in place restores the pre-mutation bits."""
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint

    x = torch.randn(1 << 22, device=card)
    flags = x > 0
    want = (x.cpu().clone(), flags.cpu().clone())
    mgr = CheckpointManager(tmp_path, keep=1, max_shard_bytes=1 << 20)
    mgr.save(1, {"x": x, "flags": flags}, blocking=False)
    for _ in range(8):  # the next supersteps write the live tensors
        x.mul_(-1.5).add_(2.0)
        flags.logical_not_()
    mgr.wait()
    got, _ = restore_checkpoint(tmp_path, {"x": torch.zeros_like(x),
                                           "flags": torch.zeros_like(flags)})
    assert got["x"].device.type == "cuda"
    assert torch.equal(got["x"].cpu(), want[0])
    assert torch.equal(got["flags"].cpu(), want[1])


def test_kill_and_resume_on_card(card, tmp_path):
    """PageRank push killed twice and BFS killed once on the blocked
    backends and scan, device residency: bitwise the uninterrupted run."""
    from repro_torch.core import CheckpointSpec, FailurePlan, run_supervised
    from repro_torch.algs import BFSProgram, PageRankPushProgram

    g = rmat(10, edge_factor=16, seed=1)
    G = repro_torch.Graph(g, device=card, bd=64, bs=64)
    for backend in ("scan", "blocked", "blocked_compact"):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        for name, prog, seeds, plan in (
            ("pr", PageRankPushProgram(), None, {5: "crash", 11: "crash"}),
            ("bfs", BFSProgram(), torch.tensor([3]), {2: "crash"}),
        ):
            sem = G._sem(pol, prog)
            base = repro_torch.run_program(sem, prog, pol, seeds=seeds)
            res, rep = run_supervised(
                sem, prog, pol, seeds=seeds, plan=FailurePlan(dict(plan)),
                checkpoint=CheckpointSpec(tmp_path / backend / name,
                                          every_k=4))
            assert rep.restarts == len(plan)
            assert torch.equal(res.values, base.values)
            assert int(res.supersteps) == int(base.supersteps)
            for x, y in zip(res.iostats, base.iostats):
                assert int(x) == int(y)


class HostSyncWCC(WCCProgram):
    """WCC whose apply reads a device value to the host (the twin of
    ``tests/test_analysis.py``'s ``B2HostSync``)."""

    def apply(self, sg, s, gathered):
        total = float(torch.sum(gathered))
        labels = torch.minimum(s.labels, gathered + total * 0.0)
        changed = labels < s.labels
        return WCCState(labels, changed), changed


@pytest.mark.parametrize("backend", ["blocked", "blocked_compact"])
def test_analyzer_on_card(card, backend):
    """The analyzer on a CUDA view: the host read is R2 in apply, the clean
    WCC has no finding and launches its min_plus kernel (B3 or B4) inside
    the recorded superstep, and ``run(analyze=True)`` equals ``run()`` bit
    for bit."""
    from repro_torch import analysis

    g = rmat(10, edge_factor=8, seed=3, symmetrize=True)
    pol = repro_torch.ExecutionPolicy(backend=backend)
    s = repro_torch.Graph(g, device=card)
    bad = analysis.check(s, HostSyncWCC(), pol)
    assert [(f.rule, f.hook) for f in bad.findings] == [("R2", "apply")]
    rep = analysis.check(s, WCCProgram(), pol)
    assert rep.ok, rep.render()
    kernel = {"blocked": "spmv_blocked_min_plus",
              "blocked_compact": "spmv_blocked_compact_min_plus"}[backend]
    assert any(f"{kernel} 1" in n for n in rep.notes), rep.notes
    a = repro_torch.Graph(g, device=card).run(WCCProgram(), policy=pol)
    b = repro_torch.Graph(g, device=card).run(WCCProgram(), policy=pol,
                                              analyze=True)
    assert torch.equal(a.values, b.values)
    assert int(a.supersteps) == int(b.supersteps)
    assert [int(x) for x in a.iostats] == [int(x) for x in b.iostats]


# ------------------------------------------------ every LM family on card
FAMILY_ARCHS = ["gemma-2b", "gemma3-4b", "qwen3-moe-235b-a22b",
                "mamba2-370m", "zamba2-2.7b", "whisper-base", "qwen2-vl-72b"]


def _attn_layers(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_decode_on_card_equals_forward(card, arch, monkeypatch):
    """``tests/test_serving_parity.py``'s contract on the card at smoke
    size (B=2, S=24, max_len S + 8, moe at capacity factor 8): the decode
    of token S after a prefill of S tokens against ``forward`` over S + 1
    tokens (max |d| < 0.05 x max|logits| and the argmax equal on every
    row; moe: the 90th percentile < 0.06 x max and half the argmaxes),
    with B5 launched once a step on every attention layer.

    A moe token whose k-th and (k+1)-th experts nearly tie can be routed
    apart by the last bits the two paths differ in, which moves its logits
    by a whole expert's output: ``tests/test_serving_parity.py`` allows
    for it on "1-2 tokens", so moe's bound holds over the rows routed
    alike in every layer, which must be at least half."""
    import dataclasses

    from repro_torch.models import moe

    routes = []
    route = moe._route

    def logged(*args, **kw):
        out = route(*args, **kw)
        routes.append(out[1][-1].sort(dim=-1).values)
        return out

    monkeypatch.setattr(moe, "_route", logged)
    cfg = get_smoke(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(5))
    gen = torch.Generator(device=card).manual_seed(0)
    toks = torch.randint(1, cfg.vocab, (2, 25), generator=gen, device=card)
    full, prompt = {"tokens": toks}, {"tokens": toks[:, :24]}
    extra = {"encdec": ("frames", 24), "vlm": ("vision_embeds", 8)}
    if cfg.family in extra:
        key, n = extra[cfg.family]
        full[key] = prompt[key] = (torch.randn(
            (2, n, cfg.d_model), generator=gen, device=card) * 0.1).to(
                torch.bfloat16)
    with torch.inference_mode():
        oracle = model.forward(params, full)[0][:, -1, :cfg.vocab]
    _, cache = model.prefill(params, prompt, max_len=32)
    tda.reset_launches()
    got, cache = model.decode_step(params, cache, toks[:, 24:])
    torch.cuda.synchronize()
    assert tda.launches["decode_attention"] == _attn_layers(cfg)
    got = got[:, :cfg.vocab]
    scale = max(float(oracle.abs().max()), 1.0)
    same = got.argmax(-1) == oracle.argmax(-1)
    if cfg.family == "moe":
        n = cfg.n_layers  # forward's routes, prefill's, then decode's
        fwd = [r.reshape(2, 25, -1)[:, -1] for r in routes[:n]]
        alike = torch.stack([(a == b).all(-1) for a, b in
                             zip(fwd, routes[2 * n:])]).all(0)
        assert 2 * int(alike.sum()) >= 2, routes
        d = (got - oracle)[alike].abs()
        assert float(torch.quantile(d.flatten(), 0.9)) < 0.06 * scale
        assert float(same.float().mean()) >= 0.5
    else:
        d = (got - oracle).abs()
        assert float(d.max()) < 0.05 * scale and bool(same.all())


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b",
                                  "whisper-base", "qwen3-moe-235b-a22b",
                                  "qwen2-vl-72b"])
def test_serve_batch_on_card_every_family(card, arch):
    """``serve_batch`` of every other family on the card at smoke size: B5
    once a step on each attention layer (none on mamba2), and the CPU
    run's schedule."""
    tda.reset_launches()
    res = serve_batch(arch, n_requests=4, max_batch=2, max_new=4,
                      max_len=32, device=card)
    assert (tda.launches["decode_attention"]
            == _attn_layers(get_smoke(arch)) * res["decode_steps"])
    cpu = serve_batch(arch, n_requests=4, max_batch=2, max_new=4,
                      max_len=32, device="cpu")
    assert res["decode_steps"] == cpu["decode_steps"]
    assert res["tokens"] == cpu["tokens"] == 16


def test_moe_ffn_repeats_bitwise_on_card(card):
    """The MoE combine adds each token's expert outputs in a fixed order:
    two runs on the card give the same bits (no atomics), and the routing
    equals the CPU's."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.param import Mk

    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"),
                              n_experts=64, top_k=8, d_model=256)
    p = moe.init_moe(Mk(torch.Generator().manual_seed(0), "cpu"), cfg)
    x = torch.randn((4, 300, 256), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    pc = {k: v.to(card) for k, v in p.items()}
    a, _ = moe.moe_ffn(pc, x.to(card), cfg)
    b, _ = moe.moe_ffn(pc, x.to(card), cfg)
    assert torch.equal(a, b)
    cap = moe.moe_capacity(1200, cfg)
    _, dc, _ = moe._route(x.reshape(1200, 256), p["router"], cfg, cap)
    _, dg, _ = moe._route(x.to(card).reshape(1200, 256), pc["router"], cfg,
                          cap)
    for u, w in zip(dc[:4], dg[:4]):
        assert torch.equal(u, w.cpu())


def test_flash_attention_on_card_matches_cpu(card):
    """The chunked attention on the card equals its CPU run within
    ``atol=rtol=2e-5`` (f32 tiles, ``tests/test_flash.py``'s bound), with a
    window and dead slots, and skips the same tiles."""
    from repro_torch.models.flash import TileTable, flash_attention

    g = torch.Generator().manual_seed(2)
    q = torch.randn((2, 1040, 8, 64), generator=g)
    k = torch.randn((2, 1040, 2, 64), generator=g)
    v = torch.randn((2, 1040, 2, 64), generator=g)
    pos = torch.arange(1040, dtype=torch.int32)[None].repeat(2, 1)
    pos[1, :7] = -1
    args = (300, True, 64**-0.5, 520, 520)
    want = flash_attention(q, k, v, pos, pos, *args)
    got = flash_attention(q.to(card), k.to(card), v.to(card), pos.to(card),
                          pos.to(card), *args)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)
    cpu = TileTable(pos, pos, 520, 520).live(300)
    dev = TileTable(pos.to(card), pos.to(card), 520, 520).live(300)
    assert (cpu == dev).all() and not cpu.all()


def test_flash_backward_on_card_matches_plain(card):
    """The chunked attention's backward on the card (bf16, gemma-2b's head
    layout at S=1,040 with a window and dead slots) against autograd
    through the dense masked softmax in f32 on the same bf16 values: each
    gradient within 0.02 x its largest entry (bf16 results)."""
    from repro_torch.models.flash import flash_attention
    from torch_flash_common import dense_plain

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g).to(card, torch.bfloat16)
               for shape in ((2, 1040, 8, 256), (2, 1040, 1, 256),
                             (2, 1040, 1, 256)))
    qpos = torch.arange(1040, dtype=torch.int32)[None].repeat(2, 1)
    kpos = qpos.clone()
    kpos[1, 500:507] = -1  # dead slots; every query keeps a live key
    qpos, kpos = qpos.to(card), kpos.to(card)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, qpos, kpos, 300, True, 256**-0.5, 520,
                          520)
    dout = torch.randn(out.shape, generator=g).to(card, torch.bfloat16)
    got = torch.autograd.grad(out, leaves, dout)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    o = dense_plain(*ref, qpos, kpos, 300, True, 256**-0.5)
    want = torch.autograd.grad(o, ref, dout.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).abs().max()) < 0.02 * float(
            b.abs().max())


def _rel_l2(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


# ``layers._LogitsF32``'s backward keeps the f32 logit gradient in f32
# against the bf16 operands (``layers._mm_f32``) and rounds only the two
# products to bf16, as the reference's gradient does: the f32 products agree
# with the upcast product's gradients up to f32 accumulation order.  They
# are held against the float64 product: cuBLAS's f32 one sums dx's 256,000
# terms with an error of its own, ~9e-6 relative L2 on an H100.
LOGIT_GRAD_BOUND = 1e-5
# A one-layer train step's leaves through ``_LogitsF32`` against the same
# step through the f32 upcast product: bf16 rounding downstream of the
# logit gradient turns f32 accumulation order into ~2**-9 a leaf.
ROUTE_COST_BOUND = 2.0**-7


def test_logits_f32_backward_on_card_matches_upcast(card):
    """``layers._LogitsF32``, the card's route of ``unembed``, at gemma-2b's
    tied unembedding (B=2 x S=1,024 rows of d=2,048 against the 256,000 x
    2,048 bf16 table), against autograd through the CPU route's f32 upcast
    product on the same values: the logits within 1e-5 relative L2 of the
    f32 product (f32 accumulation order only), the backward's f32 products
    for dx and the table's gradient within LOGIT_GRAD_BOUND relative L2 of
    the float64 product each, and the bf16 gradients autograd returns equal
    to those products rounded once."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import _mm_f32, unembed

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("gemma-2b")
    d, vocab = cfg.d_model, cfg.vocab_padded
    gen = torch.Generator(device=card).manual_seed(5)
    table = (torch.randn((vocab, d), generator=gen, device=card)
             * d**-0.5).bfloat16()
    x = torch.randn((2, 1024, d), generator=gen, device=card).bfloat16()
    dlogits = torch.randn((2, 1024, vocab), generator=gen, device=card)
    xp, tp = x.clone().requires_grad_(), table.clone().requires_grad_()
    got = unembed({"table": tp}, xp, cfg)
    dx, dt = torch.autograd.grad(got, (xp, tp), dlogits)
    assert got.dtype == torch.float32
    assert dx.dtype == dt.dtype == torch.bfloat16
    g2 = dlogits.reshape(-1, vocab)
    dx32 = _mm_f32(g2, table).reshape(dx.shape)
    dt32 = _mm_f32(x.reshape(-1, d).T, g2).T
    assert torch.equal(dx, dx32.bfloat16())
    assert torch.equal(dt, dt32.bfloat16())
    assert _rel_l2(got, x.float() @ table.float().T) < 1e-5
    g64 = g2.double()
    assert _rel_l2(dx32, (g64 @ table.double()).reshape(dx.shape)) \
        < LOGIT_GRAD_BOUND
    assert _rel_l2(dt32, (x.reshape(-1, d).double().T @ g64).T) \
        < LOGIT_GRAD_BOUND


def test_gemma_layer_train_step_on_card(card):
    """One train step of a one-layer gemma-2b at its published width on the
    card (S=1,024: the chunked attention's forward and backward), run
    twice from the same state: finite loss, parameters moved, and the two
    runs within 1e-6 of each other's loss and gradient norm (whether they
    are bit-equal is printed)."""
    import dataclasses

    from repro_torch.checkpoint.store import _flatten
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=1)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    gen = torch.Generator(device=card).manual_seed(1)
    batch = {key: torch.randint(0, cfg.vocab, (2, 1024), generator=gen,
                                device=card) for key in ("tokens", "labels")}
    step = make_train_step(model, TrainConfig())
    runs = [step(params, adamw_init(params), batch) for _ in range(2)]
    (p1, o1, m1), (p2, o2, m2) = runs
    assert torch.isfinite(m1["loss"]) and torch.isfinite(m1["grad_norm"])
    assert any(not torch.equal(a, b) for a, b in
               zip(_flatten(p1)[0], _flatten(params)[0]))
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m1[key], m2[key], atol=0, rtol=1e-6)
    same = all(torch.equal(a, b) for a, b in
               zip(_flatten((p1, o1.m))[0], _flatten((p2, o2.m))[0]))
    print(f"gemma-2b layer train step bit-equal across two runs: {same}")


def _leaf_names(tree, prefix: str = "") -> list:
    """The paths of ``tree``'s leaves, in ``_flatten``'s (sorted) order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in
                _leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def test_gemma_layer_train_step_on_card_matches_cpu(card, monkeypatch):
    """One train step of a one-layer gemma-2b at its published width (B=2,
    S=1,024) on the card against the port's CPU route from the same weights
    and optimiser state; the CPU route is held against the reference's
    step by ``tests/test_torch_train_step.py``.

    Bounds: that file's dense ones (loss within 1e-3 relative; grad_norm
    within 2e-2; every leaf of ``m`` within 0.02 relative L2) widened only
    by the measured cost of the card's unembedding route: the distance of
    the card's step from the card's step through the CPU route's f32
    upcast product (f32 accumulation order, carried through the layer's
    bf16 backward).  That cost is itself held within ROUTE_COST_BOUND a
    leaf (a wrong scale, transpose or a zeroed gradient moves a leaf by
    O(1)); both distances are printed a leaf."""
    import dataclasses

    from repro_torch.checkpoint.store import _flatten, _unflatten
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import layers
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=1)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {key: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1024)))
             for key in ("tokens", "labels")}

    def step(device):
        flat, _ = _flatten(params)
        tree = _unflatten(params, [p.to(device) for p in flat])
        on = {k: v.to(device) for k, v in batch.items()}
        return make_train_step(build_model(cfg, device), TrainConfig())(
            tree, adamw_init(tree), on)

    cpu = step("cpu")
    card_run = step(card)
    monkeypatch.setattr(layers._LogitsF32, "apply",
                        staticmethod(lambda x2, w: x2.float() @ w.float()))
    upcast = step(card)
    for key, rtol in (("loss", 1e-3), ("ce", 1e-3)):
        assert abs(float(card_run[2][key]) - float(cpu[2][key])) <= \
            rtol * abs(float(cpu[2][key])), key
    gn_cost = abs(float(card_run[2]["grad_norm"])
                  - float(upcast[2]["grad_norm"]))
    print("loss card / CPU:", float(card_run[2]["loss"]),
          float(cpu[2]["loss"]), "grad_norm card / upcast / CPU:",
          *(float(r[2]["grad_norm"]) for r in (card_run, upcast, cpu)))
    assert abs(float(card_run[2]["grad_norm"]) - float(cpu[2]["grad_norm"])) \
        <= 2e-2 * abs(float(cpu[2]["grad_norm"])) + gn_cost
    names = _leaf_names(params)
    rows = [(name, _rel_l2(got, plain), _rel_l2(got.cpu(), want),
             _rel_l2(plain.cpu(), want))
            for name, got, want, plain in zip(names,
                                              _flatten(card_run[1].m)[0],
                                              _flatten(cpu[1].m)[0],
                                              _flatten(upcast[1].m)[0])]
    for name, cost, dist, plain_dist in rows:
        print(f"m{name}: the card route's cost {cost:.4g}, card to CPU "
              f"{dist:.4g} (through the upcast product {plain_dist:.4g})")
    for name, cost, dist, _ in rows:
        assert cost < ROUTE_COST_BOUND, name
        assert dist < 0.02 + cost, name
