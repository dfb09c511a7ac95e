"""The row payload of the port's tile views and the plain version of the
kernels B1/B3 that read it (``blocked_spmv_plain_rows``).

A tile view carries, beside its dense tiles, every non-absent slot as a
CSR by destination row (``row_ptr``, ``ent_tile``, ``ent_src``,
``ent_w``) cut into segments of at most ``SEG_ENTRIES`` entries
(``seg_ptr``, ``row_seg``).  Held here on the CPU: the payload scattered
back gives the tiles exactly; its order and segment table; a reference
view carried across gets the same payload as the port's own build; the
rows arithmetic against the reference's interpret-mode Pallas kernel and
the dense plain version (plus_times within ``atol=1e-6, rtol=1e-5``, as
the sums run in another order; min_plus bit for bit); and the one place
where the two forms used to differ, an ``x`` holding inf (ROADMAP §C
P12, repaired: both now equal the reference).  The CUDA kernels
themselves are held against this plain version in
``tests/test_torch_cuda.py``, which needs a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.generators import rmat as r_rmat
from repro.kernels import spmv as rk

from repro_torch import convert
from repro_torch.graph import csr as tcsr
from repro_torch.graph.generators import rmat, star_graph
from repro_torch.graph.session import Graph
from repro_torch.kernels import spmv as tk

F32_TOL = dict(atol=1e-6, rtol=1e-5)
SIZES = [(32, 16), (128, 128), (48, 32)]
PAYLOAD = ("row_ptr", "ent_tile", "ent_src", "ent_w", "seg_ptr", "row_seg",
           "tile_ptr", "tent_row", "tent_src", "tent_w")


def _absent(semiring):
    return np.inf if semiring == "min_plus" else 0.0


def _scatter_back(bg) -> np.ndarray:
    """The payload written into a tile array filled with the absent value,
    in numpy."""
    tiles = np.full(tuple(bg.tiles.shape), _absent(bg.semiring), np.float32)
    row_ptr = bg.row_ptr.numpy().astype(np.int64)
    rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    t = bg.ent_tile.numpy().astype(np.int64)
    src = bg.ent_src.numpy().astype(np.int64)
    dbid, sbid = bg.dbid.numpy(), bg.sbid.numpy()
    tiles[t, rows - dbid[t] * bg.bd, src - sbid[t] * bg.bs] = bg.ent_w.numpy()
    return tiles


@pytest.mark.parametrize("bd,bs", SIZES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("order", ["dest", "morton", "hilbert"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "bool"])
def test_payload_rebuilds_tiles(semiring, order, reverse, bd, bs):
    g = rmat(9, edge_factor=8, seed=3, symmetrize=semiring == "min_plus")
    bg = tk.build_blocked(g, bd=bd, bs=bs, semiring=semiring, reverse=reverse,
                          tile_order=order, device="cpu")
    assert torch.equal(torch.as_tensor(_scatter_back(bg)), bg.tiles)
    # every entry is a real edge slot: as many as the tiles' occupied slots
    assert bg.ent_w.numel() == int((bg.tiles != _absent(semiring)).sum())


@pytest.mark.parametrize("bd,bs", SIZES)
@pytest.mark.parametrize("order", ["dest", "morton", "hilbert"])
def test_payload_order_and_segments(order, bd, bs):
    """Rows hold entries in ascending schedule position, then column;
    ``row_ptr`` is monotone; the segments cover each row exactly once, in
    order, with at most ``SEG_ENTRIES`` entries each."""
    g = rmat(10, edge_factor=16, seed=1)
    bg = tk.build_blocked(g, bd=bd, bs=bs, tile_order=order, device="cpu")
    row_ptr = bg.row_ptr.numpy().astype(np.int64)
    n_rows, n_ent = bg.n_dst_blocks * bd, bg.ent_tile.numel()
    assert len(row_ptr) == n_rows + 1
    assert row_ptr[0] == 0 and row_ptr[-1] == n_ent
    assert (np.diff(row_ptr) >= 0).all()
    rows = np.repeat(np.arange(n_rows), np.diff(row_ptr))
    t = bg.ent_tile.numpy().astype(np.int64)
    col = bg.ent_src.numpy() - bg.sbid.numpy()[t] * bs
    assert (bg.dbid.numpy()[t] == rows // bd).all()
    assert ((col >= 0) & (col < bs)).all()
    key = (rows * bg.num_tiles + t) * bs + col  # (row, tile, col), unique
    assert (np.diff(key) > 0).all()

    seg_ptr = bg.seg_ptr.numpy().astype(np.int64)
    row_seg = bg.row_seg.numpy().astype(np.int64)
    assert seg_ptr[0] == 0 and seg_ptr[-1] == n_ent
    assert row_seg[0] == 0 and row_seg[-1] == len(seg_ptr) - 1
    for r in range(n_rows):
        s0, s1 = row_seg[r], row_seg[r + 1]
        count = row_ptr[r + 1] - row_ptr[r]
        assert s1 - s0 == -(-count // tk.SEG_ENTRIES)
        if count:
            assert seg_ptr[s0] == row_ptr[r] and seg_ptr[s1] == row_ptr[r + 1]
            lens = np.diff(seg_ptr[s0:s1 + 1])
            assert ((lens > 0) & (lens <= tk.SEG_ENTRIES)).all()


@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "bool"])
def test_convert_payload_matches_build(semiring, order):
    """A reference tile view carried across gets the payload of the port's
    own build: both read it from the same tiles."""
    kw = dict(bd=32, bs=16, semiring=semiring, tile_order=order,
              reverse=order == "hilbert")
    got = convert.blocked_view(rk.build_blocked(r_rmat(8, edge_factor=8,
                                                       seed=2), **kw),
                               device="cpu")
    own = tk.build_blocked(rmat(8, edge_factor=8, seed=2), device="cpu", **kw)
    for name in PAYLOAD:
        assert torch.equal(getattr(got, name), getattr(own, name)), name


def _x_blocks(bg, x: np.ndarray) -> torch.Tensor:
    """``x`` [n, K] padded with the identity to the view's source blocks,
    as ``ops.blocked_spmv`` pads it."""
    k = x.shape[1]
    xp = np.full((bg.n_src_blocks * bg.bs, k), _absent(bg.semiring),
                 np.float32)
    xp[: bg.n] = x
    return torch.as_tensor(xp).view(bg.n_src_blocks, bg.bs, k)


def _rows_and_dense(tbg, x, act_np, active_on):
    act = tk.tile_activity(tbg, torch.as_tensor(act_np), active_on)
    xb = _x_blocks(tbg, x)
    k = x.shape[1]
    rows = tk.blocked_spmv_plain_rows(tbg, act, xb).reshape(-1, k)[: tbg.n]
    dense = tk.blocked_spmv_plain(tbg, act, xb).reshape(-1, k)[: tbg.n]
    return rows, dense


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("active_on", ["src", "dst"])
@pytest.mark.parametrize("order", ["dest", "hilbert"])
def test_rows_plain_matches_pallas(k, active_on, order):
    """The rows arithmetic against the reference's blocked path (Pallas in
    interpret mode) and the dense plain version.  A row with no live entry
    gets the identity, so blocks without a tile need no fill."""
    kw = dict(bd=32, bs=16, tile_order=order)
    g = rmat(8, edge_factor=8, seed=2)
    rbg = rk.build_blocked(r_rmat(8, edge_factor=8, seed=2), **kw)
    tbg = tk.build_blocked(g, device="cpu", **kw)
    rng = np.random.default_rng(k + 3)
    x = rng.normal(size=(g.n, k)).astype(np.float32)
    act = rng.random(g.n) < 0.15
    want, _ = rk.blocked_spmv(rbg, jnp.asarray(x), jnp.asarray(act),
                              active_on=active_on, interpret=True)
    rows, dense = _rows_and_dense(tbg, x, act, active_on)
    np.testing.assert_allclose(rows.numpy(), np.asarray(want).reshape(g.n, k),
                               **F32_TOL)
    torch.testing.assert_close(rows, dense, **F32_TOL)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("order", ["dest", "morton"])
def test_rows_plain_min_plus_matches_pallas(k, order):
    """min_plus: bit for bit against the reference and the dense plain
    version (min is order-free, each w + x rounds once); labels hold
    +inf (unreached)."""
    kw = dict(bd=48, bs=32, tile_order=order, semiring="min_plus")
    g = rmat(9, edge_factor=8, seed=4, symmetrize=True)
    rbg = rk.build_blocked(r_rmat(9, edge_factor=8, seed=4, symmetrize=True),
                           **kw)
    tbg = tk.build_blocked(g, device="cpu", **kw)
    rng = np.random.default_rng(k)
    x = rng.integers(0, g.n, (g.n, k)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.inf
    act = rng.random(g.n) < 0.3
    want, _ = rk.blocked_spmv(rbg, jnp.asarray(x), jnp.asarray(act),
                              interpret=True)
    rows, dense = _rows_and_dense(tbg, x, act, "src")
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(want).reshape(g.n, k))
    assert torch.equal(rows, dense)


def test_inf_in_x_gives_nan_only_in_the_dense_form():
    """ROADMAP §C P12, now closed.  On an x holding inf the reference's
    dense product gives NaN (0 * inf on absent slots) in every row of a
    live tile that reads it.  The payload skips absent slots, and used to
    give inf only in the rows with an edge from that source; it now puts
    NaN where the dense form has it, so both plain versions equal the
    reference's interpret-mode Pallas kernel, NaN for NaN and inf for
    inf."""
    kw = dict(bd=32, bs=16)
    g = rmat(8, edge_factor=8, seed=2)
    rbg = rk.build_blocked(r_rmat(8, edge_factor=8, seed=2), **kw)
    bg = tk.build_blocked(g, device="cpu", **kw)
    x = np.random.default_rng(0).random((g.n, 1)).astype(np.float32)
    hub = int(np.argmax(np.diff(g.indptr)))
    x[hub] = np.inf
    want, _ = rk.blocked_spmv(rbg, jnp.asarray(x), interpret=True)
    want = np.asarray(want).reshape(g.n, 1)
    assert np.isnan(want).any() and np.isinf(want).any()
    rows, dense = _rows_and_dense(bg, x, np.ones(g.n, bool), "src")
    for got in (rows, dense):
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # the hub's targets outside the poisoned rows see +inf
    targets = np.zeros(g.n, bool)
    targets[g.indices[g.indptr[hub]:g.indptr[hub + 1]]] = True
    assert np.array_equal(np.isinf(want[:, 0]),
                          targets & ~np.isnan(want[:, 0]))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_star_hub_row_is_split(semiring):
    """A hub with 20,000 in-edges fills one row with 20,000 entries: it is
    cut into ceil(20,000 / SEG_ENTRIES) segments, and the rows arithmetic
    still gives the edge list's answer."""
    n = 20_001
    g = star_graph(n)
    bg = tk.build_blocked(g, semiring=semiring, device="cpu")
    row_ptr, row_seg = bg.row_ptr.long(), bg.row_seg.long()
    assert int(row_ptr[1] - row_ptr[0]) == n - 1
    assert int(row_seg[1] - row_seg[0]) == -(-(n - 1) // tk.SEG_ENTRIES) > 1
    x = np.random.default_rng(1).random((n, 1)).astype(np.float32)
    rows, dense = _rows_and_dense(bg, x, np.ones(n, bool), "src")
    if semiring == "min_plus":  # unweighted: w = 0
        assert torch.equal(rows, dense)
        assert float(rows[0, 0]) == x[1:].min()
        assert torch.equal(rows[1:, 0], torch.full((n - 1,), float(x[0, 0])))
    else:
        torch.testing.assert_close(rows, dense, **F32_TOL)
        np.testing.assert_allclose(float(rows[0, 0]),
                                   x[1:].astype(np.float64).sum(), rtol=1e-5)
        assert torch.equal(rows[1:, 0], torch.full((n - 1,), float(x[0, 0])))


def test_edgeless_view_has_an_empty_payload():
    g = tcsr.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), n=40)
    bg = tk.build_blocked(g, bd=32, bs=16, device="cpu")
    assert bg.ent_tile.numel() == 0 and bg.seg_ptr.tolist() == [0]
    assert bg.row_ptr.numel() == bg.n_dst_blocks * 32 + 1
    act = torch.ones(bg.num_tiles, dtype=torch.int32)
    y = tk.blocked_spmv_plain_rows(bg, act, torch.ones(bg.n_src_blocks, 16, 2))
    assert torch.equal(y, torch.zeros(bg.n_dst_blocks, 32, 2))


def test_memory_report_counts_the_payload():
    """The report counts a tile view as the reference does, its tiles and
    schedule; the payloads the card kernels read are the view's
    ``payload_nbytes`` (ROADMAP §C P14)."""
    G = Graph(rmat(8, edge_factor=8, seed=2), device="cpu", bd=32, bs=16)
    bg = G.device(blocked=True).out_blocked
    tiles = G.memory_report()["device_views"]["tiles:plus_times:fwd:dest"]
    payload = sum(getattr(bg, name).nbytes for name in PAYLOAD)
    schedule = sum(getattr(bg, name).nbytes for name in
                   ("dbid", "sbid", "first", "last", "accum", "nnz"))
    assert payload > 0
    assert bg.payload_nbytes == payload
    assert tiles == bg.tiles.nbytes + schedule
