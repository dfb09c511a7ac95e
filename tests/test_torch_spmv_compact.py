"""The tile-major payload of the port's tile views and the plain version of
the compacted-work-list kernels B2/B4 that read it
(``blocked_spmv_plain_compact_rows``).

A tile view carries, beside its dense tiles and its row payload, every
non-absent slot tile by tile in schedule order (``tile_ptr``,
``tent_row``, ``tent_src``, ``tent_w``); a host tile store carries the
same arrays in numpy, and a host batch stages their slice.  Held here on
the CPU, with inputs made by numpy from a seed: the payload scattered back
gives the tiles exactly, tile by tile in row-major order; a reference view
carried across gets the same payload; the payload arithmetic against the
reference's interpret-mode ``spmv_pallas_compact`` (plus_times within
``atol=1e-6, rtol=1e-5``: the sums run in another order; 'bool' and
min_plus exactly) and against the dense plain version; a hub block spread
over many windows of live tiles; an edgeless view and an empty live set;
a host batch's staged payload; and, for B1-B4, an ``x`` holding +inf, -inf
or NaN (ROADMAP §C P12).  The CUDA kernels themselves are held against
this plain version in ``tests/test_torch_cuda.py``, which needs a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.generators import rmat as r_rmat
from repro.kernels import spmv as rk
from repro.kernels.spmv import kernel as rpk

from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import residency as tres
from repro_torch.core import semiring as tsr
from repro_torch.graph import csr as tcsr
from repro_torch.graph.generators import rmat, star_graph
from repro_torch.kernels import spmv as tk

F32_TOL = dict(atol=1e-6, rtol=1e-5)
TILE_PAYLOAD = ("tile_ptr", "tent_row", "tent_src", "tent_w")
WINDOW = 32  # live tiles a window of the card's B2/B4


def _absent(semiring):
    return np.inf if semiring == "min_plus" else 0.0


def _tile_ids(bg) -> np.ndarray:
    tp = bg.tile_ptr.numpy().astype(np.int64)
    return np.repeat(np.arange(len(tp) - 1), np.diff(tp))


@pytest.mark.parametrize("bd,bs", [(32, 16), (128, 128)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("order", ["dest", "morton", "hilbert"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "bool"])
def test_tile_payload_rebuilds_tiles(semiring, order, reverse, bd, bs):
    """Scattered back, the tile-major payload gives the dense tiles; each
    tile's entries run in row-major order; ``tile_ptr`` counts each tile's
    non-absent slots; the host store's numpy payload is the same."""
    g = rmat(9, edge_factor=8, seed=3, symmetrize=semiring == "min_plus")
    kw = dict(bd=bd, bs=bs, semiring=semiring, reverse=reverse,
              tile_order=order)
    bg = tk.build_blocked(g, device="cpu", **kw)
    tp = bg.tile_ptr.numpy().astype(np.int64)
    assert len(tp) == bg.num_tiles + 1 and tp[0] == 0
    assert tp[-1] == bg.tent_w.numel() == bg.ent_w.numel()
    present = (bg.tiles != _absent(semiring)).reshape(bg.num_tiles, -1)
    assert np.array_equal(np.diff(tp), present.sum(1).numpy())
    t = _tile_ids(bg)
    row = bg.tent_row.numpy().astype(np.int64)
    col = bg.tent_src.numpy() - bg.sbid.numpy()[t].astype(np.int64) * bs
    assert ((row >= 0) & (row < bd) & (col >= 0) & (col < bs)).all()
    key = (t * bd + row) * bs + col  # (tile, row, column), unique
    assert (np.diff(key) > 0).all()
    tiles = np.full(tuple(bg.tiles.shape), _absent(semiring), np.float32)
    tiles[t, row, col] = bg.tent_w.numpy()
    assert torch.equal(torch.as_tensor(tiles), bg.tiles)
    host = tk.build_payload_arrays(g, **kw)
    for name in TILE_PAYLOAD:
        assert np.array_equal(host[name], getattr(bg, name).numpy()), name
    for name in ("dbid", "sbid", "first", "last", "accum", "nnz"):
        assert np.array_equal(host[name], getattr(bg, name).numpy()), name


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("order", ["dest", "morton", "hilbert"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_convert_tile_payload_matches_build(semiring, order, reverse):
    """A reference tile view carried across by ``convert`` gets the
    tile-major payload of the port's own build."""
    kw = dict(bd=32, bs=16, semiring=semiring, tile_order=order,
              reverse=reverse)
    got = convert.blocked_view(
        rk.build_blocked(r_rmat(8, edge_factor=8, seed=2), **kw),
        device="cpu")
    own = tk.build_blocked(rmat(8, edge_factor=8, seed=2), device="cpu", **kw)
    for name in TILE_PAYLOAD:
        assert torch.equal(getattr(got, name), getattr(own, name)), name


def _x_blocks(bg, x: np.ndarray) -> np.ndarray:
    """``x`` [n, K] padded with the identity to the view's source blocks,
    as ``ops.blocked_spmv`` pads it."""
    k = x.shape[1]
    xp = np.full((bg.n_src_blocks * bg.bs, k), _absent(bg.semiring),
                 np.float32)
    xp[: bg.n] = x
    return xp.reshape(bg.n_src_blocks, bg.bs, k)


def _x(n, k, semiring, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if semiring == "min_plus":  # labels, a fifth unreached
        x = rng.integers(0, n, (n, k)).astype(np.float32)
        x[rng.random(x.shape) < 0.2] = np.inf
    elif semiring == "bool":
        x = (rng.random((n, k)) < 0.5).astype(np.float32)
    else:
        x = rng.normal(size=(n, k)).astype(np.float32)
    return x


def _pair(semiring, order, seed=2, reverse=False, bd=32, bs=16):
    kw = dict(bd=bd, bs=bs, semiring=semiring, tile_order=order,
              reverse=reverse)
    sym = semiring == "min_plus"
    return (rk.build_blocked(r_rmat(8, edge_factor=8, seed=seed,
                                    symmetrize=sym), **kw),
            tk.build_blocked(rmat(8, edge_factor=8, seed=seed,
                                  symmetrize=sym), device="cpu", **kw))


def _flushed(rbg, r_act) -> np.ndarray:
    """The blocks the compacted kernels flush: those with a live tile."""
    out = np.zeros(rbg.n_dst_blocks, bool)
    out[np.asarray(rbg.dbid)[np.asarray(r_act) > 0]] = True
    return out


def _assert_same(got, want, semiring):
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.5, 0.05])
@pytest.mark.parametrize("order", ["dest", "morton", "hilbert"])
@pytest.mark.parametrize("active_on", ["src", "dst"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("semiring", ["plus_times", "bool", "min_plus"])
def test_compact_rows_plain_matches_pallas(semiring, k, active_on, order,
                                           density):
    """The tile-major arithmetic against the reference's
    ``spmv_pallas_compact`` in interpret mode, over the same work-list, on
    the blocks the kernel flushes; the other blocks hold the identity."""
    rbg, tbg = _pair(semiring, order)
    x_blocks = _x_blocks(tbg, _x(tbg.n, k, semiring, seed=k))
    act = np.random.default_rng(k + 7).random(tbg.n) < density
    r_act = rk.tile_activity(rbg, jnp.asarray(act), active_on)
    t_act = tk.tile_activity(tbg, torch.as_tensor(act), active_on)
    perm, dbid, sbid, first, last, accum, nact = rk.compact_tile_order(
        rbg, r_act)
    want = np.asarray(rpk.spmv_pallas_compact(
        rbg.tiles, perm, dbid, sbid, first, last, accum,
        jnp.asarray([nact], jnp.int32), jnp.asarray(x_blocks),
        rbg.n_dst_blocks, semiring=semiring, interpret=True))
    args = tk.compact_tile_order(tbg, t_act)
    got = tk.blocked_spmv_plain_compact_rows(tbg, *args,
                                             torch.as_tensor(x_blocks))
    flushed = _flushed(rbg, r_act)
    assert flushed.any()
    _assert_same(got.numpy()[flushed], want[flushed], semiring)
    assert (got.numpy()[~flushed] == _absent(semiring)).all()


@pytest.mark.parametrize("order", ["dest", "morton", "hilbert"])
@pytest.mark.parametrize("semiring", ["plus_times", "bool", "min_plus"])
def test_compact_rows_plain_matches_dense(semiring, order):
    """The tile-major arithmetic equals the dense plain compact version
    (the per-run sums of the tile products): plus_times within f32
    rounding, 'bool' and min_plus exactly."""
    _, tbg = _pair(semiring, order, seed=5, reverse=True)
    x = torch.as_tensor(_x_blocks(tbg, _x(tbg.n, 2, semiring, seed=3)))
    act = tk.tile_activity(tbg, torch.as_tensor(
        np.random.default_rng(4).random(tbg.n) < 0.3))
    args = tk.compact_tile_order(tbg, act)
    got = tk.blocked_spmv_plain_compact_rows(tbg, *args, x)
    want = tk.blocked_spmv_plain_compact(tbg, *args, x)
    _assert_same(got.numpy(), want.numpy(), semiring)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_star_hub_block_spans_windows(semiring):
    """A hub with 20,000 in-edges puts 157 live tiles in one destination
    block: more than four windows of the card's kernel.  The tile-major
    arithmetic still gives the edge list's answer."""
    n = 20_001
    bg = tk.build_blocked(star_graph(n), semiring=semiring, device="cpu")
    act = torch.ones(bg.num_tiles, dtype=torch.int32)
    args = tk.compact_tile_order(bg, act)
    assert int((args[1][: args[6]] == 0).sum()) > 4 * WINDOW
    x = np.random.default_rng(1).random((n, 1)).astype(np.float32)
    xb = torch.as_tensor(_x_blocks(bg, x))
    y = tk.blocked_spmv_plain_compact_rows(bg, *args, xb).reshape(-1, 1)[:n]
    if semiring == "min_plus":  # unweighted: w = 0
        assert float(y[0, 0]) == x[1:].min()
    else:
        np.testing.assert_allclose(float(y[0, 0]),
                                   x[1:].astype(np.float64).sum(), rtol=1e-5)
    assert torch.equal(y[1:, 0], torch.full((n - 1,), float(x[0, 0])))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_edgeless_view_and_empty_live_set(semiring):
    """No entry and no live tile: every row gets the identity."""
    g = tcsr.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), n=40)
    bg = tk.build_blocked(g, bd=32, bs=16, semiring=semiring, device="cpu")
    assert bg.tent_w.numel() == 0 and bg.tile_ptr.tolist() == [0, 0]
    x = torch.ones(bg.n_src_blocks, 16, 2)
    ident = torch.full((bg.n_dst_blocks, 32, 2), _absent(semiring))
    act = torch.ones(bg.num_tiles, dtype=torch.int32)
    args = tk.compact_tile_order(bg, act)
    assert torch.equal(tk.blocked_spmv_plain_compact_rows(bg, *args, x),
                       ident)
    _, tbg = _pair(semiring, "hilbert")
    x = torch.ones(tbg.n_src_blocks, 16, 2)
    args = tk.compact_tile_order(tbg, torch.zeros(tbg.num_tiles,
                                                  dtype=torch.int32))
    assert args[6] == 0
    got = tk.blocked_spmv_plain_compact_rows(tbg, *args, x)
    assert torch.equal(got, torch.full_like(got, _absent(semiring)))


@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_host_batch_payload_is_the_view_slice(monkeypatch, semiring, order):
    """Each host tile batch stages the tile-major payload of its live
    positions, grouped by destination block: local ``tile_ptr``, and rows,
    x rows and weights equal to the device view's payload sliced at the
    same positions."""
    g = rmat(8, edge_factor=8, seed=2, symmetrize=True)
    hg = tres.host_graph(g, bd=32, bs=16, device="cpu")
    enc = "min_plus" if semiring == "min_plus" else "plus_times"
    bg = tk.build_blocked(g, bd=32, bs=16, semiring=enc, tile_order=order,
                          device="cpu")
    batches, views = [], []
    tile_batches = tres._tile_batches

    def record_batches(*a, **kw):
        out = tile_batches(*a, **kw)
        batches.extend(out[0])
        return out

    spmv = tk.spmv_blocked_compact

    def record_views(view, *a):
        views.append(view)
        return spmv(view, *a)

    monkeypatch.setattr(tres, "_tile_batches", record_batches)
    monkeypatch.setattr(tk, "spmv_blocked_compact", record_views)
    sr = tsr.MIN_PLUS if semiring == "min_plus" else tsr.PLUS_TIMES
    x = torch.as_tensor(np.random.default_rng(0).random(g.n),
                        dtype=torch.float32)
    act = torch.as_tensor(np.random.default_rng(1).random(g.n) < 0.4)
    tres.host_traverse(hg, x, act, sr, policy=teng.ExecutionPolicy(
        backend="blocked_compact", residency="host", stream_buffer=3,
        tile_order=order, switch_fraction=None))
    assert len(views) == len(batches) > 1
    tp = bg.tile_ptr.long()
    dbid = bg.dbid.numpy()
    for view, (pos, _) in zip(views, batches):
        # staged grouped by destination block, each block's runs in order
        pos = torch.as_tensor(pos[np.argsort(dbid[pos], kind="stable")])
        cnt = tp[pos + 1] - tp[pos]
        assert torch.equal(view.tile_ptr.long()[1:], torch.cumsum(cnt, 0))
        e = torch.cat([torch.arange(int(tp[p]), int(tp[p + 1])) for p in pos])
        for name in ("tent_row", "tent_src", "tent_w"):
            assert torch.equal(getattr(view, name), getattr(bg, name)[e])
        assert torch.equal(view.sbid[: pos.numel()], bg.sbid[pos])


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("poison", ["inf", "-inf", "nan"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_non_finite_x_matches_pallas(semiring, poison, compact):
    """ROADMAP §C P12: on an x holding +inf, -inf or NaN, the plain
    versions of B1-B4 (the row or tile-major payload, and the dense tiles)
    equal the reference's interpret-mode Pallas kernel, NaN where its
    dense product has NaN (0 * inf, +inf + -inf) and the same infinities
    elsewhere: plus_times within f32 rounding, min_plus exactly."""
    rbg, tbg = _pair(semiring, "hilbert", seed=4)
    x = _x(tbg.n, 2, semiring, seed=5)
    rng = np.random.default_rng(6)
    x[rng.random(x.shape) < 0.02] = float(poison)
    x_blocks = _x_blocks(tbg, x)
    act = rng.random(tbg.n) < 0.6
    r_act = rk.tile_activity(rbg, jnp.asarray(act))
    t_act = tk.tile_activity(tbg, torch.as_tensor(act))
    xb = torch.as_tensor(x_blocks)
    if compact:
        perm, dbid, sbid, first, last, accum, nact = rk.compact_tile_order(
            rbg, r_act)
        want = rpk.spmv_pallas_compact(
            rbg.tiles, perm, dbid, sbid, first, last, accum,
            jnp.asarray([nact], jnp.int32), jnp.asarray(x_blocks),
            rbg.n_dst_blocks, semiring=semiring, interpret=True)
        args = tk.compact_tile_order(tbg, t_act)
        got = (tk.blocked_spmv_plain_compact_rows(tbg, *args, xb),
               tk.spmv_blocked_compact(tbg, *args, xb))
        flushed = _flushed(rbg, r_act)
    else:
        want = rpk.spmv_pallas(
            rbg.tiles, rbg.dbid, rbg.sbid, rbg.first, rbg.last, rbg.accum,
            r_act, jnp.asarray(x_blocks), rbg.n_dst_blocks,
            semiring=semiring, interpret=True)
        got = (tk.blocked_spmv_plain_rows(tbg, t_act, xb),
               tk.spmv_blocked(tbg, t_act, xb))
        flushed = np.zeros(rbg.n_dst_blocks, bool)
        flushed[np.asarray(rbg.dbid)] = True
    want = np.asarray(want)[flushed]
    if poison != "inf" or semiring == "plus_times":
        assert np.isnan(want).any()
    for y in got:
        _assert_same(y.numpy()[flushed], want, semiring)
