"""The port's blocked SpMV (kernels B1-B4 and their plain versions) against
the reference's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.  The
schedule helpers (``compact_tile_order``, ``tile_activity``,
``x_fetch_count``) must agree exactly; plus_times products agree within
f32 rounding (``atol=rtol=1e-5``: the tile products sum in another order),
min_plus products (B3/B4) bit for bit; the tile counters exactly.  On the
CPU the wrappers run the plain torch versions; the CUDA kernels themselves
are held against those in ``tests/test_torch_cuda.py``, which needs a
card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.generators import erdos_renyi, rmat
from repro.kernels import spmv as rk
from repro.kernels.spmv import kernel as rpk

from repro_torch.kernels import spmv as tk

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _views(order="dest", semiring="plus_times", seed=2):
    g = rmat(8, edge_factor=8, seed=seed)
    kw = dict(bd=32, bs=32, semiring=semiring, tile_order=order)
    return (g, rk.build_blocked(g, **kw),
            tk.build_blocked(g, device="cpu", **kw))


def _frontier(n, density, seed):
    return np.random.default_rng(seed).random(n) < density


@pytest.mark.parametrize("order", ["dest", "morton", "hilbert"])
@pytest.mark.parametrize("density", [1.0, 0.3, 0.02, 0.0])
def test_compact_tile_order_identical(order, density):
    g, rbg, tbg = _views(order)
    act = _frontier(g.n, density, seed=3)
    r_act = rk.tile_activity(rbg, jnp.asarray(act))
    t_act = tk.tile_activity(tbg, torch.as_tensor(act))
    assert np.array_equal(np.asarray(r_act), t_act.numpy())
    ref = rk.compact_tile_order(rbg, r_act)
    got = tk.compact_tile_order(tbg, t_act)
    for name, a, b in zip(("perm", "dbid", "sbid", "first", "last", "accum"),
                          ref[:6], got[:6]):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert int(ref[6]) == got[6]
    assert int(rk.x_fetch_count(rbg.sbid, r_act)) == int(
        tk.x_fetch_count(tbg.sbid, t_act))


@pytest.mark.parametrize("active_on", ["src", "dst"])
def test_tile_activity_identical(active_on):
    g, rbg, tbg = _views("hilbert")
    act = _frontier(g.n, 0.05, seed=4)
    assert np.array_equal(
        np.asarray(rk.tile_activity(rbg, jnp.asarray(act), active_on)),
        tk.tile_activity(tbg, torch.as_tensor(act), active_on).numpy())


def test_compact_grid_size_identical():
    for T in (1, 7, 64, 1000):
        for a in (0, 1, 5, 64, 999):
            assert tk.compact_grid_size(T, a) == rk.compact_grid_size(T, a)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("active_on", ["src", "dst"])
def test_blocked_spmv_matches_pallas(compact, k, order, active_on):
    g, rbg, tbg = _views(order)
    rng = np.random.default_rng(k + 10 * compact)
    x = rng.normal(size=(g.n, k) if k > 1 else (g.n,)).astype(np.float32)
    act = _frontier(g.n, 0.15, seed=k)
    y_r, st_r = rk.blocked_spmv(rbg, jnp.asarray(x), jnp.asarray(act),
                                active_on=active_on, interpret=True,
                                compact=compact)
    y_t, st_t = tk.blocked_spmv(tbg, torch.as_tensor(x), torch.as_tensor(act),
                                active_on=active_on, compact=compact)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), **F32_TOL)
    for key in st_r:
        assert int(st_r[key]) == int(st_t[key]), key


def test_blocked_spmv_min_plus_matches_pallas():
    g, rbg, tbg = _views("morton", semiring="min_plus")
    x = np.random.default_rng(0).random(g.n).astype(np.float32)
    act = _frontier(g.n, 0.3, seed=1)
    y_r, _ = rk.blocked_spmv(rbg, jnp.asarray(x), jnp.asarray(act),
                             interpret=True)
    for compact in (False, True):
        y_t, _ = tk.blocked_spmv(tbg, torch.as_tensor(x), torch.as_tensor(act),
                                 compact=compact)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_r))


@pytest.mark.parametrize("order", ["dest", "hilbert"])
def test_full_and_compact_plain_bitwise(order):
    """Both plain versions keep the per-run summation structure, so the
    compacted work-list gives the full schedule's values bit for bit."""
    g, _, tbg = _views(order, seed=5)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(g.n, 3)),
                        dtype=torch.float32)
    act = torch.as_tensor(_frontier(g.n, 0.2, seed=6))
    y_full, _ = tk.blocked_spmv(tbg, x, act)
    y_comp, _ = tk.blocked_spmv(tbg, x, act, compact=True)
    assert torch.equal(y_full, y_comp)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_ref_twin_matches_reference_oracle(semiring):
    g, rbg, tbg = _views("hilbert", semiring=semiring)
    x = np.random.default_rng(4).random((g.n, 2)).astype(np.float32)
    act = _frontier(g.n, 0.4, seed=2)
    want = rk.blocked_spmv_ref(rbg, jnp.asarray(x), jnp.asarray(act))
    got = tk.blocked_spmv_ref(tbg, torch.as_tensor(x), torch.as_tensor(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_cpu_wrappers_launch_nothing():
    """On a CPU tensor the wrappers run the plain versions and count no
    kernel launch, on plus_times and min_plus tiles alike."""
    tk.reset_launches()
    for semiring in ("plus_times", "min_plus"):
        g, _, tbg = _views(semiring=semiring)
        x = torch.ones(g.n)
        tk.blocked_spmv(tbg, x)
        tk.blocked_spmv(tbg, x, compact=True)
    assert tk.launches == {"spmv_blocked": 0, "spmv_blocked_compact": 0,
                           "spmv_blocked_min_plus": 0,
                           "spmv_blocked_compact_min_plus": 0}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("order", ["dest", "hilbert"])
@pytest.mark.parametrize("density", [1.0, 0.15])
def test_min_plus_wrappers_match_pallas(compact, k, order, density):
    """B3/B4's wrappers (their plain versions on the CPU) against the
    reference's min_plus Pallas bodies in interpret mode: bit for bit, as
    min is order-free and each w + x rounds once."""
    g, rbg, tbg = _views(order, semiring="min_plus", seed=4)
    rng = np.random.default_rng(k)
    x = rng.integers(0, 50, (rbg.n_src_blocks * rbg.bs, k)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.inf  # unreached labels
    x_blocks = x.reshape(rbg.n_src_blocks, rbg.bs, k)
    act = _frontier(g.n, density, seed=k)
    r_act = rk.tile_activity(rbg, jnp.asarray(act))
    t_act = tk.tile_activity(tbg, torch.as_tensor(act))
    if compact:
        perm, dbid, sbid, first, last, accum, nact = rk.compact_tile_order(
            rbg, r_act)
        want = rpk.spmv_pallas_compact(
            rbg.tiles, perm, dbid, sbid, first, last, accum,
            jnp.asarray([nact], jnp.int32), jnp.asarray(x_blocks),
            rbg.n_dst_blocks, semiring="min_plus", interpret=True)
        args = tk.compact_tile_order(tbg, t_act)
        got = tk.spmv_blocked_compact(tbg, *args[:6], args[6],
                                      torch.as_tensor(x_blocks))
        flushed = np.zeros(rbg.n_dst_blocks, bool)
        flushed[np.asarray(rbg.dbid)[np.asarray(r_act) > 0]] = True
    else:
        want = rpk.spmv_pallas(
            rbg.tiles, rbg.dbid, rbg.sbid, rbg.first, rbg.last, rbg.accum,
            r_act, jnp.asarray(x_blocks), rbg.n_dst_blocks,
            semiring="min_plus", interpret=True)
        got = tk.spmv_blocked(tbg, t_act, torch.as_tensor(x_blocks))
        flushed = np.zeros(rbg.n_dst_blocks, bool)
        flushed[np.asarray(rbg.dbid)] = True
    # only flushed blocks are defined outputs of the kernels
    np.testing.assert_array_equal(got.numpy()[flushed],
                                  np.asarray(want)[flushed])


def _tile_batch(bg, ids):
    """The batch-local tile-major payload of the view's tiles ``ids``, as
    host residency stages it."""
    tp = bg.tile_ptr.long()
    cnt = tp[ids + 1] - tp[ids]
    local = torch.zeros(ids.numel() + 1, dtype=torch.int64)
    local[1:] = torch.cumsum(cnt, 0)
    e = (torch.repeat_interleave(tp[ids] - local[:-1], cnt)
         + torch.arange(int(local[-1])))
    return tk.TileBatch(tile_ptr=local.to(torch.int32),
                        tent_row=bg.tent_row[e], tent_src=bg.tent_src[e],
                        tent_w=bg.tent_w[e], sbid=bg.sbid[ids], n=bg.n,
                        bd=bg.bd, bs=bg.bs, semiring=bg.semiring)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_tile_batch_view_matches_full_view(semiring):
    """A batch-local ``TileBatch`` (the staged tiles' tile-major payload +
    their global source blocks), as host residency builds it, gives the
    full view's result: bit for bit through the dense plain route (its
    tiles rebuilt from the payload) and through the payload plain
    version."""
    g, _, tbg = _views("hilbert", semiring=semiring, seed=6)
    x = torch.as_tensor(np.random.default_rng(1).random(
        (tbg.n_src_blocks, tbg.bs, 2)), dtype=torch.float32)
    act = tk.tile_activity(tbg, torch.as_tensor(_frontier(g.n, 0.4, seed=2)))
    perm, dbid, sbid, first, last, accum, nact = tk.compact_tile_order(tbg,
                                                                       act)
    args = (dbid, sbid, first, last, accum, nact, x)
    want = tk.spmv_blocked_compact(tbg, perm, *args)
    view = _tile_batch(tbg, perm[:nact].long())
    local = torch.arange(nact, dtype=torch.int32)
    got = tk.spmv_blocked_compact(view, local, *args)
    assert torch.equal(got, want)
    assert torch.equal(tk.blocked_spmv_plain_compact_rows(view, local, *args),
                       tk.blocked_spmv_plain_compact_rows(tbg, perm, *args))


def test_plain_matches_coo_ground_truth():
    """With every vertex active the tiles equal the plain edge list."""
    g = erdos_renyi(150, 1200, seed=3)
    bg = tk.build_blocked(g, bd=32, bs=16, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(size=g.n),
                        dtype=torch.float32)
    y, st = tk.blocked_spmv(bg, x)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    want = np.zeros(g.n, np.float64)
    np.add.at(want, g.indices, x.numpy()[src].astype(np.float64))
    np.testing.assert_allclose(y.numpy(), want, **F32_TOL)
    assert int(st["tiles_skipped"]) == 0
