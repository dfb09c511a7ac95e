"""The port's engine (semirings, SEM SpMV paths, policy dispatch) against the
reference on the same edge stores.

The reference's ``SemGraph`` is carried across with
:mod:`repro_torch.convert`, so both engines stream byte-identical chunk
stores and tiles.  Frontier values are integer-valued floats (or bools), so
f32 sums are exact and values must agree bit for bit; every IOStats field
must agree exactly (the fields of ``tests/test_api.py::assert_io_equal``;
``queries`` is 0 on both sides here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import sem as rsem
from repro.core import semiring as rsr
from repro.graph.generators import erdos_renyi, rmat

from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import sem as tsem
from repro_torch.core import semiring as tsr

BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
SEMIRINGS = ("plus_times", "min_plus", "or_and")


def _sr(mod, name):
    return {"plus_times": mod.PLUS_TIMES, "min_plus": mod.MIN_PLUS,
            "max_times": mod.MAX_TIMES, "or_and": mod.OR_AND}[name]


def _io_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert int(x) == int(y), f"IOStats.{name}: {int(x)} != {int(y)}"


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def graphs():
    """(reference SemGraph, the port's copy) for the plain-tile encoding
    and for min_plus tiles."""
    g = rmat(8, edge_factor=8, seed=2)
    out = {}
    for enc in ("plus_times", "min_plus"):
        ref = rsem.device_graph(g, chunk_size=128, blocked=True, bd=32, bs=32,
                                blocked_semiring=enc)
        out[enc] = (ref, convert.sem_graph(ref, device="cpu"))
    return out


def _x(n, sr_name, k, seed):
    rng = np.random.default_rng(seed)
    shape = (n, k) if k > 1 else (n,)
    if sr_name == "or_and":
        return rng.random(shape) < 0.3
    return rng.integers(0, 64, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "max_times",
                                  "or_and"])
def test_semiring_ops(name):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 10, 200)
    if name == "or_and":
        y = rng.random((10, 3)) < 0.2
        c = rng.random((200, 3)) < 0.1
    else:
        y = rng.integers(-5, 5, (10, 3)).astype(np.float32)
        c = rng.integers(-9, 9, (200, 3)).astype(np.float32)
    r, t = _sr(rsr, name), _sr(tsr, name)
    _eq(t.scatter(torch.as_tensor(y), torch.as_tensor(keys), torch.as_tensor(c)),
        r.scatter(jnp.asarray(y), jnp.asarray(keys), jnp.asarray(c)))
    _eq(t.combine_elem(torch.as_tensor(y), torch.as_tensor(y[::-1].copy())),
        r.combine_elem(jnp.asarray(y), jnp.asarray(y[::-1].copy())))
    _eq(t.neutral_like(torch.as_tensor(y), 4), r.neutral_like(jnp.asarray(y), 4))
    act = rng.random((10, 3)) < 0.5
    _eq(t.mask_lanes(torch.as_tensor(y), torch.as_tensor(act)),
        r.mask_lanes(jnp.asarray(y), jnp.asarray(act)))


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("store", ["out_store", "in_store"])
def test_sem_and_compact_spmv(graphs, sr_name, reverse, store):
    ref, port = graphs["plus_times"]
    x = _x(ref.n, sr_name, 3, seed=5)
    act = np.random.default_rng(6).random(ref.n) < 0.1
    r, t = _sr(rsr, sr_name), _sr(tsr, sr_name)
    rs, ts = getattr(ref, store), getattr(port, store)
    y_r, st_r = rsem.sem_spmv(rs, jnp.asarray(x), jnp.asarray(act), r,
                              reverse=reverse)
    y_t, st_t = tsem.sem_spmv(ts, torch.as_tensor(x), torch.as_tensor(act), t,
                              reverse=reverse)
    _eq(y_t, y_r)
    _io_equal(st_t, st_r)
    for cap in (2, 64):  # overflow falls back to the full scan
        y_c, st_c = tsem.compact_spmv(ts, torch.as_tensor(x),
                                      torch.as_tensor(act), t, chunk_cap=cap,
                                      reverse=reverse)
        _eq(y_c, y_r)
        _io_equal(st_c, st_r)


@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("weighted", [False, True])
def test_p2p_spmv(direction, weighted):
    g = erdos_renyi(120, 900, seed=7)
    if weighted:
        from repro.graph.csr import from_edges

        src = np.repeat(np.arange(g.n), np.diff(g.indptr))
        w = np.random.default_rng(1).integers(1, 5, g.m).astype(np.float32)
        g = from_edges(src, g.indices, n=g.n, weights=w)
    ref = rsem.device_graph(g, chunk_size=64)
    port = convert.sem_graph(ref, device="cpu")
    x = _x(g.n, "plus_times", 1, seed=3)
    act = np.random.default_rng(4).random(g.n) < 0.2
    y_init = np.random.default_rng(5).integers(0, 9, g.n).astype(np.float32)
    for vcap, ecap in ((g.n, g.m), (8, 40), (64, 300)):
        y_r, st_r = rsem.p2p_spmv(ref, jnp.asarray(x), jnp.asarray(act),
                                  rsr.PLUS_TIMES, direction=direction,
                                  vcap=vcap, ecap=ecap,
                                  y_init=jnp.asarray(y_init))
        y_t, st_t = tsem.p2p_spmv(port, torch.as_tensor(x),
                                  torch.as_tensor(act), tsr.PLUS_TIMES,
                                  direction=direction, vcap=vcap, ecap=ecap,
                                  y_init=torch.as_tensor(y_init))
        _eq(y_t, y_r)
        _io_equal(st_t, st_r)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", ["out", "in", "auto"])
def test_traverse_frontier_expansion(graphs, backend, direction):
    """BFS-shaped supersteps (or_and, K lanes, an unexplored set) under
    every (backend, direction), with the compact band and the p2p arm on."""
    ref, port = graphs["plus_times"]
    rng = np.random.default_rng(8)
    active = rng.random((ref.n, 2)) < 0.15
    unexplored = rng.random((ref.n, 2)) < 0.7
    kw = dict(backend=backend, direction=direction, chunk_cap=4,
              switch_fraction=0.2)
    y_r, st_r = reng.traverse(ref, jnp.asarray(active), jnp.asarray(active),
                              rsr.OR_AND, policy=reng.ExecutionPolicy(**kw),
                              unexplored=jnp.asarray(unexplored))
    y_t, st_t = teng.traverse(port, torch.as_tensor(active),
                              torch.as_tensor(active), tsr.OR_AND,
                              policy=teng.ExecutionPolicy(**kw),
                              unexplored=torch.as_tensor(unexplored))
    _eq(y_t, y_r)
    _io_equal(st_t, st_r)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
def test_traverse_plain_spmv(graphs, backend, direction, sr_name):
    """PageRank-shaped supersteps: a plain dispatched SpMV with y_init."""
    ref, port = graphs[sr_name]
    x = _x(ref.n, sr_name, 1, seed=9)
    act = np.random.default_rng(10).random(ref.n) < 0.4
    y0 = _x(ref.n, sr_name, 1, seed=11)
    kw = dict(backend=backend, direction=direction, switch_fraction=None)
    y_r, st_r = reng.traverse(ref, jnp.asarray(x), jnp.asarray(act),
                              _sr(rsr, sr_name),
                              policy=reng.ExecutionPolicy(**kw),
                              y_init=jnp.asarray(y0))
    y_t, st_t = teng.traverse(port, torch.as_tensor(x), torch.as_tensor(act),
                              _sr(tsr, sr_name),
                              policy=teng.ExecutionPolicy(**kw),
                              y_init=torch.as_tensor(y0))
    _eq(y_t, y_r)
    _io_equal(st_t, st_r)


@pytest.mark.parametrize("backend", ["blocked", "blocked_compact"])
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("chunk_cap", [None, 4])
def test_traverse_min_plus_lanes(graphs, backend, direction, chunk_cap):
    """WCC-shaped supersteps through the min_plus tile kernels' CPU route:
    K label lanes (unreached = +inf), the compact band on and off."""
    ref, port = graphs["min_plus"]
    rng = np.random.default_rng(14)
    x = _x(ref.n, "min_plus", 2, seed=15)
    x[rng.random(x.shape) < 0.25] = np.inf
    act = rng.random(ref.n) < 0.2
    kw = dict(backend=backend, direction=direction, switch_fraction=None,
              chunk_cap=chunk_cap)
    y_r, st_r = reng.traverse(ref, jnp.asarray(x), jnp.asarray(act),
                              rsr.MIN_PLUS, policy=reng.ExecutionPolicy(**kw))
    y_t, st_t = teng.traverse(port, torch.as_tensor(x), torch.as_tensor(act),
                              tsr.MIN_PLUS, policy=teng.ExecutionPolicy(**kw))
    _eq(y_t, y_r)
    _io_equal(st_t, st_r)


@pytest.mark.parametrize("direction", ["out", "in"])
def test_flat_spmv(graphs, direction):
    ref, port = graphs["plus_times"]
    x = _x(ref.n, "plus_times", 1, seed=12)
    act = np.random.default_rng(13).random(ref.n) < 0.5
    _eq(teng.flat_spmv(port, torch.as_tensor(x), torch.as_tensor(act),
                       tsr.PLUS_TIMES, direction=direction),
        reng.flat_spmv(ref, jnp.asarray(x), jnp.asarray(act), rsr.PLUS_TIMES,
                       direction=direction))


def test_counters_and_buckets():
    deg = np.random.default_rng(0).integers(0, 50, 300).astype(np.int32)
    act = np.random.default_rng(1).random((300, 3)) < 0.4
    assert int(tsem.frontier_edge_mass(torch.as_tensor(deg),
                                       torch.as_tensor(act))) == int(
        rsem.frontier_edge_mass(jnp.asarray(deg), jnp.asarray(act)))
    for cap in (1, 5, 64, 100):
        b = tsem.pow2_buckets(cap)
        assert b == rsem.pow2_buckets(cap)
        for c in (0, 1, 3, cap):
            assert tsem.bucket_index(c, b) == int(rsem.bucket_index(
                jnp.asarray(c, jnp.int32), b))


def test_iostats_wrap_like_int32():
    """Counters wrap at 2^31 exactly as the reference's int32 fields."""
    big = 2**31 - 5
    a = tsem.IOStats.zero()._replace(bytes_moved=tsem.i32(big))
    total = a + a._replace(bytes_moved=tsem.i32(10))
    ref = jnp.asarray(big, jnp.int32) + jnp.asarray(10, jnp.int32)
    assert int(total.bytes_moved) == int(ref)
    assert int(tsem.i32(65536 * 40000)) == int(
        jnp.asarray(40000, jnp.int32) * 65536)


def test_beamer_boundary():
    for mf, mu, nf in ((10, 140, 11), (10, 139, 11), (10, 139, 10), (0, 0, 0)):
        args = [np.int32(v) for v in (mf, mu, nf)]
        want = bool(reng.beamer_use_pull(*map(jnp.asarray, args), 256))
        got = bool(teng.beamer_use_pull(*map(torch.as_tensor, args), 256))
        assert got == want


def test_policy_validation():
    for bad in (dict(backend="x"), dict(direction="sideways"),
                dict(tile_order="zigzag"), dict(residency="disk"),
                dict(stream_buffer=0)):
        with pytest.raises(teng.PolicyError):
            teng.ExecutionPolicy(**bad)
    assert teng.ExecutionPolicy() == teng.ExecutionPolicy().with_()
    ref_fields = {f: getattr(reng.ExecutionPolicy(), f)
                  for f in reng.ExecutionPolicy.__dataclass_fields__}
    port_fields = {f: getattr(teng.ExecutionPolicy(), f)
                   for f in teng.ExecutionPolicy.__dataclass_fields__}
    assert ref_fields == port_fields


def test_tile_order_mismatch_raises(graphs):
    _, port = graphs["plus_times"]
    pol = teng.ExecutionPolicy(backend="blocked", tile_order="hilbert")
    with pytest.raises(teng.ResidencyError, match="tile_order"):
        teng.traverse(port, torch.ones(port.n), torch.ones(port.n, dtype=bool),
                      tsr.PLUS_TIMES, policy=pol)
