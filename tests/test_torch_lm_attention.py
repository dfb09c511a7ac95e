"""The port's full-sequence attention and the layer pieces of the other
families against the JAX package on the CPU: ``models/flash.py``'s chunked
forward and its tile table, ``_sdpa``, ``attn_full`` on both sides of
``FLASH_MIN_SEQ``, the cross attention, M-RoPE, the ungated MLP, learned
positions and the untied head.

Inputs are made with numpy from a seed and handed to both packages; bf16
values carry their bits across (``repro_torch.convert.model_params``).
Tolerances, with their reasons:

* ``flash_attention`` in f32: ``atol=rtol=2e-5``, the bound of
  ``tests/test_flash.py``'s forward against its dense oracle (the same f32
  math, other summation orders).
* bf16 outputs of one layer function: ``rtol=atol=1.6e-2`` (two bf16 ulps
  at |x| ~ 1, as ``tests/test_torch_lm.py``): both compute in f32 and round
  to bf16, but products and reductions sum in other orders, which can move
  a value across a rounding boundary.
* the attention paths on bf16 inputs: within ``0.02 * max|ref|``.  Both
  round the probabilities to bf16 on the dense path and the output to
  bf16 after an f32 p.v on the chunked one; a bf16 ulp is 2^-8 of the
  value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.models import attention as ratt
from repro.models import flash as rflash
from repro.models import layers as rl
from repro.models.param import Mk as RMk
from repro.models.param import split

from repro_torch import configs as tcfg
from repro_torch.convert import model_params
from repro_torch.models import attention as tatt
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tl

from torch_lm_common import one_thread  # noqa: F401 (autouse fixture)

F32_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_flash.py
BF16_TOL = dict(atol=1.6e-2, rtol=1.6e-2)  # tests/test_torch_lm.py
ATTN_BOUND = 0.02

# tests/test_flash.py's cases: b, sq, t, h, kv, hd, causal, window, cq, ck
CASES = [
    (2, 16, 16, 4, 2, 8, True, 0, 4, 8),
    (1, 32, 32, 4, 1, 16, True, 10, 8, 8),
    (2, 24, 24, 6, 6, 8, False, 0, 8, 8),
    (2, 16, 48, 4, 2, 8, True, 0, 16, 16),
    (1, 64, 64, 2, 2, 4, True, 7, 16, 32),
]


def _to_port(tree):
    return model_params(jax.tree.map(np.asarray, tree), device="cpu")


def _init(fn, seed=0):
    return split(fn(RMk(jax.random.key(seed))))[0]


def _pair(a: np.ndarray, dtype=jnp.bfloat16):
    j = jnp.asarray(a, dtype)
    return j, _to_port({"a": j})["a"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _within(got, ref, bound, label):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err < bound * scale, (label, err, scale)


def _flash_inputs(case, dead: bool):
    b, sq, t, h, kv, hd = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, sq, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    qpos = np.broadcast_to(np.arange(sq)[None] + (t - sq), (b, sq))
    kpos = np.broadcast_to(np.arange(t)[None], (b, t)).copy()
    if dead:  # dead slots, as a cache that is not yet full holds them
        kpos[0, :3] = -1
        kpos[-1, -2:] = -1
    return q, k, v, qpos.astype(np.int32), kpos.astype(np.int32)


# -------------------------------------------------------------- flash
@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead_slots"])
@pytest.mark.parametrize("case", CASES)
def test_flash_forward_matches(case, dead):
    b, sq, t, h, kv, hd, causal, window, cq, ck = case
    q, k, v, qpos, kpos = _flash_inputs(case, dead)
    want = rflash.flash_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)),
        jnp.asarray(window, jnp.int32), causal, hd**-0.5, cq, ck)
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v, qpos, kpos)),
                                 window, causal, hd**-0.5, cq, ck)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_flash_packed_positions_match():
    """Two packed sequences in one row (positions restart mid-row):
    ``tests/test_flash.py::test_flash_packed_positions``'s input."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 32, 2, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.concatenate([np.arange(16), np.arange(16)])[None].astype(np.int32)
    want = rflash.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                  jnp.zeros((), jnp.int32), True, 8**-0.5, 8, 8)
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                 0, True, 8**-0.5, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead_slots"])
@pytest.mark.parametrize("case", CASES)
def test_tile_table_skips_what_the_reference_skips(case, dead):
    """The live table is the complement of the reference's ``_skippable``,
    tile for tile."""
    b, sq, t, h, kv, hd, causal, window, cq, ck = case
    _, _, _, qpos, kpos = _flash_inputs(case, dead)
    table = tflash.TileTable(torch.from_numpy(qpos), torch.from_numpy(kpos),
                             cq, ck)
    live = table.live(window, causal)
    for i in range(sq // cq):
        for j in range(t // ck):
            skip = rflash._skippable(jnp.asarray(qpos[:, i * cq:(i + 1) * cq]),
                                     jnp.asarray(kpos[:, j * ck:(j + 1) * ck]),
                                     jnp.asarray(window, jnp.int32), causal)
            assert live[i, j] == (not bool(skip)), (i, j)


def test_tile_table_reads_the_device_once_per_forward():
    """One extrema read serves every window; a window's table is kept."""
    pos = torch.arange(64, dtype=torch.int32)[None].expand(2, 64)
    table = tflash.TileTable(pos, pos, 8, 16)
    a = table.live(0)
    ext = table._extrema
    b = table.live(20)
    assert table._extrema is ext and table.live(0) is a
    assert a.sum() > b.sum()  # the window skips tiles the diagonal keeps
    assert table.live(0, causal=False).all()


@pytest.mark.parametrize("s,target", [(4096, 512), (100, 64), (7, 4),
                                      (32768, 1024), (2049, 512), (1025, 512)])
def test_pick_chunk_matches(s, target):
    assert tflash.pick_chunk(s, target) == rflash.pick_chunk(s, target)


# -------------------------------------------------------- attention
def _qkv(rng, b, s, t, h, kv, hd):
    return [_pair(rng.normal(size=shape)) for shape in
            ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


@pytest.mark.parametrize("window", [0, 5])
def test_sdpa_matches(window):
    """The dense path, probabilities rounded to bf16 before p.v (ROADMAP §C
    P9), a causal and windowed [B, S, T] mask."""
    rng = np.random.default_rng(11)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 12, 12, 4, 2, 16)
    pos = np.arange(12)
    mask = (pos[None, :] <= pos[:, None])
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    mask = np.broadcast_to(mask, (2, 12, 12))
    cfg = rcfg.get_smoke("gemma3-4b")
    want = ratt._sdpa(qj, kj, vj, jnp.asarray(mask), cfg)
    got = tatt._sdpa(qt, kt, vt, torch.from_numpy(mask.copy()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("arch,window,causal", [
    ("gemma3-4b", 0, True), ("gemma3-4b", 24, True), ("h2o-danube-1.8b", 0,
                                                      True),
    ("whisper-base", 0, False), ("qwen2-vl-72b", 0, True)])
@pytest.mark.parametrize("s", [1000, 1040], ids=["sdpa", "flash"])
def test_attn_full_matches_on_both_sides_of_1024(arch, window, causal, s):
    """``attn_full`` below ``FLASH_MIN_SEQ`` (dense ``_sdpa``) and above it
    (the chunked path, ``pick_chunk(1040, 512) = 520``): qk-norm, a window,
    learned positions (no rope), M-RoPE positions [3, B, S]."""
    cfg = rcfg.get_smoke(arch)
    tc = tcfg.get_smoke(arch)
    p = _init(lambda mk: ratt.init_attention(mk, cfg), seed=4)
    xj, xt = _pair(np.random.default_rng(s).normal(size=(1, s, cfg.d_model)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (1, s))
    if cfg.m_rope_sections:
        pos = np.stack([pos, pos // 3, pos // 5])
    want = jax.jit(lambda p, x, pos: ratt.attn_full(
        p, x, cfg, pos, window=window, causal=causal))(p, xj, jnp.asarray(pos))
    got = tatt.attn_full(_to_port(p), xt, tc, torch.from_numpy(pos.copy()),
                         window=window, causal=causal)
    assert got.shape == (1, s, cfg.d_model) and got.dtype == torch.bfloat16
    _within(_np(got), _np(want), ATTN_BOUND, (arch, s))


@pytest.mark.parametrize("t", [40, 1100], ids=["sdpa", "flash"])
def test_attn_cross_and_project_kv_match(t):
    """Whisper's cross attention over the encoder's K/V, dense and, once
    the encoder side reaches 1024, chunked."""
    cfg = rcfg.get_smoke("whisper-base")
    tc = tcfg.get_smoke("whisper-base")
    p = _init(lambda mk: ratt.init_attention(mk, cfg), seed=5)
    rng = np.random.default_rng(t)
    xj, xt = _pair(rng.normal(size=(2, 3, cfg.d_model)))
    ej, et = _pair(rng.normal(size=(2, t, cfg.d_model)))
    kj, vj = ratt.project_kv(p, ej, cfg)
    tp = _to_port(p)
    kt, vt = tatt.project_kv(tp, et, tc)
    np.testing.assert_allclose(_np(kt), _np(kj), **BF16_TOL)
    np.testing.assert_allclose(_np(vt), _np(vj), **BF16_TOL)
    want = ratt.attn_cross(p, xj, kj, vj, cfg)
    got = tatt.attn_cross(tp, xt, kt, vt, tc)
    _within(_np(got), _np(want), ATTN_BOUND, t)


def test_attn_decode_takes_m_rope_positions():
    """qwen2-vl decode: positions [3, B, 1]; the cache slot and the mask
    follow the temporal stream."""
    cfg = rcfg.get_smoke("qwen2-vl-72b")
    tc = tcfg.get_smoke("qwen2-vl-72b")
    p = _init(lambda mk: ratt.init_attention(mk, cfg), seed=6)
    tp = _to_port(p)
    jc = ratt.init_kv_cache(2, 8, cfg)
    cache = tatt.init_kv_cache(2, 8, tc, "cpu")
    decode = jax.jit(lambda p, x, c, pos: ratt.attn_decode(p, x, c, cfg, pos))
    rng = np.random.default_rng(12)
    for step in range(10):
        xj, xt = _pair(rng.normal(size=(2, 1, cfg.d_model)))
        pos = np.full((3, 2, 1), step, np.int32)
        pos[1:] += 7
        want, jc = decode(p, xj, jc, jnp.asarray(pos))
        got, cache = tatt.attn_decode(tp, xt, cache, tc, torch.from_numpy(pos))
        _within(_np(got), _np(want), 0.05, step)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jc.pos))


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_m_rope_sections_match(theta):
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng.normal(size=(2, 5, 4, 16)))
    pos = rng.integers(0, 512, (3, 2, 5)).astype(np.int32)
    got = tl.apply_rope(xt, torch.from_numpy(pos), theta, (2, 3, 3))
    want = rl.apply_rope(xj, jnp.asarray(pos), theta, (2, 3, 3))
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_ungated_mlp_matches():
    """whisper's plain two-layer GELU MLP (``gated_mlp=False``): no gate."""
    cfg = rcfg.get_smoke("whisper-base")
    p = _init(lambda mk: rl.init_mlp(mk, cfg))
    tp = tl.init_mlp(_mk(), tcfg.get_smoke("whisper-base"))
    assert sorted(tp) == sorted(p) == ["down", "up"]
    xj, xt = _pair(np.random.default_rng(8).normal(size=(2, 3, cfg.d_model)))
    got = tl.mlp(_to_port(p), xt, tcfg.get_smoke("whisper-base"))
    np.testing.assert_allclose(_np(got), _np(rl.mlp(p, xj, cfg)), **BF16_TOL)


def _mk(seed=0):
    from repro_torch.models.param import Mk

    return Mk(torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("arch,untie", [("whisper-base", False),
                                        ("gemma-2b", True)])
def test_embedding_tree_and_unembed_match(arch, untie):
    """Learned positions (whisper, scale 0.02) and an untied head where a
    configuration unties the embedding; logits in f32, padded columns
    -1e30."""
    cfg = dataclasses.replace(rcfg.get_smoke(arch), tie_embeddings=not untie)
    tc = dataclasses.replace(tcfg.get_smoke(arch), tie_embeddings=not untie)
    p = _init(lambda mk: rl.init_embedding(mk, cfg), seed=9)
    tp = tl.init_embedding(_mk(), tc)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in p.items()}
    if cfg.pos == "learned":
        assert abs(float(tp["pos"].float().std()) - 0.02) < 0.002
    xj, xt = _pair(np.random.default_rng(10).normal(size=(3, cfg.d_model)))
    got = tl.unembed(_to_port(p), xt, tc)
    want = rl.unembed(p, xj, cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    if untie:  # the head, not the table
        tied = tl.unembed(_to_port(p), xt, dataclasses.replace(
            tc, tie_embeddings=True))
        assert not torch.equal(tied, got)
