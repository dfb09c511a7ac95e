"""The port's decode attention (B5's wrapper on the CPU, i.e. its plain
version) against the JAX package's ``decode_attention`` (the Pallas kernel
in interpret mode) and its oracle ``decode_attention_ref``.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs carry their bits across).  Tolerances are those of
``tests/test_kernels.py``: ``atol=rtol=1e-4`` in f32 (the same f32 math in
another summation order: blocked online softmax against one softmax) and
``2e-2`` in bf16 (the reference's interpret-mode kernel and oracle round
their bf16 operands and products at other places than torch's f32 upcast).
The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py``, which needs a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attention, decode_attention_ref

from repro_torch.convert import model_params
from repro_torch.kernels import decode_attn as tda

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _both(a: np.ndarray, dtype):
    """The same values as a jax array and a CPU torch tensor (bf16 by its
    bits)."""
    j = jnp.asarray(a, dtype)
    return j, model_params({"a": np.asarray(j)}, device="cpu")["a"]


def _inputs(rng, B, kv, g, hd, T, dtype):
    q = rng.normal(size=(B, kv * g, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, kv, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, kv, hd)).astype(np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


def _ints(a):
    a = np.ascontiguousarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kv,g", [(1, 8), (2, 4), (8, 1)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_matches_reference(kv, g, dtype):
    rng = np.random.default_rng(kv * 10 + g)
    B, hd, T = 2, 32, 256
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, B, kv, g, hd, T, dtype)
    pj, pt = _ints(np.broadcast_to(np.arange(T)[None], (B, T)))
    cj, ct = _ints([T // 3, T - 1])
    got = tda.decode_attention(qt, kt, vt, pt, ct, block_t=64)
    assert got.dtype == torch.float32 and got.shape == (B, kv * g, hd)
    tol = F32 if dtype == jnp.float32 else BF16
    out = decode_attention(qj, kj, vj, pj, cj, block_t=64, interpret=True)
    ref = decode_attention_ref(qj, kj, vj, pj, cj)
    np.testing.assert_allclose(got.numpy(), _np(out), **tol)
    np.testing.assert_allclose(got.numpy(), _np(ref), **tol)


def test_decode_attention_4d_query_matches_3d():
    rng = np.random.default_rng(3)
    (_, qt), (_, kt), (_, vt) = _inputs(rng, 2, 2, 4, 16, 64, jnp.float32)
    _, pt = _ints(np.broadcast_to(np.arange(64)[None], (2, 64)))
    _, ct = _ints([10, 63])
    a = tda.decode_attention(qt[:, None], kt, vt, pt, ct)
    b = tda.decode_attention(qt, kt, vt, pt, ct)
    assert torch.equal(a, b)


@pytest.mark.parametrize("window", [32, 100])
def test_decode_attention_window(window):
    """Only positions inside the window contribute."""
    rng = np.random.default_rng(window)
    B, kv, g, hd, T = 1, 2, 2, 16, 512
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, B, kv, g, hd, T, jnp.float32)
    pj, pt = _ints(np.broadcast_to(np.arange(T)[None], (B, T)))
    cj, ct = _ints([T - 1])
    got = tda.decode_attention(qt, kt, vt, pt, ct, window=window, block_t=64)
    out = decode_attention(qj, kj, vj, pj, cj, window=window, block_t=64,
                           interpret=True)
    ref = decode_attention_ref(qj, kj, vj, pj, cj, window=window)
    np.testing.assert_allclose(got.numpy(), _np(out), **F32)
    np.testing.assert_allclose(got.numpy(), _np(ref), **F32)


def test_decode_attention_rotating_cache_slots():
    """Masks key on stored positions, so a scrambled slot order gives the
    result of the ordered cache."""
    rng = np.random.default_rng(7)
    B, kv, g, hd, T = 2, 1, 4, 16, 128
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, B, kv, g, hd, T, jnp.float32)
    perm = rng.permutation(T)
    base = np.broadcast_to(np.arange(T)[None], (B, T)).copy()
    pj, pt = _ints(base[:, perm])
    cj, ct = _ints([T - 1, T // 2])
    got = tda.decode_attention(qt, kt[:, perm], vt[:, perm], pt, ct,
                               block_t=32)
    out = decode_attention(qj, kj[:, perm], vj[:, perm], pj, cj, block_t=32,
                           interpret=True)
    ref = decode_attention_ref(qj, kj, vj, jnp.asarray(base, jnp.int32), cj)
    np.testing.assert_allclose(got.numpy(), _np(out), **F32)
    np.testing.assert_allclose(got.numpy(), _np(ref), **F32)


def test_decode_attention_empty_slots():
    """-1 (never written) slots are dead whatever their k/v payload."""
    rng = np.random.default_rng(9)
    B, kv, g, hd, T = 1, 2, 2, 16, 128
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, B, kv, g, hd, T, jnp.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).copy()
    pos[:, 64:] = -1  # half the cache never written
    pj, pt = _ints(pos)
    cj, ct = _ints([T - 1])
    got = tda.decode_attention(qt, kt, vt, pt, ct, block_t=32)
    out = decode_attention(qj, kj, vj, pj, cj, block_t=32, interpret=True)
    ref = decode_attention_ref(qj, kj[:, :64], vj[:, :64], pj[:, :64], cj)
    np.testing.assert_allclose(got.numpy(), _np(out), **F32)
    np.testing.assert_allclose(got.numpy(), _np(ref), **F32)


@pytest.mark.parametrize("how", ["never_written", "all_in_future"])
def test_decode_attention_row_with_no_live_slot_is_zero(how):
    """A row with no live slot gives 0, as the reference's kernel path
    ``decode_attention`` does; its oracle ``decode_attention_ref`` gives the
    mean of v there instead (softmax over a row of -2e38)."""
    rng = np.random.default_rng(11)
    B, kv, g, hd, T = 2, 2, 2, 16, 64
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, B, kv, g, hd, T, jnp.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).copy()
    if how == "never_written":
        pos[1] = -1
        cur = [T - 1, T - 1]
    else:
        pos[1] += 10
        cur = [T - 1, 5]
    pj, pt = _ints(pos)
    cj, ct = _ints(cur)
    got = tda.decode_attention(qt, kt, vt, pt, ct, block_t=16)
    out = decode_attention(qj, kj, vj, pj, cj, block_t=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(out), **F32)
    assert torch.count_nonzero(got[1]) == 0
    ref = _np(decode_attention_ref(qj, kj, vj, pj, cj))
    np.testing.assert_allclose(ref[1], _np(vj[1]).mean(0).reshape(-1, hd)
                               .repeat(g, 0), **F32)


STAGE, CONSUMERS = 16, 4  # decode_attn.cu: kStage, kConsumers
NEG_INF = -2.0e38  # the reference's NEG_INF


def _merge(states):
    """(m, l, acc) partials combined in list order, as the kernel merges
    its warps and then its splits."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L, A = torch.zeros_like(M), torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.exp(m - M)
        L = L + l * f
        A = A + acc * f[..., None]
    return M, L, A


def _ring_emulation(q, k, v, pos, cur, *, window, bt, nsplit, split_p=True):
    """The bf16 kernel's arithmetic (``decode_attn.cu``, decode_attn_ring)
    in plain torch: products of bf16 q and k summed in f32; each live
    16-slot chunk of a split an online-softmax step of the consumer warp
    that takes it (the split's live chunks dealt out in turn); P split into
    bf16 ``p_hi`` and ``p_lo`` before it meets bf16 V (or rounded to bf16
    once, ``split_p=False``); the warps merged in warp order, the splits in
    split order; ``acc / max(l, 1e-30)``."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd).float()
    kf, vf = k.float(), v.float()
    live = (pos >= 0) & (pos <= cur[:, None])
    if window > 0:
        live &= pos > cur[:, None] - window
    cpb = -(-bt // STAGE)
    total = t // bt * cpb
    out = torch.zeros(b, kv, h // kv, hd)
    for r in range(b):
        splits = []
        for split in range(nsplit):
            warps = [(torch.full(qg.shape[1:3], NEG_INF),
                      torch.zeros(qg.shape[1:3]), torch.zeros(qg.shape[1:]))
                     for _ in range(CONSUMERS)]
            seq = 0
            for ci in range(split, total, nsplit):
                blk, j = divmod(ci, cpb)
                t0 = blk * bt + j * STAGE
                sl = slice(t0, t0 + min(STAGE, bt - j * STAGE))
                ok = live[r, sl]
                if not ok.any():
                    continue
                m, l, acc = warps[seq % CONSUMERS]
                s = torch.einsum("kgd,tkd->kgt", qg[r], kf[r, sl]) * hd**-0.5
                m_new = torch.maximum(m, s.masked_fill(~ok, NEG_INF).amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(s - m_new[..., None]),
                                torch.zeros(()))
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float() if split_p else 0 * p
                acc = acc * alpha[..., None]
                for part in (lo, hi):
                    acc = acc + torch.einsum("kgt,tkd->kgd", part, vf[r, sl])
                warps[seq % CONSUMERS] = (m_new, l * alpha + p.sum(-1), acc)
                seq += 1
            splits.append(_merge(warps))
        _, L, A = _merge(splits)
        out[r] = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, hd)


@pytest.mark.parametrize("case", ["serve", "window", "rotated"])
def test_kernel_precision_plan_meets_the_gate(case):
    """The bf16 kernel's rounding, emulated in plain torch, stays within the
    card's gate (``atol=rtol=1e-4``) of the f32 plain version, and within
    the file's bf16 tolerance of the reference's interpret-mode kernel.
    Rounding P to bf16 alone would not meet the gate.  The splits are the
    kernel's at the shape on one H100 (132 SMs, one block an SM at
    hd=256)."""
    from repro_torch.kernels.decode_attn.kernel import split_count

    b, kv, g, hd, t, window, fills, rotate = {
        "serve": (4, 1, 8, 256, 1024, 0, (1, 200, 700, 1024), False),
        "window": (2, 4, 2, 64, 512, 100, (512, 300), False),
        "rotated": (2, 1, 8, 128, 1000, 0, (1500, 1030), True),  # bt=125
    }[case]
    rng = np.random.default_rng(len(case))
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, b, kv, g, hd, t,
                                           jnp.bfloat16)
    slots = np.arange(t)
    if rotate:  # slot s holds the newest position p with p % t == s
        pos = np.stack([(f - 1) - ((f - 1) - slots) % t for f in fills])
    else:
        pos = np.stack([np.where(slots < f, slots, -1) for f in fills])
    pj, pt = _ints(pos)
    cj, ct = _ints([f - 1 for f in fills])
    bt = tda.block_size(t)
    nsplit = split_count(b * kv, t // bt * -(-bt // STAGE), 132)
    emu = _ring_emulation(qt, kt, vt, pt, ct, window=window, bt=bt,
                          nsplit=nsplit)
    plain = tda.decode_attention_plain(qt, kt, vt, pt, ct, window=window)
    torch.testing.assert_close(emu, plain, **F32)
    ref = decode_attention(qj, kj, vj, pj, cj, window=window, interpret=True)
    np.testing.assert_allclose(emu.numpy(), _np(ref), **BF16)
    rounded = _ring_emulation(qt, kt, vt, pt, ct, window=window, bt=bt,
                              nsplit=nsplit, split_p=False)
    assert float((rounded - plain).abs().max()) > 1e-4


@pytest.mark.parametrize("t,block_t,want", [(256, 128, 128), (100, 128, 100),
                                            (96, 64, 48), (1024, 128, 128),
                                            (7, 4, 1)])
def test_block_size_is_the_reference_rule(t, block_t, want):
    assert tda.block_size(t, block_t) == want


@pytest.mark.parametrize("window", [0, 40])
def test_live_blocks_is_the_chunk_activity_test(window):
    rng = np.random.default_rng(window + 1)
    B, T, bt = 3, 128, 16
    pos = rng.permutation(T)[None].repeat(B, 0).astype(np.int32)
    pos[0, :40] = -1
    cur = np.asarray([T - 1, 60, 3], np.int32)
    got = tda.live_blocks(torch.from_numpy(pos), torch.from_numpy(cur), bt,
                          window).numpy()
    live = (pos >= 0) & (pos <= cur[:, None])
    if window:
        live &= pos > cur[:, None] - window
    np.testing.assert_array_equal(got, live.reshape(B, T // bt, bt).any(2))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version itself: on a CPU tensor
    it raises (the choice of path is ``decode_attention``'s)."""
    q = torch.zeros(1, 1, 2, 16)
    k = torch.zeros(1, 32, 1, 16)
    pos = torch.zeros(1, 32, dtype=torch.int32)
    cur = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attn_cuda(q, k, k, pos, cur, window=0, block_t=32)


def test_decode_attention_refuses_other_devices():
    """Only the CPU (the plain version), CUDA (B5) and the meta device (a
    traced step, B5's operator) are served: a fake XPU tensor is refused
    before anything runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.zeros(1, 2, 16, device="xpu")
        k = torch.zeros(1, 32, 1, 16, device="xpu")
        pos = torch.zeros(1, 32, dtype=torch.int32, device="xpu")
        cur = torch.zeros(1, dtype=torch.int32, device="xpu")
        with pytest.raises(ValueError, match="no decode attention"):
            tda.decode_attention(q, k, k, pos, cur)


@pytest.mark.parametrize("rows,units,slots,want", [
    (4, 64, 132, 16),  # the serve shape: 8 blocks of 8 chunks, hd=256
    (128, 2048, 132, 1),  # decode_32k: the rows fill the card
    (4, 512, 132, 32),  # B=1, KV=4, 64 blocks: 16 chunks a split
    (2400, 2, 1056, 1),  # the f32 body: 300 rows x 8 heads, 2 blocks
])
def test_split_count_fills_the_card(rows, units, slots, want):
    """At most one wave of thread blocks, at least four units a split, the
    same whole number of units in every split; never more splits than
    units, never none."""
    from repro_torch.kernels.decode_attn.kernel import split_count

    n = split_count(rows, units, slots)
    assert n == want
    assert rows * n <= max(slots, rows) and 1 <= n <= units
    assert -(-units // n) * (n - 1) < units  # no split left without a unit


def test_binding_matches_the_c_signature():
    """The ctypes argument list has one entry of the right kind for each
    parameter of ``decode_attn.cu``'s exported functions."""
    import ctypes
    import re

    from repro_torch.kernels.build import CSRC
    from repro_torch.kernels.decode_attn.kernel import _ARGTYPES

    src = (CSRC / "decode_attn.cu").read_text()
    macro = re.search(r"#define DECODE_ATTN_ARGS(.*?)\n\n", src, re.S).group(1)
    params = [p.strip() for p in macro.replace("\\", "").split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.startswith("float") else ctypes.c_int
             for p in params]
    assert kinds == _ARGTYPES
