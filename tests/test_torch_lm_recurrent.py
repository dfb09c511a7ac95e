"""The port's LM serving path for the ssm (mamba2-370m), hybrid
(zamba2-2.7b) and enc-dec (whisper-base) families against the JAX package
on the CPU: ``mamba2_full`` / ``mamba2_decode`` alone, then each family's
``forward``, ``prefill`` (logits and every cache leaf: SSM states, conv
tails, the hybrid's shared-attention K/V, the enc-dec's self and cross
K/V), ``decode_step`` after it and prefill + decode against forward; and
``serve_batch`` of whisper-base against the reference's.

Each architecture's reference outputs are computed once, by a
module-scoped fixture (``tests/torch_lm_common.py`` states the family
tolerances).  ``mamba2_full`` / ``mamba2_decode`` alone: outputs within
``0.05 * max|ref|`` (bf16 inputs and outputs, f32 inside; the reference
and torch round the bf16 projections and the conv at other places), the
f32 state within ``0.02 * max|ref|``, the conv tail within two bf16 ulps
(``rtol=atol=1.6e-2``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import build_model as ref_build_model
from repro.models import mamba2 as rm
from repro.models.param import Mk as RMk
from repro.models.param import split

from repro_torch import configs as tcfg
from repro_torch.launch.serve import serve_batch
from repro_torch.models import mamba2 as tm

from torch_lm_common import (as_np, caches_agree, family_run, logits_agree,
                             one_thread, to_port, within_bound)

ARCHS = ["mamba2-370m", "zamba2-2.7b", "whisper-base"]
BF16_TOL = dict(atol=1.6e-2, rtol=1.6e-2)


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return family_run(request.param)


# ------------------------------------------------------------- mamba2
@pytest.mark.parametrize("s", [32, 24, 5], ids=["chunks", "padded",
                                                "one_short_chunk"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_mamba2_full_and_decode_match(arch, s):
    """Chunk 16: 32 tokens are two chunks; 24 pads the second chunk with
    dt = 0; 5 is one chunk of 5.  Then one decode step from the returned
    state."""
    cfg, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
    p = split(rm.init_mamba2(RMk(jax.random.key(1)), cfg))[0]
    tp = to_port(p)
    rng = np.random.default_rng(s)
    x = jnp.asarray(rng.normal(size=(2, s, cfg.d_model)), jnp.bfloat16)
    y, st = jax.jit(lambda p, x: rm.mamba2_full(p, x, cfg,
                                                return_state=True))(p, x)
    ty, tst = tm.mamba2_full(tp, to_port({"x": x})["x"], tc,
                             return_state=True)
    assert ty.shape == (2, s, cfg.d_model) and ty.dtype == torch.bfloat16
    within_bound(as_np(ty), as_np(y), "y")
    within_bound(tst.state.numpy(), np.asarray(st.state), "state",
                 bound=0.02)
    np.testing.assert_allclose(as_np(tst.conv), as_np(st.conv), **BF16_TOL)
    assert torch.equal(tm.mamba2_full(tp, to_port({"x": x})["x"], tc), ty)
    x1 = jnp.asarray(rng.normal(size=(2, 1, cfg.d_model)), jnp.bfloat16)
    yd, sd = jax.jit(lambda p, x, st: rm.mamba2_decode(p, x, st, cfg))(
        p, x1, st)
    tyd, tsd = tm.mamba2_decode(tp, to_port({"x": x1})["x"], tst, tc)
    within_bound(as_np(tyd), as_np(yd), "decode")
    within_bound(tsd.state.numpy(), np.asarray(sd.state), "decode state",
                 bound=0.02)


def test_segsum_is_zero_above_the_diagonal_after_exp():
    x = torch.randn(3, 6, generator=torch.Generator().manual_seed(0))
    L = torch.exp(tm._segsum(x))
    assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))
    low = np.broadcast_to(np.tril(np.ones((6, 6), bool)), (3, 6, 6))
    want = np.asarray(rm._segsum(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tm._segsum(x).numpy()[low], want[low],
                               atol=1e-6)
    assert np.isneginf(want[~low]).all()


def test_ssm_cache_matches_the_reference_shapes():
    cfg, tc = rcfg.get_smoke("mamba2-370m"), tcfg.get_smoke("mamba2-370m")
    want = rm.init_ssm_cache(3, cfg)
    got = tm.init_ssm_cache(3, tc, "cpu")
    assert got.conv.shape == want.conv.shape and got.conv.dtype == torch.bfloat16
    assert got.state.shape == want.state.shape
    assert got.state.dtype == torch.float32


# ------------------------------------------------------------ families
def test_forward_matches(run):
    logits_agree(run["port_fwd"], run["ref_fwd"], run["cfg"].family,
                 "forward")


def test_prefill_logits_match(run):
    logits_agree(run["port_pre"], run["ref_pre"], run["cfg"].family,
                 "prefill")


def test_prefill_cache_matches(run):
    """SSM states and conv tails; the hybrid's shared-attention K/V on its
    attention layers only; whisper's self cache and cross K/V."""
    n = caches_agree(run["port_cache"], run["ref_cache"], "prefill cache")
    cfg = run["cfg"]
    per_layer = {"ssm": 2, "hybrid": 2, "encdec": 5}[cfg.family]
    extra = cfg.n_layers // cfg.attn_every * 3 if cfg.family == "hybrid" else 0
    assert n == per_layer * cfg.n_layers + extra + 1


def test_decode_after_prefill_matches(run):
    logits_agree(run["port_dec"], run["ref_dec"], run["cfg"].family,
                 "decode")
    caches_agree(run["port_cache_dec"], run["ref_cache_dec"], "decode cache")


def test_prefill_then_decode_equals_forward(run):
    """``tests/test_serving_parity.py``'s contract on the port alone."""
    logits_agree(run["port_dec"], run["port_fwd"][:, -1], run["cfg"].family,
                 "serving")
    assert (as_np(run["port_dec"]).argmax(-1)
            == as_np(run["port_fwd"][:, -1]).argmax(-1)).all()


def test_hybrid_shared_block_is_one_set_of_weights():
    """zamba2's shared block: one unstacked tree, applied after every
    ``attn_every``-th layer, which alone hold an attention cache."""
    from repro_torch.models import build_model

    tc = tcfg.get_smoke("zamba2-2.7b")
    model = build_model(tc, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert params["shared"]["attn"]["wq"].dim() == 3  # no layer axis
    cache = model.init_cache(2, 16)
    assert [("attn" in c) for c in cache["layers"]] == [
        (l + 1) % tc.attn_every == 0 for l in range(tc.n_layers)]


def test_serve_batch_whisper_matches_the_reference():
    """The enc-dec family through ``serve_batch`` (cross K/V of
    ``max_len`` zero frames on both sides), on the reference's own
    ``init(jax.random.key(0))`` weights: the same schedule, and the
    generated tokens agree on at least half the positions, the repo's bar
    for bf16 argmax flips (``tests/test_serving_parity.py:71``)."""
    kw = dict(n_requests=4, max_batch=2, max_new=4, max_len=32, seed=0)
    params, _ = ref_build_model(rcfg.get_smoke("whisper-base")).init(
        jax.random.key(0))
    want = ref_serve_batch("whisper-base", **kw)
    got = serve_batch("whisper-base", device="cpu", params=to_port(params),
                      **kw)
    for key in ("arch", "requests", "tokens", "decode_steps"):
        assert got[key] == want[key], key
    agree = total = 0
    for rid, toks in want["outputs"].items():
        assert len(got["outputs"][rid]) == len(toks)
        agree += sum(a == b for a, b in zip(got["outputs"][rid], toks))
        total += len(toks)
    assert agree / total >= 0.5, agree / total


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b",
                                  "qwen3-moe-235b-a22b", "qwen2-vl-72b"])
def test_serve_batch_runs_every_family_on_its_own_init(arch):
    res = serve_batch(arch, n_requests=3, max_batch=2, max_new=3,
                      max_len=16, device="cpu")
    assert res["tokens"] == 9 and len(res["outputs"]) == 3
    vocab = tcfg.get_smoke(arch).vocab
    assert all(0 <= t < vocab for v in res["outputs"].values() for t in v)
