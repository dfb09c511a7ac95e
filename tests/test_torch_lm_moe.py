"""The port's single-card MoE FFN (``repro_torch.models.moe``) against the
JAX package's ``moe_ffn`` on the CPU: the dispatch indices equal exactly
(the stable sort by expert, the slots, the capacity drops), the outputs
within ``rtol=atol=1.6e-2`` plus one bf16 ulp of the output's scale (the
expert products are bf16 batched matrix products that sum in other orders
in the two packages, ``tests/test_torch_lm.py``'s bf16 tolerance), the
load-balance loss within ``rtol=1e-5`` (f32 sums in other orders).  Ties in
the router go to the lower expert index, as ``lax.top_k`` sends them, and
each token's k expert outputs are added in ascending expert order, the
reference's scatter order, in the same bits every time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.models import moe as rmoe
from repro.models.param import Mk as RMk
from repro.models.param import split

from repro_torch import configs as tcfg
from repro_torch.models import moe as tmoe

from torch_lm_common import one_thread, as_np, to_port

ARCH = "qwen3-moe-235b-a22b"


def _setup(cf: float, seed: int, tokens=(2, 25)):
    cfg = dataclasses.replace(rcfg.get_smoke(ARCH), capacity_factor=cf)
    tc = dataclasses.replace(tcfg.get_smoke(ARCH), capacity_factor=cf)
    p = split(rmoe.init_moe(RMk(jax.random.key(seed)), cfg))[0]
    x = jnp.asarray(np.random.default_rng(seed).normal(
        size=tokens + (cfg.d_model,)), jnp.bfloat16)
    return cfg, tc, p, to_port(p), x, to_port({"x": x})["x"]


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5], ids=["lossless", "default",
                                                      "dropping"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_ffn_dispatch_equal_and_values_match(cf, seed):
    cfg, tc, p, tp, x, tx = _setup(cf, seed)
    t = x.shape[0] * x.shape[1]
    cap = rmoe.moe_capacity(t, cfg)
    assert tmoe.moe_capacity(t, tc) == cap
    _, jd, jaux = rmoe._route(x.reshape(t, -1), p["router"], cfg, cap)
    _, td, taux = tmoe._route(tx.reshape(t, -1), tp["router"], tc, cap)
    for name, a, b in zip(("se_c", "slot_c", "stok", "keep"), jd[:4], td[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_allclose(td[4].numpy(), np.asarray(jd[4]), rtol=1e-5,
                               atol=1e-7)  # the gates
    if cf < 1:
        assert not td[3].all()  # the capacity drops some assignments
    y, aux = rmoe.moe_ffn(p, x, cfg)
    ty, taux = tmoe.moe_ffn(tp, tx, tc)
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    scale = float(np.abs(as_np(y)).max())
    np.testing.assert_allclose(as_np(ty), as_np(y), rtol=1.6e-2,
                               atol=1.6e-2 + scale / 128)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    vals, idx = tmoe._top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2], [0, 1], [0, 2]]


def test_unroute_adds_by_ascending_expert_in_fixed_bits():
    """The combine is a sequence of bf16 adds, expert by ascending id, the
    same bits on every call."""
    cfg, tc, p, tp, x, tx = _setup(8.0, 2, tokens=(1, 6))
    t, d = 6, x.shape[-1]
    cap = tmoe.moe_capacity(t, tc)
    bucket, disp, _ = tmoe._route(tx.reshape(t, d), tp["router"], tc, cap)
    out = torch.randn(bucket.shape, generator=torch.Generator().manual_seed(0)
                      ).to(torch.bfloat16)
    y = tmoe._unroute(out, disp, t, d, torch.bfloat16)
    assert torch.equal(y, tmoe._unroute(out, disp, t, d, torch.bfloat16))
    se_c, slot_c, stok, keep, sgate, order, expert_idx = disp
    for tok in range(t):
        rows = sorted((int(e), i) for i, (e, s) in enumerate(zip(se_c, stok))
                      if int(s) == tok)
        want = torch.zeros(d, dtype=torch.bfloat16)
        for e, i in rows:
            want = want + out[se_c[i], slot_c[i]] * sgate[i].to(torch.bfloat16)
        assert torch.equal(y[tok], want), tok


def test_init_moe_matches_the_reference_tree():
    """The router in f32; the experts' fan-in is the expert axis, as the
    reference's ``Mk`` takes ``shape[0]``."""
    from repro_torch.models.param import Mk

    cfg, tc = rcfg.get_smoke(ARCH), tcfg.get_smoke(ARCH)
    want = split(rmoe.init_moe(RMk(jax.random.key(0)), cfg))[0]
    got = tmoe.init_moe(Mk(torch.Generator().manual_seed(0), "cpu"), tc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    e = cfg.n_experts
    assert abs(float(got["up"].float().std()) - e**-0.5) < 0.1 * e**-0.5
