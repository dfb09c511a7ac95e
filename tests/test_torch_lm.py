"""The port's LM decode path (``repro_torch.configs``, ``models`` and
``launch``) against the JAX package on the CPU.

Parameters come from the JAX package's own init and are carried across
with ``repro_torch.convert.model_params``; every other input is made with
numpy from a seed and handed to both.  Tolerances, with their reasons:

* bf16 outputs of one layer function: ``rtol=atol=1.6e-2`` (two bf16 ulps
  at |x| ~ 1): both compute in f32 and round once to bf16, but matrix
  products and reductions sum in other orders, which can move a value
  across a rounding boundary.
* ``attn_decode`` and whole decode steps: within ``0.05 * max|ref|``, the
  bound of ``tests/test_serving_parity.py``: the reference rounds the
  attention probabilities to bf16 before the p.v product
  (``attention.py:101``) where B5 and its plain version stay in f32, and
  bf16 roundings compound over the layers.  Argmax must agree wherever the
  reference's top-two margin exceeds twice that bound.
* ``serve_batch``: its schedule (steps, token counts, request ids) depends
  on nothing numeric and must be equal; generated tokens agree on at least
  half the positions, the repo's bar for bf16 argmax flips
  (``tests/test_serving_parity.py:71``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import attention as ratt
from repro.models import build_model as ref_build_model
from repro.models import layers as rl
from repro.models.param import Mk as RMk
from repro.models.param import split

from repro_torch import configs as tcfg
from repro_torch.convert import model_params
from repro_torch.kernels.decode_attn import decode_attention_plain
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import attention as tatt
from repro_torch.models import build_model
from repro_torch.models import layers as tl

DENSE = ["gemma-2b", "gemma3-4b", "h2o-danube-1.8b"]
BF16_TOL = dict(atol=1.6e-2, rtol=1.6e-2)
REL_BOUND = 0.05  # tests/test_serving_parity.py:73


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


def _within_bound(got, ref, label):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err < REL_BOUND * scale, (label, err, scale)
    return scale


def _argmax_agrees(got, ref, scale, label):
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * REL_BOUND * scale
    same = got.argmax(-1) == ref.argmax(-1)
    assert same[sure].all(), (label, np.flatnonzero(sure & ~same))


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", rcfg.list_archs())
def test_configs_equal_the_reference(arch):
    assert tcfg.list_archs() == rcfg.list_archs()
    for get in ("get_config", "get_smoke"):
        a = dataclasses.asdict(getattr(rcfg, get)(arch))
        b = dataclasses.asdict(getattr(tcfg, get)(arch))
        assert a == b, (arch, get)
    assert (tcfg.get_config(arch).param_count()
            == rcfg.get_config(arch).param_count())


def test_shapes_equal_the_reference():
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in rcfg.SHAPES.items()})


# ------------------------------------------------------------- layers
def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 3, 64)))
    wj, wt = _pair(rng.normal(size=(64,)) * 0.1)
    np.testing.assert_allclose(_np(tl.rmsnorm(xt, wt)),
                               _np(rl.rmsnorm(xj, wj)), **BF16_TOL)


def test_residual_add_matches_bit_for_bit():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 1, 64)))
    hj, ht = _pair(rng.normal(size=(2, 1, 64)))
    got = tl.residual_add(xt, ht)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(rl.residual_add(xj, hj)))


@pytest.mark.parametrize("arch", ["gemma-2b", "h2o-danube-1.8b"])
def test_mlp_matches(arch):
    """GeGLU (gemma, tanh-approximate gelu) and SwiGLU (danube)."""
    cfg = rcfg.get_smoke(arch)
    p = _init(lambda mk: rl.init_mlp(mk, cfg))
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(size=(2, 1, cfg.d_model)))
    got = tl.mlp(_to_port(p), xt, tcfg.get_smoke(arch))
    np.testing.assert_allclose(_np(got), _np(rl.mlp(p, xj, cfg)), **BF16_TOL)


def test_embed_matches_with_bf16_scale():
    """gemma's sqrt(d) scale is a bf16 constant: 45.25 at d=2048."""
    cfg = dataclasses.replace(rcfg.get_smoke("gemma-2b"), d_model=2048)
    p = _init(lambda mk: rl.init_embedding(mk, cfg))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 1))
    got = tl.embed(_to_port(p), torch.from_numpy(tokens),
                   dataclasses.replace(tcfg.get_smoke("gemma-2b"), d_model=2048))
    want = rl.embed(p, jnp.asarray(tokens), cfg)
    np.testing.assert_array_equal(_np(got), _np(want))
    table = _np(_to_port(p)["table"])[tokens]
    np.testing.assert_array_equal(_np(got), _np(
        torch.from_numpy(table).to(torch.bfloat16) * 45.25))


@pytest.mark.parametrize("vocab", [256, 250])
def test_unembed_matches_in_f32(vocab):
    """f32 logits of the bf16 product; padded vocab columns at -1e30."""
    cfg = dataclasses.replace(rcfg.get_smoke("gemma-2b"), vocab=vocab)
    p = _init(lambda mk: rl.init_embedding(mk, cfg))
    xj, xt = _pair(np.random.default_rng(4).normal(size=(3, cfg.d_model)))
    got = tl.unembed(_to_port(p), xt,
                     dataclasses.replace(tcfg.get_smoke("gemma-2b"), vocab=vocab))
    want = rl.unembed(p, xj, cfg)
    assert got.dtype == torch.float32 and got.shape == (3, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    assert (got[:, vocab:] == -1e30).all()


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_matches(theta):
    pos = np.random.default_rng(5).integers(0, 4096, (2, 3)).astype(np.int32)
    cj, sj = rl.rope(jnp.asarray(pos), 16, theta)
    ct, st = tl.rope(torch.from_numpy(pos), 16, theta)
    np.testing.assert_allclose(ct.numpy(), _np(cj), atol=2e-4, rtol=0)
    np.testing.assert_allclose(st.numpy(), _np(sj), atol=2e-4, rtol=0)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng.normal(size=(2, 3, 4, 16)))
    pos = rng.integers(0, 512, (2, 3)).astype(np.int32)
    got = tl.apply_rope(xt, torch.from_numpy(pos), theta)
    want = rl.apply_rope(xj, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# ---------------------------------------------------------- attention
@pytest.mark.parametrize("arch,window", [("gemma-2b", 0), ("gemma3-4b", 8),
                                         ("gemma3-4b", 0),
                                         ("h2o-danube-1.8b", 8)])
def test_attn_decode_matches(arch, window):
    """Steps past the cache length (window layers rotate their slots),
    qk-norm on gemma3; the same slots written, outputs within the bound."""
    cfg = rcfg.get_smoke(arch)
    tc = tcfg.get_smoke(arch)
    p = _init(lambda mk: ratt.init_attention(mk, cfg), seed=2)
    tp = _to_port(p)
    B, T = 2, (window or 16)
    jc = ratt.init_kv_cache(B, T, cfg)
    tcache = tatt.init_kv_cache(B, T, tc, "cpu")
    rng = np.random.default_rng(7)
    for step in range(T + 5):
        xj, xt = _pair(rng.normal(size=(B, 1, cfg.d_model)))
        pos = np.full((B, 1), step, np.int32)
        want, jc = ratt.attn_decode(p, xj, jc, cfg, jnp.asarray(pos), window)
        got, tcache = tatt.attn_decode(tp, xt, tcache, tc,
                                       torch.from_numpy(pos), window)
        _within_bound(_np(got), _np(want), (arch, step))
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(_np(tcache.k), _np(jc.k), **BF16_TOL)
    np.testing.assert_allclose(_np(tcache.v), _np(jc.v), **BF16_TOL)


def test_attn_decode_through_plain_equals_kernel_route_on_cpu():
    """On the CPU B5's wrapper is its plain version: routing a layer
    through either gives the same output."""
    cfg = tcfg.get_smoke("gemma3-4b")
    p = _to_port(_init(lambda mk: ratt.init_attention(mk, cfg), seed=3))
    a = tatt.init_kv_cache(2, 8, cfg, "cpu")
    b = tatt.init_kv_cache(2, 8, cfg, "cpu")
    rng = np.random.default_rng(8)
    for step in range(10):
        x = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model))).to(
            torch.bfloat16)
        pos = torch.full((2, 1), step, dtype=torch.int32)
        oa, a = tatt.attn_decode(p, x, a, cfg, pos, 8)
        ob, b = tatt.attn_decode(p, x, b, cfg, pos, 8,
                                 attend=decode_attention_plain)
        assert torch.equal(oa, ob)


# ------------------------------------------------------------ convert
def test_model_params_round_trips_bf16_bit_for_bit():
    cfg = rcfg.get_smoke("gemma3-4b")
    params, _ = ref_build_model(cfg).init(jax.random.key(3))
    np_tree = jax.tree.map(np.asarray, params)
    tp = model_params(np_tree, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(np_tree)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      leaf.view(np.int16))


@pytest.mark.parametrize("arch", DENSE)
def test_model_init_matches_the_reference_tree(arch):
    """Same keys, shapes and dtypes as the JAX tree; norms zero, the rest
    fan-in-scaled normals."""
    cfg = rcfg.get_smoke(arch)
    shapes = jax.eval_shape(lambda key: ref_build_model(cfg).init(key)[0],
                            jax.random.key(0))
    tp = build_model(tcfg.get_smoke(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(want) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in want:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    assert not tp["blocks"]["ln1"]["w"].any()
    wq = tp["blocks"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5


# ---------------------------------------------------------- the model
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_teacher_forced_matches(arch):
    """Teacher-forced decode over more steps than ``max_len``: the full
    cache wraps and the window caches rotate."""
    cfg = rcfg.get_smoke(arch)
    model = ref_build_model(cfg)
    params, _ = model.init(jax.random.key(1))
    tmodel = build_model(tcfg.get_smoke(arch), device="cpu")
    tparams = _to_port(params)
    B, max_len, steps = 2, 16, 24
    cache = model.init_cache(B, max_len)
    tcache = tmodel.init_cache(B, max_len)
    step = jax.jit(model.decode_step)
    tokens = np.random.default_rng(9).integers(1, cfg.vocab, (steps, B, 1))
    for s in range(steps):
        want, cache = step(params, cache, jnp.asarray(tokens[s], jnp.int32))
        got, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.from_numpy(tokens[s]))
        assert got.dtype == torch.float32 and got.shape == want.shape
        ref = _np(want)
        scale = _within_bound(got.numpy(), ref, (arch, s))
        _argmax_agrees(got.numpy(), ref, scale, (arch, s))
    assert tcache["len"] == int(cache["len"]) == steps


def test_make_decode_step_picks_the_argmax():
    cfg = tcfg.get_smoke("gemma-2b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    cache = model.init_cache(3, 8)
    step = make_decode_step(model)
    nxt, logits, cache = step(params, cache,
                              torch.tensor([[1], [2], [3]]))
    assert nxt.shape == (3, 1) and nxt.dtype == torch.int32
    assert torch.equal(nxt[:, 0].long(), logits.argmax(-1))
    assert cache["len"] == 1


# ------------------------------------------------------------ serving
def test_serve_batch_matches_the_reference():
    """Seed 0, as ``serve.py``; the port serves the reference's own
    ``model.init(jax.random.key(0))`` weights."""
    cfg = rcfg.get_smoke("gemma-2b")
    params, _ = ref_build_model(cfg).init(jax.random.key(0))
    want = ref_serve_batch("gemma-2b", seed=0)
    got = serve_batch("gemma-2b", seed=0, device="cpu",
                      params=_to_port(params))
    for key in ("arch", "requests", "tokens", "decode_steps"):
        assert got[key] == want[key], key
    assert sorted(got["outputs"]) == sorted(want["outputs"])
    agree = total = 0
    for rid, toks in want["outputs"].items():
        assert len(got["outputs"][rid]) == len(toks)
        agree += sum(a == b for a, b in zip(got["outputs"][rid], toks))
        total += len(toks)
    assert agree / total >= 0.5, agree / total


def test_serve_batch_runs_its_own_init():
    res = serve_batch("gemma3-4b", n_requests=3, max_batch=2, max_new=4,
                      max_len=16, device="cpu")
    assert res["tokens"] == 12 and len(res["outputs"]) == 3
    assert all(0 <= t < 256 for v in res["outputs"].values() for t in v)


def test_serve_batch_needs_a_card_by_default():
    """Without ``device=`` the serve path wants the card and never carries
    on on the CPU by itself."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_batch("gemma-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tcfg.get_smoke("gemma-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_params({"a": np.zeros(2, np.float32)})
