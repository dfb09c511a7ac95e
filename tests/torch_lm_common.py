"""Shared set-up of the port's family parity tests
(``tests/test_torch_lm_families.py`` and ``tests/test_torch_lm_recurrent.py``).

:func:`family_run` builds one architecture's smoke configuration in both
packages on the same weights (the JAX package's ``init``, carried across
by ``repro_torch.convert.model_params``) and the same numpy-seeded batch,
then runs each package's ``forward`` over S + 1 tokens, ``prefill`` over S
tokens with ``max_len = S + 8`` and one ``decode_step`` of token S (the
reference's under ``jax.jit``, as its serving runs them): the
contract of ``tests/test_serving_parity.py``, on its shapes (B = 2, S = 24,
weights from ``jax.random.key(5)``, tokens from ``default_rng(0)``).

Tolerances (from ``tests/test_serving_parity.py`` and
``tests/test_torch_lm.py``):

* logits: within ``0.05 * max|ref|`` and the argmax equal wherever the
  reference's top-two margin exceeds twice that (``within_bound``,
  ``argmax_agrees``); the reference rounds attention probabilities to bf16
  where B5 stays in f32, and bf16 roundings compound over the layers.
* moe logits: the 90th percentile of ``|d|`` below ``0.06 * max|ref|`` and
  the argmax equal on at least half the rows: a bf16 difference can flip a
  borderline expert of one token, which moves that token's logits a lot.
* cache leaves: positions exact; K/V, SSM states and conv tails within
  ``0.05 * max|ref|`` of the leaf.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.models import build_model as ref_build_model

from repro_torch import configs as tcfg
from repro_torch.convert import model_params
from repro_torch.models import build_model

REL_BOUND = 0.05  # tests/test_serving_parity.py:73
MOE_P90_BOUND = 0.06  # tests/test_serving_parity.py:69
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run a module's small tensors on one intra-op thread (imported by each
    LM test module): smoke-size models are many tiny ops, which torch's
    thread pool only slows, and under parallel test workers its threads
    oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_port(tree):
    return model_params(jax.tree.map(np.asarray, tree), device="cpu")


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def within_bound(got, ref, label, bound=REL_BOUND):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err < bound * scale, (label, err, scale)
    return scale


def argmax_agrees(got, ref, scale, label):
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * REL_BOUND * scale
    same = got.argmax(-1) == ref.argmax(-1)
    assert same[sure].all(), (label, np.flatnonzero(sure & ~same))


def logits_agree(got, ref, family: str, label):
    """The bound of ``tests/test_serving_parity.py`` for ``family``."""
    got, ref = as_np(got), as_np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    assert np.isfinite(got).all(), label
    if family == "moe":
        scale = max(float(np.abs(ref).max()), 1.0)
        p90 = float(np.percentile(np.abs(got - ref), 90))
        assert p90 < MOE_P90_BOUND * scale, (label, p90, scale)
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.5, label
        return
    argmax_agrees(got, ref, within_bound(got, ref, label), label)


def configs(arch: str):
    """(reference config, port config): the smoke configuration, at
    capacity factor 8 for moe (parity is defined only when no expert
    overflows, ``tests/test_serving_parity.py:35``)."""
    cfg, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        tc = dataclasses.replace(tc, capacity_factor=8.0)
    return cfg, tc


def batches(cfg, s: int = S):
    """(reference batch, port batch) over s + 1 tokens: the same tokens,
    frames (enc-dec) and 8 vision embeddings (vlm), bf16 by their bits."""
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab, (B, s + 1)).astype(np.int32)
    ref = {"tokens": jnp.asarray(toks)}
    if cfg.family == "encdec":
        ref["frames"] = jnp.asarray(rng.normal(size=(B, s, cfg.d_model)) * 0.1,
                                    jnp.bfloat16)
    if cfg.family == "vlm":
        ref["vision_embeds"] = jnp.asarray(
            rng.normal(size=(B, 8, cfg.d_model)) * 0.1, jnp.bfloat16)
    port = to_port(ref)
    port["tokens"] = port["tokens"].long()
    return ref, port


def ref_init(ref, seed: int):
    """The reference model's parameters from ``jax.random.key(seed)``,
    initialised under ``jax.jit`` (the same values as an eager init; the
    reference's eager op-by-op dispatch is what makes these tests slow)."""
    return jax.jit(lambda key: ref.init(key)[0])(jax.random.key(seed))


def ref_prefill(ref, max_len):
    """The reference's ``prefill`` compiled for one ``max_len``."""
    return jax.jit(lambda params, batch: ref.prefill(params, batch,
                                                     max_len=max_len))


def prefix(batch, s: int):
    out = dict(batch)
    out["tokens"] = batch["tokens"][:, :s]
    return out


def family_run(arch: str) -> dict:
    """Both packages' forward, prefill and decode on one set of inputs."""
    cfg, tc = configs(arch)
    ref = ref_build_model(cfg)
    params = ref_init(ref, 5)
    port = build_model(tc, device="cpu")
    tparams = to_port(params)
    jb, tb = batches(cfg)
    run = dict(cfg=cfg, tc=tc, ref=ref, params=params, port=port,
               tparams=tparams, jb=jb, tb=tb)
    run["ref_fwd"], run["ref_aux"] = jax.jit(ref.forward)(params, jb)
    run["port_fwd"], run["port_aux"] = port.forward(tparams, tb)
    run["ref_pre"], ref_cache = ref_prefill(ref, S + 8)(params,
                                                         prefix(jb, S))
    run["port_pre"], port_cache = port.prefill(tparams, prefix(tb, S),
                                               max_len=S + 8)
    run["ref_cache"] = jax.tree.map(np.asarray, ref_cache)
    run["port_cache"] = clone_cache(port_cache)
    run["ref_dec"], ref_cache = jax.jit(ref.decode_step)(
        params, ref_cache, jb["tokens"][:, S:S + 1])
    run["port_dec"], port_cache = port.decode_step(tparams, port_cache,
                                                   tb["tokens"][:, S:S + 1])
    run["ref_cache_dec"] = jax.tree.map(np.asarray, ref_cache)
    run["port_cache_dec"] = port_cache
    return run


def clone_cache(cache):
    """A copy of a port cache (its attention layers are written in place
    by decode)."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return node.clone()
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(cache)


def cache_leaves(cache):
    """(path, leaf) pairs of a cache of either package, with the field
    names of its named tuples as keys."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k in node._fields:
                walk(getattr(node, k), path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(cache, ())
    return out


def caches_agree(got, want, label) -> int:
    """Every leaf of the port's cache against the reference's: the same
    paths and shapes, positions and lengths exact, values in the bound.
    Returns the number of leaves compared."""
    g, w = cache_leaves(got), cache_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], label
    for (path, a), (_, b) in zip(g, w):
        if path[-1] == "len":
            assert int(a) == int(b), (label, path)
            continue
        a, b = as_np(a), np.asarray(b)
        assert a.shape == b.shape, (label, path, a.shape, b.shape)
        if path[-1] == "pos":
            np.testing.assert_array_equal(a, b, err_msg=str((label, path)))
        else:
            within_bound(a, b.astype(np.float32), (label, path))
    return len(g)
