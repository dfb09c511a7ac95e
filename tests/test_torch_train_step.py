"""The port's train step (``repro_torch.launch.steps``) against the
reference's, family by family, and the training driver.

Each case builds one architecture's smoke configuration in both packages
on the reference's weights (``jax.random.key(1)``, carried across by
``repro_torch.convert.model_params``) and the reference's AdamW state
(carried by ``convert.opt_state``), and one numpy-seeded batch (B = 2,
S = 32); it runs the reference's ``make_train_step`` under ``jax.jit`` and
the port's eagerly, once per module.  ``TrainConfig(warmup_steps=2)`` so
that the first step's learning rate is not tiny.

Bounds (both packages run bf16 weights and activations, and their bf16
roundings fall in different places; a float32 port run puts the
reference and the port equally far from it):

* ``loss`` and ``ce`` within ``LOSS_RTOL``; ``lr`` exact; ``grad_norm``
  within ``GNORM_RTOL``.
* every leaf of ``m`` (0.1 x the clipped gradient: the whole model's
  gradient) within a relative L2 distance of ``BOUND[family]``, and of
  ``v`` (0.05 x its square, so twice the relative error) within twice
  that.  The bounds are about 1.5x the largest distance measured on these
  inputs (dense 0.011, vlm 0.010, moe 0.020, ssm 0.031, hybrid 0.084,
  enc-dec 0.013).  The recurrent families' SSD products compound bf16
  noise over the sequence: at the hybrid's shared block the reference and
  the port are each about 0.05-0.1 from a float32 run of the port.  With
  ``grad_compress`` a small gradient difference can move an entry by one
  int8 step of its tensor's scale (0.021 measured, bound ``COMPRESS``).
* every updated bf16 parameter within ``2 lr`` (a gradient entry near 0
  may take the other sign, and the first AdamW step moves each entry by
  at most ``lr`` besides the decay both apply) plus half a bf16 spacing of
  each result (at most ``2**-7`` of the larger).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.configs.base import TrainConfig as RTrainConfig
from repro.launch.steps import cross_entropy as r_cross_entropy
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import build_model as r_build_model
from repro.optim import adamw_init as r_adamw_init

from repro_torch import configs as tcfg
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import model_params, opt_state
from repro_torch.launch.steps import cross_entropy, make_train_step
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.optim import adamw_init

from torch_lm_common import one_thread  # noqa: F401 (autouse fixture)

FAMILIES = {"dense": "gemma-2b", "vlm": "qwen2-vl-72b",
            "moe": "qwen3-moe-235b-a22b", "ssm": "mamba2-370m",
            "hybrid": "zamba2-2.7b", "encdec": "whisper-base"}
LOSS_RTOL, GNORM_RTOL = 1e-3, 2e-2
BOUND = {"dense": 0.02, "vlm": 0.02, "moe": 0.03, "encdec": 0.02,
         "ssm": 0.05, "hybrid": 0.12}
COMPRESS = 0.03
B, S = 2, 32


def _configs(arch):
    cfg, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
    if cfg.family == "moe":  # no expert overflows (tests/torch_lm_common.py)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        tc = dataclasses.replace(tc, capacity_factor=8.0)
    return cfg, tc


def _batches(cfg, b, s):
    rng = np.random.default_rng(0)
    ref = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (b, s)),
                                 jnp.int32),
           "labels": jnp.asarray(rng.integers(0, cfg.vocab, (b, s)),
                                 jnp.int32)}
    if cfg.family == "encdec":
        ref["frames"] = jnp.asarray(rng.normal(size=(b, s, cfg.d_model))
                                    * 0.1, jnp.bfloat16)
    if cfg.family == "vlm":
        ref["vision_embeds"] = jnp.asarray(
            rng.normal(size=(b, 8, cfg.d_model)) * 0.1, jnp.bfloat16)
    port = model_params(jax.tree.map(np.asarray, ref), device="cpu")
    return ref, port


@functools.lru_cache(maxsize=None)
def step_pair(arch, b=B, s=S, **train):
    """One train step of both packages from one state: (reference
    (params, opt, metrics), port (params, opt, metrics), lr)."""
    cfg, tc = _configs(arch)
    ref = r_build_model(cfg)
    params = jax.jit(lambda key: ref.init(key)[0])(jax.random.key(1))
    ropt = r_adamw_init(params)
    jb, tb = _batches(cfg, b, s)
    kw = dict(warmup_steps=2, **train)
    want = jax.jit(r_make_train_step(ref, RTrainConfig(**kw)))(params, ropt,
                                                              jb)
    np_tree = jax.tree.map(np.asarray, (params, ropt))
    tparams = model_params(np_tree[0], device="cpu")
    topt = opt_state(np_tree[1], device="cpu")
    port = build_model(tc, device="cpu")
    got = make_train_step(port, TrainConfig(**kw))(tparams, topt, tb)
    return jax.tree.map(np.asarray, want), got


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def check_step(pair, bound):
    """The module docstring's bounds on one pair of steps."""
    (rp, ropt, rm), (tp, topt, tm) = pair
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert float(tm["lr"]) == float(rm["lr"])
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=GNORM_RTOL)
    assert int(topt.step) == int(ropt.step) == 1
    lr = float(rm["lr"])
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(rp)]
    for name, mine, theirs, most in (("m", topt.m, ropt.m, bound),
                                     ("v", topt.v, ropt.v, 2 * bound)):
        for path, a, b in zip(paths, _flatten(mine)[0],
                              jax.tree_util.tree_leaves(theirs)):
            err = _rel_l2(_np(a), _np(b))
            assert err < most, (name, path, err)
    for path, a, b in zip(paths, _flatten(tp)[0],
                          jax.tree_util.tree_leaves(rp)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, path
        slack = 2 * lr + np.maximum(np.abs(a), np.abs(b)) * 2.0**-7 + 1e-12
        assert np.all(np.abs(a - b) <= slack), (path, np.abs(a - b).max())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(family):
    pair = step_pair(FAMILIES[family])
    check_step(pair, BOUND[family])
    assert all(np.isfinite(_np(a)).all() for a in _flatten(pair[1][0])[0])


@pytest.mark.parametrize("train, bound",
                         [(dict(microbatches=2), BOUND["dense"]),
                          (dict(grad_compress=True), COMPRESS)],
                         ids=["microbatches2", "grad_compress"])
def test_train_step_options_match_reference(train, bound):
    check_step(step_pair("gemma-2b", **train), bound)


def test_chunked_attention_train_step():
    """S = 1,024 = FLASH_MIN_SEQ: every layer runs the chunked attention's
    forward and its backward (``models/flash.py``) in both packages."""
    check_step(step_pair("gemma-2b", b=1, s=1024), BOUND["dense"])


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 9, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (2, 9)).astype(np.int32)
    want = float(r_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.as_tensor(logits),
                              torch.as_tensor(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the label gather's gradient is the one-hot contraction's
    g_ref = np.asarray(jax.grad(r_cross_entropy)(jnp.asarray(logits),
                                                 jnp.asarray(labels)))
    t = torch.tensor(logits, requires_grad=True)
    cross_entropy(t, torch.as_tensor(labels)).backward()
    np.testing.assert_allclose(t.grad.numpy(), g_ref, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-moe-235b-a22b",
                                  "zamba2-2.7b", "whisper-base"])
def test_remat_changes_nothing(arch):
    """remat none, full and dots: the same loss, gradient norm and
    moments, bit for bit (recomputation replays the same ops)."""
    _, tc = _configs(arch)
    model = build_model(tc, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, batch = _batches(rcfg.get_smoke(arch), B, S)
    runs = {}
    for remat in ("none", "full", "dots"):
        step = make_train_step(model, TrainConfig(remat=remat))
        p, opt, m = step(params, adamw_init(params), batch)
        runs[remat] = (float(m["loss"]), float(m["grad_norm"]),
                       _flatten(opt.m)[0], _flatten(p)[0])
    for remat in ("full", "dots"):
        assert runs[remat][:2] == runs["none"][:2], remat
        for a, b in zip(runs[remat][2] + runs[remat][3],
                        runs["none"][2] + runs["none"][3]):
            assert torch.equal(a, b), remat


def test_donated_step_updates_in_place():
    """``donate=True`` writes the new parameters and moments into the given
    tensors, with the values of the functional step."""
    _, tc = _configs("gemma-2b")
    model = build_model(tc, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, batch = _batches(rcfg.get_smoke("gemma-2b"), B, S)
    want_p, want_o, _ = make_train_step(model, TrainConfig())(
        params, adamw_init(params), batch)
    opt = adamw_init(params)
    got_p, got_o, _ = make_train_step(model, TrainConfig(), donate=True)(
        params, opt, batch)
    assert got_p["embed"]["table"] is params["embed"]["table"]
    assert got_o.m["embed"]["table"] is opt.m["embed"]["table"]
    for a, b in zip(_flatten((got_p, got_o.m, got_o.v))[0],
                    _flatten((want_p, want_o.m, want_o.v))[0]):
        assert torch.equal(a, b)


def test_train_loop_with_failures(tmp_path, capsys):
    """A short run on the CPU with a crash at step 4 and a straggling step
    at step 8: finite losses, one restart, and the straggler counted, as
    the reference's ``train_loop`` counts them (the step after the
    checkpoint at 3 runs twice, so 13 steps run).

    torch runs on one intra-op thread here: the straggler detection times
    each step against the median of the ones before, and a pool of threads
    over cores shared with other busy processes stretched steps of these
    small tensors several times over (no straggler seen, or three in a row
    taken for a persistent one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = train_loop("gemma-2b", steps=12, batch=4, seq=32,
                         ckpt_dir=str(tmp_path), ckpt_every=3,
                         inject_failures=True, log_every=4, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res["steps"] == 13 and res["restarts"] == 1
    assert res["straggler_events"] >= 1
    assert math.isfinite(res["loss_first10"])
    assert math.isfinite(res["loss_last10"])
    out = capsys.readouterr().out
    assert "[train] step=   4 loss=" in out
    assert "restarts=1" in out
