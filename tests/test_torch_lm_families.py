"""The port's LM serving path for the attention families (dense gemma-2b,
dense gemma3-4b with its rotating window caches, moe and vlm) against the
JAX package on the CPU: ``forward``, ``prefill`` (logits and every cache
leaf), ``decode_step`` after it, prefill + decode against forward, and
``make_prefill_step``; then every registry configuration's parameter tree
and its bf16 carry-across.

Each architecture's reference outputs are computed once, by a
module-scoped fixture (``tests/torch_lm_common.py``, which states the
tolerances and where they come from).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.models import build_model as ref_build_model

from repro_torch import configs as tcfg
from repro_torch.convert import model_params
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import build_model

from torch_lm_common import (S, as_np, batches, caches_agree, configs,
                             family_run, logits_agree, one_thread, prefix,
                             ref_init, ref_prefill, to_port)

ARCHS = ["gemma-2b", "gemma3-4b", "qwen3-moe-235b-a22b", "qwen2-vl-72b"]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return family_run(request.param)


def test_forward_matches(run):
    fam = run["cfg"].family
    logits_agree(run["port_fwd"], run["ref_fwd"], fam, "forward")
    assert run["port_fwd"].dtype == torch.float32
    np.testing.assert_allclose(float(run["port_aux"]), float(run["ref_aux"]),
                               rtol=1e-3, atol=1e-6)


def test_prefill_logits_match(run):
    assert run["port_pre"].shape == (2, run["cfg"].vocab_padded)
    logits_agree(run["port_pre"], run["ref_pre"], run["cfg"].family,
                 "prefill")


def test_prefill_cache_matches(run):
    """Every leaf: per-layer K/V (window-sized and rotated on gemma3's
    local layers), stored positions, ``len``."""
    n = caches_agree(run["port_cache"], run["ref_cache"], "prefill cache")
    assert n == 3 * run["cfg"].n_layers + 1


def test_decode_after_prefill_matches(run):
    logits_agree(run["port_dec"], run["ref_dec"], run["cfg"].family,
                 "decode")
    caches_agree(run["port_cache_dec"], run["ref_cache_dec"], "decode cache")


def test_prefill_then_decode_equals_forward(run):
    """``tests/test_serving_parity.py``'s contract on the port alone: the
    decode of token S after a prefill of S tokens is the forward's last
    position."""
    fam = run["cfg"].family
    logits_agree(run["port_dec"], run["port_fwd"][:, -1], fam, "serving")
    if fam != "moe":
        assert (as_np(run["port_dec"]).argmax(-1)
                == as_np(run["port_fwd"][:, -1]).argmax(-1)).all()


def test_forward_unroll_and_remat_change_nothing(run):
    """The layers run as a loop either way; remat matters to training
    memory only.  An unknown remat policy is refused, as the reference's
    ``_maybe_remat`` refuses it."""
    port, tp, tb = run["port"], run["tparams"], run["tb"]
    a, _ = port.forward(tp, tb, unroll=True, remat="full")
    assert torch.equal(a, run["port_fwd"])
    with pytest.raises(ValueError):
        port.forward(tp, tb, remat="everything")


def test_forward_return_hidden_unembeds_to_the_logits(run):
    from repro_torch.models.layers import unembed

    hidden, _ = run["port"].forward(run["tparams"], run["tb"],
                                    return_hidden=True)
    assert hidden.dtype == torch.bfloat16
    assert torch.equal(unembed(run["tparams"]["embed"], hidden,
                               run["tc"]), run["port_fwd"])


def test_make_prefill_step_is_prefill(run):
    step = make_prefill_step(run["port"])
    logits, cache = step(run["tparams"], prefix(run["tb"], S))
    want, cache_want = run["port"].prefill(run["tparams"],
                                           prefix(run["tb"], S))
    assert torch.equal(logits, want) and cache["len"] == S
    assert torch.is_inference(logits)


# ------------------------------------------- gemma3's rotating layout
@pytest.mark.parametrize("max_len", [None, 16, 40])
def test_gemma3_prefill_layout_and_decode_past_it(max_len):
    """Prefill of S = 24 tokens into gemma3's caches (local layers: window
    8 < S, so each keeps its last 8 positions at ``slot == pos % 8``):
    max_len None (the identity layout: the full cache is exactly the
    prompt), 16 (the global layers keep only their last 16) and 40; then
    12 teacher-forced steps past it, the slots rotating, against the
    reference."""
    cfg, tc = configs("gemma3-4b")
    ref = ref_build_model(cfg)
    params = ref_init(ref, 6)
    port = build_model(tc, device="cpu")
    tp = to_port(params)
    jb, tb = batches(cfg, s=S + 12)
    want, jc = ref_prefill(ref, max_len)(params, prefix(jb, S))
    got, tcache = port.prefill(tp, prefix(tb, S), max_len=max_len)
    logits_agree(got, want, "dense", "prefill")
    caches_agree(tcache, jax.tree.map(np.asarray, jc), "layout")
    step = jax.jit(ref.decode_step)
    for s in range(S, S + 12):
        want, jc = step(params, jc, jb["tokens"][:, s:s + 1])
        got, tcache = port.decode_step(tp, tcache, tb["tokens"][:, s:s + 1])
        logits_agree(got, want, "dense", ("step", s))
    caches_agree(tcache, jax.tree.map(np.asarray, jc), "after decode")


def test_vlm_positions_and_vision_splice():
    """qwen2-vl: the first 8 rows of the input are the vision embeddings,
    explicit M-RoPE positions [3, B, S] move the logits, and the default
    positions are the text stream thrice."""
    cfg, tc = configs("qwen2-vl-72b")
    port = build_model(tc, device="cpu")
    tp = to_port(ref_init(ref_build_model(cfg), 7))
    _, tb = batches(cfg)
    x, pos = port._embed_inputs(tp, tb)
    assert torch.equal(x[:, :8], tb["vision_embeds"])
    assert pos.shape == (3, 2, S + 1) and torch.equal(pos[0], pos[2])
    moved = dict(tb, positions=torch.stack([pos[0], pos[1] // 2,
                                            pos[2] // 3]))
    a, _ = port.forward(tp, tb)
    b, _ = port.forward(tp, moved)
    assert not torch.equal(a, b)


# ----------------------------------------------- every configuration
@pytest.mark.parametrize("arch", rcfg.list_archs())
def test_every_registry_config_builds(arch):
    """``build_model`` takes every family at its published configuration;
    at smoke size its ``init`` gives the JAX tree's keys, shapes and
    dtypes."""
    assert build_model(tcfg.get_config(arch), device="cpu").cfg.name
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
        assert tuple(t.shape) == leaf.shape, (path, t.shape, leaf.shape)
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "mamba2-370m",
                                  "zamba2-2.7b", "whisper-base",
                                  "qwen2-vl-72b", "dbrx-132b"])
def test_model_params_carries_every_family_bit_for_bit(arch):
    """bf16 leaves bit for bit, the MoE router's f32 exactly."""
    params = ref_init(ref_build_model(rcfg.get_smoke(arch)), 3)
    np_tree = jax.tree.map(np.asarray, params)
    tp = model_params(np_tree, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        if leaf.dtype == np.float32:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), leaf)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16))


def test_unknown_family_is_refused():
    cfg = dataclasses.replace(tcfg.get_smoke("gemma-2b"), family="rnn")
    with pytest.raises(ValueError, match="family"):
        build_model(cfg, device="cpu")
