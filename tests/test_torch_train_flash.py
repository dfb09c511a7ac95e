"""The chunked attention's backward (``repro_torch.models.flash``'s
``FlashAttention``) against ``jax.grad`` of the reference's
``repro.models.flash.flash_attention`` (its ``custom_vjp``), and against
autograd through a plain dense masked softmax in f32.

Cases: the five of ``tests/test_flash.py``'s ``CASES``, its packed-positions
case (positions restart mid-row), and a case with dead key slots
(``kpos = -1``) and a window.  The loss is ``sum(out ** 2)``, as
``tests/test_flash.py::test_flash_grads``'s; the tolerance is its own,
``atol = rtol = 3e-4``.  Each reference gradient is computed once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import flash_attention as r_flash

from repro_torch.models import flash as tflash
from repro_torch.models.flash import flash_attention

from torch_flash_common import dense_plain

TOL = dict(atol=3e-4, rtol=3e-4)  # tests/test_flash.py:73
# b, sq, t, h, kv, hd, causal, window, cq, ck (tests/test_flash.py CASES)
CASES = [
    (2, 16, 16, 4, 2, 8, True, 0, 4, 8),
    (1, 32, 32, 4, 1, 16, True, 10, 8, 8),
    (2, 24, 24, 6, 6, 8, False, 0, 8, 8),
    (2, 16, 48, 4, 2, 8, True, 0, 16, 16),
    (1, 64, 64, 2, 2, 4, True, 7, 16, 32),
]
NAMES = [f"case{i}" for i in range(len(CASES))] + ["packed", "dead_slots"]


def _inputs(name):
    """(q, k, v, qpos, kpos, window, causal, cq, ck) as f32/int32 numpy."""
    rng = np.random.default_rng(17)
    if name == "packed":  # tests/test_flash.py::test_flash_packed_positions
        b, sq, h, kv, hd = 1, 32, 2, 2, 8
        pos = np.concatenate([np.arange(16), np.arange(16)])[None]
        qpos = kpos = pos.astype(np.int32)
        t, window, causal, cq, ck = sq, 0, True, 8, 8
    elif name == "dead_slots":
        b, sq, t, h, kv, hd = 2, 16, 32, 4, 2, 8
        qpos = np.broadcast_to(np.arange(sq)[None] + 16, (b, sq))
        kpos = np.broadcast_to(np.arange(t)[None], (b, t)).copy()
        kpos[0, 3:9] = -1
        kpos[1, 20:24] = -1
        qpos, kpos = qpos.astype(np.int32), kpos.astype(np.int32)
        window, causal, cq, ck = 12, True, 4, 8
    else:
        b, sq, t, h, kv, hd, causal, window, cq, ck = CASES[int(name[4:])]
        qpos = np.broadcast_to(np.arange(sq)[None] + (t - sq),
                               (b, sq)).astype(np.int32)
        kpos = np.broadcast_to(np.arange(t)[None], (b, t)).astype(np.int32)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    return q, k, v, qpos, kpos, window, causal, cq, ck


@functools.lru_cache(maxsize=None)
def ref_grads(name):
    q, k, v, qpos, kpos, window, causal, cq, ck = _inputs(name)
    hd = q.shape[-1]
    w = jnp.asarray(window, jnp.int32)

    def loss(q, k, v):
        out = r_flash(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos), w,
                      causal, hd**-0.5, cq, ck)
        return jnp.sum(out**2)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    return tuple(np.asarray(g) for g in grads)


def port_grads(name, attention=flash_attention, dtype=torch.float32):
    q, k, v, qpos, kpos, window, causal, cq, ck = _inputs(name)
    hd = q.shape[-1]
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (q, k, v)]
    qp, kp = torch.as_tensor(qpos), torch.as_tensor(kpos)
    if attention is flash_attention:
        out = flash_attention(*leaves, qp, kp, window, causal, hd**-0.5, cq,
                              ck)
    else:
        out = attention(*leaves, qp, kp, window, causal, hd**-0.5)
    grads = torch.autograd.grad((out.float()**2).sum(), leaves)
    return tuple(g.float().numpy() for g in grads)


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_reference(name):
    for got, want, label in zip(port_grads(name), ref_grads(name), "qkv"):
        np.testing.assert_allclose(got, want, err_msg=f"d{label}", **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_dense_plain(name):
    for got, want, label in zip(port_grads(name),
                                port_grads(name, attention=dense_plain),
                                "qkv"):
        np.testing.assert_allclose(got, want, err_msg=f"d{label}", **TOL)


def test_bf16_grads_in_input_dtype():
    """bf16 inputs: gradients come back in bf16, within bf16 rounding of the
    f32 plain version's on the same (bf16-valued) inputs."""
    q, k, v, qpos, kpos, window, causal, cq, ck = _inputs("case1")
    leaves = [torch.tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    qp, kp = torch.as_tensor(qpos), torch.as_tensor(kpos)
    out = flash_attention(*leaves, qp, kp, window, causal, 0.25, cq, ck)
    grads = torch.autograd.grad((out.float()**2).sum(), leaves)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    ref = [a.detach().float().requires_grad_() for a in leaves]
    want = torch.autograd.grad(
        (dense_plain(*ref, qp, kp, window, causal, 0.25)**2).sum(), ref)
    for g, w in zip(grads, want):
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) < 0.02 * scale


def test_backward_visits_the_forward_tiles(monkeypatch):
    """The backward recomputes exactly the score tiles the forward computed:
    the same number of ``_attend`` calls on the same row and key ranges."""
    calls = []
    inner = tflash._attend

    def counting(q_blk, k_blk, qp, kp, *rest):
        calls.append((tuple(qp[0, [0, -1]].tolist()),
                      tuple(kp[0, [0, -1]].tolist())))
        return inner(q_blk, k_blk, qp, kp, *rest)

    monkeypatch.setattr(tflash, "_attend", counting)
    q, k, v, qpos, kpos, window, causal, cq, ck = _inputs("case4")
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    qp, kp = torch.as_tensor(qpos), torch.as_tensor(kpos)
    out = flash_attention(*leaves, qp, kp, window, causal, 0.5, cq, ck)
    forward = list(calls)
    calls.clear()
    (out**2).sum().backward()
    assert calls == forward and len(forward) > 0
    live = tflash.TileTable(qp, kp, cq, ck).live(window, causal)
    assert not live.all()  # the window skips tiles on this case
