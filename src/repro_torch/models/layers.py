"""Shared neural-net building blocks: the torch twin of the JAX package's
``repro/models/layers.py`` (plain functions on tensors, bf16 by default).

The reference's ``shard_ctx.constrain`` layout pins sit where it has them;
they change no value.  Parameters are nested dicts of tensors with the JAX
tree's keys, shapes and layouts: the untied head and learned positions
where a configuration asks for them, the ungated MLP (whisper) and M-RoPE
sections (qwen2-vl) beside the dense family's pieces.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .param import Mk
from .shard_ctx import constrain

__all__ = [
    "apply_rope",
    "embed",
    "init_embedding",
    "init_mlp",
    "init_rmsnorm",
    "mlp",
    "residual_add",
    "rmsnorm",
    "rope",
    "unembed",
]


def residual_add(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h`` on the residual stream, rounded to bf16.

    The reference pins ``h`` and the sum to bf16 with
    ``lax.reduce_precision`` so that XLA cannot keep them in f32 inside a
    compiled layer.  torch runs eagerly: a bf16 ``h`` is already rounded and
    a bf16 add rounds its sum, so plain bf16 arithmetic is the same.
    """
    if x.dtype != torch.bfloat16:
        return x + h
    return x + h.to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def init_rmsnorm(mk: Mk, d: int, layers: Optional[int] = None):
    # Stored as (scale - 1) like gemma/llama so zeros-init is identity.
    return {"w": mk.param((d,), ("embed",), init="zeros", layers=layers)}


def init_mlp(mk: Mk, cfg: ModelConfig, layers: Optional[int] = None):
    d, ff = cfg.d_model, cfg.d_ff
    p = {
        "up": mk.param((d, ff), ("embed", "ffn"), layers=layers),
        "down": mk.param((ff, d), ("ffn", "embed"), layers=layers),
    }
    if cfg.gated_mlp:
        p["gate"] = mk.param((d, ff), ("embed", "ffn"), layers=layers)
    return p


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP (GeGLU or SwiGLU), or the plain two-layer one
    (``gated_mlp=False``)."""
    def pin(h):  # the hidden ff-sharded x model, seq full
        return constrain(h, "dp", None, "model") if h.dim() == 3 else h

    if x.dim() == 3:
        x = constrain(x, "dp", None, None)
    up = pin(x @ p["up"])
    if cfg.gated_mlp:
        h = _act(pin(x @ p["gate"]), cfg.act) * up
    else:
        h = _act(up, cfg.act)
    return h @ p["down"]


def init_embedding(mk: Mk, cfg: ModelConfig):
    # d^-0.5 table init keeps tied-unembed logits O(1) at init (archs with
    # embed_scale multiply inputs back up by sqrt(d), gemma-style).
    p = {"table": mk.param((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                           scale=cfg.d_model**-0.5)}
    if not cfg.tie_embeddings:
        p["head"] = mk.param((cfg.d_model, cfg.vocab_padded),
                             ("embed", "vocab"), scale=cfg.d_model**-0.5)
    if cfg.pos == "learned":
        p["pos"] = mk.param((cfg.max_pos, cfg.d_model), (None, "embed"),
                            scale=0.02)
    return p


def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["table"][tokens]
    if cfg.embed_scale:
        # a constant of the activation dtype, as the reference's
        # jnp.asarray(sqrt(d), x.dtype): sqrt(2048) = 45.2548 is 45.25 in bf16
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _split_bf16(g: torch.Tensor) -> tuple:
    """f32 ``g`` as three bf16 parts ``hi + mid + lo``: each part rounds
    what the parts before it left, so together they hold g's 24 bits."""
    hi = g.bfloat16()
    rest = g - hi.float()
    mid = rest.bfloat16()
    return hi, mid, (rest - mid.float()).bfloat16()


# Reduction length of one tensor-core product in ``_mm_f32``: the tensor
# cores add each block of products into the f32 sum with a truncation, so
# their error grows with the length (3e-4 relative L2 over gemma-2b's
# 256,000-long vocabulary on an H100, 2e-6 over 2,048).
_K_CHUNK = 2048


def _mm_f32(a, b) -> torch.Tensor:
    """f32 ``a @ b`` of an f32 operand and a bf16 one: the f32 side split
    into three bf16 parts (:func:`_split_bf16`, stacked along its other
    dimension), each part's product with the bf16 side accumulated in f32
    on the tensor cores over chunks of ``_K_CHUNK`` of the reduction, the
    chunks summed in f32 and then the three parts (smallest first).  The
    bf16 x bf16 products are exact, so this is the f32 product up to
    accumulation order."""
    split_a = a.dtype == torch.float32
    if split_a:
        a = torch.cat(_split_bf16(a), dim=0)
    else:
        b = torch.cat(_split_bf16(b), dim=1)
    out = None
    for k0 in range(0, a.shape[1], _K_CHUNK):
        part = torch.mm(a[:, k0:k0 + _K_CHUNK], b[k0:k0 + _K_CHUNK],
                        out_dtype=torch.float32)
        out = part if out is None else out.add_(part)
    hi, mid, lo = out.chunk(3, dim=0 if split_a else 1)
    return hi + (mid + lo)


class _LogitsF32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=torch.float32)`` with a gradient (the
    card's ``mm`` with an output dtype has none).  As the reference's
    gradient of its f32-output einsum, the backward keeps the f32 logit
    gradient in f32 against the bf16 operands (:func:`_mm_f32`) and rounds
    only the two products to the operands' bf16 (ROADMAP §C P26)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w.T).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x2.T, g).to(w.dtype)
        return dx, dw


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits [..., V] of a bf16 product with the tied table (or the
    untied ``head``), never rounded to bf16.

    On the card ``torch.mm(..., out_dtype=torch.float32)`` accumulates in
    f32 and writes f32 from the bf16 operands, as the reference's
    ``preferred_element_type`` (:class:`_LogitsF32` gives it a gradient).
    A step traced on the meta device takes the card's route, so that its
    FLOP count and memory are the card's.  The CPU build has no such
    ``mm``: there both operands are upcast, which gives the same exact f32
    products.
    """
    table = p["table"].T if cfg.tie_embeddings else p["head"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type in ("cuda", "meta"):
        logits = _LogitsF32.apply(x2, table)
    else:
        logits = x2.float() @ table.float()
    logits = logits.reshape(*lead, -1)
    if cfg.vocab_padded > cfg.vocab:
        # Padding columns (vocab rounded up for clean TP sharding) must
        # never win the softmax/argmax.
        logits[..., cfg.vocab:] = -1e30
    return logits


def rope(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """cos/sin tables for ``positions`` [..., S] -> [..., S, dim/2]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: tuple = ()) -> torch.Tensor:
    """Rotary embedding on [..., S, H, hd].

    ``sections`` (pairs per section) enables qwen2-vl M-RoPE: ``positions``
    is then [3, ..., S] (t/h/w) and each head-dim section rotates by its own
    position stream.  Empty sections: standard 1D RoPE at positions
    [..., S].
    """
    hd = x.shape[-1]
    half = hd // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    if sections:
        assert sum(sections) == half, (sections, half)
        cos_parts, sin_parts = [], []
        for i, sec in enumerate(sections):
            lo = sum(sections[:i])
            exps = torch.arange(lo, lo + sec, dtype=torch.float32,
                                device=x.device) * 2 / hd
            freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                                    exps)
            ang = positions[i].float()[..., None] * freqs
            cos_parts.append(torch.cos(ang))
            sin_parts.append(torch.sin(ang))
        cos = torch.cat(cos_parts, -1)[..., None, :]
        sin = torch.cat(sin_parts, -1)[..., None, :]
    else:
        cos, sin = rope(positions, hd, theta)
        cos, sin = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
