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
from .shard_ctx import constrain, current_mesh, seq_split

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

# The key under which a layer's tree, as ``models.model._gathered`` makes it
# under a plan, names the leaves it kept as this rank's block over 'model'
# (the plan splits their heads, ffn or vocabulary); a leaf not named there
# is whole.
MODEL_BLOCKS = "model_blocks"


def on_model_block(p, name: str) -> bool:
    """Whether leaf ``name`` of the layer tree ``p`` is this rank's block
    over 'model' (:data:`MODEL_BLOCKS`)."""
    return name in p.get(MODEL_BLOCKS, ())


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


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ b`` of bf16 operands (f32 accumulation, no rounding): the
    card's ``mm`` with an f32 output; the CPU build upcasts, which gives
    the same exact products."""
    if a.device.type in ("cuda", "meta"):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _SaveRow(torch.autograd.Function):
    """The identity on ``x2`` that saves ``(x2, w)`` for
    :class:`_RowProduct`'s backward (``box`` hands it this node).  Saved
    ahead of the product, they let activation recomputation stop before
    it: ``torch.utils.checkpoint`` stops once every saved tensor is saved
    again, a custom function saves after its forward has run, and the
    backward needs neither the product nor its sum over 'model'."""

    @staticmethod
    def forward(ctx, x2, w, box):
        ctx.save_for_backward(x2, w)
        box.append(ctx)
        return x2.view_as(x2)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _RowProduct(torch.autograd.Function):
    """This rank's f32 partial ``x2 @ w`` of a reduction split over
    'model' (bf16 operands, no rounding); its inputs are saved by
    :class:`_SaveRow`.  The backward is the plain product's, against the
    output's gradient as the bf16 sum passed it."""

    @staticmethod
    def forward(ctx, x2, w, box):
        ctx.box = box
        return _f32_product(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.box[0].saved_tensors
        g = g.to(x2.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = x2.T @ g if ctx.needs_input_grad[1] else None
        return dx, dw, None


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w 2-D) over this rank's slice of the reduction: each
    rank's partial product in f32, summed over the scope mesh's 'model'
    dim in f32 and rounded once to x's dtype (ROADMAP §C P34).  Under
    sequence parallelism (``shard_ctx.seq_split``) the sum is a
    reduce-scatter along the sequence (dim 1 of x), and each rank keeps
    its block of it."""
    from ..distributed.sharding import sum_rows

    x2 = x.reshape(-1, x.shape[-1])
    box = []
    part = _RowProduct.apply(_SaveRow.apply(x2, w, box), w, box)
    part = part.reshape(*x.shape[:-1], w.shape[-1])
    return sum_rows(part, current_mesh(), x.dtype, 1 if seq_split() else None)


def stream_inputs(x: torch.Tensor, split: bool, whole: bool = False):
    """The residual stream ``x`` as a sublayer's products take it: (the
    input of products on this rank's 'model' block where ``split``, else
    of products every rank computes whole; with ``whole`` the latter too
    beside the former).  Under sequence parallelism ``x`` is this rank's
    block of the sequence, gathered over 'model' once in its dtype: the
    gradient of the split products' input is summed over 'model' in f32
    (a reduce-scatter, one rounding), and of the whole products' this
    rank's block is kept.  Otherwise the split products' input is
    Megatron's column input (its gradient summed over 'model')."""
    from ..distributed.sharding import copy_to_model, gather, mine

    mesh = current_mesh()
    if not seq_split():
        return (copy_to_model(x, mesh) if split else x), x
    if not split:
        xw = gather(x, mesh, ("model",), 1, partial=False)
        return xw, xw
    xs = gather(x, mesh, ("model",), 1, partial=True)
    return xs, (mine(xs, mesh, 1) if whole else None)


def stream_output(y: torch.Tensor) -> torch.Tensor:
    """A sublayer output every rank computed whole, as the residual stream
    holds it: under sequence parallelism this rank's block of the
    sequence (its gradient gathered back), else ``y``."""
    if not seq_split():
        return y
    from ..distributed.sharding import split

    return split(y, current_mesh(), ("model",), 1)


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP (GeGLU or SwiGLU), or the plain two-layer one
    (``gated_mlp=False``).  With the ffn leaves a rank's block over
    'model' (a plan in scope), column-parallel up and gate and a
    row-parallel down projection."""
    def pin(h):  # the hidden ff-sharded x model, seq full
        return constrain(h, "dp", None, "model") if h.dim() == 3 else h

    if x.dim() == 3:
        x = constrain(x, "dp", None, None)
    split = on_model_block(p, "up")
    x = stream_inputs(x, split)[0]
    up = pin(x @ p["up"])
    if cfg.gated_mlp:
        h = _act(pin(x @ p["gate"]), cfg.act) * up
    else:
        h = _act(up, cfg.act)
    if split:
        return row_parallel(h, p["down"])
    return stream_output(h @ p["down"])


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


def _vocab_block(p, name: str, rows: int):
    """(mesh, first vocabulary row) of leaf ``name`` of ``p``, which holds
    ``rows`` rows of the padded vocabulary: a rank's block over 'model'
    where :func:`on_model_block` says so, else (None, 0), the whole."""
    if not on_model_block(p, name):
        return None, 0
    mesh = current_mesh()
    return mesh, rows * mesh.get_local_rank("model")


def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The table's rows of ``tokens``.  Vocab-parallel when the table is a
    rank's block over 'model': each rank looks up the tokens of its rows,
    zeroes the rest, and the ranks' rows are summed over 'model'."""
    table = p["table"]
    mesh, lo = _vocab_block(p, "table", table.shape[0])
    if mesh is None:
        x = table[tokens]
    else:
        from ..distributed.sharding import reduce_from_model

        local = tokens - lo
        mine = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(mine, local, 0)] * mine[..., None].to(
            table.dtype)
        x = reduce_from_model(x, mesh)
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
    untied ``head``), never rounded to bf16.  With the table a rank's
    block over 'model' (a plan in scope), the rank's block of the
    vocabulary's logits.

    On the card ``torch.mm(..., out_dtype=torch.float32)`` accumulates in
    f32 and writes f32 from the bf16 operands, as the reference's
    ``preferred_element_type`` (:class:`_LogitsF32` gives it a gradient).
    A step traced on the meta device takes the card's route, so that its
    FLOP count and memory are the card's.  The CPU build has no such
    ``mm``: there both operands are upcast, which gives the same exact f32
    products.
    """
    name = "table" if cfg.tie_embeddings else "head"
    table = p["table"].T if cfg.tie_embeddings else p["head"]
    mesh, lo = _vocab_block(p, name, table.shape[1])
    x = stream_inputs(x, mesh is not None)[0]  # vocab-parallel: its block
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type in ("cuda", "meta"):
        logits = _LogitsF32.apply(x2, table)
    else:
        logits = x2.float() @ table.float()
    logits = logits.reshape(*lead, -1)
    if cfg.vocab_padded > cfg.vocab and cfg.vocab - lo < logits.shape[-1]:
        # Padding columns (vocab rounded up for clean TP sharding) must
        # never win the softmax/argmax; by their global index, so they
        # sit in the last 'model' block alone.
        logits[..., max(cfg.vocab - lo, 0):] = -1e30
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
