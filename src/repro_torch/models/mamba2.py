"""Mamba2 (state-space duality, SSD) block, arXiv:2405.21060: the torch
twin of the JAX package's ``repro/models/mamba2.py``.

The chunked SSD forward computes the within-chunk interactions in their
quadratic (attention-like) form and carries the ``[B, heads, head_dim,
state]`` SSM state across chunks by a linear recurrence: a loop over the
chunks that emits the state before each chunk (the reference's
``lax.scan``).  Decode is a one-token state update: O(state) work and no
cache growth.  Neither is a TPU kernel in the reference; this is plain
torch.

Under a plan that splits the mixer's 'inner' dim over 'model' (the
layer tree as ``models.model._gathered`` makes it: ``out_proj`` named
under ``layers.MODEL_BLOCKS``), each rank runs its block of the heads,
Megatron style: its columns of z, x and dt and B and C whole
(:func:`head_columns`), the SSD over its heads, the gated norm's sum of
squares summed over 'model', and ``out_proj`` row parallel.  With the
whole mixer (no plan, or one rank over 'model') the same functions run
the one program's path, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import on_model_block, row_parallel
from .param import Mk
from .shard_ctx import current_mesh

__all__ = ["SSMCache", "head_columns", "init_mamba2", "init_ssm_cache",
           "mamba2_decode", "mamba2_full"]


def init_mamba2(mk: Mk, cfg: ModelConfig, layers: Optional[int] = None):
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return {
        "in_proj": mk.param((d, 2 * di + 2 * n + nh), ("embed", "inner"),
                            layers=layers),  # x, z, B, C, dt,
        "conv_w": mk.param((cfg.ssm_conv, conv_ch), (None, "inner"), scale=0.5,
                           layers=layers),
        "conv_b": mk.param((conv_ch,), ("inner",), init="zeros",
                           layers=layers),
        "A_log": mk.param((nh,), (None,), init="ones", layers=layers),
        "D": mk.param((nh,), (None,), init="ones", layers=layers),
        "dt_bias": mk.param((nh,), (None,), init="zeros", layers=layers),
        "norm_w": mk.param((di,), ("inner",), init="zeros", layers=layers),
        "out_proj": mk.param((di, d), ("inner", "embed"), layers=layers),
    }


class SSMCache(NamedTuple):
    """Decode state for one mamba2 layer: O(1) in sequence length."""

    conv: torch.Tensor  # [B, conv_k-1, di + 2n] trailing raw conv inputs
    state: torch.Tensor  # [B, heads, head_dim, state] SSM state (f32)


def init_ssm_cache(batch: int, cfg: ModelConfig, device) -> SSMCache:
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                         dtype=torch.bfloat16, device=device),
        state=torch.zeros((batch, nh, di // nh, n), dtype=torch.float32,
                          device=device),
    )


def head_columns(di: int, n: int, nh: int, m: int) -> dict:
    """The columns each of ``m`` ranks computes with where the mixer's
    heads split over 'model': per leaf (``in_proj``'s fused z | x | B | C
    | dt columns, the conv's x | B | C channels), per rank, its sorted
    ``(lo, hi)`` ranges: z, x and dt of its ``nh / m`` heads, B and C
    whole (ngroups = 1: every head reads them)."""
    w, h = di // m, nh // m
    inp, conv = [], []
    for r in range(m):
        inp.append(((r * w, (r + 1) * w), (di + r * w, di + (r + 1) * w),
                    (2 * di, 2 * di + 2 * n),
                    (2 * di + 2 * n + r * h, 2 * di + 2 * n + (r + 1) * h)))
        conv.append(((r * w, (r + 1) * w), (di, di + 2 * n)))
    return {"in_proj": tuple(inp), "conv_w": tuple(conv),
            "conv_b": tuple(conv)}


def _widths(p, cfg: ModelConfig) -> tuple:
    """(d_inner, heads) of the mixer ``p`` computes: its block of the
    heads over 'model' (:func:`on_model_block`), else the whole."""
    if on_model_block(p, "out_proj"):
        return p["norm_w"].shape[0], p["A_log"].shape[0]
    return cfg.d_inner, cfg.ssm_heads


def _whole_x(xbc: torch.Tensor, di: int) -> torch.Tensor:
    """The conv's channels whole ``[..., d_inner + 2n]`` from a rank's
    ``[..., di | B | C]`` (its heads' x, B and C whole): the x blocks
    gathered over 'model' (outside autograd: a cache's)."""
    from ..distributed.sharding import _gather

    xs = _gather(xbc[..., :di].contiguous(), current_mesh(), ("model",),
                 xbc.dim() - 1)
    return torch.cat([xs, xbc[..., di:]], dim=-1)


def _split_proj(p, x: torch.Tensor, di: int, n: int):
    zxbcdt = x @ p["in_proj"]
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(p, xbc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv over the sequence dim, SiLU activation.

    Computed in f32 and rounded to bf16 once, after the SiLU, here and in
    :func:`mamba2_decode` alike (ROADMAP §C P22): the reference writes a
    bf16 sum of bf16 products, and rounding each of its steps in one path
    and not the other let prefill + decode drift from the forward by
    4-8% of the logits over 48 layers, where one rounding keeps it ~2%."""
    k = cfg.ssm_conv
    pad = F.pad(xbc, (0, 0, k - 1, 0)).float()
    w = p["conv_w"].float()
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + p["conv_b"].float()).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                whole: int = 0) -> torch.Tensor:
    """RMS norm of ``y * silu(z)``.  ``whole``: ``y`` is a rank's block of
    the heads of a ``whole``-wide inner dim; the f32 sums of squares are
    summed over 'model' (and so is their gradient) and divided by
    ``whole`` (ROADMAP §C P38: another order than the one program's)."""
    g = y.float() * F.silu(z.float())
    if whole:
        from ..distributed.sharding import reduce_sum

        sq = reduce_sum((g * g).sum(dim=-1, keepdim=True), current_mesh(),
                        ("model",), ("model",))
        var = sq / whole
    else:
        var = (g * g).mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + 1e-6) * (1.0 + w.float())).to(y.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """L[..., t, s] = sum_{s < k <= t} x[..., k]; -inf above the diagonal
    (``exp`` makes it 0 there)."""
    t = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def mamba2_full(p, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Chunked SSD over a full sequence.  x: [B, S, d], any S (padded
    internally to a chunk multiple with identity transitions: dt = 0 at
    padded positions means decay exp(0 A) = 1 and zero input, so the state
    and the real outputs are exact).

    ``return_state=True`` also returns the :class:`SSMCache` after the last
    token, for the prefill -> decode handoff.

    On a block of the heads (see the module's docstring) ``x`` is the
    whole input (the column-parallel input, gathered under sequence
    parallelism), the output is ``out_proj``'s row-parallel sum (this
    rank's block of the sequence under sequence parallelism) and the state
    holds the rank's heads ``[B, heads / model, hp, n]``; the conv cache
    is whole."""
    b, s, _ = x.shape
    split = on_model_block(p, "out_proj")
    (di, nh), n = _widths(p, cfg), cfg.ssm_state
    hp = di // nh
    cl = min(cfg.ssm_chunk, s)
    pad = (-s) % cl
    s_real = s
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        s = s + pad
    nc = s // cl

    z, xbc_raw, dt_raw = _split_proj(p, x, di, n)
    xbc = _causal_conv(p, xbc_raw, cfg)
    xin = xbc[..., :di].reshape(b, nc, cl, nh, hp)
    B = xbc[..., di:di + n].reshape(b, nc, cl, n)
    C = xbc[..., di + n:].reshape(b, nc, cl, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float()).reshape(
        b, nc, cl, nh)
    if pad:
        valid = (torch.arange(s, device=x.device) < s_real).reshape(
            1, nc, cl, 1)
        dt = dt * valid
    A = -torch.exp(p["A_log"].float())  # [nh]
    dA = dt * A  # [b, nc, cl, nh]
    cum = torch.cumsum(dA, dim=2)

    xdt = xin.float() * dt[..., None]  # effective input
    Bf, Cf = B.float(), C.float()

    # intra-chunk: the quadratic (attention-like) form
    L = torch.exp(_segsum(dA.movedim(-1, 2)))  # [b, nc, nh, cl, cl]
    scores = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    y_diag = torch.einsum("bchts,bcshp->bcthp", scores[:, :, None] * L, xdt)

    # chunk states and the linear recurrence across chunks
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)  # [b, nc, cl, nh]
    states = torch.einsum("bcsn,bcshp->bchpn", Bf, xdt * decay_out[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [b, nc, nh]
    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):  # emit the state BEFORE each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # [b, nc, nh, hp, n]

    y_off = (torch.einsum("bctn,bchpn->bcthp", Cf, h_prev)
             * torch.exp(cum)[..., None])
    y = (y_diag + y_off).reshape(b, s, nh, hp)
    y = y + xin.reshape(b, s, nh, hp).float() * p["D"].float().reshape(
        1, 1, nh, 1)
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm_w"], cfg.d_inner if split else 0)
    if split:  # the padding's rows are cut before the row-parallel sum
        out = row_parallel(y[:, :s_real], p["out_proj"])
    else:
        out = y @ p["out_proj"]
        if pad:
            out = out[:, :s_real]
    if not return_state:
        return out
    # decode handoff: the conv cache holds the last (k-1) RAW xbc inputs
    conv_tail = xbc_raw[:, s_real - (cfg.ssm_conv - 1):s_real, :]
    if split:
        conv_tail = _whole_x(conv_tail, di)
    return out, SSMCache(conv=conv_tail.contiguous(), state=h)


def mamba2_decode(p, x: torch.Tensor, cache: SSMCache,
                  cfg: ModelConfig) -> tuple[torch.Tensor, SSMCache]:
    """Single-token SSD step.  x: [B, 1, d].  On a block of the heads the
    cache's conv is whole and its state the rank's heads, and so are the
    returned ones; the output is ``out_proj``'s row-parallel sum."""
    b = x.shape[0]
    split = on_model_block(p, "out_proj")
    (di, nh), n = _widths(p, cfg), cfg.ssm_state
    hp = di // nh

    z, xbc, dt_raw = _split_proj(p, x, di, n)  # [b, 1, ...]
    conv = cache.conv
    if split:  # the rank's channels of the whole history: its x, B, C
        lo = di * current_mesh().get_local_rank("model")
        conv = torch.cat([conv[..., lo:lo + di], conv[..., cfg.d_inner:]],
                         dim=-1)
    hist = torch.cat([conv, xbc], dim=1)  # [b, k, ch]
    conv_out = ((hist.float() * p["conv_w"].float()).sum(dim=1)
                + p["conv_b"].float())
    xbc1 = F.silu(conv_out).to(x.dtype)[:, None, :]
    if split:
        new_conv = torch.cat([cache.conv, _whole_x(xbc, di)], dim=1)[:, 1:]
    else:
        new_conv = hist[:, 1:, :]

    xin = xbc1[..., :di].reshape(b, nh, hp).float()
    B = xbc1[..., di:di + n].reshape(b, n).float()
    C = xbc1[..., di + n:].reshape(b, n).float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())  # [b, nh]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)

    # h' = exp(dt A) h + (dt x) B^T ;  y = C h' + D x
    xdt = xin * dt[..., None]
    state = (cache.state * dA[..., None, None]
             + torch.einsum("bhp,bn->bhpn", xdt, B))
    y = torch.einsum("bhpn,bn->bhp", state, C)
    y = y + xin * p["D"].float().reshape(1, nh, 1)
    y = y.reshape(b, 1, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm_w"], cfg.d_inner if split else 0)
    out = row_parallel(y, p["out_proj"]) if split else y @ p["out_proj"]
    return out, SSMCache(conv=new_conv, state=state)
