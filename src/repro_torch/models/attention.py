"""Grouped-query attention, cached decode: the torch twin of the JAX
package's ``repro/models/attention.py`` (``init_attention``, ``KVCache``,
``init_kv_cache``, ``_project_qkv`` and ``attn_decode``).

The decode path keeps the paper's discipline: the O(1) query state stays in
fast memory while the O(seq) KV cache is streamed, and sliding-window layers
keep a rotating window-sized cache, so evicted tokens are never read.  The
attention after the cache write runs through B5
(``repro_torch.kernels.decode_attn.decode_attention``): the CUDA kernel on
the card, its plain version on the CPU.

The full-sequence and cross-attention paths (``attn_full``, ``_sdpa``,
``attn_cross``, ``project_kv``) wait for the prefill, training and
encoder-decoder slices of the port.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attention
from .layers import apply_rope, rmsnorm
from .param import Mk

__all__ = ["KVCache", "attn_decode", "init_attention", "init_kv_cache"]


def init_attention(mk: Mk, cfg: ModelConfig, layers: Optional[int] = None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": mk.param((d, h, hd), layers=layers),
        "wk": mk.param((d, kv, hd), layers=layers),
        "wv": mk.param((d, kv, hd), layers=layers),
        "wo": mk.param((h, hd, d), layers=layers),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"w": mk.param((hd,), init="zeros", layers=layers)}
        p["k_norm"] = {"w": mk.param((hd,), init="zeros", layers=layers)}
    return p


class KVCache(NamedTuple):
    """Decode-time cache for ONE attention layer.

    k/v: [B, T, kv_heads, head_dim] — T is the *window* for local layers.
    pos: [B, T] int32 absolute positions stored in each slot (-1 = empty);
      rotating writes make slot order irrelevant, masks use stored positions.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def init_kv_cache(batch: int, length: int, cfg: ModelConfig,
                  device) -> KVCache:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    bf16 = dict(dtype=torch.bfloat16, device=device)
    return KVCache(
        k=torch.zeros((batch, length, kv, hd), **bf16),
        v=torch.zeros((batch, length, kv, hd), **bf16),
        pos=torch.full((batch, length), -1, dtype=torch.int32, device=device),
    )


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('bsd,dhk->bshk', x, w)`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["w"])
        k = rmsnorm(k, p["k_norm"]["w"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_decode(
    p,
    x: torch.Tensor,
    cache: KVCache,
    cfg: ModelConfig,
    positions: torch.Tensor,
    window: int = 0,
    attend: Callable = decode_attention,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against the cache.

    x: [B, 1, d]; positions: [B, 1] int32 — the absolute position of the
    new token.  The new K/V/pos land at slot
    ``pos % T`` (full cache: T >= max positions, so this is just ``pos``;
    window cache: rotating overwrite, so evicted tokens are unreachable).

    Unlike the reference, which returns a new cache, this writes the slot in
    place (``index_put_``) and returns the same cache: copying every layer's
    whole cache on every step would cost its bytes twice per token.

    The attention runs through ``attend`` (B5's ``decode_attention``; its
    plain version for checks) with ``cur = pos``.  Its mask is
    ``0 <= pos <= cur`` (and the window), where the reference's
    ``attn_decode`` masks ``pos >= 0`` (and the window) alone: the two agree
    after the write, because no stored position exceeds the new token's when
    every row writes one increasing position per step, as the decode loop
    and ``serve_batch`` do.
    """
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    b, t = cache.pos.shape
    pos1d = positions[:, 0]  # [B]
    slot = (pos1d % t).long()
    bidx = torch.arange(b, device=x.device)
    cache.k.index_put_((bidx, slot), k_new[:, 0])
    cache.v.index_put_((bidx, slot), v_new[:, 0])
    cache.pos.index_put_((bidx, slot), pos1d)

    out = attend(q, cache.k, cache.v, cache.pos, pos1d, window=window)
    h, hd = cfg.n_heads, cfg.head_dim
    out = out.to(x.dtype).reshape(b, 1, h * hd)
    out = out @ p["wo"].reshape(h * hd, -1)
    return out, cache
