"""Grouped-query attention, full-sequence and cached decode: the torch twin
of the JAX package's ``repro/models/attention.py``.

The decode path keeps the paper's discipline: the O(1) query state stays in
fast memory while the O(seq) KV cache is streamed, and sliding-window layers
keep a rotating window-sized cache, so evicted tokens are never read.  The
attention after the cache write runs through B5
(``repro_torch.kernels.decode_attn.decode_attention``): the CUDA kernel on
the card, its plain version on the CPU.

The full-sequence path (``attn_full``, training and prefill) takes the
dense ``_sdpa`` below ``FLASH_MIN_SEQ`` query rows and the chunked
``flash_attention`` (``models/flash.py``) from there on, as the reference
does; ``attn_cross`` and ``project_kv`` are the encoder-decoder's cross
attention.  Neither is a TPU kernel in the reference: their counterparts
are plain torch.  The reference's layout pins (``shard_ctx``) sit where it
has them; they change no value.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attention
from .flash import NEG_INF, TileTable, flash_attention, pick_chunk
from .layers import apply_rope, rmsnorm
from .param import Mk
from .shard_ctx import constrain, constrain_heads, current_mesh

__all__ = ["FLASH_MIN_SEQ", "KVCache", "attn_cross", "attn_decode",
           "attn_full", "init_attention", "init_kv_cache", "project_kv"]

# Above this many query rows the dense [B,H,S,T] score tensor is replaced by
# the chunked online-softmax path (models/flash.py).
FLASH_MIN_SEQ = 1024


def init_attention(mk: Mk, cfg: ModelConfig, layers: Optional[int] = None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": mk.param((d, h, hd), ("embed", "heads", None), layers=layers),
        "wk": mk.param((d, kv, hd), ("embed", "kv", None), layers=layers),
        "wv": mk.param((d, kv, hd), ("embed", "kv", None), layers=layers),
        "wo": mk.param((h, hd, d), ("heads", None, "embed"), layers=layers),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"w": mk.param((hd,), (None,), init="zeros",
                                       layers=layers)}
        p["k_norm"] = {"w": mk.param((hd,), (None,), init="zeros",
                                       layers=layers)}
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
    if cfg.pos == "rope":
        sec = cfg.m_rope_sections
        q = apply_rope(q, positions, cfg.rope_theta, sec)
        k = apply_rope(k, positions, cfg.rope_theta, sec)
    # the reference's layout: one seq-gather a layer (shard_ctx)
    return constrain_heads(q, k, v)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum('bshk,hkd->bsd', out, wo)`` as one matrix product."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _sdpa(q, k, v, mask):
    """Grouped SDPA.  q: [B,S,H,hd]; k/v: [B,T,KV,hd]; mask: [B,S,T] or
    [S,T].  f32 scores of the bf16 operands, the probabilities rounded to
    q's dtype before the p.v product, as the reference does (ROADMAP §C
    P9)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * (hd**-0.5)
    if mask.dim() == 2:
        mask = mask[None]
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _attention(q, k, v, pos1d, window: int, causal: bool, tiles):
    """The attention of ``attn_full`` after the projections."""
    s = q.shape[1]
    if s >= FLASH_MIN_SEQ:
        cq, ck = pick_chunk(s, 512), pick_chunk(s, 1024)
        if tiles is None or (tiles.cq, tiles.ck) != (cq, ck):
            tiles = TileTable(pos1d, pos1d, cq, ck)
        return flash_attention(q, k, v, pos1d, pos1d, window, causal,
                               q.shape[-1]**-0.5, cq, ck, current_mesh(),
                               live=tiles.live(window, causal))
    qp = pos1d[..., :, None]
    kp = pos1d[..., None, :]
    if causal:
        mask = kp <= qp
    else:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if window:
        mask = mask & (kp > qp - window)
    return _sdpa(q, k, v, mask)


def attn_full(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
              window: int = 0, causal: bool = True,
              tiles: Optional[TileTable] = None, return_kv: bool = False):
    """Full-sequence attention (training / prefill).  ``window > 0`` is
    sliding-window attention.  ``tiles`` is the forward's table of live
    flash tiles over these positions (made here when None);
    ``return_kv=True`` also returns the projected K and V, which prefill
    lays into the decode cache."""
    pos1d = positions[0] if cfg.m_rope_sections else positions
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _attention(q, k, v, pos1d, int(window), causal, tiles)
    out, _, _ = constrain_heads(out, out, out)
    out = _out_proj(out, p["wo"])
    return (out, k, v) if return_kv else out


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

    x: [B, 1, d]; positions: [B, 1] int32 (or [3, B, 1] for M-RoPE) — the
    absolute position of the new token.  The new K/V/pos land at slot
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
    pos1d = (positions[0] if cfg.m_rope_sections else positions)[:, 0]  # [B]
    slot = (pos1d % t).long()
    bidx = torch.arange(b, device=x.device)
    cache.k.index_put_((bidx, slot), k_new[:, 0])
    cache.v.index_put_((bidx, slot), v_new[:, 0])
    cache.pos.index_put_((bidx, slot), pos1d)
    # the reference's decode layout: head_dim x 'model'
    q = constrain(q, "dp", None, None, "model")
    k = constrain(cache.k, "dp", None, None, "model")
    v = constrain(cache.v, "dp", None, None, "model")

    out = attend(q, k, v, cache.pos, pos1d, window=window)
    h, hd = cfg.n_heads, cfg.head_dim
    out = out.to(x.dtype).reshape(b, 1, h * hd)
    out = out @ p["wo"].reshape(h * hd, -1)
    return out, cache


def attn_cross(p, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention over precomputed encoder K/V (whisper decoder): no
    mask, the chunked path once either side reaches ``FLASH_MIN_SEQ``."""
    q = _proj(x, p["wq"])
    q, _, _ = constrain_heads(q, q, q)
    b, s = x.shape[:2]
    t = enc_k.shape[1]
    if s >= FLASH_MIN_SEQ or t >= FLASH_MIN_SEQ:
        ar = dict(dtype=torch.int32, device=x.device)
        pos_q = torch.arange(s, **ar)[None].expand(b, s)
        pos_k = torch.arange(t, **ar)[None].expand(b, t)
        out = flash_attention(q, enc_k, enc_v, pos_q, pos_k, 0, False,
                              cfg.head_dim**-0.5, pick_chunk(s, 512),
                              pick_chunk(t, 1024), current_mesh())
    else:
        mask = torch.ones((s, t), dtype=torch.bool, device=x.device)
        out = _sdpa(q, enc_k, enc_v, mask)
    return _out_proj(out, p["wo"])


def project_kv(p, x_enc: torch.Tensor, cfg: ModelConfig):
    """Encoder-side K/V for cross attention (computed once per request)."""
    k = _proj(x_enc, p["wk"])
    _, k, v = constrain_heads(k, k, _proj(x_enc, p["wv"]))
    return k, v
