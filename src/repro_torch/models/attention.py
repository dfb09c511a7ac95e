"""Grouped-query attention, full-sequence and cached decode: the torch twin
of the JAX package's ``repro/models/attention.py``.

The decode path keeps the paper's discipline: the O(1) query state stays in
fast memory while the O(seq) KV cache is streamed, and sliding-window layers
keep a rotating window-sized cache, so evicted tokens are never read.  The
attention after the cache write runs through B5
(``repro_torch.kernels.decode_attn.decode_attention``): the CUDA kernel on
the card, its plain version on the CPU; where a plan holds the cache's
head_dim or sequence split over the mesh, each rank attends over its own
blocks instead, as the reference's one program computes it
(:func:`_attend_blocks`).

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
from .layers import (apply_rope, on_model_block, rmsnorm, stream_inputs,
                     stream_output)
from .param import Mk
from .shard_ctx import constrain, constrain_heads, current_mesh

__all__ = ["FLASH_MIN_SEQ", "CacheLayout", "KVCache", "attn_cross", "attn_decode",
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
    """q, k, v of ``x``.  Where the plan in scope splits the heads over
    'model' (``wq`` a rank's block), q holds this rank's heads, and k and v
    its kv heads when those split too; otherwise k and v hold every kv
    head (:func:`_local_kv` picks the ones a rank's q heads read)."""
    q_split = on_model_block(p, "wq")
    kv_split = on_model_block(p, "wk")
    xq, xw = stream_inputs(x, q_split, whole=not kv_split)
    xk = xq if kv_split else xw
    q, k, v = _proj(xq, p["wq"]), _proj(xk, p["wk"]), _proj(xk, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["w"])
        k = rmsnorm(k, p["k_norm"]["w"])
    if cfg.pos == "rope":
        sec = cfg.m_rope_sections
        q = apply_rope(q, positions, cfg.rope_theta, sec)
        k = apply_rope(k, positions, cfg.rope_theta, sec)
    # the reference's layout: one seq-gather a layer (shard_ctx)
    return constrain_heads(q, k, v)


def _copy_to_model(x: torch.Tensor) -> torch.Tensor:
    from ..distributed.sharding import copy_to_model

    return copy_to_model(x, current_mesh())


def _local_kv(p, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: ModelConfig) -> tuple:
    """The kv heads this rank's q heads read: ``k`` and ``v`` as they are,
    unless q holds a block of the heads over 'model' (``wq`` a rank's block
    in ``p``) and k and v every kv head (``wk`` whole); then the kv heads of
    that block (every rank computed them whole, so their gradient is summed
    over 'model' before the cut)."""
    if not on_model_block(p, "wq") or on_model_block(p, "wk"):
        return k, v
    hq = q.shape[-2]
    group = cfg.n_heads // cfg.n_kv_heads
    first = hq * current_mesh().get_local_rank("model")
    lo, hi = first // group, (first + hq - 1) // group + 1
    if hq % (hi - lo) or (hi - lo) * group < hq:
        raise ValueError(f"{hq} heads a rank do not map onto whole kv "
                         f"heads ({cfg.n_heads} heads, {cfg.n_kv_heads} kv)")
    return _copy_to_model(k)[..., lo:hi, :], _copy_to_model(v)[..., lo:hi, :]


def _out_proj(out: torch.Tensor, p) -> torch.Tensor:
    """``einsum('bshk,hkd->bsd', out, p["wo"])`` as one matrix product;
    row parallel (summed over 'model') when ``wo`` holds a rank's block of
    the heads, as ``out`` then does."""
    wo = p["wo"]
    h, k, d = wo.shape
    o2 = out.reshape(*out.shape[:-2], h * k)
    if on_model_block(p, "wo"):
        from .layers import row_parallel

        return row_parallel(o2, wo.reshape(h * k, d))
    return stream_output(o2 @ wo.reshape(h * k, d))


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
    lays into the decode cache (a rank's kv heads where the plan in scope
    splits them, every kv head otherwise)."""
    pos1d = positions[0] if cfg.m_rope_sections else positions
    q, k, v = _project_qkv(p, x, cfg, positions)
    kq, vq = _local_kv(p, q, k, v, cfg)
    out = _attention(q, kq, vq, pos1d, int(window), causal, tiles)
    out, _, _ = constrain_heads(out, out, out)
    out = _out_proj(out, p)
    return (out, k, v) if return_kv else out


class CacheLayout(NamedTuple):
    """How a rank holds an attention cache and how a step computes with
    it, as spec entries of k and v ``[B, T, KV, hd]`` (pos ``[B, T]``
    takes the first two): ``held`` the plan's (``cache_pspecs``), ``want``
    the step's (its batch block, its kv heads where the heads split)."""

    mesh: object
    held: tuple
    want: tuple

    def splits(self) -> tuple:
        """(the mesh dims the held sequence is split over, whether the held
        head_dim is split over 'model'), counting dims of more than one
        rank."""
        from ..distributed.sharding import _axes, _names

        axes = _axes(self.mesh)
        seq = tuple(n for n in _names(self.held[1]) if axes[n] > 1)
        hd = any(axes[n] > 1 for n in _names(self.held[3]))
        return seq, hd

    def step(self) -> tuple:
        """The entries a step computes with k and v in: ``want``, but the
        held sequence and head_dim where :meth:`splits` finds either split
        (the rank attends over its blocks; nothing is gathered)."""
        seq, hd = self.splits()
        if not (seq or hd):
            return self.want
        return (self.want[0], self.held[1], self.want[2], self.held[3])


def attn_decode(
    p,
    x: torch.Tensor,
    cache: KVCache,
    cfg: ModelConfig,
    positions: torch.Tensor,
    window: int = 0,
    attend: Callable = decode_attention,
    layout: Optional[CacheLayout] = None,
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

    ``layout``: the cache is this rank's block under the plan (see
    :class:`CacheLayout`), and the new entry is written into the block
    that holds its slot.  Where the plan splits the cache's head_dim over
    'model' or its sequence over the data axes, the rank attends over its
    own block, as the reference's one program computes it
    (:func:`_attend_blocks`), and no cache block moves: B5 needs whole
    head_dims and the whole sequence, so the layout alone, never a
    failure of B5, chooses that path.  Otherwise B5 runs on the rank's
    batch and kv heads.
    """
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    pos1d = (positions[0] if cfg.m_rope_sections else positions)[:, 0]  # [B]
    if layout is None:
        _write(cache, k_new, v_new, pos1d)
        k, v, kpos = cache.k, cache.v, cache.pos
    else:
        k, v, kpos = _write_held(cache, k_new, v_new, pos1d, layout)
        seq, hd = layout.splits()
        if seq or hd:
            out = _attend_blocks(p, q, k, v, kpos, pos1d, window, cfg,
                                 layout.mesh, seq, hd)
            return _out_proj(out, p), cache
    # the reference's decode layout: head_dim x 'model'
    q = constrain(q, "dp", None, None, "model")
    k = constrain(k, "dp", None, None, "model")
    v = constrain(v, "dp", None, None, "model")
    k, v = _local_kv(p, q, k, v, cfg)

    out = attend(q, k.contiguous(), v.contiguous(), kpos, pos1d,
                 window=window)
    b, hq = q.shape[0], q.shape[2]
    out = out.to(x.dtype).reshape(b, 1, hq, cfg.head_dim)
    return _out_proj(out, p), cache


def _write(cache: KVCache, k_new, v_new, pos1d) -> None:
    """The new token's K, V and position at slot ``pos % T`` of a whole
    cache."""
    b, t = cache.pos.shape
    slot = (pos1d % t).long()
    bidx = torch.arange(b, device=k_new.device)
    cache.k.index_put_((bidx, slot), k_new[:, 0])
    cache.v.index_put_((bidx, slot), v_new[:, 0])
    cache.pos.index_put_((bidx, slot), pos1d)


def _write_held(cache: KVCache, k_new, v_new, pos1d, layout: CacheLayout):
    """:func:`_write` into this rank's block of the cache (only the rank
    whose sequence block holds the slot writes it), then (k, v, pos) in
    the step's layout (:meth:`CacheLayout.step`)."""
    from ..distributed.sharding import _axis_size, _coord, _names, relayout

    mesh, held, want = layout
    b, t_loc = cache.pos.shape
    seq = _names(held[1])
    lo = t_loc * _coord(mesh, seq) if seq else 0
    local = (pos1d % (t_loc * _axis_size(mesh, seq))).long() - lo
    mine = (local >= 0) & (local < t_loc)
    idx = local.clamp(0, t_loc - 1)
    bidx = torch.arange(b, device=k_new.device)
    row = (want[0], None, want[2], want[3])
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        new = relayout(new, mesh, row, (held[0], None, held[2], held[3]))
        buf.index_put_((bidx, idx), torch.where(mine[:, None, None],
                                                new[:, 0], buf[bidx, idx]))
    cache.pos.index_put_((bidx, idx), torch.where(mine, pos1d,
                                                  cache.pos[bidx, idx]))
    want = layout.step()
    return (relayout(cache.k, mesh, held, want),
            relayout(cache.v, mesh, held, want),
            relayout(cache.pos, mesh, held[:2], want[:2]))


def _attend_blocks(p, q, k, v, kpos, pos1d, window: int, cfg: ModelConfig,
                   mesh, seq: tuple, hd: bool) -> torch.Tensor:
    """The reference's decode attention (``_sdpa`` after its
    ``constrain(q, "dp", None, None, "model")``) over this rank's blocks
    of the cache: k, v ``[B, T_loc, KV', hd_loc]`` and kpos ``[B, T_loc]``
    (``seq``: the mesh dims the sequence is split over; ``hd``: the
    head_dim split over 'model').  Returns the heads ``_out_proj`` takes
    ``[B, 1, H', hd]``.

    With ``hd``, q goes from its heads to the head_dim block (one
    all-to-all over 'model', or a cut where every rank holds every head),
    the partial f32 scores ``[B, KV, G, 1, T_loc]`` are summed over
    'model' in f32, and the output goes back to ``wo``'s heads (the
    reverse exchange, or a gather of the head_dim).  The scale is the
    whole head_dim's.  Then the reference's mask (``pos >= 0`` and the
    window).  With ``seq``, the softmax's max is taken over the data axes
    (MAX), then the exponentials and their sum (SUM, f32); otherwise one
    f32 softmax.  The probabilities are rounded to bf16 before p.v, as the
    reference rounds them (ROADMAP §C P9).  With ``seq``, each rank's p.v
    over its block is an f32 partial, summed over the data axes in f32 and
    rounded once (§C P37)."""
    import torch.distributed as dist

    from ..distributed.sharding import _all_reduce

    b, dtype = q.shape[0], q.dtype
    if hd:
        q = _heads_to_dims(q, mesh, on_model_block(p, "wq"))
    else:
        k, v = _local_kv(p, q, k, v, cfg)
    kvh, hq = k.shape[2], q.shape[2]
    qg = q.reshape(b, 1, kvh, hq // kvh, q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    if hd:
        scores = _all_reduce(scores, mesh, ("model",), dist.ReduceOp.SUM)
    scores = scores * (cfg.head_dim**-0.5)
    valid = kpos >= 0
    if window:
        valid = valid & (kpos > (pos1d[:, None] - window))
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    if seq:
        m = _all_reduce(scores.amax(dim=-1, keepdim=True), mesh, seq,
                        dist.ReduceOp.MAX)
        e = torch.exp(scores - m)
        total = _all_reduce(e.sum(dim=-1, keepdim=True), mesh, seq,
                            dist.ReduceOp.SUM)
        probs = (e / total).to(dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float())
        out = _all_reduce(out, mesh, seq, dist.ReduceOp.SUM).to(dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    out = out.reshape(b, 1, hq, out.shape[-1])
    if hd:
        out = _dims_to_heads(out, mesh, on_model_block(p, "wo"))
    return out


def _heads_to_dims(q: torch.Tensor, mesh, split: bool) -> torch.Tensor:
    """q ``[B, 1, H', hd]`` (this rank's heads where ``split``, else every
    head) -> every head's block of the head_dim over 'model' ``[B, 1, H,
    hd_loc]``: one all-to-all over 'model' (a cut without ``split``)."""
    from ..distributed.sharding import _axis_size, _exchange, _own

    if not split:
        return _own(q, mesh, ("model",), 3)
    m = _axis_size(mesh, "model")
    b, _, h_loc, hd = q.shape
    send = q[:, 0].reshape(b, h_loc, m, hd // m).permute(2, 0, 1, 3)
    got = _exchange(send, mesh.get_group("model"))  # [m, B, h_loc, hd_loc]
    return got.permute(1, 0, 2, 3).reshape(b, 1, m * h_loc, hd // m)


def _dims_to_heads(out: torch.Tensor, mesh, split: bool) -> torch.Tensor:
    """The inverse of :func:`_heads_to_dims`: ``[B, 1, H, hd_loc]`` ->
    this rank's heads ``[B, 1, H / model, hd]`` where ``split`` (the
    reverse all-to-all), else every head (the head_dim gathered over
    'model')."""
    from ..distributed.sharding import _axis_size, _exchange, _gather

    if not split:
        return _gather(out, mesh, ("model",), 3)
    m = _axis_size(mesh, "model")
    b, _, h, hd_loc = out.shape
    send = out[:, 0].reshape(b, m, h // m, hd_loc).permute(1, 0, 2, 3)
    got = _exchange(send, mesh.get_group("model"))  # [m, B, h_loc, hd_loc]
    return got.permute(1, 2, 0, 3).reshape(b, 1, h // m, m * hd_loc)


def attn_cross(p, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor,
               cfg: ModelConfig,
               layout: Optional[CacheLayout] = None) -> torch.Tensor:
    """Cross-attention over precomputed encoder K/V (whisper decoder): no
    mask, the chunked path once either side reaches ``FLASH_MIN_SEQ``.
    ``enc_k``/``enc_v`` as :func:`project_kv` gives them, or, with
    ``layout`` (a decode step's), this rank's blocks of them as the cache
    plan holds them: where it splits their head_dim or sequence, the rank
    attends over its blocks (:func:`_attend_blocks`), else they are moved
    to the step's layout."""
    from ..distributed.sharding import relayout

    q_split = on_model_block(p, "wq")
    q = _proj(stream_inputs(x, q_split)[0], p["wq"])
    q, _, _ = constrain_heads(q, q, q)
    if layout is not None:
        enc_k, enc_v = (relayout(t, layout.mesh, layout.held,
                                 layout.step()).contiguous()
                        for t in (enc_k, enc_v))
        seq, hd = layout.splits()
        if seq or hd:
            valid = torch.zeros(enc_k.shape[:2], dtype=torch.int32,
                                device=x.device)
            return _out_proj(_attend_blocks(p, q, enc_k, enc_v, valid, None,
                                            0, cfg, layout.mesh, seq, hd), p)
    enc_k, enc_v = _local_kv(p, q, enc_k, enc_v, cfg)
    b, s = q.shape[:2]
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
    return _out_proj(out, p)


def project_kv(p, x_enc: torch.Tensor, cfg: ModelConfig):
    """Encoder-side K/V for cross attention (computed once per request): a
    rank's kv heads where the plan in scope splits them, every kv head
    otherwise."""
    if on_model_block(p, "wk"):
        x_enc = _copy_to_model(x_enc)
    k = _proj(x_enc, p["wk"])
    _, k, v = constrain_heads(k, k, _proj(x_enc, p["wv"]))
    return k, v
