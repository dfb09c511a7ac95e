"""Chunked online-softmax attention, forward: the torch twin of the JAX
package's ``repro/models/flash.py`` (``pick_chunk``, ``_mask``,
``_attend``, ``_skippable``, ``_fwd_impl`` and ``flash_attention``'s
forward).

Full attention over a long prompt cannot hold its ``[B, H, S, S]`` scores,
so attention runs over ``(cq, ck)`` tiles with the online-softmax
recurrence: f32 scores, f32 ``p.v`` (``v`` cast to f32), the running
``(m, l, acc)`` state per query row, and ``acc / max(l, 1e-30)`` cast to
``q``'s dtype at the end.  Masked scores take the finite ``NEG_INF =
-2e38``, never ``-inf``: a row that has seen no live key yet keeps
``m = NEG_INF``, and ``exp(-inf - -inf)`` would be NaN.

Tiles in which every (query, key) pair is masked are skipped, as the
reference's ``lax.cond`` on ``_skippable`` skips them: above the causal
diagonal, or wholly below a sliding window.  The reference decides this
per tile on the device; here the decision is one table per forward and
window (:class:`TileTable`): the positions' per-chunk minima and maxima
are read from the device once, and every layer of that window reuses the
table, so a forward makes no host read per tile.  The tiles that stay are
computed one key chunk at a time over every run of consecutive live query
chunks at once (within a memory budget), in ascending key-chunk order for
every query row, which is the order of the reference's scan.

The backward is the reference's ``_flash_bwd`` (a ``custom_vjp``), here
a ``torch.autograd.Function`` (:class:`FlashAttention`): the forward saves
``(q, k, v, qpos, kpos, out, lse)`` and the live-tile table it used, and
the backward recomputes each live tile's probabilities ``p = exp(s -
lse)`` from them, with ``delta = rowsum(dout * out)`` and ``ds = p (dp -
delta) scale``, all in f32.  The reference runs two passes over the tiles,
``dq`` (outer query chunks, inner key chunks ascending) and ``dk``/``dv``
(outer key chunks, inner query chunks ascending).  Here one walk over the
key chunks in ascending order, and within each over the runs of live query
rows in ascending order, does both: each ``dq`` row still adds its key
chunks in ascending order and each key chunk's ``dk``/``dv`` its query
rows in ascending order, and each live tile is recomputed once instead of
twice.  It skips exactly the tiles the forward skips, and its tiles are
batched under the forward's memory budget (``_TILE_ELEMS``).  ``dq``,
``dk`` and ``dv`` are cast to their inputs' dtypes at the end; positions,
window, chunk sizes and ``mesh`` get no gradient.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["NEG_INF", "FlashAttention", "TileTable", "flash_attention",
           "pick_chunk"]

NEG_INF = -2.0e38
_INT32_MAX = 2**31 - 1
# f32 elements of one batch of score tiles ([B, KV, G, rows, ck]); the
# probabilities take as many again.
_TILE_ELEMS = 1 << 25


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target (so tiles always cover)."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def _mask(qp: torch.Tensor, kp: torch.Tensor, window: int,
          causal: bool) -> torch.Tensor:
    """valid [B, cq, ck] from absolute positions (window == 0: no window)."""
    q = qp[:, :, None]
    k = kp[:, None, :]
    valid = k >= 0
    if causal:
        valid = valid & (k <= q)
        if window:
            valid = valid & (k > q - window)
    return valid


def _attend(q_blk, k_blk, qp, kp, window: int, causal: bool, scale: float):
    """The masked f32 scores [B, KV, G, rows, ck] of ``q_blk`` [B, rows, KV,
    G, hd] against ``k_blk`` [B, ck, KV, hd] (already f32)."""
    s = torch.einsum("bqkgh,btkh->bkgqt", q_blk.float(), k_blk) * scale
    valid = _mask(qp, kp, window, causal)
    return s.masked_fill(~valid[:, None, None], NEG_INF)


class TileTable:
    """Which ``(cq, ck)`` tiles of ``qpos`` [B, Sq] against ``kpos`` [B, T]
    hold a live pair: the complement of the reference's ``_skippable``.

    A tile is skippable when its keys all lie above the causal diagonal of
    every query in it (the least live key position beyond the greatest
    query position, over all rows of the batch), or all at or below the
    window of every query in it.  The chunk extrema are read from the
    device once, at the first causal table asked for; each window's table
    is then made once on the host and kept.  :meth:`of_arange` makes the
    table of the model's default positions with no read at all (so a step
    traces on meta and fake tensors).
    """

    def __init__(self, qpos: torch.Tensor, kpos: torch.Tensor, cq: int,
                 ck: int):
        self.qpos, self.kpos, self.cq, self.ck = qpos, kpos, cq, ck
        self.nq, self.nk = qpos.shape[1] // cq, kpos.shape[1] // ck
        self._extrema = None
        self._live: dict = {}

    @classmethod
    def of_arange(cls, pos: torch.Tensor, cq: int, ck: int) -> "TileTable":
        """The self-attention table of positions that are ``arange(S)`` in
        every row of ``pos`` [B, S] (the model's default): the chunk extrema
        are known on the host, and nothing is read from the device."""
        table = cls(pos, pos, cq, ck)
        q0 = np.arange(table.nq, dtype=np.int64) * cq
        k0 = np.arange(table.nk, dtype=np.int64) * ck
        table._extrema = (q0 + cq - 1, q0, k0, k0 + ck - 1)
        return table

    def extrema(self):
        """(qmax, qmin, kmin over live keys, kmax) per chunk, int64 numpy:
        one read of the device."""
        if self._extrema is None:
            b = self.qpos.shape[0]
            qc = self.qpos.reshape(b, self.nq, self.cq).long()
            kc = self.kpos.reshape(b, self.nk, self.ck).long()
            dead = torch.full_like(kc, _INT32_MAX)
            both = torch.cat([qc.amax((0, 2)), qc.amin((0, 2)),
                              torch.where(kc < 0, dead, kc).amin((0, 2)),
                              kc.amax((0, 2))]).cpu().numpy()
            nq = self.nq
            self._extrema = (both[:nq], both[nq:2 * nq],
                             both[2 * nq:2 * nq + self.nk],
                             both[2 * nq + self.nk:])
        return self._extrema

    def live(self, window: int, causal: bool = True) -> np.ndarray:
        """[nq, nk] bool: the tiles to compute."""
        if not causal:
            return np.ones((self.nq, self.nk), bool)
        key = int(window)
        if key not in self._live:
            qmax, qmin, kmin, kmax = self.extrema()
            skip = kmin[None, :] > qmax[:, None]  # above the diagonal
            if key > 0:
                skip |= kmax[None, :] <= qmin[:, None] - key  # below the window
            self._live[key] = ~skip
        return self._live[key]


def _runs(chunks: np.ndarray):
    """(first, end) of each run of consecutive chunk indices."""
    if chunks.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(chunks) != 1)
    starts = np.concatenate([[chunks[0]], chunks[breaks + 1]])
    ends = np.concatenate([chunks[breaks], [chunks[-1]]]) + 1
    return list(zip(starts.tolist(), ends.tolist()))


def _group_rows(b: int, h: int, ck: int, cq: int) -> int:
    """Query rows a batch of score tiles covers within ``_TILE_ELEMS``."""
    return max(cq, _TILE_ELEMS // max(b * h * ck, 1) // cq * cq)


def _fwd_impl(q, k, v, qpos, kpos, window: int, *, causal: bool,
              scale: float, cq: int, ck: int, live: np.ndarray):
    """Returns (out [B, Sq, H, hd] in q's dtype, lse [B, KV, G, Sq] f32)
    over the ``live`` tiles."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q5 = q.reshape(b, sq, kv, g, hd)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, kv, g, sq), NEG_INF, **f32)
    l = torch.zeros((b, kv, g, sq), **f32)
    acc = torch.zeros((b, kv, g, sq, hd), **f32)
    group = _group_rows(b, h, ck, cq)
    for j in range(t // ck):
        col = slice(j * ck, (j + 1) * ck)
        k_blk, v_blk, kp = k[:, col].float(), v[:, col].float(), kpos[:, col]
        for first, end in _runs(np.flatnonzero(live[:, j])):
            for r0 in range(first * cq, end * cq, group):
                rows = slice(r0, min(end * cq, r0 + group))
                s = _attend(q5[:, rows], k_blk, qpos[:, rows], kp, window,
                            causal, scale)
                m_old = m[..., rows]
                m_new = torch.maximum(m_old, s.amax(dim=-1))
                alpha = torch.exp(m_old - m_new)
                p = torch.exp(s - m_new[..., None])
                l[..., rows] = l[..., rows] * alpha + p.sum(dim=-1)
                acc[..., rows, :] = (acc[..., rows, :] * alpha[..., None]
                                     + torch.einsum("bkgqt,btkh->bkgqh", p,
                                                    v_blk))
                m[..., rows] = m_new
    lsafe = l.clamp_min(1e-30)
    out = acc / lsafe[..., None]
    lse = m + torch.log(lsafe)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype), lse


def _bwd_impl(q, k, v, qpos, kpos, out, lse, dout, window: int, *,
              causal: bool, scale: float, cq: int, ck: int,
              live: np.ndarray):
    """(dq, dk, dv) of :func:`_fwd_impl`'s output, from its saved output and
    log-sum-exp (the reference's ``_flash_bwd``)."""
    b, sq, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q5 = q.reshape(b, sq, kv, g, hd)
    do5 = dout.reshape(b, sq, kv, g, hd).float()
    o5 = out.reshape(b, sq, kv, g, hd).float()
    delta = torch.einsum("bskgh,bskgh->bkgs", do5, o5)  # [b, kv, g, sq]
    del o5
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros((b, sq, kv, g, hd), **f32)
    dk = torch.zeros((b, t, kv, hd), **f32)
    dv = torch.zeros((b, t, kv, hd), **f32)
    group = _group_rows(b, h, ck, cq)
    for j in range(t // ck):
        col = slice(j * ck, (j + 1) * ck)
        k_blk, v_blk, kp = k[:, col].float(), v[:, col].float(), kpos[:, col]
        for first, end in _runs(np.flatnonzero(live[:, j])):
            for r0 in range(first * cq, end * cq, group):
                rows = slice(r0, min(end * cq, r0 + group))
                q_blk = q5[:, rows].float()
                s = _attend(q_blk, k_blk, qpos[:, rows], kp, window, causal,
                            scale)
                p = torch.exp(s - lse[..., rows, None])  # [b,kv,g,rows,ck]
                del s
                do_blk = do5[:, rows]
                dp = torch.einsum("bqkgh,btkh->bkgqt", do_blk, v_blk)
                ds = p * (dp - delta[..., rows, None]) * scale
                del dp
                dq[:, rows] += torch.einsum("bkgqt,btkh->bqkgh", ds, k_blk)
                dv[:, col] += torch.einsum("bkgqt,bqkgh->btkh", p, do_blk)
                dk[:, col] += torch.einsum("bkgqt,bqkgh->btkh", ds, q_blk)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """The chunked attention with the reference's FlashAttention backward
    (``flash_attention``'s ``custom_vjp``): ``apply(q, k, v, qpos, kpos,
    window, causal, scale, cq, ck, live, mesh)`` with ``live`` the
    :meth:`TileTable.live` table both directions walk."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, window, causal, scale, cq, ck,
                live, mesh=None):
        out, lse = _fwd_impl(q, k, v, qpos, kpos, window, causal=causal,
                             scale=scale, cq=cq, ck=ck, live=live)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.args = (window, causal, scale, cq, ck, live, mesh)
        return out

    @staticmethod
    def backward(ctx, dout):
        from .shard_ctx import constrain_m

        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        window, causal, scale, cq, ck, live, mesh = ctx.args
        # the reference pins the full-sequence operands seq-replicated
        q, dout, out, k, v = (constrain_m(mesh, t, "dp", None, "model", None)
                              for t in (q, dout, out, k, v))
        dq, dk, dv = _bwd_impl(q, k, v, qpos, kpos, out, lse, dout, window,
                               causal=causal, scale=scale, cq=cq, ck=ck,
                               live=live)
        return (dq, dk, dv) + (None,) * 9


def flash_attention(q, k, v, qpos, kpos, window, causal: bool, scale: float,
                    cq: int, ck: int, mesh=None, *,
                    live: Optional[np.ndarray] = None) -> torch.Tensor:
    """Chunked attention.  q [B,Sq,H,hd]; k/v [B,T,KV,hd]; qpos [B,Sq];
    kpos [B,T] (-1 = dead slot); window: int (0 = none).  ``mesh`` pins
    the backward's full-sequence operands to the reference's layouts
    (``shard_ctx.constrain_m``; no value changes).  ``live``
    (from :meth:`TileTable.live`) is the table of tiles to compute; without
    it the call reads the positions' chunk extrema itself.  Differentiable
    in ``q``, ``k`` and ``v`` (:class:`FlashAttention`).
    Returns [B, Sq, H, hd] in q.dtype."""
    window = int(window)
    if q.shape[1] % cq or k.shape[1] % ck:
        raise ValueError(f"chunks ({cq}, {ck}) do not tile "
                         f"({q.shape[1]}, {k.shape[1]})")
    if live is None:
        live = TileTable(qpos, kpos, cq, ck).live(window, causal)
    return FlashAttention.apply(q, k, v, qpos, kpos, window, causal, scale,
                                cq, ck, live, mesh)
