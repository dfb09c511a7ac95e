"""Plain torch version of B5 (no blocking): the torch twin of the JAX
package's ``decode_attention_ref``, with the semantics of its kernel path
``decode_attention`` where the two differ.

They differ on a row with no live slot: the Pallas kernel returns 0
(``acc / max(l, 1e-30)`` with ``l = 0``), while ``decode_attention_ref``
softmaxes a row of ``-2e38`` scores into the mean of ``v``.  This version
returns 0, as the kernel does.
"""
from __future__ import annotations

import torch

__all__ = ["decode_attention_plain"]


def decode_attention_plain(
    q: torch.Tensor,  # [B, 1, H, hd] or [B, H, hd]
    k: torch.Tensor,  # [B, T, KV, hd]
    v: torch.Tensor,  # [B, T, KV, hd]
    pos: torch.Tensor,  # [B, T] stored absolute positions (-1 = empty)
    cur: torch.Tensor,  # [B] absolute position of the new token
    *,
    window: int = 0,
) -> torch.Tensor:
    """Returns [B, H, hd] attention output (f32)."""
    if q.dim() == 4:
        q = q[:, 0]
    b, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) * hd**-0.5
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window > 0:
        valid = valid & (pos > cur[:, None] - window)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # empty row
    p = torch.exp(s - m)  # 0 on every dead slot
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(b, h, hd)
