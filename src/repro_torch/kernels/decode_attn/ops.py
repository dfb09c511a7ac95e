"""Cache-layout plumbing of B5: the torch twin of the JAX package's
``repro/kernels/decode_attn/ops.py``.

``decode_attention`` is the decode-attention math of
``repro_torch.models.attention.attn_decode`` after the cache update: it takes
the [B, T, KV, hd] cache, the per-slot stored positions and the current
position, picks the cache block the reference's way and streams only the
blocks that hold a live slot through the kernel.  The reference computes
that chunk-activity test (:func:`live_blocks`) in its wrapper and
scalar-prefetches it; the CUDA kernel tests the positions of each 16-slot
piece of a block itself and reads only live pieces, so the sum runs over
the same slots.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from .kernel import decode_attn_cuda, decode_attn_op
from .ref import decode_attention_plain

__all__ = ["block_size", "decode_attention", "live_blocks"]


def block_size(t: int, block_t: int = 128) -> int:
    """The reference's cache block: ``min(block_t, t)``, stepped down until
    it divides ``t``."""
    bt = min(block_t, t)
    while t % bt:
        bt -= 1
    return bt


def live_blocks(pos: torch.Tensor, cur: torch.Tensor, bt: int,
                window: int = 0) -> torch.Tensor:
    """[B, T/bt] bool: does cache block i hold any live slot of row b (the
    reference's ``needed``)."""
    b, t = pos.shape
    pb = pos.reshape(b, t // bt, bt)
    c = cur[:, None, None]
    live = (pb >= 0) & (pb <= c)
    if window > 0:
        live = live & (pb > c - window)
    return live.any(dim=2)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd] or [B, H, hd] new-token queries
    k: torch.Tensor,  # [B, T, KV, hd]
    v: torch.Tensor,  # [B, T, KV, hd]
    pos: torch.Tensor,  # [B, T] int32 stored absolute positions (-1 = empty)
    cur: torch.Tensor,  # [B] int32 absolute position of the new token
    *,
    window: int = 0,
    block_t: int = 128,
    interpret: bool = True,
) -> torch.Tensor:
    """Returns [B, H, hd] attention output (f32).

    On a CUDA tensor this launches B5 or raises; on a meta or fake tensor
    the operator ``torch.ops.repro_torch.decode_attn`` gives the output's
    shape (a traced step); on a CPU tensor it runs the plain version.
    Under a dispatch mode (``FlopCounterMode``, a fake-tensor trace) a CUDA
    call goes through the operator too, so that the mode sees B5; with
    none, it launches the operator's CUDA kernel directly, without the
    operator's dispatch (~20 us of host time a call on the H100's host).
    ``interpret`` is kept for the reference's signature and ignored: the
    tensor's device decides (ROADMAP §C P4).
    """
    if q.dim() == 4:
        q = q[:, 0]
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, cur, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no decode attention for device {q.device}")
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    qg = q.reshape(b, kv, h // kv, hd)
    bt = block_size(t, block_t)
    if q.device.type == "cuda" and _get_current_dispatch_mode() is None:
        out = decode_attn_cuda(qg, k, v, pos, cur, window=int(window),
                               block_t=bt)
    else:
        out = decode_attn_op(qg, k, v, pos, cur, int(window), bt)
    return out.reshape(b, h, hd)
