"""Mixture-of-experts FFN, top-k token-choice routing with static capacity:
the torch twin of the JAX package's ``repro/models/moe.py`` on one card
(``init_moe``, ``moe_capacity``, ``_route``, ``_unroute``, ``moe_ffn`` and
``moe_apply``).

``moe_ffn`` is the reference's single-program formulation: a global
stable sort of the token-expert assignments by expert, capacity buckets
``[E, cap, d]``, one batched product per expert matrix, and the inverse
gather.  The reference's expert-parallel ``moe_ffn_ep`` (a ``shard_map``
over a mesh's ``model`` axis) comes with the multi-card slice (ROADMAP §A
A15.4); ``moe_apply`` takes ``moe_ffn`` whenever there is no such mesh,
which one card never has.

Two choices keep the routing the reference's on every device:

* ``lax.top_k`` breaks ties toward the lower expert index; ``torch.topk``
  promises no order among ties, so :func:`_top_k` takes the first k of a
  stable descending sort, which keeps equal probabilities in index order.
* the reference scatter-adds each token's k weighted expert outputs in
  bf16 in the order of the expert-sorted assignments, that is by
  ascending expert id.  :func:`_unroute` adds them in that order, one
  bf16 add after another, with no atomics: two runs give the same bits on
  the card too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .param import Mk

__all__ = ["init_moe", "moe_apply", "moe_capacity", "moe_ffn"]


def init_moe(mk: Mk, cfg: ModelConfig, layers: Optional[int] = None):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": mk.param((d, e), dtype=torch.float32, layers=layers),
        "up": mk.param((e, d, ff), layers=layers),
        "gate": mk.param((e, d, ff), layers=layers),
        "down": mk.param((e, ff, d), layers=layers),
    }


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, ties toward the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xf: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           cap: int):
    """Top-k -> expert-sorted capacity buckets.

    Returns (bucket [E, cap, d], the dispatch (se_c, slot_c, stok, keep,
    sgate, order, expert_idx), the load-balance aux loss)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # [t, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Load-balance auxiliary loss (Switch-style).
    density = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)
    aux = e * (density * probs.mean(dim=0)).sum()

    # sort assignments by expert, the slot within the expert
    dev = xf.device
    flat_e = expert_idx.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, stok, sgate = flat_e[order], flat_tok[order], gate_vals.reshape(-1)[order]
    counts = torch.bincount(se, minlength=e)
    starts = torch.cumsum(counts, dim=0) - counts
    slot = torch.arange(t * k, device=dev) - starts[se]
    keep = slot < cap

    se_c = torch.where(keep, se, 0)
    slot_c = torch.where(keep, slot, cap - 1)
    vals = torch.where(keep[:, None], xf[stok], 0)
    # kept assignments own their slots; dropped ones add zeros to one slot
    bucket = torch.zeros((e, cap, d), dtype=xf.dtype, device=dev)
    bucket.index_put_((se_c, slot_c), vals, accumulate=True)
    return bucket, (se_c, slot_c, stok, keep, sgate, order, expert_idx), aux


def _unroute(out: torch.Tensor, dispatch, t: int, d: int,
             dtype) -> torch.Tensor:
    """Each token's gated expert outputs summed in bf16 by ascending expert
    id (the reference's scatter-add order), in a fixed order of adds."""
    se_c, slot_c, stok, keep, sgate, order, expert_idx = dispatch
    k = expert_idx.shape[1]
    tok_out = out[se_c, slot_c] * torch.where(keep, sgate, 0.0)[:, None].to(
        dtype)
    # the sorted entries back in [token, rank] layout, then each token's
    # ranks by ascending expert
    flat = torch.empty_like(tok_out)
    flat[order] = tok_out
    per_tok = flat.reshape(t, k, d)
    by_expert = torch.argsort(expert_idx, dim=1, stable=True)
    per_tok = per_tok.gather(1, by_expert[..., None].expand(t, k, d))
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    return y


def moe_ffn(p, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], the load-balance aux loss)."""
    b, s, d = x.shape
    t = b * s
    cap = moe_capacity(t, cfg)
    bucket, dispatch, aux = _route(x.reshape(t, d), p["router"], cfg, cap)
    h = F.silu(torch.bmm(bucket, p["gate"])) * torch.bmm(bucket, p["up"])
    out = torch.bmm(h, p["down"])
    return _unroute(out, dispatch, t, d, x.dtype).reshape(b, s, d), aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """The reference's dispatch with no mesh: the single-program path."""
    return moe_ffn(p, x, cfg)
