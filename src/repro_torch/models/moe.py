"""Mixture-of-experts FFN, top-k token-choice routing with static capacity:
the torch twin of the JAX package's ``repro/models/moe.py``.

Two execution paths, as in the reference:

  * :func:`moe_ffn` — the single-program formulation: a global stable sort
    of the token-expert assignments by expert, capacity buckets
    ``[E, cap, d]``, one batched product per expert matrix, and the
    inverse gather.
  * :func:`moe_ffn_ep` — the expert-parallel path over a mesh's ``model``
    dim.  Where the reference runs a ``shard_map``, every rank here takes
    the global ``x`` and parameters, works on the local block the
    reference's ``in_specs`` give its mesh coordinates (its token shard,
    routed locally with ``moe_capacity`` of the local token count; its
    experts, rows ``[j*e_loc, (j+1)*e_loc)``), exchanges capacity buckets
    with one ``all_to_all_single`` over the ``model`` group and reverses
    it with a second, and returns the global ``y`` (its blocks gathered
    over the token shards) and the aux loss averaged over every rank.
    In the training layout the FSDP'd expert weights are all-gathered over
    the data group; in the serving layout (``s == 1``) experts are laid
    out experts x model, ffn x data and the down-projection partials are
    summed over the data group.  Forward only: the collectives carry no
    gradient (expert-parallel training waits for ROADMAP §A).

``moe_apply`` dispatches as the reference's does: EP under a scope whose
``model`` dim is > 1.  Under a scope whose batch is sharded (the
data-parallel train step's, ``shard_ctx.batch_axes``), it first gathers the
tokens over those dims, so that routing and capacity see the global batch
as the reference's one program does, and keeps its own block of ``y``.

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

__all__ = ["init_moe", "moe_apply", "moe_capacity", "moe_ffn", "moe_ffn_ep"]


def init_moe(mk: Mk, cfg: ModelConfig, layers: Optional[int] = None):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": mk.param((d, e), ("embed", "experts"), dtype=torch.float32,
                           layers=layers),
        "up": mk.param((e, d, ff), ("experts", "embed", "ffn"), layers=layers),
        "gate": mk.param((e, d, ff), ("experts", "embed", "ffn"),
                         layers=layers),
        "down": mk.param((e, ff, d), ("experts", "ffn", "embed"),
                         layers=layers),
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
    # bincount's count with an op that has meta and fake kernels
    counts = torch.zeros(e, dtype=se.dtype, device=dev).index_add_(
        0, se, torch.ones_like(se))
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


def _experts(bucket, up, gate, down) -> torch.Tensor:
    """The expert FFN over capacity buckets ``[e, c, d]``: one batched
    product a matrix."""
    h = F.silu(torch.bmm(bucket, gate)) * torch.bmm(bucket, up)
    return torch.bmm(h, down)


def moe_ffn(p, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], the load-balance aux loss)."""
    b, s, d = x.shape
    t = b * s
    cap = moe_capacity(t, cfg)
    bucket, dispatch, aux = _route(x.reshape(t, d), p["router"], cfg, cap)
    out = _experts(bucket, p["up"], p["gate"], p["down"])
    return _unroute(out, dispatch, t, d, x.dtype).reshape(b, s, d), aux


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 to peer i; chunk i of the result from peer i."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_ffn_ep(p, x: torch.Tensor, cfg: ModelConfig,
               mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh`` (see the module docstring): the
    global x [B, S, d] on every rank -> (the global y, the aux loss
    averaged over every rank).  Falls back to :func:`moe_ffn` where the
    topology does not divide, as the reference does."""
    import torch.distributed as dist

    from ..distributed.sharding import (
        PartitionSpec as P, _all_reduce, _axes, _axis_size, _block, _entry,
        _gather, data_axes)

    b, s, d = x.shape
    e = cfg.n_experts
    axes = _axes(mesh)
    msize = axes.get("model", 1)
    dp = data_axes(mesh)
    dpe = _entry(dp)
    dsize = _axis_size(mesh, dp) if dp else 1
    if e % msize or (dsize > 1 and b % dsize) or (s > 1 and s % msize):
        return moe_ffn(p, x, cfg)  # topology doesn't divide: dense fallback
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *p.values())):
        raise NotImplementedError(
            "moe_ffn_ep runs forward only: gradients through its "
            "collectives wait for expert-parallel training (ROADMAP §A)")
    e_loc = e // msize
    seq_shard = s % msize == 0 and s > 1
    # serving (decode: s == 1): experts stay resident in a 2D layout
    # (experts x model, ffn x data), decode tokens are replicated over data
    # and the ffn-partial down-projection sums over the data axes.
    serving = s == 1
    x_spec = (P(None, None, None) if serving
              else P(dpe, "model" if seq_shard else None, None))
    t_loc = b if serving else (b // dsize) * (s // msize if seq_shard else s)
    cap = moe_capacity(t_loc, cfg)

    xl = _block(x, mesh, x_spec)
    b_l, s_l, _ = xl.shape
    t_l = b_l * s_l
    bucket, dispatch, aux = _route(xl.reshape(t_l, d), p["router"], cfg,
                                   cap)
    aux = _all_reduce(aux.clone(), mesh, tuple(axes), dist.ReduceOp.SUM)
    aux = aux / _axis_size(mesh, tuple(axes))

    if serving:
        w_specs = (P("model", None, dpe), P("model", None, dpe),
                   P("model", dpe, None))  # up, gate [E, d, ff]; down
    else:
        w_specs = (P("model", dpe, None), P("model", dpe, None),
                   P("model", None, dpe))  # d_model FSDP'd
    up, gate, down = (_block(p[k], mesh, spec) if "model" in axes
                      else _block(p[k], mesh, P(None, *spec[1:]))
                      for k, spec in zip(("up", "gate", "down"), w_specs))
    if dp and not serving:
        # ZeRO-3: gather the FSDP'd d_model dim of the local experts
        up = _gather(up, mesh, dp, 1)
        gate = _gather(gate, mesh, dp, 1)
        down = _gather(down, mesh, dp, 2)

    # dispatch: experts are contiguous in the bucket, so peer j's experts
    # are rows [j*e_loc, (j+1)*e_loc)
    if msize > 1:
        group = mesh.get_group("model")
        recv = _all_to_all(bucket, group).reshape(msize, e_loc, cap, d)
        recv = recv.transpose(0, 1).reshape(e_loc, msize * cap, d)
    else:
        recv = bucket
    out = _experts(recv, up, gate, down)  # serving: the local ffn slice
    if serving and dp:
        out = _all_reduce(out, mesh, dp, dist.ReduceOp.SUM)
    if msize > 1:
        out = out.reshape(e_loc, msize, cap, d).transpose(0, 1)
        out = _all_to_all(out, group).reshape(e, cap, d)  # [E, cap, d]
    y = _unroute(out, dispatch, t_l, d, x.dtype).reshape(b_l, s_l, d)
    # out_specs = x_spec: every rank returns the global y
    if seq_shard and "model" in axes:
        y = _gather(y, mesh, ("model",), 1)
    if dp and not serving:
        y = _gather(y, mesh, dp, 0)
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """Dispatch: EP under a mesh scope whose ``model`` dim is > 1, the
    single-program path otherwise; a batch sharded over the scope's
    ``batch_axes`` is gathered first and this rank's block of y kept."""
    from ..distributed.sharding import (
        _AllGather, _axes, _axis_size, _block, _entry, PartitionSpec)
    from .shard_ctx import batch_axes, current_mesh

    mesh = current_mesh()
    if mesh is None:
        return moe_ffn(p, x, cfg)
    ep = _axes(mesh).get("model", 1) > 1
    names = batch_axes()
    if names and _axis_size(mesh, names) > 1:
        xg = _AllGather.apply(x, mesh, names)
        y, aux = moe_ffn_ep(p, xg, cfg, mesh) if ep else moe_ffn(p, xg, cfg)
        return _block(y, mesh, PartitionSpec(_entry(names))), aux
    if ep:
        return moe_ffn_ep(p, x, cfg, mesh)
    return moe_ffn(p, x, cfg)
