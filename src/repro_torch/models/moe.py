"""Mixture-of-experts FFN, top-k token-choice routing with static capacity:
the torch twin of the JAX package's ``repro/models/moe.py``.

Two execution paths, as in the reference:

  * :func:`moe_ffn` — the single-program formulation: a global stable sort
    of the token-expert assignments by expert, capacity buckets
    ``[E, cap, d]``, one batched product per expert matrix, and the
    inverse gather.
  * :func:`moe_ffn_ep` — the expert-parallel path over a mesh's ``model``
    dim.  Where the reference runs a ``shard_map``, each rank works on the
    block the reference's ``in_specs`` give its mesh coordinates (its token
    shard, routed locally with ``moe_capacity`` of the local token count;
    its experts, rows ``[j*e_loc, (j+1)*e_loc)``, held as the plan's
    blocks), exchanges capacity buckets with one ``all_to_all_single``
    over the ``model`` group and reverses it with a second, and returns
    the global ``y`` and the aux loss averaged over every rank.  In the
    training layout the FSDP'd expert weights are gathered over the data
    axes on use; in the serving layout (``s == 1``) experts are laid out
    experts x model, ffn x data and the down-projection partials are
    summed over the data axes.  Every collective carries its gradient
    (``distributed.sharding``: the exchange's transpose is the reverse
    exchange), so the layer trains.

``moe_apply`` dispatches as the reference's does: EP under a scope whose
``model`` dim is > 1.  Under a scope whose batch is sharded (the train
step's, ``shard_ctx.batch_axes``), the training layout routes this rank's
block of the batch as it is (its data block is the reference's token
shard); serving and the single-program path first gather the tokens over
those dims, so that routing and capacity see the global batch as the
reference's one program does, and keep this rank's block of ``y``.

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


def moe_ffn_ep(p, x: torch.Tensor, cfg: ModelConfig, mesh,
               specs=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh`` (see the module docstring): the
    global x [B, S, d] on every rank -> (the global y, the aux loss
    averaged over every rank).  ``p``: this rank's blocks under ``specs``
    (the plan's specs of the moe leaves), or the global leaves when
    ``specs`` is None.  Falls back to :func:`moe_ffn` where the topology
    does not divide, as the reference does."""
    b, s, d = x.shape
    dp = _data(mesh)
    if not _ep_fits(cfg, mesh, b, s):
        return moe_ffn(_whole(p, specs, mesh, ()), x, cfg)
    p, specs = _ep_blocks(p, specs, mesh, s == 1)
    if s == 1:
        return _ep(p, specs, x, cfg, mesh, serving=True, aux_partial=())
    # the training layout: this rank's (data, model) block of the tokens
    from ..distributed.sharding import gather, split

    xl = split(x, mesh, dp, 0) if dp else x
    y, aux = _ep(p, specs, xl, cfg, mesh, serving=False, aux_partial=())
    return (gather(y, mesh, dp, 0, partial=False) if dp else y), aux


def _data(mesh) -> tuple:
    """The mesh's data axes of more than one rank."""
    from ..distributed.sharding import _axes, data_axes

    return tuple(a for a in data_axes(mesh) if _axes(mesh)[a] > 1)


def _ep_fits(cfg: ModelConfig, mesh, b: int, s: int) -> bool:
    """Whether the expert-parallel layout divides (``b``, ``s``: the
    global batch and sequence)."""
    from ..distributed.sharding import _axes, _axis_size

    msize = _axes(mesh).get("model", 1)
    dsize = _axis_size(mesh, _data(mesh))
    return not (cfg.n_experts % msize or (dsize > 1 and b % dsize)
                or (s > 1 and s % msize))


def _ep_blocks(p, specs, mesh, serving: bool):
    """(blocks, specs): ``p`` as given when ``specs`` is set, else this
    rank's blocks of the global leaves in the layout of the reference's
    ``shard_map``: experts x model with d_model FSDP'd over data
    (training), or ffn over data (serving), the router whole."""
    if specs is not None:
        return p, specs
    from ..distributed.sharding import PartitionSpec as P, _axes, _block
    from ..distributed.sharding import _entry, data_axes

    dpe = _entry(data_axes(mesh))
    m = "model" if "model" in _axes(mesh) else None
    if serving:
        specs = {"up": P(m, None, dpe), "gate": P(m, None, dpe),
                 "down": P(m, dpe, None)}
    else:
        specs = {"up": P(m, dpe, None), "gate": P(m, dpe, None),
                 "down": P(m, None, dpe)}
    specs["router"] = P()
    return {k: _block(p[k], mesh, specs[k]) for k in p}, specs


def _whole(p, specs, mesh, partial):
    """Every moe leaf gathered whole (the single-program path's)."""
    if specs is None:
        return p
    from ..distributed.sharding import use

    return {k: use(p[k], mesh, specs[k], partial=partial) for k in p}


def _ep(p, specs, x: torch.Tensor, cfg: ModelConfig, mesh, *, serving: bool,
        aux_partial: tuple, seq_block: bool = False):
    """The expert-parallel layer on this rank's tokens ``x`` (training:
    its data block [b, s, d], cut here to its sequence block over 'model',
    or that block already with ``seq_block``; serving: every token):
    route locally with the capacity of the local token count, exchange
    capacity buckets with the experts' owners over 'model' and back, and
    return (this rank's y, the aux loss averaged over every rank).
    ``aux_partial``: the mesh dims over which the loss the aux enters
    differs (a sharded batch's), whose gradients it sums."""
    from ..distributed.sharding import (
        _axes, _axis_size, _names, all_to_all, gather, reduce_sum, split,
        use)

    b, s, d = x.shape
    e = cfg.n_experts
    axes = _axes(mesh)
    msize = axes.get("model", 1)
    dp = _data(mesh)
    seq_shard = not serving and msize > 1
    cut = seq_shard and not seq_block
    xl = split(x, mesh, ("model",), 1) if cut else x
    b_l, s_l, _ = xl.shape
    t_l = b_l * s_l
    cap = moe_capacity(t_l, cfg)
    # the ranks route different tokens: their gradients of the leaves sum
    tokens = () if serving else dp
    router = use(p["router"], mesh, specs["router"],
                 partial=tokens + (("model",) if seq_shard else ()))
    bucket, dispatch, aux = _route(xl.reshape(t_l, d), router, cfg, cap)
    every = tuple(a for a in axes if axes[a] > 1)
    aux = reduce_sum(aux, mesh, every, aux_partial) / _axis_size(mesh, every)

    # the serving layout's ffn over data: each rank holds a slice of it
    ffn = tuple(n for n in _names(specs["up"][2]) if n in dp)
    up, gate, down = (use(p[k], mesh, specs[k], keep=("model",) + ffn,
                          partial=tokens) for k in ("up", "gate", "down"))
    e_loc = up.shape[0]
    # dispatch: experts are contiguous in the bucket, so peer j's experts
    # are rows [j*e_loc, (j+1)*e_loc)
    if msize > 1:
        group = mesh.get_group("model")
        recv = all_to_all(bucket, group).reshape(msize, e_loc, cap, d)
        recv = recv.transpose(0, 1).reshape(e_loc, msize * cap, d)
    else:
        recv = bucket
    out = _experts(recv, up, gate, down)  # serving: the local ffn slice
    if ffn:
        out = reduce_sum(out, mesh, ffn, ())
    if msize > 1:
        out = out.reshape(e_loc, msize, cap, d).transpose(0, 1)
        out = all_to_all(out, group).reshape(e, cap, d)  # [E, cap, d]
    y = _unroute(out, dispatch, t_l, d, x.dtype).reshape(b_l, s_l, d)
    if cut:
        y = gather(y, mesh, ("model",), 1, partial=False)
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, specs=None):
    """Dispatch: EP under a mesh scope whose ``model`` dim is > 1, the
    single-program path otherwise.  ``p``: this rank's blocks under
    ``specs`` (the plan's), or the global leaves when ``specs`` is None.
    Under a scope whose batch is sharded (``batch_axes``), ``x`` is this
    rank's block: the training layout routes it as it is (its data block
    is the reference's shard); serving and the single-program path gather
    the tokens over those dims first and keep this rank's block of y.

    Under sequence parallelism (``shard_ctx.seq_split``) ``x`` is this
    rank's block of the sequence over 'model' too: where the batch is a
    block over every data axis, that is the reference's token shard of
    the training layout, which routes it as it is; any other path takes
    the sequence gathered and keeps its block of y."""
    from ..distributed.sharding import (
        PartitionSpec, _axes, _axis_size, _block, _entry, gather)
    from .layers import stream_inputs, stream_output
    from .shard_ctx import batch_axes, current_mesh, seq_scope, seq_split

    mesh = current_mesh()
    if mesh is None:
        return moe_ffn(p, x, cfg)
    names = tuple(a for a in batch_axes() if _axes(mesh)[a] > 1)
    b, s, _ = x.shape
    if seq_split():
        if names == _data(mesh) and _ep_fits(
                cfg, mesh, b * _axis_size(mesh, names),
                s * _axes(mesh)["model"]):
            p, specs = _ep_blocks(p, specs, mesh, False)
            return _ep(p, specs, x, cfg, mesh, serving=False,
                       aux_partial=names, seq_block=True)
        with seq_scope(False):
            y, aux = moe_apply(p, stream_inputs(x, False)[0], cfg, specs)
        return stream_output(y), aux
    ep = (_axes(mesh).get("model", 1) > 1
          and _ep_fits(cfg, mesh, b * _axis_size(mesh, names), s))
    if not names:
        if ep:
            return moe_ffn_ep(p, x, cfg, mesh, specs)
        return moe_ffn(_whole(p, specs, mesh, ()), x, cfg)
    if ep and s > 1:
        p, specs = _ep_blocks(p, specs, mesh, False)
        return _ep(p, specs, x, cfg, mesh, serving=False, aux_partial=names)
    xg = gather(x, mesh, names, 0, partial=True)
    if ep:
        p, specs = _ep_blocks(p, specs, mesh, True)
        y, aux = _ep(p, specs, xg, cfg, mesh, serving=True,
                     aux_partial=names)
    else:
        y, aux = moe_ffn(_whole(p, specs, mesh, names), xg, cfg)
    return _block(y, mesh, PartitionSpec(_entry(names))), aux
