"""AdamW with warmup+cosine schedule and global-norm clipping (functional):
the torch port of ``repro.optim.adamw``.

Parameters stay in their own dtype (bf16 for most); first/second moments
are f32.  The update math runs in f32 in the reference's order — the clip
scale, then ``m``, ``v``, the bias corrections and the decayed delta — and
casts back.  Trees are the parameter trees of the port (nested dicts of
tensors), walked in JAX's leaf order (dict keys sorted).

``adamw_update`` returns new tensors and leaves its inputs as they were.
``inplace=True`` writes the new parameters and moments into the given
tensors instead (the reference's jitted step donates them,
``donate_argnums=(0, 1)``): at gemma-2b's width the old and new moments
would otherwise both be live, 20 GB more of the card.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..checkpoint.store import _flatten, _unflatten
from ..configs.base import TrainConfig

__all__ = ["OptState", "adamw_init", "adamw_update", "global_norm", "lr_at"]


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def _zeros_f32(tree):
    leaves, _ = _flatten(tree)
    return _unflatten(tree, [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) for p in leaves])


def adamw_init(params) -> OptState:
    leaves, _ = _flatten(params)
    return OptState(
        m=_zeros_f32(params),
        v=_zeros_f32(params),
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    )


def lr_at(step: torch.Tensor, tc: TrainConfig,
          total_steps: int = 10_000) -> torch.Tensor:
    """Linear warmup to ``tc.learning_rate``, then a cosine to 0 at
    ``total_steps``; f32 like the reference's."""
    step = torch.as_tensor(step)
    warm = tc.learning_rate * (step + 1) / max(tc.warmup_steps, 1)
    prog = torch.clip(
        (step - tc.warmup_steps) / max(total_steps - tc.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * tc.learning_rate * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < tc.warmup_steps, warm, cos).to(torch.float32)


def global_norm(tree, plan=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  Under ``plan`` (the
    :class:`~repro_torch.distributed.sharding.NamedSharding` tree the
    leaves are this rank's blocks of) each block's squared sum is summed
    over the mesh dims its leaf is laid over, and over no other: a mesh dim
    the leaf is replicated on holds it whole on every rank."""
    leaves, _ = _flatten(tree)
    squares = [torch.sum(torch.square(l.float())) for l in leaves]
    if plan is None:
        return torch.sqrt(sum(squares))
    import torch.distributed as dist

    from ..distributed.sharding import _all_reduce, _split_dims

    shardings, _ = _flatten(plan)
    groups: dict = {}  # the mesh dims a leaf is laid over -> its squares
    for sq, s in zip(squares, shardings):
        names = tuple(n for _, ns in _split_dims(s.spec, s.mesh) for n in ns)
        groups.setdefault((id(s.mesh), tuple(sorted(names))),
                          (s.mesh, []))[1].append(sq)
    total = 0
    for (_, names), (mesh, sqs) in groups.items():
        part = sum(sqs)  # in leaf order, as without a plan
        if names:
            part = _all_reduce(part, mesh, names, dist.ReduceOp.SUM)
        total = total + part
    return torch.sqrt(total)


def adamw_update(grads, state: OptState, params, tc: TrainConfig, *,
                 inplace: bool = False, plan=None):
    """Returns (new_params, new_state, metrics ``grad_norm`` and ``lr``).
    Under ``plan`` the trees are this rank's blocks: the norm sums over the
    ranks (:func:`global_norm`), the clip and the update are elementwise
    on each block."""
    gnorm = global_norm(grads, plan)
    scale = torch.clamp(tc.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(state.step, tc)
    b1, b2 = tc.b1, tc.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        del g
        denom = torch.sqrt(v_new / bc2).add_(1e-8)
        delta = (m_new / bc1).div_(denom)
        del denom
        p32 = p.to(torch.float32, copy=True)  # f32 leaves too (the router)
        delta.add_(tc.weight_decay * p32).mul_(lr)
        p32.sub_(delta)
        del delta
        if not inplace:
            return p32.to(p.dtype), m_new, v_new
        p.copy_(p32)
        m.copy_(m_new)
        v.copy_(v_new)
        return p, m, v

    flat_g, _ = _flatten(grads)
    flat_m, _ = _flatten(state.m)
    flat_v, _ = _flatten(state.v)
    flat_p, _ = _flatten(params)
    if not len(flat_g) == len(flat_m) == len(flat_v) == len(flat_p):
        raise ValueError("grads, moments and params differ in structure")
    out = [upd(g, m, v, p) for g, m, v, p in zip(flat_g, flat_m, flat_v,
                                                 flat_p)]
    new_p = _unflatten(params, [o[0] for o in out])
    new_m = _unflatten(state.m, [o[1] for o in out])
    new_v = _unflatten(state.v, [o[2] for o in out])
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm, "lr": lr}
