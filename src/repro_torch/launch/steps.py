"""Step functions: the torch twin of the JAX package's
``repro/launch/steps.py`` — the train step (with microbatching and int8
gradient compression), prefill and decode.

The reference jit-compiles these steps; the port runs them eagerly.
``make_prefill_step`` and ``make_decode_step`` run under
``torch.inference_mode()`` (``Model.prefill`` and ``Model.decode_step``
enter it); the train step differentiates ``Model.forward`` with
``torch.autograd.grad``.
"""
from __future__ import annotations

import contextlib

import torch

from ..checkpoint.store import _flatten, _unflatten
from ..configs.base import TrainConfig
from ..distributed.sharding import _all_reduce, _axis_size, data_axes
from ..models.model import Model
from ..models.shard_ctx import shard_scope
from ..optim import OptState, adamw_update, compress, decompress

__all__ = ["cross_entropy", "make_decode_step", "make_prefill_step",
           "make_train_step"]

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE. logits [B,S,V] (f32), labels [B,S] integer.

    The reference contracts a one-hot of the labels against the logits (a
    gather over a vocab-sharded dim would replicate them); on one card a
    gather of each label's logit gives the same value."""
    logits = logits.float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    label_logit = torch.take_along_dim(logits, labels[..., None].long(),
                                       dim=-1)[..., 0]
    return torch.mean(lse - label_logit)


def _leaf(p: torch.Tensor) -> torch.Tensor:
    """A fresh autograd leaf on ``p``'s storage (a copy when ``p`` was made
    under ``torch.inference_mode()``, which autograd cannot record)."""
    p = p.clone() if p.is_inference() else p.detach()
    return p.requires_grad_()


def make_train_step(
    model: Model,
    tc: TrainConfig,
    aux_weight: float = 0.01,
    unroll: bool = False,
    param_shardings=None,
    *,
    donate: bool = False,
):
    """(params, opt, batch) -> (params, opt, metrics).

    ``tc.microbatches > 1`` accumulates the gradients of batch chunks in f32
    (the activation-memory lever) and divides by their count;
    ``tc.grad_compress`` applies int8 error-feedback quantization to the
    gradient before the optimizer, with the error from
    ``batch["_grad_error"]`` (zeros without it).  ``metrics`` holds
    ``loss`` (``ce + aux_weight * aux``), ``ce``, ``grad_norm`` and ``lr``
    as 0-d tensors.  ``donate=True`` updates ``params`` and ``opt`` in
    place, as the reference's jitted step donates them
    (``donate_argnums=(0, 1)``); the caller must not read the old values.

    ``param_shardings`` (``distributed.sharding.param_shardings``' tree, the
    plan) makes the step data-parallel over the plan mesh's data axes: the
    batch is this rank's block of the global batch (``sharded_batches``
    with a spec that shards it over those axes), the forward runs in that
    mesh's scope, and the gradient, ``loss`` and ``ce`` are averaged over
    the data axes with an f32 all-reduce — the reduction XLA makes
    implicitly in the reference's one program.  Compression and AdamW
    then run on the averaged gradient as without a plan; parameters and
    optimizer state stay replicated.
    """
    mesh = _plan_mesh(param_shardings)

    def loss_fn(params, batch):
        with (contextlib.nullcontext() if mesh is None
              else shard_scope(mesh, batch_axes=data_axes(mesh))):
            logits, aux = model.forward(params, batch, remat=tc.remat,
                                        unroll=unroll)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux_weight * aux, ce

    def grads_of(params, batch):
        flat, _ = _flatten(params)
        leaves = [_leaf(p) for p in flat]
        with torch.enable_grad():
            loss, ce = loss_fn(_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return _unflatten(params, grads), loss.detach(), ce.detach()

    def train_step(params, opt: OptState, batch):
        inputs = {k: v for k, v in batch.items() if k != "_grad_error"}
        if tc.microbatches > 1:
            k = tc.microbatches
            chunks = {name: x.chunk(k) for name, x in inputs.items()}
            gsum = lsum = csum = None
            for i in range(k):
                g, l, c = grads_of(params, {n: x[i] for n, x in
                                            chunks.items()})
                flat, _ = _flatten(g)
                if gsum is None:
                    gsum = [t.float() for t in flat]
                    lsum, csum = l, c
                else:
                    for acc, t in zip(gsum, flat):
                        acc.add_(t.float())
                    lsum, csum = lsum + l, csum + c
                del g, flat
            grads = _unflatten(params, [t / k for t in gsum])
            loss, ce = lsum / k, csum / k
        else:
            grads, loss, ce = grads_of(params, inputs)
        if mesh is not None:
            grads, loss, ce = _data_mean((grads, loss, ce), mesh)

        if tc.grad_compress:
            err = batch.get("_grad_error")
            if err is None:
                flat, _ = _flatten(grads)
                err = _unflatten(grads, [torch.zeros(g.shape,
                                                     dtype=torch.float32,
                                                     device=g.device)
                                         for g in flat])
            q, scales, _ = compress(grads, err)
            grads = decompress(q, scales)

        with torch.no_grad():
            params, opt, om = adamw_update(grads, opt, params, tc,
                                           inplace=donate)
        metrics = {"loss": loss, "ce": ce, **om}
        return params, opt, metrics

    return train_step


def _plan_mesh(plan):
    """The mesh of a plan tree's first leaf (None without a plan)."""
    if plan is None:
        return None
    while isinstance(plan, dict):
        plan = next(iter(plan.values()))
    return plan.mesh


def _data_mean(tree, mesh):
    """Every tensor of ``tree`` in f32, averaged over the mesh's data axes
    (one ``SUM`` all-reduce a tensor and dim, then a division by the
    count)."""
    import torch.distributed as dist

    names = data_axes(mesh)
    n = _axis_size(mesh, names)
    flat, _ = _flatten(tree)
    out = [_all_reduce(t.clone() if t.dtype == torch.float32 else t.float(),
                       mesh, names, dist.ReduceOp.SUM).div_(n) for t in flat]
    return _unflatten(tree, out)


def make_prefill_step(model: Model, unroll: bool = False):
    """(params, batch) -> (last-token logits, primed decode cache)."""

    def prefill_step(params, batch):
        return model.prefill(params, batch, unroll=unroll)

    return prefill_step


def make_decode_step(model: Model, sample: bool = False):
    """(params, cache, tokens[B,1]) -> (next_tokens[B,1], logits, cache).

    ``sample`` is kept for the reference's signature: both pick the argmax.
    """

    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return decode_step
