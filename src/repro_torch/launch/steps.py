"""Step functions: the torch twin of the JAX package's
``repro/launch/steps.py`` — the train step (with microbatching and int8
gradient compression), prefill and decode.

The reference jit-compiles these steps; the port runs them eagerly.
``make_prefill_step`` and ``make_decode_step`` run under
``torch.inference_mode()`` (``Model.prefill`` and ``Model.decode_step``
enter it); the train step differentiates ``Model.forward`` with
``torch.autograd.grad``.

With a plan (``param_shardings``: ``distributed.sharding.param_shardings``'
tree), a step takes and returns this rank's blocks of the parameters (and
of the moments and the decode cache): the model gathers each layer's
leaves on use and runs attention, the MLP, the vocabulary and the experts
on the rank's block over 'model' (``models/model.py``).
"""
from __future__ import annotations

import contextlib

import torch

from ..checkpoint.store import _flatten, _unflatten
from ..configs.base import TrainConfig
from ..distributed.sharding import (
    _all_reduce, _axis_size, _gather, data_axes, reduce_sum)
from ..models.model import Model
from ..models.shard_ctx import shard_scope
from ..optim import OptState, adamw_update, compress, decompress

__all__ = ["cross_entropy", "make_decode_step", "make_prefill_step",
           "make_train_step"]

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """Mean token CE. logits [B,S,V] (f32), labels [B,S] integer.

    The reference contracts a one-hot of the labels against the logits (a
    gather over a vocab-sharded dim would replicate them).  Without
    ``mesh`` a gather of each label's logit gives the same value.  With
    ``mesh``, ``logits`` is this rank's block of the vocabulary over its
    'model' dim, and the max, the sum of exponents and the label's logit
    (from the rank whose block holds it, zero elsewhere) are each reduced
    over 'model': the reference's gather-free form, partitioned."""
    logits = logits.float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    if mesh is None:
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        label_logit = torch.take_along_dim(logits, labels[..., None].long(),
                                           dim=-1)[..., 0]
        return torch.mean(lse - label_logit)
    import torch.distributed as dist

    model = ("model",)
    m = _all_reduce(m, mesh, model, dist.ReduceOp.MAX)
    sumexp = reduce_sum(torch.exp(logits - m).sum(dim=-1), mesh, model)
    lse = torch.log(sumexp) + m[..., 0]
    v = logits.shape[-1]
    local = labels.long() - v * mesh.get_local_rank("model")
    mine = (local >= 0) & (local < v)
    label_logit = torch.take_along_dim(
        logits, torch.where(mine, local, 0)[..., None], dim=-1)[..., 0]
    label_logit = reduce_sum(torch.where(mine, label_logit, 0.0), mesh, model)
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
    plan) makes the step ZeRO-3 over the plan mesh's data axes and tensor
    parallel over its 'model' dim: ``params`` and ``opt`` are this rank's
    blocks (``sharding.shard_params``), and so are the returned ones; the
    batch is this rank's block of the global batch (``sharded_batches``
    with a spec that shards it over the data axes).  The forward runs in
    the mesh's scope and gathers each layer's leaves on use; their
    backward sums the gradients of the data axes' ranks into each block
    (a reduce-scatter in f32), from a loss divided by the data count, so
    the f32 microbatch accumulator holds blocks of the mean gradient, as
    the reference pins it to the parameter layout.  ``loss`` and ``ce``
    are averaged over the data axes; the norm, compression and AdamW run
    on the blocks (``global_norm`` sums over the ranks).
    """
    mesh = _plan_mesh(param_shardings)
    n_data = 1 if mesh is None else _axis_size(mesh, data_axes(mesh))

    def loss_fn(params, batch):
        with _step_scope(mesh, param_shardings):
            logits, aux = model.forward(params, batch, remat=tc.remat,
                                        unroll=unroll)
            ce = cross_entropy(logits, batch["labels"], model.vocab_mesh())
        return ce + aux_weight * aux, ce

    def grads_of(params, batch):
        flat, _ = _flatten(params)
        leaves = [_leaf(p) for p in flat]
        with torch.enable_grad():
            loss, ce = loss_fn(_unflatten(params, leaves), batch)
            # each rank's share of the mean over the data axes' batch
            grads = torch.autograd.grad(loss / n_data if n_data > 1
                                        else loss, leaves, allow_unused=True)
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
            loss, ce = _data_mean((loss, ce), mesh)

        if tc.grad_compress:
            err = batch.get("_grad_error")
            if err is None:
                flat, _ = _flatten(grads)
                err = _unflatten(grads, [torch.zeros(g.shape,
                                                     dtype=torch.float32,
                                                     device=g.device)
                                         for g in flat])
            q, scales, _ = compress(grads, err, param_shardings)
            grads = decompress(q, scales)

        with torch.no_grad():
            params, opt, om = adamw_update(grads, opt, params, tc,
                                           inplace=donate,
                                           plan=param_shardings)
        metrics = {"loss": loss, "ce": ce, **om}
        return params, opt, metrics

    return train_step


def _step_scope(mesh, plan, cache_plan=None, batch_axes=None):
    """The scope a step with a plan runs its model call in (none without
    one): the batch a block over ``batch_axes`` (default: the mesh's data
    axes), the parameters held under ``plan``."""
    if mesh is None:
        return contextlib.nullcontext()
    return shard_scope(mesh, plan=plan, cache_plan=cache_plan,
                       batch_axes=data_axes(mesh) if batch_axes is None
                       else batch_axes)


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


def make_prefill_step(model: Model, unroll: bool = False,
                      param_shardings=None, *, cache_shardings=None,
                      max_len=None, batch_axes=None):
    """(params, batch) -> (last-token logits, primed decode cache).

    With a plan (``param_shardings``, ``param_pspecs(fsdp=True)``'s) the
    parameters are this rank's blocks and the batch its block over
    ``batch_axes`` (default: the data axes); the logits are the rank's
    block of the vocabulary where the plan splits it, and the cache is held
    as ``cache_shardings`` (``cache_pspecs``' tree of the decode cache;
    default: of the cache this prefill makes).  ``max_len`` sizes the
    cache (``Model.prefill``)."""
    mesh = _plan_mesh(param_shardings)

    def prefill_step(params, batch):
        with _step_scope(mesh, param_shardings, cache_shardings, batch_axes):
            return model.prefill(params, batch, unroll=unroll,
                                 max_len=max_len)

    return prefill_step


def make_decode_step(model: Model, sample: bool = False,
                     param_shardings=None, *, cache_shardings=None,
                     batch_axes=None):
    """(params, cache, tokens[B,1]) -> (next_tokens[B,1], logits, cache).

    ``sample`` is kept for the reference's signature: both pick the argmax.
    With a plan (``param_pspecs(fsdp=False, moe_2d=True)``'s, the serving
    layout) the parameters and the cache (held as ``cache_shardings``) are
    this rank's blocks and the tokens its block over ``batch_axes``
    (default: the data axes); the logits are its block of the vocabulary
    where the plan splits it, and the argmax is taken over the whole
    vocabulary (each rank's best, gathered over 'model').
    """
    mesh = _plan_mesh(param_shardings)

    def decode_step(params, cache, tokens):
        with _step_scope(mesh, param_shardings, cache_shardings, batch_axes):
            logits, cache = model.decode_step(params, cache, tokens)
            vocab = model.vocab_mesh()
        with torch.inference_mode():
            nxt = _argmax(logits, vocab)
        return nxt.to(torch.int32)[:, None], logits, cache

    return decode_step


def _argmax(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The first index of the largest logit of each row; with ``mesh``,
    over the vocabulary whose blocks the ranks of 'model' hold."""
    if mesh is None:
        return torch.argmax(logits, dim=-1)
    v = logits.shape[-1]
    best, idx = logits.max(dim=-1)
    idx = idx + v * mesh.get_local_rank("model")
    best = _gather(best[None], mesh, ("model",), 0)  # [model, B]
    idx = _gather(idx[None], mesh, ("model",), 0)
    # the first block holding the largest value: the lowest index
    return idx.gather(0, best.argmax(dim=0)[None])[0]
