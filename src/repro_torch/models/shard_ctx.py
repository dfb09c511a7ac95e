"""Scoped activation-sharding context: the torch twin of the JAX package's
``repro/models/shard_ctx.py``.

``shard_scope`` installs a mesh for the duration of one model call (a
``contextvars`` scope); ``constrain_heads``, ``constrain`` and
``constrain_m`` then name the layouts the reference pins attention's
projected q/k/v and the MLP's hidden to.  They change no value in the
reference, and here they are the identity on plain tensors; a ``DTensor``
is redistributed to the placements they name.  Outside a scope every call
is a no-op, as in the reference.

The scope also carries which mesh dims the batch of this rank's model call
is sharded over (``batch_axes``): the data-parallel train step runs each
rank's forward on its own block of the batch, where the reference's one
program sees the whole batch; ``moe_apply`` reads it to route the global
batch as the reference does.
"""
from __future__ import annotations

import contextlib
import contextvars

from ..distributed.sharding import (
    PartitionSpec, _axes, _axis_size, _is_dtensor, constrain as _c)

__all__ = ["batch_axes", "constrain", "constrain_heads", "constrain_m",
           "current_mesh", "shard_scope"]

_VAR: contextvars.ContextVar = contextvars.ContextVar("repro_shard_ctx",
                                                      default=None)
_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_shard_ctx_batch", default=())


@contextlib.contextmanager
def shard_scope(mesh, *, batch_axes: tuple = ()):
    """Install ``mesh`` (or None) as the ambient activation-sharding mesh;
    ``batch_axes``: the mesh dims this rank's batch is a block of (none:
    every rank holds the whole batch)."""
    token = _VAR.set(mesh)
    btoken = _BATCH.set(tuple(batch_axes) if mesh is not None else ())
    try:
        yield
    finally:
        _BATCH.reset(btoken)
        _VAR.reset(token)


def current_mesh():
    return _VAR.get()


def batch_axes() -> tuple:
    """The mesh dims the current scope's batch is sharded over."""
    return _BATCH.get()


def _dp_entry(mesh):
    from ..distributed.sharding import data_axes

    axes = data_axes(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def constrain_m(mesh, x, *entries):
    """Mesh-explicit layout pin with per-dim divisibility fallback.
    ``entries`` align with x's dims; 'dp' maps to the data axes, any other
    string is a mesh axis; None = unsharded."""
    if mesh is None or not _is_dtensor(x):
        return x
    axes = _axes(mesh)
    spec = []
    for dim, e in zip(x.shape, entries):
        entry = _dp_entry(mesh) if e == "dp" else e
        names = entry if isinstance(entry, tuple) else (entry,)
        if (entry is None or any(n not in axes for n in names)
                or dim % _axis_size(mesh, entry) != 0):
            spec.append(None)
        else:
            spec.append(entry)
    return _c(x, mesh, PartitionSpec(*spec))


def constrain(x, *entries):
    """Context-var flavor of :func:`constrain_m` (forward-path use)."""
    return constrain_m(_VAR.get(), x, *entries)


def constrain_heads(q, k, v):
    """Pin projected attention tensors: batch x DP, seq replicated, heads x
    model where divisible."""
    if _VAR.get() is None:
        return q, k, v
    q = constrain(q, "dp", None, "model", None)
    k = constrain(k, "dp", None, "model", None)
    v = constrain(v, "dp", None, "model", None)
    return q, k, v
