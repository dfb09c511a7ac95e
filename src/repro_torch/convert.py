"""Carry the reference's device views across into the port.

Each function takes an object with the reference's field names — a
``repro`` ``EdgeChunkStore`` / ``BlockedGraph`` / ``SemGraph``, or any
namespace holding the same fields — reads every array leaf with
``np.asarray`` and builds the port's counterpart on ``device`` (None: the
CUDA device).  Feeding
both packages byte-identical edge stores this way lets a test hold the
port's engine against the reference on the same inputs, and check that the
port's own tilers reproduce them.  :func:`model_params` does the same for
a language model's parameter tree, and :func:`opt_state` for its AdamW
state.  Nothing here imports ``repro``,
``jax`` or ``ml_dtypes``: the objects are read by attribute.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.sem import EdgeChunkStore, SemGraph
from .kernels.spmv.ops import BlockedGraph, blocked_graph
from .optim import OptState

__all__ = ["blocked_view", "edge_store", "model_params", "opt_state",
           "sem_graph"]


def _arr(a, device):
    return None if a is None else torch.as_tensor(np.array(a)).to(device)


def edge_store(store, device=None) -> EdgeChunkStore:
    """The port's :class:`EdgeChunkStore` from a reference chunk store."""
    device = resolve_device(device)
    return EdgeChunkStore(
        major=_arr(store.major, device),
        minor=_arr(store.minor, device),
        w=_arr(store.w, device),
        lo=_arr(store.lo, device),
        hi=_arr(store.hi, device),
        n=int(store.n),
        chunk_size=int(store.chunk_size),
        sorted_by=str(store.sorted_by),
    )


def blocked_view(bg, device=None) -> BlockedGraph:
    """The port's :class:`BlockedGraph` from a reference tile view."""
    return blocked_graph(
        bg.tiles, bg.dbid, bg.sbid, bg.first, bg.last, bg.accum, bg.nnz,
        n=bg.n, bd=bg.bd, bs=bg.bs, semiring=bg.semiring,
        tile_order=getattr(bg, "tile_order", "dest"), device=device,
    )


def sem_graph(sg, device=None) -> SemGraph:
    """The port's :class:`SemGraph` from a reference SEM view (chunk
    stores, CSR arrays and any tile views)."""
    device = resolve_device(device)

    def opt(obj, fn):
        return None if obj is None else fn(obj, device)

    return SemGraph(
        out_store=opt(sg.out_store, edge_store),
        in_store=opt(sg.in_store, edge_store),
        indptr=_arr(sg.indptr, device),
        indices=_arr(sg.indices, device),
        w=_arr(sg.w, device),
        in_indptr=_arr(sg.in_indptr, device),
        in_indices=_arr(sg.in_indices, device),
        in_w=_arr(sg.in_w, device),
        out_degree=_arr(sg.out_degree, device),
        in_degree=_arr(sg.in_degree, device),
        n=int(sg.n),
        m=int(sg.m),
        out_blocked=opt(sg.out_blocked, blocked_view),
        out_blocked_rev=opt(sg.out_blocked_rev, blocked_view),
    )


def _leaf(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy refuses: carry the bits
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def model_params(np_tree, device=None):
    """The port's parameter tree from the JAX package's, read leaf by leaf
    as numpy arrays (``jax.tree.map(np.asarray, params)``): the same nested
    dict keys, shapes, layouts and dtypes, bf16 leaves bit for bit."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, device)

    return walk(np_tree)


def opt_state(np_opt, device=None):
    """The port's :class:`~repro_torch.optim.OptState` from the JAX
    package's, read leaf by leaf as numpy arrays (``jax.tree.map(np.asarray,
    opt)``, read by attribute): the f32 moments ``m`` and ``v`` as
    :func:`model_params` carries a tree, ``step`` a 0-d int32 tensor."""
    device = resolve_device(device)
    return OptState(
        m=model_params(np_opt.m, device),
        v=model_params(np_opt.v, device),
        step=torch.tensor(int(np.asarray(np_opt.step)), dtype=torch.int32,
                          device=device),
    )
