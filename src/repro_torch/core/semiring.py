"""Semirings for vertex-centric message combination (torch port of
``repro.core.semiring``).

``y[k] = combine(y[k], edge_op(x[gather], w))`` over edges.  ``add``
scatters with ``index_add_`` on the CPU, which adds each key's terms one
after another in edge order; on the card ``index_add_`` adds with atomics
in no fixed order, so there a float ``add`` sorts the terms by key
(stably, keeping edge order) and sums each key's run in that order
(:func:`_ordered_add`): two runs give the same bits, from a zero ``y``
the CPU's bits, and a term of ``+0.0`` (an inactive lane of a batched
run) leaves a sum's bits as they are.  ``min``/``max`` scatter with ``scatter_reduce_(...,
include_self=True)``, whose result is the same in any order.  ``max`` on
bool is logical OR (the BFS reachability semiring); torch has no bool
scatter reduction, so bool buffers reduce as uint8 and are cast back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["Semiring", "PLUS_TIMES", "MIN_PLUS", "MAX_TIMES", "OR_AND"]

_REDUCE = {"min": "amin", "max": "amax"}


@dataclasses.dataclass(frozen=True)
class Semiring:
    """Attributes mirror the reference: ``combine`` is one of
    ``add | min | max``, ``identity`` its identity element (fills padding
    lanes and the sentinel vertex row ``n``), ``edge_op`` maps
    (gathered vertex value, edge weight) to the contribution."""

    name: str
    combine: str
    identity: float | bool
    edge_op: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]

    def scatter(self, y: torch.Tensor, keys: torch.Tensor,
                contrib: torch.Tensor) -> torch.Tensor:
        """Scatter-combine ``contrib`` into a copy of ``y`` at rows ``keys``.
        The last row of ``y`` is the sentinel row ``n``, which takes the
        masked terms and which every caller drops; on the card the add
        leaves it as it is (:func:`_ordered_add`)."""
        if self.combine == "add":
            if y.is_cuda and y.is_floating_point():
                return _ordered_add(y, keys, contrib.to(y.dtype))
            return y.index_add(0, keys, contrib.to(y.dtype))
        if self.combine not in _REDUCE:
            raise ValueError(f"unknown combine {self.combine!r}")
        boolean = y.dtype == torch.bool
        buf = y.to(torch.uint8) if boolean else y.clone()
        src = contrib.to(buf.dtype)
        idx = keys.reshape((-1,) + (1,) * (src.ndim - 1)).expand_as(src)
        buf.scatter_reduce_(0, idx, src, _REDUCE[self.combine],
                            include_self=True)
        return buf.bool() if boolean else buf

    def combine_elem(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise form of the scatter reduction (same dispatch)."""
        if self.combine == "add":
            return a + b
        if self.combine == "min":
            return torch.minimum(a, b)
        if self.combine == "max":
            return torch.maximum(a, b)
        raise ValueError(f"unknown combine {self.combine!r}")

    def neutral_like(self, x: torch.Tensor, n_rows: int) -> torch.Tensor:
        """An identity-filled buffer with ``n_rows`` rows."""
        return torch.full((n_rows,) + tuple(x.shape[1:]), self.identity,
                          dtype=x.dtype, device=x.device)

    def mask_lanes(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """Identity-mask ``x`` per (vertex, lane): slots whose own lane is
        inactive contribute the ``combine`` identity."""
        ident = torch.tensor(self.identity, dtype=x.dtype, device=x.device)
        return torch.where(active, x, ident)


def _ordered_add(y: torch.Tensor, keys: torch.Tensor,
                 contrib: torch.Tensor) -> torch.Tensor:
    """``y.index_add(0, keys, contrib)`` with each key's terms summed in
    edge order, ``y[k] + (((0 + c_1) + c_2) + ...)``: a stable sort by key,
    then ``segment_reduce`` over every row's run (empty runs give 0).  The
    contributions go in as (E, lanes), so that a lane's sum runs the same
    sequential loop whatever the lane count; the run offsets come from
    ``searchsorted``, so nothing waits on the device.  The last row of
    ``y`` is the sentinel row that takes the masked terms (up to all E of
    them) and that every caller drops: its run is not summed, since one
    sequential loop over it would cost more than all the others.  No
    terms at all (a compact gather with no live chunk) leave ``y`` as it
    is, as ``index_add`` does."""
    if keys.numel() == 0:
        return y.clone()
    keys, order = torch.sort(keys.to(torch.int32), stable=True)
    starts = torch.searchsorted(keys, torch.arange(
        y.shape[0], dtype=torch.int32, device=keys.device))
    lengths = torch.diff(starts, append=starts[-1:])  # the sentinel's is 0
    flat = contrib[order].reshape(keys.shape[0], -1)
    sums = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0,
                                unsafe=True)
    return y + sums.reshape(y.shape)


def _times(xv, w):
    return xv if w is None else xv * w.reshape(w.shape + (1,) * (xv.ndim - w.ndim))


def _plus(xv, w):
    return xv if w is None else xv + w.reshape(w.shape + (1,) * (xv.ndim - w.ndim))


def _ident(xv, w):
    return xv


PLUS_TIMES = Semiring("plus_times", combine="add", identity=0.0, edge_op=_times)
MIN_PLUS = Semiring("min_plus", combine="min", identity=math.inf, edge_op=_plus)
MAX_TIMES = Semiring("max_times", combine="max", identity=-math.inf,
                     edge_op=_times)
# Logical OR over bool lanes: max(False, x) == x, max(True, _) == True.
OR_AND = Semiring("or_and", combine="max", identity=False, edge_op=_ident)
