"""``repro_torch.Graph`` — the library façade (torch port of
``repro.graph.session``).

One object holds the host CSR image, builds and caches its views lazily
(device chunk stores on first use, dense tile views only when a blocked
backend asks, one per (encoding, reverse, tile_order); the host-resident
view only when a ``residency='host'`` policy asks), and runs algorithms
through :func:`~repro_torch.core.run_program`::

    import repro_torch

    g = repro_torch.Graph.from_edges(src, dst)      # on the CUDA device
    pr = g.pagerank()                               # ProgramResult
    bf = g.bfs([0, 3, 5], policy=repro_torch.ExecutionPolicy(backend="blocked"))
    sem = g.pagerank(policy=repro_torch.ExecutionPolicy(residency="host"))

Views live on ``device``, which defaults to the CUDA device; without one
the constructor raises instead of carrying on on the CPU, so a CPU run is
always the caller's explicit ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..algs.bfs import BFSProgram
from ..algs.pagerank import PageRankPullProgram, PageRankPushProgram
from ..core import ExecutionPolicy, ProgramResult, SemGraph, run_program
from ..core.program import VertexProgram
from ..core.sem import _store_record_bytes, device_graph
from ..core.semiring import PLUS_TIMES
from . import csr

__all__ = ["Graph", "resolve_device"]

_BLOCKED = ("blocked", "blocked_compact")


def _nbytes(obj, seen: set) -> int:
    """Bytes of every tensor reachable from ``obj`` (dataclass fields),
    each storage counted once."""
    if obj is None:
        return 0
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.nbytes)
        if key in seen:
            return 0
        seen.add(key)
        return int(obj.nbytes)
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0


class Graph:
    """A graph session: host image + lazily cached device views + algorithms.

    Args:
      host: the immutable CSR image (:class:`repro_torch.graph.csr.Graph`).
      chunk_size: SEM edge-chunk size (fetch/skip granularity).
      bd / bs: dense tile dims for the blocked backends.
      device: where the views live; None means the CUDA device.
    """

    def __init__(self, host: csr.Graph, *, chunk_size: int = 4096,
                 bd: int = 128, bs: int = 128, device=None):
        self.torch_device = resolve_device(device)
        self._host = host
        self._chunk_size = chunk_size
        self._bd, self._bs = bd, bs
        self._base: Optional[SemGraph] = None
        self._tiles: dict = {}  # (semiring, reverse, tile_order) -> BlockedGraph
        self._views: dict = {}  # (semiring, with_reverse, tile_order) -> SemGraph
        self._host_view = None  # HostGraph, built by the first host run

    @classmethod
    def from_edges(cls, src, dst, n: Optional[int] = None, weights=None, *,
                   symmetrize: bool = False, dedup: bool = True,
                   drop_self_loops: bool = True, chunk_size: int = 4096,
                   bd: int = 128, bs: int = 128, device=None) -> "Graph":
        """A session from a COO edge list (cleaning as
        :func:`repro_torch.graph.csr.from_edges`)."""
        host = csr.from_edges(src, dst, n=n, weights=weights,
                              symmetrize=symmetrize, dedup=dedup,
                              drop_self_loops=drop_self_loops)
        return cls(host, chunk_size=chunk_size, bd=bd, bs=bs, device=device)

    @classmethod
    def from_csr(cls, indptr, indices, weights=None, *,
                 chunk_size: int = 4096, bd: int = 128, bs: int = 128,
                 device=None) -> "Graph":
        """A session from CSR arrays (out-edges; the in-edge view is derived)."""
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int32)
        n = int(indptr.shape[0] - 1)
        src = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
        host = csr.from_edges(src, indices, n=n, weights=weights,
                              dedup=False, drop_self_loops=False)
        return cls(host, chunk_size=chunk_size, bd=bd, bs=bs, device=device)

    @property
    def host(self) -> csr.Graph:
        return self._host

    @property
    def n(self) -> int:
        return self._host.n

    @property
    def m(self) -> int:
        return self._host.m

    def __repr__(self) -> str:
        built = ["base"] if self._base is not None else []
        built += [f"tiles{k}" for k in sorted(self._tiles)]
        built += ["host"] if self._host_view is not None else []
        return (f"Graph(n={self.n}, m={self.m}, chunk_size={self._chunk_size},"
                f" device={self.torch_device}, cached={built or 'none'})")

    def device(self, *, blocked: bool = False, blocked_reverse: bool = False,
               blocked_semiring: str = "plus_times",
               tile_order: str = "dest") -> SemGraph:
        """The cached device-resident SEM view (built once per session);
        tile views are sub-cached per (encoding, direction, tile_order)."""
        if self._base is None:
            self._base = device_graph(self._host, chunk_size=self._chunk_size,
                                      device=self.torch_device)
        if not blocked and not blocked_reverse:
            return self._base
        key = (blocked_semiring, bool(blocked_reverse), tile_order)
        if key not in self._views:
            self._views[key] = dataclasses.replace(
                self._base,
                out_blocked=self._tile_view(blocked_semiring, reverse=False,
                                            tile_order=tile_order),
                out_blocked_rev=(
                    self._tile_view(blocked_semiring, reverse=True,
                                    tile_order=tile_order)
                    if blocked_reverse else None
                ),
            )
        return self._views[key]

    def _tile_view(self, semiring: str, *, reverse: bool,
                   tile_order: str = "dest"):
        key = (semiring, reverse, tile_order)
        if key not in self._tiles:
            from ..kernels.spmv import build_blocked

            self._tiles[key] = build_blocked(
                self._host, bd=self._bd, bs=self._bs, direction="out",
                semiring=semiring, reverse=reverse, tile_order=tile_order,
                device=self.torch_device,
            )
        return self._tiles[key]

    def host_view(self):
        """The cached host-resident SEM view (``residency='host'``).

        Lazy like every other view and keyed apart from them: a host run
        never calls :meth:`device`, so no O(m) device copy is built.  Host
        tile stores are sub-cached inside the view per (encoding,
        direction, tile_order)."""
        if self._host_view is None:
            from ..core.residency import host_graph

            self._host_view = host_graph(self._host,
                                         chunk_size=self._chunk_size,
                                         bd=self._bd, bs=self._bs,
                                         device=self.torch_device)
        return self._host_view

    def memory_report(self, policy: Optional[ExecutionPolicy] = None, *,
                      batch: int = 1) -> dict:
        """Where this session's graph bytes live now (the reference's
        fields):

          * ``residency`` — ``policy.residency`` (default ``'device'``);
          * ``device_views`` — bytes per cached device view (``'base'``
            plus one ``'tiles:<encoding>:<fwd|rev>:<order>'`` entry per
            tile view), each storage counted once;
          * ``device_total`` — their sum;
          * ``device_edge_total`` — the O(m) part: chunk stores, CSR
            index/weight columns, tile views.  Host residency keeps it 0;
          * ``host_store_bytes`` — the host view's edge-store bytes;
          * ``peak_stage_bytes`` — the largest in-flight staging footprint
            measured so far;
          * ``stream_buffer_bytes`` — the model size of ONE staging batch
            under ``policy`` (tile batches for blocked backends, chunk
            batches otherwise, at least the p2p arm's single ``ecap``-lane
            payload when that arm is on).  Peak staging is at most two of
            these unless a blocked run is longer than ``stream_buffer``
            tiles: runs are never split, so such a run ships alone;
          * ``query_state_bytes`` — the O(n·Q) vertex-state model of a
            ``batch=Q`` run: per vertex and lane two bool masks and one
            4-byte value.
        """
        pol = policy if policy is not None else ExecutionPolicy()
        seen: set = set()
        device_views = {}
        if self._base is not None:
            device_views["base"] = _nbytes(self._base, seen)
        for (sr, rev, order), tv in sorted(self._tiles.items(),
                                           key=lambda kv: repr(kv[0])):
            name = f"tiles:{sr}:{'rev' if rev else 'fwd'}:{order}"
            device_views[name] = _nbytes(tv, seen)
        edge_seen: set = set()
        device_edge_total = 0
        if self._base is not None:
            for part in (self._base.out_store, self._base.in_store,
                         self._base.indices, self._base.w,
                         self._base.in_indices, self._base.in_w):
                device_edge_total += _nbytes(part, edge_seen)
        for tv in self._tiles.values():
            device_edge_total += _nbytes(tv, edge_seen)

        B = pol.stream_buffer
        if pol.backend in _BLOCKED:
            # tile batches round up to a power of two of steps; each step
            # ships its tile plus six int32 schedule flags (+ one count).
            G = 1
            while G < B:
                G *= 2
            stream_buffer_bytes = G * (self._bd * self._bs * 4 + 6 * 4) + 4
        else:
            # chunk batches ship record columns plus one valid flag a slot.
            stream_buffer_bytes = B * (
                self._chunk_size * _store_record_bytes(self._host.weights)
                + 1)
        if pol.switch_fraction is not None:
            # the p2p arm ships its ecap lanes in one piece.
            ecap = (pol.ecap if pol.ecap is not None
                    else max(int(self._host.m), 1))
            lane = 9 + (4 if self._host.weights is not None else 0)
            stream_buffer_bytes = max(stream_buffer_bytes, ecap * lane)
        hv = self._host_view
        return {
            "residency": pol.residency,
            "device_views": device_views,
            "device_total": sum(device_views.values()),
            "device_edge_total": device_edge_total,
            "host_store_bytes": hv.store_nbytes if hv is not None else 0,
            "peak_stage_bytes": hv.peak_stage_bytes if hv is not None else 0,
            "stream_buffer_bytes": int(stream_buffer_bytes),
            "query_state_bytes": int(self.n) * max(int(batch), 1) * 6,
        }

    def _sem(self, policy: Optional[ExecutionPolicy], prog=None):
        """The view a (program, policy) pair needs, built/cached on demand.
        Views are keyed on residency first: a host policy gets the host
        view and never builds a device copy."""
        if policy is not None and policy.residency == "host":
            return self.host_view()
        if policy is None or policy.backend not in _BLOCKED:
            return self.device()
        sr = getattr(prog, "semiring", None) or PLUS_TIMES
        if sr.name == "or_and":
            # Boolean frontiers run on plus_times tiles unless real weights
            # could corrupt the y>0 threshold — then exact occupancy tiles.
            tile_sr = "bool" if self._host.weights is not None else "plus_times"
        elif sr.name == "min_plus":
            tile_sr = "min_plus"
        else:
            tile_sr = "plus_times"
        return self.device(blocked=True,
                           blocked_reverse=getattr(prog, "reverse", False),
                           blocked_semiring=tile_sr,
                           tile_order=policy.tile_order)

    def run(self, program: VertexProgram, *, seeds=None, batch=None,
            policy: Optional[ExecutionPolicy] = None,
            max_supersteps: Optional[int] = None, checkpoint=None,
            resume: bool = False, analyze: bool = False) -> ProgramResult:
        """Run any :class:`~repro_torch.core.VertexProgram` on this graph.
        ``batch``, ``checkpoint``/``resume`` and ``analyze`` belong to later
        slices of the port and raise."""
        if batch is not None:
            raise NotImplementedError("batched driver (batch=...): ROADMAP A10")
        if checkpoint is not None or resume:
            raise NotImplementedError("checkpoint/resume: ROADMAP A12")
        if analyze:
            raise NotImplementedError("analyze=True: ROADMAP A13")
        pol = policy if policy is not None else program.default_policy
        return run_program(self._sem(pol, program), program, policy,
                           seeds=seeds, max_supersteps=max_supersteps)

    def bfs(self, sources=0, *, policy: Optional[ExecutionPolicy] = None,
            max_supersteps: Optional[int] = None, checkpoint=None,
            resume: bool = False) -> ProgramResult:
        """(Multi-source) BFS.  ``values``: int32 distances — ``[n]`` for a
        scalar source, ``[n, K]`` for K sources (``UNREACHED`` where a lane
        never arrives).  K sources run as K lanes of one
        :func:`run_program` (the reference's inline driver), one streamed
        tile serving every lane."""
        if checkpoint is not None or resume:
            raise NotImplementedError("checkpoint/resume: ROADMAP A12")
        scalar = np.ndim(sources) == 0
        seeds = np.atleast_1d(np.asarray(sources, np.int64))
        prog = BFSProgram()
        res = run_program(self._sem(policy, prog), prog, policy, seeds=seeds,
                          max_supersteps=max_supersteps)
        return res._replace(values=res.values[:, 0] if scalar else res.values)

    def pagerank(self, *, mode: str = "push", damping: float = 0.85,
                 tol: float = 1e-3, max_iters: int = 100, reset=None,
                 policy: Optional[ExecutionPolicy] = None, checkpoint=None,
                 resume: bool = False) -> ProgramResult:
        """PageRank.  ``values``: f32[n] ranks (sum ≈ 1).  ``mode='push'``
        is Graphyti's delta-push, ``'pull'`` the Pregel-style baseline."""
        if mode not in ("push", "pull"):
            raise ValueError(f"unknown pagerank mode {mode!r}")
        if reset is not None:
            raise NotImplementedError(
                "personalized pagerank (reset=...): ROADMAP A10")
        if checkpoint is not None or resume:
            raise NotImplementedError("checkpoint/resume: ROADMAP A12")
        prog = (PageRankPushProgram if mode == "push" else PageRankPullProgram)(
            damping=damping, tol=tol
        )
        return run_program(self._sem(policy, prog), prog, policy,
                           max_supersteps=max_iters)
