"""The ExecutionPolicy dispatch stack and the one-superstep traverse (torch
port of ``repro.core.engine``).

:func:`traverse` composes the reference's two switches per superstep:

  * **direction** — push (stream the frontier's out-edges) or pull (stream
    the unexplored candidates' in-edges), or Beamer's α/β heuristic under
    ``direction='auto'``;
  * **density** — dense multicast, the compacted work-list (``chunk_cap``)
    or the point-to-point gather (``switch_fraction``).

Each ``lax.cond``/``lax.switch`` of the reference is a host branch here on
a device scalar, so every branch decision synchronises with the device
once; the values and every IOStats field are those the reference's chosen
branch gives.  The four multicast backends are ``'scan'``/``'compact'``
(:mod:`repro_torch.core.sem`) and ``'blocked'``/``'blocked_compact'``
(:func:`repro_torch.kernels.spmv.blocked_spmv`, the CUDA kernels B1/B2 and,
on min_plus tiles, B3/B4 on the card).  A host view routes each superstep
to :func:`repro_torch.core.residency.host_traverse`, which has the same
dispatch over streamed edges.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..kernels.spmv.order import TILE_ORDERS
from .sem import (
    EDGE_RECORD_BYTES,
    IOStats,
    SemGraph,
    _pad_y_init,
    _stats,
    bucket_index,
    chunk_activity,
    compact_spmv,
    frontier_edge_mass,
    i32,
    p2p_spmv,
    pad_state,
    pow2_buckets,
    sem_spmv,
)
from .semiring import Semiring

__all__ = [
    "ExecutionPolicy",
    "PolicyError",
    "ResidencyError",
    "as_policy",
    "batched_union_frontier",
    "beamer_use_pull",
    "blocked_backend_spmv",
    "bsp_run",
    "flat_spmv",
    "hybrid_spmv",
    "spmv",
    "traverse",
]

_BLOCKED = ("blocked", "blocked_compact")


class PolicyError(ValueError):
    """An :class:`ExecutionPolicy` field value (or combination) is invalid."""


class ResidencyError(ValueError):
    """The policy asks for a view the graph does not have (blocked tiles,
    in-CSR, tile order, semiring encoding)."""


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Every dispatch knob in one place — the reference's fields and
    defaults (see ``repro.core.engine.ExecutionPolicy`` for each one).

    ``interpret`` is kept for signature parity and ignored: the device of
    the tensors decides between the CUDA kernels and their plain versions.
    ``residency='host'`` and the ``stream_*`` fields drive host residency
    (:mod:`repro_torch.core.residency`).
    """

    backend: str = "scan"
    direction: str = "out"
    chunk_cap: Optional[int] = None
    adaptive_cap: bool = False
    vcap: Optional[int] = None
    ecap: Optional[int] = None
    switch_fraction: Optional[float] = 0.10
    compact_fraction: float = 0.5
    alpha: float = 14.0
    beta: float = 24.0
    tile_order: str = "dest"
    interpret: Optional[bool] = None
    residency: str = "device"
    stream_buffer: int = 16
    stream_retries: int = 3
    stream_backoff_s: float = 0.002

    def __post_init__(self):
        if self.backend not in ("scan", "compact", "blocked", "blocked_compact"):
            raise PolicyError(f"unknown backend {self.backend!r}")
        if self.direction not in ("out", "in", "auto"):
            raise PolicyError(f"unknown direction {self.direction!r}")
        if self.tile_order not in TILE_ORDERS:
            raise PolicyError(
                f"unknown tile_order {self.tile_order!r}; expected one of "
                f"{TILE_ORDERS}"
            )
        if self.residency not in ("device", "host"):
            raise PolicyError(
                f"unknown residency {self.residency!r}; expected 'device' "
                "or 'host'"
            )
        if int(self.stream_buffer) < 1:
            raise PolicyError("stream_buffer must be >= 1")
        if int(self.stream_retries) < 0:
            raise PolicyError("stream_retries must be >= 0")
        if float(self.stream_backoff_s) < 0:
            raise PolicyError("stream_backoff_s must be >= 0")

    def with_(self, **kw) -> "ExecutionPolicy":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)


def as_policy(
    policy: Optional[ExecutionPolicy],
    default: Optional[ExecutionPolicy] = None,
    **deprecated,
) -> ExecutionPolicy:
    """Merge an explicit policy with an algorithm's deprecated kwargs:
    ``policy`` is the base (else ``default``, else a plain
    :class:`ExecutionPolicy`), and each deprecated kwarg the caller passed
    (non-``None``) overrides its field."""
    base = policy if policy is not None else (default or ExecutionPolicy())
    kw = {k: v for k, v in deprecated.items() if v is not None}
    return dataclasses.replace(base, **kw) if kw else base


def bsp_run(
    step: Callable[[Any], Tuple[Any, torch.Tensor]],
    state0: Any,
    max_supersteps: int,
) -> Tuple[Any, torch.Tensor]:
    """Run ``step`` (state -> (state, done)) until it reports done or the
    budget is spent; returns the final state and the int32 number of
    supersteps run.  The reference's ``lax.while_loop`` is a host loop
    here, reading ``done`` once a superstep."""
    state, it, done = state0, 0, False
    while not done and it < max_supersteps:
        state, d = step(state)
        done = bool(d)
        it += 1
    return state, torch.tensor(it, dtype=torch.int32)


def beamer_use_pull(
    frontier_edges: torch.Tensor,
    unexplored_edges: torch.Tensor,
    frontier_verts: torch.Tensor,
    n: int,
    *,
    alpha: float = 14.0,
    beta: float = 24.0,
) -> torch.Tensor:
    """Beamer's direction heuristic as a bool scalar tensor: pull when
    ``m_f * alpha > m_u`` and ``n_f * beta > n`` (in f32, as the reference)."""
    mf = frontier_edges.to(torch.float32)
    mu = unexplored_edges.to(torch.float32)
    nf = frontier_verts.to(torch.float32)
    return (mf * alpha > mu) & (nf * beta > float(n))


def _select_blocked(sg: SemGraph, direction: str, reverse: bool):
    """(BlockedGraph, active_on, major_degree) for a (direction, reverse)
    pair, mirroring sem_spmv's gather/key/mask conventions."""
    if direction == "out" and not reverse:
        return sg.out_blocked, "src", sg.out_degree
    if direction == "out" and reverse:
        if sg.out_blocked_rev is None and sg.out_blocked is not None:
            raise ResidencyError(
                "reverse blocked view not built; use "
                "device_graph(..., blocked=True, blocked_reverse=True)"
            )
        return sg.out_blocked_rev, "dst", sg.out_degree
    if direction == "in" and not reverse:
        if sg.in_degree is None:
            raise ResidencyError(
                "SemGraph has no in-edge view; pull ('in') blocked dispatch "
                "needs a graph built with its in-CSR"
            )
        return sg.out_blocked, "dst", sg.in_degree
    raise NotImplementedError("blocked backend: direction='in' with reverse")


def _check_blocked_semiring(sr: Semiring, tile_semiring: str,
                            weighted: bool) -> bool:
    """Validate (gather semiring, tile encoding); returns the ``boolean``
    flag (or_and executed as f32 product + y>0 threshold)."""
    boolean = sr.name == "or_and"
    if boolean:
        if tile_semiring not in ("plus_times", "bool"):
            raise ResidencyError(
                "or_and requires 'plus_times' or 'bool' blocked tiles"
            )
        if tile_semiring == "plus_times" and weighted:
            raise ResidencyError(
                "or_and on a weighted graph needs occupancy tiles; build "
                "with device_graph(..., blocked_semiring='bool')"
            )
    elif sr.name != tile_semiring:
        raise ResidencyError(
            f"semiring {sr.name!r} needs blocked tiles built with "
            f"semiring={sr.name!r} (have {tile_semiring!r})"
        )
    return boolean


def _blocked_pre_mask(tile_semiring: str, active_on: str,
                      active: torch.Tensor, x: torch.Tensor,
                      boolean: bool) -> torch.Tensor:
    """The kernel-input x: cast for boolean flows and, on push, mask
    inactive senders with the additive identity so block-granular tiles
    stay row-exact."""
    xv = x.to(torch.float32) if boolean else x
    if active_on == "src":
        ident = float("inf") if tile_semiring == "min_plus" else 0.0
        mask = active.reshape((-1,) + (1,) * (xv.ndim - 1))
        xv = torch.where(mask, xv, torch.tensor(ident, dtype=xv.dtype,
                                                device=xv.device))
    return xv


def _blocked_post(sr: Semiring, active_on: str, active: torch.Tensor,
                  y: torch.Tensor, y_init: Optional[torch.Tensor],
                  boolean: bool, out_dtype) -> torch.Tensor:
    """The kernel-output epilogue: boolean threshold, pull/reverse masking
    of inactive major rows, y_init combine, dtype restore."""
    if boolean:
        y = y > 0
    if active_on == "dst":
        mask = active.reshape((-1,) + (1,) * (y.ndim - 1))
        base = y_init if y_init is not None else sr.neutral_like(y, y.shape[0])
        y = torch.where(mask, sr.combine_elem(base.to(y.dtype), y),
                        base.to(y.dtype))
    elif y_init is not None:
        y = sr.combine_elem(y_init.to(y.dtype), y)
    if not boolean:
        y = y.to(out_dtype)
    return y


def blocked_backend_spmv(
    sg: SemGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    direction: str = "out",
    reverse: bool = False,
    y_init: Optional[torch.Tensor] = None,
    compact: bool = False,
) -> tuple[torch.Tensor, IOStats]:
    """Row-exact SpMV through the blocked kernels + unified IOStats.

    Tile skipping is block-granular; exactness is restored by masking the
    gather side (push) or the scatter side (pull/reverse).  ``compact=True``
    runs the compacted work-list (kernel B2) instead of the full schedule
    (B1); values and IOStats are the same.
    """
    from ..kernels.spmv import blocked_spmv, tile_byte_size

    bg, active_on, deg = _select_blocked(sg, direction, reverse)
    if bg is None:
        raise ResidencyError(
            "SemGraph has no blocked views; build with "
            "device_graph(..., blocked=True)"
        )
    boolean = _check_blocked_semiring(sr, bg.semiring, sg.w is not None)
    n = sg.n
    xv = _blocked_pre_mask(bg.semiring, active_on, active, x, boolean)
    y, stats = blocked_spmv(bg, xv, active, active_on=active_on,
                            compact=compact)
    y = _blocked_post(sr, active_on, active, y, y_init, boolean, x.dtype)

    # requests: one per active major vertex whose block holds >=1 tile.
    blk = bg.bs if active_on == "src" else bg.bd
    n_blocks = bg.n_src_blocks if active_on == "src" else bg.n_dst_blocks
    bid = bg.sbid if active_on == "src" else bg.dbid
    has_tiles = torch.zeros(n_blocks, dtype=torch.bool, device=x.device)
    has_tiles[bid.long()] = True
    ap = torch.zeros(n_blocks * blk, dtype=torch.bool, device=x.device)
    ap[:n] = active
    requests = (ap.view(n_blocks, blk) & has_tiles[:, None]).sum()
    tile_bytes = tile_byte_size(bg)
    fetched = stats["tiles_fetched"]
    st = _stats(
        x.device,
        requests=requests,
        records=fetched * (tile_bytes // EDGE_RECORD_BYTES),
        chunks_skipped=stats["tiles_skipped"],
        messages=torch.where(active, deg.long(), 0).sum(),
        bytes_moved=fetched * tile_bytes,
        x_fetches=stats["x_fetches"],
    )
    return y, st


def _store(sg: SemGraph, direction: str):
    store = sg.out_store if direction == "out" else sg.in_store
    if store is None:
        raise ResidencyError(f"SemGraph has no {direction!r} store")
    return store


def spmv(
    sg: SemGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    direction: str = "out",
    y_init: Optional[torch.Tensor] = None,
    reverse: bool = False,
    backend: str = "scan",
    chunk_cap: Optional[int] = None,
) -> tuple[torch.Tensor, IOStats]:
    """Chunked SEM SpMV in the given direction ('out' = push, 'in' = pull)
    on one backend (see the module docstring)."""
    if backend in _BLOCKED:
        return blocked_backend_spmv(
            sg, x, active, sr, direction=direction, reverse=reverse,
            y_init=y_init, compact=backend == "blocked_compact",
        )
    if backend not in ("scan", "compact"):
        raise PolicyError(f"unknown backend {backend!r}")
    store = _store(sg, direction)
    if backend == "compact":
        cap = store.num_chunks if chunk_cap is None else chunk_cap
        return compact_spmv(store, x, active, sr, y_init=y_init,
                            reverse=reverse, chunk_cap=cap)
    return sem_spmv(store, x, active, sr, y_init=y_init, reverse=reverse)


def _adaptive_compact(store, x, active, sr, y_init, reverse, cap,
                      n_act_chunks):
    """The smallest pow2 work-list bucket that fits the live-chunk count
    (the dispatch already proved ``n_act_chunks <= cap``)."""
    caps = pow2_buckets(cap)
    c = caps[bucket_index(n_act_chunks, caps)]
    return compact_spmv(store, x, active, sr, y_init=y_init, reverse=reverse,
                        chunk_cap=c, assume_fits=True)


def _multicast(sg, x, active, sr, *, direction, reverse, y_init, pol):
    """Dense-vs-compact dispatch within one backend family: with
    ``pol.chunk_cap`` set, the mid-density band (live units within the cap
    and within ``compact_fraction`` of all units) runs compacted."""
    backend = pol.backend
    if backend in _BLOCKED:
        bg, active_on, _ = _select_blocked(sg, direction, reverse)
        if bg is None:
            raise ResidencyError(
                "SemGraph has no blocked views; build with "
                "device_graph(..., blocked=True)"
            )
        if bg.tile_order != pol.tile_order:
            raise ResidencyError(
                f"policy wants tile_order={pol.tile_order!r} but the "
                f"graph's blocked view was built with {bg.tile_order!r}; "
                "rebuild with device_graph(..., tile_order=...) or run "
                "through repro_torch.Graph, which caches one view per order"
            )
    if pol.chunk_cap is None and not (
        pol.adaptive_cap and backend in ("scan", "compact")
    ):
        return spmv(sg, x, active, sr, direction=direction, reverse=reverse,
                    y_init=y_init, backend=backend)
    if backend in _BLOCKED:
        from ..kernels.spmv import tile_activity

        T = bg.num_tiles
        cap = max(1, min(int(pol.chunk_cap), T))
        n_act_tiles = int(tile_activity(bg, active, active_on).sum())
        use_compact = (n_act_tiles <= cap
                       and n_act_tiles <= int(pol.compact_fraction * T))
        return blocked_backend_spmv(
            sg, x, active, sr, direction=direction, reverse=reverse,
            y_init=y_init, compact=use_compact or backend == "blocked_compact",
        )
    store = _store(sg, direction)
    C = store.num_chunks
    cap = C if pol.chunk_cap is None else max(1, min(int(pol.chunk_cap), C))
    n_act_chunks = int(chunk_activity(store, active).sum())
    if n_act_chunks <= cap and n_act_chunks <= int(pol.compact_fraction * C):
        if pol.adaptive_cap:
            return _adaptive_compact(store, x, active, sr, y_init, reverse,
                                     cap, n_act_chunks)
        return compact_spmv(store, x, active, sr, y_init=y_init,
                            reverse=reverse, chunk_cap=cap, assume_fits=True)
    return sem_spmv(store, x, active, sr, y_init=y_init, reverse=reverse)


def _adaptive_p2p(sg, x, active, sr, *, direction, y_init, vcap, ecap,
                  n_act, act_edges):
    """The smallest pow2 (vcap, ecap) pair that fits both the live vertex
    count and the live edge mass (ladders padded to equal length and
    climbed together, as the reference)."""
    vbuckets = pow2_buckets(vcap)
    ebuckets = pow2_buckets(ecap)
    k = max(len(vbuckets), len(ebuckets))
    vbuckets = vbuckets + (vbuckets[-1],) * (k - len(vbuckets))
    ebuckets = ebuckets + (ebuckets[-1],) * (k - len(ebuckets))
    idx = max(bucket_index(n_act, vbuckets), bucket_index(act_edges, ebuckets))
    return p2p_spmv(sg, x, active, sr, direction=direction,
                    vcap=vbuckets[idx], ecap=ebuckets[idx], y_init=y_init)


def _dispatch(sg, x, active, sr, *, direction, reverse, y_init, pol):
    """The density three-way (multicast / compact / p2p) for one direction;
    p2p is skipped when ``pol.switch_fraction`` is None or the flow is
    reversed."""
    if pol.switch_fraction is None or reverse:
        return _multicast(sg, x, active, sr, direction=direction,
                          reverse=reverse, y_init=y_init, pol=pol)
    deg = sg.out_degree if direction == "out" else sg.in_degree
    vcap = pol.vcap if pol.vcap is not None else sg.n
    ecap = pol.ecap if pol.ecap is not None else max(int(sg.m), 1)
    act_edges = int(frontier_edge_mass(deg, active))
    n_act = int(active.sum())
    use_p2p = (act_edges <= int(pol.switch_fraction * sg.m)
               and act_edges <= ecap and n_act <= vcap)
    if not use_p2p:
        return _multicast(sg, x, active, sr, direction=direction,
                          reverse=reverse, y_init=y_init, pol=pol)
    if pol.adaptive_cap:
        return _adaptive_p2p(sg, x, active, sr, direction=direction,
                             y_init=y_init, vcap=vcap, ecap=ecap,
                             n_act=n_act, act_edges=act_edges)
    return p2p_spmv(sg, x, active, sr, direction=direction, vcap=vcap,
                    ecap=ecap, y_init=y_init)


def _pull_available(sg: SemGraph, pol: ExecutionPolicy) -> bool:
    """Can this graph execute the pull arm under ``pol``?"""
    if sg.in_degree is None:
        return False
    if pol.backend in _BLOCKED:
        if sg.out_blocked is None:
            return False
    elif sg.in_store is None:
        return False
    if pol.switch_fraction is not None and sg.in_indptr is None:
        return False
    return True


def batched_union_frontier(
    sg: SemGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    unexplored: Optional[torch.Tensor],
    reverse: bool,
    direction: str,
):
    """Collapse an (n, Q) frontier into its 1-D union call: returns
    ``(x_masked, union_active, union_unexplored, lane_mass)``."""
    xm = sr.mask_lanes(x, active)
    union = torch.any(active, dim=-1)
    un_union = unexplored
    if unexplored is not None and unexplored.ndim > 1:
        un_union = torch.any(unexplored, dim=-1)
    plain = reverse or unexplored is None
    if plain and not reverse and direction == "in":
        deg = sg.in_degree
    else:
        deg = sg.out_degree
    return xm, union, un_union, frontier_edge_mass(deg, active)


def check_residency(sg, pol: ExecutionPolicy) -> bool:
    """True when ``sg`` is a host view under a host policy, False for a
    device view under a device policy; raises :class:`ResidencyError` on a
    mismatched pair."""
    is_host = bool(getattr(sg, "is_host_view", False))
    if pol.residency == "host" and not is_host:
        raise ResidencyError(
            "residency='host' policy met a device-resident graph: this "
            "SemGraph's edge store already lives in device memory, so "
            "streaming it from host would misreport residency.  Run "
            "through repro_torch.Graph (sessions key views on residency) "
            "or build a host view with "
            "repro_torch.core.residency.host_graph()"
        )
    if is_host and pol.residency != "host":
        raise ResidencyError(
            "device-residency policy met a host-resident graph view: "
            "its edge store has no device copy to dispatch on.  Use "
            "ExecutionPolicy(residency='host') or build a device view "
            "with device_graph()"
        )
    return is_host


def traverse(
    sg: SemGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    policy: Optional[ExecutionPolicy] = None,
    unexplored: Optional[torch.Tensor] = None,
    reverse: bool = False,
    y_init: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, IOStats]:
    """The engine's traversal entry point: one superstep, policy-dispatched.

    Every edge whose source is in the frontier (``active``, with ``x``
    carrying its per-lane values) contributes ``edge_op(x[src], w)``
    combined into ``y[dst]``.  With ``unexplored`` the call is a frontier
    expansion and the direction ('out', 'in' or Beamer's 'auto') is an
    execution choice; ``messages`` then reports the frontier's logical
    out-edge mass on every path.  ``active`` may be (n, Q): the union of the
    lanes is fetched once, each lane identity-masked by its own frontier.
    A host view (``residency='host'``) streams the superstep through
    :func:`repro_torch.core.residency.host_traverse`; a host policy on a
    device view, or the reverse, raises :class:`ResidencyError`.
    """
    pol = policy if policy is not None else ExecutionPolicy()
    if active.ndim > 1:
        xm, union, un_union, mass = batched_union_frontier(
            sg, x, active, sr, unexplored=unexplored, reverse=reverse,
            direction=pol.direction,
        )
        y, st = traverse(sg, xm, union, sr, policy=pol,
                         unexplored=un_union, reverse=reverse, y_init=y_init)
        return y, st._replace(messages=mass)
    if check_residency(sg, pol):
        from .residency import host_traverse

        return host_traverse(sg, x, active, sr, policy=pol,
                             unexplored=unexplored, reverse=reverse,
                             y_init=y_init)
    if reverse or unexplored is None:
        direction = pol.direction if pol.direction in ("out", "in") else "out"
        return _dispatch(sg, x, active, sr, direction=direction,
                         reverse=reverse, y_init=y_init, pol=pol)

    mf = frontier_edge_mass(sg.out_degree, active)
    mode = pol.direction
    if mode != "out" and not _pull_available(sg, pol):
        if mode == "in":
            raise ResidencyError(
                "direction='in' needs the graph's pull views (in-store / "
                "in_degree; blocked backends also need the forward tile "
                "view) — build the graph with its in-CSR"
            )
        mode = "out"
    if mode == "auto":
        use_pull = beamer_use_pull(
            mf,
            frontier_edge_mass(sg.out_degree, unexplored),
            i32(active.sum()),
            sg.n,
            alpha=pol.alpha,
            beta=pol.beta,
        )
        mode = "in" if bool(use_pull) else "out"
    if mode == "out":
        y, st = _dispatch(sg, x, active, sr, direction="out", reverse=False,
                          y_init=y_init, pol=pol)
    else:
        # Pull: x masked to the frontier, candidates' in-edges streamed.
        mask = active.reshape((-1,) + (1,) * (x.ndim - 1))
        xm = torch.where(mask, x, torch.tensor(sr.identity, dtype=x.dtype,
                                               device=x.device))
        y, st = _dispatch(sg, xm, unexplored, sr, direction="in",
                          reverse=False, y_init=y_init, pol=pol)
    return y, st._replace(messages=mf)


def hybrid_spmv(
    sg: SemGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    direction: str = "out",
    vcap: Optional[int] = None,
    ecap: Optional[int] = None,
    switch_fraction: float = 0.10,
    y_init: Optional[torch.Tensor] = None,
    backend: str = "scan",
    chunk_cap: Optional[int] = None,
    compact_fraction: float = 0.5,
    policy: Optional[ExecutionPolicy] = None,
    unexplored: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, IOStats]:
    """The pre-policy density dispatch, kept for compatibility: the loose
    kwargs become an :class:`ExecutionPolicy` (unless ``policy`` is given)
    and the call is :func:`traverse`'s."""
    if policy is None:
        policy = ExecutionPolicy(
            backend=backend,
            direction=direction,
            chunk_cap=chunk_cap,
            vcap=vcap,
            ecap=ecap,
            switch_fraction=switch_fraction,
            compact_fraction=compact_fraction,
        )
    return traverse(sg, x, active, sr, policy=policy, unexplored=unexplored,
                    y_init=y_init)


def flat_spmv(
    sg: SemGraph,
    x: torch.Tensor,
    active: torch.Tensor,
    sr: Semiring,
    *,
    direction: str = "out",
    y_init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """In-memory baseline: single pass over all m edges, no streaming, no
    counting (the flat CSR arrays of the direction)."""
    n = sg.n
    if direction == "out":
        indptr, indices, w = sg.indptr, sg.indices, sg.w
    else:
        indptr, indices, w = sg.in_indptr, sg.in_indices, sg.in_w
    deg = (indptr[1: n + 1] - indptr[:n]).long()
    major = torch.repeat_interleave(
        torch.arange(n, device=deg.device), deg, output_size=sg.m)
    minor = indices.long()
    gather_idx = minor if direction == "in" else major
    key = major if direction == "in" else minor
    xp = pad_state(x, sr)
    mask = active[major]
    contrib = sr.edge_op(xp[gather_idx], w)
    mask_b = mask.reshape((-1,) + (1,) * (contrib.ndim - 1))
    contrib = torch.where(mask_b, contrib, torch.tensor(
        sr.identity, dtype=contrib.dtype, device=contrib.device))
    keyv = torch.where(mask, key, n)
    y0 = _pad_y_init(sr, xp, y_init, n)
    return sr.scatter(y0, keyv, contrib)[:n]
