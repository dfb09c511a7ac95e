#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

  1. build   — compile ``src/repro_torch/csrc/spmv.cu`` (kernels B1-B4) for
               sm_90a with nvcc (into the git-ignored ``build/kernels/``).
  2. graph   — ``rmat(16, edge_factor=16, seed=1)``: n=65,536, m=955,396;
               its 128x128 f32 tile view (239,398 tiles, ~15.7 GB) lives on
               the card.
  3. main    — after one warm-up run per backend and residency on rmat(10),
               the slice-1 path through ``repro_torch.Graph``:
               ``pagerank()`` push and pull and ``bfs(0)``/``bfs(hub)`` on the
               backends scan, compact, blocked and blocked_compact, plus
               ``bfs([0, 1, 2, 3])`` on blocked.  Kernel launch counts are
               zeroed just before and read just after; B1 and B2 must have
               run.
  4. check   — BFS levels equal across backends and equal a numpy BFS of the
               host CSR; K-lane BFS equals K single-source numpy BFS runs;
               PageRank agrees across backends (atol 1e-6, rtol 1e-5) and
               with a numpy power iteration within the push/pull error bound
               (L1 <= tol / (1 - damping)); BFS IOStats agree field for field
               between backends sharing a layout and in the layout-free
               fields (messages, supersteps) across all four.
  5. wcc     — ``Graph.run(WCC)`` (min-label propagation, the MIN_PLUS
               program of ``examples/custom_program.py``) on
               ``rmat(16, edge_factor=16, seed=1, symmetrize=True)``
               (n=65,536, m=1,820,044; its min_plus tile view holds 257,273
               tiles, ~16.9 GB) on all four backends, device residency, with
               the counts zeroed just before and read just after: B3 and B4
               must have run.  Labels equal across backends and equal a
               numpy union-find labelling; IOStats as in phase 4.
  6. host    — host residency (edges in host RAM, streamed per superstep)
               against device residency in this process:
               (a) ``rmat(20, edge_factor=16, seed=1)`` (n=1,048,576) on scan
                   and compact: ``pagerank()`` push and pull (pull capped
                   at 30 supersteps), ``bfs(hub)``;
               (b) ``rmat(14, edge_factor=16, seed=1, symmetrize=True)`` on
                   blocked and blocked_compact: WCC, ``bfs(hub)`` and
                   ``pagerank()`` (capped at 20 supersteps) at the default
                   ``stream_buffer=16``, then
                   WCC on a 'hilbert' schedule at 16 and WCC and
                   ``bfs(hub)`` there at ``stream_buffer=1`` (a batch per run,
                   several runs per block).
               BFS levels and WCC labels exact, PageRank within atol 1e-6,
               rtol 1e-5, BFS/WCC IOStats equal except host_bytes and
               retries (PageRank's are logged: f32 rounding order moves its
               counters, ROADMAP §C P2), ``device_edge_total == 0`` under
               host residency, and ``peak_stage_bytes <= 2 *
               stream_buffer_bytes`` where no run exceeds the buffer.  Logs
               each wall beside its device twin and their ratio, and the
               streamed bytes per second beside the pinned host-to-device
               rate of a plain 1 GB copy.  Host launches of B2/B4 are counted
               apart from the main paths'.
  7. kernels — B1-B4 held against their plain torch versions on the card
               (K=1 and K=4; full and n/8 frontiers; the 'dest' views at the
               main paths' shapes and 'hilbert' views of rmat(14)): B1/B2
               within atol=rtol=1e-5, B3/B4 with ``torch.equal``.
  8. time    — each kernel at K=1 beside its bound, its plain version and a
               library call over the same live edges (``torch.sparse.mm``
               for B1/B2, ``scatter_reduce_(..., 'amin')`` for B3/B4).
  9. profile — device time and idle share of blocked PageRank, blocked BFS,
               host scan PageRank (10 supersteps) and host blocked_compact
               WCC.

Prints the card's ``name, power.limit``, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA
device, and when the repository's ``src/`` is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
PR_ATOL, PR_RTOL = 1e-6, 1e-5
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
# The order-invariant fields of one storage layout (scan/compact chunks vs
# blocked tiles); ``messages`` and ``supersteps`` are the same in every
# layout.
LAYOUT_FREE = ("messages", "supersteps")
# Depth cuts of the host phase, for the script's time: PageRank pull at
# scale 20 runs into its default cap of 100 supersteps (31 s on host), the
# scale-14 tile PageRank takes 36-40 s on host, and the profiler multiplies
# a host PageRank's 18 s wall by ten.  Host and device runs get the same cap.
PULL_ITERS_20, PUSH_ITERS_14, PROFILE_ITERS = 30, 20, 10


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def numpy_bfs(g, source: int):
    import numpy as np

    from repro_torch.algs import UNREACHED

    dist = np.full(g.n, UNREACHED, np.int32)
    dist[source] = 0
    frontier = np.asarray([source])
    level = 0
    while frontier.size:
        starts, ends = g.indptr[frontier], g.indptr[frontier + 1]
        counts = ends - starts
        idx = np.repeat(starts - np.cumsum(counts) + counts, counts) + np.arange(
            counts.sum())
        nbrs = np.unique(g.indices[idx])
        nbrs = nbrs[dist[nbrs] == UNREACHED]
        level += 1
        dist[nbrs] = level
        frontier = nbrs
    return dist


def numpy_pagerank(g, damping: float, iters: int = 300):
    import numpy as np

    deg = np.diff(g.indptr)
    src = np.repeat(np.arange(g.n), deg)
    rank = np.full(g.n, 1.0 / g.n)
    share = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    for _ in range(iters):
        new = (1 - damping) / g.n + damping * np.bincount(
            g.indices, weights=(rank * share)[src], minlength=g.n)
        if np.abs(new - rank).max() < 1e-15:
            return new
        rank = new
    return rank


def io_dict(io) -> dict:
    return {k: int(v) for k, v in zip(io._fields, io)}


def check_io(label: str, a: dict, b: dict, fields) -> None:
    bad = {f: (a[f], b[f]) for f in fields if a[f] != b[f]}
    if bad:
        raise AssertionError(f"{label}: IOStats differ {bad}")


def phase_main(G, hub, torch):
    """The main path; returns results and the launch counts it caused."""
    import repro_torch
    from repro_torch.kernels.spmv import kernel as K

    results, wall = {}, {}
    K.reset_launches()
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        for name, call in (
            ("pr_push", lambda: G.pagerank(policy=pol)),
            ("pr_pull", lambda: G.pagerank(mode="pull", policy=pol)),
            ("bfs0", lambda: G.bfs(0, policy=pol)),
            ("bfs_hub", lambda: G.bfs(hub, policy=pol)),
        ):
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall[(backend, name)] = (time.perf_counter() - t0) * 1e3
            results[(backend, name)] = res
            log(f"main {backend:16s} {name:8s} supersteps={int(res.supersteps)}"
                f" wall_ms={wall[(backend, name)]:.1f}")
    for backend, name, sources in (("blocked", "bfs4", [0, 1, 2, 3]),
                                   ("blocked_compact", "bfs4_hub",
                                    [hub, 1, 2, 3])):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        t0 = time.perf_counter()
        results[(backend, name)] = G.bfs(sources, policy=pol)
        torch.cuda.synchronize()
        wall[(backend, name)] = (time.perf_counter() - t0) * 1e3
    counts = dict(K.launches)
    log(f"main path kernel launches: {counts}")
    require_launched("main path", counts, ("spmv_blocked",
                                           "spmv_blocked_compact"))
    return results, wall, counts


def phase_check(g, hub, results, torch, damping=0.85, tol=1e-3) -> None:
    import numpy as np

    from repro_torch.algs import UNREACHED

    for run, source in (("bfs0", 0), ("bfs_hub", hub)):
        levels = numpy_bfs(g, source)
        ref_io = {}
        for backend in BACKENDS:
            res = results[(backend, run)]
            if not np.array_equal(res.values.cpu().numpy(), levels):
                raise AssertionError(f"{run} on {backend} differs from numpy BFS")
            ref_io[backend] = io_dict(res.iostats)
        check_io(f"{run} scan/compact", ref_io["scan"], ref_io["compact"],
                 ref_io["scan"].keys())
        check_io(f"{run} blocked/blocked_compact", ref_io["blocked"],
                 ref_io["blocked_compact"], ref_io["blocked"].keys())
        for backend in BACKENDS[1:]:
            check_io(f"{run} scan/{backend}", ref_io["scan"], ref_io[backend],
                     LAYOUT_FREE)
        reached = levels != UNREACHED
        log(f"{run}: source {source} reaches {int(reached.sum())} vertices in "
            f"{int(levels[reached].max())} levels; all backends equal; "
            f"supersteps {ref_io['scan']['supersteps']}")
    for backend, run, sources in (("blocked", "bfs4", [0, 1, 2, 3]),
                                  ("blocked_compact", "bfs4_hub",
                                   [hub, 1, 2, 3])):
        multi = results[(backend, run)].values.cpu().numpy()
        if multi.shape != (g.n, 4):
            raise AssertionError(f"bfs({sources}) shape {multi.shape}")
        for lane, source in enumerate(sources):
            if not np.array_equal(multi[:, lane], numpy_bfs(g, source)):
                raise AssertionError(f"bfs({sources}) lane {lane} differs "
                                     "from numpy BFS")
    log("bfs([0, 1, 2, 3]) and bfs([hub, 1, 2, 3]): every lane equals numpy BFS")

    ref = numpy_pagerank(g, damping)
    for mode in ("pr_push", "pr_pull"):
        base = results[("scan", mode)].values.cpu()
        for backend in BACKENDS:
            vals = results[(backend, mode)].values.cpu()
            if vals.shape != (g.n,) or not torch.isfinite(vals).all():
                raise AssertionError(f"{mode} {backend}: bad values")
            torch.testing.assert_close(vals, base, atol=PR_ATOL, rtol=PR_RTOL)
            l1 = float(np.abs(vals.double().numpy() - ref).sum())
            if l1 > tol / (1 - damping):
                raise AssertionError(f"{mode} {backend}: L1 error {l1} vs "
                                     f"numpy power iteration")
        ios = {b: io_dict(results[(b, mode)].iostats) for b in BACKENDS}
        log(f"{mode}: backends agree; supersteps "
            f"{[ios[b]['supersteps'] for b in BACKENDS]}, messages "
            f"{[ios[b]['messages'] for b in BACKENDS]}")


def require_launched(path: str, counts: dict, names) -> None:
    for name in names:
        if counts.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path}")


_WCC = None


def wcc_program():
    """Weakly connected components by min-label propagation: the MIN_PLUS
    program of ``examples/custom_program.py``, written against the port's
    public ``VertexProgram`` as a user would."""
    global _WCC
    if _WCC is None:
        from typing import NamedTuple

        import torch

        import repro_torch
        from repro_torch.core.semiring import MIN_PLUS

        class WCCState(NamedTuple):
            labels: torch.Tensor
            active: torch.Tensor

        class WCCProgram(repro_torch.VertexProgram):
            semiring = MIN_PLUS

            def init(self, sg, seeds):
                return WCCState(
                    labels=torch.arange(sg.n, dtype=torch.float32,
                                        device=sg.device),
                    active=torch.ones(sg.n, dtype=torch.bool,
                                      device=sg.device))

            def frontier(self, sg, s):
                return repro_torch.Frontier(x=s.labels, active=s.active)

            def apply(self, sg, s, gathered):
                labels = torch.minimum(s.labels, gathered)
                changed = labels < s.labels
                return WCCState(labels, changed), changed

            def finalize(self, sg, s):
                return s.labels.to(torch.int32)

        _WCC = WCCProgram
    return _WCC()


def numpy_wcc(g):
    """Component labels (smallest vertex id of each weakly connected
    component) by union-find with pointer jumping, in numpy."""
    import numpy as np

    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    parent = np.arange(g.n)
    while True:
        pu, pv = parent[src], parent[dst]
        hi, lo = np.maximum(pu, pv), np.minimum(pu, pv)
        before = parent.copy()
        np.minimum.at(parent, hi, lo)
        while True:  # pointer jumping to the roots
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
        if np.array_equal(parent, before):
            return parent.astype(np.int32)


def timed(fn, torch):
    """(result, wall ms, kernel launches it made)."""
    from repro_torch.kernels.spmv import kernel as K

    before = dict(K.launches)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return res, ms, {k: K.launches[k] - before[k] for k in before}


def phase_wcc(torch):
    """WCC through ``Graph.run`` on the four backends (device residency)."""
    import numpy as np

    import repro_torch
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    t0 = time.perf_counter()
    wg = rmat(16, edge_factor=16, seed=1, symmetrize=True)
    if (wg.n, wg.m) != (65536, 1820044):
        raise AssertionError(f"rmat(16, symmetrize) gave n={wg.n} m={wg.m}")
    W = repro_torch.Graph(wg, device="cuda")
    wbg = W.device(blocked=True, blocked_semiring="min_plus").out_blocked
    torch.cuda.synchronize()
    log(f"wcc graph: n={wg.n} m={wg.m} min_plus tiles={wbg.num_tiles} "
        f"({wbg.tiles.nbytes / 1e9:.2f} GB on the card) built in "
        f"{time.perf_counter() - t0:.1f} s")
    want = numpy_wcc(wg)
    results, wall = {}, {}
    K.reset_launches()
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        t0 = time.perf_counter()
        results[backend] = W.run(wcc_program(), policy=pol)
        torch.cuda.synchronize()
        wall[backend] = (time.perf_counter() - t0) * 1e3
        log(f"wcc {backend:16s} supersteps="
            f"{int(results[backend].supersteps)} wall_ms={wall[backend]:.1f}")
    counts = dict(K.launches)
    log(f"wcc path kernel launches: {counts}")
    require_launched("wcc path", counts, ("spmv_blocked_min_plus",
                                          "spmv_blocked_compact_min_plus"))
    ios = {}
    for backend, res in results.items():
        if not np.array_equal(res.values.cpu().numpy(), want):
            raise AssertionError(f"wcc on {backend} differs from numpy "
                                 "union-find")
        ios[backend] = io_dict(res.iostats)
    check_io("wcc scan/compact", ios["scan"], ios["compact"],
             ios["scan"].keys())
    check_io("wcc blocked/blocked_compact", ios["blocked"],
             ios["blocked_compact"], ios["blocked"].keys())
    for backend in BACKENDS[1:]:
        check_io(f"wcc scan/{backend}", ios["scan"], ios[backend],
                 LAYOUT_FREE)
    log(f"wcc: {len(np.unique(want))} components, largest "
        f"{int(np.bincount(want).max())} vertices; all backends equal "
        f"numpy union-find; supersteps {ios['scan']['supersteps']}")
    return W, wg, wall, counts


def pinned_h2d_rate(torch, nbytes: int = 1 << 30) -> float:
    """Bytes per second of one plain pinned host-to-device ``copy_``."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps=5)
    del src, dst
    return nbytes / (ms / 1e3)


def max_run_tiles(session, semiring: str, tile_order: str) -> int:
    """The longest run of the host tile store (a run is never split)."""
    import numpy as np

    st = session.host_view().blocked_store(semiring, reverse=False,
                                           tile_order=tile_order)
    starts = np.flatnonzero(st.first)
    return int(np.diff(np.append(starts, st.num_tiles)).max())


def check_host(label, dev, host, exact, torch) -> None:
    """Host against device residency: values, and for BFS/WCC every IOStats
    field but host_bytes and retries."""
    if exact:
        if not torch.equal(host.values, dev.values):
            raise AssertionError(f"{label}: host values differ from device")
    else:
        torch.testing.assert_close(host.values, dev.values, atol=PR_ATOL,
                                   rtol=PR_RTOL)
    a, b = io_dict(host.iostats), io_dict(dev.iostats)
    fields = [f for f in a if f not in ("host_bytes", "retries")]
    if exact:
        check_io(label, a, b, fields)
    else:
        diff = {f: (a[f], b[f]) for f in fields if a[f] != b[f]}
        if diff:
            log(f"{label}: PageRank counters differ host/device (P2): {diff}")
    if a["host_bytes"] == 0:
        raise AssertionError(f"{label}: host run shipped nothing")


def phase_host(torch):
    """Host residency against device residency (see the module docstring).
    Returns the host sessions the profile phase reuses and the host
    launch counts."""
    import numpy as np

    import repro_torch
    from repro_torch.graph.generators import rmat

    rate = pinned_h2d_rate(torch)
    log(f"host: pinned host-to-device copy_ of 1 GiB: {rate / 1e9:.2f} GB/s")
    host_counts = {}
    rows = []

    def twin(label, D, H, call, pol, exact, dev_cache):
        key = (label, pol.backend, pol.tile_order)
        if key not in dev_cache:
            dev_cache[key] = timed(lambda: call(D, pol), torch)[:2]
        dres, dms = dev_cache[key]
        hpol = pol.with_(residency="host")
        hv = H.host_view()
        before = hv.streamed_bytes
        hres, hms, launched = timed(lambda: call(H, hpol), torch)
        streamed = hv.streamed_bytes - before
        for k, v in launched.items():
            host_counts[k] = host_counts.get(k, 0) + v
        name = f"{label}/{pol.backend}/{pol.tile_order}/sb{pol.stream_buffer}"
        check_host(name, dres, hres, exact, torch)
        hb = int(hres.iostats.host_bytes)
        # IOStats.host_bytes is int32 and wraps like the reference's.
        if hb != (streamed + 2**31) % 2**32 - 2**31:
            raise AssertionError(f"{name}: host_bytes {hb} is not the "
                                 f"streamed {streamed} B modulo 2^32")
        rows.append((name, dms, hms, streamed))
        log(f"host {name:40s} supersteps={int(hres.supersteps)} device_ms="
            f"{dms:.1f} host_ms={hms:.1f} ratio={dms / hms:.3f} streamed="
            f"{streamed} B ({streamed / (hms / 1e3) / 1e9:.2f} GB/s) "
            f"host_bytes={hb}{' (wrapped)' if hb != streamed else ''}")

    def bound_check(H, pol, runs_fit: bool):
        rep = H.memory_report(pol.with_(residency="host"))
        if rep["device_edge_total"] != 0:
            raise AssertionError(f"host session holds device edges: {rep}")
        peak, buf = rep["peak_stage_bytes"], rep["stream_buffer_bytes"]
        if runs_fit and not 0 < peak <= 2 * buf:
            raise AssertionError(f"peak_stage_bytes {peak} > 2 x {buf}")
        log(f"host memory_report: device_edge_total=0 host_store_bytes="
            f"{rep['host_store_bytes']} peak_stage_bytes={peak} "
            f"stream_buffer_bytes={buf}"
            + ("" if runs_fit else " (runs exceed the buffer: no bound)"))

    # (a) chunk stores at scale 20
    t0 = time.perf_counter()
    ga = rmat(20, edge_factor=16, seed=1)
    hub_a = int(np.argmax(np.diff(ga.indptr)))
    Da = repro_torch.Graph(ga, device="cuda")
    Ha = repro_torch.Graph(ga, device="cuda")
    hv = Ha.host_view()
    log(f"host (a): rmat(20) n={ga.n} m={ga.m} hub={hub_a}; chunk stores "
        f"{hv.out_store.nbytes} + {hv.in_store.nbytes} B in host RAM; built "
        f"in {time.perf_counter() - t0:.1f} s")
    dev_cache: dict = {}
    for backend in ("scan", "compact"):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        twin("pr_push", Da, Ha, lambda G, p: G.pagerank(policy=p), pol, False,
             dev_cache)
        twin("pr_pull", Da, Ha, lambda G, p: G.pagerank(
            mode="pull", max_iters=PULL_ITERS_20, policy=p), pol, False,
             dev_cache)
        twin("bfs_hub", Da, Ha, lambda G, p: G.bfs(hub_a, policy=p), pol,
             True, dev_cache)
        bound_check(Ha, pol, True)
    del Da
    torch.cuda.empty_cache()

    # (b) tile stores at scale 14
    gb = rmat(14, edge_factor=16, seed=1, symmetrize=True)
    hub_b = int(np.argmax(np.diff(gb.indptr)))
    Db = repro_torch.Graph(gb, device="cuda")
    Hb = repro_torch.Graph(gb, device="cuda")
    log(f"host (b): rmat(14, symmetrize) n={gb.n} m={gb.m} hub={hub_b}")
    runs = {
        "wcc": (lambda G, p: G.run(wcc_program(), policy=p), True),
        "bfs_hub": (lambda G, p: G.bfs(hub_b, policy=p), True),
        "pr_push": (lambda G, p: G.pagerank(max_iters=PUSH_ITERS_14,
                                            policy=p), False),
    }
    dev_cache = {}
    for order, sb, names in (("dest", 16, ("wcc", "bfs_hub", "pr_push")),
                             ("hilbert", 16, ("wcc",)),
                             ("hilbert", 1, ("wcc", "bfs_hub"))):
        # the peak is a session-wide maximum: measure each setting alone
        Hb.host_view().peak_stage_bytes = 0
        for backend in ("blocked", "blocked_compact"):
            pol = repro_torch.ExecutionPolicy(backend=backend,
                                              tile_order=order,
                                              stream_buffer=sb)
            for name in names:
                call, exact = runs[name]
                twin(name, Db, Hb, call, pol, exact, dev_cache)
        longest = max_run_tiles(Hb, "min_plus", order)
        log(f"host (b) {order}: longest run {longest} tiles, stream_buffer "
            f"{sb}")
        bound_check(Hb, repro_torch.ExecutionPolicy(
            backend="blocked", tile_order=order, stream_buffer=sb),
            longest <= sb)
    log(f"host launches (apart from the main paths): {host_counts}")
    require_launched("host path", host_counts, ("spmv_blocked_compact",
                                                "spmv_blocked_compact_min_plus"))
    log(f"host h2d rate bound: {rate / 1e9:.2f} GB/s pinned copy_")
    del Db
    torch.cuda.empty_cache()
    return Ha, Hb, host_counts, rows, rate


def phase_warmup() -> None:
    """One PageRank and one BFS per backend on a small graph, so that the
    main path's wall times exclude first-call costs (library load, caching
    allocator).  The card-against-CPU check of this graph is
    ``tests/test_torch_cuda.py::test_card_matches_cpu``."""
    import repro_torch
    from repro_torch.graph.generators import rmat

    g = rmat(10, edge_factor=8, seed=3, symmetrize=True)
    G = repro_torch.Graph(g, device="cuda")
    H = repro_torch.Graph(g, device="cuda")
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        for S, p in ((G, pol), (H, pol.with_(residency="host"))):
            S.pagerank(tol=1e-4, policy=p)
            S.bfs([0, 1, 2, 3], policy=p)
            S.run(wcc_program(), policy=p)
    log("warm-up: every backend ran once on rmat(10), both residencies")


def kernel_inputs(bg, frontier, k, torch, seed):
    """Random x blocks (min_plus: integer labels, a tenth of them +inf) and
    the tile activity of ``frontier``."""
    from repro_torch.kernels.spmv import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x_blocks = torch.rand((bg.n_src_blocks, bg.bs, k), generator=gen,
                          device="cuda")
    if bg.semiring == "min_plus":
        unreached = torch.rand(x_blocks.shape, generator=gen,
                               device="cuda") < 0.1
        x_blocks = torch.where(unreached, float("inf"),
                               torch.floor(x_blocks * bg.n))
    act = ops.tile_activity(bg, frontier, "src")
    return x_blocks, act


def compact_args(bg, act):
    from repro_torch.kernels.spmv import ops

    perm, dbid, sbid, first, last, accum, nact = ops.compact_tile_order(bg, act)
    G = ops.compact_grid_size(bg.num_tiles, nact)
    return (perm[:G], dbid[:G], sbid[:G], first[:G], last[:G], accum[:G],
            nact)


def max_err(got, want, exact: bool, torch) -> float:
    """B1/B2: within atol=rtol=1e-5; B3/B4 (``exact``): bit for bit."""
    if exact:
        if not torch.equal(got, want):
            raise AssertionError("min_plus kernel differs from its plain "
                                 "version")
        return 0.0
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    return float((got - want).abs().max())


# kernel name -> (tile encoding, full-schedule kernel?)
KERNELS = {"spmv_blocked": ("plus_times", True),
           "spmv_blocked_compact": ("plus_times", False),
           "spmv_blocked_min_plus": ("min_plus", True),
           "spmv_blocked_compact_min_plus": ("min_plus", False)}
REPLACES = {"spmv_blocked": "src/repro/kernels/spmv/kernel.py:86",
            "spmv_blocked_compact": "src/repro/kernels/spmv/kernel.py:199",
            "spmv_blocked_min_plus": "src/repro/kernels/spmv/kernel.py:113",
            "spmv_blocked_compact_min_plus":
                "src/repro/kernels/spmv/kernel.py:227"}


def phase_kernels(G, W, torch):
    """Hold B1-B4 against the plain versions; returns max errors by kernel."""
    import repro_torch
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    small = repro_torch.Graph(rmat(14, edge_factor=16, seed=1), device="cuda")
    small_sym = repro_torch.Graph(rmat(14, edge_factor=16, seed=1,
                                       symmetrize=True), device="cuda")
    views = {
        ("plus_times", "dest"): G.device(blocked=True).out_blocked,
        ("plus_times", "hilbert"): small.device(
            blocked=True, tile_order="hilbert").out_blocked,
        ("min_plus", "dest"): W.device(
            blocked=True, blocked_semiring="min_plus").out_blocked,
        ("min_plus", "hilbert"): small_sym.device(
            blocked=True, blocked_semiring="min_plus",
            tile_order="hilbert").out_blocked,
    }
    errs = {name: 0.0 for name in KERNELS}
    for (enc, order), bg in views.items():
        full_name, compact_name = [n for n, (e, _) in KERNELS.items()
                                   if e == enc]
        n = bg.n
        full = torch.ones(n, dtype=torch.bool, device="cuda")
        sparse = torch.arange(n, device="cuda") < n // 8
        for k in (1, 4):
            for fname, frontier in (("full", full), ("sparse", sparse)):
                x_blocks, act = kernel_inputs(bg, frontier, k, torch, seed=k)
                exact = enc == "min_plus"
                e1 = max_err(K.spmv_blocked(bg, act, x_blocks),
                             K.blocked_spmv_plain(bg, act, x_blocks), exact,
                             torch)
                args = compact_args(bg, act)
                e2 = max_err(K.spmv_blocked_compact(bg, *args, x_blocks),
                             K.blocked_spmv_plain_compact(bg, *args, x_blocks),
                             exact, torch)
                errs[full_name] = max(errs[full_name], e1)
                errs[compact_name] = max(errs[compact_name], e2)
                log(f"kernel check {enc:10s} {order:7s} k={k} {fname:6s} "
                    f"live={int(act.sum())}/{bg.num_tiles} full err={e1:.3g}"
                    f" compact err={e2:.3g}")
    torch.cuda.synchronize()
    return errs


def bound(bg, act, k: int, schedule_entries: int):
    """(bound_ms, bound_by) of one product over the live tiles (``act``):
    their tile bytes, the x blocks they read, all of y, and 16 bytes of
    int32 schedule per entry the kernel walks (B1/B3: every tile's id, run
    flag, activity flag and source block; B2/B4: each live tile's id, run
    flag, destination and source block) over the memory rate, against 2
    operations per tile slot and lane (multiply-add, or add and min) over
    the f32 peak."""
    import torch

    live = act.bool()
    live_tiles = int(live.sum())
    live_src_blocks = int(torch.unique(bg.sbid[live]).numel())
    nbytes = (live_tiles * bg.bd * bg.bs * 4
              + live_src_blocks * bg.bs * k * 4
              + bg.n_dst_blocks * bg.bd * k * 4 + schedule_entries * 16)
    flops = 2.0 * live_tiles * bg.bd * bg.bs * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def live_edges(g, frontier_np):
    """(src, dst) of the live edges (source active), as numpy int64."""
    import numpy as np

    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    keep = frontier_np[src]
    return src[keep], g.indices[keep].astype(np.int64)


def live_csr(g, frontier_np, torch):
    """The live edges (source active) as a CUDA CSR matrix, rows = dst."""
    import numpy as np

    src, dst = live_edges(g, frontier_np)
    idx = torch.as_tensor(np.stack([dst, src]))
    with warnings.catch_warnings():
        # torch flags its sparse invariant checks and CSR support as beta.
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(idx, torch.ones(len(src)),
                                      (g.n, g.n), check_invariants=True)
        return coo.coalesce().to_sparse_csr().cuda()


def library_call(name, g, frontier_np, x_blocks, torch):
    """One PyTorch call computing the kernel's function over the same live
    edges: ``torch.sparse.mm`` (plus_times), or ``scatter_reduce_`` with
    'amin' over ``x[src] + w``, the gather included (min_plus)."""
    n = g.n
    xv = x_blocks.reshape(-1, 1)[:n].contiguous()
    if KERNELS[name][0] == "plus_times":
        A = live_csr(g, frontier_np, torch)
        return lambda: torch.sparse.mm(A, xv)
    src, dst = (torch.as_tensor(a, device="cuda")
                for a in live_edges(g, frontier_np))
    w = torch.zeros(src.numel(), device="cuda")  # unweighted: w = 0
    x1 = xv[:, 0]

    def run():
        y = torch.full((n,), float("inf"), device="cuda")
        return y.scatter_reduce_(0, dst, x1[src] + w, "amin",
                                 include_self=True)

    return run


def phase_time(g, G, wg, W, torch):
    """Time B1/B3 (full frontier) and B2/B4 (frontier of the first n/8
    vertices) at K=1 on the main paths' 'dest' views."""
    import numpy as np

    from repro_torch.kernels.spmv import kernel as K

    views = {"plus_times": (g, G.device(blocked=True).out_blocked),
             "min_plus": (wg, W.device(blocked=True,
                                       blocked_semiring="min_plus")
                          .out_blocked)}
    rows = {}
    for name, (enc, full_schedule) in KERNELS.items():
        graph, bg = views[enc]
        n = bg.n
        frontier_np = np.ones(n, bool) if full_schedule else np.arange(n) < n // 8
        frontier = torch.as_tensor(frontier_np, device="cuda")
        x_blocks, act = kernel_inputs(bg, frontier, 1, torch, seed=7)
        live = int(act.sum())
        if full_schedule:
            def run():
                return K.spmv_blocked(bg, act, x_blocks)

            def plain():
                return K.blocked_spmv_plain(bg, act, x_blocks)
        else:
            args = compact_args(bg, act)

            def run():
                return K.spmv_blocked_compact(bg, *args, x_blocks)

            def plain():
                return K.blocked_spmv_plain_compact(bg, *args, x_blocks)
        lib = library_call(name, graph, frontier_np, x_blocks, torch)
        ms = cuda_ms(run, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        library_ms = cuda_ms(lib, reps=20)
        bound_ms, bound_by = bound(bg, act, 1,
                                   bg.num_tiles if full_schedule else live)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, live=live)
        log(f"time {name}: live={live}/{bg.num_tiles} ms={ms:.3f} "
            f"bound_ms={bound_ms:.3f} ({bound_by}) plain_ms={plain_ms:.3f} "
            f"library_ms={library_ms:.3f}")
    return rows


def phase_profile(runs, torch) -> dict:
    """Device time against wall time of each named call (torch.profiler,
    CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, call in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernel events only: an aten op's self device time repeats the
        # time of the kernels it launched.
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:4]
        out[name] = dict(wall_ms=wall_ms, device_ms=device_ms, top={
            e.key[:60]: round(e.self_device_time_total / 1e3, 3) for e in top})
        log(f"profile {name}: wall_ms={wall_ms:.1f} device_ms={device_ms:.1f} "
            f"idle_share={1 - device_ms / wall_ms:.3f} top={out[name]['top']}")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = K.build_library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in Path(str(lib) + ".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"ptxas: {line.strip()}")

    t0 = time.perf_counter()
    g = rmat(16, edge_factor=16, seed=1)
    if (g.n, g.m) != (65536, 955396):
        raise AssertionError(f"rmat(16) gave n={g.n} m={g.m}")
    G = repro_torch.Graph(g, device="cuda")
    bg = G.device(blocked=True).out_blocked
    torch.cuda.synchronize()
    log(f"graph: n={g.n} m={g.m} tiles={bg.num_tiles} "
        f"({bg.tiles.nbytes / 1e9:.2f} GB on the card) built in "
        f"{time.perf_counter() - t0:.1f} s")

    hub = int(np.argmax(np.diff(g.indptr)))
    phase_warmup()
    results, wall, counts = phase_main(G, hub, torch)
    phase_check(g, hub, results, torch)
    W, wg, wcc_wall, wcc_counts = phase_wcc(torch)
    Ha, Hb, host_counts, host_rows, rate = phase_host(torch)
    errs = phase_kernels(G, W, torch)
    times = phase_time(g, G, wg, W, torch)
    blocked = repro_torch.ExecutionPolicy(backend="blocked")
    host_scan = repro_torch.ExecutionPolicy(residency="host")
    host_bc = repro_torch.ExecutionPolicy(backend="blocked_compact",
                                          residency="host")
    phase_profile((
        ("blocked/pr_push", lambda: G.pagerank(policy=blocked)),
        ("blocked/bfs_hub", lambda: G.bfs(hub, policy=blocked)),
        ("host/scan/pr_push", lambda: Ha.pagerank(
            max_iters=PROFILE_ITERS, policy=host_scan)),
        ("host/blocked_compact/wcc", lambda: Hb.run(wcc_program(),
                                                    policy=host_bc)),
    ), torch)

    launched = dict(counts)
    launched.update({k: wcc_counts[k] for k in ("spmv_blocked_min_plus",
                                                "spmv_blocked_compact_min_plus")})
    kernels = [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/csrc/spmv.cu", "replaces": REPLACES[name],
         "launches": launched[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name in KERNELS
    ]
    main_ms = {f"{b}/{r}": round(v, 3) for (b, r), v in wall.items()}
    log(f"main path wall ms: {json.dumps(main_ms)}")
    log(f"wcc wall ms: {json.dumps({b: round(v, 3) for b, v in wcc_wall.items()})}")
    log("host runs [device ms, host ms, streamed bytes]: " + json.dumps(
        {n: [round(d, 3), round(h, 3), b] for n, d, h, b in host_rows}))
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
