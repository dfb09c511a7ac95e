#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

  1. build   — compile ``src/repro_torch/csrc/spmv.cu`` for sm_90a with nvcc
               (into the git-ignored ``build/kernels/``).
  2. graph   — ``rmat(16, edge_factor=16, seed=1)``: n=65,536, m=955,396;
               its 128x128 f32 tile view (239,398 tiles, ~15.7 GB) lives on
               the card.
  3. main    — after one warm-up run per backend on rmat(10), the main path through ``repro_torch.Graph``: ``pagerank()``
               push and pull and ``bfs(0)`` on the backends scan, compact,
               blocked and blocked_compact, plus ``bfs([0, 1, 2, 3])`` on
               blocked.  Kernel launch counts are zeroed just before and read
               just after; kernels B1 and B2 must both have run.
  4. check   — BFS levels equal across backends and equal a numpy BFS of the
               host CSR; K-lane BFS equals K single-source numpy BFS runs;
               PageRank agrees across backends (atol 1e-6, rtol 1e-5) and
               with a numpy power iteration within the push/pull error bound
               (L1 <= tol / (1 - damping)); BFS IOStats agree field for field
               between backends sharing a layout and in the layout-free
               fields (messages, supersteps) across all four.
  5. kernels — B1 and B2 held against their plain torch versions on the card
               (K=1 and K=4; the 'dest' view at the main path's shapes and a
               'hilbert' view of rmat(14); a sparse frontier on B2), then
               timed beside their bound, the plain version and
               ``torch.sparse.mm`` over the same live edges.

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
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
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


def phase_warmup() -> None:
    """One PageRank and one BFS per backend on a small graph, so that the
    main path's wall times exclude first-call costs (library load, caching
    allocator).  The card-against-CPU check of this graph is
    ``tests/test_torch_cuda.py::test_card_matches_cpu``."""
    import repro_torch
    from repro_torch.graph.generators import rmat

    G = repro_torch.Graph(rmat(10, edge_factor=8, seed=3), device="cuda")
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        G.pagerank(tol=1e-4, policy=pol)
        G.bfs([0, 1, 2, 3], policy=pol)
    log("warm-up: every backend ran once on rmat(10)")


def kernel_inputs(bg, frontier, k, torch, seed):
    from repro_torch.kernels.spmv import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x_blocks = torch.rand((bg.n_src_blocks, bg.bs, k), generator=gen,
                          device="cuda")
    act = ops.tile_activity(bg, frontier, "src")
    return x_blocks, act


def compact_args(bg, act):
    from repro_torch.kernels.spmv import ops

    perm, dbid, sbid, first, last, accum, nact = ops.compact_tile_order(bg, act)
    G = ops.compact_grid_size(bg.num_tiles, nact)
    return (perm[:G], dbid[:G], sbid[:G], first[:G], last[:G], accum[:G],
            nact)


def max_err(got, want, torch) -> float:
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    return float((got - want).abs().max())


def phase_kernels(g, G, torch):
    """Hold B1/B2 against the plain versions; returns max errors by kernel."""
    import repro_torch
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    small = repro_torch.Graph(rmat(14, edge_factor=16, seed=1), device="cuda")
    views = {
        "dest": G.device(blocked=True).out_blocked,
        "hilbert": small.device(blocked=True,
                                tile_order="hilbert").out_blocked,
    }
    errs = {"spmv_blocked": 0.0, "spmv_blocked_compact": 0.0}
    for order, bg in views.items():
        n = bg.n
        full = torch.ones(n, dtype=torch.bool, device="cuda")
        sparse = torch.arange(n, device="cuda") < n // 8
        for k in (1, 4):
            for fname, frontier in (("full", full), ("sparse", sparse)):
                x_blocks, act = kernel_inputs(bg, frontier, k, torch, seed=k)
                e1 = max_err(K.spmv_blocked(bg, act, x_blocks),
                             K.blocked_spmv_plain(bg, act, x_blocks), torch)
                args = compact_args(bg, act)
                e2 = max_err(K.spmv_blocked_compact(bg, *args, x_blocks),
                             K.blocked_spmv_plain_compact(bg, *args, x_blocks),
                             torch)
                errs["spmv_blocked"] = max(errs["spmv_blocked"], e1)
                errs["spmv_blocked_compact"] = max(
                    errs["spmv_blocked_compact"], e2)
                log(f"kernel check {order:7s} k={k} {fname:6s} live="
                    f"{int(act.sum())}/{bg.num_tiles} B1 err={e1:.3g} "
                    f"B2 err={e2:.3g}")
    torch.cuda.synchronize()
    return errs


def bound(bg, act, k: int, schedule_entries: int):
    """(bound_ms, bound_by) of one product over the live tiles (``act``):
    their tile bytes, the x blocks they read, all of y, and 16 bytes of
    int32 schedule per entry the kernel walks (B1: every tile's id, run
    flag, activity flag and source block; B2: each live tile's id, run
    flag, destination and source block) over the memory rate, against 2
    flops per tile slot and lane over the f32 peak."""
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


def live_csr(g, frontier_np, torch):
    """The live edges (source active) as a CUDA CSR matrix, rows = dst."""
    import numpy as np

    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    keep = frontier_np[src]
    idx = torch.as_tensor(np.stack([g.indices[keep].astype(np.int64),
                                    src[keep]]))
    with warnings.catch_warnings():
        # torch flags its sparse invariant checks and CSR support as beta.
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(idx, torch.ones(int(keep.sum())),
                                      (g.n, g.n), check_invariants=True)
        return coo.coalesce().to_sparse_csr().cuda()


def phase_time(g, G, torch):
    """Time B1 (full frontier) and B2 (sparse frontier) at K=1."""
    import numpy as np

    from repro_torch.kernels.spmv import kernel as K

    bg = G.device(blocked=True).out_blocked
    n = bg.n
    rows = {}
    cases = (("spmv_blocked", np.ones(n, bool)),
             ("spmv_blocked_compact", np.arange(n) < n // 8))
    for name, frontier_np in cases:
        frontier = torch.as_tensor(frontier_np, device="cuda")
        x_blocks, act = kernel_inputs(bg, frontier, 1, torch, seed=7)
        live = int(act.sum())
        if name == "spmv_blocked":
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
        A = live_csr(g, frontier_np, torch)
        xv = x_blocks.reshape(-1, 1)[:n].contiguous()
        ms = cuda_ms(run, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        library_ms = cuda_ms(lambda: torch.sparse.mm(A, xv), reps=20)
        bound_ms, bound_by = bound(
            bg, act, 1, bg.num_tiles if name == "spmv_blocked" else live)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, live=live)
        log(f"time {name}: live={live}/{bg.num_tiles} ms={ms:.3f} "
            f"bound_ms={bound_ms:.3f} ({bound_by}) plain_ms={plain_ms:.3f} "
            f"library_ms={library_ms:.3f}")
    return rows


def phase_profile(G, hub, torch) -> dict:
    """Device time against wall time for one blocked PageRank and one
    blocked BFS from the hub (torch.profiler, CUDA activity)."""
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pol = repro_torch.ExecutionPolicy(backend="blocked")
    out = {}
    for name, call in (("blocked/pr_push", lambda: G.pagerank(policy=pol)),
                       ("blocked/bfs_hub", lambda: G.bfs(hub, policy=pol))):
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

    t0 = time.perf_counter()
    lib = K.build_library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in Path(str(lib) + ".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
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
    errs = phase_kernels(g, G, torch)
    times = phase_time(g, G, torch)
    phase_profile(G, hub, torch)

    replaces = {"spmv_blocked": "src/repro/kernels/spmv/kernel.py:86",
                "spmv_blocked_compact": "src/repro/kernels/spmv/kernel.py:199"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/csrc/spmv.cu", "replaces": replaces[name],
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name in ("spmv_blocked", "spmv_blocked_compact")
    ]
    main_ms = {f"{b}/{r}": round(v, 3) for (b, r), v in wall.items()}
    log(f"main path wall ms: {json.dumps(main_ms)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
