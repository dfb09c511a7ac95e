"""Walls of host-residency WCC on a host tile store, and where the host
time of each run goes.

Runs weakly connected components (``chip_smoke.wcc_program``) with
``residency='host'`` on the blocked_compact backend over the graph of
``chip_smoke.py``'s host (b) phase (``rmat(14, symmetrize=True)``), once
for each tile order and ``stream_buffer`` asked, and prints one JSON line
a run: the wall, the batches staged, and the host milliseconds spent in
staging (``_Stager.stage``: filling a pinned buffer and issuing its copy)
and in the SpMV wrapper (``spmv_blocked_compact``, launches only).  The
labels are held against numpy union-find.

    python3 scripts/host_tile_walls.py [--src DIR] [--tag NAME]
        [--runs hilbert:16,hilbert:1,dest:16] [--device cuda]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported, so
two checkouts compare on one card (run them in turn: A, B, B, A).
``--device cpu`` rehearses the script on a small graph (``--scale``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--runs", default="hilbert:16,hilbert:1,dest:16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=14)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))

    import numpy as np
    import torch

    import repro_torch
    import repro_torch.kernels.spmv as spmv
    from chip_smoke import numpy_wcc, wcc_program
    from repro_torch.core import residency
    from repro_torch.graph.generators import rmat

    if args.device == "cuda" and not torch.cuda.is_available():
        print("host_tile_walls: no CUDA device", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    g = rmat(args.scale, edge_factor=16, seed=1, symmetrize=True)
    want = numpy_wcc(g)
    H = repro_torch.Graph(g, device=args.device)
    print(f"{args.tag}: repro_torch from {Path(repro_torch.__file__).parent}; "
          f"rmat({args.scale}, symmetrize) n={g.n} m={g.m}", flush=True)

    spent = {"stage": 0.0, "wrapper": 0.0, "batches": 0}
    stage, wrapper = residency._Stager.stage, spmv.spmv_blocked_compact

    def timed_stage(stager, layout, fill):
        t0 = time.perf_counter()
        out = stage(stager, layout, fill)
        spent["stage"] += time.perf_counter() - t0
        spent["batches"] += 1
        return out

    def timed_wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = wrapper(*a, **kw)
        spent["wrapper"] += time.perf_counter() - t0
        return out

    residency._Stager.stage = timed_stage
    spmv.spmv_blocked_compact = timed_wrapper
    # warm-up: the kernel's library, the allocator and the stager's buffers
    H.run(wcc_program(), policy=repro_torch.ExecutionPolicy(
        backend="blocked_compact", residency="host", stream_buffer=16))
    sync()
    for spec in args.runs.split(","):
        order, sb = spec.split(":")
        pol = repro_torch.ExecutionPolicy(
            backend="blocked_compact", residency="host", tile_order=order,
            stream_buffer=int(sb))
        H.host_view().blocked_store("min_plus", reverse=False,
                                    tile_order=order)  # built outside
        spent.update(stage=0.0, wrapper=0.0, batches=0)
        t0 = time.perf_counter()
        res = H.run(wcc_program(), policy=pol)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(res.values.cpu().numpy(), want):
            raise AssertionError(f"{spec}: labels differ from union-find")
        print(json.dumps({
            "tag": args.tag, "order": order, "stream_buffer": int(sb),
            "wall_ms": wall, "batches": spent["batches"],
            "stage_ms": spent["stage"] * 1e3,
            "wrapper_ms": spent["wrapper"] * 1e3,
            "supersteps": int(res.supersteps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
