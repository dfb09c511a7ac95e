"""Walls of ``Graph.coreness()`` on the card, for comparing two trees.

Runs k-core peeling on ``chip_smoke.py``'s algs graph
(``rmat(16, edge_factor=16, seed=1, symmetrize=True)``) with each
messaging mode (dense, p2p, hybrid) on the scan and blocked backends,
after one warm-up of each, and prints one JSON line a run: the wall in
ms (ending in ``torch.cuda.synchronize()``) and the supersteps.  The core
numbers are held against numpy peeling (``chip_smoke.numpy_coreness``).

    python3 scripts/coreness_walls.py [--src DIR] [--tag NAME] [--reps N]
        [--device cuda] [--scale 16]

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
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))

    import numpy as np
    import torch

    import repro_torch
    from chip_smoke import numpy_coreness
    from repro_torch.graph.generators import rmat

    if args.device == "cuda" and not torch.cuda.is_available():
        print("coreness_walls: no CUDA device", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    g = rmat(args.scale, edge_factor=16, seed=1, symmetrize=True)
    want = numpy_coreness(g)
    A = repro_torch.Graph(g, device=args.device)
    print(f"{args.tag}: repro_torch from {Path(repro_torch.__file__).parent}; "
          f"rmat({args.scale}, symmetrize) n={g.n} m={g.m}", flush=True)
    runs = [(b, m) for b in ("scan", "blocked")
            for m in ("dense", "p2p", "hybrid")]
    for rep in range(args.reps + 1):  # the first pass warms up
        for backend, messaging in runs:
            pol = repro_torch.ExecutionPolicy(backend=backend)
            sync()
            t0 = time.perf_counter()
            res = A.coreness(messaging=messaging, policy=pol)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(res.values.cpu().numpy(), want):
                raise AssertionError(f"{backend}/{messaging}: coreness "
                                     "differs from numpy peeling")
            if rep:
                print(json.dumps({"tag": args.tag, "backend": backend,
                                  "messaging": messaging, "rep": rep,
                                  "wall_ms": ms,
                                  "supersteps": int(res.supersteps)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
