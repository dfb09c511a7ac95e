#!/usr/bin/env python3
"""Host-link bytes a query of batched BFS against solo runs, under host
residency: the amortization ``chip_smoke.py``'s batched_host phase gates.

    PYTHONPATH=src python3 scripts/host_batch_factor.py --scale 20 \\
        --backend scan --rule nonzero --seed 7
    PYTHONPATH=src python3 scripts/host_batch_factor.py --scale 14 \\
        --symmetrize --backend blocked_compact --rule all --seed 7

Runs ``Graph.bfs(S)`` for Q sources and each source alone on
``rmat(scale, edge_factor=16, seed=1)`` and prints ``host_bytes`` (the
reference's count, unwrapped: dense tile batches as ``chip_smoke.StageLog``
counts them, plus every other arm's payload), the bytes really streamed,
and the factor ``solo mean / (batched / Q)`` of each.  These are counts,
the same on any device, so ``--device cpu`` (the default) gives the card's
numbers.  ``--rule all`` draws the sources from every vertex (the rule of
``benchmarks/bench_multisource.py``), ``nonzero`` from the vertices with an
out-edge, ``hubs`` takes the Q of largest out-degree.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import numpy as np

    import chip_smoke as cs
    import repro_torch
    from repro_torch.graph.generators import rmat

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--symmetrize", action="store_true")
    ap.add_argument("--backend", default="scan")
    ap.add_argument("--rule", choices=("all", "nonzero", "hubs"),
                    default="nonzero")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    g = rmat(args.scale, edge_factor=16, seed=1, symmetrize=args.symmetrize)
    H = repro_torch.Graph(g, device=args.device)
    deg = np.diff(g.indptr)
    rng = np.random.default_rng(args.seed)
    if args.rule == "all":
        S = rng.choice(g.n, args.queries, replace=False)
    elif args.rule == "nonzero":
        S = rng.choice(np.flatnonzero(deg > 0), args.queries, replace=False)
    else:
        S = cs.top_degree(g, args.queries)
    pol = repro_torch.ExecutionPolicy(backend=args.backend, residency="host")

    def run(sources):
        hv = H.host_view()
        before = hv.streamed_bytes
        with cs.StageLog() as tiles:
            H.bfs(sources, policy=pol)
        streamed = hv.streamed_bytes - before
        return tiles.dense + streamed - tiles.payload, streamed

    hb, st = run(S.tolist())
    solo = np.array([run(int(s)) for s in S], dtype=np.float64)
    q = args.queries
    print(f"rmat({args.scale}{', symmetrize' if args.symmetrize else ''}) "
          f"{args.backend} rule={args.rule} seed={args.seed} sources "
          f"{S.tolist()} out-degrees {deg[S].tolist()}")
    print(f"host_bytes: batched {hb}, solo mean {solo[:, 0].mean():.1f}, "
          f"factor {solo[:, 0].mean() / (hb / q):.3f}")
    print(f"streamed:   batched {st}, solo mean {solo[:, 1].mean():.1f}, "
          f"factor {solo[:, 1].mean() / (st / q):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
