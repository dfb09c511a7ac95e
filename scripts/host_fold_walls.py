"""Host-resident PageRank on the card against the device-resident run, for
comparing two trees: its wall and whether its ranks have the device run's
bits.

Runs ``pagerank()`` (push, then pull, or the ``--modes`` given) on
``chip_smoke.py``'s host (a) graph (``rmat(20, edge_factor=16, seed=1)``)
with the scan backend, once device-resident and once host-resident (edges
streamed in ``stream_buffer``-chunk batches), after one warm-up of each,
and prints one JSON line a mode: both walls in ms (ending in
``torch.cuda.synchronize()``), the supersteps, the host wall a superstep,
whether the host ranks equal the device ranks bit for bit and their
largest difference.  ``--max-iters`` below convergence (48 supersteps for
pull, 65 for push) gives two trees the same number of supersteps.

    python3 scripts/host_fold_walls.py [--src DIR] [--tag NAME]
        [--device cuda] [--scale 20] [--modes push,pull] [--max-iters 100]

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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--modes", default="push,pull")
    ap.add_argument("--max-iters", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    import repro_torch
    from repro_torch.graph.generators import rmat

    if args.device == "cuda" and not torch.cuda.is_available():
        print("host_fold_walls: no CUDA device", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    g = rmat(args.scale, edge_factor=16, seed=1)
    D = repro_torch.Graph(g, device=args.device)
    H = repro_torch.Graph(g, device=args.device)
    print(f"{args.tag}: repro_torch from {Path(repro_torch.__file__).parent}; "
          f"rmat({args.scale}) n={g.n} m={g.m}", flush=True)
    device = repro_torch.ExecutionPolicy()
    host = device.with_(residency="host")

    def timed(G, mode, pol):
        sync()
        t0 = time.perf_counter()
        res = G.pagerank(mode=mode, max_iters=args.max_iters, policy=pol)
        sync()
        return res, (time.perf_counter() - t0) * 1e3

    for mode in args.modes.split(","):
        timed(D, mode, device), timed(H, mode, host)  # warm-up
        dres, dms = timed(D, mode, device)
        hres, hms = timed(H, mode, host)
        print(json.dumps({
            "tag": args.tag, "mode": mode, "device_ms": dms, "host_ms": hms,
            "supersteps": [int(dres.supersteps), int(hres.supersteps)],
            "host_ms_per_step": hms / max(int(hres.supersteps), 1),
            "bit_equal": bool(torch.equal(hres.values, dres.values)),
            "max_abs_diff": float((hres.values - dres.values).abs().max()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
