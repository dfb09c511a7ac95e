"""Device time of the blocked SpMV kernels B1-B4 at K lanes, for comparing
two trees on one card.

On the 'dest' views of ``chip_smoke.py``'s main graph (``rmat(16)``) and
its wcc graph (``rmat(16, symmetrize=True)``, min_plus tiles), times one
call of B1/B3 (``spmv_blocked``, every vertex active) and B2/B4
(``spmv_blocked_compact``, the first n/8 vertices active) at each K of
``--ks`` (min_plus at K=1 only, as WCC runs them), each in a CUDA graph
(``chip_smoke.device_ms``), with the device ms of each CUDA kernel launched
(``chip_smoke.kernel_parts``) and ``torch.sparse.mm`` over the same live
edges at the same K (plus_times).  One JSON line a call, after the card's
name and power limit.

    python3 scripts/spmv_walls.py [--src DIR] [--tag NAME] [--ks 1,4,16,32]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (its
kernels are built from that tree's ``csrc``), so two checkouts compare in
one call: run them in turn, A B B A.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--ks", default="1,4,16,32")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("spmv_walls: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from chip_smoke import (compact_args, device_ms, kernel_inputs,
                            kernel_parts, library_call)
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.tag}: repro_torch from "
          f"{Path(repro_torch.__file__).parent} on {smi}", flush=True)
    graphs = {"plus_times": rmat(16, edge_factor=16, seed=1),
              "min_plus": rmat(16, edge_factor=16, seed=1, symmetrize=True)}
    for enc, g in graphs.items():
        bg = repro_torch.Graph(g, device="cuda").device(
            blocked=True, blocked_semiring=enc).out_blocked
        n = bg.n
        ks = [int(k) for k in args.ks.split(",")] if enc == "plus_times" \
            else [1]
        for k in ks:
            for full in (True, False):
                frontier_np = np.ones(n, bool) if full else np.arange(n) < n // 8
                frontier = torch.as_tensor(frontier_np, device="cuda")
                x_blocks, act = kernel_inputs(bg, frontier, k, torch, seed=7)
                if full:
                    name = "spmv_blocked"
                    run = lambda: K.spmv_blocked(bg, act, x_blocks)  # noqa: E731
                else:
                    name = "spmv_blocked_compact"
                    cargs = compact_args(bg, act)
                    run = lambda: K.spmv_blocked_compact(  # noqa: E731
                        bg, *cargs, x_blocks)
                name += "_min_plus" if enc == "min_plus" else ""
                row = {"tag": args.tag, "kernel": name, "k": k,
                       "frontier": "full" if full else "n/8",
                       "device_ms": device_ms(run, torch),
                       "parts": kernel_parts(run, torch)}
                if enc == "plus_times":
                    lib = library_call(name, g, frontier_np, x_blocks, torch)
                    row["library_device_ms"] = device_ms(lib, torch)
                print(json.dumps(row), flush=True)
        del bg
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
