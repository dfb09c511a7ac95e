"""Batched multi-source queries on the PyTorch port: amortize one edge
stream over Q answers (the twin of ``examples/batched_queries.py``).

    PYTHONPATH=src python examples_torch/batched_queries.py [--device cpu]

Concurrent queries are the serving workload of a graph library: many
personalized-PageRank or BFS requests against ONE immutable graph.  The
batched driver runs Q of them as a single engine pass over an ``(n, Q)``
state block — the union of the live frontiers drives the fetch schedule,
so every streamed edge chunk is paid once and multiplied against all Q
query columns.  Per-query I/O falls toward 1/Q of the solo cost, while
every BFS answer stays exactly what it would be alone.  Runs on the CUDA
device unless ``--device`` says otherwise.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

import repro_torch
from repro_torch._device import resolve_device
from repro_torch.graph.generators import rmat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # A power-law graph with Twitter-like skew, edges streamed from host
    # RAM (residency='host': the true-SEM configuration — zero
    # device-resident edge bytes, a measured host-link odometer).
    g = repro_torch.Graph(rmat(12, edge_factor=16, seed=7, symmetrize=True),
                          chunk_size=1024, device=device)
    host = repro_torch.ExecutionPolicy(residency="host", switch_fraction=None)
    print(f"graph: n={g.n} m={g.m}")

    # 1. Batched personalized PageRank: one engine pass, Q=8 reset
    #    vertices.  values[:, q] is query q's personalized fixed point —
    #    what g.pagerank(reset=[seeds[q]]) alone returns.
    seeds = [0, 3, 17, 42, 99, 256, 1024, 2048]
    ppr = g.pagerank(reset=seeds, policy=host)
    print(f"\npersonalized pagerank, Q={int(ppr.iostats.queries)}:")
    print(f"  values: {tuple(ppr.values.shape)}, converged at supersteps "
          f"{ppr.query_supersteps.tolist()}")
    for q in (0, 5):
        top = int(torch.argsort(-ppr.values[:, q], stable=True)[1])
        print(f"  query {q} (restart@{seeds[q]}): "
              f"top non-source vertex {top}")

    # 2. The amortization, measured: Q solo BFS runs vs one batched run.
    #    host_bytes is an odometer of bytes that actually crossed the host
    #    link — the SSD-bandwidth analogue of the paper's Fig. 4/5.
    solo_bytes = 0
    for s in seeds:
        solo_bytes += int(g.bfs(s, policy=host).iostats.host_bytes)
    batched = g.bfs(seeds, policy=host)
    bb = int(batched.iostats.host_bytes)
    print(f"\nbfs host-link bytes, {len(seeds)} queries:")
    print(f"  sequential: {solo_bytes / 1e6:7.2f} MB "
          f"({solo_bytes / len(seeds) / 1e6:.2f} MB/query)")
    print(f"  batched:    {bb / 1e6:7.2f} MB "
          f"({bb / len(seeds) / 1e6:.2f} MB/query)")
    print(f"  -> {solo_bytes / bb:.1f}x fewer bytes per query")

    # 3. Per-query convergence: each column retires (and stops costing
    #    anything) at its own superstep; the batched total is their max.
    print(f"\nbfs query_supersteps: "
          f"{batched.query_supersteps.tolist()} "
          f"(batched run: {int(batched.supersteps)})")

    # 4. The axis that bounds Q is vertex state, not edge bandwidth: the
    #    (n, Q) term grows linearly while edge bytes stay ~flat.
    for q in (1, 8, 64):
        mb = g.memory_report(host, batch=q)["query_state_bytes"] / 1e6
        print(f"  memory_report(batch={q:3d}): query_state_bytes "
              f"{mb:6.2f} MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
