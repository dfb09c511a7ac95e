"""The paper's scenario end-to-end on the PyTorch port: run the whole
Graphyti library over one ``repro_torch.Graph`` session and report the
per-algorithm I/O ledger (the twin of ``examples/graph_analytics.py``).

One :class:`~repro_torch.core.ExecutionPolicy` drives every algorithm's
engine dispatch — direction='auto' gives the traversals (diameter's BFS
sweeps, betweenness forward) Beamer-style push<->pull switching,
chunk_cap + adaptive_cap keep draining frontiers on pow2-bucketed compact
work-lists, and the p2p arm takes the sparse tails.  The session builds its
SEM view once; every method reuses it and returns the same
``ProgramResult`` shape, so the ledger below is one loop over uniform
results.  Runs on the CUDA device unless ``--device`` says otherwise.

    PYTHONPATH=src python examples_torch/graph_analytics.py [--scale 11] [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

import repro_torch
from repro_torch._device import resolve_device
from repro_torch.graph.generators import rmat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def elapsed(t0: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    g = repro_torch.Graph(rmat(args.scale, edge_factor=8, seed=3,
                               symmetrize=True),
                          chunk_size=2048, device=device)
    # One policy object replaces the per-algorithm knob sprawl: the engine
    # owns direction, density dispatch, and work-list sizing (paper §4.2).
    policy = repro_torch.ExecutionPolicy(
        direction="auto",                 # Beamer push<->pull per superstep
        backend="compact",                # frontier-compacted chunk scans
        chunk_cap=max(1, -(-g.m // 2048)),
        adaptive_cap=True,                # pow2 work-list re-bucketing
        switch_fraction=0.10,             # p2p on the sparse tail
        vcap=max(64, g.n // 4),
        ecap=max(256, g.m // 10),
    )
    print(f"graph: n={g.n} m={g.m} | policy: {policy.direction}/"
          f"{policy.backend} | ledger: MB read / requests / supersteps")

    def record(name, res, t):
        mb = res.iostats.bytes() / 1e6  # layout-aware bytes, not slot counts
        print(f"  {name:12s} {mb:9.2f} MB {int(res.iostats.requests):9d} req "
              f"{int(res.supersteps):5d} steps {t:7.2f}s")

    t0 = time.perf_counter()
    pr = g.pagerank(policy=policy)
    record("pagerank", pr, elapsed(t0))

    t0 = time.perf_counter()
    core = g.coreness(policy=policy)
    record("coreness", core, elapsed(t0))
    print(f"    kmax = {int(core.values.max())}")

    t0 = time.perf_counter()
    diam = g.diameter(num_sources=16, sweeps=1, policy=policy)
    record("diameter", diam, elapsed(t0))
    print(f"    estimate = {int(diam.values)}")

    t0 = time.perf_counter()
    # the 8 sources of largest degree, ranked on the host CSR as the
    # reference ranks them (numpy's sort, so ties fall alike)
    deg = g.host.out_degree
    srcs = np.argsort(-deg)[:8].astype(np.int32)
    bc = g.betweenness(srcs, mode="fused")
    record("betweenness", bc, elapsed(t0))
    print(f"    shared fetches = {int(bc.state.shared)}")

    t0 = time.perf_counter()
    tri = g.triangles(variant="restarted", ordered=True)
    record("triangles", tri, elapsed(t0))
    print(f"    count = {int(tri.values)}")

    t0 = time.perf_counter()
    lv = g.louvain(materialize=False, max_levels=5)
    record("louvain", lv, elapsed(t0))
    print(f"    modularity = {lv.state.modularity:.3f} "
          f"({int(lv.iostats.bytes_moved)} bytes rewritten)")

    # True SEM rerun: residency='host' keeps the O(m) edge store in host
    # RAM and double-buffers the live work-list to the device — the same
    # policy object drives it (with_ swaps one field).  A fresh session
    # proves the residency claim: zero device-resident edge bytes against
    # the O(m) device copy above, staging that stays O(buffer) while the
    # device copy grows O(m), and bit-identical ranks.
    g_host = repro_torch.Graph(g.host, chunk_size=2048, device=device)
    host_pol = policy.with_(residency="host")
    t0 = time.perf_counter()
    pr_h = g_host.pagerank(policy=host_pol)
    record("pagerank/host", pr_h, elapsed(t0))
    mr_h = g_host.memory_report(host_pol)
    mr_d = g.memory_report()
    assert torch.equal(pr_h.values, pr.values)
    print(f"    device edge bytes: {mr_d['device_edge_total'] / 1e6:.2f} MB "
          f"(device) -> {mr_h['device_edge_total']} (host); "
          f"{int(pr_h.iostats.host_bytes) / 1e6:.2f} MB over the link, "
          f"peak staging {mr_h['peak_stage_bytes'] / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
