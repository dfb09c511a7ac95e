"""Quickstart: the Graphyti public API on the PyTorch port (the twin of
``examples/quickstart.py``).

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

One ``repro_torch.Graph`` session owns the whole workflow: build the graph
once, the engine builds (and caches) its SEM device views lazily, and every
algorithm — built-in or user-written — runs through the same
``run_program`` driver, returns the same ``ProgramResult``, and is steered
by the same ``ExecutionPolicy``.  Runs on the CUDA device unless
``--device`` says otherwise.
"""
import argparse
import sys
from pathlib import Path
from typing import NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

import repro_torch
from repro_torch._device import resolve_device
from repro_torch.core import MIN_PLUS
from repro_torch.graph.generators import rmat


# 5. (defined ahead of main) Write your own algorithm in ~30 lines: a
#    VertexProgram says WHAT a superstep means; the engine owns HOW it
#    executes (chunk skipping, density dispatch, direction, I/O
#    accounting).  This one is weakly connected components by min-label
#    propagation — see examples_torch/custom_program.py for the narrated
#    version.
class WCCState(NamedTuple):
    labels: torch.Tensor
    active: torch.Tensor


class WCC(repro_torch.VertexProgram):
    semiring = MIN_PLUS

    def init(self, sg, seeds):
        return WCCState(
            torch.arange(sg.n, dtype=torch.float32, device=sg.device),
            torch.ones(sg.n, dtype=torch.bool, device=sg.device))

    def frontier(self, sg, s):
        return repro_torch.Frontier(x=s.labels, active=s.active)

    def apply(self, sg, s, gathered):
        labels = torch.minimum(s.labels, gathered)
        changed = labels < s.labels
        return WCCState(labels, changed), changed

    def finalize(self, sg, s):
        return s.labels.to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. A power-law graph (2^12 vertices, edge factor 16), Twitter-like
    #    skew.  Graph.from_edges(src, dst) works the same from raw COO
    #    arrays.
    g = repro_torch.Graph(rmat(12, edge_factor=16, seed=7), chunk_size=1024,
                          device=device)
    print(f"graph: n={g.n} m={g.m}")

    # 2. PR-push vs PR-pull — same ranks, different I/O (paper Fig. 2).
    #    The session reuses one cached SEM view for both runs.
    push = g.pagerank()              # Graphyti's delta-push (P1)
    pull = g.pagerank(mode="pull")   # the Pregel-style baseline
    print(f"pagerank: {int(push.supersteps)} supersteps, "
          f"top vertex {int(push.values.argmax())}")
    print(f"  push: {push.iostats.bytes() / 1e6:8.2f} MB read, "
          f"{int(push.iostats.requests):8d} requests")
    print(f"  pull: {pull.iostats.bytes() / 1e6:8.2f} MB read, "
          f"{int(pull.iostats.requests):8d} requests")
    print(f"  push saves "
          f"{int(pull.iostats.records) / max(int(push.iostats.records), 1):.2f}x "
          "read I/O (paper: 1.8x)")

    # 3. Every engine decision lives in ONE policy object: direction
    #    optimization (Beamer push<->pull), frontier-compacted work-lists,
    #    point-to-point sparse tails... no per-algorithm knobs.
    policy = repro_torch.ExecutionPolicy(direction="auto", backend="compact",
                                         chunk_cap=16, adaptive_cap=True)
    bfs = g.bfs(0, policy=policy)
    print(f"bfs: {int(bfs.supersteps)} supersteps, "
          f"{int(bfs.iostats.chunks_skipped)} chunk fetches skipped")

    # 4. Coreness with k-pruning + hybrid messaging (paper Fig. 3) on the
    #    symmetrized graph — a second session.
    gu = repro_torch.Graph(rmat(12, edge_factor=16, seed=7, symmetrize=True),
                           device=device)
    core = gu.coreness()
    print(f"coreness: kmax={int(core.values.max())} "
          f"in {int(core.supersteps)} supersteps")

    # 5. The user-written WCC program above, under the same policy.
    wcc = gu.run(WCC(), policy=policy)
    n_comp = int(torch.unique(wcc.values).shape[0])
    print(f"custom WCC program: {n_comp} components "
          f"in {int(wcc.supersteps)} supersteps")

    # 6. TRUE semi-external memory: residency='host' pins the O(m) edge
    #    store in host RAM and streams only the live work-list to the
    #    device each superstep (double-buffered).  Same bits, same
    #    supersteps, same IOStats as the device run — but the device never
    #    holds the edges: device-resident edge bytes drop to 0, with peak
    #    staging bounded by two stream buffers, O(n) + O(buffer) instead of
    #    O(m) as the graph grows.
    gh = repro_torch.Graph(rmat(12, edge_factor=16, seed=7, symmetrize=True),
                           device=device)
    host_pol = repro_torch.ExecutionPolicy(residency="host")
    pr_host = gh.pagerank(policy=host_pol)
    mr_host = gh.memory_report(host_pol)
    mr_dev = gu.memory_report()
    assert torch.equal(pr_host.values, gu.pagerank().values)
    print(f"host residency: {mr_dev['device_edge_total'] / 1e6:.2f} MB device "
          f"edges -> {mr_host['device_edge_total']} bytes; "
          f"{int(pr_host.iostats.host_bytes) / 1e6:.2f} MB streamed, "
          f"peak staging {mr_host['peak_stage_bytes'] / 1e3:.0f} KB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
