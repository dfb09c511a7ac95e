"""A user-defined algorithm in ~30 lines: weakly connected components, on
the PyTorch port (the twin of ``examples/custom_program.py``).

    PYTHONPATH=src python examples_torch/custom_program.py [--device cpu]

This file is the extensibility proof for the ``VertexProgram`` API: it is
written ONLY against the public surface (``repro_torch.Graph``,
``repro_torch.VertexProgram``, ``repro_torch.ExecutionPolicy``, the
exported semirings) — no engine internals — yet inherits everything the
built-in algorithms get: chunk-skipping SEM I/O accounting, the
multicast/compact/p2p density dispatch, the blocked CUDA backends, and the
shared BSP driver.

The algorithm is label propagation over the min semiring: every vertex
starts with its own id as label; active vertices multicast their label
along out-edges; a vertex adopting a smaller label activates.  On a
symmetrized graph the fixed point labels each weakly connected component
by its smallest member.  Runs on the CUDA device unless ``--device`` says
otherwise.
"""
import argparse
import sys
from pathlib import Path
from typing import NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

import repro_torch
from repro_torch._device import resolve_device
from repro_torch.core import MIN_PLUS


class WCCState(NamedTuple):
    labels: torch.Tensor  # f32[n] current component label
    active: torch.Tensor  # bool[n] changed last superstep


class WCCProgram(repro_torch.VertexProgram):
    """Weakly connected components by min-label propagation."""

    semiring = MIN_PLUS  # y[dst] = min(y[dst], x[src]) on unweighted edges

    def init(self, sg, seeds) -> WCCState:
        return WCCState(
            labels=torch.arange(sg.n, dtype=torch.float32, device=sg.device),
            active=torch.ones(sg.n, dtype=torch.bool, device=sg.device))

    def frontier(self, sg, s: WCCState) -> repro_torch.Frontier:
        return repro_torch.Frontier(x=s.labels, active=s.active)

    def apply(self, sg, s: WCCState, gathered):
        labels = torch.minimum(s.labels, gathered)
        changed = labels < s.labels
        return WCCState(labels, changed), changed

    def finalize(self, sg, s: WCCState) -> torch.Tensor:
        return s.labels.to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # Three ring components of very different sizes.
    comps, src, dst = [900, 90, 10], [], []
    base = 0
    for size in comps:
        v = base + np.arange(size)
        src.append(v), dst.append(base + (np.arange(size) + 1) % size)
        base += size
    g = repro_torch.Graph.from_edges(np.concatenate(src), np.concatenate(dst),
                                     symmetrize=True, chunk_size=256,
                                     device=device)

    policy = repro_torch.ExecutionPolicy(backend="compact", chunk_cap=8,
                                         adaptive_cap=True)
    res = g.run(WCCProgram(), policy=policy)

    _, counts = torch.unique(res.values, return_counts=True)
    sizes = torch.sort(counts, descending=True).values
    print(f"graph: n={g.n} m={g.m}")
    print(f"components: {len(sizes)} (sizes {sizes.tolist()}) "
          f"in {int(res.supersteps)} supersteps")
    print(f"I/O: {res.iostats.bytes() / 1e6:.2f} MB moved, "
          f"{int(res.iostats.chunks_skipped)} chunk fetches skipped")
    assert sizes.tolist() == sorted(comps, reverse=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
