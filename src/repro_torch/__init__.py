"""Graphyti on PyTorch: the semi-external-memory graph library, ported from
the JAX package ``repro`` (which stays the reference).

The public API mirrors ``repro``:

  * :class:`repro_torch.Graph` — the session façade (``from_edges`` /
    ``from_csr``, then ``.pagerank()``, ``.bfs()``, ``.coreness()``,
    ``.betweenness()``, ``.diameter()``, ``.triangles()``, ``.louvain()``
    or ``.run(program)``; many-source BFS, personalized PageRank and
    ``run(batch=Q)`` on the batched driver); its views live on the CUDA
    device unless the caller passes ``device="cpu"``.
  * :class:`repro_torch.VertexProgram` + :func:`repro_torch.run_program` —
    the extension point, driven by one :class:`ExecutionPolicy`.

The blocked backends run hand-written CUDA kernels on the card
(``repro_torch/csrc/spmv.cu``) and their plain torch versions on the CPU.
This package imports neither ``jax`` nor ``repro``.
"""
from .core import (
    ExecutionPolicy,
    Frontier,
    IOStats,
    PolicyError,
    ProgramResult,
    ResidencyError,
    VertexProgram,
    run_program,
)
from .graph.session import Graph

__all__ = [
    "ExecutionPolicy",
    "Frontier",
    "Graph",
    "IOStats",
    "PolicyError",
    "ProgramResult",
    "ResidencyError",
    "VertexProgram",
    "run_program",
]
