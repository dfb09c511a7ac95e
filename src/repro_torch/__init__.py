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
    the extension point, driven by one :class:`ExecutionPolicy`;
    ``checkpoint=CheckpointSpec(...)`` makes any run resumable bit for bit
    (:func:`repro_torch.run_supervised`), and :class:`repro_torch.WorkQueue`
    shards source sweeps across workers that may die.

The blocked backends run hand-written CUDA kernels on the card
(``repro_torch/csrc/spmv.cu``) and their plain torch versions on the CPU.
This package imports neither ``jax`` nor ``repro``.
"""
from .core import (
    CheckpointSpec,
    ExecutionPolicy,
    FailurePlan,
    Frontier,
    IOStats,
    PolicyError,
    ProgramResult,
    ResidencyError,
    VertexProgram,
    WorkQueue,
    run_program,
    run_supervised,
)
from .graph.session import Graph

__all__ = [
    "CheckpointSpec",
    "ExecutionPolicy",
    "FailurePlan",
    "Frontier",
    "Graph",
    "IOStats",
    "PolicyError",
    "ProgramResult",
    "ResidencyError",
    "VertexProgram",
    "WorkQueue",
    "run_program",
    "run_supervised",
]
