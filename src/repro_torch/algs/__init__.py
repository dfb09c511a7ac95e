"""The algorithms of the port: every BSP algorithm is a
:class:`~repro_torch.core.VertexProgram` on the shared driver; triangle
counting and Louvain run on the host, as in the reference.  The bare
functions (``bfs_multi``, ``pagerank_push``, ...) are deprecated shims
kept for compatibility; new code goes through the ``repro_torch.Graph``
façade (or ``run_program`` for custom programs)."""
from .betweenness import (
    BCBackwardProgram,
    BCForwardProgram,
    FusedBCProgram,
    bc_fused,
    bc_multisource,
    bc_unisource,
)
from .bfs import UNREACHED, BFSProgram, bfs_multi, bfs_uni
from .coreness import CorenessProgram, coreness
from .diameter import diameter_multisource, diameter_unisource
from .louvain import LouvainResult, louvain, modularity
from .pagerank import (
    PageRankPullProgram,
    PageRankPushProgram,
    PersonalizedPageRankProgram,
    pagerank_inmem,
    pagerank_pull,
    pagerank_push,
)
from .triangles import TriangleResult, count_triangles, triangles_blocked_mxu

__all__ = [
    "UNREACHED",
    "BCBackwardProgram",
    "BCForwardProgram",
    "BFSProgram",
    "CorenessProgram",
    "FusedBCProgram",
    "LouvainResult",
    "PageRankPullProgram",
    "PageRankPushProgram",
    "PersonalizedPageRankProgram",
    "TriangleResult",
    "bc_fused",
    "bc_multisource",
    "bc_unisource",
    "bfs_multi",
    "bfs_uni",
    "coreness",
    "count_triangles",
    "diameter_multisource",
    "diameter_unisource",
    "louvain",
    "modularity",
    "pagerank_inmem",
    "pagerank_pull",
    "pagerank_push",
    "triangles_blocked_mxu",
]
