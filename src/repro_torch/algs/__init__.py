"""The algorithms of the port: every BSP algorithm is a
:class:`~repro_torch.core.VertexProgram` on the shared driver; triangle
counting and Louvain run on the host, as in the reference."""
from .betweenness import BCBackwardProgram, BCForwardProgram, FusedBCProgram
from .bfs import UNREACHED, BFSProgram
from .coreness import CorenessProgram
from .louvain import LouvainResult, louvain, modularity
from .pagerank import (
    PageRankPullProgram,
    PageRankPushProgram,
    PersonalizedPageRankProgram,
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
    "count_triangles",
    "louvain",
    "modularity",
    "triangles_blocked_mxu",
]
