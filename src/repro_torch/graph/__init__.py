"""Host-side graph containers and generators (numpy copies of ``repro.graph``).

``Graph`` here is the host CSR *container*; the session façade is
:class:`repro_torch.Graph` (``repro_torch.graph.session``), imported from
the package root so that this package stays free of the engine.
"""
from .csr import Graph, degree_order, from_edges, reverse
from .generators import cycle_graph, erdos_renyi, path_graph, rmat, star_graph

__all__ = [
    "Graph",
    "cycle_graph",
    "degree_order",
    "erdos_renyi",
    "from_edges",
    "path_graph",
    "reverse",
    "rmat",
    "star_graph",
]
