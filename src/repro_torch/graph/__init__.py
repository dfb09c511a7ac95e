"""Host-side graph containers and generators (numpy copies of ``repro.graph``).

``Graph`` here is the host CSR *container*; the session façade is
:class:`repro_torch.Graph` (``repro_torch.graph.session``), served from this
package as :class:`GraphSession` on first use, as the reference serves it:
the session imports the engine, which imports ``.csr``, so an eager import
here would cycle when ``repro_torch.core`` initialises first.
"""
from .csr import Graph, degree_order, from_edges, reverse
from .generators import cycle_graph, erdos_renyi, path_graph, rmat, star_graph


def __getattr__(name):
    if name == "GraphSession":
        from .session import Graph as GraphSession

        return GraphSession
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "Graph",
    "GraphSession",
    "cycle_graph",
    "degree_order",
    "erdos_renyi",
    "from_edges",
    "path_graph",
    "reverse",
    "rmat",
    "star_graph",
]
