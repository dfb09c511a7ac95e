"""The algorithms of the port (slice 1: PageRank push/pull and BFS)."""
from .bfs import UNREACHED, BFSProgram
from .pagerank import PageRankPullProgram, PageRankPushProgram

__all__ = ["BFSProgram", "PageRankPullProgram", "PageRankPushProgram",
           "UNREACHED"]
