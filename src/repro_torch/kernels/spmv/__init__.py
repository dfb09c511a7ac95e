from .kernel import (
    blocked_spmv_plain,
    blocked_spmv_plain_compact,
    launches,
    reset_launches,
    spmv_blocked,
    spmv_blocked_compact,
)
from .ops import (
    BlockedGraph,
    TILE_ORDERS,
    blocked_graph,
    blocked_spmv,
    build_blocked,
    build_blocked_arrays,
    compact_grid_size,
    compact_tile_order,
    tile_activity,
    tile_byte_size,
    x_fetch_count,
)
from .order import curve_bits, hilbert_key, morton_key, tile_curve_key
from .ref import blocked_spmv_ref

__all__ = [
    "BlockedGraph",
    "TILE_ORDERS",
    "blocked_graph",
    "blocked_spmv",
    "blocked_spmv_plain",
    "blocked_spmv_plain_compact",
    "blocked_spmv_ref",
    "build_blocked",
    "build_blocked_arrays",
    "compact_grid_size",
    "compact_tile_order",
    "curve_bits",
    "hilbert_key",
    "launches",
    "morton_key",
    "reset_launches",
    "spmv_blocked",
    "spmv_blocked_compact",
    "tile_activity",
    "tile_byte_size",
    "tile_curve_key",
    "x_fetch_count",
]
