"""Blocked semiring SpMV kernels B1-B4: CUDA for Hopper, plain torch beside.

The reference streams dense ``(Bd, Bs)`` edge tiles through a sequential
Pallas grid (``repro/kernels/spmv/kernel.py``: ``spmv_pallas``, bodies
``_kernel_plus_times`` lines 86-110 and ``_kernel_min_plus`` lines 113-136,
and ``spmv_pallas_compact``, bodies ``_kernel_plus_times_compact`` lines
199-224 and ``_kernel_min_plus_compact`` lines 227-250), carrying a
``(Bd, K)`` accumulator from one grid step to the next and flushing it at
each run's end::

    plus_times: y[dst_block] (+)= tile (Bd, Bs) @ x[src_block] (Bs, K)
    min_plus:   y[dst_block] (min)= min_s(tile[:, s] + x[src_block][s, :])

On the GPU the thread blocks run in parallel and in no order, so the
kernels in ``repro_torch/csrc/spmv.cu`` give each destination block to its
own thread blocks, which walk that block's tiles in schedule order (see
the source for the design and its bound).  The two entry points differ in
their work-list:

  * :func:`spmv_blocked` (B1, B3 on min_plus tiles) — every tile of the
    schedule; each thread block reads the activity flag of each of its
    block's tiles and skips inactive ones.  The per-block tile table is
    static (``BlockedGraph.blk_ptr``/``blk_tiles``).
  * :func:`spmv_blocked_compact` (B2, B4 on min_plus tiles) — only the live
    tiles ``perm[:nact]`` of the compacted schedule, grouped by destination
    block in torch each call; run boundaries come from the recomputed
    ``first`` flags.  It also takes a :class:`TileBatch`, the batch-local
    view that host residency stages per batch.

On a CPU tensor each wrapper runs its plain torch version
(:func:`blocked_spmv_plain`, :func:`blocked_spmv_plain_compact`), which
keeps the reference's per-run summation structure: per-run sums of the
tile products, combined into the block in run order.  On a CUDA tensor it
launches the kernel or raises; ``launches`` counts kernel launches, one
key per kernel.  'bool' occupancy tiles run the plus_times kernels.

The shared library is built with ``nvcc`` at first use into
``build/kernels/`` at the repository root (git-ignored), keyed by the
source's hash, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = [
    "TileBatch",
    "blocked_spmv_plain",
    "blocked_spmv_plain_compact",
    "build_library",
    "launches",
    "reset_launches",
    "spmv_blocked",
    "spmv_blocked_compact",
]

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "spmv.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
_ROWS_PER_CTA = 32  # rows of a destination block per thread block (spmv.cu)
_MAX_K = 192  # lanes the kernel's 48 KB of shared accumulators hold
_PLAIN_CHUNK = 512  # tiles per batched product in the plain versions

#: Kernel launches since the last :func:`reset_launches`: B1, B2, B3, B4.
launches = {"spmv_blocked": 0, "spmv_blocked_compact": 0,
            "spmv_blocked_min_plus": 0, "spmv_blocked_compact_min_plus": 0}
# launch key -> the function spmv.cu exports for it
_ENTRY = {"spmv_blocked": "spmv_full",
          "spmv_blocked_compact": "spmv_compact",
          "spmv_blocked_min_plus": "spmv_full_min_plus",
          "spmv_blocked_compact_min_plus": "spmv_compact_min_plus"}

_lib = None


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


@dataclasses.dataclass(frozen=True)
class TileBatch:
    """A batch-local tile view for :func:`spmv_blocked_compact`: ``tiles``
    [G, Bd, Bs] staged for one batch and ``sbid`` [G] the global source
    block of each staged tile, so work-list entry ``i`` reads
    ``x_blocks[sbid[i]]``.  ``n`` sizes the output's destination blocks as
    in the graph's own view."""

    tiles: torch.Tensor
    sbid: torch.Tensor
    n: int
    bd: int
    bs: int
    semiring: str

    @property
    def num_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_dst_blocks(self) -> int:
        return -(-self.n // self.bd)

    @property
    def n_src_blocks(self) -> int:
        return -(-self.n // self.bs)


def build_library() -> Path:
    """Compile ``csrc/spmv.cu`` for ``sm_90a`` (once per source hash) and
    return the shared library's path.  ``nvcc``'s ``-Xptxas -v`` report is
    kept beside it as ``<lib>.log``."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libspmv_{digest}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("spmv_full", "spmv_full_min_plus"):
            getattr(lib, fn).argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
            getattr(lib, fn).restype = i
        for fn in ("spmv_compact", "spmv_compact_min_plus"):
            getattr(lib, fn).argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
            getattr(lib, fn).restype = i
        _lib = lib
    return _lib


def _on_cpu(x_blocks: torch.Tensor) -> bool:
    """True for a CPU tensor (plain path), False for CUDA (kernel path)."""
    if x_blocks.device.type == "cpu":
        return True
    if x_blocks.device.type != "cuda":
        raise ValueError(f"no blocked SpMV for device {x_blocks.device}")
    return False


def _check_cuda(bg, x_blocks: torch.Tensor) -> None:
    """Refuse what the CUDA kernel does not take (no fallback)."""
    if bg.tiles.device != x_blocks.device:
        raise ValueError("tiles and x_blocks lie on different devices")
    if bg.tiles.dtype != torch.float32 or x_blocks.dtype != torch.float32:
        raise TypeError("the blocked kernel takes float32 tiles and x")
    if not (bg.tiles.is_contiguous() and x_blocks.is_contiguous()):
        raise ValueError("the blocked kernel takes contiguous tiles and x")
    if bg.tiles.data_ptr() % 16 or x_blocks.data_ptr() % 16:
        raise ValueError("the blocked kernel takes 16-byte aligned tiles and x")
    if bg.bs % 4 or bg.bs > 128:
        raise ValueError(f"the blocked kernel needs bs % 4 == 0 and bs <= 128 "
                         f"(got bs={bg.bs})")
    k = x_blocks.shape[-1]
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"the blocked kernel takes 1..{_MAX_K} lanes, got {k}")
    if tuple(x_blocks.shape[:2]) != (bg.n_src_blocks, bg.bs):
        raise ValueError(f"x_blocks shape {tuple(x_blocks.shape)} does not "
                         f"match the tile view")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _launch(name: str, args, bg, k: int, device) -> torch.Tensor:
    if bg.semiring == "min_plus":
        name += "_min_plus"
    fn = getattr(_library(), _ENTRY[name])
    y = torch.empty((bg.n_dst_blocks, bg.bd, k), dtype=torch.float32,
                    device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(_ptr(bg.tiles), _ptr(args[0]), _ptr(y),
             *[_ptr(a) for a in args[1:]],
             bg.n_dst_blocks, bg.bd, bg.bs, k, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return y


def spmv_blocked(bg, act: torch.Tensor, x_blocks: torch.Tensor) -> torch.Tensor:
    """B1 (B3 on min_plus tiles): y_blocks [nDB, Bd, K] f32 over the full
    tile schedule.

    A block whose tiles are all inactive flushes the identity (0, or +inf
    under min_plus); a block with no tile at all is left for the caller to
    fill (``ops.blocked_spmv``).
    """
    if _on_cpu(x_blocks):
        return blocked_spmv_plain(bg, act, x_blocks)
    _check_cuda(bg, x_blocks)
    args = (x_blocks, bg.blk_ptr, bg.blk_tiles, bg.first, bg.sbid,
            act.to(torch.int32).contiguous())
    return _launch("spmv_blocked", args, bg, x_blocks.shape[-1],
                   x_blocks.device)


def spmv_blocked_compact(bg, perm, dbid, sbid, first, last, accum, nact: int,
                         x_blocks: torch.Tensor) -> torch.Tensor:
    """B2 (B4 on min_plus tiles): the same over the compacted work-list
    ``perm[:nact]`` (arguments as returned by ``ops.compact_tile_order``,
    sliced to the grid bucket).  ``bg`` is a ``BlockedGraph`` or a
    :class:`TileBatch`.  Blocks with no live tile are left for the caller
    to fill."""
    if _on_cpu(x_blocks):
        return blocked_spmv_plain_compact(bg, perm, dbid, sbid, first, last,
                                          accum, nact, x_blocks)
    _check_cuda(bg, x_blocks)
    d = dbid[:nact].long()
    order = torch.argsort(d, stable=True)
    seg_ptr = torch.zeros(bg.n_dst_blocks + 1, dtype=torch.int64,
                          device=x_blocks.device)
    seg_ptr[1:] = torch.cumsum(torch.bincount(d, minlength=bg.n_dst_blocks), 0)
    args = (x_blocks, seg_ptr.to(torch.int32),
            perm[:nact][order].to(torch.int32).contiguous(),
            first[:nact][order].to(torch.int32).contiguous(), bg.sbid)
    return _launch("spmv_blocked_compact", args, bg, x_blocks.shape[-1],
                   x_blocks.device)


def _runs_into_blocks(bg, ids, runs, run_db, x_blocks) -> torch.Tensor:
    """Plain core: sum each listed tile's product into its run (in list
    order), then combine the runs into their blocks in run order."""
    k = x_blocks.shape[-1]
    minp = bg.semiring == "min_plus"
    fill = float("inf") if minp else 0.0
    acc = torch.full((run_db.numel(), bg.bd, k), fill, dtype=torch.float32,
                     device=x_blocks.device)
    for s in range(0, ids.numel(), _PLAIN_CHUNK):
        i = ids[s:s + _PLAIN_CHUNK].long()
        r = runs[s:s + _PLAIN_CHUNK].long()
        xin = x_blocks[bg.sbid[i].long()]  # [c, Bs, K]
        tiles = bg.tiles[i]  # [c, Bd, Bs]
        if minp:
            cand = (tiles[:, :, :, None] + xin[:, None, :, :]).amin(dim=2)
            acc.scatter_reduce_(0, r[:, None, None].expand_as(cand), cand,
                                "amin", include_self=True)
        else:
            acc.index_add_(0, r, torch.bmm(tiles, xin))
    y = torch.full((bg.n_dst_blocks, bg.bd, k), fill, dtype=torch.float32,
                   device=x_blocks.device)
    rdb = run_db.long()
    if minp:
        y.scatter_reduce_(0, rdb[:, None, None].expand_as(acc), acc, "amin",
                          include_self=True)
    else:
        y.index_add_(0, rdb, acc)
    return y


def blocked_spmv_plain(bg, act: torch.Tensor,
                       x_blocks: torch.Tensor) -> torch.Tensor:
    """Plain torch version of B1 (and of B3 on min_plus tiles)."""
    runs = torch.cumsum(bg.first.long(), 0) - 1
    ids = torch.nonzero(act).flatten()
    return _runs_into_blocks(bg, ids, runs[ids], bg.dbid[bg.first == 1],
                             x_blocks)


def blocked_spmv_plain_compact(bg, perm, dbid, sbid, first, last, accum,
                               nact: int, x_blocks: torch.Tensor
                               ) -> torch.Tensor:
    """Plain torch version of B2 (and of B4 on min_plus tiles)."""
    f = first[:nact].long()
    runs = torch.cumsum(f, 0) - 1
    return _runs_into_blocks(bg, perm[:nact], runs, dbid[:nact][f == 1],
                             x_blocks)
