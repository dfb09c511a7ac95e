"""B5: the CUDA decode-attention kernel's build, binding and wrapper.

The kernel (``repro_torch/csrc/decode_attn.cu``) replaces the Pallas TPU
kernel ``repro/kernels/decode_attn/kernel.py`` (``_kernel``, line 44,
launched by ``decode_attn_pallas``); see the source for its design and
bound.  It is built with ``nvcc`` for ``sm_90a`` at first use into the
git-ignored ``build/kernels/`` (:mod:`repro_torch.kernels.build`) and loaded
with ``ctypes``.  :func:`decode_attn_cuda` launches it on CUDA tensors only:
the CPU path is the plain version in ``ref.py``, chosen by
``ops.decode_attention``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import build

__all__ = ["build_library", "decode_attn_cuda", "launches", "reset_launches"]

#: Kernel launches since the last :func:`reset_launches` (one per call: the
#: split pass and its merge).
launches = {"decode_attention": 0}

_MAX_G = 16  # query heads per KV head the kernel holds (decode_attn.cu)
_MAX_HD = 256  # head_dim: 8 columns a lane
_TARGET_CTAS = 8 * 132  # thread blocks to aim for: a few waves of 132 SMs
_ENTRY = {torch.bfloat16: "decode_attn_bf16", torch.float32: "decode_attn_f32"}
# decode_attn.cu's DECODE_ATTN_ARGS: 9 pointers (q, k, v, pos, cur, the three
# partials, out), 8 ints (B, T, KV, G, hd, block_t, splits, window), the
# scale, the stream
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])

_lib = None


def reset_launches() -> None:
    launches["decode_attention"] = 0


def build_library() -> Path:
    """Compile ``csrc/decode_attn.cu`` for ``sm_90a`` (once per source
    hash) and return the shared library's path."""
    return build.build_library("decode_attn")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for fn in _ENTRY.values():
            getattr(lib, fn).argtypes = _ARGTYPES
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def split_count(b: int, kv: int, n_blocks: int) -> int:
    """Thread blocks that share the ``n_blocks`` cache blocks of each (row,
    KV head), so that the grid holds about ``_TARGET_CTAS`` of them; split
    ``s`` takes blocks ``s, s + n, s + 2n, ...``."""
    return max(1, min(n_blocks, math.ceil(_TARGET_CTAS / (b * kv))))


def _check(qg, k, v, pos, cur, block_t: int) -> None:
    """Refuse what the kernel does not take (no fallback)."""
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"the decode-attention kernel runs on CUDA, got {dev}")
    for name, t in (("k", k), ("v", v), ("pos", pos), ("cur", cur)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"the decode-attention kernel takes a "
                             f"contiguous {name}")
    if not qg.is_contiguous():
        raise ValueError("the decode-attention kernel takes a contiguous q")
    if qg.dtype not in _ENTRY or k.dtype != qg.dtype or v.dtype != qg.dtype:
        raise TypeError(f"q, k, v must share bfloat16 or float32, got "
                        f"{qg.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32 or cur.dtype != torch.int32:
        raise TypeError("pos and cur must be int32")
    b, kv, g, hd = qg.shape
    t = k.shape[1]
    if tuple(k.shape) != (b, t, kv, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(qg.shape)}")
    if tuple(pos.shape) != (b, t) or tuple(cur.shape) != (b,):
        raise ValueError(f"pos {tuple(pos.shape)} / cur {tuple(cur.shape)} "
                         f"do not match [B={b}, T={t}]")
    vec = 16 // qg.element_size()  # elements of one 16-byte load
    if not 1 <= g <= _MAX_G or not 1 <= hd <= _MAX_HD or hd % vec:
        raise ValueError(f"the kernel takes 1..{_MAX_G} query heads per KV "
                         f"head and a head_dim of 1..{_MAX_HD} in multiples "
                         f"of {vec}, got G={g}, hd={hd}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the decode-attention kernel takes 16-byte aligned "
                         "k and v")
    if block_t < 1 or t % block_t:
        raise ValueError(f"block_t={block_t} does not divide T={t}")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def decode_attn_cuda(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, cur: torch.Tensor, *, window: int,
                     block_t: int) -> torch.Tensor:
    """Launch B5: ``qg`` [B, KV, G, hd], ``k``/``v`` [B, T, KV, hd] (bf16 or
    f32), ``pos`` [B, T] and ``cur`` [B] int32 on one CUDA device.  Returns
    [B, KV, G, hd] f32; raises on what the kernel does not take or when the
    launch fails."""
    _check(qg, k, v, pos, cur, block_t)
    b, kv, g, hd = qg.shape
    t = k.shape[1]
    nsplit = split_count(b, kv, t // block_t)
    f32 = dict(dtype=torch.float32, device=qg.device)
    m_part = torch.empty((b, kv, nsplit, g), **f32)
    l_part = torch.empty((b, kv, nsplit, g), **f32)
    acc_part = torch.empty((b, kv, nsplit, g, hd), **f32)
    out = torch.empty((b, kv, g, hd), **f32)
    stream = torch.cuda.current_stream(qg.device).cuda_stream
    fn = getattr(_library(), _ENTRY[qg.dtype])
    err = fn(_ptr(qg), _ptr(k), _ptr(v), _ptr(pos), _ptr(cur), _ptr(m_part),
             _ptr(l_part), _ptr(acc_part), _ptr(out), b, t, kv, g, hd,
             block_t, nsplit, int(window), hd**-0.5,
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"decode-attention kernel launch failed: CUDA "
                           f"error {err}")
    launches["decode_attention"] += 1
    return out
