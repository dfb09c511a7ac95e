"""B5: the CUDA decode-attention kernel's build, binding and wrapper.

The kernel (``repro_torch/csrc/decode_attn.cu``) replaces the Pallas TPU
kernel ``repro/kernels/decode_attn/kernel.py`` (``_kernel``, line 44,
launched by ``decode_attn_pallas``); see the source for its design and
bound.  It is built with ``nvcc`` for ``sm_90a`` at first use into the
git-ignored ``build/kernels/`` (:mod:`repro_torch.kernels.build`) and loaded
with ``ctypes``.  :func:`decode_attn_cuda` launches it on CUDA tensors only:
the CPU path is the plain version in ``ref.py``, chosen by
``ops.decode_attention``.

:func:`decode_attn_op` is the launch as the operator
``torch.ops.repro_torch.decode_attn``, so that dispatch modes see it: its
CUDA implementation is :func:`decode_attn_cuda`, its fake implementation
(meta and fake tensors) returns the output's shape, and its FLOP formula
counts the q.k and p.v products over every cache slot (``FlopCounterMode``
reads it).  It has no CPU implementation: a CPU tensor raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import build

__all__ = ["build_library", "decode_attn_cuda", "decode_attn_op", "launches",
           "reset_launches"]

#: Kernel launches since the last :func:`reset_launches` (one per call).
launches = {"decode_attention": 0}

_MAX_G = 16  # query heads per KV head the kernel holds (decode_attn.cu)
_MAX_HD = 256  # head_dim the kernels' registers are sized for
_STAGE = 16  # cache slots a stage of the bf16 kernel's ring holds (kStage)
_MIN_CHUNKS = 4  # work units a split takes at least: its fill and merge cost
_MAX_SPLIT = 32  # splits the bf16 kernel's merge stages in shared memory
_F32_CTAS_PER_SM = 8  # thread blocks to aim at per SM for the f32 body
_ENTRY = {torch.bfloat16: "decode_attn_bf16", torch.float32: "decode_attn_f32"}
# decode_attn.cu's DECODE_ATTN_ARGS: 9 pointers (the tensor maps, q, k, v,
# pos, cur, the workspace, the tickets, out), 8 ints (B, T, KV, G, hd,
# block_t, splits, window), the scale, the stream
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
_MAPS_BYTES = 256  # two CUtensorMap

_lib = None
_slots: dict = {}  # (device index, hd) -> thread blocks the card holds
_workspaces: dict = {}  # (device, stream, shape, splits) -> (work, tickets)
_maps: dict = {}  # (k, v addresses, shape) -> the tensor maps of k and v


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
        lib.decode_attn_bf16_ctas_per_sm.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.decode_attn_bf16_ctas_per_sm.restype = ctypes.c_int
        lib.decode_attn_bf16_maps.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.decode_attn_bf16_maps.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_count(rows: int, units: int, slots: int) -> int:
    """Thread blocks that share the ``units`` work units (the bf16 kernel's
    16-slot chunks, or the f32 body's cache blocks) of each of ``rows``
    (row, KV head) pairs, when the card runs ``slots`` thread blocks at once
    (SMs times the blocks an SM holds); split ``s`` takes units ``s, s + n,
    s + 2n, ...``.

    At most one wave (``rows * n <= slots``; one split once the rows fill
    the card), at least :data:`_MIN_CHUNKS` units a split, at most
    :data:`_MAX_SPLIT` splits, and then as few splits as give every split
    the same whole number of units."""
    n = max(1, min(units, slots // rows, -(-units // _MIN_CHUNKS),
                   _MAX_SPLIT))
    return -(-units // -(-units // n))


def _card_slots(dev: torch.device, hd: int) -> int:
    """SMs times the bf16 kernel's thread blocks an SM holds at ``hd``
    (asked of the CUDA runtime once per device and head_dim, which also
    sets the kernel's shared memory limit)."""
    key = (dev.index, hd)
    if key not in _slots:
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _library().decode_attn_bf16_ctas_per_sm(hd, ctypes.byref(n))
        if err != 0 or n.value < 1:
            raise RuntimeError(f"decode-attention kernel cannot be resident "
                               f"at head_dim {hd}: CUDA error {err}, "
                               f"{n.value} blocks an SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _slots[key] = sms * n.value
    return _slots[key]


def _workspace(dev, stream: int, b: int, kv: int, g: int, hd: int,
               nsplit: int):
    """The partials and tickets of one shape, made once (tickets zeroed;
    the kernel leaves them at 0) and kept, so a call allocates only its
    output and stays capturable in a CUDA graph.  Keyed by stream: calls on
    one stream run in order."""
    key = (dev.index, stream, b, kv, g, hd, nsplit)
    ws = _workspaces.get(key)
    if ws is None:
        rows = b * kv * nsplit * g
        ws = (torch.empty(rows * (hd + 2), dtype=torch.float32, device=dev),
              torch.zeros(b * kv, dtype=torch.int32, device=dev))
        _workspaces[key] = ws
    return ws


def _tensor_maps(k: torch.Tensor, v: torch.Tensor):
    """The TMA tensor maps of a bf16 cache's k and v, encoded on the host
    once per (address, shape) and kept: a serve loop's layers keep their
    caches, so its steps encode nothing."""
    b, t, kv, hd = k.shape
    key = (k.data_ptr(), v.data_ptr(), b, t, kv, hd)
    maps = _maps.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(_MAPS_BYTES)
        err = _library().decode_attn_bf16_maps(_ptr(k), _ptr(v), b, t, kv,
                                               hd, maps)
        if err != 0:
            raise RuntimeError(f"decode-attention tensor maps failed: error "
                               f"{err}")
        if len(_maps) >= 1024:
            _maps.clear()
        _maps[key] = maps
    return maps


def _check(qg, k, v, pos, cur, block_t: int) -> None:
    """Refuse what the kernel does not take (no fallback)."""
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"the decode-attention kernel runs on CUDA, got {dev}")
    _check_shapes(qg, k, v, pos, cur, block_t)
    for name, t in (("q", qg), ("k", k), ("v", v), ("pos", pos),
                    ("cur", cur)):
        if not t.is_contiguous():
            raise ValueError(f"the decode-attention kernel takes a "
                             f"contiguous {name}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the decode-attention kernel takes 16-byte aligned "
                         "k and v")


def _check_shapes(qg, k, v, pos, cur, block_t: int) -> None:
    """What the kernel takes that a tensor's metadata shows: devices,
    dtypes, shapes, the head grouping and the cache block."""
    dev = qg.device
    for name, t in (("k", k), ("v", v), ("pos", pos), ("cur", cur)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, q on {dev}")
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
    # bf16: 16-column mma steps; f32: 16-byte loads
    step = 16 if qg.dtype == torch.bfloat16 else 4
    if not 1 <= g <= _MAX_G or not 1 <= hd <= _MAX_HD or hd % step:
        raise ValueError(f"the kernel takes 1..{_MAX_G} query heads per KV "
                         f"head and a head_dim of 1..{_MAX_HD} in multiples "
                         f"of {step}, got G={g}, hd={hd}")
    if block_t < 1 or t % block_t:
        raise ValueError(f"block_t={block_t} does not divide T={t}")


def _ptr(t):
    """A tensor's address as ctypes passes it to a ``void *`` (None: NULL)."""
    return None if t is None else t.data_ptr()


def decode_attn_cuda(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, cur: torch.Tensor, *, window: int,
                     block_t: int) -> torch.Tensor:
    """Launch B5: ``qg`` [B, KV, G, hd], ``k``/``v`` [B, T, KV, hd] (bf16 or
    f32), ``pos`` [B, T] and ``cur`` [B] int32 on one CUDA device.  Returns
    [B, KV, G, hd] f32; raises on what the kernel does not take or when the
    launch fails.  Neither synchronises nor reads the device, so a call can
    be captured in a CUDA graph (after one call of its shape outside)."""
    _check(qg, k, v, pos, cur, block_t)
    b, kv, g, hd = qg.shape
    t = k.shape[1]
    dev = qg.device
    n_blocks = t // block_t
    if qg.dtype == torch.bfloat16:
        units = n_blocks * -(-block_t // _STAGE)
        slots = _card_slots(dev, hd)
    else:
        units = n_blocks
        slots = _F32_CTAS_PER_SM * torch.cuda.get_device_properties(
            dev).multi_processor_count
    nsplit = split_count(b * kv, units, slots)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = tickets = maps = None
    if nsplit > 1 or qg.dtype == torch.float32:
        work, tickets = _workspace(dev, stream, b, kv, g, hd, nsplit)
    if qg.dtype == torch.bfloat16:
        maps = _tensor_maps(k, v)
    out = torch.empty((b, kv, g, hd), dtype=torch.float32, device=dev)
    fn = getattr(_library(), _ENTRY[qg.dtype])
    err = fn(maps, _ptr(qg), _ptr(k), _ptr(v), _ptr(pos), _ptr(cur),
             _ptr(work), _ptr(tickets), _ptr(out), b, t, kv, g, hd, block_t,
             nsplit, int(window), hd**-0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode-attention kernel launch failed: CUDA "
                           f"error {err}")
    launches["decode_attention"] += 1
    return out


# The operator is defined with ``torch.library.Library`` rather than the
# ``torch.library.custom_op`` decorator: the decorator's Python wrapper added
# ~20 us of host time a call, the plain registration ~5 (a CPU stand-in
# body, 20,000 calls), and the decode loop is host-bound.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("decode_attn(Tensor qg, Tensor k, Tensor v, Tensor pos, "
            "Tensor cur, int window, int block_t) -> Tensor")


def _decode_attn_impl(qg, k, v, pos, cur, window, block_t):
    return decode_attn_cuda(qg, k, v, pos, cur, window=window,
                            block_t=block_t)


_LIB.impl("decode_attn", _decode_attn_impl, "CUDA")


@torch.library.register_fake("repro_torch::decode_attn", lib=_LIB)
def _decode_attn_fake(qg, k, v, pos, cur, window, block_t):
    _check_shapes(qg, k, v, pos, cur, block_t)
    return qg.new_empty(qg.shape, dtype=torch.float32)


#: B5 as an operator: :func:`decode_attn_cuda` on CUDA tensors, the
#: output's shape on meta and fake ones; no other device has a kernel.
decode_attn_op = torch.ops.repro_torch.decode_attn.default


@register_flop_formula(torch.ops.repro_torch.decode_attn)
def _decode_attn_flops(qg_shape, k_shape, *args, **kwargs) -> int:
    """q.k and p.v over every one of the T cache slots: 2 B H T hd each
    (the kernel reads only the live slots' pieces; the count, like the
    reference's, does not depend on the data)."""
    b, kv, g, hd = qg_shape
    return 2 * 2 * b * kv * g * k_shape[1] * hd
