"""Recording machinery: source attribution, host reads, forward taint.

The reference walks the jaxpr of its traced superstep.  The port has no
jaxpr: its superstep is eager torch, and the engine's dispatch reads the
device every superstep, so no whole-body trace exists.  :class:`Recorder`
stands in for the walk.  It runs program hooks under two torch modes at
once:

* a :class:`~torch.overrides.TorchFunctionMode` that sees the
  Python-level host reads: ``item``, ``tolist``, ``numpy``,
  ``__array__`` (so ``np.asarray`` of a tensor), ``__bool__``,
  ``__int__``, ``__float__``, ``__index__``, ``.cpu()``, ``.to('cpu')``,
  indexing with a boolean mask, and synchronous host-to-device copies
  (``torch.tensor(..., device='cuda')``, ``.to('cuda')``/``.cuda()`` of
  a CPU tensor), which the card's sync debug mode also reports;
* a :class:`~torch.utils._python_dispatch.TorchDispatchMode` that sees
  every aten op.  It records ops whose output shape depends on the data
  (``nonzero``, ``masked_select``, boolean-mask indexing, ``unique``,
  ``repeat_interleave`` without ``output_size``: implicit syncs on the
  card, trace failures in JAX) and scalar reads (``_local_scalar_dense``,
  ``equal``) as host syncs; it records each op output with a dimension
  equal to a watched size (``m``, for rule R1) on the watched device;
  and it propagates *taint* forward, tensor by tensor, the counterpart of
  the reference's ``taint_jaxpr``: an op's outputs, and every argument
  it writes (``index_add_``, ``copy_``, ``out=``), are tainted when any
  of its tensor inputs is.

Every event carries its innermost user frame (:func:`user_location`).
Frames inside the engine (``repro_torch/core``, ``repro_torch/kernels``)
are library code, as the reference exempts ``repro/core`` and
``repro/kernels``: an event whose innermost frame is there is not the
user's (:func:`frame_is_engine`).  ``repro_torch/algs`` is not exempt.

The CUDA kernels (B1–B5) launch through ``ctypes``.  Neither mode sees a
launch, and no taint crosses one: a kernel's output tensor is allocated by
an op the modes see and then written by the kernel.  No rule needs that
edge.  R4's taint starts at the ``IOStats`` fields the engine builds, not
at the SpMV result ``y``, and R6's reaches ``converged`` through the
program's own ops.  Which kernels ran inside a recorded superstep is read
from the kernels' launch counters instead (:func:`kernel_launches`).
"""
from __future__ import annotations

import contextlib
import os
import sys
import sysconfig
import weakref
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = [
    "Event",
    "Recorder",
    "frame_is_engine",
    "kernel_launches",
    "leaves_with_paths",
    "location_from_exception",
    "user_location",
]

# Source files owned by the engine and kernels: events whose innermost
# user frame lands here are library code, exempt from the user-hook rules.
_ENGINE_PARTS = ("repro_torch/core/", "repro_torch/kernels/",
                 "repro_torch\\core\\", "repro_torch\\kernels\\")
_NOISE_PARTS = ("repro_torch/analysis/", "repro_torch\\analysis\\",
                "site-packages", "<frozen")
_NOISE_DIRS = tuple(os.path.dirname(mod.__file__) + os.sep
                    for mod in (torch, np)) \
    + (sysconfig.get_paths()["stdlib"] + os.sep,)


def frame_is_engine(file_name: str) -> bool:
    return any(p in file_name for p in _ENGINE_PARTS)


def _is_noise(file_name: str) -> bool:
    return (any(p in file_name for p in _NOISE_PARTS)
            or file_name.startswith(_NOISE_DIRS))


def user_location(frame=None) -> Optional[Tuple[str, int, str]]:
    """``(file, line, function)`` of the innermost frame outside torch,
    numpy, the standard library and this package, from ``frame`` (default:
    the caller) outwards, or None when there is none."""
    f = frame if frame is not None else sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if not _is_noise(name):
            return name, f.f_lineno, f.f_code.co_name
        f = f.f_back
    return None


def location_from_exception(exc: BaseException) -> str:
    """Innermost non-library frame of an exception's traceback, as
    ``file:line`` (the offending hook line of a failed fake run)."""
    tb, best = exc.__traceback__, ""
    while tb is not None:
        fname = tb.tb_frame.f_code.co_filename
        if not _is_noise(fname):
            best = f"{fname}:{tb.tb_lineno}"
        tb = tb.tb_next
    return best


def leaves_with_paths(tree, path: str = "") -> List[Tuple[str, object]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order and key
    notation (NamedTuple fields ``.f``, sequence items ``[i]``, dict keys
    ``['k']`` sorted; ``None`` holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, c in zip(tree._fields, tree)
                for kv in leaves_with_paths(c, f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, c in enumerate(tree)
                for kv in leaves_with_paths(c, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def kernel_launches() -> dict:
    """The SpMV kernels' launch counters (B1–B4), copied."""
    from ..kernels.spmv import kernel

    return dict(kernel.launches)


class Event(NamedTuple):
    """One recorded happening in a user frame: ``kind`` is ``'sync'`` (a
    host read or an op with a data-dependent output shape) or ``'om'`` (an
    output with an O(m) dimension on the watched device)."""

    kind: str
    what: str
    hook: Optional[str]
    location: str


_T = torch.Tensor
_HOST_READS = {
    _T.item: "item()", _T.tolist: "tolist()", _T.numpy: "numpy()",
    _T.__array__: "np.asarray()", _T.__bool__: "bool()",
    _T.__int__: "int()", _T.__float__: "float()", _T.__index__: "index()",
    _T.cpu: "cpu()",
}
_aten = torch.ops.aten
_SCALAR_READS = {_aten._local_scalar_dense.default: "a scalar read",
                 _aten.equal.default: "torch.equal()"}
_DATA_DEPENDENT = {
    _aten.nonzero.default: "nonzero",
    _aten.masked_select.default: "masked_select",
    _aten._unique.default: "unique",
    _aten._unique2.default: "unique",
    _aten.unique_dim.default: "unique",
    _aten.unique_consecutive.default: "unique_consecutive",
}
_REPEAT = (_aten.repeat_interleave.Tensor, _aten.repeat_interleave.self_Tensor)
_MASK_INDEXED = (_aten.index.Tensor, _aten.index_put.default,
                 _aten.index_put_.default)


def _is_mask(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype in (torch.bool,
                                                       torch.uint8)


def _mask_index(index) -> bool:
    items = index if isinstance(index, (tuple, list)) else (index,)
    return any(_is_mask(i) for i in items)


def _target(args, kwargs) -> Optional[str]:
    """The device type a ``Tensor.to`` call names, if any."""
    for a in list(args[1:]) + [kwargs.get("device")]:
        if isinstance(a, (str, torch.device)):
            return torch.device(a).type
    return None


def _copy_what(func, args, kwargs) -> Optional[str]:
    """A host read (a copy to the CPU) or a synchronous host-to-device
    copy (from pageable memory) that ``func`` makes, if any."""
    if func is _T.to:
        src, dst = args[0].device.type, _target(args, kwargs)
    elif func is _T.cuda:
        src, dst = args[0].device.type, "cuda"
    elif func in (torch.tensor, torch.as_tensor):
        data = args[0] if args else kwargs.get("data")
        dev = kwargs.get("device")
        if dev is None or isinstance(data, torch.Tensor) and data.is_cuda:
            return None
        src, dst = "cpu", torch.device(dev).type
    else:
        return None
    if dst == "cpu" and func is _T.to:  # as .cpu(): a read on the card
        return "to('cpu')"
    if src == "cpu" and dst == "cuda" and not kwargs.get("non_blocking"):
        return "a host-to-device copy from pageable memory"
    return None


class _FunctionLayer(TorchFunctionMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        what = _HOST_READS.get(func) or _copy_what(func, args, kwargs)
        if what is None and func in (_T.__getitem__, _T.__setitem__) \
                and len(args) > 1 and _mask_index(args[1]):
            what = "boolean-mask indexing"
        if what is not None:
            self.rec.sync(what)
        return func(*args, **kwargs)


class _DispatchLayer(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        what = _SCALAR_READS.get(func) or _DATA_DEPENDENT.get(func)
        if what is None and func in _REPEAT \
                and kwargs.get("output_size") is None:
            what = "repeat_interleave without output_size"
        if what is None and func in _MASK_INDEXED and _mask_index(args[1]):
            what = "boolean-mask indexing"
        if what is not None:
            rec.sync(what)
        out = func(*args, **kwargs)
        if rec.tainting():
            if any(rec.tainted(t) for t in tree_leaves((args, kwargs))):
                for t in tree_leaves(out):
                    rec.taint(t)
                for i, a in enumerate(func._schema.arguments):
                    if a.alias_info is not None and a.alias_info.is_write:
                        v = args[i] if i < len(args) else kwargs.get(a.name)
                        for t in tree_leaves(v):
                            rec.taint(t)
        if rec.m is not None:
            rec.check_sizes(func, out)
        return out


class Recorder:
    """Runs hooks under the two recording modes (see the module
    docstring) and keeps what they saw.

    ``m`` and ``device``: an op output with a dimension equal to ``m`` on
    ``device`` in a user frame is an ``'om'`` event (None: not watched).
    ``events`` holds one :class:`Event` per distinct (kind, location)
    outside the engine; :meth:`hook` names the hook events belong to."""

    def __init__(self, *, m: Optional[int] = None, device=None):
        self.m = m
        self.device_type = torch.device(device).type if device else None
        self.events: List[Event] = []
        self._seen: set = set()
        self._hook: Optional[str] = None
        self._taint: dict = {}  # id(tensor) -> weakref (ids are reused)

    # ----------------------------------------------------------- events
    def _event(self, kind: str, what: str) -> None:
        loc = user_location(sys._getframe(1))
        if loc is None or frame_is_engine(loc[0]):
            return
        where = f"{loc[0]}:{loc[1]}"
        if (kind, where) not in self._seen:
            self._seen.add((kind, where))
            self.events.append(Event(kind, what, self._hook, where))

    def sync(self, what: str) -> None:
        self._event("sync", what)

    def sync_at(self, what: str, location: str, hook: str) -> None:
        """A host sync in ``hook`` known only from an exception's
        traceback."""
        if ("sync", location) not in self._seen:
            self._seen.add(("sync", location))
            self.events.append(Event("sync", what, hook, location))

    def check_sizes(self, func, out) -> None:
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and t.device.type == self.device_type
                    and any(int(d) == self.m for d in t.shape)):
                self._event("om", f"{str(t.dtype).removeprefix('torch.')}"
                                  f"{list(t.shape)} by '{func.__name__}'")

    def hook_events(self, kind: str, hooks) -> List[Event]:
        return [e for e in self.events if e.kind == kind and e.hook in hooks]

    # ------------------------------------------------------------ taint
    def tainting(self) -> bool:
        return bool(self._taint)

    def taint(self, t) -> None:
        if isinstance(t, torch.Tensor):
            self._taint[id(t)] = weakref.ref(t)

    def tainted(self, t) -> bool:
        if not isinstance(t, torch.Tensor):
            return False
        for x in (t, t._base):
            r = self._taint.get(id(x)) if x is not None else None
            if r is not None and r() is x:
                return True
        return False

    def clear_taint(self) -> None:
        self._taint.clear()

    # --------------------------------------------------------- running
    @contextlib.contextmanager
    def hook(self, name: str):
        """Record what runs inside the block as hook ``name``."""
        prev, self._hook = self._hook, name
        try:
            with _FunctionLayer(self), _DispatchLayer(self):
                yield
        finally:
            self._hook = prev
