"""Mesh builders: the torch twin of the JAX package's ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims carry
the reference's axis names (``pod``, ``data``, ``model``).  Every rank runs
the same program in a process of its own, where the reference runs one
program over many devices, so a mesh needs a process group of as many
ranks as it has devices.  Functions, not module-level constants: importing
this module touches no device state and starts no process group.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["make_fake_mesh", "make_local_mesh", "make_production_mesh"]

# One-rank groups rendezvous through a file under the checkout's git-ignored
# build/ unless the caller names another.
_STORE_DIR = Path(__file__).resolve().parents[3] / "build" / "mesh"


def _mesh(device, shape: tuple, names: tuple, init_file):
    dev = resolve_device(device)
    n = 1
    for size in shape:
        n *= size
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {shape} mesh needs a process group of {n} ranks; start "
                "one on every rank (torch.distributed.init_process_group) "
                "before building it")
        path = Path(init_file) if init_file else (
            _STORE_DIR / f"pg_{os.getpid()}")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)  # a stale store would hold old keys
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{path}", rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; this process "
                           f"group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks), over a
    process group of that many ranks; raises otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, names, None)


def make_local_mesh(data: int = 1, model: int = 1, device=None, *,
                    init_file: Optional[str] = None):
    """A ``(data, model)`` mesh on the CUDA device (NCCL) unless ``device``
    says otherwise (``"cpu"``: gloo).  With no process group and one rank
    in all, it starts a one-rank group itself over a ``file://`` store at
    ``init_file`` (default: under the checkout's ``build/mesh/``), which
    opens no network listener; more ranks need the caller's group.  Raises
    without a card unless ``device`` is given."""
    return _mesh(device, (data, model), ("data", "model"), init_file)


def make_fake_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the ``fake``
    backend, as rank 0 of a world of ``prod(shape)`` ranks, in this
    process: for the dry run only (``launch/dryrun.py``), which traces one
    rank's step and records the collectives it issues.  The fake group
    moves no bytes, starts no other process and opens no listener (its
    store is an in-process stub).  Raises if a process group is already up;
    the caller tears it down with ``torch.distributed.destroy_process_group``.
    """
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the fake mesh "
                           "needs a process of its own")
    n = 1
    for size in shape:
        n *= size
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        return init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=tuple(names))
    except BaseException:
        dist.destroy_process_group()
        raise
