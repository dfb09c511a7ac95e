"""Logical-axis -> mesh sharding rules (DP/FSDP/TP/EP/SP): the torch twin
of the JAX package's ``repro/distributed/sharding.py``.

Parallelism map (the reference's):
  * batch            -> ('pod', 'data')   pure DP across pods, DP within
  * weight 'embed'   -> 'data'            FSDP (ZeRO-3)
  * 'vocab'/'heads'/'kv'/'ffn'/'inner'  -> 'model'   tensor parallel
  * 'experts'        -> 'model'           expert parallel (all-to-all)
  * decode KV cache  -> batch over 'data' when divisible, else sequence
                        over 'data' (sequence parallelism for long_500k)

Any weight dim not divisible by its mesh axis falls back to replication on
that axis.

A :class:`PartitionSpec` keeps the reference's per-dim entries (``None``,
an axis name, or a tuple of names), so a plan can be held against the
reference's entry for entry.  The plan functions read only a mesh's dim
names and sizes: they take a ``DeviceMesh`` or a :class:`MeshShape` (the
counterpart of ``jax.sharding.AbstractMesh``), so a plan for (16, 16) can
be made on one card.  ``param_shardings`` turns each spec into ``DTensor``
placements (``Shard(dim)`` / ``Replicate()`` per mesh dim).
"""
from __future__ import annotations

import torch

__all__ = [
    "LOGICAL_RULES",
    "MeshShape",
    "NamedSharding",
    "PartitionSpec",
    "batch_pspec",
    "cache_pspecs",
    "constrain",
    "data_axes",
    "param_pspecs",
    "param_shardings",
]

LOGICAL_RULES = {
    "vocab": "model",
    "ffn": "model",
    "heads": "model",
    "kv": "model",
    "experts": "model",
    "inner": "model",
    "embed": "data",  # FSDP
    "layers": None,
}


class PartitionSpec(tuple):
    """Per-dim mesh entries of one tensor, as ``jax.sharding.PartitionSpec``
    holds them: ``None``, an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape:
    """A mesh's axis names and sizes, with no devices: what the plan
    functions read (``jax.sharding.AbstractMesh((16, 16), ('data',
    'model'))`` in the reference)."""

    def __init__(self, sizes, names):
        if len(sizes) != len(names):
            raise ValueError((sizes, names))
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))

    def __repr__(self) -> str:
        return f"MeshShape({tuple(self.shape.values())}, {self.axis_names})"


def _axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`,
    in mesh order."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    axes = _axes(mesh)
    size = 1
    for a in (name if isinstance(name, tuple) else (name,)):
        size *= axes[a]
    return size


def _entry(names: tuple):
    """One spec entry for a group of axis names: None, a name or a tuple."""
    if not names:
        return None
    return names if len(names) > 1 else names[0]


def data_axes(mesh) -> tuple:
    """The batch/FSDP mesh axes: ('pod','data') on multi-pod, ('data',)."""
    return tuple(a for a in ("pod", "data") if a in _axes(mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) and all(
        isinstance(a, (str, type(None))) for a in x)


def _map(fn, tree, *rest, is_leaf=lambda x: False):
    """``fn`` over the leaves of nested dicts, tuples and NamedTuples (the
    first tree's structure; the others run in lockstep)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (tuple, list)):
        kids = [_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def _spec_for(axes: tuple, shape: tuple, mesh, fsdp_axes: tuple,
              moe_2d_axes: tuple = ()) -> PartitionSpec:
    """One parameter's logical axes -> a spec, with the divisibility
    fallback.  'embed' FSDP-shards over ``fsdp_axes`` unless taken;
    ``moe_2d_axes``: an expert tensor's 'ffn' dim shards over these (data)
    axes once 'model' is taken (the serving layout: experts x model, ffn x
    data)."""
    entries = []
    used = set()
    mesh_axes = _axes(mesh)  # an axis the mesh lacks replicates
    is_expert = "experts" in axes
    for dim, ax in zip(shape, axes):
        rule = LOGICAL_RULES.get(ax) if ax else None
        if ax == "embed":
            rule = _entry(fsdp_axes)
        if ax == "ffn" and is_expert and moe_2d_axes and "model" in used:
            rule = _entry(moe_2d_axes)
        if rule is None:
            entries.append(None)
            continue
        names = rule if isinstance(rule, tuple) else (rule,)
        if (any(n in used or n not in mesh_axes for n in names)
                or dim % _axis_size(mesh, rule)):
            entries.append(None)
            continue
        used.update(names)
        entries.append(rule)
    return P(*entries)


def param_pspecs(axes_tree, shapes_tree, mesh, *, fsdp: bool = True,
                 moe_2d: bool = False):
    """Spec tree for a parameter tree: ``axes_tree`` (``Model.logical_axes``)
    and ``shapes_tree`` (tensors, meta tensors included, or anything with a
    ``shape``) in lockstep."""
    fsdp_axes = data_axes(mesh) if fsdp else ()
    moe_axes = data_axes(mesh) if moe_2d else ()
    return _map(lambda ax, sh: _spec_for(ax, tuple(sh.shape), mesh,
                                         fsdp_axes, moe_axes),
                axes_tree, shapes_tree, is_leaf=_is_axes)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(dim)`` on
    each mesh dim that an entry names, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in _axes(mesh):
        dim = next((i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``), with its
    ``DTensor`` placements."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def param_shardings(axes_tree, shapes_tree, mesh, *, fsdp: bool = True):
    specs = param_pspecs(axes_tree, shapes_tree, mesh, fsdp=fsdp)
    return _map(lambda s: NamedSharding(mesh, s), specs,
                is_leaf=lambda x: isinstance(x, PartitionSpec))


def batch_pspec(global_batch: int, mesh) -> PartitionSpec:
    """Shard the batch dim over ('pod','data') if divisible, else replicate."""
    ax = data_axes(mesh)
    if ax and global_batch % _axis_size(mesh, ax) == 0:
        return P(_entry(ax))
    # try data-only
    if "data" in _axes(mesh) and global_batch % _axis_size(mesh, "data") == 0:
        return P("data")
    return P()


def cache_pspecs(cache_shapes, mesh, global_batch: int):
    """Decode-cache specs: batch over the data axes when divisible;
    otherwise the sequence dim (sequence parallelism, long_500k), and a
    heads-like dim over 'model'.  Takes the cache tree of
    ``launch.specs.cache_specs`` (or any tree of tensors)."""
    ax = data_axes(mesh)
    dsize = _axis_size(mesh, ax) if ax else 1
    batch_ok = bool(ax) and global_batch % dsize == 0
    data_entry = _entry(ax)
    msize = _axes(mesh).get("model", 1)

    def spec(leaf):
        shp = tuple(getattr(leaf, "shape", ()))
        nd = len(shp)
        if nd == 0:
            return P()
        entries = [None] * nd
        if batch_ok and shp[0] == global_batch:
            entries[0] = data_entry
        elif nd >= 2 and shp[0] == global_batch and not batch_ok:
            # batch too small: SP — shard the sequence dim (axis 1)
            if shp[1] % dsize == 0 and shp[1] > 1:
                entries[1] = data_entry
        # shard a heads-like dim over model if divisible (dims 2+)
        for i in range(2, nd):
            if shp[i] % msize == 0 and shp[i] >= msize and entries[i] is None:
                entries[i] = "model"
                break
        return P(*entries)

    return _map(spec, cache_shapes)


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, mesh, spec: PartitionSpec):
    """The reference's ``with_sharding_constraint``: a layout that changes
    no value.  A plain tensor is returned as it is; a ``DTensor`` is
    redistributed to ``spec``'s placements."""
    if not _is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(spec, mesh))


# ---------------------------------------------------------------- per rank
def _coord(mesh, names) -> int:
    """This rank's linear index over the mesh dims ``names`` (major to
    minor, as a tuple entry orders them)."""
    axes = _axes(mesh)
    idx = 0
    for a in names:
        idx = idx * axes[a] + mesh.get_local_rank(a)
    return idx


def _block(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The block of the global ``x`` that ``spec`` puts on this rank's mesh
    coordinates (``NamedSharding(mesh, spec)``'s shard here)."""
    for dim, e in enumerate(spec):
        if e is None:
            continue
        names = e if isinstance(e, tuple) else (e,)
        n = _axis_size(mesh, names)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {names} ({n})")
        x = x.chunk(n, dim)[_coord(mesh, names)]
    return x


def _groups(mesh, names) -> list:
    """The process groups of the mesh dims ``names``, minor dim first (the
    order in which a gather over several dims must concatenate)."""
    return [mesh.get_group(a) for a in reversed(tuple(names))]


def _all_reduce(x: torch.Tensor, mesh, names, op) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()  # NCCL takes contiguous tensors only
    for g in _groups(mesh, names):
        dist.all_reduce(x, op=op, group=g)
    return x


def _gather(x: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over the mesh dims ``names``, concatenated along
    ``dim`` in coordinate order (tiled ``all_gather``)."""
    import torch.distributed as dist

    for g in _groups(mesh, names):
        n = dist.get_world_size(g)
        moved = x.movedim(dim, 0).contiguous()
        out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
        dist.all_gather_into_tensor(out, moved, group=g)
        x = out.movedim(0, dim)
    return x


def _reduce_scatter(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """The transpose of :func:`_gather` along dim 0: ``x`` summed over the
    ranks of the mesh dims ``names``, each keeping its own block."""
    import torch.distributed as dist

    for g in reversed(_groups(mesh, names)):
        n = dist.get_world_size(g)
        out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x.contiguous(), group=g)
        x = out
    return x


class _AllGather(torch.autograd.Function):
    """:func:`_gather` along dim 0 with its gradient: each rank's block
    gets the sum of every rank's gradient for it."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return _gather(x, mesh, names, 0)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.names), None, None


def _shard_bytes(shapes_tree, specs_tree, mesh) -> int:
    """Bytes one rank holds of a tree of tensors (meta tensors included)
    laid out by a spec tree on ``mesh``: each leaf's bytes over the sizes
    of the axes its spec names (the plan's entries divide by
    construction)."""
    total = 0

    def one(t, spec):
        nonlocal total
        if isinstance(t, torch.Tensor):
            parts = 1
            for e in spec:
                parts *= _axis_size(mesh, e)
            total += t.numel() * t.element_size() // parts

    _map(one, shapes_tree, specs_tree)
    return total
