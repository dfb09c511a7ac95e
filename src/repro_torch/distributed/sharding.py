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

The plan realised, a process a rank: :func:`shard_params` gives the
rank's block of every leaf (:func:`gather_params` the global tree back),
and the steps compute with blocks.  :func:`use` gathers a leaf on use
(ZeRO-3), with a gradient summed over the mesh dims where the rank's
compute differs and taken as the rank's own block elsewhere;
:func:`copy_to_model` and :func:`reduce_from_model` are Megatron's two
tensor-parallel operators; :func:`sum_rows` sums row-parallel partials
(all-reduced, or reduce-scattered along the sequence under sequence
parallelism) and :func:`mine` makes a gradient every rank holds whole
into this rank's part of it; :func:`split`, :func:`gather` and
:func:`all_to_all` carry their transposes; :func:`relayout` moves a
decode cache between its plan and a step's layout (an all-to-all where a
mesh dim moves from one tensor dim to another).  ``use(columns=)`` takes,
from the contiguous blocks of a dim over 'model', the columns each rank
computes with (one all-to-all of uneven pieces: the SSD mixer's heads).
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
    "gather_params",
    "param_pspecs",
    "param_shardings",
    "shard_params",
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


def param_shardings(axes_tree, shapes_tree, mesh, *, fsdp: bool = True,
                    moe_2d: bool = False):
    specs = param_pspecs(axes_tree, shapes_tree, mesh, fsdp=fsdp,
                         moe_2d=moe_2d)
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


def _names(entry) -> tuple:
    """The mesh dims of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _split_dims(spec, mesh, keep=()) -> tuple:
    """``(dim, names)`` of each dim ``spec`` lays over mesh dims of more
    than one rank (a dim of one rank moves nothing), less the dims whose
    entry names a mesh dim in ``keep``."""
    axes = _axes(mesh)
    out = []
    for dim, e in enumerate(spec):
        names = tuple(n for n in _names(e) if axes.get(n, 1) > 1)
        if names and not set(_names(e)) & set(keep):
            out.append((dim, names))
    return tuple(out)


def _own(x: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over the mesh dims
    ``names`` (major to minor)."""
    return x.chunk(_axis_size(mesh, names), dim)[_coord(mesh, names)]


def _scatter_sum(x: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """:func:`_reduce_scatter` along ``dim``."""
    if dim == 0:
        return _reduce_scatter(x, mesh, names)
    return _reduce_scatter(x.movedim(dim, 0), mesh, names).movedim(0, dim)


_PIECES: dict = {}


def _pieces(n: int, me: int, picks: tuple, device) -> tuple:
    """How the ranks of 'model' exchange the columns ``picks`` (per rank,
    its sorted ``(lo, hi)`` ranges of global columns) where rank ``me``
    holds the contiguous block ``me`` of ``n`` columns: (the local
    indices it sends, rank after rank; how many it sends each rank; how
    many it takes from each)."""
    key = (n, me, picks, str(device))
    hit = _PIECES.get(key)
    if hit is None:
        lo_me, hi_me = me * n, (me + 1) * n
        send, sizes = [], []
        for ranges in picks:
            idx = [i - lo_me for lo, hi in ranges
                   for i in range(max(lo, lo_me), min(hi, hi_me))]
            send += idx
            sizes.append(len(idx))
        takes = [sum(max(0, min(hi, (j + 1) * n) - max(lo, j * n))
                     for lo, hi in picks[me]) for j in range(len(picks))]
        hit = (torch.tensor(send, dtype=torch.long, device=device), sizes,
               takes)
        _PIECES[key] = hit
    return hit


def _a2a(x: torch.Tensor, group, out_sizes, in_sizes) -> torch.Tensor:
    """``all_to_all_single`` of uneven pieces along dim 0."""
    import torch.distributed as dist

    out = x.new_empty((sum(out_sizes),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), out_sizes, in_sizes,
                           group=group)
    return out


def _take_columns(x: torch.Tensor, mesh, dim: int, picks: tuple):
    """The columns ``picks[r]`` on each rank ``r`` of 'model', of a dim
    that 'model' splits into contiguous blocks (``x``: this rank's block,
    ``dim`` that dim), in one all-to-all."""
    xt = x.movedim(dim, 0)
    idx, sizes, takes = _pieces(xt.shape[0], mesh.get_local_rank("model"),
                                picks, x.device)
    out = _a2a(xt.index_select(0, idx), mesh.get_group("model"), takes,
               sizes)
    return out.movedim(0, dim)


def _give_columns(g: torch.Tensor, mesh, dim: int, picks: tuple,
                  n: int) -> torch.Tensor:
    """The transpose of :func:`_take_columns`: the f32 gradient of this
    rank's block of ``n`` columns from each rank's gradient ``g`` of its
    columns, summed where several ranks took a column."""
    idx, sizes, takes = _pieces(n, mesh.get_local_rank("model"), picks,
                                g.device)
    back = _a2a(g.movedim(dim, 0).float(), mesh.get_group("model"), sizes,
                takes)
    out = back.new_zeros((n,) + tuple(back.shape[1:]))
    return out.index_add_(0, idx, back).movedim(0, dim)


class _Use(torch.autograd.Function):
    """A leaf's block gathered along ``dims`` (``(dim, names)`` pairs) with
    its gradient; with ``cols`` (``(dim, picks)``) then the columns each
    rank computes with taken over 'model' (:func:`_take_columns`).
    Backward, over each mesh dim of ``partial`` (the rank's compute
    differs over it: its batch, or the block of heads it runs) the
    gradients of the ranks are summed, in f32: the columns' back to their
    blocks, a reduce-scatter along a gathered dim, an all-reduce where the
    leaf is not laid over that mesh dim (``reduce``).  Over any other mesh
    dim the ranks computed the same gradient, and each keeps its own block
    of it: a sum there would count it once a rank."""

    @staticmethod
    def forward(ctx, x, mesh, dims, partial, reduce, cols):
        ctx.mesh, ctx.dims, ctx.partial, ctx.reduce = (mesh, dims, partial,
                                                       reduce)
        for dim, names in dims:
            x = _gather(x, mesh, names, dim)
        ctx.cols = None
        if cols:  # (dim, picks, the block's length along dim)
            ctx.cols = cols + (x.shape[cols[0]],)
            x = _take_columns(x, mesh, *cols)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.float()
        if ctx.cols:
            g = _give_columns(g, mesh, *ctx.cols)
        for dim, names in reversed(ctx.dims):
            for name in names:  # major first: the gather's last step
                g = (_scatter_sum(g, mesh, (name,), dim)
                     if name in ctx.partial else _own(g, mesh, (name,), dim))
        if ctx.reduce:
            import torch.distributed as dist

            g = _all_reduce(g, mesh, ctx.reduce, dist.ReduceOp.SUM)
        return g, None, None, None, None, None


def use(x: torch.Tensor, mesh, spec, *, keep=(), partial=(),
        columns=None) -> torch.Tensor:
    """What a rank computes with from its block ``x`` of a leaf that
    ``spec`` lays out on ``mesh``: ``x`` gathered over every mesh dim the
    spec names, save the dims whose entry names one of ``keep`` (the rank
    runs on its block there: its heads, its ffn slice, its vocabulary, its
    experts).  ``columns`` (``(dim, picks)``, with 'model' kept on
    ``dim``): then the columns ``picks[r]`` of that dim on the rank of
    'model' coordinate ``r``, taken from the ranks' contiguous blocks.
    ``partial``: the mesh dims over which the rank's gradient of the
    result is a part of the whole (see :class:`_Use`); outside autograd
    it changes nothing."""
    dims = _split_dims(spec, mesh, keep)
    cols = tuple(columns) if columns else None
    if not (torch.is_grad_enabled() and x.requires_grad):
        for dim, names in dims:
            x = _gather(x, mesh, names, dim)
        return _take_columns(x, mesh, *cols) if cols else x
    named = {n for e in spec for n in _names(e)}
    axes = _axes(mesh)
    reduce = tuple(a for a in axes if a in partial and a not in named
                   and axes[a] > 1)
    if not (dims or reduce or cols):
        return x
    return _Use.apply(x, mesh, dims, frozenset(partial), reduce, cols)


class _Reduce(torch.autograd.Function):
    """A SUM all-reduce over the mesh dims ``fwd`` in the forward, over
    ``bwd`` in the backward, each in f32 and rounded once to the tensor's
    dtype.  ``fwd=(), bwd=("model",)`` and ``fwd=("model",), bwd=()`` are
    Megatron's two operators: the identity at a column-parallel input whose
    gradient is summed, and the sum of a row-parallel product's partials,
    whose gradient every rank already holds whole."""

    @staticmethod
    def forward(ctx, x, mesh, fwd, bwd):
        ctx.mesh, ctx.bwd = mesh, bwd
        return _sum_f32(x, mesh, fwd) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.mesh, ctx.bwd), None, None, None


def _sum_f32(x: torch.Tensor, mesh, names) -> torch.Tensor:
    import torch.distributed as dist

    names = tuple(n for n in names if _axes(mesh).get(n, 1) > 1)
    if not names:
        return x
    s = _all_reduce(x.float() if x.dtype != torch.float32 else x.clone(),
                    mesh, names, dist.ReduceOp.SUM)
    return s.to(x.dtype)


def reduce_sum(x: torch.Tensor, mesh, fwd=(), bwd=()) -> torch.Tensor:
    """:class:`_Reduce` (in f32, rounded once); outside autograd the
    forward alone."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reduce.apply(x, mesh, tuple(fwd), tuple(bwd))
    return _sum_f32(x, mesh, fwd)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's column-parallel input: the identity, its gradient summed
    over 'model'."""
    return reduce_sum(x, mesh, (), ("model",))


class _Mine(torch.autograd.Function):
    """The identity, whose gradient keeps this rank's block along ``dim``
    over 'model' and zeroes the rest."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = torch.zeros_like(g)
        _own(out, ctx.mesh, ("model",), ctx.dim).copy_(
            _own(g, ctx.mesh, ("model",), ctx.dim))
        return out, None, None


def mine(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """``x``, whose gradient, which every rank holds whole (a replicated
    compute's), becomes this rank's part of it: its block along ``dim``
    over 'model', zeros elsewhere, so that a sum over 'model' counts it
    once (:class:`_Mine`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Mine.apply(x, mesh, dim)
    return x


class _RowSum(torch.autograd.Function):
    """Row-parallel partials (f32) summed over 'model' in f32 and rounded
    once to ``dtype``: all-reduced, or with ``dim`` reduce-scattered along
    it (sequence parallelism: this rank keeps its block).  The backward
    is the transpose: the gradient as it is, or gathered along ``dim``
    in ``dtype``."""

    @staticmethod
    def forward(ctx, part, mesh, dim, dtype):
        ctx.mesh, ctx.dim = mesh, dim
        if dim is None:
            return _sum_f32(part, mesh, ("model",)).to(dtype)
        return _scatter_sum(part, mesh, ("model",), dim).to(dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is not None:
            g = _gather(g, ctx.mesh, ("model",), ctx.dim)
        return g.float(), None, None, None


def sum_rows(part: torch.Tensor, mesh, dtype, dim=None) -> torch.Tensor:
    """:class:`_RowSum`."""
    return _RowSum.apply(part, mesh, dim, dtype)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's row-parallel output: the partials summed over 'model' in
    f32 and rounded once; the gradient passes as it is."""
    return reduce_sum(x, mesh, ("model",), ())


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` over ``names``; backward gathers
    the blocks' gradients (the transpose of a gather whose gradient every
    rank holds whole)."""

    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        return _own(x, mesh, names, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.names, ctx.dim), None, None, None


def split(x: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    names = tuple(names)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Split.apply(x, mesh, names, dim)
    return _own(x, mesh, names, dim)


def gather(x: torch.Tensor, mesh, names, dim: int, *,
           partial: bool) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` over ``names``, with the gradient
    of :func:`use`: summed over the ranks (``partial``) or each rank's own
    block of it."""
    names = tuple(n for n in names if _axes(mesh).get(n, 1) > 1)
    if not names:
        return x
    return use(x, mesh, tuple(names if d == dim else None
                              for d in range(x.dim())),
               partial=names if partial else ())


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` (chunk i of dim 0 to peer i);
    its transpose is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


def _move(x: torch.Tensor, mesh, name: str, src: int,
          dst: int) -> torch.Tensor:
    """``x``, a block along ``src`` over the mesh dim ``name``, as a block
    along ``dst`` over it (``src`` whole): one all-to-all over ``name``."""
    m = _axes(mesh)[name]
    send = torch.stack(x.chunk(m, dst))
    got = _exchange(send, mesh.get_group(name))
    return torch.cat(got.unbind(0), dim=src)


def relayout(x: torch.Tensor, mesh, held, want) -> torch.Tensor:
    """A tensor laid out by the entries ``held`` (one a dim) in the layout
    ``want``, outside autograd (a decode cache between its plan and the
    layout a step computes in): gathered where ``held`` names mesh dims
    that ``want`` does not; a mesh dim that is a whole entry of both on
    different dims moves between them by one all-to-all (:func:`_move`),
    after the gathers; then cut to this rank's block where ``want`` names
    ones that ``held`` does not."""
    axes = _axes(mesh)
    held, want = list(held), list(want)
    moves = []
    for name in axes:
        src = [d for d, e in enumerate(held) if e == name]
        dst = [d for d, e in enumerate(want) if e == name]
        if axes[name] > 1 and src and dst and src != dst:
            moves.append((name, src[0], dst[0]))
            held[src[0]] = want[dst[0]] = None
    for dim, (h, w) in enumerate(zip(held, want)):
        if h != w and h is not None:
            x = _gather(x, mesh, _names(h), dim)
    for move in moves:
        x = _move(x, mesh, *move)
    for dim, (h, w) in enumerate(zip(held, want)):
        if h != w and w is not None:
            x = _own(x, mesh, _names(w), dim)
    return x


# ------------------------------------------------------ the plan realised
def shard_params(tree, plan):
    """This rank's blocks of the global ``tree`` (parameters, or anything
    of their shapes: the AdamW moments) under ``plan`` (a tree of
    :class:`NamedSharding`, :func:`param_shardings`' tree): each block a
    tensor of its own, as ``param_pspecs`` lays it out (a leaf the plan
    does not split over more than one rank is the leaf itself)."""
    def one(t, s):
        b = _block(t, s.mesh, s.spec)
        return t if b.numel() == t.numel() else b.clone()

    return _map(one, tree, plan)


def gather_params(blocks, plan):
    """The global tree of this rank's ``blocks`` under ``plan`` (every
    rank calls it: each leaf is gathered over every mesh dim its spec
    names)."""
    def one(t, s):
        for dim, names in _split_dims(s.spec, s.mesh):
            t = _gather(t, s.mesh, names, dim)
        return t

    return _map(one, blocks, plan)


def block_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec``."""
    return tuple(n // _axis_size(mesh, _names(e) or None)
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


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
