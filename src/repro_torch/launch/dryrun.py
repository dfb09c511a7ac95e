"""Dry run of every (arch x shape x mesh) cell: the torch twin of the JAX
package's ``repro/launch/dryrun.py``.

The reference compiles each cell with XLA over 512 forced host devices and
reads the compiled module's memory and cost analyses and the collectives in
its HLO text.  The port has no compiler to ask, so it traces: one rank's
step runs once on fake tensors of the meta device (no storage, no card),
as rank 0 of a ``fake`` process group of the mesh's size
(:func:`~repro_torch.launch.mesh.make_fake_mesh`), under

  * :func:`collective_counts` (a ``TorchDispatchMode``): every ``c10d``
    collective the step issues, with its operand and link bytes, by
    collective and by mesh dim;
  * ``torch.utils.flop_counter.FlopCounterMode``: the rank's FLOPs (B5
    counts through its operator's FLOP formula);
  * ``torch.distributed._tools.mem_tracker.MemTracker``: the rank's peak
    bytes, of which the arguments are what the rank holds as the port
    holds it today (parameters and optimizer state replicated over the
    data axes, ROADMAP §C P31), and ``plan_argument_bytes`` what it would
    hold under the sharding plan;
  * a dispatch mode that adds each op's input and output bytes (the
    reference's ``bytes accessed``, before any fusion).

The FLOP probe (``probe``, :func:`repro_torch.launch.patch_probe.probe_cell`)
is the unpartitioned step of the whole global batch on meta tensors with no
mesh, its layers unrolled as the port always runs them.

Rank 0 runs its block of the batch (``sharded_batches``' block over the
data axes).  The train step is the data-parallel step of the plan
(``make_train_step(param_shardings=)``, an f32 gradient all-reduce over the
data axes); prefill and decode run in the mesh's scope with the batch
sharded over the data axes, as that step's forward does (a moe layer
gathers the tokens over them, then runs ``moe_ffn_ep`` over ``model``).
Decode takes the serving layout's plan (``param_pspecs(..., fsdp=False,
moe_2d=True)``) and a full cache at position ``seq_len - 1``.

The dry run needs no card and runs on the CPU.  Run it as its own process
(``python -m repro_torch.launch.dryrun``): a process holds one process
group, and ``--all`` runs each cell in a subprocess of its own, keeping
the records of cells that are ok or skipped.  Records go to ``--out``
(default ``experiments/dryrun_torch``, apart from the reference's
directory), one JSON file a cell, of the reference's shape, so
``launch/roofline.py`` and ``launch/report.py`` read them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["collective_counts", "main", "run_cell", "trace_step"]

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# c10d op -> (the reference's collective name, index of the argument that
# holds the operand); recv_ is the far side of a send and is not counted
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _link_bytes(op: str, operand: int, g: int) -> float:
    """Bytes one rank sends over its links for a ring collective of ``g``
    ranks (the reference's factors, ``repro/launch/dryrun.py:179-194``)."""
    ring = (g - 1) / g
    if op == "all-gather":
        return operand * g * ring  # each shard sent g-1 times
    if op == "reduce-scatter":
        return operand * ring
    if op == "all-reduce":
        return 2 * operand * ring  # reduce-scatter + all-gather
    if op == "all-to-all":
        return operand * ring
    return operand  # collective-permute


class _CollectiveLog(TorchDispatchMode):
    def __init__(self, dims: dict):
        super().__init__()
        self.dims = dims  # process group name -> mesh dim name
        self.out = {k: {"bytes": 0, "link_bytes": 0, "count": 0}
                    for k in _COLLECTIVES}
        self.by_dim: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        entry = (_C10D.get(func.__name__.split(".")[0])
                 if func.namespace == "c10d" else None)
        if entry is not None:
            self._record(entry, args)
        return func(*args, **kwargs)

    def _record(self, entry, args) -> None:
        import torch.distributed as dist

        op, at = entry
        pg = next(dist.ProcessGroup.unbox(a) for a in args
                  if isinstance(a, torch.ScriptObject)
                  and "ProcessGroup" in str(a))
        g = pg.size()
        operand = _nbytes(args[at])
        link = int(_link_bytes(op, operand, g))
        for row in (self.out[op], self.by_dim.setdefault(
                self.dims.get(pg.group_name, pg.group_name),
                {"bytes": 0, "link_bytes": 0, "count": 0, "size": g})):
            row["bytes"] += operand
            row["link_bytes"] += link
            row["count"] += 1


@contextlib.contextmanager
def collective_counts(mesh=None):
    """Record every ``c10d`` collective issued inside the block (on real,
    meta or fake tensors; a ``fake`` process group moves nothing).  Yields
    a dict of the reference's shape (``collective_bytes``): per collective
    ``bytes`` (operand bytes), ``link_bytes`` (what one rank sends over
    its links on a ring) and ``count``, and ``total_bytes``,
    ``total_link_bytes``, ``total_count``; besides them ``by_dim``: the
    same three and the group ``size`` per mesh dim of ``mesh`` (a group
    outside the mesh under its process group name).  The totals are filled
    in when the block ends.  The port issues its collectives explicitly
    and runs its layers as a Python loop, so no trip count enters."""
    dims = {}
    if mesh is not None:
        dims = {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}
    log = _CollectiveLog(dims)
    out = log.out
    out["by_dim"] = log.by_dim
    with log:
        yield out
    rows = [out[k] for k in _COLLECTIVES]
    out["total_bytes"] = sum(r["bytes"] for r in rows)
    out["total_link_bytes"] = sum(r["link_bytes"] for r in rows)
    out["total_count"] = sum(r["count"] for r in rows)


class _BytesAccessed(TorchDispatchMode):
    """Each op's input and output tensor bytes, added up (the reference's
    HLO ``bytes accessed`` before fusion); views move nothing and are left
    out."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += (_flat_bytes(args) + _flat_bytes(kwargs.values())
                           + _flat_bytes((out,)))
        return out


def _flat_bytes(items) -> int:
    """Tensor bytes among ``items`` and the lists and tuples in them (an
    op's arguments nest no deeper)."""
    total = 0
    for a in items:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif isinstance(a, (list, tuple)):
            total += _flat_bytes(a)
    return total


def _default_microbatches(arch: str, shape_name: str) -> int:
    """Keep per-step activation memory bounded for the big train cells."""
    if shape_name != "train_4k":
        return 1
    big = {"qwen3-moe-235b-a22b": 8, "qwen2-vl-72b": 8, "dbrx-132b": 8,
           "command-r-35b": 4}
    return big.get(arch, 2)


def _mesh_names(mesh_shape: tuple) -> tuple:
    return ("pod", "data", "model")[3 - len(mesh_shape):]


def _blocked(tree, specs, mesh):
    """Meta tensors of the blocks rank 0 holds of ``tree`` when only the
    leading (batch) dim of each spec is realised: the port shards a batch
    over the data axes and replicates the rest."""
    from ..distributed.sharding import _axis_size, _map

    def one(t, spec):
        if not isinstance(t, torch.Tensor) or not spec or spec[0] is None:
            return t
        n = _axis_size(mesh, spec[0])
        return torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device="meta")

    return _map(one, tree, specs)


def _fake(tree, mode, device):
    """Tensors made under ``mode`` on ``device`` with the shapes and dtypes
    of ``tree``'s tensors (other leaves kept)."""
    from ..distributed.sharding import _map

    with mode:
        return _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device)
                    if isinstance(t, torch.Tensor) else t, tree)


def trace_step(step, args: tuple, mesh=None, device="meta") -> dict:
    """Run ``step(*args)`` once on tensors of ``args``' shapes that hold no
    data: meta tensors for the dry run, or fake tensors on ``device``
    (``cuda`` on a card, where the memory tracker applies the allocator's
    rounding), under :func:`collective_counts`, ``FlopCounterMode``,
    ``MemTracker`` and the bytes-accessed count.  Returns the record's
    ``memory``, ``cost`` and ``collectives`` and the trace's ``seconds``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    # meta tensors trace as they are (and 3.4x faster than fake ones); the
    # mesh's own bookkeeping (rank maps) runs on real CPU tensors
    mode = (contextlib.nullcontext() if device == "meta"
            else FakeTensorMode(allow_non_fake_inputs=True))
    fake = _fake(args, mode, device)
    leaves = [t for t in tree_flatten(fake)[0] if isinstance(t, torch.Tensor)]
    tracker = MemTracker()
    tracker.track_external(*leaves)
    t0 = time.perf_counter()
    with mode, collective_counts(mesh) as coll, _BytesAccessed() as acc, \
            FlopCounterMode(display=False) as flops, tracker:
        out = step(*fake)
    seconds = time.perf_counter() - t0
    arg_bytes = _nbytes(leaves)
    stores = {t.untyped_storage()._cdata for t in leaves}
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    peak = sum(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    memory = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": _nbytes(outs),
        "temp_size_in_bytes": max(peak - arg_bytes, 0),
        "alias_size_in_bytes": _nbytes([t for t in outs if
                                        t.untyped_storage()._cdata in stores]),
        "generated_code_size_in_bytes": 0,
        "peak_bytes": peak,
    }
    cost = {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(acc.bytes)}
    return {"memory": memory, "cost": cost, "collectives": coll,
            "seconds": seconds}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: int = 0, *, cfg=None, shape=None,
             mesh_shape=None) -> dict:
    """Trace one cell; returns its record.  ``cfg``, ``shape`` and
    ``mesh_shape`` stand in for the registry's configuration, the shape of
    ``SHAPES`` and the production mesh ((16, 16), or (2, 16, 16) with
    ``multi_pod``), so a small cell runs in a test.  ``compile_s`` is 0.0:
    nothing is compiled, ``lower_s`` is the trace's seconds.  A failing
    probe raises (the record is then an error), where the reference's
    leaves it empty."""
    import torch.distributed as dist

    from ..configs import SHAPES, TrainConfig, cell_is_skipped, get_config
    from ..distributed.sharding import (
        _axis_size, _shard_bytes, batch_pspec, cache_pspecs, data_axes,
        param_pspecs, param_shardings)
    from ..models import build_model
    from ..models.shard_ctx import shard_scope
    from .mesh import make_fake_mesh
    from .patch_probe import probe_cell
    from .specs import cache_specs, input_specs, state_specs
    from .steps import make_decode_step, make_prefill_step, make_train_step

    shape = shape or SHAPES[shape_name]
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": skip}
    cfg = cfg or get_config(arch)
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    mesh_name = "x".join(str(n) for n in mesh_shape)
    if shape.kind == "train" and cfg.family == "moe" and mesh_shape[-1] > 1:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "the port's expert-parallel moe_ffn_ep runs forward "
                          "only: no train step over a model dim > 1 "
                          "(ROADMAP §A 3)"}

    mesh = make_fake_mesh(mesh_shape, _mesh_names(mesh_shape))
    try:
        model = build_model(cfg, "meta").set_mesh(mesh)
        params_s, opt_s, axes = state_specs(model)
        p_specs = param_pspecs(axes, params_s, mesh)
        bspec = batch_pspec(shape.global_batch, mesh)
        batch = input_specs(cfg, shape)
        b_specs = {k: bspec for k in batch}
        batch_r = _blocked(batch, b_specs, mesh)
        plan = _shard_bytes(batch, b_specs, mesh)
        sharded = bool(bspec) and _axis_size(mesh, bspec[0]) > 1
        scope = shard_scope(mesh, batch_axes=data_axes(mesh) if sharded
                            else ())
        mb = 1
        if shape.kind == "train":
            mb = microbatches or _default_microbatches(arch, shape_name)
            tc = TrainConfig(microbatches=mb, remat="full")
            step = make_train_step(
                model, tc, param_shardings=param_shardings(axes, params_s,
                                                           mesh),
                donate=True)
            args = (params_s, opt_s, batch_r)
            plan += (_shard_bytes(params_s, p_specs, mesh)
                     + _shard_bytes(opt_s.m, p_specs, mesh)
                     + _shard_bytes(opt_s.v, p_specs, mesh)
                     + _nbytes(opt_s.step))
        elif shape.kind == "prefill":
            inner = make_prefill_step(model)

            def step(params, batch):
                with scope:
                    return inner(params, batch)

            args = (params_s, batch_r)
            plan += _shard_bytes(params_s, p_specs, mesh)
        else:
            cache_s = cache_specs(model, shape)
            c_specs = cache_pspecs(cache_s, mesh, shape.global_batch)
            serve = param_pspecs(axes, params_s, mesh, fsdp=False,
                                 moe_2d=True)
            plan += (_shard_bytes(params_s, serve, mesh)
                     + _shard_bytes(cache_s, c_specs, mesh))
            # the port's cache holds its position as a Python int
            cache_r = dict(_blocked(cache_s, c_specs, mesh),
                           len=shape.seq_len - 1)
            inner = make_decode_step(model)

            def step(params, cache, tokens):
                with scope:
                    return inner(params, cache, tokens)

            args = (params_s, cache_r, batch_r["tokens"])
        traced = trace_step(step, args, mesh)
        mem = dict(traced["memory"], plan_argument_bytes=plan)
        probe = probe_cell(arch, shape_name, cfg=cfg, shape=shape)
        return {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_name,
            "status": "ok",
            "devices": dist.get_world_size(),
            "kind": shape.kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens": shape.tokens,
            "microbatches": mb,
            "lower_s": round(traced["seconds"], 2),
            "compile_s": 0.0,
            "memory": mem,
            "cost": traced["cost"],
            "probe": probe,
            "collectives": traced["collectives"],
        }
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--all", action="store_true",
                    help="sweep every cell of --mesh, a subprocess a cell")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        from ..configs import cells

        rc = 0
        for arch, shape in cells():
            tag = f"{arch}__{shape}__{args.mesh}"
            dst = out_dir / f"{tag}.json"
            if dst.exists() and json.loads(dst.read_text()).get(
                    "status") in ("ok", "skipped"):
                print(f"[dryrun] {tag}: cached")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", args.mesh,
                   "--out", str(out_dir)]
            if args.microbatches:
                cmd += ["--microbatches", str(args.microbatches)]
            print(f"[dryrun] {tag}: tracing ...", flush=True)
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                failed, err = r.returncode != 0, r.stderr
            except subprocess.TimeoutExpired:
                failed, err = True, f"timed out after {args.timeout} s"
            if failed:
                rc = 1
                dst.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": args.mesh,
                    "status": "error", "stderr": err[-4000:],
                }, indent=1))
                print(f"[dryrun] {tag}: FAILED\n{err[-2000:]}")
            else:
                print(r.stdout.strip().splitlines()[-1] if r.stdout else "",
                      flush=True)
        return rc

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    try:
        res = run_cell(args.arch, args.shape, args.mesh == "multipod",
                       args.microbatches)
    except Exception:
        res = {
            "arch": args.arch, "shape": args.shape,
            "mesh": "2x16x16" if args.mesh == "multipod" else "16x16",
            "status": "error", "error": traceback.format_exc()[-4000:],
        }
    tag = f"{args.arch}__{args.shape}__{args.mesh}"
    (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
    if res["status"] == "ok":
        print(
            f"[dryrun] {tag}: OK trace={res['lower_s']}s "
            f"probe={res['probe']['probe_s']}s "
            f"flops={res['cost']['flops']:.3e} "
            f"coll={res['collectives']['total_bytes']:.3e}B "
            f"args={res['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB "
            f"(plan {res['memory']['plan_argument_bytes'] / 2**30:.2f}) "
            f"temp={res['memory']['temp_size_in_bytes'] / 2**30:.2f}GiB"
        )
        return 0
    if res["status"] == "skipped":
        print(f"[dryrun] {tag}: SKIPPED ({res['reason']})")
        return 0
    print(f"[dryrun] {tag}: ERROR\n{res.get('error', '')}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
