"""One gloo rank of ``tests/test_torch_mesh_ranks.py`` (not a test file):

    python tests/torch_mesh_ranks_worker.py RANK WORLD STORE OUT

joins a ``file://`` rendezvous at STORE, runs every multi-rank check of the
port on the CPU on one intra-op thread, and writes its results to
``OUT/rank<RANK>.npz`` (bf16 tensors as float32, exactly).  It imports
neither jax nor repro.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch_mesh_common as C  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import TokenStream, sharded_batches  # noqa
from repro_torch.distributed.sharding import (  # noqa: E402
    PartitionSpec, _block, batch_pspec, constrain, param_shardings)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.moe import _route, moe_capacity, moe_ffn_ep  # noqa
from repro_torch.models.shard_ctx import shard_scope  # noqa: E402
from repro_torch.optim import adamw_init, compressed_psum  # noqa: E402
from repro_torch.optim.compress import _psum_leaf  # noqa: E402


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).numpy()


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def moe_checks(mesh, out: dict) -> None:
    for case in C.MOE_CASES:
        params, x, cf = C.moe_inputs(case)
        cfg = ModelConfig(**C.MOE, capacity_factor=cf)
        p = {k: torch.from_numpy(v) if k == "router"
             else torch.from_numpy(v).to(torch.bfloat16)
             for k, v in params.items()}
        with torch.no_grad():
            y, aux = moe_ffn_ep(p, torch.from_numpy(x).to(torch.bfloat16),
                                cfg, mesh)
        out[f"moe/{case}/y"] = _np(y)
        out[f"moe/{case}/aux"] = _np(aux)
        # the assignments this rank's shard keeps (the training layout's
        # x_spec: batch over data, sequence over model)
        b, s, d = x.shape
        xl = torch.from_numpy(x).to(torch.bfloat16)
        if s > 1:
            xl = _block(xl, mesh, PartitionSpec("data", "model"))
        t = xl.shape[0] * xl.shape[1]
        _, disp, _ = _route(xl.reshape(t, d), p["router"], cfg,
                            moe_capacity(t, cfg))
        out[f"moe/{case}/kept"] = np.asarray(int(disp[3].sum()))
        out[f"moe/{case}/assigned"] = np.asarray(disp[3].numel())


def psum_checks(out: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    mesh8 = init_device_mesh("cpu", (C.RANKS,), mesh_dim_names=("x",))
    grads, err = C.psum_inputs()
    spec = PartitionSpec("x")
    g = {k: _block(torch.from_numpy(v), mesh8, spec)
         for k, v in grads.items() if k != "c"}
    g["b"] = g["b"].to(torch.bfloat16)
    g["c"] = {"w": _block(torch.from_numpy(grads["c"]["w"]), mesh8, spec)}
    e = {"a": _block(torch.from_numpy(err["a"]), mesh8, spec),
         "b": _block(torch.from_numpy(err["b"]), mesh8, spec),
         "c": {"w": _block(torch.from_numpy(err["c"]["w"]), mesh8, spec)}}
    with shard_scope(mesh8):
        mean, new_err = compressed_psum(g, e, "x")
    for (name, m), (_, ne), (_, gl), (_, el) in zip(
            _leaves(mean), _leaves(new_err), _leaves(g), _leaves(e)):
        _, _, q, total = _psum_leaf(gl, el, mesh8, ("x",))
        out[f"psum{name}/mean"] = _np(m)
        out[f"psum{name}/err"] = _np(ne)
        out[f"psum{name}/q"] = _np(q)
        out[f"psum{name}/total"] = _np(total)
    out["psum/coord"] = np.asarray(mesh8.get_local_rank("x"))


def batch_checks(mesh, out: dict) -> None:
    stream = TokenStream(**C.STREAM)
    for name, spec in C.BATCH_SPECS.items():
        for step in C.STREAM_STEPS:
            batch = next(sharded_batches(stream, mesh, PartitionSpec(*spec),
                                         start_step=step))
            for k, v in batch.items():
                out[f"batch/{name}/{step}/{k}"] = _np(v)
    out["batch/pspec"] = np.asarray(str(tuple(
        batch_pspec(C.STREAM["global_batch"], mesh))))


def dp_checks(rank: int, out: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    mesh42 = init_device_mesh("cpu", C.DP_MESH,
                              mesh_dim_names=("data", "model"))
    dmesh = mesh42["data"]  # data=4: this rank's replica of the DP group
    for family, arch in C.DP_ARCHS.items():
        cfg = get_smoke(arch)
        if cfg.family == "moe":  # no expert overflows
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        model = Model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(C.DP_SEED))
        plan = param_shardings(model.logical_axes(), params, dmesh)
        stream = TokenStream(vocab=cfg.vocab, seq_len=C.DP_SEQ,
                             global_batch=C.DP_BATCH)
        spec = batch_pspec(C.DP_BATCH, dmesh)
        block = next(sharded_batches(stream, dmesh, spec))
        tc = TrainConfig(warmup_steps=2)
        step = make_train_step(model, tc, param_shardings=plan)
        runs = {"dp": step(params, adamw_init(params), block)}
        if rank == 0:  # the one-process step on the whole batch
            whole = next(sharded_batches(stream, device="cpu"))
            runs["one"] = make_train_step(model, tc)(
                params, adamw_init(params), whole)
        for run, (p, opt, metrics) in runs.items():
            key = f"dp/{family}/{run}"
            for m in ("loss", "ce", "grad_norm", "lr"):
                out[f"{key}/{m}"] = _np(metrics[m])
            for tree, name in ((p, "params"), (opt.m, "m"), (opt.v, "v")):
                for path, t in _leaves(tree):
                    out[f"{key}/{name}{path}"] = _np(t)


def dtensor_checks(mesh, out: dict) -> None:
    """A layout pin on a DTensor: a replicated one redistributed to the
    placements of ``P("data", "model")``, its values unchanged."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    x = torch.arange(32.0).reshape(4, 8)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    c = constrain(d, mesh, PartitionSpec("data", "model"))
    out["dtensor/placements"] = np.asarray(str(tuple(c.placements)))
    out["dtensor/full"] = _np(c.full_tensor())
    out["dtensor/local"] = _np(c.to_local())


def main() -> int:
    rank, world, store, dest = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], Path(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = make_local_mesh(*C.MESH, device="cpu")
    out = {"coord": np.asarray(mesh.get_coordinate())}
    moe_checks(mesh, out)
    psum_checks(out)
    batch_checks(mesh, out)
    dtensor_checks(mesh, out)
    dp_checks(rank, out)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(dest / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
