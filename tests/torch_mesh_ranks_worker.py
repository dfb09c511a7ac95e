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
    PartitionSpec, _block, _gather, batch_pspec, cache_pspecs, constrain,
    param_shardings, shard_params)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    cross_entropy, make_decode_step, make_prefill_step, make_train_step)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.moe import _route, moe_capacity, moe_ffn_ep  # noqa
from repro_torch.models.shard_ctx import shard_scope  # noqa: E402
from repro_torch.models.layers import MODEL_BLOCKS, embed, unembed  # noqa: E402
from repro_torch.optim import adamw_init, compress, compressed_psum  # noqa
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
        specs = C.moe_specs(case)
        blocks = {k: _block(v, mesh, PartitionSpec(*specs[k]))
                  for k, v in p.items()}
        with torch.no_grad():
            y, aux = moe_ffn_ep(blocks, torch.from_numpy(x).to(
                torch.bfloat16), cfg, mesh,
                {k: PartitionSpec(*v) for k, v in specs.items()})
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


def _smoke(arch: str):
    cfg = get_smoke(arch)
    if cfg.family == "moe":  # no expert overflows
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def dp_checks(mesh, rank: int, out: dict) -> None:
    """The blocked train step on the (data, model) mesh: each rank's blocks
    of the updated parameters and moments; rank 0 also runs the
    one-process step on the whole batch."""
    for family, arch in C.DP_ARCHS.items():
        cfg = _smoke(arch)
        model = Model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(C.DP_SEED))
        plan = param_shardings(model.logical_axes(), params, mesh)
        blocks = shard_params(params, plan)
        stream = TokenStream(vocab=cfg.vocab, seq_len=C.DP_SEQ,
                             global_batch=C.DP_BATCH)
        spec = batch_pspec(C.DP_BATCH, mesh)
        block = next(sharded_batches(stream, mesh, spec))
        tc = TrainConfig(warmup_steps=2)
        step = make_train_step(model, tc, param_shardings=plan)
        runs = {"dp": step(blocks, adamw_init(blocks), block)}
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


def compress_checks(mesh, out: dict) -> None:
    """``compress`` on the blocks of the dense model's plan against the
    blocks of ``compress`` of the global tree (one scale a whole leaf)."""
    model = Model(_smoke(C.DP_ARCHS["dense"]), "cpu")
    shapes = model.init(torch.Generator().manual_seed(C.DP_SEED))
    plan = param_shardings(model.logical_axes(), shapes, mesh)
    rng = np.random.default_rng(9)
    g = {path: torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)
                                * 10.0 ** rng.integers(-3, 3))
         for path, t in _leaves(shapes)}
    e = {path: torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)
                                * 1e-3) for path, t in _leaves(shapes)}
    flat_plan = dict(_leaves(plan))
    gb, eb = shard_params(g, flat_plan), shard_params(e, flat_plan)
    q, scales, err = compress(gb, eb, flat_plan)
    qg, sg, eg = compress(g, e)
    for path in g:
        out[f"compress{path}/q"] = _np(q[path])
        out[f"compress{path}/scale"] = _np(scales[path])
        out[f"compress{path}/err"] = _np(err[path])
        want = shard_params({"x": qg[path], "e": eg[path]},
                            {"x": flat_plan[path], "e": flat_plan[path]})
        out[f"compress{path}/q_global"] = _np(want["x"])
        out[f"compress{path}/scale_global"] = _np(sg[path])
        out[f"compress{path}/err_global"] = _np(want["e"])


def vocab_checks(mesh, out: dict) -> None:
    """Vocab-parallel ``embed``, ``unembed`` and ``cross_entropy`` on a
    padded vocabulary (250 tokens in 256 rows, the padding in the last
    'model' block) against the global ones, with the logits' gradient."""
    cfg = dataclasses.replace(get_smoke(C.DP_ARCHS["dense"]),
                              vocab=C.PAD_VOCAB)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(C.DP_SEED))
    plan = param_shardings(model.logical_axes(), params, mesh)
    table = shard_params(params, plan)["embed"]["table"]
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    labels = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    x = torch.randn((2, 8, cfg.d_model), generator=gen).to(torch.bfloat16)
    whole = {"table": params["embed"]["table"]}
    # the data axes gather the table's d_model; 'model' keeps the rows
    rows = {"table": _gather(table, mesh, ("data",), 1),
            MODEL_BLOCKS: frozenset({"table"})}
    with shard_scope(mesh):
        out["vocab/embed"] = _np(embed(rows, tokens, cfg))
        logits = unembed(rows, x, cfg).requires_grad_()
        ce = cross_entropy(logits, labels, mesh)
        (grad,) = torch.autograd.grad(ce, logits)
    out["vocab/embed_global"] = _np(embed(whole, tokens, cfg))
    out["vocab/logits"] = _np(logits)
    out["vocab/ce"] = _np(ce)
    out["vocab/grad"] = _np(grad)
    logits_g = unembed(whole, x, cfg).requires_grad_()
    ce_g = cross_entropy(logits_g, labels)
    (grad_g,) = torch.autograd.grad(ce_g, logits_g)
    out["vocab/logits_global"] = _np(logits_g)
    out["vocab/ce_global"] = _np(ce_g)
    out["vocab/grad_global"] = _np(grad_g)


def serve_checks(mesh, out: dict) -> None:
    """Prefill under the training layout's plan and decode steps under the
    serving layout's (the cache held as ``cache_pspecs`` lays it out), each
    step's logits gathered over the mesh; rank 0 also runs the unsharded
    model."""
    b, s, steps = C.SERVE
    for family, arch in C.DP_ARCHS.items():
        cfg = _smoke(arch)
        model = Model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(C.DP_SEED))
        axes = model.logical_axes()
        toks = torch.randint(1, cfg.vocab, (b, s + steps),
                             generator=torch.Generator().manual_seed(6))
        cache_plan = cache_pspecs(Model(cfg, "meta").init_cache(
            b, s + steps), mesh, b)
        d = mesh.get_local_rank("data")
        mine = toks.chunk(C.MESH[0])[d]
        pplan = param_shardings(axes, params, mesh)
        dplan = param_shardings(axes, params, mesh, fsdp=False, moe_2d=True)
        logits, cache = make_prefill_step(
            model, param_shardings=pplan, cache_shardings=cache_plan,
            max_len=s + steps)(shard_params(params, pplan),
                               {"tokens": mine[:, :s]})
        got = [logits]
        dec = make_decode_step(model, param_shardings=dplan,
                               cache_shardings=cache_plan)
        dblocks = shard_params(params, dplan)
        for i in range(steps):
            nxt, logits, cache = dec(dblocks, cache, mine[:, s + i:s + i + 1])
            got.append(logits)
            out[f"serve/{family}/next/{i}"] = _np(_gather(
                nxt, mesh, ("data",), 0))
        for i, lg in enumerate(got):
            lg = _gather(_gather(lg, mesh, ("model",), 1), mesh, ("data",),
                         0)
            out[f"serve/{family}/mesh/{i}"] = _np(lg)
        if dist.get_rank() == 0:
            lg, cache = model.prefill(params, {"tokens": toks[:, :s]},
                                      max_len=s + steps)
            out[f"serve/{family}/one/0"] = _np(lg)
            for i in range(steps):
                lg, cache = model.decode_step(params, cache,
                                              toks[:, s + i:s + i + 1])
                out[f"serve/{family}/one/{i + 1}"] = _np(lg)


def serve_ref_checks(mesh, out: dict, arch: str = C.DP_ARCHS["dense"],
                     key: str = "serve_ref") -> None:
    """``SERVE_REF``'s cases (the reference's side:
    ``torch_mesh_ranks_ref.serve_ref``): prefill under the training plan
    and decode steps under the serving plan, the cache held as
    ``cache_pspecs`` lays it out (head_dim over 'model'; at B = 1 the
    sequence over 'data' too, every rank holding the whole batch), each
    step's logits gathered over the mesh, under ``key``; rank 0 also runs
    the unsharded model."""
    cfg = _smoke(arch)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(C.DP_SEED))
    axes = model.logical_axes()
    pplan = param_shardings(axes, params, mesh)
    dplan = param_shardings(axes, params, mesh, fsdp=False, moe_2d=True)
    pblocks, dblocks = shard_params(params, pplan), shard_params(params, dplan)
    for case, (b, s, steps) in C.SERVE_REF.items():
        toks = torch.from_numpy(C.serve_tokens(b, s + steps, cfg.vocab))
        cache_plan = cache_pspecs(Model(cfg, "meta").init_cache(
            b, C.SERVE_LEN), mesh, b)
        split = b % C.MESH[0] == 0  # the batch over 'data', else whole
        baxes = ("data",) if split else ()
        mine = toks.chunk(C.MESH[0])[mesh.get_local_rank("data")] \
            if split else toks
        logits, cache = make_prefill_step(
            model, param_shardings=pplan, cache_shardings=cache_plan,
            max_len=C.SERVE_LEN, batch_axes=baxes)(
                pblocks, {"tokens": mine[:, :s]})
        got = [logits]
        dec = make_decode_step(model, param_shardings=dplan,
                               cache_shardings=cache_plan, batch_axes=baxes)
        for i in range(steps):
            _, logits, cache = dec(dblocks, cache, mine[:, s + i:s + i + 1])
            got.append(logits)
        held = cache_plan["layers"][0]
        held = held["ssm"] if isinstance(held, dict) else held
        out[f"{key}/{case}/held"] = np.asarray(str(tuple(
            held.state if hasattr(held, "state") else held.k)))
        for i, lg in enumerate(got):
            lg = _gather(lg, mesh, ("model",), 1)
            if split:
                lg = _gather(lg, mesh, ("data",), 0)
            out[f"{key}/{case}/mesh/{i}"] = _np(lg)
        if dist.get_rank() == 0:
            lg, cache = model.prefill(params, {"tokens": toks[:, :s]},
                                      max_len=C.SERVE_LEN)
            out[f"{key}/{case}/one/0"] = _np(lg)
            for i in range(steps):
                lg, cache = model.decode_step(params, cache,
                                              toks[:, s + i:s + i + 1])
                out[f"{key}/{case}/one/{i + 1}"] = _np(lg)


def sp_checks(mesh, rank: int, out: dict) -> None:
    """``SP_ARCHS``' smoke configurations on the mesh, the residual stream
    sequence parallel (32 positions, 8 a rank): the blocked train step's
    metrics (remat full) and the logits of a prefill of 16 positions and
    two decode steps gathered over the mesh; rank 0 also runs them
    without a mesh."""
    b, s, t = C.DP_BATCH, C.DP_SEQ, C.SERVE_LEN
    d = mesh.get_local_rank("data")
    for family, arch in C.SP_ARCHS.items():
        cfg = _smoke(arch)
        if family in C.SP_HEADS:
            h = C.SP_HEADS[family]
            cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=h)
        model = Model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(C.DP_SEED))
        gen = torch.Generator().manual_seed(2)
        batch = {k: torch.randint(1, cfg.vocab, (b, s), generator=gen,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            batch["frames"] = (torch.randn(b, s, cfg.d_model, generator=gen)
                               * 0.5).to(torch.bfloat16)
        if cfg.family == "vlm":
            batch["vision_embeds"] = (torch.randn(
                b, C.SP_VISION, cfg.d_model, generator=gen) * 0.5).to(
                    torch.bfloat16)
        axes = model.logical_axes()
        plan = param_shardings(axes, params, mesh)
        dplan = param_shardings(axes, params, mesh, fsdp=False, moe_2d=True)
        blocks = shard_params(params, plan)
        tc = TrainConfig(warmup_steps=2, remat="full")
        mine = {k: v.chunk(C.MESH[0])[d] for k, v in batch.items()}
        runs = {"mesh": make_train_step(model, tc, param_shardings=plan)(
            blocks, adamw_init(blocks), mine)[2]}
        prompt = {k: v[:, :16] if k in ("tokens", "frames") else v
                  for k, v in batch.items() if k != "labels"}
        enc = prompt.get("frames", prompt["tokens"]).shape[1]
        cplan = cache_pspecs(Model(cfg, "meta").init_cache(b, t, enc), mesh,
                             b)
        logits, cache = make_prefill_step(
            model, param_shardings=plan, cache_shardings=cplan, max_len=t)(
                blocks, {k: v.chunk(C.MESH[0])[d] for k, v in prompt.items()})
        got = [logits]
        dec = make_decode_step(model, param_shardings=dplan,
                               cache_shardings=cplan)
        dblocks = shard_params(params, dplan)
        for i in range(2):
            _, logits, cache = dec(dblocks, cache, mine["tokens"][
                :, 16 + i:17 + i])
            got.append(logits)
        for i, lg in enumerate(got):
            if lg.shape[-1] < cfg.vocab_padded:  # the vocabulary's block
                lg = _gather(lg, mesh, ("model",), 1)
            out[f"sp/{family}/mesh/logits/{i}"] = _np(
                _gather(lg, mesh, ("data",), 0)[:, :cfg.vocab])
        if rank == 0:
            runs["one"] = make_train_step(model, tc)(
                params, adamw_init(params), batch)[2]
            lg, cache = model.prefill(params, prompt, max_len=t)
            out[f"sp/{family}/one/logits/0"] = _np(lg[:, :cfg.vocab])
            for i in range(2):
                lg, cache = model.decode_step(
                    params, cache, batch["tokens"][:, 16 + i:17 + i])
                out[f"sp/{family}/one/logits/{i + 1}"] = _np(
                    lg[:, :cfg.vocab])
        for run, metrics in runs.items():
            for m in ("loss", "ce"):
                out[f"sp/{family}/{run}/{m}"] = _np(metrics[m])


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
    dp_checks(mesh, rank, out)
    compress_checks(mesh, out)
    vocab_checks(mesh, out)
    serve_checks(mesh, out)
    serve_ref_checks(mesh, out)
    for family, arch in C.SSD_ARCHS.items():
        serve_ref_checks(mesh, out, arch, f"serve_ssd/{family}")
    sp_checks(mesh, rank, out)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(dest / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
