"""The reference's side of ``tests/test_torch_mesh_ranks.py`` (not a test
file):

    python tests/torch_mesh_ranks_ref.py OUT

runs the JAX package on 8 forced host devices (``XLA_FLAGS`` set before
``import jax``, as ``tests/test_moe_ep.py`` does) over the inputs of
``tests/torch_mesh_common.py`` and writes ``OUT/ref.npz``: each shard by
its device's mesh coordinates.  The data-parallel step's weights are the
port's ``Model.init`` draw, carried across, so it imports ``repro_torch``
for them too.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import torch_mesh_common as C  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro.data.pipeline import TokenStream, sharded_batches  # noqa: E402
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.moe import _shard_map, moe_ffn_ep  # noqa: E402
from repro.optim import adamw_init, compressed_psum  # noqa: E402
from repro.optim.compress import _q  # noqa: E402


def _np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def coords(mesh, device) -> tuple:
    return tuple(int(i) for i in np.argwhere(mesh.devices == device)[0])


def moe_ref(mesh, out: dict) -> None:
    for case in C.MOE_CASES:
        params, x, cf = C.moe_inputs(case)
        cfg = ModelConfig(**C.MOE, capacity_factor=cf)
        p = {k: jnp.asarray(v) if k == "router"
             else jnp.asarray(v).astype(jnp.bfloat16)
             for k, v in params.items()}
        y, aux = jax.jit(lambda p, x: moe_ffn_ep(p, x, cfg, mesh))(
            p, jnp.asarray(x).astype(jnp.bfloat16))
        out[f"moe/{case}/y"] = _np(y)
        out[f"moe/{case}/aux"] = _np(aux)


def psum_ref(out: dict) -> None:
    mesh8 = jax.make_mesh((C.RANKS,), ("x",))
    grads, err = C.psum_inputs()
    g = jax.tree.map(jnp.asarray, grads)
    g["b"] = g["b"].astype(jnp.bfloat16)
    e = jax.tree.map(jnp.asarray, err)

    def wire(g, e):  # the payload and its sum, as compressed_psum makes them
        def one(g, e):
            gf = g.astype(jnp.float32) + e
            _, s = _q(gf)
            s_max = jax.lax.pmax(s, "x")
            q = jnp.clip(jnp.round(gf / s_max), -127, 127).astype(jnp.int8)
            return q, jax.lax.psum(q.astype(jnp.int32), "x")
        return jax.tree.map(one, g, e)

    mean, new_err = jax.jit(_shard_map(
        lambda g, e: compressed_psum(g, e, "x"), mesh=mesh8,
        in_specs=(P("x"), P("x")), out_specs=(P(), P("x"))))(g, e)
    qt = jax.jit(_shard_map(wire, mesh=mesh8, in_specs=(P("x"), P("x")),
                            out_specs=P("x")))(g, e)
    for (name, m), (_, ne) in zip(_leaves(mean), _leaves(new_err)):
        out[f"psum{name}/mean"] = _np(m)  # replicated: one copy
        out[f"psum{name}/err"] = _np(ne)  # the 8 blocks along dim 0
    pairs = {"/a": qt["a"], "/b": qt["b"], "/c/w": qt["c"]["w"]}
    for name, (q, total) in pairs.items():
        out[f"psum{name}/q"] = _np(q)  # the 8 blocks along dim 0
        out[f"psum{name}/total"] = _np(total)  # each device's copy, stacked


def batch_ref(mesh, out: dict) -> None:
    stream = TokenStream(**C.STREAM)
    for name, spec in C.BATCH_SPECS.items():
        for step in C.STREAM_STEPS:
            batch = next(sharded_batches(stream, mesh, P(*spec),
                                         start_step=step))
            for k, arr in batch.items():
                for shard in arr.addressable_shards:
                    c = coords(mesh, shard.device)
                    out[f"batch/{name}/{step}/{k}/{c[0]}{c[1]}"] = _np(
                        shard.data)


def dp_ref(mesh, out: dict) -> None:
    """The reference's one program with its plan on the (data, model)
    mesh: the model's layout pins installed (``set_mesh``), the
    parameters ``device_put`` with ``param_shardings`` and the step jitted
    with them (``make_train_step(param_shardings=)``)."""
    import torch

    from repro.distributed.sharding import param_shardings
    from repro.launch.specs import state_specs
    from repro_torch import configs as tcfg
    from repro_torch.models.model import Model

    for family, arch in C.DP_ARCHS.items():
        cfg, tc = get_smoke(arch), tcfg.get_smoke(arch)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
            tc = dataclasses.replace(tc, capacity_factor=8.0)
        tparams = Model(tc, "cpu").init(
            torch.Generator().manual_seed(C.DP_SEED))
        shapes, _, axes = state_specs(build_model(cfg))
        plan = param_shardings(axes, shapes, mesh)
        params = jax.device_put(_tree(tparams), plan)
        batch = {k: jnp.asarray(v) for k, v in TokenStream(
            vocab=cfg.vocab, seq_len=C.DP_SEQ,
            global_batch=C.DP_BATCH).batch(0).items()}
        model = build_model(cfg).set_mesh(mesh)
        step = jax.jit(make_train_step(model, TrainConfig(warmup_steps=2),
                                       param_shardings=plan))
        p, opt, metrics = step(params, adamw_init(params), batch)
        key = f"dp/{family}/ref"
        for m in ("loss", "ce", "grad_norm", "lr"):
            out[f"{key}/{m}"] = _np(metrics[m])
        for tree, name in ((p, "params"), (opt.m, "m"), (opt.v, "v")):
            for path, t in _leaves(tree):
                out[f"{key}/{name}{path}"] = _np(t)


def serve_ref(mesh, out: dict, arch: str = C.DP_ARCHS["dense"],
              key: str = "serve_ref") -> None:
    """The reference's prefill (the plan of ``param_shardings``, the cache
    laid out by ``cache_pspecs``) and ``make_decode_step`` (the serving
    layout: ``fsdp=False, moe_2d=True``), each jitted with its shardings as
    its dry run lowers them, on ``SERVE_REF``'s cases: the logits of the
    prefill and of each decode step, under ``key``."""
    import torch
    from jax.sharding import NamedSharding

    from repro.distributed.sharding import (
        batch_pspec, cache_pspecs, param_pspecs, param_shardings)
    from repro.launch.specs import state_specs
    from repro.launch.steps import make_decode_step
    from repro_torch import configs as tcfg
    from repro_torch.models.model import Model

    cfg = get_smoke(arch)
    tparams = Model(tcfg.get_smoke(arch), "cpu").init(
        torch.Generator().manual_seed(C.DP_SEED))
    shapes, _, axes = state_specs(build_model(cfg))
    model = build_model(cfg).set_mesh(mesh)

    def named(specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    pplan = param_shardings(axes, shapes, mesh)
    dplan = named(param_pspecs(axes, shapes, mesh, fsdp=False, moe_2d=True))

    for case, (b, s, steps) in C.SERVE_REF.items():
        toks = jnp.asarray(C.serve_tokens(b, s + steps, cfg.vocab))
        c_sh = named(cache_pspecs(jax.eval_shape(
            lambda: model.init_cache(b, C.SERVE_LEN)), mesh, b))
        tok_sh = NamedSharding(mesh, batch_pspec(b, mesh))
        prefill = jax.jit(
            lambda p, t: model.prefill(p, {"tokens": t},
                                       max_len=C.SERVE_LEN),
            in_shardings=(pplan, tok_sh), out_shardings=(None, c_sh))
        decode = jax.jit(make_decode_step(model),
                         in_shardings=(dplan, c_sh, tok_sh),
                         out_shardings=(None, None, c_sh))
        params = jax.device_put(_tree(tparams), pplan)
        logits, cache = prefill(params, toks[:, :s])
        out[f"{key}/{case}/0"] = _np(logits)
        params = jax.device_put(params, dplan)
        for i in range(steps):
            _, logits, cache = decode(params, cache, toks[:, s + i:s + i + 1])
            out[f"{key}/{case}/{i + 1}"] = _np(logits)


def _tree(t):
    import torch

    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def main() -> int:
    dest = Path(sys.argv[1])
    mesh = jax.make_mesh(C.MESH, ("data", "model"))
    out = {}
    moe_ref(mesh, out)
    psum_ref(out)
    batch_ref(mesh, out)
    # the one program's layout left to XLA's partitioner (Auto axes), as
    # the reference's launchers make their meshes
    auto = jax.make_mesh(C.MESH, ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    dp_ref(auto, out)
    serve_ref(auto, out)
    for family, arch in C.SSD_ARCHS.items():
        serve_ref(auto, out, arch, f"serve_ssd/{family}")
    np.savez(dest / "ref.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
