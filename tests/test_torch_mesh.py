"""The port's multi-card layer in one process, no ranks: the sharding plan,
the logical axes, the meta-device specs and the roofline arithmetic
against the JAX package's, for every registry configuration.

* The plan (``param_pspecs`` with fsdp on and off and with ``moe_2d``,
  ``batch_pspec``, ``cache_pspecs``) equals the reference's entry for
  entry on (16, 16) and (2, 16, 16); the reference runs over
  ``jax.sharding.AbstractMesh``, the port over ``MeshShape``.
* ``Model.logical_axes`` equals the reference's ``Model.init(key)[1]``.
* ``input_specs``, ``state_specs`` and ``cache_specs`` have the
  reference's ``ShapeDtypeStruct`` shapes and dtypes on every
  configuration x ``SHAPES`` cell, on the meta device.
* ``model_flops`` and ``_model_traffic`` equal the reference's to
  ``rtol=1e-12`` (the same float arithmetic).
* ``shard_ctx`` is a no-op outside a scope; ``make_local_mesh()`` raises
  without a card unless ``device=`` is given.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import SHAPES, get_config, list_archs
from repro.distributed import sharding as rsh
from repro.launch import roofline as rroof
from repro.launch import specs as rspecs
from repro.models import build_model as r_build_model

from repro_torch import configs as tcfg
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import shard_ctx
from repro_torch.models.model import Model

ARCHS = list_archs()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _port_leaves(tree, path=""):
    """(path, leaf) in ``jax.tree_util``'s order: dict keys sorted, tuples
    and NamedTuples in order; axes tuples and specs are leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], f"{path}['{k}']")
    elif isinstance(tree, tuple) and not _is_axes(tree) and not isinstance(
            tree, tsh.PartitionSpec):
        for i, t in enumerate(tree):
            yield from _port_leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


def _ref_leaves(tree, is_leaf=None):
    return jax.tree_util.tree_leaves(tree, is_leaf=is_leaf)


@functools.lru_cache(maxsize=None)
def ref_state(arch):
    return rspecs.state_specs(r_build_model(get_config(arch)))


@functools.lru_cache(maxsize=None)
def port_state(arch):
    return tspecs.state_specs(Model(tcfg.get_config(arch), "meta"))


def _same_specs(got, want):
    """Leaf by leaf, each port spec's entries equal the reference's."""
    want = _ref_leaves(want, is_leaf=lambda x: isinstance(x, JP))
    got = list(_port_leaves(got))
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        assert isinstance(g, tsh.PartitionSpec), path
        assert tuple(g) == tuple(w), (path, g, w)


def _same_shapes(got, want):
    want = _ref_leaves(want)
    got = list(_port_leaves(got))
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        assert g.device.type == "meta", path  # allocates nothing
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    rmesh, tmesh = AbstractMesh(sizes, names), tsh.MeshShape(sizes, names)
    params, _, axes = ref_state(arch)
    tparams, _, taxes = port_state(arch)
    for kw in (dict(), dict(fsdp=False), dict(moe_2d=True)):
        _same_specs(tsh.param_pspecs(taxes, tparams, tmesh, **kw),
                    rsh.param_pspecs(axes, params, rmesh, **kw))
    plan = tsh.param_shardings(taxes, tparams, tmesh)
    leaf = plan["embed"]["table"]
    assert isinstance(leaf, tsh.NamedSharding) and len(leaf.placements) \
        == len(names)
    for shape_name, shape in SHAPES.items():
        b = shape.global_batch
        assert tuple(tsh.batch_pspec(b, tmesh)) == tuple(
            rsh.batch_pspec(b, rmesh)), (shape_name, b)
        if shape.kind != "decode":
            continue
        cache = rspecs.cache_specs(r_build_model(get_config(arch)), shape)
        tcache = tspecs.cache_specs(Model(tcfg.get_config(arch), "meta"),
                                    shape)
        _same_specs(tsh.cache_pspecs(tcache, tmesh, b),
                    rsh.cache_pspecs(cache, rmesh, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_and_state_specs_match_reference(arch):
    params, opt, axes = ref_state(arch)
    tparams, topt, taxes = port_state(arch)
    got = list(_port_leaves(taxes))
    want = _ref_leaves(axes, is_leaf=_is_axes)
    assert [g for _, g in got] == want
    _same_shapes(tparams, params)
    _same_shapes((topt.m, topt.v, topt.step), (opt.m, opt.v, opt.step))
    # the axes come from the same init code as the parameters
    assert [p for p, _ in got] == [p for p, _ in _port_leaves(tparams)]


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    tc = tcfg.get_config(arch)
    _same_shapes(tspecs.input_specs(tc, tcfg.SHAPES[shape_name]),
                 rspecs.input_specs(cfg, shape))
    _same_shapes(tspecs.cache_specs(Model(tc, "meta"),
                                    tcfg.SHAPES[shape_name]),
                 rspecs.cache_specs(r_build_model(cfg), shape))
    assert tspecs.VISION_TOKENS == rspecs.VISION_TOKENS


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_traffic_match_reference(arch):
    for shape_name in SHAPES:
        np.testing.assert_allclose(troof.model_flops(arch, shape_name),
                                   rroof.model_flops(arch, shape_name),
                                   rtol=1e-12)
        rec = {"arch": arch, "shape": shape_name,
               "params": get_config(arch).param_count()}
        np.testing.assert_allclose(troof._model_traffic(rec),
                                   rroof._model_traffic(rec), rtol=1e-12)


def test_roofline_reads_a_record_with_the_cards_peaks():
    """The same record through both: the useful-FLOP ratio is the
    reference's; the times scale by the peaks' ratios."""
    rec = {"arch": "gemma-2b", "shape": "train_4k", "status": "ok",
           "params": get_config("gemma-2b").param_count(),
           "probe": {"flops": 3.0e18, "bytes accessed": 2.0e15},
           "collectives": {"total_link_bytes": 4.0e10,
                           "all-gather": {"count": 3, "bytes": 1.0}},
           "memory": {"temp_size_in_bytes": 2**31}, "cost": {},
           "devices": 256}
    got, want = troof.roofline_terms(rec), rroof.roofline_terms(rec)
    assert got["model_flops"] == want["model_flops"]
    assert got["useful_ratio"] == want["useful_ratio"]
    np.testing.assert_allclose(got["compute_s"] * troof.PEAK_FLOPS,
                               want["compute_s"] * rroof.PEAK_FLOPS)
    np.testing.assert_allclose(got["mem_model_s"] * troof.HBM_BW,
                               want["mem_model_s"] * rroof.HBM_BW)
    assert got["coll_by_op"] == want["coll_by_op"]
    assert "gemma-2b" in troof.to_markdown([got])


def test_shard_ctx_is_a_no_op_outside_a_scope():
    x = torch.randn(2, 4, 8)
    assert shard_ctx.current_mesh() is None
    assert shard_ctx.constrain(x, "dp", None, "model") is x
    q, k, v = shard_ctx.constrain_heads(x, x, x)
    assert q is x and k is x and v is x
    assert shard_ctx.constrain_m(None, x, "dp", None, None) is x
    mesh = tsh.MeshShape((2, 4), ("data", "model"))
    with shard_ctx.shard_scope(mesh, batch_axes=("data",)):
        assert shard_ctx.current_mesh() is mesh
        assert shard_ctx.batch_axes() == ("data",)
        assert shard_ctx.constrain(x, "dp", None, "model") is x  # a layout
    assert shard_ctx.current_mesh() is None and shard_ctx.batch_axes() == ()


def test_make_local_mesh_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh(1, 1)
