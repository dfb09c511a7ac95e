"""The port's dry run (``repro_torch.launch.dryrun``, ``patch_probe``,
``report``) against the reference's counts, and the tracing repairs it
needs.

The probe's FLOPs (``FlopCounterMode`` over the step on meta tensors) are
held against the reference's ``jax.make_jaxpr`` of the same step at the
same smoke configuration, where every ``dot_general`` counts 2 x its
output x its contracted size (a scan body times its length, the larger
branch of a ``cond``) and B5's ``pallas_call`` 4 B H T hd.  They agree
exactly but for the gaps of ``DIVERGENCES``, each an exact term with its
cause.  The dry run itself runs on a fake (2, 4) mesh (a ``fake`` process
group of 8 ranks in this process, destroyed after each test), and on the
full-size (16, 16) mesh for one cheap cell.

``repro.launch.dryrun`` and ``repro.launch.patch_probe`` set ``XLA_FLAGS``
when imported; this file imports neither (``tests/test_torch_exports.py``
restores the variable around its import).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import TrainConfig, get_smoke, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, patch_probe, report, roofline
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.specs import cache_specs, input_specs, state_specs
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model

B = 2  # the probe comparisons' batch
MESH = (2, 4)  # the fake (data, model) mesh of the dry-run tests
NAME = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _cfg(arch: str, s: int):
    """The smoke configuration, its learned position table long enough for
    ``s`` (whisper's smoke table has 128 rows)."""
    cfg = get_smoke(arch)
    if cfg.pos == "learned" and cfg.max_pos < s:
        cfg = dataclasses.replace(cfg, max_pos=s)
    return cfg


@pytest.fixture(autouse=True)
def _no_group_left():
    """Every fake world is destroyed by the code that made it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group was left up")


# ------------------------------------------------------- the reference
def _ref_count(jaxpr) -> tuple:
    """(FLOPs, of which contraction-free) of a jaxpr: ``dot_general``
    2 x out x contracted (a ``dot_general`` with no contracting dim is an
    elementwise product XLA counts as FLOPs), B5's ``pallas_call`` by the
    port's formula, scan bodies x length, the larger ``cond`` branch."""
    from jax.extend import core as jcore

    total = free = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            a = e.invars[0].aval.shape
            n = 2 * int(np.prod(e.outvars[0].aval.shape))
            n *= int(np.prod([a[i] for i in lc])) if lc else 1
            total += n
            free += 0 if lc else n
        elif name == "pallas_call":  # (needed, cur, q, k, v, pos)
            b, kv, g, hd = e.invars[2].aval.shape
            total += 4 * b * kv * g * e.invars[3].aval.shape[1] * hd
        elif name == "scan":
            t, f = _ref_count(e.params["jaxpr"].jaxpr)
            total += e.params["length"] * t
            free += e.params["length"] * f
        elif name == "cond":
            t, f = max(_ref_count(b.jaxpr) for b in e.params["branches"])
            total += t
            free += f
        else:
            for v in e.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        sub = sub.jaxpr
                    if isinstance(sub, jcore.Jaxpr):
                        t, f = _ref_count(sub)
                        total += t
                        free += f
    return total, free


def _ref_flops(arch: str, kind: str, s: int) -> tuple:
    import jax

    from repro.configs import TrainConfig as RTC, get_smoke as rsmoke
    from repro.configs.base import ShapeConfig as RShape
    from repro.launch import specs, steps
    from repro.models import build_model as rbuild

    cfg = rsmoke(arch)
    if cfg.pos == "learned" and cfg.max_pos < s:
        cfg = dataclasses.replace(cfg, max_pos=s)
    model = rbuild(cfg)
    params, opt, _ = specs.state_specs(model)
    shape = RShape("x", s, B, kind)
    batch = specs.input_specs(cfg, shape)
    if kind == "train":
        step = steps.make_train_step(model, RTC(remat="full"), unroll=True)
        jx = jax.make_jaxpr(step)(params, opt, batch)
    elif kind == "prefill":
        jx = jax.make_jaxpr(steps.make_prefill_step(model, unroll=True))(
            params, batch)
    else:
        jx = jax.make_jaxpr(steps.make_decode_step(model))(
            params, specs.cache_specs(model, shape), batch["tokens"])
    return _ref_count(jx.jaxpr)


def _port_flops(arch: str, kind: str, s: int) -> int:
    shape = ShapeConfig(NAME[kind], s, B, kind)
    return int(patch_probe.probe_cell(arch, shape.name, cfg=_cfg(arch, s),
                                      shape=shape)["flops"])


# ------------------------------------------------- the gaps, each exact
def _p26(cfg, s):
    """P26: the card's logit gradient (``layers._LogitsF32``, the meta
    device's route too) multiplies the f32 side split into three bf16
    parts, so its two products count 3x: 2 x 2 x (2 B S d V) more."""
    return 8 * B * s * cfg.d_model * cfg.vocab_padded


def _in_proj(cfg, s):
    """The reference's ``mamba2_full(return_state=True)`` projects the
    input twice a layer (``repro/models/mamba2.py:170``); the port keeps
    the first projection's conv inputs."""
    width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    return cfg.n_layers * 2 * B * s * cfg.d_model * width


def _qkv(cfg, s, layers):
    """One more q/k/v projection a layer in the reference (``_project_qkv``
    in its hybrid prefill body, ``fill_kv`` in its ``_prime_cache``); the
    port takes K/V from the one ``attn_full``."""
    width = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    return layers * 2 * B * s * cfg.d_model * width


def _conv(cfg):
    """The reference's decode conv is an einsum (``bkc,kc->bc``); the port
    multiplies and sums in f32 (ROADMAP §C P22), which counts nothing."""
    channels = cfg.d_inner + 2 * cfg.ssm_state
    return cfg.n_layers * 2 * B * channels * cfg.ssm_conv


def _dead_tiles(cfg, s, products):
    """The reference's chunked attention ``lax.cond``s each (512, 1024)
    tile and the count takes the computing branch of the dead ones too;
    the port skips them.  ``products``: the tile products a dead tile
    carries (forward 2; a remat-full train step 17 over the forward, its
    recomputation and the two backward passes)."""
    nq, nk = s // 512, s // 1024
    dead = sum(k * 1024 > (q + 1) * 512 - 1 for q in range(nq)
               for k in range(nk))
    return (cfg.n_layers * dead * products
            * 2 * B * cfg.n_heads * 512 * 1024 * cfg.head_dim)


def _ssd_train(cfg, s):
    """Beyond its contraction-free products, the reference's backward of
    the SSD's ``scores x L`` product (``bcts,bchts,bcshp->bcthp``) counts
    one more [B, c, h, cl, cl] product a pass (forward, recomputation,
    backward) a layer."""
    cl = cfg.ssm_chunk
    return cfg.n_layers * 3 * 2 * B * (s // cl) * cfg.ssm_heads * cl * cl


def _shared_cond(cfg, s):
    """The reference's hybrid prefill runs its shared block under a
    ``lax.cond`` in every layer, and the count takes that branch in all
    ``n_layers`` where it runs after every ``attn_every``-th: the port's
    count of one shared block (on meta tensors) that many times more."""
    model = build_model(cfg, "meta")
    shared = model.init(torch.Generator())["shared"]
    x = torch.empty(B, s, cfg.d_model, dtype=torch.bfloat16, device="meta")
    pos = torch.arange(s, device="meta")[None].expand(B, s)
    with FlopCounterMode(display=False) as counter:
        model._shared_block(shared, x, pos, None)
    extra = cfg.n_layers - cfg.n_layers // cfg.attn_every
    return extra * counter.get_total_flops()


SSD = ("jnp splits the SSD's three-operand einsums (repro/models/"
       "mamba2.py:137,141,157) into contraction-free products the port does "
       "elementwise, uncounted (repro_torch/models/mamba2.py:141,145,154)")
# (arch, kind, S): (reference - port as a function of (cfg, S, the
# reference's contraction-free FLOPs), the causes); every train step has
# P26 in it (qwen3-moe's and whisper's at S=128 differ by P26 alone, as
# gemma-2b's; zamba2's decode by mamba2's terms; whisper's prefill by
# _qkv(cfg, S, n_layers), its _prime_cache projecting q/k/v twice)
DIVERGENCES = {
    ("gemma-2b", "train", 128): (
        lambda c, s, free: -_p26(c, s), "P26"),
    ("gemma-2b", "prefill", 2048): (
        lambda c, s, free: _dead_tiles(c, s, 2),
        "the reference counts the chunked attention's dead tiles"),
    ("gemma-2b", "train", 2048): (
        lambda c, s, free: _dead_tiles(c, s, 17) - _p26(c, s),
        "dead tiles in all three passes; P26"),
    ("mamba2-370m", "prefill", 128): (
        lambda c, s, free: free + _in_proj(c, s),
        SSD + "; the reference's second input projection"),
    ("mamba2-370m", "train", 128): (
        lambda c, s, free: free + _ssd_train(c, s) - _p26(c, s),
        SSD + ", and their backward; P26"),
    ("mamba2-370m", "decode", 128): (
        lambda c, s, free: free + _conv(c),
        "mamba2_decode's outer product (contraction-free); its conv"),
    ("zamba2-2.7b", "prefill", 128): (
        lambda c, s, free: (free + _in_proj(c, s) + _shared_cond(c, s)
                            + _qkv(c, s, c.n_layers)),
        SSD + "; the second input projection; the shared block's cond "
        "counted in every layer, with its extra q/k/v projection"),
}

EXACT = [("gemma-2b", "prefill", 128), ("gemma-2b", "decode", 128),
         ("qwen2-vl-72b", "prefill", 256),
         ("qwen3-moe-235b-a22b", "prefill", 128),
         ("whisper-base", "decode", 128)]


@pytest.mark.parametrize("arch,kind,s", EXACT)
def test_probe_equals_reference_dot_general_count(arch, kind, s):
    ref, _ = _ref_flops(arch, kind, s)
    assert _port_flops(arch, kind, s) == ref


@pytest.mark.parametrize("case", sorted(DIVERGENCES), ids=str)
def test_probe_gaps_are_the_named_terms(case):
    arch, kind, s = case
    ref, free = _ref_flops(arch, kind, s)
    gap, why = DIVERGENCES[case]
    assert ref - _port_flops(arch, kind, s) == gap(_cfg(arch, s), s, free), why


# ------------------------------------- every family traces on meta tensors
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_family_steps_on_the_meta_device(arch, kind):
    """At S = 1,024 (the chunked attention's threshold) the train, prefill
    and decode steps run on meta tensors under FlopCounterMode: no device
    read (TileTable.of_arange), no bincount, B5 through its operator.
    One layer of each kind (a local and a global one, the hybrid's shared
    block once), and the SSD in 128-long chunks (8 a sequence, where the
    smoke configuration's 16 would loop over 64 chunks a layer)."""
    s = 1024
    cfg = _cfg(arch, s)
    depth = max(cfg.attn_every, cfg.local_global_pattern + 1)
    cfg = dataclasses.replace(cfg, n_layers=depth,
                              encoder_layers=min(cfg.encoder_layers, 1))
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, ssm_chunk=128)
    shape = ShapeConfig(NAME[kind], s, 1, kind)
    model = build_model(cfg, "meta")
    params, opt, _ = state_specs(model)
    batch = input_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            make_train_step(model, TrainConfig())(params, opt, batch)
        elif kind == "prefill":
            make_prefill_step(model)(params, batch)
        else:
            cache = dict(cache_specs(model, shape), len=s - 1)
            _, logits, _ = make_decode_step(model)(params, cache,
                                                   batch["tokens"])
            assert logits.shape == (1, cfg.vocab_padded)
    assert counter.get_total_flops() > 0


# ----------------------------------------------------- the tracing repairs
@pytest.mark.parametrize("s,cq,ck,window", [
    (1024, 512, 1024, 0), (2048, 512, 1024, 0), (4096, 512, 1024, 1024),
    (3072, 512, 1024, 512), (1536, 512, 512, 100)])
def test_tile_table_of_arange_equals_the_device_read(s, cq, ck, window):
    from repro_torch.models.flash import TileTable

    pos = torch.arange(s, dtype=torch.int32)[None].expand(2, s)
    known = TileTable.of_arange(pos, cq, ck)
    read = TileTable(pos, pos, cq, ck)
    for w, causal in ((window, True), (0, True), (window, False)):
        assert np.array_equal(known.live(w, causal), read.live(w, causal))
    assert all(np.array_equal(a, b) for a, b in zip(known.extrema(),
                                                    read.extrema()))


def test_moe_expert_count_is_bincounts():
    from repro_torch.models.moe import _route

    cfg = get_smoke("qwen3-moe-235b-a22b")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, cfg.d_model, generator=gen).bfloat16()
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=gen).bfloat16()
    _, (se_c, slot_c, stok, keep, _, order, idx), _ = _route(x, router, cfg,
                                                            cap=4)
    flat = idx.reshape(-1)
    se = flat[order]
    counts = torch.bincount(se, minlength=cfg.n_experts)
    slot = torch.arange(se.numel()) - (torch.cumsum(counts, 0) - counts)[se]
    assert torch.equal(keep, slot < 4)
    assert torch.equal(slot_c, torch.where(keep, slot, 3))


def test_b5_operator_traces_and_counts():
    from repro_torch.kernels.decode_attn import decode_attention, decode_attn_op

    b, kv, g, hd, t = 2, 2, 4, 64, 256
    meta = dict(device="meta")
    q = torch.empty(b, kv * g, hd, dtype=torch.bfloat16, **meta)
    k = torch.empty(b, t, kv, hd, dtype=torch.bfloat16, **meta)
    pos = torch.empty(b, t, dtype=torch.int32, **meta)
    cur = torch.empty(b, dtype=torch.int32, **meta)
    with FlopCounterMode(display=False) as counter:
        out = decode_attention(q, k, k, pos, cur)
    assert out.shape == (b, kv * g, hd) and out.dtype == torch.float32
    assert counter.get_total_flops() == 4 * b * kv * g * t * hd
    cpu = [torch.zeros(x.shape, dtype=x.dtype) for x in (q, k, k, pos, cur)]
    cpu[0] = cpu[0].reshape(b, kv, g, hd)
    with pytest.raises(NotImplementedError):
        decode_attn_op(*cpu, 0, 128)  # no CPU kernel: nothing falls back
    # under a dispatch mode a CUDA call goes through the operator (here
    # FakeTensorMode's fake kernel; the direct launch would need a card)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = [torch.empty(x.shape, dtype=x.dtype, device="cuda")
                for x in (q, k, k, pos, cur)]
        assert decode_attention(*fake).shape == (b, kv * g, hd)
    k32 = torch.empty(b, t, kv, 32, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError):  # the fake kernel checks the shapes
        decode_attn_op(q.reshape(b, kv, g, hd), k32, k32, pos, cur, 0, 128)


def test_fake_mesh_refuses_a_second_group():
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    try:
        assert dist.get_backend() == "fake" and dist.get_world_size() == 8
        assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == {
            "data": 2, "model": 4}
        with pytest.raises(RuntimeError):
            make_fake_mesh((2,), ("data",))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------- the dry run on (2, 4)
def _cell(arch, kind, s=128, b=8):
    shape = ShapeConfig(NAME[kind], s, b, kind)
    return dryrun.run_cell(arch, shape.name, False, cfg=_cfg(arch, s),
                           shape=shape, mesh_shape=MESH)


@pytest.fixture(scope="module")
def train_record():
    return _cell("gemma-2b", "train")


def _whole_kv_flops(cfg, tokens: int, passes: int) -> int:
    """FLOPs of the k and v projections of ``tokens`` tokens over every
    layer, run ``passes`` times.  Where the kv heads do not divide 'model'
    every rank computes them whole (``attention._project_qkv``); every
    other product of a dense layer runs on the rank's 'model' block."""
    return (passes * cfg.n_layers * 2
            * 2 * tokens * cfg.d_model * cfg.n_kv_heads * cfg.head_dim)


def _gathered_numel(arch: str) -> tuple:
    """(leaves gathered over 'data' on use in a layer, the f32 words of
    their gradients' reduce-scatters in a microbatch) of the smoke
    configuration on MESH: each use gathers a leaf's 'data' dim and keeps
    its 'model' block; the tied table is used twice (embed, unembed)."""
    from repro_torch.distributed.sharding import MeshShape, param_pspecs

    model = build_model(get_smoke(arch), "meta")
    params, _, axes = state_specs(model)
    specs = param_pspecs(axes, params, MeshShape(MESH, ("data", "model")))
    flat = zip(torch.utils._pytree.tree_leaves(params),
               torch.utils._pytree.tree_leaves(
                   specs, is_leaf=lambda x: isinstance(x, tuple)))
    layer = words = 0
    for t, spec in flat:
        if "data" not in spec:
            continue
        per = t.numel() // (MESH[1] if "model" in spec else 1)
        if spec[0] is None:  # a stacked leaf: one use a layer
            layer += t.shape[0]
        words += per * (2 if t.shape[0] == get_smoke(arch).vocab_padded
                        else 1)
    return layer, words


def test_data_parallel_step_all_reduces_f32_gradients(train_record):
    """The blocked step's collectives: every leaf gathered over 'data' on
    use (again in the remat recompute: ZeRO-3's backward), its gradient
    reduce-scattered over 'data' in f32 (one a use), and over 'data'
    nothing else but four f32 all-reduces (the loss, the ce and two groups
    of the gradient norm's squares).  Over 'model', sequence parallelism
    (128 positions, a block of 32 a rank): the stream gathered in bf16
    before each column-parallel sublayer and the unembedding, the
    row-parallel sums reduce-scattered in f32, and the transposes of both
    in the backward; all-reduces for the embedding's rows, the
    vocabulary's max, sum and label logit, the kv heads' gradients (one
    kv head, computed whole), the stream norms' gradients (each rank
    normed its block) and the norm."""
    coll = train_record["collectives"]
    mb = train_record["microbatches"]
    layer, words = _gathered_numel("gemma-2b")
    uses = layer + 3  # + the table twice and the final norm
    data, model = coll["by_dim"]["data"], coll["by_dim"]["model"]
    assert data["ops"]["reduce-scatter"] == {"bytes": mb * 4 * words,
                                             "link_bytes": mb * 2 * words,
                                             "count": mb * uses}
    assert data["ops"]["all-gather"]["count"] == mb * (2 * layer + 3)
    assert data["size"] == 2 and model["size"] == 4
    assert data["ops"]["all-reduce"] == {"bytes": 4 * 4, "link_bytes": 4 * 4,
                                         "count": 4}
    assert set(data["ops"]) == {"all-gather", "reduce-scatter", "all-reduce"}
    assert coll["all-to-all"]["count"] == 0
    assert train_record["devices"] == 8 and train_record["mesh"] == "2x4"
    # a microbatch of rank 0: 2 rows of 128 positions, d = 64; L layers
    cfg = get_smoke("gemma-2b")
    n = cfg.n_layers
    rows = 2 * 128 * cfg.d_model
    ops = model["ops"]
    assert set(ops) == {"all-gather", "reduce-scatter", "all-reduce"}
    # gathers (a bf16 block of 32 positions): attention's and the MLP's
    # inputs in the forward and the recompute, the unembedding's; the
    # transposes of the row-parallel sums and of the embedding's split
    assert ops["all-gather"] == {"bytes": mb * (6 * n + 2) * rows // 4 * 2,
                                 "link_bytes": mb * (6 * n + 2) * rows * 2
                                 * 3 // 4, "count": mb * (6 * n + 2)}
    # f32 reduce-scatters: the two row-parallel sums in the forward, the
    # attention's again in the recompute (it feeds the MLP; the MLP's
    # down projection and its sum are not recomputed), the transposes of
    # the sublayers' and the unembedding's gathers
    assert ops["reduce-scatter"]["count"] == mb * (5 * n + 1)
    assert ops["reduce-scatter"]["bytes"] == mb * (5 * n + 1) * rows * 4
    # all-reduces: the embedding, the three of the cross entropy; the
    # backward's k and v gradients, ln1 and ln2, the final norm; the norm
    assert ops["all-reduce"]["count"] == mb * (4 + 4 * n + 1) + 1
    # rank 0 runs half the batch; of it, the kv projections whole (one kv
    # head on a 4-way 'model'; forward, recompute, the input's and the
    # weight's gradient) and every other product over a quarter of its
    # heads, ffn columns or vocabulary rows; the recompute stops before the
    # down projection, as the probe's does:
    # flops = (probe - kv) / (2 * 4) + kv / 2
    assert cfg.n_kv_heads % MESH[1]
    kv = _whole_kv_flops(cfg, 8 * 128, passes=4)
    assert (MESH[0] * MESH[1] * train_record["cost"]["flops"]
            == train_record["probe"]["flops"] + (MESH[1] - 1) * kv)
    mem = train_record["memory"]
    # donated: the parameter and moment blocks are updated in place; the
    # batch block (4 rows of tokens and labels) and the step count are not
    assert mem["alias_size_in_bytes"] == (mem["argument_size_in_bytes"]
                                          - 2 * 4 * 128 * 4 - 4)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_traced_arguments_equal_the_plan_bytes(kind, train_record):
    """A rank's traced arguments are its blocks of the state under the
    plan (the decode cache's too), byte for byte the plan's count."""
    rec = train_record if kind == "train" else _cell("gemma-2b", kind)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == mem["plan_argument_bytes"] > 0


@pytest.mark.parametrize("b", [8, 1])
def test_decode_attends_over_the_held_cache_blocks(b):
    """Decode under the serving plan, gemma-2b's smoke configuration (one
    kv head, head_dim 16 over a 4-way 'model'): the cache stays as
    ``cache_pspecs`` holds it, head_dim over 'model' and, at b = 1, the
    sequence over 'data'; nothing of it is gathered.  A layer moves q to
    the head_dim block and the output back (two all-to-alls), sums the f32
    partial scores ``[B, KV, G, 1, T]`` over 'model', and at b = 1 takes
    the softmax's max and sum and the f32 output over 'data'; B5 does not
    run (its products count over a quarter of the head_dim)."""
    cfg = get_smoke("gemma-2b")
    n, t, h, d = cfg.n_layers, 128, cfg.n_heads, cfg.d_model
    rec = _cell("gemma-2b", "decode", t, b)
    # the batch's block over 'data', else the sequence's
    rows, t_loc = ((b // MESH[0], t) if b % MESH[0] == 0
                   else (b, t // MESH[0]))
    model = rec["collectives"]["by_dim"]["model"]["ops"]
    assert set(model) == {"all-to-all", "all-reduce", "all-gather"}
    scores = rows * h * t_loc * 4
    # + the row-parallel sums of wo and down a layer, the embedding's rows
    assert model["all-reduce"] == {
        "bytes": n * scores + (2 * n + 1) * rows * d * 4,
        "link_bytes": int(n * scores * 3 / 2) + (2 * n + 1) * rows * d * 6,
        "count": 3 * n + 1}
    assert model["all-to-all"] == {"bytes": 2 * n * rows * h * 16 // 4 * 2,
                                   "link_bytes": 2 * n * rows * h * 24 // 4,
                                   "count": 2 * n}
    # the argmax's best logits and their indices, not the cache
    assert model["all-gather"] == {"bytes": rows * 12,
                                   "link_bytes": rows * 36, "count": 2}
    if b == 1:
        data = rec["collectives"]["by_dim"]["data"]["ops"]
        assert set(data) == {"all-reduce"}  # no sequence block moves
        # max and sum [1, KV, G, 1, 1], the output [1, 1, KV, G, hd / 4]
        assert data["all-reduce"] == {"bytes": n * (2 * h * 4 + h * 16),
                                      "link_bytes": n * (2 * h * 4 + h * 16),
                                      "count": 3 * n}
    else:
        assert "data" not in rec["collectives"]["by_dim"]
    # the kv projections whole, every other product over a quarter; at
    # b = 8 of half the batch, at b = 1 the attention's over half the
    # sequence (4 B H T hd, q.k and p.v)
    kv = _whole_kv_flops(cfg, b, passes=1)
    if b % MESH[0] == 0:
        assert (MESH[0] * MESH[1] * rec["cost"]["flops"]
                == rec["probe"]["flops"] + (MESH[1] - 1) * kv)
    else:
        attn = n * 4 * b * h * t * cfg.head_dim
        assert (MESH[0] * MESH[1] * rec["cost"]["flops"]
                == MESH[0] * (rec["probe"]["flops"] - attn
                              + (MESH[1] - 1) * kv) + attn)


def _ssd_whole_flops(cfg, b: int, s: int, passes: int) -> int:
    """FLOPs every rank computes whole on its rows where the SSD mixer
    runs on its heads (ngroups = 1): the B and C columns of the input
    projection, and in a full sequence's chunks C·Bᵀ (``scores``); a pass
    each in the forward (and the recompute), two in the backward."""
    n = cfg.ssm_state
    bc = 2 * b * s * cfg.d_model * 2 * n
    scores = 2 * b * s * cfg.ssm_chunk * n if s > 1 else 0
    return passes * cfg.n_layers * (bc + scores)


@pytest.mark.parametrize("kind,b", [("train", 8), ("prefill", 8),
                                    ("decode", 8), ("decode", 1)])
def test_ssd_mixer_runs_on_the_ranks_heads(kind, b):
    """mamba2's smoke configuration (8 heads of 16, 2 a rank over a 4-way
    'model') under the plan: each layer takes its heads' columns of
    ``in_proj`` and the conv (z, x, dt; B and C whole) by one all-to-all a
    leaf from the plan's blocks (rank 0 holds no B or C column, so it
    sends each column of its blocks once; the backward gives the f32
    gradients of its columns back), sums the gated norm's squares and
    ``out_proj``'s f32 partials over 'model', and moves the SSM state
    between the cache plan's head_dim split and its heads by all-to-alls;
    nothing of the state or of ``in_proj`` is gathered whole.  FLOPs: every
    product over the rank's rows and heads but the B and C terms, whole
    on every rank (:func:`_ssd_whole_flops`)."""
    cfg = get_smoke("mamba2-370m")
    n, d, L = cfg.n_layers, cfg.d_model, 128
    m, dd = MESH[1], MESH[0]
    di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k, ch = cfg.ssm_conv, di + 2 * st
    # rank 0's blocks of in_proj, conv_w and conv_b (bf16) and the f32
    # gradients of its columns (its heads' z, x, dt; B and C whole)
    take = (d * (2 * di + 2 * st + nh) + k * ch + ch) // m * 2
    cols = 2 * di // m + 2 * st + nh // m
    give = (d * cols + (k + 1) * (di // m + 2 * st)) * 4
    rec = _cell("mamba2-370m", kind, L, b)
    assert rec["status"] == "ok"
    ops = rec["collectives"]["by_dim"]["model"]["ops"]
    rows = b // dd if b % dd == 0 else b
    state = rows * nh * (di // nh) * st // m * 4  # a rank's f32 block
    if kind == "train":
        mb = rec["microbatches"]
        r = rows // mb  # a microbatch's rows
        blk = r * L // m * d  # a block of the sequence
        assert ops["all-to-all"] == {"bytes": mb * n * (2 * take + give),
                                     "link_bytes": mb * n * (2 * take + give)
                                     * 3 // 4, "count": mb * 9 * n}
        # SP: the stream gathered (forward, recompute, the row sums'
        # transposes), the unembedding's input, the embedding's transpose
        assert ops["all-gather"] == {"bytes": mb * (3 * n + 2) * blk * 2,
                                     "link_bytes": mb * (3 * n + 2) * blk
                                     * 2 * 3, "count": mb * (3 * n + 2)}
        assert ops["reduce-scatter"] == {
            "bytes": mb * (2 * n + 1) * r * L * d * 4,
            "link_bytes": mb * (2 * n + 1) * r * L * d * 3, "count":
                mb * (2 * n + 1)}
        # the embedding, the cross entropy's three, per layer the norm's
        # squares (forward, recompute, backward), the gradients of A_log,
        # D, dt_bias and ln, the final norm's; the gradient norm's two
        # groups laid over 'model'
        assert ops["all-reduce"]["count"] == mb * (5 + 7 * n) + 2
        passes = 4
    elif kind == "prefill":
        assert ops["all-to-all"] == {"bytes": n * (take + state),
                                     "link_bytes": n * (take + state) * 3
                                     // 4, "count": 4 * n}
        # SP: the stream a layer, the conv tail's x; the last row
        conv = rows * (k - 1) * di // m * 2
        assert ops["all-gather"] == {
            "bytes": n * (rows * L // m * d * 2 + conv) + rows * d * 2,
            "link_bytes": 3 * (n * (rows * L // m * d * 2 + conv)
                               + rows * d * 2), "count": 2 * n + 1}
        assert ops["reduce-scatter"]["count"] == n
        assert ops["all-reduce"] == {
            "bytes": n * rows * L * 4 + rows * L * d * 4,
            "link_bytes": (n * rows * L * 4 + rows * L * d * 4) * 3 // 2,
            "count": n + 1}
        passes = 1
    else:
        # the state there and back, each layer
        assert ops["all-to-all"] == {"bytes": n * (take + 2 * state),
                                     "link_bytes": n * (take + 2 * state)
                                     * 3 // 4, "count": 5 * n}
        # the conv history's channels, the new token's x; the argmax's
        # best logits and their indices
        gathered = n * (rows * (k - 1) * ch // m + rows * di // m) * 2
        assert ops["all-gather"] == {"bytes": gathered + rows * 12,
                                     "link_bytes": 3 * (gathered + rows
                                                        * 12), "count":
                                         2 * n + 2}
        assert ops["all-reduce"] == {
            "bytes": n * (rows * 4 + rows * d * 4) + rows * d * 4,
            "link_bytes": (n * (rows * 4 + rows * d * 4) + rows * d * 4)
            * 3 // 2, "count": 2 * n + 1}
        data = rec["collectives"]["by_dim"].get("data")
        if b % dd == 0:
            assert data is None
        else:  # the state's heads, held over 'data', gathered there
            assert data["ops"] == {"all-gather": {
                "bytes": n * state // dd, "link_bytes": n * state // dd,
                "count": n}}
        passes = 1
    assert set(ops) <= {"all-to-all", "all-gather", "reduce-scatter",
                        "all-reduce"}
    whole = _ssd_whole_flops(cfg, b, L if kind != "decode" else 1, passes)
    split = dd if b % dd == 0 else 1
    assert (split * m * rec["cost"]["flops"]
            == rec["probe"]["flops"] + (m - 1) * whole)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == mem["plan_argument_bytes"]


def test_moe_prefill_all_to_alls_over_model():
    """moe_ffn_ep's dispatch and return: two all-to-alls a layer over
    'model' of the [E, cap, d] bf16 bucket, cap from the tokens of one
    (data, model) block; the leaves' gathers over 'data' and the aux
    loss's all-reduces besides."""
    from repro_torch.models.moe import moe_capacity

    cfg = get_smoke("qwen3-moe-235b-a22b")
    b, s = 8, 128
    rec = _cell("qwen3-moe-235b-a22b", "prefill", s, b)
    coll = rec["collectives"]
    cap = moe_capacity((b // MESH[0]) * (s // MESH[1]), cfg)
    bucket = cfg.n_experts * cap * cfg.d_model * 2
    assert coll["all-to-all"] == {"bytes": 2 * cfg.n_layers * bucket,
                                  "link_bytes": 2 * cfg.n_layers
                                  * int(bucket * 3 / 4),
                                  "count": 2 * cfg.n_layers}
    assert coll["by_dim"]["model"]["size"] == 4
    assert coll["all-gather"]["count"] > 0 and coll["by_dim"]["data"]["size"] == 2


def test_moe_train_over_a_model_dim_is_traced():
    """Expert-parallel training: the exchanges carry their gradient (the
    reverse all-to-all), so the step traces, with the blocks of the plan
    as its arguments: per microbatch four all-to-alls a layer (the
    forward's two, the recompute's two) and two in the backward."""
    rec = dryrun.run_cell("qwen3-moe-235b-a22b", "train_4k", False,
                          microbatches=2,
                          cfg=_cfg("qwen3-moe-235b-a22b", 128),
                          shape=ShapeConfig("train_4k", 128, 8, "train"),
                          mesh_shape=MESH)
    assert rec["status"] == "ok"
    layers = get_smoke("qwen3-moe-235b-a22b").n_layers
    assert rec["collectives"]["all-to-all"]["count"] == 2 * 6 * layers
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == mem["plan_argument_bytes"]


def test_record_reads_in_roofline_and_both_reports(train_record, tmp_path):
    from repro.launch import report as ref_report

    (tmp_path / "gemma-2b__train_4k__pod.json").write_text(
        json.dumps(train_record))
    rows = roofline.analyze(str(tmp_path), "pod")
    assert len(rows) == 1 and rows[0]["hlo_flops"] == \
        train_record["probe"]["flops"]
    assert not rows[0]["flops_fallback"]

    def row(table):
        line = next(r for r in table.splitlines()
                    if r.startswith("| gemma-2b | train_4k |"))
        return [c.strip() for c in line.strip("|").split("|")]

    ours = row(report.dryrun_table(tmp_path, "pod"))
    ref = row(ref_report.dryrun_table(tmp_path, "pod"))
    assert ours[:4] + ours[5:7] == ref[:4] + ref[5:]
    assert len(ours) == len(ref) + 2  # the port's and the plan's args


def test_collective_seconds_by_mesh_dim():
    row = {"link_bytes": 450e9 * 2, "bytes": 0, "count": 1, "size": 2}
    coll = {"by_dim": {"data": row, "model": dict(row, size=4)},
            "total_link_bytes": 4 * 450e9}
    # (2, 4): both dims within one node of 8 cards: NVLink 4, 450 GB/s
    assert roofline._coll_seconds(coll, "2x4") == pytest.approx(4.0)
    # (16, 16): both leave the node: 50 GB/s a card
    assert roofline._coll_seconds(coll, "16x16") == pytest.approx(36.0)
    # a record without per-dim bytes (the reference's): NVLink whole
    assert roofline._coll_seconds({"total_link_bytes": 450e9},
                                  "16x16") == pytest.approx(1.0)


# ------------------------------------- a full-size cell on 256 fake ranks
def test_full_size_cell_main_patch_probe_and_report(tmp_path, capsys):
    """h2o-danube-1.8b x decode_32k on the (16, 16) mesh through ``main``;
    ``patch_probe`` restores a blanked probe; a skipped cell and the
    report."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "h2o-danube-1.8b", "--shape", "decode_32k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k",
                        "--out", out]) == 0
    f = tmp_path / "h2o-danube-1.8b__decode_32k__pod.json"
    rec = json.loads(f.read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["mesh"] == "16x16"
    # the serving plan: no leaf over 'data'; the cache's head_dim (80 over
    # 16: its 8 kv heads do not divide) split over 'model', attended over
    # as it is held (q and the output exchanged, the scores summed)
    assert set(rec["collectives"]["by_dim"]) == {"model"}
    assert "all-gather" not in rec["collectives"]["by_dim"]["model"]["ops"] \
        or rec["collectives"]["all-gather"]["count"] == 2  # the argmax's
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == mem["plan_argument_bytes"]
    # 8 of the probe's 128 rows; of them, the kv projections whole and
    # the heads', MLP's, vocabulary's and attention's products over a
    # sixteenth:
    # flops = (probe - kv) / (16 * 16) + kv / 16
    from repro_torch.configs import get_config

    kv = _whole_kv_flops(get_config("h2o-danube-1.8b"), 128, passes=1)
    assert 16 * 16 * rec["cost"]["flops"] == rec["probe"]["flops"] + 15 * kv
    probe = rec["probe"]
    f.write_text(json.dumps(dict(rec, probe={})))
    assert patch_probe.main(["--dryrun-dir", out, "--kind", "decode"]) == 0
    patched = json.loads(f.read_text())["probe"]
    assert {k: v for k, v in patched.items() if k != "probe_s"} == {
        k: v for k, v in probe.items() if k != "probe_s"}
    skipped = json.loads((tmp_path / "gemma-2b__long_500k__pod.json")
                         .read_text())
    assert skipped["status"] == "skipped"
    capsys.readouterr()
    assert report.main(["--dryrun-dir", out]) == 0
    text = capsys.readouterr().out
    assert "| h2o-danube-1.8b | decode_32k | 0 |" in text
    assert "| gemma-2b | long_500k | — skipped" in text
