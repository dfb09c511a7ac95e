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


def test_data_parallel_step_all_reduces_f32_gradients(train_record):
    """Every gradient leaf, the loss and the ce: one f32 SUM all-reduce
    each over 'data' (2 ranks), nothing else."""
    model = build_model(get_smoke("gemma-2b"), "meta")
    params, _, _ = state_specs(model)
    leaves = torch.utils._pytree.tree_leaves(params)
    coll = train_record["collectives"]
    want = 4 * sum(t.numel() for t in leaves) + 2 * 4
    assert coll["all-reduce"] == {"bytes": want, "link_bytes": want,
                                  "count": len(leaves) + 2}
    assert coll["by_dim"] == {"data": dict(coll["all-reduce"], size=2)}
    assert coll["total_count"] == len(leaves) + 2
    assert train_record["devices"] == 8 and train_record["mesh"] == "2x4"
    # rank 0 runs half the batch: half the probe's FLOPs
    assert 2 * train_record["cost"]["flops"] == train_record["probe"]["flops"]
    mem = train_record["memory"]
    # donated: the parameters and both moments are updated in place; the
    # batch block (4 rows of tokens and labels) and the step count are not
    assert mem["alias_size_in_bytes"] == (mem["argument_size_in_bytes"]
                                          - 2 * 4 * 128 * 4 - 4)
    assert mem["plan_argument_bytes"] < mem["argument_size_in_bytes"]


def test_moe_prefill_all_to_alls_over_model():
    """moe_ffn_ep's dispatch and return: two all-to-alls a layer over
    'model' of the [E, cap, d] bf16 bucket, cap from the tokens of one
    (data, model) block; the tokens' all-gather over 'data' and the aux
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


def test_moe_train_over_a_model_dim_is_skipped_with_the_reason():
    rec = _cell("qwen3-moe-235b-a22b", "train")
    assert rec["status"] == "skipped" and "§A 3" in rec["reason"]


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
    assert rec["mesh"] == "16x16" and rec["collectives"]["total_count"] == 0
    # 128 rows over 16 data ranks: rank 0 runs 8 of the probe's 128
    assert 16 * rec["cost"]["flops"] == rec["probe"]["flops"]
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
