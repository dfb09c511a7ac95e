"""The port's multi-card layer over 8 gloo ranks on the CPU, against the
JAX package's ``shard_map`` on 8 forced host devices.

One spawn of 8 rank processes (``tests/torch_mesh_ranks_worker.py``: a
``file://`` rendezvous in ``tmp_path``, no network, one intra-op thread a
rank) runs every check on a ``(data=2, model=4)`` mesh and writes its
results; one JAX subprocess (``tests/torch_mesh_ranks_ref.py``,
``XLA_FLAGS`` set before ``import jax``) computes the reference's side;
both start together and build their inputs from
``tests/torch_mesh_common.py``.  Shards are compared by mesh coordinates,
not rank numbers.  The cases:

* ``moe_ffn_ep`` on ``tests/test_moe_ep.py``'s configuration: the training
  layout at capacity factor 8 and at 1.0 (tokens dropped per shard), and
  the serving layout (s = 1).  Every rank returns the same global y; y
  within ``rtol=atol=1.6e-2`` plus ``scale/128`` of the reference's (the
  bound of ``tests/test_torch_lm_moe.py``: bf16 expert products summed in
  other orders), the aux loss within ``rtol=1e-5``.
* ``compressed_psum`` over an 8-rank axis: the int8 payload, its int32 sum
  and the mean bit-equal.  The error is not: XLA contracts
  ``gf - q * s_max`` into a fused multiply-add, which rounds once, for
  some entries (the others round twice), while the port rounds the
  product first, as its ``compress`` (and so ``decompress(compress(g,
  e))``, its one-rank value) does.  The port's error is held bit for bit
  to two roundings of the same ``gf``, ``q`` and ``s_max``, each of the
  reference's entries to one of the two, and the two within half an f32
  ulp of ``gf``.
* ``sharded_batches`` with three batch specs and three steps: each rank's
  block equal to the reference's shard at the same coordinates.
* ``sharding.constrain`` on a ``DTensor`` (the port's own: the reference's
  pin changes no value) redistributes it to the spec's placements.
* the blocked train step (ZeRO-3 over 'data', tensor and expert parallel
  over 'model') on the dense, the moe (capacity factor 8) and the ssm
  smoke configurations (mamba2: its SSD mixer on each rank's 2 of 8
  heads), from the port's ``Model.init`` weights and ``TokenStream``
  batch 0 (B = 4, S = 32).  Each rank holds exactly its plan block of
  every parameter and moment (``param_pspecs`` on the mesh); the blocks,
  put together by mesh coordinates, are held against the port's
  one-process step on the whole batch: ``ce`` within f32 summation order
  (``rtol=1e-6``), and ``loss`` too but on the moe configuration (its
  aux is the mean of each (data, model) token shard's, as the
  reference's ``shard_map`` makes it, where the one-process step takes the
  whole batch's); the gradient is each block's bf16 gradient summed in
  f32 where the one-process step rounds the whole batch's gradient to
  bf16 once, so the moments are within bf16 rounding of partial sums
  (``m`` relative L2 < 2**-6, ``v`` twice that; ``grad_norm``
  ``rtol=1e-3``) and the parameters within
  ``tests/test_torch_train_step.py``'s slack.  Against the reference's one
  program with its plan (``param_shardings`` on 8 forced host devices):
  that file's bounds for the dense and ssm configurations; for the moe
  configuration ``loss``, ``ce``, ``grad_norm`` and ``lr`` only, since one
  of the 128 tokens takes another expert at layer 1 in the two packages'
  bf16 (ROADMAP §C P23).
* a leaf gathered whole on use (its compute replicated over 'model'): its
  gradient is the one-process step's, not the 'model' size times it; and
  the q/k norms of heads split over 'model', whose gradients sum; so do
  mamba2's per-head vectors and the B and C columns of its input
  projection and conv, which every rank takes whole for its heads.
* ``compress`` on the blocks equal, bit for bit, to the blocks of
  ``compress`` of the global tree (each leaf's scale its whole leaf's).
* vocab-parallel ``embed``, ``unembed`` and ``cross_entropy`` on a padded
  vocabulary against the global ones, the logits' gradient too.
* prefill under the training plan and decode under the serving plan, the
  cache held as ``cache_pspecs`` lays it out: the logits gathered over the
  mesh within ``tests/test_torch_lm.py``'s bound of the unsharded
  model's, the next tokens the argmax of the whole vocabulary.
* the same against the reference's program with its plan (its prefill
  and ``make_decode_step`` jitted with ``param_shardings``, the serving
  layout and ``cache_pspecs`` on 8 forced host devices), on gemma-2b's
  smoke configuration (one kv head on a 4-way 'model': the cache's
  head_dim splits) at B = 4 (the batch over 'data') and B = 1 (the
  sequence over 'data'): every rank's logits bit-equal to rank 0's, and
  within ``REL_BOUND`` of the reference's and of the unsharded port's.
  The same for mamba2 and zamba2 (``SSD_ARCHS``), each rank's mixer on
  its heads: the SSM state held with its head_dim over 'model' (at B = 1
  its heads over 'data' too) and moved to the rank's heads and back by
  all-to-alls each step.
  The sequence parallelism of the prefill (16 positions, a block of 4 a
  rank) and of the train step (32 positions) runs in these cases too.
* the sequence-parallel stream through the encoder-decoder, hybrid and
  vlm families' own routes (cross attention and the encoder, the SSD
  mixer and the shared block, the vision embeddings; whisper at 2 heads,
  so that its self and cross caches hold their head_dim over 'model' and
  decode attends over both caches' blocks): the blocked train
  step's loss and ce within ``rtol=1e-6`` of the one-process step's, the
  prefill and decode logits within ``REL_BOUND`` of the unsharded
  model's, every rank bit-equal to rank 0.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_common as C
from test_torch_lm import REL_BOUND
from test_torch_train_step import BOUND, GNORM_RTOL, LOSS_RTOL

HERE = Path(__file__).resolve().parent
TIMEOUT = 600  # seconds for the whole spawn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, each rank's results)."""
    out = tmp_path_factory.mktemp("mesh_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_ranks_ref.py"), str(out)],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_ranks_worker.py"), str(r),
         str(C.RANKS), str(out / "store"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(C.RANKS)]
    deadline = time.monotonic() + TIMEOUT
    try:
        results = [p.communicate(
            timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    ref = dict(np.load(out / "ref.npz"))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(C.RANKS)]
    return ref, ranks


@pytest.mark.parametrize("case", sorted(C.MOE_CASES))
def test_moe_ffn_ep_matches_reference(runs, case):
    ref, ranks = runs
    y = ref[f"moe/{case}/y"]
    for r in ranks:
        assert np.array_equal(r[f"moe/{case}/y"], ranks[0][f"moe/{case}/y"])
        assert r[f"moe/{case}/aux"] == ranks[0][f"moe/{case}/aux"]
    scale = float(np.abs(y).max())
    np.testing.assert_allclose(ranks[0][f"moe/{case}/y"], y, rtol=1.6e-2,
                               atol=1.6e-2 + scale / 128)
    np.testing.assert_allclose(float(ranks[0][f"moe/{case}/aux"]),
                               float(ref[f"moe/{case}/aux"]), rtol=1e-5)
    kept = sum(int(r[f"moe/{case}/kept"]) for r in ranks)
    assigned = sum(int(r[f"moe/{case}/assigned"]) for r in ranks)
    if case == "train_cf1":
        assert kept < assigned  # the local capacity drops tokens
    else:
        assert kept == assigned


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("leaf", ["/a", "/b", "/c/w"])
def test_compressed_psum_matches_reference(runs, leaf):
    ref, ranks = runs
    grads, err = C.psum_inputs()
    pick = {"/a": lambda t: t["a"], "/b": lambda t: t["b"],
            "/c/w": lambda t: t["c"]["w"]}[leaf]
    g, e = pick(grads), pick(err)
    gf = (_bf16(g) if leaf == "/b" else g) + e  # f32
    blocks = np.split(gf, C.RANKS)
    s_max = max(np.float32(max(np.abs(b).max(), np.float32(1e-12)))
                / np.float32(127.0) for b in blocks)
    n = blocks[0].shape[0]
    for r in ranks:
        c = int(r["psum/coord"])
        sl = slice(c * n, (c + 1) * n)
        q = r[f"psum{leaf}/q"]
        assert q.dtype == np.int8
        np.testing.assert_array_equal(q, ref[f"psum{leaf}/q"][sl])
        np.testing.assert_array_equal(r[f"psum{leaf}/total"],
                                      ref[f"psum{leaf}/total"][sl])
        assert np.array_equal(r[f"psum{leaf}/mean"], ref[f"psum{leaf}/mean"])
        mine, theirs = r[f"psum{leaf}/err"], ref[f"psum{leaf}/err"][sl]
        prod = q.astype(np.float32) * s_max
        assert np.array_equal(mine, blocks[c] - prod)  # two roundings
        fused = (blocks[c].astype(np.float64)
                 - q.astype(np.float64) * np.float64(s_max)).astype(
                     np.float32)
        # XLA fuses the multiply-add in some entries and not in others
        assert np.all((theirs == fused) | (theirs == mine))
        assert np.all(np.abs(mine - theirs)
                      <= np.spacing(np.abs(blocks[c])) / 2)


@pytest.mark.parametrize("spec", sorted(C.BATCH_SPECS))
@pytest.mark.parametrize("step", C.STREAM_STEPS)
def test_sharded_batches_match_reference(runs, spec, step):
    ref, ranks = runs
    for r in ranks:
        coord = "".join(str(int(c)) for c in r["coord"])
        for key in ("tokens", "labels", "positions"):
            np.testing.assert_array_equal(
                r[f"batch/{spec}/{step}/{key}"],
                ref[f"batch/{spec}/{step}/{key}/{coord}"])
    assert str(ranks[0]["batch/pspec"]) == "('data',)"


def test_constrain_redistributes_a_dtensor(runs):
    """``sharding.constrain`` (the layout pin) on a DTensor: its placements
    become the spec's, its values stay, each rank holds its block."""
    _, ranks = runs
    x = np.arange(32.0, dtype=np.float32).reshape(4, 8)
    for r in ranks:
        assert str(r["dtensor/placements"]) == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_array_equal(r["dtensor/full"], x)
        d, m = (int(c) for c in r["coord"])
        np.testing.assert_array_equal(r["dtensor/local"],
                                      x[2 * d:2 * d + 2, 2 * m:2 * m + 2])


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_leaves(got: dict, want: dict, m_bound: float, lr: float):
    for name, most in (("m", m_bound), ("v", 2 * m_bound)):
        for k in got:
            if k.startswith(f"{name}/"):
                err = _rel_l2(got[k], want[k])
                assert err < most, (k, err)
    for k in got:
        if k.startswith("params/"):
            a, b = got[k], want[k]
            assert a.shape == b.shape, k
            slack = 2 * lr + np.maximum(np.abs(a), np.abs(b)) * 2.0**-7
            assert np.all(np.abs(a - b) <= slack + 1e-12), k


def _run(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _plan(family: str) -> dict:
    """path -> (spec entries, global shape) of the smoke configuration's
    leaves under the plan on the (data, model) mesh."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import MeshShape, param_pspecs
    from repro_torch.models.model import Model

    model = Model(get_smoke(C.DP_ARCHS[family]), "meta")
    shapes = model.init(torch.Generator())
    specs = param_pspecs(model.logical_axes(), shapes,
                         MeshShape(C.MESH, ("data", "model")))
    return {path: (tuple(sp), tuple(t.shape))
            for (path, t), (_, sp) in zip(_walk(shapes), _walk(specs))}


def _assemble(ranks, key: str, spec: tuple, shape: tuple) -> np.ndarray:
    """The global leaf from each rank's block by its mesh coordinates;
    each block is exactly the plan's, and ranks at the same coordinates
    of the spec's mesh dims hold equal blocks."""
    sizes = dict(zip(("data", "model"), C.MESH))
    out = np.zeros(shape, np.float32)
    seen = {}
    for r in ranks:
        coord = dict(zip(("data", "model"), (int(c) for c in r["coord"])))
        idx = []
        for n, e in zip(shape, spec):
            step = n // sizes[e] if e else n
            lo = coord[e] * step if e else 0
            idx.append(slice(lo, lo + step))
        block = r[key]
        assert block.shape == tuple(sl.stop - sl.start for sl in idx), key
        where = tuple((sl.start, sl.stop) for sl in idx)
        if where in seen:
            assert np.array_equal(seen[where], block), key
        seen[where] = block
        out[tuple(idx)] = block
    return out


def _blocked_run(ranks, family: str) -> dict:
    """The blocked step's metrics (equal on every rank) and its leaves put
    together by mesh coordinates."""
    prefix = f"dp/{family}/dp/"
    got = {m: ranks[0][prefix + m] for m in ("loss", "ce", "grad_norm",
                                             "lr")}
    for r in ranks[1:]:
        assert all(r[prefix + m] == v for m, v in got.items())
    for path, (spec, shape) in _plan(family).items():
        for name in ("params", "m", "v"):
            got[f"{name}{path}"] = _assemble(ranks, f"{prefix}{name}{path}",
                                             spec, shape)
    return got


@pytest.mark.parametrize("family", sorted(C.DP_ARCHS))
def test_data_parallel_step(runs, family):
    ref, ranks = runs
    dp = _blocked_run(ranks, family)
    one = _run(ranks[0], f"dp/{family}/one/")
    lr = float(one["lr"])
    assert float(dp["lr"]) == lr
    for key in ("loss", "ce") if family != "moe" else ("ce",):
        np.testing.assert_allclose(float(dp[key]), float(one[key]),
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(dp["grad_norm"]),
                               float(one["grad_norm"]), rtol=1e-3)
    _check_leaves(dp, one, 2.0**-6, lr)

    want = _run(ref, f"dp/{family}/ref/")
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(dp[key]), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert float(dp["lr"]) == float(want["lr"])
    np.testing.assert_allclose(float(dp["grad_norm"]),
                               float(want["grad_norm"]), rtol=GNORM_RTOL)
    if family != "moe":
        _check_leaves(dp, want, BOUND[family], lr)


@pytest.mark.parametrize("family", sorted(C.DP_ARCHS))
def test_gathered_whole_leaf_gradient_is_not_summed_over_model(runs,
                                                               family):
    """A leaf whose spec names no 'model' dim is gathered whole on use and
    its compute replicated over 'model' (the norms; gemma's single kv
    head, cut to each rank's heads after the projection): each rank keeps
    its own block of the gradient, which a sum over 'model' would make 4
    times the one-process step's.  The q/k norms of heads split over
    'model' are the other way round: each rank normed its own heads, and
    without the sum a rank's moment would be a quarter of it.  The first
    moment is 0.1 x the clipped gradient."""
    _, ranks = runs
    dp = _blocked_run(ranks, family)
    one = _run(ranks[0], f"dp/{family}/one/")
    scale = float(dp["grad_norm"]) / float(one["grad_norm"])
    whole = [path for path, (spec, _) in _plan(family).items()
             if "model" not in spec]
    assert any("norm" in p for p in whole)
    for path in whole:
        got, want = dp[f"m{path}"], one[f"m{path}"]
        ratio = np.linalg.norm(got) / np.linalg.norm(want)
        assert abs(ratio - 1.0) < 2.0**-6, (path, ratio, scale)
        assert _rel_l2(got, want) < 2.0**-6, path


def test_ssd_head_split_gradients_sum_over_model(runs):
    """mamba2's mixer on each rank's 2 of 8 heads: ``A_log``, ``D`` and
    ``dt_bias`` are whole on every rank but each rank's gradient is
    non-zero on its heads alone, and every rank takes the B and C columns
    of ``in_proj`` (and their conv channels) whole, its gradient of them
    from its heads alone.  Summed over 'model' they are the one-process
    step's (without the sum a rank's moment would be a quarter of it, or
    wrong by head): first moments within 2**-6 relative L2."""
    from repro_torch.configs import get_smoke

    _, ranks = runs
    dp = _blocked_run(ranks, "ssm")
    one = _run(ranks[0], "dp/ssm/one/")
    cfg = get_smoke(C.DP_ARCHS["ssm"])
    di, n = cfg.d_inner, cfg.ssm_state
    pick = {"A_log": np.s_[...], "D": np.s_[...], "dt_bias": np.s_[...],
            "in_proj": np.s_[..., 2 * di:2 * di + 2 * n],
            "conv_w": np.s_[..., di:di + 2 * n],
            "conv_b": np.s_[..., di:di + 2 * n]}
    for leaf, cols in pick.items():
        got = dp[f"m/blocks/ssm/{leaf}"][cols]
        want = one[f"m/blocks/ssm/{leaf}"][cols]
        ratio = np.linalg.norm(got) / np.linalg.norm(want)
        assert abs(ratio - 1.0) < 2.0**-6, (leaf, ratio)
        assert _rel_l2(got, want) < 2.0**-6, leaf


def test_compress_on_blocks_equals_the_global_blocks(runs):
    _, ranks = runs
    for r in ranks:
        paths = {k.split("/q")[0] for k in r if k.startswith("compress/")
                 and k.endswith("/q")}
        assert paths
        for p in paths:
            assert r[f"{p}/q"].dtype == np.int8
            for part in ("q", "scale", "err"):
                assert np.array_equal(r[f"{p}/{part}"],
                                      r[f"{p}/{part}_global"]), (p, part)


def test_vocab_parallel_embed_unembed_and_cross_entropy(runs):
    """250 tokens padded to 256 rows over 4 'model' ranks: each rank's
    embedding rows summed over 'model' give the global lookup bit for bit;
    its logits are the global logits' block (the padding, by global index,
    -1e30 in the last block alone); the cross entropy and its gradient of
    the logits block agree within f32 summation order."""
    _, ranks = runs
    for r in ranks:
        m = int(r["coord"][1])
        assert np.array_equal(r["vocab/embed"], r["vocab/embed_global"])
        v = r["vocab/logits"].shape[-1]
        cols = slice(m * v, (m + 1) * v)
        np.testing.assert_allclose(r["vocab/logits"],
                                   r["vocab/logits_global"][..., cols],
                                   rtol=1e-6, atol=1e-6)
        pad = np.arange(m * v, (m + 1) * v) >= C.PAD_VOCAB
        assert pad.any() == (m == C.MESH[1] - 1)
        assert np.all(r["vocab/logits"][..., pad] == -1e30)
        np.testing.assert_allclose(float(r["vocab/ce"]),
                                   float(r["vocab/ce_global"]), rtol=1e-6)
        np.testing.assert_allclose(r["vocab/grad"],
                                   r["vocab/grad_global"][..., cols],
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("family", sorted(C.DP_ARCHS))
def test_prefill_and_decode_on_the_mesh(runs, family):
    _, ranks = runs
    steps = C.SERVE[2]
    for i in range(steps + 1):
        got = ranks[0][f"serve/{family}/mesh/{i}"]
        want = ranks[0][f"serve/{family}/one/{i}"]
        assert got.shape == want.shape
        for r in ranks[1:]:
            assert np.array_equal(r[f"serve/{family}/mesh/{i}"], got)
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max())
        assert err < REL_BOUND * scale, (i, err, scale)
        if i:
            assert np.array_equal(ranks[0][f"serve/{family}/next/{i - 1}"][
                :, 0], got.argmax(-1))


@pytest.mark.parametrize("case", sorted(C.SERVE_REF))
def test_split_cache_decode_matches_reference_with_its_plan(runs, case):
    """The decode cache held with its head_dim over 'model' (and at B = 1
    its sequence over 'data'): each rank attends over its blocks (partial
    scores summed over 'model'; the softmax's max, sum and the output over
    'data'), against the reference's program with its plan."""
    ref, ranks = runs
    b, _, steps = C.SERVE_REF[case]
    held = str(ranks[0][f"serve_ref/{case}/held"])
    assert held == ("('data', None, None, 'model')" if b % C.MESH[0] == 0
                    else "(None, 'data', None, 'model')")
    for i in range(steps + 1):
        got = ranks[0][f"serve_ref/{case}/mesh/{i}"]
        for r in ranks[1:]:
            assert np.array_equal(r[f"serve_ref/{case}/mesh/{i}"], got)
        for want in (ref[f"serve_ref/{case}/{i}"],
                     ranks[0][f"serve_ref/{case}/one/{i}"]):
            assert got.shape == want.shape
            scale = max(float(np.abs(want).max()), 1.0)
            err = float(np.abs(got - want).max())
            assert err < REL_BOUND * scale, (i, err, scale)


@pytest.mark.parametrize("case", sorted(C.SERVE_REF))
@pytest.mark.parametrize("family", sorted(C.SSD_ARCHS))
def test_ssd_head_split_decode_matches_reference_with_its_plan(runs, family,
                                                               case):
    """Prefill and decode with the SSD mixer on each rank's heads, the
    SSM state held as ``cache_pspecs`` lays it out (its head_dim over
    'model'; at B = 1 its heads over 'data') and moved to the rank's heads
    by all-to-alls: every rank's logits bit-equal to rank 0's, and within
    ``REL_BOUND`` of the reference's program with its plan and of the
    unsharded port's."""
    ref, ranks = runs
    b, _, steps = C.SERVE_REF[case]
    key = f"serve_ssd/{family}/{case}"
    held = str(ranks[0][f"{key}/held"])
    assert held == ("('data', None, 'model', None)" if b % C.MESH[0] == 0
                    else "(None, 'data', 'model', None)")
    for i in range(steps + 1):
        got = ranks[0][f"{key}/mesh/{i}"]
        for r in ranks[1:]:
            assert np.array_equal(r[f"{key}/mesh/{i}"], got)
        for want in (ref[f"{key}/{i}"], ranks[0][f"{key}/one/{i}"]):
            assert got.shape == want.shape
            scale = max(float(np.abs(want).max()), 1.0)
            err = float(np.abs(got - want).max())
            assert err < REL_BOUND * scale, (i, err, scale)


@pytest.mark.parametrize("family", sorted(C.SP_ARCHS))
def test_sequence_parallel_families_match_one_process(runs, family):
    _, ranks = runs
    for m in ("loss", "ce"):
        got = ranks[0][f"sp/{family}/mesh/{m}"]
        assert all(r[f"sp/{family}/mesh/{m}"] == got for r in ranks[1:])
        np.testing.assert_allclose(float(got),
                                   float(ranks[0][f"sp/{family}/one/{m}"]),
                                   rtol=1e-6, err_msg=m)
    for i in range(3):
        got = ranks[0][f"sp/{family}/mesh/logits/{i}"]
        want = ranks[0][f"sp/{family}/one/logits/{i}"]
        for r in ranks[1:]:
            assert np.array_equal(r[f"sp/{family}/mesh/logits/{i}"], got)
        assert got.shape == want.shape  # the vocabulary's columns (P24)
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max())
        assert err < REL_BOUND * scale, (i, err, scale)
