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
* the data-parallel train step, ``data=4`` (a ``(4, 2)`` mesh's data dim:
  two replicas of the group), on the dense and the moe smoke
  configurations (capacity factor 8), from the port's ``Model.init``
  weights and ``TokenStream`` batch 0 (B = 4, S = 32).  Against the
  port's one-process step on the whole batch: ``loss`` and ``ce`` within
  f32 summation order (``rtol=1e-6``); the gradient is each block's bf16
  gradient averaged in f32 where the one-process step rounds the whole
  batch's gradient to bf16 once, so the moments are within bf16 rounding
  of partial sums (``m`` relative L2 < 2**-6, measured 0.0043 dense and
  0.0091 moe; ``v`` twice that; ``grad_norm`` ``rtol=1e-3``) and the
  parameters within ``tests/test_torch_train_step.py``'s slack.  Against
  the reference's one-program step: that file's bounds for the dense
  configuration; for the moe configuration ``loss``, ``ce``,
  ``grad_norm`` and ``lr`` only, since one of the 128 tokens takes
  another expert at layer 1 in the two packages' bf16 (ROADMAP §C P23),
  which moves the moments by ~0.08 in the one-process step as in the
  data-parallel one.
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


@pytest.mark.parametrize("family", sorted(C.DP_ARCHS))
def test_data_parallel_step(runs, family):
    ref, ranks = runs
    dp = _run(ranks[0], f"dp/{family}/dp/")
    for r in ranks[1:]:  # parameters and moments stay replicated
        other = _run(r, f"dp/{family}/dp/")
        assert all(np.array_equal(other[k], dp[k]) for k in dp)
    one = _run(ranks[0], f"dp/{family}/one/")
    lr = float(one["lr"])
    assert float(dp["lr"]) == lr
    for key in ("loss", "ce"):
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
    if family == "dense":
        _check_leaves(dp, want, BOUND["dense"], lr)
