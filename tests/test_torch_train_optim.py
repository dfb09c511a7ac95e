"""The port's token pipeline (``repro_torch.data``), AdamW and int8 gradient
compression (``repro_torch.optim``) against the reference's, the ports of
``tests/test_substrate.py``'s pipeline and optimiser tests, and a train
state (``{"params", "opt"}``) crossing packages through the checkpoint
store.

Tolerances: batches, packing, the int8 payload ``q`` and its scales are
exact; AdamW's moments and parameters, the compression error and the
learning rate within ``rtol=1e-6`` (the same f32 operations in the same
order; XLA and torch may still reduce the global norm in another order).
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.configs.base import TrainConfig as RTrainConfig
from repro.data import TokenStream as RTokenStream
from repro.data import pack_documents as r_pack_documents
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import model_params, opt_state
from repro_torch.data import (SyntheticLM, TokenStream, pack_documents,
                              sharded_batches)
from repro_torch.distributed.sharding import PartitionSpec
from repro_torch.optim import (OptState, adamw_init, adamw_update, compress,
                               decompress, init_error, lr_at)

r_compress = importlib.import_module("repro.optim.compress")
r_adamw = importlib.import_module("repro.optim.adamw")
EXACT_RTOL = 1e-6


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _trees(seed=0):
    """(numpy grads, numpy params) with a bf16 and an f32 leaf, nested."""
    rng = np.random.default_rng(seed)
    grads = {"a": rng.normal(size=(33, 17)).astype(np.float32) * 1e-2,
             "b": {"c": rng.normal(size=(9,)).astype(np.float32),
                   "d": rng.normal(size=(4, 5)).astype(np.float32) * 1e3}}
    params = {"a": rng.normal(size=(33, 17)).astype(np.float32),
              "b": {"c": rng.normal(size=(9,)).astype(np.float32),
                    "d": rng.normal(size=(4, 5)).astype(np.float32)}}
    return grads, params


def _ref_params(params):
    return {"a": jnp.asarray(params["a"], jnp.bfloat16),
            "b": {"c": jnp.asarray(params["b"]["c"]),
                  "d": jnp.asarray(params["b"]["d"], jnp.bfloat16)}}


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed", [0, 7])
def test_token_stream_is_the_references_byte_for_byte(seed):
    for vocab, seq, gb in ((1000, 64, 4), (256000, 128, 3), (50, 9, 5)):
        mine = TokenStream(vocab=vocab, seq_len=seq, global_batch=gb,
                           seed=seed)
        theirs = RTokenStream(vocab=vocab, seq_len=seq, global_batch=gb,
                              seed=seed)
        for step in (0, 1, 17, 1000):
            a, b = mine.batch(step), theirs.batch(step)
            assert sorted(a) == sorted(b) == ["labels", "positions",
                                              "tokens"]
            for key in a:
                assert a[key].dtype == b[key].dtype == np.int32
                assert a[key].tobytes() == b[key].tobytes(), (step, key)


def test_pack_documents_is_the_references():
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 99, int(n)) for n in rng.integers(1, 40, 25)]
    for seq in (4, 16, 33):
        for got, want in zip(pack_documents(docs, seq, pad_id=5),
                             r_pack_documents(docs, seq, pad_id=5)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_pipeline_deterministic_and_resumable():
    s1 = TokenStream(vocab=1000, seq_len=64, global_batch=4, seed=7)
    s2 = TokenStream(vocab=1000, seq_len=64, global_batch=4, seed=7)
    b17a, b17b = s1.batch(17), s2.batch(17)
    np.testing.assert_array_equal(b17a["tokens"], b17b["tokens"])
    # different steps/seeds differ
    assert not np.array_equal(s1.batch(18)["tokens"], b17a["tokens"])
    assert not np.array_equal(
        TokenStream(vocab=1000, seq_len=64, global_batch=4,
                    seed=8).batch(17)["tokens"],
        b17a["tokens"],
    )


def test_pipeline_shapes_and_label_shift():
    s = TokenStream(vocab=500, seq_len=32, global_batch=3)
    b = s.batch(0)
    assert b["tokens"].shape == (3, 32) and b["labels"].shape == (3, 32)
    assert (b["tokens"] < 500).all() and (b["tokens"] >= 0).all()
    # labels are the next token of the same packed row
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pack_documents_positions_restart():
    docs = [np.arange(1, 6), np.arange(10, 13)]
    rows, pos = pack_documents(docs, 4)
    assert rows.shape[1] == 4
    assert pos[0, 0] == 0  # first doc starts at 0
    flat_pos = pos.reshape(-1)
    # a position reset marks each document boundary
    assert (flat_pos == 0).sum() >= 2


def test_synthetic_docs_stay_in_vocab():
    doc = SyntheticLM(vocab=64).sample_doc(np.random.default_rng(1), 300)
    assert doc.dtype == np.int32 and doc[0] == 1
    assert doc.min() >= 0 and doc.max() < 64


def test_sharded_batches_resume_on_a_device():
    stream = TokenStream(vocab=300, seq_len=16, global_batch=2, seed=3)
    it = sharded_batches(stream, start_step=5, device="cpu")
    for step in (5, 6):
        got = next(it)
        for key, want in stream.batch(step).items():
            assert isinstance(got[key], torch.Tensor)
            np.testing.assert_array_equal(got[key].numpy(), want)
    # over a mesh: this rank's block at its coordinates (data 1 of 2); the
    # multi-rank file holds it against the reference's shards
    class Rank:
        device_type = "cpu"
        mesh_dim_names = ("data", "model")
        mesh = torch.empty(2, 1)

        def get_local_rank(self, name):
            return {"data": 1, "model": 0}[name]

    got = next(sharded_batches(stream, Rank(), PartitionSpec("data"),
                               start_step=5))
    for key, want in stream.batch(5).items():
        np.testing.assert_array_equal(got[key].numpy(), want[1:])


# ----------------------------------------------------------------- optim
def test_lr_schedule_is_the_references():
    for tc_kw in (dict(), dict(warmup_steps=0), dict(warmup_steps=7,
                                                    learning_rate=1e-2)):
        for step in (0, 1, 6, 7, 99, 100, 101, 5000, 9999, 20000):
            want = float(r_adamw.lr_at(jnp.int32(step), RTrainConfig(**tc_kw)))
            got = lr_at(torch.tensor(step, dtype=torch.int32),
                        TrainConfig(**tc_kw))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=EXACT_RTOL)


def test_adamw_update_is_the_references():
    """Three steps on the same trees (bf16 and f32 leaves, one leaf whose
    gradient trips the clip): moments, parameters and metrics."""
    grads, params = _trees()
    tc_kw = dict(warmup_steps=2, grad_clip=1.0)
    rp = _ref_params(params)
    ropt = r_adamw_init(rp)
    tp = model_params(jax.tree.map(np.asarray, rp), device="cpu")
    topt = opt_state(jax.tree.map(np.asarray, ropt), device="cpu")
    for step in range(3):
        g = jax.tree.map(lambda a: a * (step + 1), grads)
        rp, ropt, rm = r_adamw_update(jax.tree.map(jnp.asarray, g), ropt, rp,
                                      RTrainConfig(**tc_kw))
        tp, topt, tm = adamw_update(jax.tree.map(torch.as_tensor, g), topt,
                                    tp, TrainConfig(**tc_kw))
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                       rtol=EXACT_RTOL)
    assert int(topt.step) == int(ropt.step) == 3
    for mine, theirs in ((tp, rp), (topt.m, ropt.m), (topt.v, ropt.v)):
        for a, b in zip(_flatten(mine)[0], jax.tree_util.tree_leaves(theirs)):
            assert str(a.dtype).removeprefix("torch.") == b.dtype.name
            np.testing.assert_allclose(_np(a), _np(b), rtol=EXACT_RTOL,
                                       atol=1e-12)


def test_adamw_update_leaves_inputs_unless_in_place():
    grads, params = _trees(1)
    tp = {"a": torch.as_tensor(params["a"]), "b": {
        "c": torch.as_tensor(params["b"]["c"]),
        "d": torch.as_tensor(params["b"]["d"]).bfloat16()}}
    before = [t.clone() for t in _flatten(tp)[0]]
    g = jax.tree.map(torch.as_tensor, grads)
    opt = adamw_init(tp)
    new_p, new_opt, _ = adamw_update(g, opt, tp, TrainConfig())
    assert all(torch.equal(a, b) for a, b in zip(_flatten(tp)[0], before))
    assert all(float(m.abs().max()) == 0 for m in _flatten(opt.m)[0])
    got_p, got_opt, _ = adamw_update(g, opt, tp, TrainConfig(), inplace=True)
    assert got_p["a"] is tp["a"] and got_opt.m["a"] is opt.m["a"]
    for a, b in zip(_flatten((got_p, got_opt.m, got_opt.v))[0],
                    _flatten((new_p, new_opt.m, new_opt.v))[0]):
        assert torch.equal(a, b)


def test_compress_is_the_references():
    """The int8 payload and the scales exact; the error and the decompressed
    gradient within rtol 1e-6."""
    grads, _ = _trees(2)
    rng = np.random.default_rng(5)
    err = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-4)
                       .astype(np.float32), grads)
    rq, rs, re = r_compress.compress(jax.tree.map(jnp.asarray, grads),
                                     jax.tree.map(jnp.asarray, err))
    tq, ts, te = compress(jax.tree.map(torch.as_tensor, grads),
                          jax.tree.map(torch.as_tensor, err))
    for a, b in zip(_flatten(tq)[0], jax.tree_util.tree_leaves(rq)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(_flatten(ts)[0], jax.tree_util.tree_leaves(rs)):
        assert a.dtype == torch.float32 and float(a) == float(b)
    for a, b in zip(_flatten(te)[0], jax.tree_util.tree_leaves(re)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=EXACT_RTOL, atol=1e-12)
    want = r_compress.decompress(rq, rs)
    for a, b in zip(_flatten(decompress(tq, ts))[0],
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=EXACT_RTOL)


def test_round_half_to_even():
    """``torch.round`` rounds a tie to the even integer, as ``jnp.round``."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5])
    assert torch.round(x).tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, 126.0]
    assert np.asarray(jnp.round(jnp.asarray(x.numpy()))).tolist() == \
        torch.round(x).tolist()


def test_adamw_descends_quadratic():
    tc = TrainConfig(learning_rate=0.1, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, m = adamw_update(grads, opt, params, tc)
    assert float(params["w"].abs().max()) < 0.2
    assert int(opt.step) == 200


def test_grad_clip_bounds_update():
    tc = TrainConfig(learning_rate=1.0, warmup_steps=0, grad_clip=1.0,
                     weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    _, _, m = adamw_update({"w": torch.full((3,), 1e6)}, opt, params, tc)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_compress_error_feedback_converges():
    """Quantization error is carried, not lost: sum of dequantized grads
    over many steps tracks the true sum."""
    rng = np.random.default_rng(0)
    g_true = torch.as_tensor(rng.normal(size=(64,)).astype(np.float32)) * 1e-3
    err = init_error({"g": g_true})["g"]
    total = torch.zeros(64)
    for _ in range(50):
        q, s, err_t = compress({"g": g_true}, {"g": err})
        err = err_t["g"]
        total = total + decompress(q, s)["g"]
    np.testing.assert_allclose(total.numpy(), g_true.numpy() * 50, atol=2e-4)


# ---------------------------------------------------------- checkpoints
def _train_states():
    """The same {"params", "opt"} train state in both packages."""
    grads, params = _trees(3)
    rp = _ref_params(params)
    ropt = r_adamw_init(rp)
    rp, ropt, _ = r_adamw_update(jax.tree.map(jnp.asarray, grads), ropt, rp,
                                 RTrainConfig(warmup_steps=1))
    np_state = jax.tree.map(np.asarray, (rp, ropt))
    port = {"params": model_params(np_state[0], device="cpu"),
            "opt": opt_state(np_state[1], device="cpu")}
    return {"params": rp, "opt": ropt}, port


def _manifest(directory, step):
    path = directory / f"step_{step:08d}" / "manifest.json"
    return json.loads(path.read_text())


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
        return t.numpy().tobytes()
    a = np.asarray(leaf)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


def test_opt_state_treedef_is_jaxs():
    ref, port = _train_states()
    assert isinstance(port["opt"], OptState)
    assert _flatten(port)[1] == str(jax.tree_util.tree_structure(ref))


def test_train_state_crosses_packages(tmp_path):
    """A train state saved by either package's ``CheckpointManager``
    restores through the other bit for bit, with equal manifests."""
    ref, port = _train_states()
    RCheckpointManager(tmp_path / "ref", keep=2).save(3, ref)
    CheckpointManager(tmp_path / "port", keep=2).save(3, port)
    assert _manifest(tmp_path / "port", 3) == _manifest(tmp_path / "ref", 3)
    zeros_t = jax.tree.map(torch.zeros_like, port)
    zeros_r = jax.tree.map(jnp.zeros_like, ref)
    got_t, step_t = CheckpointManager(tmp_path / "ref").restore(zeros_t)
    got_r, step_r = RCheckpointManager(tmp_path / "port").restore(zeros_r)
    assert step_t == step_r == 3
    assert isinstance(got_t["opt"], OptState)
    assert got_t["opt"].step.dtype == torch.int32
    for a, b in zip(_flatten(got_t)[0], jax.tree_util.tree_leaves(ref)):
        assert _bits(a) == _bits(b)
    for a, b in zip(jax.tree_util.tree_leaves(got_r), _flatten(port)[0]):
        assert _bits(a) == _bits(b)


def test_training_modules_import_without_jax():
    """With ``jax`` and ``repro`` unimportable, the training modules import
    and take a step on the CPU."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch, repro_torch.optim, repro_torch.data\n"
        "from repro_torch.launch.train import train_loop\n"
        "from repro_torch.configs import get_smoke, TrainConfig\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.launch.steps import make_train_step\n"
        "m = build_model(get_smoke('gemma-2b'), 'cpu')\n"
        "p = m.init(torch.Generator().manual_seed(0))\n"
        "b = {k: torch.from_numpy(v) for k, v in repro_torch.data.TokenStream("
        "256, 16, 2).batch(0).items()}\n"
        "_, _, met = make_train_step(m, TrainConfig())(p, "
        "repro_torch.optim.adamw_init(p), b)\n"
        "assert torch.isfinite(met['loss'])\n"
        "print('ok')\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
