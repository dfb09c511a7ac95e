"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): one on-disk format.

A tree saved by either package restores through the other leaf for leaf
(legacy ``proc0.npz``, streaming shards, delta references), and the two
packages write equal manifests for equal trees: the same treedef text,
dtype names, shapes and piece hashes.  The reference's store-level
durability tests are ported case for case, and the run fingerprint's
``graph`` and ``seeds`` components equal the reference's.  Tolerances:
exact throughout.
"""
import json
import shutil
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import checkpoint as rck
from repro.core import recovery as rrec
from repro.core.sem import IOStats as RIOStats
from repro.graph.generators import rmat

import repro_torch
from repro_torch import checkpoint as tck
from repro_torch.checkpoint import (
    CheckpointCorruptionError,
    CheckpointManager,
    latest_step,
    load_extra,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.store import _flatten
from repro_torch.core import recovery as trec
from repro_torch.core.sem import IOStats as TIOStats

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's small tensors on one intra-op thread: torch's
    thread pool only slows tiny ops, and under parallel test workers its
    threads oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (kwargs of save_checkpoint) per layout
LAYOUTS = {
    "legacy": {},
    "streaming": {"max_shard_bytes": 256},
    "delta": {"max_shard_bytes": 256, "delta": True},
}


class Pair(NamedTuple):
    a: object
    b: object = None


def _data(seed: int = 0) -> dict:
    """numpy leaves of one test tree (bf16 held as its float32 values)."""
    rng = np.random.default_rng(seed)
    return {
        "f": rng.standard_normal(300).astype(np.float32),
        "i": np.arange(77, dtype=np.int32),
        "l": np.arange(5, dtype=np.int64),
        "b": rng.random(40) < 0.5,
        "h": rng.standard_normal(130).astype(np.float32),  # stored as bf16
        "s": np.float32(2.5),
        "io": np.arange(10, dtype=np.int32),
    }


def torch_tree(d: dict) -> dict:
    return {
        "z": {"f": torch.from_numpy(d["f"]), "none": None,
              "pair": Pair(torch.from_numpy(d["i"]), None)},
        "a": [torch.from_numpy(d["l"]), torch.from_numpy(d["b"])],
        "bf": torch.from_numpy(d["h"]).to(torch.bfloat16),
        "io": TIOStats(*(torch.tensor(int(v), dtype=torch.int32)
                         for v in d["io"])),
        "s": torch.tensor(d["s"]),
    }


def jax_tree(d: dict) -> dict:
    return {
        "z": {"f": jnp.asarray(d["f"]), "none": None,
              "pair": Pair(jnp.asarray(d["i"]), None)},
        "a": [np.asarray(d["l"]), jnp.asarray(d["b"])],
        "bf": jnp.asarray(d["h"]).astype(jnp.bfloat16),
        "io": RIOStats(*(jnp.asarray(int(v), jnp.int32) for v in d["io"])),
        "s": jnp.asarray(d["s"]),
    }


def _manifest(d, step):
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


def _bytes(leaf) -> tuple:
    """(dtype name, shape, raw bytes) of a leaf of either package."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        t = leaf.view(torch.int16) if name == "bfloat16" else leaf
        return name, tuple(leaf.shape), t.numpy().tobytes()
    a = np.asarray(leaf)
    return a.dtype.name, a.shape, a.tobytes()


def test_flatten_matches_jax_treedef():
    """Leaf order and treedef text are JAX's for dicts (sorted keys),
    lists, tuples, NamedTuples and None."""
    d = _data()
    leaves, text = _flatten(torch_tree(d))
    jleaves, jdef = jax.tree_util.tree_flatten(jax_tree(d))
    assert text == str(jdef)
    assert len(leaves) == len(jleaves) == 16
    for a, b in zip(leaves, jleaves):
        assert _bytes(a) == _bytes(b)
    assert _flatten((1,))[1] == str(jax.tree_util.tree_structure((1,)))
    assert _flatten(None)[1] == str(jax.tree_util.tree_structure(None))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_and_reference_write_equal_manifests(tmp_path, layout):
    """Equal trees give equal manifests (treedef, dtype names, shapes,
    piece hashes, shards), step after step of a delta chain."""
    kw = LAYOUTS[layout]
    for step, seed in ((1, 0), (2, 0), (3, 1)):
        d = _data(seed)
        save_checkpoint(tmp_path / "port", step, torch_tree(d), **kw)
        rck.save_checkpoint(tmp_path / "ref", step, jax_tree(d), **kw)
        assert _manifest(tmp_path / "port", step) == \
            _manifest(tmp_path / "ref", step)
    if layout == "delta":  # step 2 is all references to step 1
        m = _manifest(tmp_path / "port", 2)
        assert m["stored_bytes"] == 0
        assert {p["step"] for e in m["leaves"] for p in e["pieces"]} == {1}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_snapshot_restores_through_reference(tmp_path, layout):
    d = _data()
    tree = torch_tree(d)
    save_checkpoint(tmp_path, 4, tree, **LAYOUTS[layout])
    got, step = rck.restore_checkpoint(tmp_path, jax_tree(_data(9)),
                                       as_numpy=True)
    assert step == 4
    mine, _ = _flatten(tree)
    theirs = jax.tree_util.tree_leaves(got)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert _bytes(a) == _bytes(b)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reference_snapshot_restores_through_port(tmp_path, layout):
    d = _data()
    tree = jax_tree(d)
    rck.save_checkpoint(tmp_path, 6, tree, **LAYOUTS[layout])
    got, step = restore_checkpoint(tmp_path, torch_tree(_data(9)))
    assert step == 6
    assert isinstance(got["io"], TIOStats) and got["z"]["none"] is None
    assert got["bf"].dtype == torch.bfloat16
    mine, _ = _flatten(got)
    theirs = jax.tree_util.tree_leaves(tree)
    for a, b in zip(mine, theirs):
        assert _bytes(a) == _bytes(b)
    # as_numpy: host arrays, bf16 as its uint16 view
    arrs, _ = restore_checkpoint(tmp_path, torch_tree(d), as_numpy=True)
    assert arrs["bf"].dtype == np.uint16
    assert arrs["bf"].tobytes() == _bytes(tree["bf"])[2]


def test_coreness_state_crosses_packages(tmp_path):
    """A mid-run coreness state (its level ``k`` a 0-d int32 leaf, as the
    reference's) writes the reference's manifest and restores through
    either package."""
    from repro.algs.coreness import CorenessProgram as RCore

    from repro_torch.algs.coreness import CorenessProgram as TCore

    g = rmat(8, edge_factor=8, seed=1, symmetrize=True)
    kw = dict(chunk_size=128, device="cpu")
    ts = repro_torch.core.run_program(repro_torch.Graph(g, **kw).device(),
                                      TCore(), max_supersteps=7).state
    rs = repro.core.run_program(repro.Graph(g, chunk_size=128).device(),
                                RCore(), max_supersteps=7).state
    assert ts.k.dtype == torch.int32 and ts.k.ndim == 0
    save_checkpoint(tmp_path / "port", 7, ts)
    rck.save_checkpoint(tmp_path / "ref", 7, rs)
    assert _manifest(tmp_path / "port", 7) == _manifest(tmp_path / "ref", 7)
    got, _ = restore_checkpoint(tmp_path / "ref", ts)
    back, _ = rck.restore_checkpoint(tmp_path / "port", rs)
    for a, b, c in zip(_flatten(got)[0], jax.tree_util.tree_leaves(back),
                       _flatten(ts)[0]):
        assert _bytes(a) == _bytes(b) == _bytes(c)


def test_restore_places_tensors_and_keeps_python_scalars(tmp_path):
    save_checkpoint(tmp_path, 1, {"t": torch.arange(4), "n": np.ones(2),
                                  "k": 7, "flag": True})
    got, _ = restore_checkpoint(tmp_path, {"t": torch.zeros(4), "n":
                                           np.zeros(2), "k": 0,
                                           "flag": False}, device="cpu")
    assert got["t"].dtype == torch.int64 and torch.equal(got["t"],
                                                         torch.arange(4))
    assert isinstance(got["n"], np.ndarray)
    assert got["k"] == 7 and got["flag"] is True


def test_async_save_copies_before_returning(tmp_path):
    """A background save taken while the caller goes on mutating the
    state in place writes the bits the state held at the save."""
    x = torch.arange(1 << 16, dtype=torch.float32)
    want = x.clone()
    mgr = CheckpointManager(tmp_path, keep=1, max_shard_bytes=4096)
    mgr.save(1, {"x": x}, blocking=False)
    x.mul_(3.0).add_(1.0)  # the next superstep writes the live tensor
    mgr.wait()
    got, _ = restore_checkpoint(tmp_path, {"x": torch.zeros_like(x)})
    assert torch.equal(got["x"], want)


# ------------------------------------------------ the reference's store tests
class TestStoreDurability:
    def test_tmp_partial_and_stray_entries_ignored(self, tmp_path):
        tree = {"a": torch.arange(5, dtype=torch.int32), "b": torch.ones(3)}
        save_checkpoint(tmp_path, 4, tree)
        (tmp_path / "step_00000099.tmp").mkdir()
        (tmp_path / "step_junk").mkdir()
        (tmp_path / "step_").mkdir()
        assert latest_step(tmp_path) == 4
        restored, step = restore_checkpoint(
            tmp_path, {"a": torch.zeros(5, dtype=torch.int32),
                       "b": torch.zeros(3)})
        assert step == 4
        assert torch.equal(restored["a"], torch.arange(5, dtype=torch.int32))
        mgr = CheckpointManager(tmp_path, keep=1)
        mgr.save(7, tree)
        assert latest_step(tmp_path) == 7

    def test_corrupt_shard_is_an_error(self, tmp_path):
        save_checkpoint(tmp_path, 1, {"a": torch.arange(4), "b": torch.ones(2)})
        shard = tmp_path / "step_00000001" / "proc0.npz"
        np.savez(shard, a0=np.arange(4))  # one leaf missing
        with pytest.raises(CheckpointCorruptionError, match="manifest"):
            restore_checkpoint(
                tmp_path, {"a": torch.zeros(4), "b": torch.zeros(2)})

    def test_extra_metadata_round_trip(self, tmp_path):
        save_checkpoint(tmp_path, 2, {"a": torch.zeros(1)},
                        extra={"graph": "abc", "superstep": 2})
        assert load_extra(tmp_path, 2) == {"graph": "abc", "superstep": 2}
        assert load_extra(tmp_path, 3) is None

    def test_as_numpy_preserves_dtypes(self, tmp_path):
        save_checkpoint(tmp_path, 1, {"r": np.arange(3, dtype=np.float64)})
        tree, _ = restore_checkpoint(
            tmp_path, {"r": np.zeros(3, np.float64)}, as_numpy=True)
        assert tree["r"].dtype == np.float64


class TestTornMetadata:
    def test_latest_step_skips_torn_extra(self, tmp_path):
        tree = {"a": torch.arange(4)}
        save_checkpoint(tmp_path, 2, tree, extra={"fp": "ok"})
        save_checkpoint(tmp_path, 4, tree, extra={"fp": "ok"})
        (tmp_path / "step_00000004" / "extra.json").write_text('{"fp": "o')
        assert latest_step(tmp_path) == 2
        _, step = restore_checkpoint(tmp_path, {"a": torch.zeros(4)})
        assert step == 2

    def test_load_extra_raises_typed_error_naming_step(self, tmp_path):
        save_checkpoint(tmp_path, 7, {"a": torch.zeros(1)}, extra={"x": 1})
        (tmp_path / "step_00000007" / "extra.json").write_text("")
        with pytest.raises(CheckpointCorruptionError, match="step 7"):
            load_extra(tmp_path, 7)


class TestStreamingStore:
    def test_sharded_save_bounded_staging_bitwise_restore(self, tmp_path):
        rng = np.random.default_rng(0)
        tree = {
            "big": torch.from_numpy(
                rng.standard_normal(16384).astype(np.float32)),
            "ints": np.arange(5000, dtype=np.int64),
            "flags": torch.from_numpy(rng.random(333) < 0.5),
            "scalar": np.float64(1.25),
        }
        tel = {}
        budget = 8192
        save_checkpoint(tmp_path, 3, tree, max_shard_bytes=budget,
                        telemetry=tel)
        shards = sorted((tmp_path / "step_00000003").glob("shard_*.npz"))
        assert len(shards) >= 8
        assert 0 < tel["stage_peak_bytes"] <= budget
        assert tel["shard_files"] == len(shards)
        restored, step = restore_checkpoint(tmp_path, tree)
        assert step == 3
        for k, v in tree.items():
            assert _bytes(restored[k]) == _bytes(v), k

    def test_streaming_handles_tensor_and_bf16_leaves(self, tmp_path):
        tree = {"bf": torch.arange(3000).to(torch.bfloat16),
                "f": torch.linspace(0, 1, 700)}
        save_checkpoint(tmp_path, 1, tree, max_shard_bytes=1024)
        restored, _ = restore_checkpoint(tmp_path, tree)
        for k in tree:
            assert restored[k].dtype == tree[k].dtype
            assert torch.equal(restored[k], tree[k]), k

    def test_delta_skips_unchanged_pieces(self, tmp_path):
        tree = {"big": torch.arange(8192, dtype=torch.float32),
                "tick": np.int64(0)}
        save_checkpoint(tmp_path, 1, tree, max_shard_bytes=4096, delta=True)
        full_bytes = _manifest(tmp_path, 1)["stored_bytes"]
        tree2 = dict(tree, tick=np.int64(1))
        save_checkpoint(tmp_path, 2, tree2, max_shard_bytes=4096, delta=True)
        m2 = _manifest(tmp_path, 2)
        assert m2["stored_bytes"] * 2 < full_bytes
        assert {p["step"] for p in m2["leaves"][0]["pieces"]} == {1}
        restored, step = restore_checkpoint(tmp_path, tree2)
        assert step == 2
        assert torch.equal(restored["big"], tree2["big"])
        assert int(restored["tick"]) == 1

    def test_delta_references_collapse_to_physical_home(self, tmp_path):
        tree = {"big": torch.zeros(4096), "t": np.int64(0)}
        for s in range(1, 6):
            tree = dict(tree, t=np.int64(s))
            save_checkpoint(tmp_path, s, tree, delta=True)
        m = _manifest(tmp_path, 5)
        assert {p["step"] for p in m["leaves"][0]["pieces"]} == {1}
        restored, _ = restore_checkpoint(tmp_path, tree)
        assert int(restored["t"]) == 5

    def test_gc_retains_delta_referenced_base(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, delta=True,
                                max_shard_bytes=4096)
        tree = {"big": torch.arange(4096, dtype=torch.float32),
                "t": np.int64(0)}
        for s in range(6):
            mgr.save(s, dict(tree, t=np.int64(s)))
        kept = sorted(p.name for p in tmp_path.iterdir()
                      if p.name.startswith("step_"))
        assert "step_00000000" in kept
        restored, step = mgr.restore(tree)
        assert step == 5
        assert torch.equal(restored["big"], tree["big"])

    def test_missing_referenced_shard_is_corruption_error(self, tmp_path):
        tree = {"big": torch.zeros(4096), "t": np.int64(0)}
        save_checkpoint(tmp_path, 1, tree, delta=True)
        save_checkpoint(tmp_path, 2, dict(tree, t=np.int64(1)), delta=True)
        shutil.rmtree(tmp_path / "step_00000001")
        with pytest.raises(CheckpointCorruptionError, match="shard"):
            restore_checkpoint(tmp_path, tree, 2)


# ------------------------------------------------------------ fingerprints
@pytest.mark.parametrize("residency", ("device", "host"))
def test_fingerprint_graph_and_seeds_match_reference(residency):
    g = rmat(6, edge_factor=6, seed=3, symmetrize=True)
    kw = dict(chunk_size=64, bd=32, bs=32)
    rs = repro.Graph(g, **kw)
    ts = repro_torch.Graph(g, device="cpu", **kw)
    rsem = rs.device() if residency == "device" else rs.host_view()
    tsem = ts.device() if residency == "device" else ts.host_view()
    seeds = np.asarray([0, 3, 11], np.int32)
    for t_seeds, r_seeds in ((torch.from_numpy(seeds), jnp.asarray(seeds)),
                             ((torch.ones(4), np.int32(2)),
                              (jnp.ones(4), np.int32(2))),
                             (None, None)):
        t = trec.run_fingerprint(tsem, repro_torch.algs.BFSProgram(),
                                 repro_torch.ExecutionPolicy(), t_seeds)
        r = rrec.run_fingerprint(rsem, repro.algs.BFSProgram(),
                                 repro.ExecutionPolicy(), r_seeds)
        assert (t["graph"], t["seeds"]) == (r["graph"], r["seeds"])
    other = repro_torch.Graph(rmat(6, edge_factor=6, seed=4, symmetrize=True),
                              device="cpu", **kw).device()
    assert trec.run_fingerprint(other, repro_torch.algs.BFSProgram(),
                                repro_torch.ExecutionPolicy(),
                                None)["graph"] != t["graph"]


def test_package_exports_match_reference():
    assert tck.__all__ == rck.__all__
