"""The SSD mixer's 'inner' split (mamba2, zamba2): the columns each rank
of 'model' computes with, the uneven all-to-all that takes them from the
plan's contiguous blocks and gives their gradients back, and the one-rank
plan, on which nothing splits.

* ``mamba2.head_columns``: each rank's columns are its heads' z, x and dt
  and B and C whole; the heads' columns partition the mixer's.
* ``sharding._pieces``, played out for every rank of a group in one
  process: each rank receives exactly its columns of the global leaf, and
  the transpose sums a column's gradients over the ranks that took it.
* On a one-rank gloo group (in this process, destroyed after the test),
  the planned train step and the planned prefill + decode of the ssm and
  hybrid smoke configurations are bit-equal to the unplanned ones: with
  one rank over 'model' the mixer runs whole, as the one program does.
  The 8-rank comparisons are in ``tests/test_torch_mesh_ranks.py``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import TrainConfig, get_smoke
from repro_torch.data.pipeline import TokenStream, sharded_batches
from repro_torch.distributed.sharding import (_pieces, cache_pspecs,
                                              gather_params, param_shardings,
                                              shard_params)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.mamba2 import head_columns
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init

# (d_inner, state, heads, ranks): the smoke configurations on a 4-way
# 'model', mamba2-370m and zamba2-2.7b on a 16-way one
SHAPES = [(128, 16, 8, 4), (2048, 128, 32, 16), (5120, 64, 80, 16)]


def _cols(ranges) -> list:
    return [i for lo, hi in ranges for i in range(lo, hi)]


@pytest.mark.parametrize("di,n,nh,m", SHAPES)
def test_head_columns_are_the_heads_and_b_c_whole(di, n, nh, m):
    cols = head_columns(di, n, nh, m)
    width = 2 * di + 2 * n + nh
    bc = set(range(2 * di, 2 * di + 2 * n))
    seen = []
    for r, ranges in enumerate(cols["in_proj"]):
        mine = _cols(ranges)
        assert mine == sorted(mine)
        assert len(mine) == 2 * di // m + 2 * n + nh // m
        assert bc <= set(mine)
        seen += [c for c in mine if c not in bc]
        h, w = nh // m, di // m
        assert mine[:w] == list(range(r * w, (r + 1) * w))  # z of its heads
        assert mine[-h:] == list(range(width - nh + r * h,
                                       width - nh + (r + 1) * h))  # dt
        conv = _cols(cols["conv_w"][r])
        assert conv == list(range(r * w, (r + 1) * w)) + list(
            range(di, di + 2 * n))
        assert cols["conv_b"][r] == cols["conv_w"][r]
    assert sorted(seen) == sorted(set(range(width)) - bc)


@pytest.mark.parametrize("di,n,nh,m", SHAPES)
def test_pieces_take_each_ranks_columns_and_sum_them_back(di, n, nh, m):
    """Every rank's pieces (``_pieces``) routed as ``all_to_all_single``
    routes them: rank r's output is the global leaf's columns
    ``picks[r]``, in order; the transpose's index-add gives each block
    the sum of its columns' gradients over the ranks that took them."""
    picks = head_columns(di, n, nh, m)["in_proj"]
    width = 2 * di + 2 * n + nh
    blk = width // m
    rng = np.random.default_rng(0)
    leaf = rng.normal(size=(width, 3))
    plans = [_pieces(blk, j, picks, "cpu") for j in range(m)]
    grads = []
    for r in range(m):
        got = []
        for j, (idx, sizes, _) in enumerate(plans):
            start = sum(sizes[:r])
            local = idx[start:start + sizes[r]].numpy()
            got.append(leaf[j * blk + local])
        assert [g.shape[0] for g in got] == plans[r][2]  # what r takes
        got = np.concatenate(got)
        np.testing.assert_array_equal(got, leaf[_cols(picks[r])])
        grads.append(rng.normal(size=got.shape))
    want = np.zeros_like(leaf)
    for r in range(m):
        np.add.at(want, _cols(picks[r]), grads[r])
    for j, (idx, sizes, _) in enumerate(plans):
        back = []  # rank r's gradient rows that came from block j
        for r in range(m):
            takes = plans[r][2]
            start = sum(takes[:j])
            back.append(grads[r][start:start + takes[j]])
        block = np.zeros((blk, 3))
        np.add.at(block, idx.numpy(), np.concatenate(back))
        np.testing.assert_allclose(block, want[j * blk:(j + 1) * blk],
                                   rtol=1e-12, atol=1e-12)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_local_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_one_rank_plan_is_bit_equal_to_no_plan(one_rank, arch):
    mesh = one_rank
    cfg = get_smoke(arch)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(1))
    axes = model.logical_axes()
    plan = param_shardings(axes, params, mesh)
    stream = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=2)
    batch = next(sharded_batches(stream, device="cpu"))
    tc = TrainConfig(warmup_steps=2)
    blocks = shard_params(params, plan)
    p_a, o_a, m_a = make_train_step(model, tc)(params, adamw_init(params),
                                               batch)
    p_b, o_b, m_b = make_train_step(model, tc, param_shardings=plan)(
        blocks, adamw_init(blocks), batch)
    for key in ("loss", "grad_norm"):
        assert torch.equal(m_a[key], m_b[key]), key
    assert _equal(p_a, gather_params(p_b, plan))
    assert _equal(o_a.m, gather_params(o_b.m, plan))

    toks = torch.randint(1, cfg.vocab, (2, 19),
                         generator=torch.Generator().manual_seed(6))
    cplan = cache_pspecs(Model(cfg, "meta").init_cache(2, 19), mesh, 2)
    dplan = param_shardings(axes, params, mesh, fsdp=False, moe_2d=True)
    lg_a, c_a = model.prefill(params, {"tokens": toks[:, :16]}, max_len=19)
    lg_b, c_b = make_prefill_step(model, param_shardings=plan,
                                  cache_shardings=cplan, max_len=19)(
        shard_params(params, plan), {"tokens": toks[:, :16]})
    assert torch.equal(lg_a, lg_b) and _equal(c_a, c_b)
    dec = make_decode_step(model, param_shardings=dplan,
                           cache_shardings=cplan)
    dblocks = shard_params(params, dplan)
    for i in range(3):
        tok = toks[:, 16 + i:17 + i]
        lg_a, c_a = model.decode_step(params, c_a, tok)
        _, lg_b, c_b = dec(dblocks, c_b, tok)
        assert torch.equal(lg_a, lg_b), i
    assert _equal(c_a["layers"], c_b["layers"])
