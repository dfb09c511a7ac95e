#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

The whole run, the builds included, has 1,200 s to end on one H100; the
depth cuts named below keep it inside that on the slower hosts.

Phases, each of which raises (and so exits non-zero) on failure:

  1. build     — compile ``src/repro_torch/csrc/spmv.cu`` (kernels B1-B4)
                 and ``decode_attn.cu`` (B5) for sm_90a, one nvcc each,
                 started together (into the git-ignored ``build/kernels/``);
                 logs ptxas's registers and spills, and fails if ptxas
                 spills in any of B1-B4's passes (every lane width).

  The LM slice runs first, while the card holds nothing else:

  2. lm_kernel — B5 against its plain version on the card within
                 atol=rtol=1e-4 (the same inputs, f32 math in another
                 summation order), two launches bit-equal: the serve shape
                 (B=4, KV=1, G=8, hd=256, T=1024) in bf16 and f32 at several
                 fill levels, a rotated slot order, gemma3-4b's window 1024
                 over T=8192 (whole blocks skipped), an empty row (must be
                 0), KV=4 with G=2; G=1, 4 and 16; hd=64 and 128 in bf16;
                 T=1000 (ragged blocks of 125) and T=96; KV=4, G=8 with a
                 window; and the shapes the families phase gives it:
                 zamba2's hd=80 with KV=32, G=1 (T=2112), qwen3-moe's
                 G=16 (KV=4, hd=128, T=1088) and whisper's KV=8, G=1 at
                 hd=64 (T=1564).  The build fails if ptxas spills in B5's
                 bf16 kernel.
  3. lm_serve  — ``serve_batch('gemma-2b', smoke=False, n_requests=5,
                 max_batch=4, max_new=16, max_len=1024, seed=0)`` at the
                 published width and depth, weights from the port's own
                 ``Model.init`` with a seeded generator; the cache wraps past
                 1024 before the fifth request refills a slot.  B5's count
                 is zeroed just before and read just
                 after: it must be 18 x decode_steps.  Logs ms per decode
                 step, tokens/s and the weight-streaming bound of a step.
                 Then 32 teacher-forced steps of the same tokens through B5
                 and through the plain attention (one set of weights): logits
                 within 0.05 x max|logits|, argmax equal wherever the plain
                 run's top-two margin exceeds twice that.
  4. lm_time   — B5 beside its bound, its plain version and one
                 ``scaled_dot_product_attention`` call at (a) the serve shape
                 and (b) the decode_32k shape (B=128, T=32,768, 4.3 GB of K/V)
                 full and with half its blocks unneeded: event loops, B5's
                 and SDPA's device time in a CUDA graph (which proves B5's
                 call captures), B5's device time by kernel, and the share
                 bound / ms.
  5. lm_profile — device time and idle share over 32 decode steps of the
                 full-width serve loop.
  6. lm_families — the serving path of every family at its published
                 width, weights seeded on the card, one model at a time:
                 gemma-2b (18 layers; B=4, S=512 on the dense attention and
                 S=1,024 on the chunked one), gemma3-4b (34 layers; B=2,
                 S=2,048, the local layers' window caches rotating),
                 mamba2-370m (48 layers; B=4, S=2,048), zamba2-2.7b (54
                 layers; B=2, S=2,048), whisper-base (6 + 6 layers; B=4,
                 1,500 frames and tokens), qwen3-moe-235b-a22b (4 of 94
                 layers, capacity factor 8; B=2, S=1,024) and qwen2-vl-72b
                 (8 of 80 layers; B=2, S=1,024 with 256 stub vision
                 embeddings).  ``prefill`` of S tokens (max_len = S + 64)
                 and one ``decode_step`` of token S against ``forward`` over
                 S + 1 tokens at the last position (max |d| < 0.05 x
                 max|logits| and the argmax equal on every row; moe: the
                 90th percentile < 0.06 x max and half the argmaxes);
                 8 teacher-forced steps from the primed cache, each from
                 one cache state through B5 and through the plain
                 attention, within the same bounds
                 (the argmax equal where the plain run's top-two margin
                 exceeds twice the bound, as in lm_serve);
                 B5's count zeroed before and read after each decode run:
                 attention layers (n_layers; zamba2's n_layers / 6; 0 for
                 mamba2) x steps; ``serve_batch(smoke=False, n_requests=4,
                 max_batch=2, max_new=8, max_len=256)`` for the five that
                 fit whole; prefill ms against its FLOP bound and ms per
                 decode step against its byte bound; the chunked attention
                 of one layer against one SDPA call at six prefill shapes.

  7. lm_train  — the training path (``repro_torch.launch.steps``,
                 ``optim``, ``data``, ``launch.train``), which launches
                 none of B1-B5: (a) gemma-2b at its published width and
                 depth, weights seeded on the card, batches
                 ``TokenStream(vocab=256000, seq_len=1024,
                 global_batch=2)``: ``make_train_step`` with
                 ``remat="none"`` and again ``"full"`` from the same
                 state, one warm-up and 3 timed steps each (loss and
                 grad norm finite, parameters moved, the two policies'
                 first steps within 1e-5), ms a step (CUDA events)
                 against the FLOP bound, tokens/s, peak GB, the idle
                 share over one step (torch.profiler); one layer's chunked
                 attention backward (B=2, S=1,024, H=8, KV=1, hd=256, bf16)
                 against autograd through the dense f32 softmax (within
                 0.02 x max) and its ms against the forward's and one
                 SDPA forward + backward; (b) one ``microbatches=2`` step
                 of each family's smoke configuration (loss finite,
                 parameters moved; the moe step twice, bit-equal);
                 (c) ``train_loop('gemma-2b', steps=300, ckpt_every=50,
                 inject_failures=True)`` on the card under the git-ignored
                 ``build/``: loss_last10 < loss_first10, 1 restart, >= 1
                 straggler event.
  7b. lm_mesh  — the multi-card layer on a one-rank NCCL mesh
                 (``make_local_mesh(1, 1)``, its ``file://`` store under
                 the git-ignored ``build/mesh/``; the group is destroyed at
                 the end): (a) qwen3-moe-235b-a22b at 4 of 94 layers
                 (capacity factor 8, seeded weights) through
                 ``make_prefill_step`` / ``make_decode_step`` with their
                 plans (``param_shardings``; the decode's serving layout,
                 ``fsdp=False, moe_2d=True``; the cache held as
                 ``cache_pspecs`` lays it out): prefill at B=2, S=1,024 and
                 8 decode steps through B5, every logit bit-equal to the
                 same model's without a mesh (B5 counted: 4 x 8); then
                 ``moe_ffn_ep`` on layer 0's experts at the prefill and the
                 decode shape, y and aux bit-equal to ``moe_ffn``, both
                 timed; (b) gemma-2b at full width, B=2, S=1,024, batches
                 from ``sharded_batches(stream, mesh, batch_pspec(2,
                 mesh))``: ``make_train_step(param_shardings=plan)``'s
                 first step on the rank's blocks (``shard_params``; loss,
                 grad norm, every updated parameter gathered back)
                 bit-equal to the step without a plan from the same state,
                 ms a step; (c) ``compressed_psum`` over 'data' on that
                 batch's gradient tree: mean and error bit-equal to
                 ``decompress(compress(g, e))``, ms and the int8 bytes;
                 (d) ``state_specs`` and ``cache_specs`` (decode_32k) of
                 the ten registry configurations on the meta device,
                 ``memory_allocated`` unchanged, with one rank's parameter,
                 optimizer and cache bytes under the (16, 16) plan
                 (computed, not measured); (e) ``roofline.model_flops``
                 beside this script's ``prefill_bound``/``train_bound``
                 FLOP counts for lm_families' and lm_train's shapes; (f)
                 after the group is gone, ``python3 chip_smoke.py
                 --mesh-rank`` in a process of its own: rank 0 of gemma-2b
                 ``train_4k`` on the (16, 16) plan over a ``fake``
                 256-rank group, its blocks and its 16 rows real CUDA
                 tensors, one train step with the residual stream
                 sequence parallel over 'model' (values not checked):
                 ``max_memory_allocated`` within 15% of the dry run's
                 fake-tensor peak for the same cell (lm_dryrun's trace)
                 and under the card's memory, its arguments the plan's
                 bytes; (g) in the same process, rank 0 of command-r-35b
                 ``decode_32k`` at full width on the plan's serving
                 layout, its cache block seeded in the plan's layout
                 (head_dim over 'model'), one decode step: peak within
                 15% of the dry run's for that cell, B5 launched 0 times
                 by design (the rank attends over its head_dim block),
                 ms a step printed as compute only (the fake group moves
                 no bytes); (h) on the one-rank mesh, mamba2-370m at full
                 width: the planned train step (B=2, S=512) and the planned
                 prefill + 4 decode steps bit-equal to the unplanned ones;
                 then in (f)'s process rank 0 of zamba2-2.7b
                 ``decode_32k`` on the (16, 16) serving layout (each
                 mamba2 layer on the rank's 5 of 80 heads, the SSM state
                 held with its head_dim over 'model'), one decode step:
                 peak within 15% of the dry run's for that cell, its
                 collectives over 'model' and 'data' equal to the dry
                 run's record, its all-gathers over 'model' below the
                 layers' state blocks (no state gathered whole), B5
                 launched once a shared attention layer (9).
  7c. lm_dryrun — the dry run (``launch/dryrun.py``) against real steps
                 of gemma-2b at full width: (a) the train step at
                 lm_train's B=2, S=1,024 (remat full): ``FlopCounterMode``
                 on the card equal to ``patch_probe.probe_cell``'s count on
                 the meta device, and ``dryrun.trace_step``'s fake-tensor
                 peak on the card's device within 15% of
                 ``max_memory_allocated``; (b) prefill at B=4, S=1,024
                 (the chunked path) and (c) the decode step at B=4,
                 max_len 1,024 (B5 launched 18 times), FLOPs equal as in
                 (a); (d) B5's operator ``torch.ops.repro_torch.decode_attn``
                 against its plain version at the serve shape
                 (atol=rtol=1e-4, two launches bit-equal) and the wrapper's
                 ms through it against the direct launch; (e)
                 ``python -m repro_torch.launch.dryrun`` on gemma-2b x
                 train_4k (pod) in a subprocess on the CPU, started before
                 lm_kernel, its record under the git-ignored
                 ``build/dryrun/``.

  The graph slices (views freed of the LM's weights):

  8. graph   — ``rmat(16, edge_factor=16, seed=1)``: n=65,536, m=955,396;
               its 128x128 f32 tile view (239,398 tiles, ~15.7 GB) lives on
               the card, with the row payload B1 reads and the tile-major
               payload B2 reads (955,396 entries of 12 B each, built from
               the tiles on the card): logs the payloads' build time and
               bytes.
  9. main    — after one warm-up run per backend and residency on rmat(10),
               the slice-1 path through ``repro_torch.Graph``:
               ``pagerank()`` push and pull and ``bfs(0)``/``bfs(hub)`` on the
               backends scan, compact, blocked and blocked_compact, plus
               ``bfs([0, 1, 2, 3])`` on blocked.  Kernel launch counts are
               zeroed just before and read just after; B1 and B2 must have
               run.
  10. check   — BFS levels equal across backends and equal a numpy BFS of the
               host CSR; K-lane BFS equals K single-source numpy BFS runs;
               PageRank agrees across backends (atol 1e-6, rtol 1e-5) and
               with a numpy power iteration within the push/pull error bound
               (L1 <= tol / (1 - damping)); BFS IOStats agree field for field
               between backends sharing a layout and in the layout-free
               fields (messages, supersteps) across all four.
  11. wcc     — ``Graph.run(WCC)`` (min-label propagation, the MIN_PLUS
               program of ``examples/custom_program.py``) on
               ``rmat(16, edge_factor=16, seed=1, symmetrize=True)``
               (n=65,536, m=1,820,044; its min_plus tile view holds 257,273
               tiles, ~16.9 GB, and payloads of 1,820,044 entries, whose
               build time and bytes are logged) on all four backends, device
               residency, with
               the counts zeroed just before and read just after: B3 and B4
               must have run.  Labels equal across backends and equal a
               numpy union-find labelling; IOStats as in phase 10.
  12. batched — the batched (n, Q) driver on the main view, device
               residency, all four backends, with the counts zeroed just
               before and read just after (B1 and B2 must have run; the lane
               widths the kernels saw are logged): ``bfs(S)`` for the 32
               vertices of largest out-degree (ties to the lower id), each
               lane equal to numpy BFS, ``query_supersteps`` equal to the
               solo ``bfs(s)`` runs on blocked, ``iostats.queries == 32``,
               IOStats as in phase 10; ``run(BFSProgram(), seeds=S,
               batch=32)`` equal to it; ``pagerank(reset=S[:16])`` and a
               float (n, 4) reset matrix from ``--seed``, each column within
               atol=1e-6, rtol=1e-5 of its width-one run and within
               tol / (1 - damping) in L1 of a numpy personalized power
               iteration.  Logs the wall per query against the solo walls
               and how many columns are bit-equal to their solo runs.
  13. algs    — on ``rmat(16, symmetrize=True)`` (its plus_times forward and
               reverse tile views), counts zeroed before and read after:
               ``coreness()`` dense/p2p/hybrid on scan and blocked, equal to
               numpy peeling; ``betweenness(S32)`` 'multi' on scan, blocked
               and blocked_compact, 'uni' with ``batch=8`` on blocked and
               'fused', within rtol=1e-4 of a numpy level-synchronous
               Brandes (B1 and B2 must have run over the reverse view);
               ``diameter(num_sources=32)`` on blocked, equal to a numpy
               replay of its sweeps; ``triangles(policy=blocked)`` on
               ``rmat(14, symmetrize=True)`` (a 1.07 GB dense product) equal
               to the numpy ladder.
  14. host    — host residency (edges in host RAM, streamed per superstep)
               against device residency in this process:
               (a) ``rmat(20, edge_factor=16, seed=1)`` (n=1,048,576) on scan
                   and compact: ``pagerank()`` push and pull (capped at 8
                   and 15 supersteps), ``bfs(hub)``;
               (b) ``rmat(14, edge_factor=16, seed=1, symmetrize=True)`` on
                   blocked and blocked_compact: WCC, ``bfs(hub)`` and
                   ``pagerank()`` (capped at 20 supersteps) at the default
                   ``stream_buffer=16``, then
                   WCC on a 'hilbert' schedule at 16 and WCC and
                   ``bfs(hub)`` there at ``stream_buffer=1`` (a batch per
                   run, several runs per block).
               BFS levels, WCC labels and (a)'s PageRank bit-equal (the
               chunk stream's running sums, ``Semiring.fold``), (b)'s
               PageRank within atol 1e-6, rtol 1e-5; IOStats equal except
               host_bytes and retries (but (b)'s PageRank counters, logged:
               f32 rounding order moves them, ROADMAP §C P2),
               ``device_edge_total == 0`` under
               host residency, and ``peak_stage_bytes <= 2 *
               stream_buffer_bytes`` where no run exceeds the buffer.  Tile
               batches stage the tile-major payload of their tiles:
               ``streamed_bytes`` must equal that payload and schedule,
               counted from the store's ``tile_ptr`` over each batch
               (``StageLog``), plus what other arms ship, and
               ``IOStats.host_bytes`` the reference's dense batch layout
               (G tiles and the schedule) plus the same, modulo 2^32.  Logs each wall
               beside its device twin and their ratio, and the streamed
               bytes per second beside the pinned host-to-device rate of a
               plain 1 GB copy.  Host launches of B2/B4 are counted apart
               from the main paths'.
  15. batched_host — ``bfs`` of 8 sources (``default_rng(7)`` over the
               vertices with an out-edge, as ``benchmarks/
               bench_multisource.py`` draws them) under host residency on
               rmat(20) (scan) and the rmat(14, symmetrize) tile store
               (blocked_compact): values, query supersteps and IOStats but
               host_bytes and retries equal device residency's, and
               ``host_bytes`` a query at least 4x below the 8 solo host
               runs' mean (the benchmark's gate; the factor is logged).
  16. kernels — both payloads scattered back equal the dense tiles of the
               full-size main and wcc views (a chunk of tiles at a time, on
               the card); B1-B4 held against their plain torch versions on
               the card (K=1 and K=4; full and n/8 frontiers; the 'dest'
               views at the main paths' shapes and 'hilbert' views of
               rmat(14)): B1/B2 within atol=rtol=1e-5, B3/B4 with
               ``torch.equal``, each against both the dense plain version
               and the plain version of its payload arithmetic, and two
               launches of each must give the same bits.  Then, on an x
               holding +inf, -inf and NaN, all four against their plain
               versions, NaN for NaN (ROADMAP §C P12).  B1/B2 also at
               K=4, 32, 192 and 256 (two lane groups) on both views and
               frontiers, every column ``torch.equal`` to the K=1 call on
               that column.
  17. time    — each kernel at K=1 beside its bound, its plain version and a
               library call over the same live edges (``torch.sparse.mm``
               for B1/B2, ``scatter_reduce_(..., 'amin')`` for B3/B4), and
               one call's device time in a CUDA graph and by kernel
               (torch.profiler).  The bound counts the
               bytes the payload design must read (B1/B3 ``bound_rows``: 12 B
               a live entry, a row pointer and a y value a row, the x blocks
               of live tiles, the activity flag of each tile; B2/B4
               ``bound_compact_rows``: 12 B a live entry, three words of
               list and pointers a live tile, the x blocks of live tiles,
               y); the dense tile bound of the earlier design is
               logged beside it, as is the dense plain version's time.
               B1 and B2 again at K=4, 16 and 32 (the widths of the
               batched paths as columns retire; ``k4_*``, ``k16_*`` and
               ``k32_*`` keys of the kernels line), each with its bound and
               ``torch.sparse.mm`` at that K.
  18. recovery — kill and resume on the card (``repro_torch.core.recovery``).
               First the sum scatter's fixed order (ROADMAP §C P17): scan
               and compact ``pagerank()`` on the main view with the
               fixed-order add and with the ``index_add_`` it replaced, in
               turns (the fixed-order runs must be bit-equal; walls
               logged).  Then, with the counts zeroed just before and read
               just after (B1-B4 must all have run), each of these runs
               twice uninterrupted (the two must be bit-equal, else the
               phase fails naming the run) and once killed and resumed
               from its newest snapshot (which must equal them: values,
               supersteps and all ten IOStats fields, ``host_bytes`` and
               ``retries`` included): on the main view, blocked (B1) and
               blocked_compact (B2), PageRank push under ``run_supervised``
               with ``every_k=8`` killed at supersteps 5 and 21, BFS from
               the hub (``every_k=2``, killed at 3), and the batched BFS of
               the 8 top-degree sources (killed at 3, resumed); WCC on the
               wcc view, blocked (B3); host (b)'s WCC on blocked_compact
               (B4); host (a)'s scan PageRank push (16 supersteps,
               ``every_k=4``, killed at 6).  Logs per run the replayed
               supersteps, saves, ``sync_s``, snapshot bytes and the bytes
               the host replays streamed again, and the walls of blocked
               PageRank push (main view) and host (a) scan PageRank push at
               ``every_k`` 1 and 8 and without checkpoints.
  19. analysis — the contract checker (``repro_torch.analysis``) on the
               card, over the views the script already holds, counts zeroed
               before and read after (B1-B4 must all have run): the
               zero-findings gate of ``python -m
               repro_torch.analysis.semlint --analyze`` (BFS, PageRank push
               and pull, coreness, betweenness forward and backward,
               personalized PageRank and the README's WCC) on the wcc and
               main views under scan, compact, blocked and blocked_compact,
               on host (b) under blocked_compact and host (a) under scan;
               the recorded superstep of the main view's PageRank push must
               launch B1 (blocked) and B2 (blocked_compact), the wcc view's
               WCC B3 and B4.  Each pair's superstep also runs under
               ``torch.cuda.set_sync_debug_mode('warn')``, and no user frame
               may synchronize (R2 found none).  The extra tile views each
               graph needs are freed before the next.  Then the broken
               fixtures of ``tests/test_analysis.py`` (twins on the WCC
               program) must each raise exactly their rule (B1's R1 on host
               (b)), and B2's R2 line must be the one line the sync debug
               mode reports.  Logs the first and the cached ``analyze()``
               wall and ``run()`` against ``run(analyze=True)`` (cached and
               not) for blocked PageRank push on the main view and host
               (b)'s blocked_compact WCC, whose results must be bit-equal.
  20. profile — device time and idle share of blocked PageRank, blocked BFS,
               blocked WCC, blocked_compact PageRank and WCC, host scan
               PageRank (10 supersteps), host blocked_compact WCC, and
               blocked batched BFS (Q=32) and personalized PageRank (Q=16);
               batched BFS's largest kernel is named by the ``repro_torch``
               lines that launched it (``with_stack=True``).
  21. chaos   — with the parent's views freed, a ``DurableWorkQueue`` of 12
               tasks (the batched BFS of 2 sources, over the 8 top-degree
               vertices of host (b)'s graph, on scan, compact and blocked)
               served by 3 worker processes spawned on the card, two
               SIGKILLed mid-lease and two stalled past their lease and
               restarted by ``supervise_workers``: the merge must be
               bitwise the single-process run's, every lane equal to numpy
               BFS, no task lost or committed twice, and more than 0 late
               commits refused.

  22. examples — the six twins of ``examples/`` in ``examples_torch/``,
               each through its ``main`` on the card (its wall logged with
               the card's ``name, power.limit``; ``Graph`` methods and the
               LM drivers wrapped to keep what they return):
               ``custom_program`` (WCC labels equal numpy union-find),
               ``quickstart`` (PageRank push and pull within the numpy
               bound of phase 10, BFS levels equal numpy BFS, kmax and the
               WCC labels equal numpy's, the host session's
               ``device_edge_total`` 0, its ranks bit-equal to the device
               run's by the twin's own assert) and ``batched_queries``
               (each PPR column within the numpy bound, each BFS column
               equal numpy BFS) as written; ``graph_analytics --scale 16``
               (``rmat(16, edge_factor=8, symmetrize=True)``; kmax equal
               numpy peeling; its host rerun bit-equal by its assert);
               B1-B4 launches over the graph twins logged (0: their
               policies pick scan and compact); ``serve_lm`` (gemma3-4b
               smoke) and ``serve_lm --full`` (34 layers), B5's count
               zeroed before each and read after: n_layers x
               decode_steps, tokens, ms a decode step, peak GB;
               ``train_lm`` (300 steps, checkpoints under the git-ignored
               ``build/examples/``): exit 0, so the loss fell and a
               restart happened.

Prints the card's ``name, power.limit``, a ``{"kernels": [...]}`` line
(B1-B5; B1/B2's launches are the main, batched, algorithm, host batched,
recovery and analysis paths', B3/B4's the WCC, recovery and analysis
paths', B5's the lm_serve, lm_families, lm_mesh, lm_dryrun and examples
paths')
and, last, ``{"ok": true, "device": {...}}``.  ``--seed`` seeds
the batched phase's reset matrix (default 0).  Exits non-zero without a CUDA
device, and when the repository's ``src/`` is not beside it.
"""
from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
BACKENDS = ("scan", "compact", "blocked", "blocked_compact")
PR_ATOL, PR_RTOL = 1e-6, 1e-5
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
# The order-invariant fields of one storage layout (scan/compact chunks vs
# blocked tiles); ``messages`` and ``supersteps`` are the same in every
# layout.
LAYOUT_FREE = ("messages", "supersteps")
# Depth cuts of the host phase, for the script's time: PageRank pull at
# scale 20 runs into its default cap of 100 supersteps (31 s on host; at
# 30, four push and pull runs took 115 s of a 1,128 s run on a slow H100
# host), push at 8 (65 to convergence at 0.33-0.7 s a superstep), the
# scale-14 tile PageRank takes 36-40 s on host, and the profiler multiplies
# a host PageRank's 18 s wall by ten (at 10 supersteps its key_averages
# took 90 s of a 1,107 s run on one H100 host; 3 keep the idle share's
# reading).  Host and device runs get the same cap.
PULL_ITERS_20, PUSH_ITERS_20, PUSH_ITERS_14, PROFILE_ITERS = 15, 8, 20, 3


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def numpy_bfs(g, source: int):
    import numpy as np

    from repro_torch.algs import UNREACHED

    dist = np.full(g.n, UNREACHED, np.int32)
    dist[source] = 0
    frontier = np.asarray([source])
    level = 0
    while frontier.size:
        starts, ends = g.indptr[frontier], g.indptr[frontier + 1]
        counts = ends - starts
        idx = np.repeat(starts - np.cumsum(counts) + counts, counts) + np.arange(
            counts.sum())
        nbrs = np.unique(g.indices[idx])
        nbrs = nbrs[dist[nbrs] == UNREACHED]
        level += 1
        dist[nbrs] = level
        frontier = nbrs
    return dist


def numpy_pagerank(g, damping: float, iters: int = 300):
    import numpy as np

    deg = np.diff(g.indptr)
    src = np.repeat(np.arange(g.n), deg)
    rank = np.full(g.n, 1.0 / g.n)
    share = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    for _ in range(iters):
        new = (1 - damping) / g.n + damping * np.bincount(
            g.indices, weights=(rank * share)[src], minlength=g.n)
        if np.abs(new - rank).max() < 1e-15:
            return new
        rank = new
    return rank


def io_dict(io) -> dict:
    return {k: int(v) for k, v in zip(io._fields, io)}


def check_io(label: str, a: dict, b: dict, fields) -> None:
    bad = {f: (a[f], b[f]) for f in fields if a[f] != b[f]}
    if bad:
        raise AssertionError(f"{label}: IOStats differ {bad}")


ROW_PAYLOAD = ("row_ptr", "ent_tile", "ent_src", "ent_w", "seg_ptr",
               "row_seg")
TILE_PAYLOAD = ("tile_ptr", "tent_row", "tent_src", "tent_w")
PAYLOAD = ROW_PAYLOAD + TILE_PAYLOAD


def payload_build(label: str, bg, torch) -> None:
    """Build the view's payloads once more from its tiles, timed, and
    check that they are the view's own; log their time and bytes."""
    from repro_torch.kernels.spmv import ops

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = ops.row_payload(bg.tiles, bg.dbid, bg.sbid, n=bg.n, bd=bg.bd,
                              bs=bg.bs, semiring=bg.semiring)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    for name in PAYLOAD:
        if not torch.equal(payload[name], getattr(bg, name)):
            raise AssertionError(f"{label}: payload {name} differs between "
                                 "two builds")
    nbytes = sum(getattr(bg, name).nbytes for name in ROW_PAYLOAD)
    tbytes = sum(getattr(bg, name).nbytes for name in TILE_PAYLOAD)
    if bg.payload_nbytes != nbytes + tbytes:
        raise AssertionError(f"{label}: payload_nbytes {bg.payload_nbytes} "
                             f"!= {nbytes + tbytes}")
    counts = torch.diff(bg.row_ptr.long()).float()
    p50, p99 = torch.quantile(counts, torch.tensor([0.5, 0.99],
                                                   device=counts.device))
    per_tile = torch.diff(bg.tile_ptr.long())
    log(f"{label}: row payload {bg.ent_tile.numel()} entries, "
        f"{bg.seg_ptr.numel() - 1} segments, {nbytes} B; tile-major payload "
        f"{tbytes} B; together {(nbytes + tbytes) / bg.tiles.nbytes:.2e} of "
        f"the tiles' bytes, built from the tiles in {ms:.1f} ms; entries a "
        f"row: mean {float(counts.mean()):.1f}, median {float(p50):.0f}, p99 "
        f"{float(p99):.0f}, max {int(counts.max())}, empty rows "
        f"{int((counts == 0).sum())}; entries a tile: max "
        f"{int(per_tile.max())}")


def payload_tiles(bg, lo: int, hi: int, torch):
    """Tiles ``lo:hi`` rebuilt from the view's row payload alone, the other
    slots holding the absent value."""
    from repro_torch.kernels.spmv import kernel as K

    absent = float("inf") if bg.semiring == "min_plus" else 0.0
    out = torch.full((hi - lo, bg.bd, bg.bs), absent, dtype=torch.float32,
                     device=bg.tiles.device)
    t = bg.ent_tile.long()
    keep = (t >= lo) & (t < hi)
    t = t[keep]
    row = K.entry_rows(bg)[keep]
    src = bg.ent_src[keep].long()
    out[t - lo, row - bg.dbid[t].long() * bg.bd,
        src - bg.sbid[t].long() * bg.bs] = bg.ent_w[keep]
    return out


def tile_payload_tiles(bg, lo: int, hi: int, torch):
    """Tiles ``lo:hi`` rebuilt from the view's tile-major payload alone."""
    absent = float("inf") if bg.semiring == "min_plus" else 0.0
    out = torch.full((hi - lo, bg.bd, bg.bs), absent, dtype=torch.float32,
                     device=bg.tiles.device)
    tp = bg.tile_ptr.long()
    e0, e1 = int(tp[lo]), int(tp[hi])
    t = torch.repeat_interleave(torch.arange(lo, hi, device=tp.device),
                                torch.diff(tp[lo:hi + 1]),
                                output_size=e1 - e0)
    out[t - lo, bg.tent_row[e0:e1].long(),
        bg.tent_src[e0:e1].long() - bg.sbid[t].long() * bg.bs] = (
            bg.tent_w[e0:e1])
    return out


def check_payload(label: str, bg, torch, chunk: int = 4096) -> None:
    """Both payloads scattered back equal the dense tiles, chunk by
    chunk."""
    for t0 in range(0, bg.num_tiles, chunk):
        t1 = min(t0 + chunk, bg.num_tiles)
        for name, rebuild in (("row", payload_tiles),
                              ("tile-major", tile_payload_tiles)):
            if not torch.equal(rebuild(bg, t0, t1, torch), bg.tiles[t0:t1]):
                raise AssertionError(f"{label}: {name} payload does not "
                                     f"rebuild tiles {t0}:{t1}")
    log(f"kernel check {label}: the row and tile-major payloads rebuild all "
        f"{bg.num_tiles} tiles ({bg.tiles.nbytes / 1e9:.2f} GB)")


def phase_main(G, hub, torch):
    """The main path; returns results and the launch counts it caused."""
    import repro_torch
    from repro_torch.kernels.spmv import kernel as K

    results, wall = {}, {}
    K.reset_launches()
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        for name, call in (
            ("pr_push", lambda: G.pagerank(policy=pol)),
            ("pr_pull", lambda: G.pagerank(mode="pull", policy=pol)),
            ("bfs0", lambda: G.bfs(0, policy=pol)),
            ("bfs_hub", lambda: G.bfs(hub, policy=pol)),
        ):
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall[(backend, name)] = (time.perf_counter() - t0) * 1e3
            results[(backend, name)] = res
            log(f"main {backend:16s} {name:8s} supersteps={int(res.supersteps)}"
                f" wall_ms={wall[(backend, name)]:.1f}")
    for backend, name, sources in (("blocked", "bfs4", [0, 1, 2, 3]),
                                   ("blocked_compact", "bfs4_hub",
                                    [hub, 1, 2, 3])):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        t0 = time.perf_counter()
        results[(backend, name)] = G.bfs(sources, policy=pol)
        torch.cuda.synchronize()
        wall[(backend, name)] = (time.perf_counter() - t0) * 1e3
    counts = dict(K.launches)
    log(f"main path kernel launches: {counts}")
    require_launched("main path", counts, ("spmv_blocked",
                                           "spmv_blocked_compact"))
    return results, wall, counts


def phase_check(g, hub, results, torch, damping=0.85, tol=1e-3) -> None:
    import numpy as np

    from repro_torch.algs import UNREACHED

    for run, source in (("bfs0", 0), ("bfs_hub", hub)):
        levels = numpy_bfs(g, source)
        ref_io = {}
        for backend in BACKENDS:
            res = results[(backend, run)]
            if not np.array_equal(res.values.cpu().numpy(), levels):
                raise AssertionError(f"{run} on {backend} differs from numpy BFS")
            ref_io[backend] = io_dict(res.iostats)
        check_io(f"{run} scan/compact", ref_io["scan"], ref_io["compact"],
                 ref_io["scan"].keys())
        check_io(f"{run} blocked/blocked_compact", ref_io["blocked"],
                 ref_io["blocked_compact"], ref_io["blocked"].keys())
        for backend in BACKENDS[1:]:
            check_io(f"{run} scan/{backend}", ref_io["scan"], ref_io[backend],
                     LAYOUT_FREE)
        reached = levels != UNREACHED
        log(f"{run}: source {source} reaches {int(reached.sum())} vertices in "
            f"{int(levels[reached].max())} levels; all backends equal; "
            f"supersteps {ref_io['scan']['supersteps']}")
    for backend, run, sources in (("blocked", "bfs4", [0, 1, 2, 3]),
                                  ("blocked_compact", "bfs4_hub",
                                   [hub, 1, 2, 3])):
        multi = results[(backend, run)].values.cpu().numpy()
        if multi.shape != (g.n, 4):
            raise AssertionError(f"bfs({sources}) shape {multi.shape}")
        for lane, source in enumerate(sources):
            if not np.array_equal(multi[:, lane], numpy_bfs(g, source)):
                raise AssertionError(f"bfs({sources}) lane {lane} differs "
                                     "from numpy BFS")
    log("bfs([0, 1, 2, 3]) and bfs([hub, 1, 2, 3]): every lane equals numpy BFS")

    ref = numpy_pagerank(g, damping)
    for mode in ("pr_push", "pr_pull"):
        base = results[("scan", mode)].values.cpu()
        for backend in BACKENDS:
            vals = results[(backend, mode)].values.cpu()
            if vals.shape != (g.n,) or not torch.isfinite(vals).all():
                raise AssertionError(f"{mode} {backend}: bad values")
            torch.testing.assert_close(vals, base, atol=PR_ATOL, rtol=PR_RTOL)
            l1 = float(np.abs(vals.double().numpy() - ref).sum())
            if l1 > tol / (1 - damping):
                raise AssertionError(f"{mode} {backend}: L1 error {l1} vs "
                                     f"numpy power iteration")
        ios = {b: io_dict(results[(b, mode)].iostats) for b in BACKENDS}
        log(f"{mode}: backends agree; supersteps "
            f"{[ios[b]['supersteps'] for b in BACKENDS]}, messages "
            f"{[ios[b]['messages'] for b in BACKENDS]}")


def require_launched(path: str, counts: dict, names) -> None:
    for name in names:
        if counts.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path}")


_WCC = None


def wcc_program():
    """Weakly connected components by min-label propagation: the MIN_PLUS
    program of ``examples/custom_program.py``, written against the port's
    public ``VertexProgram`` as a user would."""
    global _WCC
    if _WCC is None:
        from typing import NamedTuple

        import torch

        import repro_torch
        from repro_torch.core.semiring import MIN_PLUS

        class WCCState(NamedTuple):
            labels: torch.Tensor
            active: torch.Tensor

        class WCCProgram(repro_torch.VertexProgram):
            semiring = MIN_PLUS

            def init(self, sg, seeds):
                return WCCState(
                    labels=torch.arange(sg.n, dtype=torch.float32,
                                        device=sg.device),
                    active=torch.ones(sg.n, dtype=torch.bool,
                                      device=sg.device))

            def frontier(self, sg, s):
                return repro_torch.Frontier(x=s.labels, active=s.active)

            def apply(self, sg, s, gathered):
                labels = torch.minimum(s.labels, gathered)
                changed = labels < s.labels
                return WCCState(labels, changed), changed

            def finalize(self, sg, s):
                return s.labels.to(torch.int32)

        _WCC = WCCProgram
    return _WCC()


def numpy_wcc(g):
    """Component labels (smallest vertex id of each weakly connected
    component) by union-find with pointer jumping, in numpy."""
    import numpy as np

    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    parent = np.arange(g.n)
    while True:
        pu, pv = parent[src], parent[dst]
        hi, lo = np.maximum(pu, pv), np.minimum(pu, pv)
        before = parent.copy()
        np.minimum.at(parent, hi, lo)
        while True:  # pointer jumping to the roots
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
        if np.array_equal(parent, before):
            return parent.astype(np.int32)


def timed(fn, torch):
    """(result, wall ms, kernel launches it made)."""
    from repro_torch.kernels.spmv import kernel as K

    before = dict(K.launches)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return res, ms, {k: K.launches[k] - before[k] for k in before}


def phase_wcc(torch):
    """WCC through ``Graph.run`` on the four backends (device residency)."""
    import numpy as np

    import repro_torch
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    t0 = time.perf_counter()
    wg = rmat(16, edge_factor=16, seed=1, symmetrize=True)
    if (wg.n, wg.m) != (65536, 1820044):
        raise AssertionError(f"rmat(16, symmetrize) gave n={wg.n} m={wg.m}")
    W = repro_torch.Graph(wg, device="cuda")
    wbg = W.device(blocked=True, blocked_semiring="min_plus").out_blocked
    torch.cuda.synchronize()
    log(f"wcc graph: n={wg.n} m={wg.m} min_plus tiles={wbg.num_tiles} "
        f"({wbg.tiles.nbytes / 1e9:.2f} GB on the card) built in "
        f"{time.perf_counter() - t0:.1f} s")
    payload_build("wcc graph", wbg, torch)
    want = numpy_wcc(wg)
    results, wall = {}, {}
    K.reset_launches()
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        t0 = time.perf_counter()
        results[backend] = W.run(wcc_program(), policy=pol)
        torch.cuda.synchronize()
        wall[backend] = (time.perf_counter() - t0) * 1e3
        log(f"wcc {backend:16s} supersteps="
            f"{int(results[backend].supersteps)} wall_ms={wall[backend]:.1f}")
    counts = dict(K.launches)
    log(f"wcc path kernel launches: {counts}")
    require_launched("wcc path", counts, ("spmv_blocked_min_plus",
                                          "spmv_blocked_compact_min_plus"))
    ios = {}
    for backend, res in results.items():
        if not np.array_equal(res.values.cpu().numpy(), want):
            raise AssertionError(f"wcc on {backend} differs from numpy "
                                 "union-find")
        ios[backend] = io_dict(res.iostats)
    check_io("wcc scan/compact", ios["scan"], ios["compact"],
             ios["scan"].keys())
    check_io("wcc blocked/blocked_compact", ios["blocked"],
             ios["blocked_compact"], ios["blocked"].keys())
    for backend in BACKENDS[1:]:
        check_io(f"wcc scan/{backend}", ios["scan"], ios[backend],
                 LAYOUT_FREE)
    log(f"wcc: {len(np.unique(want))} components, largest "
        f"{int(np.bincount(want).max())} vertices; all backends equal "
        f"numpy union-find; supersteps {ios['scan']['supersteps']}")
    return W, wg, wall, counts


def pinned_h2d_rate(torch, nbytes: int = 1 << 30) -> float:
    """Bytes per second of one plain pinned host-to-device ``copy_``."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps=5)
    del src, dst
    return nbytes / (ms / 1e3)


def max_run_tiles(session, semiring: str, tile_order: str) -> int:
    """The longest run of the host tile store (a run is never split)."""
    import numpy as np

    st = session.host_view().blocked_store(semiring, reverse=False,
                                           tile_order=tile_order)
    starts = np.flatnonzero(st.first)
    return int(np.diff(np.append(starts, st.num_tiles)).max())


class StageLog:
    """Within the ``with`` block, records the batches host residency cuts
    from its tile stores (``residency._tile_batches``) and counts, from
    each store's ``tile_ptr`` and each batch's schedule positions, what a
    batch of ``kk`` tiles holding ``E`` payload entries must ship:
    ``payload``, the tile-major payload and schedule (12 B an entry, a
    local tile pointer of kk + 1 words, six G-step int32 arrays with G the
    power of two at least kk, and the live count), and ``dense``, the
    reference's batch (G dense Bd x Bs f32 tiles, the six arrays and the
    count, ``src/repro/core/residency.py``).  Any other payload (chunk
    batches, the point-to-point arm) ships alike in both counts."""

    def __init__(self):
        self.payload = self.dense = 0

    def __enter__(self):
        import numpy as np

        from repro_torch.core import residency

        self._batches = cut = residency._tile_batches

        def counted(store, live, B):
            batches, run_id = cut(store, live, B)
            tp = store.tile_ptr.astype(np.int64)
            for pos, _ in batches:
                kk = len(pos)
                G = 1 << (kk - 1).bit_length()
                E = int((tp[pos + 1] - tp[pos]).sum())
                self.payload += 12 * E + 4 * (kk + 1) + 24 * G + 4
                self.dense += G * (store.bd * store.bs * 4 + 24) + 4
            return batches, run_id

        residency._tile_batches = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import residency

        residency._tile_batches = self._batches


def staged_run(label, H, call, torch):
    """One host-residency call with its byte counts: ``(result, wall ms,
    launches, host_bytes, streamed, tile payload)``.  ``streamed`` is what
    the call really copied: the tile batches' payload as :class:`StageLog`
    counts it, plus what other arms (chunk batches, point-to-point) ship.
    ``host_bytes`` is the reference's count, unwrapped: its dense tile
    batches plus the same other arms; IOStats' int32 field, which wraps
    like the reference's, must equal it modulo 2^32."""
    hv = H.host_view()
    before = hv.streamed_bytes
    with StageLog() as tiles:
        res, ms, launched = timed(call, torch)
    streamed = hv.streamed_bytes - before
    other = streamed - tiles.payload
    if other < 0:
        raise AssertionError(f"{label}: streamed_bytes {streamed} is not the "
                             f"tile batches' {tiles.payload} B plus the "
                             "other arms'")
    host_bytes = tiles.dense + other
    hb = int(res.iostats.host_bytes)
    if hb != (host_bytes + 2**31) % 2**32 - 2**31:
        raise AssertionError(f"{label}: host_bytes {hb} is not the "
                             f"reference's {host_bytes} B modulo 2^32")
    return res, ms, launched, host_bytes, streamed, tiles.payload


def check_host(label, dev, host, exact, torch) -> None:
    """Host against device residency: values, and for BFS/WCC every IOStats
    field but host_bytes and retries."""
    if exact:
        if not torch.equal(host.values, dev.values):
            raise AssertionError(f"{label}: host values differ from device")
    else:
        torch.testing.assert_close(host.values, dev.values, atol=PR_ATOL,
                                   rtol=PR_RTOL)
    a, b = io_dict(host.iostats), io_dict(dev.iostats)
    fields = [f for f in a if f not in ("host_bytes", "retries")]
    if exact:
        check_io(label, a, b, fields)
    else:
        diff = {f: (a[f], b[f]) for f in fields if a[f] != b[f]}
        if diff:
            log(f"{label}: PageRank counters differ host/device (P2): {diff}")
    if a["host_bytes"] == 0:
        raise AssertionError(f"{label}: host run shipped nothing")


def phase_host(torch):
    """Host residency against device residency (see the module docstring).
    Returns the host sessions the profile phase reuses and the host
    launch counts."""
    import numpy as np

    import repro_torch
    from repro_torch.graph.generators import rmat

    rate = pinned_h2d_rate(torch)
    log(f"host: pinned host-to-device copy_ of 1 GiB: {rate / 1e9:.2f} GB/s")
    host_counts = {}
    rows = []

    def twin(label, D, H, call, pol, exact, dev_cache):
        key = (label, pol.backend, pol.tile_order)
        if key not in dev_cache:
            dev_cache[key] = timed(lambda: call(D, pol), torch)[:2]
        dres, dms = dev_cache[key]
        hpol = pol.with_(residency="host")
        name = f"{label}/{pol.backend}/{pol.tile_order}/sb{pol.stream_buffer}"
        hres, hms, launched, dense, streamed, payload = staged_run(
            name, H, lambda: call(H, hpol), torch)
        for k, v in launched.items():
            host_counts[k] = host_counts.get(k, 0) + v
        check_host(name, dres, hres, exact, torch)
        if pol.backend in ("blocked", "blocked_compact") and payload == 0:
            raise AssertionError(f"{name}: no tile batch staged")
        hb = int(hres.iostats.host_bytes)
        rows.append((name, dms, hms, streamed))
        log(f"host {name:40s} supersteps={int(hres.supersteps)} device_ms="
            f"{dms:.1f} host_ms={hms:.1f} ratio={dms / hms:.3f} streamed="
            f"{streamed} B ({streamed / (hms / 1e3) / 1e9:.2f} GB/s; tile "
            f"payload {payload} B) host_bytes={hb} (reference's "
            f"layout {dense} B{', wrapped' if hb != dense else ''})")

    def bound_check(H, pol, runs_fit: bool):
        rep = H.memory_report(pol.with_(residency="host"))
        if rep["device_edge_total"] != 0:
            raise AssertionError(f"host session holds device edges: {rep}")
        peak, buf = rep["peak_stage_bytes"], rep["stream_buffer_bytes"]
        if runs_fit and not 0 < peak <= 2 * buf:
            raise AssertionError(f"peak_stage_bytes {peak} > 2 x {buf}")
        log(f"host memory_report: device_edge_total=0 host_store_bytes="
            f"{rep['host_store_bytes']} peak_stage_bytes={peak} "
            f"stream_buffer_bytes={buf}"
            + ("" if runs_fit else " (runs exceed the buffer: no bound)"))

    # (a) chunk stores at scale 20
    t0 = time.perf_counter()
    ga = rmat(20, edge_factor=16, seed=1)
    hub_a = int(np.argmax(np.diff(ga.indptr)))
    Da = repro_torch.Graph(ga, device="cuda")
    Ha = repro_torch.Graph(ga, device="cuda")
    hv = Ha.host_view()
    log(f"host (a): rmat(20) n={ga.n} m={ga.m} hub={hub_a}; chunk stores "
        f"{hv.out_store.nbytes} + {hv.in_store.nbytes} B in host RAM; built "
        f"in {time.perf_counter() - t0:.1f} s")
    dev_cache: dict = {}
    for backend in ("scan", "compact"):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        twin("pr_push", Da, Ha, lambda G, p: G.pagerank(
            max_iters=PUSH_ITERS_20, policy=p), pol, True, dev_cache)
        twin("pr_pull", Da, Ha, lambda G, p: G.pagerank(
            mode="pull", max_iters=PULL_ITERS_20, policy=p), pol, True,
             dev_cache)
        twin("bfs_hub", Da, Ha, lambda G, p: G.bfs(hub_a, policy=p), pol,
             True, dev_cache)
        bound_check(Ha, pol, True)
    del Da
    torch.cuda.empty_cache()

    # (b) tile stores at scale 14
    gb = rmat(14, edge_factor=16, seed=1, symmetrize=True)
    hub_b = int(np.argmax(np.diff(gb.indptr)))
    Db = repro_torch.Graph(gb, device="cuda")
    Hb = repro_torch.Graph(gb, device="cuda")
    log(f"host (b): rmat(14, symmetrize) n={gb.n} m={gb.m} hub={hub_b}")
    runs = {
        "wcc": (lambda G, p: G.run(wcc_program(), policy=p), True),
        "bfs_hub": (lambda G, p: G.bfs(hub_b, policy=p), True),
        "pr_push": (lambda G, p: G.pagerank(max_iters=PUSH_ITERS_14,
                                            policy=p), False),
    }
    dev_cache = {}
    for order, sb, names in (("dest", 16, ("wcc", "bfs_hub", "pr_push")),
                             ("hilbert", 16, ("wcc",)),
                             ("hilbert", 1, ("wcc", "bfs_hub"))):
        # the peak is a session-wide maximum: measure each setting alone
        Hb.host_view().peak_stage_bytes = 0
        for backend in ("blocked", "blocked_compact"):
            pol = repro_torch.ExecutionPolicy(backend=backend,
                                              tile_order=order,
                                              stream_buffer=sb)
            for name in names:
                call, exact = runs[name]
                twin(name, Db, Hb, call, pol, exact, dev_cache)
        longest = max_run_tiles(Hb, "min_plus", order)
        store = Hb.host_view().blocked_store("min_plus", reverse=False,
                                             tile_order=order)
        log(f"host (b) {order}: longest run {longest} tiles, stream_buffer "
            f"{sb}; min_plus store {store.payload_nbytes} B of tile-major "
            f"payload in host RAM (the reference's dense store: "
            f"{store.nbytes} B)")
        bound_check(Hb, repro_torch.ExecutionPolicy(
            backend="blocked", tile_order=order, stream_buffer=sb),
            longest <= sb)
    log(f"host launches (apart from the main paths): {host_counts}")
    require_launched("host path", host_counts, ("spmv_blocked_compact",
                                                "spmv_blocked_compact_min_plus"))
    log(f"host h2d rate bound: {rate / 1e9:.2f} GB/s pinned copy_")
    del Db
    torch.cuda.empty_cache()
    return Ha, Hb, host_counts, rows, rate


# ------------------------------------------------- batched driver, algorithms
Q_MAIN = 32  # batched BFS queries on the main view
Q_PPR = 16  # one-hot personalized PageRank queries
Q_RESET = 4  # columns of the seeded reset matrix
Q_HOST = 8  # host queries: benchmarks/bench_multisource.py's Q and gate
HOST_GATE = 4.0  # host_bytes a query must drop at least this much at Q=8
BC_RTOL = 1e-4
K_WIDE = (4, 32, 192, 256)  # B1/B2 lanes checked beside K=1; 256 splits
K_TIME = (4, 16, 32)  # B1/B2 lanes timed beside K=1: Q=32 as columns retire


def top_degree(g, k: int):
    """The k vertices of largest out-degree, ties to the lower id."""
    import numpy as np

    return np.argsort(-np.diff(g.indptr), kind="stable")[:k]


class LaneLog:
    """Within the ``with`` block, records each launch of B1-B4 (one a lane
    group): its counter's name, the id of its tile view and its lanes."""

    def __enter__(self):
        from repro_torch.kernels.spmv import kernel as K

        self.calls = []
        self._saved = rows, compact = K._launch_rows, K._launch_compact

        def log_rows(bg, act, x):
            self.calls.append((K._kernel_name("spmv_blocked", bg), id(bg),
                               x.shape[-1]))
            return rows(bg, act, x)

        def log_compact(bg, lst, ldb, nact, x):
            self.calls.append((K._kernel_name("spmv_blocked_compact", bg),
                               id(bg), x.shape[-1]))
            return compact(bg, lst, ldb, nact, x)

        K._launch_rows, K._launch_compact = log_rows, log_compact
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.spmv import kernel as K

        K._launch_rows, K._launch_compact = self._saved

    def widths(self) -> dict:
        """{kernel: {lanes: launches}}."""
        out: dict = {}
        for name, _, k in self.calls:
            out.setdefault(name, {})
            out[name][k] = out[name].get(k, 0) + 1
        return out

    def on(self, bg) -> dict:
        """{kernel: launches} over the tile view ``bg``."""
        out: dict = {}
        for name, view, _ in self.calls:
            if view == id(bg):
                out[name] = out.get(name, 0) + 1
        return out


def numpy_ppr(g, resets, damping: float, iters: int = 1000):
    """Personalized PageRank of each column of ``resets`` (normalized to
    sum 1) by power iteration in float64: R = (1 - c) r + c A^T (R / deg),
    a vertex without out-edges sending nothing, as the push program's
    fixed point."""
    import numpy as np
    import scipy.sparse as sp

    deg = np.diff(g.indptr)
    src = np.repeat(np.arange(g.n), deg)
    at = sp.csr_matrix((np.ones(g.m), (g.indices, src)), shape=(g.n, g.n))
    share = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)[:, None]
    base = (1 - damping) * resets / resets.sum(0, keepdims=True)
    rank = base
    for _ in range(iters):
        new = base + damping * (at @ (rank * share))
        if np.abs(new - rank).max() < 1e-15:
            return new
        rank = new
    return rank


def numpy_coreness(g):
    """Core numbers by level-synchronous peeling in numpy: remove every
    live vertex of degree <= k, decrement its neighbours, and raise k to
    the least live degree when nothing goes."""
    import numpy as np

    deg = np.diff(g.indptr).astype(np.int64)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    alive = np.ones(g.n, bool)
    core = np.zeros(g.n, np.int32)
    k = 0
    while alive.any():
        gone = alive & (deg <= k)
        if gone.any():
            core[gone] = k
            alive &= ~gone
            deg -= np.bincount(g.indices[gone[src]], minlength=g.n)
        else:
            k = max(int(deg[alive].min()), k + 1)
    return core


def numpy_brandes(g, sources):
    """Betweenness from ``sources`` by level-synchronous Brandes in float64
    (scipy sparse): path counts level by level, then dependencies back
    down the levels; each source's own entry left out."""
    import numpy as np
    import scipy.sparse as sp

    n, k = g.n, len(sources)
    src = np.repeat(np.arange(n), np.diff(g.indptr))
    a = sp.csr_matrix((np.ones(g.m), (src, g.indices)), shape=(n, n))
    at = a.T.tocsr()
    lanes = np.arange(k)
    sigma = np.zeros((n, k))
    sigma[sources, lanes] = 1.0
    dist = np.full((n, k), -1)
    dist[sources, lanes] = 0
    front, level = dist == 0, 0
    while front.any():
        recv = at @ np.where(front, sigma, 0.0)
        new = (recv > 0) & (dist < 0)
        sigma = np.where(new, recv, sigma)
        dist = np.where(new, level + 1, dist)
        front, level = new, level + 1
    delta = np.zeros((n, k))
    for lv in range(int(dist.max()) - 1, -1, -1):
        x = np.where(dist == lv + 1, (1 + delta) / np.maximum(sigma, 1e-300),
                     0.0)
        delta = np.where(dist == lv, delta + sigma * (a @ x), delta)
    delta[sources, lanes] = 0.0
    return delta.sum(1)


def numpy_diameter(g, num_sources: int, sweeps: int = 2) -> int:
    """The diameter estimator's sweeps replayed with numpy BFS: from the
    first vertex of largest degree, then from the ``num_sources`` farthest
    reachable vertices of the last sweep (ties to the lower id)."""
    import numpy as np

    from repro_torch.algs import UNREACHED

    def finite(d):
        return np.where(d == UNREACHED, -1, d)

    dist = numpy_bfs(g, int(np.argmax(np.diff(g.indptr))))
    estimate = int(finite(dist).max())
    for _ in range(sweeps):
        sources = np.argsort(-finite(dist), kind="stable")[:num_sources]
        best = np.full(g.n, -1)
        for s in sources:
            d = finite(numpy_bfs(g, int(s)))
            estimate = max(estimate, int(d.max()))
            best = np.maximum(best, d)
        dist = np.where(best < 0, UNREACHED, best)
    return estimate


def phase_batched(g, G, torch, seed: int, damping=0.85, tol=1e-3):
    """Batched BFS and personalized PageRank on the main view (see the
    module docstring).  Returns the path's launch counts, its walls and
    each backend's count of PPR columns bit-equal to their solo runs."""
    import numpy as np

    import repro_torch
    from repro_torch.algs import BFSProgram
    from repro_torch.kernels.spmv import kernel as K

    S = top_degree(g, Q_MAIN).tolist()
    resets = np.random.default_rng(seed).random((g.n, Q_RESET)).astype(
        np.float32)
    runs, wall = {}, {}
    K.reset_launches()
    with LaneLog() as lanes:
        for backend in BACKENDS:
            pol = repro_torch.ExecutionPolicy(backend=backend)
            for name, call in (
                ("bfs", lambda: G.bfs(S, policy=pol)),
                ("run", lambda: G.run(BFSProgram(), seeds=S, batch=Q_MAIN,
                                      policy=pol)),
                ("ppr", lambda: G.pagerank(reset=S[:Q_PPR], policy=pol)),
                ("ppr_matrix", lambda: G.pagerank(reset=resets, policy=pol)),
            ):
                runs[(backend, name)], wall[(backend, name)] = timed(
                    call, torch)[:2]
    counts = dict(K.launches)
    log(f"batched path kernel launches: {counts}; lane widths "
        f"{lanes.widths()}")
    require_launched("batched path", counts, ("spmv_blocked",
                                              "spmv_blocked_compact"))

    # BFS: numpy, the solo runs on blocked, and the façade's run(batch=).
    blocked = repro_torch.ExecutionPolicy(backend="blocked")
    solo = {s: timed(lambda: G.bfs(s, policy=blocked), torch)[:2] for s in S}
    steps = [int(solo[s][0].supersteps) for s in S]
    ios = {}
    for backend in BACKENDS:
        res = runs[(backend, "bfs")]
        vals = res.values.cpu().numpy()
        for q, s in enumerate(S):
            if not np.array_equal(vals[:, q], numpy_bfs(g, s)):
                raise AssertionError(f"batched bfs on {backend}: query {q} "
                                     "differs from numpy BFS")
        if (res.query_supersteps.tolist() != steps
                or int(res.supersteps) != max(steps)
                or int(res.iostats.queries) != Q_MAIN):
            raise AssertionError(f"batched bfs on {backend}: query supersteps"
                                 f" {res.query_supersteps.tolist()} against "
                                 f"solo {steps}, queries "
                                 f"{int(res.iostats.queries)}")
        via = runs[(backend, "run")]
        ios[backend] = io_dict(res.iostats)
        if not (torch.equal(via.values, res.values)
                and torch.equal(via.query_supersteps, res.query_supersteps)
                and io_dict(via.iostats) == ios[backend]):
            raise AssertionError(f"run(batch={Q_MAIN}) on {backend} differs "
                                 "from bfs(sources)")
    check_io("batched bfs scan/compact", ios["scan"], ios["compact"],
             ios["scan"].keys())
    check_io("batched bfs blocked/blocked_compact", ios["blocked"],
             ios["blocked_compact"], ios["blocked"].keys())
    for backend in BACKENDS[1:]:
        check_io(f"batched bfs scan/{backend}", ios["scan"], ios[backend],
                 LAYOUT_FREE)
    solo_bfs_ms = [solo[s][1] for s in S]
    log(f"batched bfs: {Q_MAIN} top-degree sources, every lane equals numpy "
        f"BFS on all four backends, query supersteps equal the solo runs' "
        f"{steps}; run(batch=) equals bfs(); wall per query "
        + ", ".join(f"{b} {wall[(b, 'bfs')] / Q_MAIN:.3f}" for b in BACKENDS)
        + f" ms against a blocked solo run's mean {np.mean(solo_bfs_ms):.3f} "
        f"ms (sum {np.sum(solo_bfs_ms):.1f})")

    # PPR: width-one runs and a numpy power iteration.
    one_hot = np.zeros((g.n, Q_PPR))
    one_hot[S[:Q_PPR], np.arange(Q_PPR)] = 1.0
    want = {"ppr": numpy_ppr(g, one_hot, damping),
            "ppr_matrix": numpy_ppr(g, resets.astype(np.float64), damping)}
    solo_reset = {"ppr": lambda q: S[q:q + 1],
                  "ppr_matrix": lambda q: resets[:, q:q + 1]}
    bit_equal, solo_ppr_ms = {}, []
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        for name, ref in want.items():
            res = runs[(backend, name)]
            cols = ref.shape[1]
            if (res.values.shape != (g.n, cols)
                    or not torch.isfinite(res.values).all()
                    or int(res.iostats.queries) != cols):
                raise AssertionError(f"{name} on {backend}: bad result")
            same = 0
            for q in range(cols):
                one, ms = timed(lambda: G.pagerank(reset=solo_reset[name](q),
                                                   policy=pol), torch)[:2]
                if backend == "blocked" and name == "ppr":
                    solo_ppr_ms.append(ms)
                torch.testing.assert_close(res.values[:, q], one.values[:, 0],
                                           atol=PR_ATOL, rtol=PR_RTOL)
                same += bool(torch.equal(res.values[:, q], one.values[:, 0]))
                if int(res.query_supersteps[q]) != int(one.supersteps):
                    log(f"{name} on {backend}: query {q} converged at "
                        f"{int(res.query_supersteps[q])}, alone at "
                        f"{int(one.supersteps)}")
                l1 = float(np.abs(res.values[:, q].double().cpu().numpy()
                                  - ref[:, q]).sum())
                if l1 > tol / (1 - damping):
                    raise AssertionError(f"{name} on {backend}: query {q} L1 "
                                         f"error {l1} vs numpy")
            bit_equal[(backend, name)] = same
    # Without the point-to-point arm (which a batch and a solo run enter
    # in different supersteps) blocked runs every superstep through B1.
    nop2p = repro_torch.ExecutionPolicy(backend="blocked",
                                        switch_fraction=None)
    res = G.pagerank(reset=S[:Q_PPR], policy=nop2p)
    bit_equal[("blocked_no_p2p", "ppr")] = sum(
        bool(torch.equal(res.values[:, q], G.pagerank(
            reset=S[q:q + 1], policy=nop2p).values[:, 0]))
        for q in range(Q_PPR))
    log("batched ppr: columns within atol=1e-6, rtol=1e-5 of width-one runs "
        "and within tol/(1-damping) in L1 of numpy; columns bit-equal to "
        "their solo runs: " + json.dumps(
            {f"{b}/{n}": v for (b, n), v in bit_equal.items()})
        + "; wall per query " + ", ".join(
            f"{b} {wall[(b, 'ppr')] / Q_PPR:.3f}" for b in BACKENDS)
        + f" ms against a blocked solo run's mean {np.mean(solo_ppr_ms):.3f}"
        " ms")
    walls = {f"{b}/{n}": round(v, 3) for (b, n), v in wall.items()}
    walls.update({"blocked/solo_bfs_mean": round(float(np.mean(
        solo_bfs_ms)), 3), "blocked/solo_ppr_mean": round(float(np.mean(
            solo_ppr_ms)), 3)})
    return counts, walls, bit_equal




def phase_batched_host(Ha, Hb, torch):
    """Host batched BFS against device residency and against solo host
    runs (see the module docstring); returns the host path's launches."""
    import numpy as np

    import repro_torch
    from repro_torch.kernels.spmv import kernel as K

    counts, rows = {}, {}
    for label, H, backend in (("rmat20", Ha, "scan"),
                              ("rmat14_sym", Hb, "blocked_compact")):
        g = H.host
        # benchmarks/bench_multisource.py's draw (seed 7), over vertices
        # with an out-edge: a search from one without is empty.
        S = np.random.default_rng(7).choice(
            np.flatnonzero(np.diff(g.indptr) > 0), Q_HOST,
            replace=False).tolist()
        pol = repro_torch.ExecutionPolicy(backend=backend)
        hpol = pol.with_(residency="host")
        D = repro_torch.Graph(g, device="cuda", chunk_size=H._chunk_size,
                              bd=H._bd, bs=H._bs)
        dres, dms = timed(lambda: D.bfs(S, policy=pol), torch)[:2]
        del D
        torch.cuda.empty_cache()
        K.reset_launches()
        hres, hms, _, hb, streamed, _ = staged_run(
            label, H, lambda: H.bfs(S, policy=hpol), torch)
        for k, v in K.launches.items():
            counts[k] = counts.get(k, 0) + v
        check_host(f"batched host {label}/{backend}", dres, hres, True, torch)
        if not (torch.equal(hres.query_supersteps, dres.query_supersteps)
                and int(hres.iostats.queries) == Q_HOST):
            raise AssertionError(f"batched host {label}: query supersteps "
                                 "or queries differ from device")
        solo = [staged_run(label, H, lambda: H.bfs(s, policy=hpol), torch)
                for s in S]
        solo_hb = float(np.mean([r[3] for r in solo]))
        solo_streamed = float(np.mean([r[4] for r in solo]))
        factor = solo_hb / (hb / Q_HOST)
        rows[label] = dict(host_bytes=hb, solo_host_bytes_mean=solo_hb,
                           factor=factor, streamed=streamed,
                           solo_streamed_mean=solo_streamed,
                           device_ms=dms, host_ms=hms,
                           solo_host_ms_mean=float(np.mean(
                               [r[1] for r in solo])))
        log(f"batched host {label}/{backend}: sources {S} (out-degrees "
            f"{np.diff(g.indptr)[S].tolist()}), query supersteps "
            f"{hres.query_supersteps.tolist()}; values and IOStats equal "
            f"device residency's; host_bytes {hb} = {hb / Q_HOST:.0f} a query"
            f" against a solo mean of {solo_hb:.0f}: {factor:.3f}x fewer "
            f"(streamed {streamed} B, {solo_streamed / (streamed / Q_HOST):.3f}"
            f"x fewer); walls device {dms:.1f} ms, host {hms:.1f} ms, host "
            f"solo mean {rows[label]['solo_host_ms_mean']:.1f} ms")
        if factor < HOST_GATE:
            raise AssertionError(f"batched host {label}: host_bytes a query "
                                 f"drop only {factor:.3f}x (< {HOST_GATE}x)")
    log(f"batched host launches: {counts}")
    require_launched("batched host path", counts, ("spmv_blocked_compact",))
    return counts, rows


def phase_algs(wg, torch):
    """Coreness, betweenness, diameter and triangles on the card (see the
    module docstring).  Returns the path's launch counts and walls."""
    import numpy as np

    import repro_torch
    from repro_torch.algs import count_triangles
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    A = repro_torch.Graph(wg, device="cuda")
    S = top_degree(wg, Q_MAIN).tolist()
    tg = rmat(14, edge_factor=16, seed=1, symmetrize=True)
    T = repro_torch.Graph(tg, device="cuda")
    blocked = repro_torch.ExecutionPolicy(backend="blocked")
    runs, wall = {}, {}

    def run(key, call):
        runs[key], wall[key] = timed(call, torch)[:2]

    K.reset_launches()
    with LaneLog() as lanes:
        for backend in ("scan", "blocked"):
            pol = repro_torch.ExecutionPolicy(backend=backend)
            for messaging in ("dense", "p2p", "hybrid"):
                run(f"coreness/{backend}/{messaging}", lambda: A.coreness(
                    messaging=messaging, policy=pol))
        for backend in ("scan", "blocked", "blocked_compact"):
            run(f"bc/multi/{backend}", lambda: A.betweenness(
                S, policy=repro_torch.ExecutionPolicy(backend=backend)))
        run("bc/uni8/blocked", lambda: A.betweenness(S, mode="uni", batch=8,
                                                      policy=blocked))
        run("bc/fused/scan", lambda: A.betweenness(S, mode="fused"))
        run("diameter/blocked", lambda: A.diameter(num_sources=Q_MAIN,
                                                   policy=blocked))
        run("triangles/blocked", lambda: T.triangles(policy=blocked))
    counts = dict(K.launches)
    rev = A.device(blocked=True, blocked_reverse=True).out_blocked_rev
    on_rev = lanes.on(rev)
    log(f"algs path kernel launches: {counts}; over the reverse view "
        f"{on_rev}; lane widths {lanes.widths()}")
    require_launched("algs path", counts, ("spmv_blocked",
                                           "spmv_blocked_compact"))
    require_launched("betweenness backward (reverse view)", on_rev,
                     ("spmv_blocked", "spmv_blocked_compact"))

    core = numpy_coreness(wg)
    for key in [k for k in runs if k.startswith("coreness")]:
        if not np.array_equal(runs[key].values.cpu().numpy(), core):
            raise AssertionError(f"{key} differs from numpy peeling")
    bc = numpy_brandes(wg, S)
    for key in [k for k in runs if k.startswith("bc/")]:
        np.testing.assert_allclose(runs[key].values.double().cpu().numpy(),
                                   bc, rtol=BC_RTOL, err_msg=key)
    est = numpy_diameter(wg, Q_MAIN)
    if int(runs["diameter/blocked"].values) != est:
        raise AssertionError(f"diameter {int(runs['diameter/blocked'].values)}"
                             f" != numpy replay {est}")
    ladder = count_triangles(tg, variant="hash", ordered=True).triangles
    got = runs["triangles/blocked"].values
    if got != ladder:
        raise AssertionError(f"triangles_blocked_mxu {got} != ladder {ladder}"
                             " (f32 total, ROADMAP §C)")
    log(f"algs: coreness (max core {int(core.max())}, supersteps "
        f"{int(runs['coreness/blocked/dense'].supersteps)}) equals numpy "
        f"peeling on scan and blocked, dense/p2p/hybrid; betweenness from "
        f"{Q_MAIN} top-degree sources within rtol={BC_RTOL} of numpy Brandes "
        f"(multi on scan/blocked/blocked_compact, uni batch=8, fused: shared "
        f"chunks {int(runs['bc/fused/scan'].state.shared)}); diameter {est} "
        f"equals the numpy replay; triangles on rmat(14, symmetrize) {got} "
        f"equal the numpy ladder; walls ms " + json.dumps(
            {k: round(v, 3) for k, v in wall.items()}))
    del A, T
    torch.cuda.empty_cache()
    return counts, wall


# ------------------------------------------------- fault tolerance
RECOVERY_DIR = ROOT / "build" / "recovery"  # git-ignored, inside the checkout
RECOVERY_PUSH_ITERS = 16  # host (a) PageRank push: ~0.33 s a superstep on host
Q_RECOVERY = 8  # batched BFS sources of the recovery phase
CHAOS_SHARD = 2  # sources per chaos task
CHAOS_COMBOS = ("scan", "compact", "blocked")  # device residency, rmat(14)


def same_result(label: str, a, b) -> None:
    """Bitwise: values, supersteps, every IOStats field (host_bytes and
    retries included) and, for batched runs, the query supersteps."""
    import torch

    diff = []
    if not torch.equal(a.values, b.values):
        diff.append("values")
    if int(a.supersteps) != int(b.supersteps):
        diff.append(f"supersteps {int(a.supersteps)} != {int(b.supersteps)}")
    diff += [f"{f} {int(x)} != {int(y)}" for f, x, y in
             zip(a.iostats._fields, a.iostats, b.iostats) if int(x) != int(y)]
    if (a.query_supersteps is not None
            and not torch.equal(a.query_supersteps, b.query_supersteps)):
        diff.append("query_supersteps")
    if diff:
        raise AssertionError(f"{label}: not bit-equal ({', '.join(diff)})")


def snapshot_bytes(directory: Path) -> int:
    """Bytes of the newest complete snapshot under ``directory``."""
    from repro_torch.checkpoint import latest_step

    step = latest_step(directory)
    return sum(f.stat().st_size for f in
               (directory / f"step_{step:08d}").iterdir())


def recovery_case(label, sem, prog, pol, torch, *, seeds=None,
                  max_supersteps=None, every_k, kills, batched=False,
                  host=None):
    """Two uninterrupted runs (which must be bit-equal: the first gate),
    then the run killed at each superstep of ``kills`` and resumed from
    its newest snapshot (which must equal them: the second).  Returns a
    row for the log: walls, replayed supersteps, saves, ``sync_s``,
    snapshot bytes and the bytes the replays streamed again."""
    import shutil

    from repro_torch.core import (
        CheckpointSpec,
        DeviceFailure,
        FailurePlan,
        run_program,
        run_program_batched,
        run_supervised,
    )

    driver = run_program_batched if batched else run_program
    kw = dict(seeds=seeds, max_supersteps=max_supersteps)
    streamed = (lambda: host.streamed_bytes) if host is not None \
        else (lambda: 0)
    s0 = streamed()
    base, base_ms, _ = timed(lambda: driver(sem, prog, pol, **kw), torch)
    base_streamed = streamed() - s0
    again = driver(sem, prog, pol, **kw)
    same_result(f"{label}: two uninterrupted runs", base, again)
    directory = RECOVERY_DIR / label.replace("/", "_")
    shutil.rmtree(directory, ignore_errors=True)
    tele: dict = {}
    spec = CheckpointSpec(directory, every_k=every_k, telemetry=tele)
    plan = FailurePlan({k: "crash" for k in kills})
    s0 = streamed()
    t0 = time.perf_counter()
    if batched:
        # the batched driver has no supervisor: kill, then resume
        resumed = []
        res = None
        for attempt in range(len(kills) + 1):
            try:
                res = driver(sem, prog, pol, checkpoint=spec,
                             resume=attempt > 0, _plan=plan, **kw)
                break
            except DeviceFailure:
                from repro_torch.checkpoint import latest_step

                resumed.append(latest_step(directory))
        if res is None or len(resumed) != len(kills):
            raise AssertionError(f"{label}: kills {kills} did not all fire")
    else:
        res, rep = run_supervised(sem, prog, pol, checkpoint=spec, plan=plan,
                                  **kw)
        resumed = rep.resumed_steps
    torch.cuda.synchronize()
    killed_ms = (time.perf_counter() - t0) * 1e3
    replay_streamed = streamed() - s0 - base_streamed
    same_result(f"{label}: killed at {kills} and resumed", res, base)
    if len(resumed) != len(kills):
        raise AssertionError(f"{label}: {len(resumed)} restarts for kills "
                             f"{kills}")
    replayed = sum(k - (r or 0) for k, r in zip(kills, resumed))
    if host is not None and replayed and replay_streamed <= 0:
        raise AssertionError(f"{label}: {replayed} replayed supersteps "
                             "streamed nothing again")
    row = dict(supersteps=int(base.supersteps), base_ms=base_ms,
               killed_ms=killed_ms, kills=list(kills), resumed=resumed,
               replayed_supersteps=replayed, saves=tele["saves"],
               sync_s=tele["sync_s"],
               sync_ms_per_save=tele["sync_s"] * 1e3 / max(tele["saves"], 1),
               snapshot_bytes=snapshot_bytes(directory),
               replay_streamed_bytes=replay_streamed)
    log(f"recovery {label}: " + json.dumps(
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in row.items()}))
    return row


def cadence_walls(label, sem, prog, pol, torch, **kw) -> dict:
    """Wall ms of one run at ``every_k`` 1 and 8 and without checkpoints,
    with the checkpoint layer's synchronous seconds beside each."""
    import shutil

    from repro_torch.core import CheckpointSpec, run_program

    out = {"off": timed(lambda: run_program(sem, prog, pol, **kw),
                        torch)[1]}
    for k in (1, 8):
        directory = RECOVERY_DIR / f"cadence_{label}_{k}".replace("/", "_")
        shutil.rmtree(directory, ignore_errors=True)
        tele: dict = {}
        spec = CheckpointSpec(directory, every_k=k, telemetry=tele)
        out[f"every_{k}"] = timed(lambda: run_program(
            sem, prog, pol, checkpoint=spec, **kw), torch)[1]
        out[f"every_{k}_sync_ms"] = tele["sync_s"] * 1e3
        out[f"every_{k}_saves"] = tele["saves"]
        out[f"every_{k}_snapshot_bytes"] = snapshot_bytes(directory)
    log(f"recovery cadence {label} (wall ms): " + json.dumps(
        {k: round(v, 3) for k, v in out.items()}))
    return out


def p17_walls(G, torch) -> dict:
    """Scan and compact PageRank push on the main view with the sum
    scatter's fixed-order add and with the unordered ``index_add`` it
    replaced, in turns (ordered, unordered, unordered, ordered); the
    ordered runs must be bit-equal."""
    import repro_torch
    from repro_torch.core import semiring

    ordered = semiring._ordered_add

    def unordered(y, keys, contrib):
        return y.index_add(0, keys, contrib)

    out = {}
    for backend in ("scan", "compact"):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        runs = {"ordered": [], "index_add": []}
        for name in ("ordered", "index_add", "index_add", "ordered"):
            semiring._ordered_add = ordered if name == "ordered" \
                else unordered
            try:
                runs[name].append(timed(lambda: G.pagerank(policy=pol),
                                        torch)[:2])
            finally:
                semiring._ordered_add = ordered
        (a, a_ms), (b, b_ms) = runs["ordered"]
        same_result(f"p17 {backend} pr_push (fixed-order add)", a, b)
        (c, c_ms), (d, d_ms) = runs["index_add"]
        out[backend] = dict(
            ordered_ms=[a_ms, b_ms], index_add_ms=[c_ms, d_ms],
            index_add_bit_equal=bool(torch.equal(c.values, d.values)),
            supersteps=int(a.supersteps))
    log("p17 walls (main view pr_push, ms): " + json.dumps(out))
    return out


def phase_recovery(g, hub, G, W, Ha, Hb, torch):
    """Kill and resume on the card (see the module docstring).  Returns
    the phase's launch counts and its rows."""
    import numpy as np

    import repro_torch
    from repro_torch.algs import BFSProgram, PageRankPushProgram
    from repro_torch.kernels.spmv import kernel as K

    rows = {"p17": p17_walls(G, torch)}
    S = top_degree(g, Q_RECOVERY).tolist()
    K.reset_launches()
    for backend in ("blocked", "blocked_compact"):
        pol = repro_torch.ExecutionPolicy(backend=backend)
        push, bfs = PageRankPushProgram(), BFSProgram()
        rows[f"{backend}/pr_push"] = recovery_case(
            f"main/{backend}/pr_push", G._sem(pol, push), push, pol, torch,
            max_supersteps=100, every_k=8, kills=(5, 21))
        rows[f"{backend}/bfs_hub"] = recovery_case(
            f"main/{backend}/bfs_hub", G._sem(pol, bfs), bfs, pol, torch,
            seeds=np.asarray([hub]), every_k=2, kills=(3,))
        rows[f"{backend}/bfs_q{Q_RECOVERY}"] = recovery_case(
            f"main/{backend}/bfs_q{Q_RECOVERY}", G._sem(pol, bfs), bfs, pol,
            torch, seeds=np.asarray(S), every_k=2, kills=(3,), batched=True)
    blocked = repro_torch.ExecutionPolicy(backend="blocked")
    wcc = wcc_program()
    rows["wcc/blocked"] = recovery_case(
        "wcc/blocked", W._sem(blocked, wcc), wcc, blocked, torch, every_k=2,
        kills=(3,))
    hpol = repro_torch.ExecutionPolicy(backend="blocked_compact",
                                       residency="host")
    rows["host_b/blocked_compact/wcc"] = recovery_case(
        "host_b/blocked_compact/wcc", Hb.host_view(), wcc, hpol, torch,
        every_k=2, kills=(3,), host=Hb.host_view())
    counts = dict(K.launches)
    hscan = repro_torch.ExecutionPolicy(residency="host")
    push = PageRankPushProgram()
    rows["host_a/scan/pr_push"] = recovery_case(
        "host_a/scan/pr_push", Ha.host_view(), push, hscan, torch,
        max_supersteps=RECOVERY_PUSH_ITERS, every_k=4, kills=(6,),
        host=Ha.host_view())
    log(f"recovery path kernel launches: {counts}")
    require_launched("recovery path", counts, KERNELS)
    pol = repro_torch.ExecutionPolicy(backend="blocked")
    rows["cadence/blocked/pr_push"] = cadence_walls(
        "main/blocked/pr_push", G._sem(pol, push), push, pol, torch,
        max_supersteps=100)
    rows["cadence/host_a/scan/pr_push"] = cadence_walls(
        "host_a/scan/pr_push", Ha.host_view(), push, hscan, torch,
        max_supersteps=RECOVERY_PUSH_ITERS)
    return counts, rows


# ------------------------------------------------- the contract checker
def analysis_fixtures():
    """Twins of ``tests/test_analysis.py``'s broken programs on the WCC
    program, each with the one rule it must raise."""
    import torch

    from repro_torch.core.semiring import Semiring

    WCC = type(wcc_program())

    class B1MaterializesEdges(WCC):
        def apply(self, sg, s, gathered):
            leak = torch.zeros(sg.m, device=sg.device)  # O(m) on the card
            labels = torch.minimum(s.labels, gathered) + leak.sum() * 0.0
            changed = labels < s.labels
            return type(s)(labels, changed), changed

    class B2HostSync(WCC):
        def apply(self, sg, s, gathered):
            total = float(torch.sum(gathered))  # a host read a superstep
            labels = torch.minimum(s.labels, gathered + total * 0.0)
            changed = labels < s.labels
            return type(s)(labels, changed), changed

    class B3DtypeDrift(WCC):
        def init(self, sg, seeds):
            return super().init(sg, seeds)._replace(labels=torch.full(
                (sg.n,), 1.0e9, dtype=torch.float64, device=sg.device))

        def apply(self, sg, s, gathered):
            labels = torch.minimum(s.labels, gathered).to(torch.float32)
            changed = labels < s.labels
            return type(s)(labels, changed), changed

    class B4LedgerLeak(WCC):
        def gather(self, sg, s, fr, policy):
            gathered, st = super().gather(sg, s, fr, policy)
            return gathered, st._replace(records=st.records + st.x_fetches)

    class B5UnlawfulSemiring(WCC):
        semiring = Semiring("bad_plus", combine="add", identity=1.0,
                            edge_op=lambda xv, w: xv if w is None else xv * w)

    class B6ConstantConverged(WCC):
        def converged(self, sg, s, activated):
            return torch.zeros((), dtype=torch.bool, device=sg.device)

    unhashable = WCC()
    unhashable.scratch = [1, 2, 3]  # a list defeats the caches
    return {"B1": (B1MaterializesEdges(), "R1"), "B2": (B2HostSync(), "R2"),
            "B3": (B3DtypeDrift(), "R3"), "B4": (B4LedgerLeak(), "R4"),
            "B5": (B5UnlawfulSemiring(), "R5"),
            "B6": (B6ConstantConverged(), "R6"), "unhashable": (unhashable,
                                                                "R3")}


def sync_frames(S, prog, pol, seeds, torch) -> set:
    """The user frames that synchronize with the card in one superstep
    (frontier, gather, apply, activate, then converged), found by
    ``torch.cuda.set_sync_debug_mode('warn')``: each sync warning is
    attributed to its innermost frame outside torch, numpy and the
    standard library, and the engine's own frames (``repro_torch/core``,
    ``repro_torch/kernels``) are dropped, so only the user hooks count."""
    import warnings

    from repro_torch.analysis.inspect import frame_is_engine, user_location
    from repro_torch.core.program import superstep
    from repro_torch.core.sem import IOStats

    sem = S._sem(pol, prog)
    pol = prog.prepare_policy(sem, pol)
    state, io = prog.init(sem, seeds), IOStats.zero(sem.device)
    torch.cuda.synchronize()
    frames = set()

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            loc = user_location(sys._getframe(1))
            if loc is not None and not frame_is_engine(loc[0]) \
                    and loc[2] != "sync_frames":  # the window's own frame
                frames.add(f"{loc[0]}:{loc[1]}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, io, act = superstep(sem, prog, pol, state, io)
            prog.converged(sem, state, act)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return frames


def drop_tile_views(S, torch, keep=None) -> None:
    """Free session ``S``'s tile views but its forward ``keep`` encoding,
    and the analysis cache that pins views: one graph's forward, reverse
    and min_plus views fill ~50 GB of the card."""
    import gc

    from repro_torch.analysis import rules

    rules._ANALYSIS_CACHE.clear()
    for cache in (S._tiles, S._views):
        for key in [k for k in cache if k[:2] != (keep, False)]:
            del cache[key]
    gc.collect()
    torch.cuda.empty_cache()


def phase_analysis(G, W, Ha, Hb, torch):
    """The contract checker on the card (see the module docstring).
    Returns the phase's launch counts and its rows."""
    import repro_torch
    from repro_torch import analysis
    from repro_torch.algs import PageRankPushProgram
    from repro_torch.analysis import rules
    from repro_torch.analysis.semlint import gate_programs
    from repro_torch.kernels.spmv import kernel as K

    P = repro_torch.ExecutionPolicy
    # one graph's tile views on the card at a time: G's are rebuilt for its
    # gate, which keeps its plus_times view for the profile phase; W's
    # min_plus view is rebuilt by the fixtures below
    views = [
        ("wcc", W, [(b, P(backend=b)) for b in BACKENDS], None),
        ("main", G, [(b, P(backend=b)) for b in BACKENDS], "plus_times"),
        ("host_b", Hb, [("blocked_compact", P(backend="blocked_compact",
                                              residency="host"))], None),
        ("host_a", Ha, [("scan", P(residency="host"))], None),
    ]
    drop_tile_views(G, torch)
    # the kernel that each view's recorded superstep of a program must
    # launch, by policy
    expect = {("main", "blocked"): ("pr_push", "spmv_blocked"),
              ("main", "blocked_compact"): ("pr_push", "spmv_blocked_compact"),
              ("wcc", "blocked"): ("wcc", "spmv_blocked_min_plus"),
              ("wcc", "blocked_compact"): ("wcc",
                                           "spmv_blocked_compact_min_plus")}
    rows, gate, inside = {}, 0, {}
    t_phase = time.perf_counter()
    log(f"analysis: {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
        "card at the start")
    rows["peak_gb/before"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    torch.cuda.reset_peak_memory_stats()  # the groups' peaks, logged
    K.reset_launches()
    for vname, S, pols, keep in views:
        t0 = time.perf_counter()
        progs = gate_programs(S)
        for pname, pol in pols:
            for name, prog, seeds in progs:
                rep, _, ran = timed(lambda: analysis.check(
                    S, prog, pol, seeds=seeds), torch)
                if not rep.ok:
                    raise AssertionError(f"analysis gate {vname}/{pname}/"
                                         f"{name}:\n{rep.render()}")
                frames = sync_frames(S, prog, pol, seeds, torch)
                if frames:
                    raise AssertionError(
                        f"{vname}/{pname}/{name}: the card's sync debug "
                        f"mode saw user frames sync ({sorted(frames)}) "
                        "where the analyzer found no R2")
                inside[f"{vname}/{pname}/{name}"] = {
                    k: v for k, v in ran.items() if v}
                gate += 1
            if (vname, pname) in expect:
                prog_name, kernel = expect[vname, pname]
                ran = inside[f"{vname}/{pname}/{prog_name}"]
                if not ran.get(kernel):
                    raise AssertionError(
                        f"{vname}/{pname}/{prog_name}: {kernel} did not "
                        f"launch inside the recorded superstep ({ran})")
        rows[f"gate_s/{vname}"] = round(time.perf_counter() - t0, 3)
        rows[f"peak_gb/{vname}"] = round(
            torch.cuda.max_memory_allocated() / 1e9, 3)
        if vname in ("wcc", "main"):
            drop_tile_views(S, torch, keep)
    log(f"analysis gate: {gate} program x view x policy pairs clean on the "
        f"card, each superstep's user frames free of syncs under "
        f"set_sync_debug_mode; launches inside the recorded supersteps "
        + json.dumps({k: v for k, v in inside.items() if v}))

    # each broken fixture flagged with exactly its rule; R2 against the
    # card's own sync detector
    blocked = P(backend="blocked")
    host_bc = P(backend="blocked_compact", residency="host")
    for name, (prog, rule) in analysis_fixtures().items():
        # R1 needs host residency; B5's semiring has no tiles
        S, pol = {"B1": (Hb, host_bc), "B5": (W, P())}.get(name, (W, blocked))
        rep = analysis.check(S, prog, pol)
        got = [f.rule for f in rep.findings]
        if got != [rule]:
            raise AssertionError(f"fixture {name}: {got} != [{rule!r}]\n"
                                 + rep.render())
        if name == "B1":
            continue  # its superstep would allocate the O(m) tensor
        r2 = {f.location for f in rep.findings if f.rule == "R2"}
        frames = sync_frames(S, prog, pol, None, torch)
        if frames != r2:
            raise AssertionError(f"fixture {name}: sync debug mode saw "
                                 f"{sorted(frames)}, R2 {sorted(r2)}")
        rows[f"fixture/{name}"] = rule
    log("analysis fixtures: each flagged with exactly its rule on the card "
        "(B1 on host (b), B5 on the wcc view's scan, the rest on its "
        "blocked tiles); B2's R2 line is the one the card's sync debug "
        "mode reports, and the others sync in no user frame")

    # walls: the first analysis, the cached one, run() against
    # run(analyze=True)
    cases = (("main/blocked/pr_push", G, PageRankPushProgram, blocked),
             ("host_b/blocked_compact/wcc", Hb, lambda: wcc_program(),
              host_bc))
    for label, S, make, pol in cases:
        rules._ANALYSIS_CACHE.clear()
        first = timed(lambda: analysis.check(S, make(), pol), torch)[1]
        cached = timed(lambda: analysis.check(S, make(), pol), torch)[1]
        plain, plain_ms, _ = timed(lambda: S.run(make(), policy=pol), torch)
        checked, checked_ms, _ = timed(
            lambda: S.run(make(), policy=pol, analyze=True), torch)
        rules._ANALYSIS_CACHE.clear()
        fresh, fresh_ms, _ = timed(
            lambda: S.run(make(), policy=pol, analyze=True), torch)
        same_result(f"{label} analyze=True", plain, checked)
        same_result(f"{label} analyze=True (uncached)", plain, fresh)
        rows[label] = {"analyze_ms": round(first, 3),
                       "cached_ms": round(cached, 6),
                       "run_ms": round(plain_ms, 3),
                       "run_analyze_cached_ms": round(checked_ms, 3),
                       "run_analyze_first_ms": round(fresh_ms, 3)}
    counts = dict(K.launches)
    rules._ANALYSIS_CACHE.clear()
    rows["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log(f"analysis path kernel launches: {counts}")
    require_launched("analysis path", counts, KERNELS)
    log(f"analysis: {json.dumps(rows)}")
    return counts, rows


_chaos_session = {}


def chaos_graph():
    from repro_torch.graph.generators import rmat

    return rmat(14, edge_factor=16, seed=1, symmetrize=True)


def chaos_work(payload):
    """One chaos task on the card: the batched BFS of ``CHAOS_SHARD``
    sources on one backend of ``CHAOS_COMBOS`` over host (b)'s graph.
    The result is a float64 vector, zero outside the backend's slot,
    holding the (n, CHAOS_SHARD) levels and the task's IOStats, so the
    queue's additive merge sums both per backend.  Module-level, so that
    spawned workers import it by reference."""
    import numpy as np

    import repro_torch

    p = np.asarray(payload, np.int64)
    G = _chaos_session.get("G")
    if G is None:
        G = _chaos_session["G"] = repro_torch.Graph(chaos_graph(),
                                                    device="cuda")
    r = G.bfs(p[1:].tolist(), policy=repro_torch.ExecutionPolicy(
        backend=CHAOS_COMBOS[int(p[0])]))
    slot = G.n * CHAOS_SHARD + len(r.iostats)
    out = np.zeros(len(CHAOS_COMBOS) * slot, np.float64)
    vals = r.values.cpu().numpy().astype(np.float64).reshape(-1)
    a = int(p[0]) * slot
    out[a:a + vals.size] = vals
    out[a + vals.size:a + slot] = [float(v) for v in r.iostats]
    return out


def phase_chaos(torch):
    """The durable queue served by 3 spawned worker processes on the
    card, two SIGKILLed mid-lease and two stalled past their lease: the
    merge must be bitwise the single-process run's, no task lost or
    committed twice, and more than 0 late commits refused."""
    import shutil

    import numpy as np

    from repro_torch.core import DurableWorkQueue, run_workers, shard_sources

    g = chaos_graph()
    sources = top_degree(g, 4 * CHAOS_SHARD)
    tasks = [np.concatenate([[ci], grp]).astype(np.int64)
             for ci in range(len(CHAOS_COMBOS))
             for grp in shard_sources(sources, CHAOS_SHARD)]
    tpl = np.zeros(len(CHAOS_COMBOS) * (g.n * CHAOS_SHARD + 10), np.float64)
    root = RECOVERY_DIR / "chaos"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    clean = DurableWorkQueue(root / "clean", tasks, lease_timeout=30.0,
                             result_template=tpl)
    rep0 = run_workers(clean, chaos_work, processes=1, timeout=300.0)
    clean_s = time.perf_counter() - t0
    if not (rep0.finished and rep0.completed == len(tasks)
            and rep0.kills == 0 and rep0.stale_rejections == 0):
        raise AssertionError(f"chaos: the single-process run failed: "
                             f"{rep0}")
    want = clean.merge(lambda a, b: a + b)
    # The kills hit the first two tasks leased, while most of the queue is
    # still pending, so the supervisor must restart both workers.  The
    # stalls hit the last two, which are leased after the kills.  A stall
    # outlasts its lease plus twice the single-process run's wall, which
    # bounds the time a worker takes from its spawn to its first lease, so
    # a restarted worker is live to reap the stalled claim and rerun it
    # before the late commit comes in, however slowly workers start.
    lease_s = 3.0
    stall_s = lease_s + 2.0 * clean_s + 5.0
    last = len(tasks) - 1
    faults = {(0, 1): "sigkill", (1, 1): "sigkill", (last - 1, 1): stall_s,
              (last, 1): stall_s}
    t0 = time.perf_counter()
    chaos = DurableWorkQueue(root / "chaos", tasks, lease_timeout=lease_s,
                             max_attempts=4, result_template=tpl)
    rep = run_workers(chaos, chaos_work, processes=3, faults=faults,
                      timeout=300.0)
    chaos_s = time.perf_counter() - t0
    done = sorted(p.name for p in (root / "chaos" / "done").iterdir())
    problems = []
    if not rep.finished:
        problems.append("not finished")
    if rep.kills < 2 or rep.restarts < 2:
        problems.append(f"kills {rep.kills}, restarts {rep.restarts}")
    if rep.stale_rejections <= 0:
        problems.append("no stale commit refused")
    if rep.dead_letters:
        problems.append(f"dead letters {rep.dead_letters}")
    if len(done) != len(tasks) or len({m.split(".")[0] for m in done}) \
            != len(tasks):
        problems.append(f"done markers {done}")
    if not np.array_equal(chaos.merge(lambda a, b: a + b), want):
        problems.append("merge differs from the single-process run")
    slot = g.n * CHAOS_SHARD + 10
    for ci, backend in enumerate(CHAOS_COMBOS):  # every lane a numpy BFS
        levels = want[ci * slot:ci * slot + g.n * CHAOS_SHARD].reshape(
            g.n, CHAOS_SHARD)
        expect = sum(np.stack([numpy_bfs(g, int(s)) for s in grp], 1)
                     .astype(np.float64)
                     for grp in shard_sources(sources, CHAOS_SHARD))
        if not np.array_equal(levels, expect):
            problems.append(f"{backend} levels differ from numpy BFS")
    if problems:
        raise AssertionError(f"chaos gate: {'; '.join(problems)}; log "
                             f"{rep.log}")
    row = dict(tasks=len(tasks), clean_s=clean_s, stall_s=stall_s,
               chaos_s=chaos_s,
               spawned=rep.spawned, kills=rep.kills, restarts=rep.restarts,
               stale_rejections=rep.stale_rejections, leases=rep.leases)
    log(f"chaos: 3 spawned workers on the card, 2 SIGKILLs and 2 stalls; "
        f"merge bitwise the single-process run's, every lane equal to numpy"
        f" BFS: " + json.dumps({k: round(v, 3) if isinstance(v, float) else v
                                for k, v in row.items()}))
    return row


def phase_warmup() -> None:
    """One PageRank and one BFS per backend on a small graph, so that the
    main path's wall times exclude first-call costs (library load, caching
    allocator).  The card-against-CPU check of this graph is
    ``tests/test_torch_cuda.py::test_card_matches_cpu``."""
    import repro_torch
    from repro_torch.graph.generators import rmat

    g = rmat(10, edge_factor=8, seed=3, symmetrize=True)
    G = repro_torch.Graph(g, device="cuda")
    H = repro_torch.Graph(g, device="cuda")
    for backend in BACKENDS:
        pol = repro_torch.ExecutionPolicy(backend=backend)
        for S, p in ((G, pol), (H, pol.with_(residency="host"))):
            S.pagerank(tol=1e-4, policy=p)
            S.bfs([0, 1, 2, 3], policy=p)
            S.run(wcc_program(), policy=p)
    log("warm-up: every backend ran once on rmat(10), both residencies")


def kernel_inputs(bg, frontier, k, torch, seed):
    """Random x blocks (min_plus: integer labels, a tenth of them +inf) and
    the tile activity of ``frontier``."""
    from repro_torch.kernels.spmv import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x_blocks = torch.rand((bg.n_src_blocks, bg.bs, k), generator=gen,
                          device="cuda")
    if bg.semiring == "min_plus":
        unreached = torch.rand(x_blocks.shape, generator=gen,
                               device="cuda") < 0.1
        x_blocks = torch.where(unreached, float("inf"),
                               torch.floor(x_blocks * bg.n))
    act = ops.tile_activity(bg, frontier, "src")
    return x_blocks, act


def compact_args(bg, act):
    from repro_torch.kernels.spmv import ops

    perm, dbid, sbid, first, last, accum, nact = ops.compact_tile_order(bg, act)
    G = ops.compact_grid_size(bg.num_tiles, nact)
    return (perm[:G], dbid[:G], sbid[:G], first[:G], last[:G], accum[:G],
            nact)


def max_err(got, want, exact: bool, torch) -> float:
    """B1/B2: within atol=rtol=1e-5; B3/B4 (``exact``): bit for bit.  NaN
    must meet NaN; the error is over the finite values."""
    if exact:
        gn, wn = torch.isnan(got), torch.isnan(want)
        if not (torch.equal(gn, wn)
                and torch.equal(got.masked_fill(gn, 0), want.masked_fill(wn, 0))):
            raise AssertionError("B3/B4 differ from their plain version")
        return 0.0
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                               equal_nan=True)
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


# kernel name -> (tile encoding, full-schedule kernel?)
KERNELS = {"spmv_blocked": ("plus_times", True),
           "spmv_blocked_compact": ("plus_times", False),
           "spmv_blocked_min_plus": ("min_plus", True),
           "spmv_blocked_compact_min_plus": ("min_plus", False)}
REPLACES = {"spmv_blocked": "src/repro/kernels/spmv/kernel.py:86",
            "spmv_blocked_compact": "src/repro/kernels/spmv/kernel.py:199",
            "spmv_blocked_min_plus": "src/repro/kernels/spmv/kernel.py:113",
            "spmv_blocked_compact_min_plus":
                "src/repro/kernels/spmv/kernel.py:227"}


def phase_kernels(G, W, torch):
    """Hold B1-B4 against the plain versions; returns max errors by kernel."""
    import repro_torch
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmv import kernel as K

    small = repro_torch.Graph(rmat(14, edge_factor=16, seed=1), device="cuda")
    small_sym = repro_torch.Graph(rmat(14, edge_factor=16, seed=1,
                                       symmetrize=True), device="cuda")
    views = {
        ("plus_times", "dest"): G.device(blocked=True).out_blocked,
        ("plus_times", "hilbert"): small.device(
            blocked=True, tile_order="hilbert").out_blocked,
        ("min_plus", "dest"): W.device(
            blocked=True, blocked_semiring="min_plus").out_blocked,
        ("min_plus", "hilbert"): small_sym.device(
            blocked=True, blocked_semiring="min_plus",
            tile_order="hilbert").out_blocked,
    }
    check_payload("main view", views[("plus_times", "dest")], torch)
    check_payload("wcc view", views[("min_plus", "dest")], torch)
    errs = {name: 0.0 for name in KERNELS}
    for (enc, order), bg in views.items():
        full_name, compact_name = [n for n, (e, _) in KERNELS.items()
                                   if e == enc]
        n = bg.n
        full = torch.ones(n, dtype=torch.bool, device="cuda")
        sparse = torch.arange(n, device="cuda") < n // 8
        for k in (1, 4):
            for fname, frontier in (("full", full), ("sparse", sparse)):
                x_blocks, act = kernel_inputs(bg, frontier, k, torch, seed=k)
                exact = enc == "min_plus"
                y1 = K.spmv_blocked(bg, act, x_blocks)
                if not torch.equal(y1, K.spmv_blocked(bg, act, x_blocks)):
                    raise AssertionError(f"{full_name}: two launches differ")
                e1 = max(max_err(y1, K.blocked_spmv_plain(bg, act, x_blocks),
                                 exact, torch),
                         max_err(y1, K.blocked_spmv_plain_rows(bg, act,
                                                               x_blocks),
                                 exact, torch))
                args = compact_args(bg, act)
                y2 = K.spmv_blocked_compact(bg, *args, x_blocks)
                if not torch.equal(y2, K.spmv_blocked_compact(bg, *args,
                                                              x_blocks)):
                    raise AssertionError(f"{compact_name}: two launches "
                                         "differ")
                e2 = max(max_err(y2, K.blocked_spmv_plain_compact(
                             bg, *args, x_blocks), exact, torch),
                         max_err(y2, K.blocked_spmv_plain_compact_rows(
                             bg, *args, x_blocks), exact, torch))
                errs[full_name] = max(errs[full_name], e1)
                errs[compact_name] = max(errs[compact_name], e2)
                log(f"kernel check {enc:10s} {order:7s} k={k} {fname:6s} "
                    f"live={int(act.sum())}/{bg.num_tiles} full err={e1:.3g}"
                    f" compact err={e2:.3g} (two launches of each equal)")
    for order in ("dest", "hilbert"):
        check_wide(order, views[("plus_times", order)], errs, torch)
    for (enc, order), bg in views.items():
        if order == "hilbert":
            check_non_finite(enc, bg, errs, torch)
    torch.cuda.synchronize()
    return errs


def check_wide(order, bg, errs, torch) -> None:
    """B1/B2 at the batched paths' lane counts (``K_WIDE``; past 192 lanes
    the wrappers launch lane groups) on full and n/8 frontiers: within
    atol=rtol=1e-5 of both plain versions, two launches bit-equal, one
    launch a group of at most 192 lanes, and every column ``torch.equal``
    to the K=1 call on that column."""
    from repro_torch.kernels.spmv import kernel as K

    n = bg.n
    for k in K_WIDE:
        for fname, frontier in (
                ("full", torch.ones(n, dtype=torch.bool, device="cuda")),
                ("sparse", torch.arange(n, device="cuda") < n // 8)):
            x_blocks, act = kernel_inputs(bg, frontier, k, torch, seed=k)
            args = compact_args(bg, act)
            K.reset_launches()
            y1 = K.spmv_blocked(bg, act, x_blocks)
            y2 = K.spmv_blocked_compact(bg, *args, x_blocks)
            groups = -(-k // K._MAX_K)
            if (K.launches["spmv_blocked"], K.launches["spmv_blocked_compact"]
                    ) != (groups, groups):
                raise AssertionError(f"k={k}: launches {K.launches}, "
                                     f"{groups} lane groups expected")
            if not (torch.equal(y1, K.spmv_blocked(bg, act, x_blocks))
                    and torch.equal(y2, K.spmv_blocked_compact(bg, *args,
                                                               x_blocks))):
                raise AssertionError(f"k={k}: two launches differ")
            for q in range(k):  # each column against its K=1 call
                xq = x_blocks[..., q:q + 1].contiguous()
                if not (torch.equal(y1[..., q:q + 1],
                                    K.spmv_blocked(bg, act, xq))
                        and torch.equal(y2[..., q:q + 1],
                                        K.spmv_blocked_compact(bg, *args,
                                                               xq))):
                    raise AssertionError(f"k={k} {order} {fname}: column {q}"
                                         " differs from its K=1 call")
            e1 = max(max_err(y1, K.blocked_spmv_plain(bg, act, x_blocks),
                             False, torch),
                     max_err(y1, K.blocked_spmv_plain_rows(bg, act, x_blocks),
                             False, torch))
            e2 = max(max_err(y2, K.blocked_spmv_plain_compact(
                         bg, *args, x_blocks), False, torch),
                     max_err(y2, K.blocked_spmv_plain_compact_rows(
                         bg, *args, x_blocks), False, torch))
            errs["spmv_blocked"] = max(errs["spmv_blocked"], e1)
            errs["spmv_blocked_compact"] = max(errs["spmv_blocked_compact"],
                                               e2)
            log(f"kernel check plus_times {order:7s} k={k} {fname:6s} "
                f"live={int(act.sum())}/{bg.num_tiles} full err={e1:.3g} "
                f"compact err={e2:.3g} ({groups} lane group(s); two launches "
                f"of each equal; all {k} columns equal their K=1 calls)")


def check_non_finite(enc, bg, errs, torch) -> None:
    """ROADMAP §C P12: on an x holding +inf, -inf and NaN (four values of
    each, in lane 0 of two), B1-B4 against both their plain versions, NaN
    for NaN: NaN where the dense product has it, the same infinities
    elsewhere, and lane 1 untouched."""
    from repro_torch.kernels.spmv import kernel as K

    full_name, compact_name = [n for n, (e, _) in KERNELS.items()
                               if e == enc]
    exact = enc == "min_plus"
    frontier = torch.arange(bg.n, device="cuda") < bg.n // 2
    x_blocks, act = kernel_inputs(bg, frontier, 2, torch, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    lane0 = x_blocks.view(-1, 2)[:, 0]
    for value in (float("inf"), float("-inf"), float("nan")):
        lane0[torch.randint(lane0.numel(), (4,), generator=gen,
                            device="cuda")] = value
    args = compact_args(bg, act)
    y1 = K.spmv_blocked(bg, act, x_blocks)
    y2 = K.spmv_blocked_compact(bg, *args, x_blocks)
    e1 = max(max_err(y1, K.blocked_spmv_plain(bg, act, x_blocks), exact,
                     torch),
             max_err(y1, K.blocked_spmv_plain_rows(bg, act, x_blocks), exact,
                     torch))
    e2 = max(max_err(y2, K.blocked_spmv_plain_compact(bg, *args, x_blocks),
                     exact, torch),
             max_err(y2, K.blocked_spmv_plain_compact_rows(bg, *args,
                                                           x_blocks),
                     exact, torch))
    if not torch.isnan(y1[..., 0]).any() or torch.isnan(y1[..., 1]).any():
        raise AssertionError(f"{full_name}: NaN not confined to lane 0")
    errs[full_name] = max(errs[full_name], e1)
    errs[compact_name] = max(errs[compact_name], e2)
    log(f"kernel check {enc:10s} non-finite x: {int(torch.isnan(y1).sum())}"
        f" / {int(torch.isnan(y2).sum())} NaN outputs (full / compact), "
        f"{int(torch.isinf(y1).sum())} / {int(torch.isinf(y2).sum())} inf, "
        f"all equal to the dense and payload plain versions; errors "
        f"{e1:.3g} / {e2:.3g}")


def bound(bg, act, k: int, schedule_entries: int):
    """(bound_ms, bound_by) of one product over the live dense tiles
    (``act``): the dense form of the earlier B1-B4 designs, logged beside
    the payload bounds.  Their tile bytes, the x blocks they read, all of
    y, and 16 bytes of int32 schedule per entry the kernel walks (each
    live tile's id, run flag, destination and source block; the earlier
    B1/B3 walked every tile) over the memory rate, against 2 operations
    per tile slot and lane (multiply-add, or add and min) over the f32
    peak."""
    live = act.bool()
    live_tiles = int(live.sum())
    nbytes = (live_tiles * bg.bd * bg.bs * 4 + live_x_bytes(bg, live, k)
              + bg.n_dst_blocks * bg.bd * k * 4 + schedule_entries * 16)
    return roofline(nbytes, 2.0 * live_tiles * bg.bd * bg.bs * k)


def roofline(nbytes: int, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def live_x_bytes(bg, tiles, k: int) -> int:
    """The x blocks of the listed tiles: what a product over them must read
    of x, non-finite values included (ROADMAP §C P12)."""
    import torch

    return int(torch.unique(bg.sbid[tiles]).numel()) * bg.bs * k * 4


def bound_rows(bg, act, k: int):
    """(bound_ms, bound_by) of B1/B3 over the row payload: 12 B of each
    live entry (tile, source row, weight), a 4-byte row pointer and K y
    values a row, the x blocks of the live tiles and the 4-byte activity
    flag of each tile over the memory rate, against 2 operations a live
    entry and lane over the f32 peak.  A tile's source block is not
    counted: the kernel reads it only where x holds a non-finite value
    (ROADMAP §C P12), and the count over x, already in the bound, shows
    whether it does."""
    live = act[bg.ent_tile.long()] != 0
    live_entries = int(live.sum())
    n_rows = bg.row_ptr.numel() - 1
    nbytes = (live_entries * 12 + (n_rows + 1) * 4 + n_rows * k * 4
              + live_x_bytes(bg, act.bool(), k) + bg.num_tiles * 4)
    return roofline(nbytes, 2.0 * live_entries * k)


def bound_compact_rows(bg, args, k: int):
    """(bound_ms, bound_by) of B2/B4 over the tile-major payload: 12 B of
    each live tile's entries (row, source row, weight), three words a live
    tile (list entry, destination block, tile pointer), the x blocks of
    the live tiles and y over the memory rate, against 2 operations a live
    entry and lane over the f32 peak.  As in :func:`bound_rows`, a tile's
    source block is not counted."""
    nact = args[6]
    ids = args[0][:nact].long()
    tp = bg.tile_ptr.long()
    entries = int((tp[ids + 1] - tp[ids]).sum())
    nbytes = (entries * 12 + nact * 12 + live_x_bytes(bg, ids, k)
              + bg.n_dst_blocks * bg.bd * k * 4)
    return roofline(nbytes, 2.0 * entries * k)


def live_edges(g, frontier_np):
    """(src, dst) of the live edges (source active), as numpy int64."""
    import numpy as np

    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    keep = frontier_np[src]
    return src[keep], g.indices[keep].astype(np.int64)


def live_csr(g, frontier_np, torch):
    """The live edges (source active) as a CUDA CSR matrix, rows = dst."""
    import numpy as np

    src, dst = live_edges(g, frontier_np)
    idx = torch.as_tensor(np.stack([dst, src]))
    with warnings.catch_warnings():
        # torch flags its sparse invariant checks and CSR support as beta.
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(idx, torch.ones(len(src)),
                                      (g.n, g.n), check_invariants=True)
        return coo.coalesce().to_sparse_csr().cuda()


def library_call(name, g, frontier_np, x_blocks, torch):
    """One PyTorch call computing the kernel's function over the same live
    edges: ``torch.sparse.mm`` (plus_times, an (n, K) x), or
    ``scatter_reduce_`` with 'amin' over ``x[src] + w``, the gather
    included (min_plus, K=1)."""
    n = g.n
    xv = x_blocks.reshape(-1, x_blocks.shape[-1])[:n].contiguous()
    if KERNELS[name][0] == "plus_times":
        A = live_csr(g, frontier_np, torch)
        return lambda: torch.sparse.mm(A, xv)
    src, dst = (torch.as_tensor(a, device="cuda")
                for a in live_edges(g, frontier_np))
    w = torch.zeros(src.numel(), device="cuda")  # unweighted: w = 0
    x1 = xv[:, 0]

    def run():
        y = torch.full((n,), float("inf"), device="cuda")
        return y.scatter_reduce_(0, dst, x1[src] + w, "amin",
                                 include_self=True)

    return run


def phase_time(g, G, wg, W, torch):
    """Time B1/B3 (full frontier) and B2/B4 (frontier of the first n/8
    vertices) at K=1 on the main paths' 'dest' views."""
    import numpy as np

    from repro_torch.kernels.spmv import kernel as K

    views = {"plus_times": (g, G.device(blocked=True).out_blocked),
             "min_plus": (wg, W.device(blocked=True,
                                       blocked_semiring="min_plus")
                          .out_blocked)}
    rows = {}
    for name, (enc, full_schedule) in KERNELS.items():
        graph, bg = views[enc]
        n = bg.n
        frontier_np = np.ones(n, bool) if full_schedule else np.arange(n) < n // 8
        frontier = torch.as_tensor(frontier_np, device="cuda")
        x_blocks, act = kernel_inputs(bg, frontier, 1, torch, seed=7)
        live = int(act.sum())
        run, plain, (bound_ms, bound_by), args = kernel_calls(
            full_schedule, bg, act, x_blocks, 1)
        lib = library_call(name, graph, frontier_np, x_blocks, torch)
        ms = cuda_ms(run, reps=50 if full_schedule else 20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        library_ms = cuda_ms(lib, reps=20)
        if full_schedule:
            tile_bound_ms = bound(bg, act, 1, bg.num_tiles)[0]
            dense_ms = cuda_ms(lambda: K.blocked_spmv_plain(bg, act,
                                                            x_blocks),
                               reps=3, warmup=1)
        else:
            tile_bound_ms = bound(bg, act, 1, live)[0]
            dense_ms = cuda_ms(lambda: K.blocked_spmv_plain_compact(
                bg, *args, x_blocks), reps=3, warmup=1)
        kernel_device_ms = device_ms(run, torch)
        parts = kernel_parts(run, torch)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, live=live,
                          device_ms=kernel_device_ms,
                          dense_bound_ms=tile_bound_ms)
        if enc == "plus_times":
            rows[name].update(time_wide(name, graph, bg, frontier,
                                        frontier_np, torch))
        log(f"time {name}: live={live}/{bg.num_tiles} ms={ms:.4f} "
            f"device_ms={kernel_device_ms:.4f} (one call in a CUDA graph) "
            f"bound_ms={bound_ms:.5f} ({bound_by}) plain_ms={plain_ms:.3f} "
            f"library_ms={library_ms:.4f} (library device_ms "
            f"{device_ms(lib, torch):.4f}; dense-tile bound of the earlier "
            f"design {tile_bound_ms:.4f} ms; dense plain_ms {dense_ms:.3f}); "
            f"device ms a call by kernel {parts}")
    return rows


def kernel_calls(full_schedule: bool, bg, act, x_blocks, k: int):
    """``(run, plain, (bound_ms, bound_by), compact args)`` of B1/B3
    (``full_schedule``) or B2/B4 over the tiles live under ``act``."""
    from repro_torch.kernels.spmv import kernel as K

    if full_schedule:
        return (lambda: K.spmv_blocked(bg, act, x_blocks),
                lambda: K.blocked_spmv_plain_rows(bg, act, x_blocks),
                bound_rows(bg, act, k), None)
    args = compact_args(bg, act)
    return (lambda: K.spmv_blocked_compact(bg, *args, x_blocks),
            lambda: K.blocked_spmv_plain_compact_rows(bg, *args, x_blocks),
            bound_compact_rows(bg, args, k), args)


def time_wide(name, graph, bg, frontier, frontier_np, torch) -> dict:
    """B1 or B2 at each of ``K_TIME`` lanes on the same view and frontier:
    the event-loop and CUDA-graph device times, the bound at K lanes, the
    plain version's time and ``torch.sparse.mm`` with an (n, K) x, as keys
    ``k{K}_*``, and the device ms a call of each kernel launched."""
    out = {}
    for k in K_TIME:
        x_blocks, act = kernel_inputs(bg, frontier, k, torch, seed=k)
        run, plain, (bound_ms, bound_by), _ = kernel_calls(
            KERNELS[name][1], bg, act, x_blocks, k)
        lib = library_call(name, graph, frontier_np, x_blocks, torch)
        row = {f"k{k}_ms": cuda_ms(run, reps=20),
               f"k{k}_device_ms": device_ms(run, torch),
               f"k{k}_bound_ms": bound_ms, f"k{k}_bound_by": bound_by,
               f"k{k}_plain_ms": cuda_ms(plain, reps=3, warmup=1),
               f"k{k}_library_ms": cuda_ms(lib, reps=20),
               f"k{k}_library_device_ms": device_ms(lib, torch)}
        out.update(row)
        log(f"time {name} k={k}: " + json.dumps(
            {key: (round(v, 5) if isinstance(v, float) else v)
             for key, v in row.items()})
            + f"; device ms / library device ms "
            f"{row[f'k{k}_device_ms'] / row[f'k{k}_library_device_ms']:.3f}"
            f"; device ms a call by kernel {kernel_parts(run, torch)}")
    return out


def kernel_parts(fn, torch, calls: int = 20) -> dict:
    """Device ms a call of each CUDA kernel that ``fn`` launches
    (torch.profiler over ``calls`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]:
            round(e.self_device_time_total / 1e3 / calls, 5)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def device_ms(fn, torch, calls: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    and replayed, timed with events, so the host's launch overhead (which
    an event loop over eager calls can include) drops out."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # allocations and lazy set-up outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps=10) / calls


def phase_profile(runs, torch) -> dict:
    """Device time against wall time of each named call (torch.profiler,
    CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, call in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernel events only: an aten op's self device time repeats the
        # time of the kernels it launched.
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:4]
        out[name] = dict(wall_ms=wall_ms, device_ms=device_ms, top={
            e.key[:60]: round(e.self_device_time_total / 1e3, 3) for e in top})
        log(f"profile {name}: wall_ms={wall_ms:.1f} device_ms={device_ms:.1f} "
            f"idle_share={1 - device_ms / wall_ms:.3f} top={out[name]['top']}")
    return out


def name_top_kernel(label, call, torch) -> dict:
    """The CUDA kernel that takes the most device time in one ``call`` and
    the ``repro_torch`` lines that launch it: torch.profiler gives the
    kernel and the aten op that launched it (the card's profile records no
    Python frames), then one more ``call`` with that op's Tensor method
    wrapped records the innermost three ``repro_torch`` frames of each of
    its calls.  Returns ``{"kernel", "op", "device_ms", "share",
    "call_device_ms", "lines": {frames: calls}}``."""
    import traceback

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kernels)
    top = max(kernels, key=lambda e: e.self_device_time_total)
    ops: dict = {}
    for fe in prof.events():
        us = sum(k.duration for k in getattr(fe, "kernels", ())
                 if k.name == top.key)
        if us:
            ops[fe.name] = ops.get(fe.name, 0.0) + us
    op = max(ops, key=ops.get) if ops else "?"
    method = op.split("::")[-1]
    lines: dict = {}
    orig = getattr(torch.Tensor, method, None)
    if orig is not None:
        def wrapped(*args, **kwargs):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename][::-1][:3]
            key = " <- ".join(f"{f.filename.split('src/', 1)[-1]}:"
                              f"{f.lineno} {f.name}" for f in frames) or "?"
            lines[key] = lines.get(key, 0) + 1
            return orig(*args, **kwargs)

        setattr(torch.Tensor, method, wrapped)
        try:
            call()
            torch.cuda.synchronize()
        finally:
            setattr(torch.Tensor, method, orig)
    out = dict(kernel=top.key, op=op,
               device_ms=top.self_device_time_total / 1e3,
               share=top.self_device_time_total / total,
               call_device_ms=total / 1e3, lines=lines)
    log(f"profile {label}: top kernel {out['kernel'][:90]} "
        f"{out['device_ms']:.3f} of {out['call_device_ms']:.3f} device ms "
        f"({out['share']:.3f}), launched by {op} from (calls) "
        f"{json.dumps(lines)}")
    return out


# ------------------------------------------------------------ LM phases
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
LM_ATOL = LM_RTOL = 1e-4  # B5 vs plain: same inputs, f32 math, other order
LM_ARCH = "gemma-2b"
# serve_batch's arguments in the lm_serve phase (the reference's defaults
# but for max_len, which makes the cache wrap, and n_requests, cut from 8
# for the script's time: the first four prompts take 1,384 steps, past the
# 1,024 slots, and the fifth refills a slot; 8 took 3,111 steps)
SERVE = dict(n_requests=5, max_batch=4, max_new=16, max_len=1024, seed=0)
TEACHER_STEPS = PROFILE_STEPS = 32
LOGIT_BOUND = 0.05  # tests/test_serving_parity.py:73
B5 = "decode_attention"


def _attn_case(dev, torch, b, kv, g, hd, t, dtype, fill, seed,
               rotate=False):
    """Random q/k/v and a cache of ``t`` slots filled with positions
    0..fill[i]-1 (row i; -1 beyond), or after ``fill[i]`` steps of a
    rotating cache (slot = pos % t) when ``rotate``; cur = fill - 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kv * g, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    slots = torch.arange(t, device=dev)
    rows = []
    for f in fill:
        if rotate:
            last = f - 1  # the newest position; slot s holds the newest p
            rows.append(last - (last - slots) % t)  # with p % t == s
        else:
            rows.append(torch.where(slots < f, slots, -1))
    pos = torch.stack(rows).to(torch.int32)
    cur = torch.tensor([f - 1 for f in fill], dtype=torch.int32, device=dev)
    return q, k, v, pos, cur


def phase_lm_kernel(torch, dev="cuda"):
    """B5 against its plain version (``atol=rtol=1e-4`` on the f32 output:
    the same bf16/f32 inputs, f32 math in another summation order).
    Returns the largest error."""
    from repro_torch.kernels import decode_attn as tda

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, (b, kv, g, hd, t, dtype, fill), window, rotate
        ("serve bf16, fills 1/200/700/1024",
         (4, 1, 8, 256, 1024, bf16, (1, 200, 700, 1024)), 0, False),
        ("serve f32, fills 1/200/700/1024",
         (4, 1, 8, 256, 1024, f32, (1, 200, 700, 1024)), 0, False),
        ("serve bf16, rotated slots after 1500/1030/2049/1024 steps",
         (4, 1, 8, 256, 1024, bf16, (1500, 1030, 2049, 1024)), 0, True),
        ("gemma3 window 1024 over T=8192",
         (2, 4, 2, 256, 8192, bf16, (8192, 5000)), 1024, False),
        ("empty row (fill 0) beside a full one",
         (2, 1, 8, 256, 1024, bf16, (0, 1024)), 0, False),
        ("KV=4 G=2 (gemma3's grouping), fills 300/1024",
         (2, 4, 2, 256, 1024, bf16, (300, 1024)), 0, False),
        ("G=1 (KV=4), fills 1000/37",
         (2, 4, 1, 256, 1024, bf16, (1000, 37)), 0, False),
        ("G=4 (KV=2), fills 513/1024",
         (2, 2, 4, 256, 1024, bf16, (513, 1024)), 0, False),
        ("G=16, fills 900/1024",
         (2, 1, 16, 256, 1024, bf16, (900, 1024)), 0, False),
        ("hd=64 bf16, fills 1024/333",
         (2, 1, 8, 64, 1024, bf16, (1024, 333)), 0, False),
        ("hd=128 bf16 KV=8 (command-r's heads), fills 1024/700",
         (2, 8, 8, 128, 1024, bf16, (1024, 700)), 0, False),
        ("T=1000 (bt=125, ragged chunks), rotated after 1000/1500/2333",
         (3, 1, 8, 256, 1000, bf16, (1000, 1500, 2333)), 0, True),
        ("T=96 (bt=96), fills 96/50",
         (2, 1, 8, 256, 96, bf16, (96, 50)), 0, False),
        ("KV=4 G=8 strided rows, window 256 over T=2048",
         (2, 4, 8, 128, 2048, bf16, (2048, 1111)), 256, False),
        # the shapes the families phase gives B5 (max_len = S + 64)
        ("zamba2: hd=80 KV=32 G=1, T=2112 (bt=96), fills 2049/1000",
         (2, 32, 1, 80, 2112, bf16, (2049, 1000)), 0, False),
        ("qwen3-moe: KV=4 G=16 hd=128, T=1088 (bt=68), fills 1025/600",
         (2, 4, 16, 128, 1088, bf16, (1025, 600)), 0, False),
        ("whisper: KV=8 G=1 hd=64, T=1564 (bt=92), fills 1501/800/1564/3",
         (4, 8, 1, 64, 1564, bf16, (1501, 800, 1564, 3)), 0, False),
    ]
    worst = 0.0
    for i, (name, (b, kv, g, hd, t, dtype, fill), window, rot) in enumerate(
            cases):
        q, k, v, pos, cur = _attn_case(dev, torch, b, kv, g, hd, t, dtype,
                                       fill, seed=i, rotate=rot)
        bt = tda.block_size(t)
        live = tda.live_blocks(pos, cur, bt, window)
        got = tda.decode_attention(q, k, v, pos, cur, window=window)
        want = tda.decode_attention_plain(q, k, v, pos, cur, window=window)
        torch.testing.assert_close(got, want, atol=LM_ATOL, rtol=LM_RTOL)
        if not torch.equal(got, tda.decode_attention(q, k, v, pos, cur,
                                                     window=window)):
            raise AssertionError(f"{name}: two launches differ")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        for row, f in enumerate(fill):
            if f == 0 and torch.count_nonzero(got[row]):
                raise AssertionError(f"{name}: an empty row is not 0")
        log(f"lm_kernel {name}: live blocks {int(live.sum())}/{live.numel()}"
            f" max_abs_err={err:.3g}, two launches bit-equal")
        if window and int(live.sum()) * 4 > live.numel():
            raise AssertionError(f"{name}: the window skips no block")
    return worst


def phase_lm_serve(torch, arch=LM_ARCH, dev="cuda", serve=SERVE,
                   smoke=False):
    """The slice-3 main path: ``serve_batch`` at the configuration's full
    width and depth, B5's count zeroed just before and read just after;
    then teacher-forced steps through B5 against the plain attention."""
    import numpy as np

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import decode_attn as tda
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    cfg = get_smoke(arch) if smoke else get_config(arch)
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    w_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    log(f"lm_serve: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab}: {n_params} parameters, "
        f"{w_bytes / 1e9:.3f} GB of bf16 weights on the card, initialised "
        f"in {time.perf_counter() - t0:.1f} s")

    tda.reset_launches()
    res = serve_batch(arch, smoke=smoke, device=dev, params=params, **serve)
    launched = tda.launches[B5]
    steps = res["decode_steps"]
    log(f"lm_serve launches: {{'{B5}': {launched}}} for {steps} decode "
        f"steps x {cfg.n_layers} layers")
    if launched != cfg.n_layers * steps:
        raise AssertionError(f"B5 ran {launched} times, not "
                             f"{cfg.n_layers} x {steps}")
    want_tokens = serve["n_requests"] * serve["max_new"]
    outs = [t for v in res["outputs"].values() for t in v]
    if res["tokens"] != want_tokens or not all(0 <= t < cfg.vocab
                                               for t in outs):
        raise AssertionError(f"serve_batch: {res['tokens']} tokens, "
                             f"ids {min(outs)}..{max(outs)}")
    if steps <= serve["max_len"]:
        raise AssertionError(f"{steps} steps never wrap the "
                             f"{serve['max_len']}-slot cache")
    cache_bytes = (cfg.n_layers * 2 * serve["max_batch"] * serve["max_len"]
                   * cfg.n_kv_heads * cfg.head_dim * 2)
    bound_ms = (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    step_ms = res["seconds"] / steps * 1e3
    log(f"lm_serve: {res['tokens']} tokens, {steps} decode steps in "
        f"{res['seconds']:.3f} s: {step_ms:.3f} ms per step, "
        f"{res['tokens'] / res['seconds']:.2f} generated tok/s, "
        f"{steps * serve['max_batch'] / res['seconds']:.1f} slot-tokens/s; "
        f"weight-streaming bound {bound_ms:.3f} ms per step "
        f"({w_bytes / 1e9:.3f} GB weights + {cache_bytes / 1e9:.3f} GB "
        f"cache over 3.35 TB/s)")

    # Teacher-forced: the same tokens through B5 and through the plain
    # attention, one set of weights, two caches.
    from repro_torch.kernels.decode_attn import decode_attention_plain

    plain = build_model(cfg, dev, attention=decode_attention_plain)
    b = serve["max_batch"]
    ca = model.init_cache(b, serve["max_len"])
    cb = plain.init_cache(b, serve["max_len"])
    tokens = np.random.default_rng(1).integers(1, cfg.vocab,
                                               (TEACHER_STEPS, b, 1))
    worst = unsure = 0
    for s in range(TEACHER_STEPS):
        tok = torch.as_tensor(tokens[s], device=dev)
        la, ca = model.decode_step(params, ca, tok)
        lb, cb = plain.decode_step(params, cb, tok)
        if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
            raise AssertionError(f"teacher step {s}: non-finite logits")
        scale = max(float(lb.abs().max()), 1.0)
        err = float((la - lb).abs().max())
        if err >= LOGIT_BOUND * scale:
            raise AssertionError(f"teacher step {s}: |B5 - plain| {err} >= "
                                 f"{LOGIT_BOUND} x {scale}")
        top2 = lb.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_BOUND * scale
        if not torch.equal(la.argmax(-1)[sure], lb.argmax(-1)[sure]):
            raise AssertionError(f"teacher step {s}: argmax differs")
        worst = max(worst, err / scale)
        unsure += int((~sure).sum())
    log(f"lm_serve teacher-forced: {TEACHER_STEPS} steps x {b} rows, B5 "
        f"against the plain attention: max |dlogits| / max|logits| = "
        f"{worst:.3g} (bound {LOGIT_BOUND}); argmax equal on every row with "
        f"a clear margin ({unsure} rows within the margin)")
    del plain, ca, cb
    return model, params, res, dict(step_ms=step_ms, bound_ms=bound_ms,
                                    launches=launched)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def attn_bound(q, k, pos, cur, window, torch):
    """(bound_ms, bound_by) of one decode attention: the bytes of the live
    K/V blocks, all of ``pos``, q and the f32 output over the memory rate,
    against 4 operations per query head, live slot and head_dim column
    (q.k and p.v) over the bf16 tensor-core peak."""
    from repro_torch.kernels import decode_attn as tda

    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    bt = tda.block_size(t)
    n_live_blocks = int(tda.live_blocks(pos, cur, bt, window).sum())
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window:
        valid &= pos > cur[:, None] - window
    live_slots = int(valid.sum())
    nbytes = (n_live_blocks * bt * kv * hd * 2 * k.element_size()
              + pos.numel() * 4 + q.numel() * q.element_size()
              + b * h * hd * 4)
    ops = 4.0 * h * hd * live_slots
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, pos, cur, window, torch):
    """One ``scaled_dot_product_attention`` computing B5's function (timed
    only, never used by the port): the G query heads of each KV head as G
    query rows against that head's K/V, a boolean mask over the slots.
    This is grouped-query attention without ``enable_gqa=True``, whose
    masked path repeats K/V once per query head (8x 4.3 GB at the
    decode_32k shape)."""
    import torch.nn.functional as F

    b, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [B, KV, T, hd] views
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window:
        valid &= pos > cur[:, None] - window
    mask = valid[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qg, kt, vt, attn_mask=mask)


def _time_attn(name, sets, torch):
    """Time B5, its plain version and one SDPA call over ``sets`` of
    (q, k, v, pos, cur), taken in turn: event loops, and B5's and SDPA's
    device time in a CUDA graph, B5's by kernel; check B5 on the first set
    (on 8 rows where the plain version's f32 upcast of a large cache would
    not fit beside it)."""
    from repro_torch.kernels import decode_attn as tda

    turn = [0]

    def cycle(fn):
        def run():
            turn[0] += 1
            return fn(turn[0] % len(sets))
        return run

    libs = [sdpa_call(*s, 0, torch) for s in sets]
    q, k, v, pos, cur = sets[0]
    b, t = pos.shape
    bound_ms, bound_by = attn_bound(q, k, pos, cur, 0, torch)
    kernel = cycle(lambda i: tda.decode_attention(*sets[i]))
    ms = cuda_ms(kernel, reps=50)
    lib_ms = cuda_ms(cycle(lambda i: libs[i]()), reps=20)
    dev_ms = device_ms(kernel, torch)  # also proves the call captures
    lib_dev_ms = device_ms(cycle(lambda i: libs[i]()), torch)
    parts = kernel_parts(kernel, torch)
    big = b > 8
    plain_ms = cuda_ms(cycle(lambda i: tda.decode_attention_plain(*sets[i])),
                       reps=2 if big else 20, warmup=1)
    rows = [x[:8] for x in sets[0]] if big else sets[0]
    got, want = tda.decode_attention(*rows), tda.decode_attention_plain(*rows)
    torch.testing.assert_close(got, want, atol=LM_ATOL, rtol=LM_RTOL)
    err = float((got - want).abs().max())
    live = tda.live_blocks(pos, cur, tda.block_size(t))
    log(f"time {B5} ({name}): B={b} T={t} live blocks "
        f"{int(live.sum())}/{live.numel()}, K/V "
        f"{2 * k.numel() * k.element_size() / 1e9:.3f} GB x {len(sets)} "
        f"copies: ms={ms:.4f} device_ms={dev_ms:.5f} bound_ms={bound_ms:.5f}"
        f" ({bound_by}) share bound/ms={bound_ms / ms:.3f} bound/device_ms="
        f"{bound_ms / dev_ms:.3f} plain_ms={plain_ms:.3f} library_ms="
        f"{lib_ms:.4f} library_device_ms={lib_dev_ms:.5f} kernel_parts="
        f"{parts} max_abs_err={err:.3g}"
        + (" (checked on 8 rows)" if big else ""))
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                bound_ms=bound_ms, bound_by=bound_by, err=err,
                kernel_parts=parts)


def phase_lm_time(torch, dev="cuda", copies=18, big=(128, 32768)):
    """B5 at bf16 K/V: (a) the serve shape B=4, KV=1, G=8, hd=256, T=1024
    over 18 copies taken in turn (one per layer, 75 MB: the serve loop finds
    them cold in L2); (b) the decode_32k shape (``configs/base.py``:
    B=128, T=32768) at gemma-2b's heads, 4.3 GB of K/V, full and with half
    its blocks unneeded (cur = T/2 - 1)."""
    bf16 = torch.bfloat16
    rows = {}
    sets = [_attn_case(dev, torch, 4, 1, 8, 256, 1024, bf16, (1024,) * 4,
                       seed=100 + i) for i in range(copies)]
    rows["a"] = _time_attn("a, serve shape", sets, torch)
    del sets
    b, t = big
    q, k, v, pos, cur = _attn_case(dev, torch, b, 1, 8, 256, t, bf16,
                                   (t,) * b, seed=200)
    rows["b_full"] = _time_attn("b, decode_32k full", [(q, k, v, pos, cur)],
                                torch)
    rows["b_half"] = _time_attn("b, decode_32k half the blocks unneeded",
                                [(q, k, v, pos, cur // 2)], torch)
    del q, k, v, pos, cur
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ LM families phase
# (arch, depth cut or None, batch, prefill lengths): each family's
# configuration at its published width; qwen3-moe-235b-a22b (469 GB of
# bf16 weights) and qwen2-vl-72b (143 GB) do not fit one card and keep 4
# of their 94 and 8 of their 80 layers.
FAMILY_RUNS = (
    ("gemma-2b", None, 4, (512, 1024)),
    ("gemma3-4b", None, 2, (2048,)),
    ("mamba2-370m", None, 4, (2048,)),
    ("zamba2-2.7b", None, 2, (2048,)),
    ("whisper-base", None, 4, (1500,)),
    ("qwen3-moe-235b-a22b", 4, 2, (1024,)),
    ("qwen2-vl-72b", 8, 2, (1024,)),
)
FAMILY_HEADROOM = 64  # prefill's max_len = S + 64
FAMILY_TEACHER = 8  # teacher-forced decode steps, B5 against plain
FAMILY_DECODE_REPS = 16
# serve_batch's arguments for the families that fit the card whole
FAMILY_SERVE = dict(n_requests=4, max_batch=2, max_new=8, max_len=256, seed=0)
VISION_TOKENS = 256  # qwen2-vl's stub vision embeddings at the prompt's head
MOE_P90_BOUND = 0.06  # tests/test_serving_parity.py:69


def family_config(arch: str, depth):
    """The published configuration, cut in depth where it must be, at the
    lossless capacity factor of ``tests/test_serving_parity.py`` for moe
    (a 1-token decode and a 2,050-token forward drop different tokens at
    the published 1.25 by design)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def attn_layers(cfg) -> int:
    """Layers whose decode step runs B5."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def family_batch(cfg, b: int, s: int, dev, torch, seed: int) -> dict:
    """s + 1 tokens, with whisper's s stub frames and qwen2-vl's stub
    vision embeddings, drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(1, cfg.vocab, (b, s + 1), generator=gen,
                                     device=dev)}
    stub = {"encdec": ("frames", s), "vlm": ("vision_embeds", VISION_TOKENS)}
    if cfg.family in stub:
        key, n = stub[cfg.family]
        batch[key] = (torch.randn((b, n, cfg.d_model), generator=gen,
                                  device=dev) * 0.1).to(torch.bfloat16)
    return batch


def clone_cache(cache, torch):
    def walk(node):
        if isinstance(node, torch.Tensor):
            return node.clone()
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node
    return walk(cache)


class RouteLog:
    """Records the experts each moe layer routes every token to, by
    wrapping ``repro_torch.models.moe._route`` (nothing for the other
    families).  A token's routing is a discontinuous function of its
    hidden state: the last f32 bits B5 and the plain attention differ in
    can send a token whose 8th and 9th expert of 128 nearly tie to
    another expert, which moves its logits by a whole expert's output."""

    def __init__(self, cfg):
        self.on = cfg.family == "moe"
        self.experts = []

    def __enter__(self):
        if self.on:
            from repro_torch.models import moe

            self._moe, self._orig = moe, moe._route

            def route(*args, **kw):
                out = self._orig(*args, **kw)
                self.experts.append(out[1][-1].sort(dim=-1).values)
                return out

            moe._route = route
        return self

    def __exit__(self, *exc):
        if self.on:
            self._moe._route = self._orig

    def same_rows(self, other):
        """[B] bool: rows routed alike in every layer (None off moe)."""
        if not self.on:
            return None
        same = None
        for a, b in zip(self.experts, other.experts, strict=True):
            eq = (a == b).all(dim=-1)
            same = eq if same is None else same & eq
        return same


def check_family_logits(label, got, want, cfg, torch,
                        margin: bool = False, rows=None) -> float:
    """``tests/test_serving_parity.py``'s bounds over the vocabulary's
    columns (the padding columns hold -1e30 on both sides, which would
    make any bound relative to max|want| vacuous): max |d| < 0.05 x
    max|want| and the argmax equal on every row; moe: the 90th percentile
    of |d| < 0.06 x max|want| and the argmax equal on half the rows.
    ``margin``: the lm_serve phase's teacher-forced rule instead, the
    argmax equal wherever ``want``'s top-two margin exceeds twice the
    bound.  ``rows`` (moe): the rows both runs routed to the same experts
    in every layer, which must be at least half (the parity rule's "half
    the argmaxes"); the bound holds over them.  Returns |d| (max, or
    moe's 90th percentile) over max|want|."""
    family = cfg.family
    got, want = got[..., :cfg.vocab], want[..., :cfg.vocab]
    if rows is not None:
        if 2 * int(rows.sum()) < rows.numel():
            raise AssertionError(f"{label}: {int((~rows).sum())} of "
                                 f"{rows.numel()} rows routed apart")
        got, want = got[rows], want[rows]
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{label}: non-finite logits")
    scale = max(float(want.abs().max()), 1.0)
    d = (got - want).abs().float()
    same = got.argmax(-1) == want.argmax(-1)
    if family == "moe":
        err, bound = float(torch.quantile(d.flatten(), 0.9)), MOE_P90_BOUND
        ok = float(same.float().mean()) >= 0.5
    else:
        err, bound = float(d.max()), LOGIT_BOUND
        ok = bool(same.all())
    if margin:
        top2 = want.topk(2, dim=-1).values
        ok = bool(same[(top2[:, 0] - top2[:, 1]) > 2 * bound * scale].all())
    if err >= bound * scale or not ok:
        raise AssertionError(f"{label}: |d| {err} vs {scale}, argmax equal "
                             f"on {same.tolist()}")
    return err / scale


def live_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention over s positions computes."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def prefill_bound(model, params, b: int, s: int):
    """(bound_ms, flops): 2 x the non-embedding parameters a token uses x
    tokens (moe: top_k of n_experts experts; mamba2's SSD products beyond
    its projections not counted), the last position's unembedding, and 4
    x heads x head_dim x the live (query, key) pairs of every attention,
    over the bf16 tensor-core peak."""
    cfg = model.cfg
    n = 0
    for name, sub in params.items():
        if name == "embed":
            continue
        for leaf in _leaves(sub):
            n += leaf.numel()
    if cfg.family == "moe":
        experts = sum(params["blocks"]["moe"][k].numel()
                      for k in ("up", "gate", "down"))
        n -= experts * (1 - cfg.top_k / cfg.n_experts)
    flops = 2.0 * n * b * s + 2.0 * b * cfg.d_model * cfg.vocab_padded
    per = 4.0 * b * cfg.n_heads * cfg.head_dim
    if cfg.family in ("dense", "vlm", "moe"):
        flops += per * sum(live_pairs(s, w) for w in model.layer_windows())
    elif cfg.family == "hybrid":
        flops += per * attn_layers(cfg) * live_pairs(s)
    elif cfg.family == "encdec":  # encoder, decoder self and cross
        flops += per * (cfg.encoder_layers * s * s
                        + cfg.n_layers * (live_pairs(s) + s * s))
    return flops / BF16_FLOPS * 1e3, flops


def decode_bound(params, cache, torch):
    """(bound_ms, bytes): every weight once and the cache's live part once
    (K/V of slots holding a position, SSM states and conv tails, cross
    K/V), over the memory rate."""
    from repro_torch.models.attention import KVCache

    nbytes = sum(p.numel() * p.element_size() for p in _leaves(params))

    def walk(node):
        nonlocal nbytes
        if isinstance(node, KVCache):
            live = int((node.pos >= 0).sum())
            row = node.k[0, 0].numel() * node.k.element_size()
            nbytes += 2 * live * row + node.pos.numel() * 4
        elif isinstance(node, torch.Tensor):
            nbytes += node.numel() * node.element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, tuple):
            for v in node:
                walk(v)

    walk(cache["layers"])
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def time_chunked(label, b, s, h, kv, hd, window, causal, dev, torch):
    """One layer's chunked attention (``models/flash.py``) at a prefill
    shape against one ``scaled_dot_product_attention`` call on the same
    bf16 inputs (timed only), with the bound of the live pairs' operations
    and the q/k/v/output bytes."""
    import torch.nn.functional as F

    from repro_torch.models.flash import TileTable, flash_attention, pick_chunk

    gen = torch.Generator(device=dev).manual_seed(s + h)
    bf16 = torch.bfloat16
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(bf16)
    k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(bf16)
    v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(bf16)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    cq, ck = pick_chunk(s, 512), pick_chunk(s, 1024)
    live = TileTable(pos, pos, cq, ck).live(window, causal)

    def chunked():
        return flash_attention(q, k, v, pos, pos, window, causal, hd**-0.5,
                               cq, ck, live=live)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window:
        p = torch.arange(s, device=dev)
        mask = (p[None, :] <= p[:, None]) & (p[None, :] > p[:, None] - window)

    def library():
        if mask is not None:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    ms = cuda_ms(chunked, reps=5, warmup=1)
    lib_ms = cuda_ms(library, reps=5, warmup=1)
    got, want = chunked(), library().transpose(1, 2).float()
    scale = float(want.abs().max())
    err = float((got.float() - want).abs().max())
    if err >= 0.02 * max(scale, 1.0):
        raise AssertionError(f"chunked attention {label}: |d| {err} against "
                             f"SDPA (max {scale})")
    pairs = live_pairs(s, window) if causal else s * s
    flops = 4.0 * b * h * hd * pairs
    nbytes = (q.numel() * 2 + (k.numel() + v.numel()) * 2) * 2
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    tiles = int(live.sum())
    log(f"lm_families chunked attention {label}: B={b} S={s} H={h} KV={kv} "
        f"hd={hd} window={window} causal={causal} (cq={cq}, ck={ck}, "
        f"{tiles}/{live.size} tiles live): ms={ms:.3f} sdpa_ms={lib_ms:.3f} "
        f"bound_ms={bound:.4f} ({'operations' if t_ops >= t_bytes else 'bytes'})"
        f" |chunked - sdpa| / max = {err / max(scale, 1.0):.3g}")
    return dict(ms=ms, sdpa_ms=lib_ms, bound_ms=bound)


def phase_lm_families(torch, dev="cuda", runs=FAMILY_RUNS,
                      serve=FAMILY_SERVE):
    """The serving path of every family at full width: per configuration,
    prefill of S tokens (``max_len = S + 64``) then one decode step of
    token S, held against ``forward`` over S + 1 tokens at the last
    position; ``FAMILY_TEACHER`` teacher-forced steps from the primed
    cache through B5 and through the plain attention; B5's count zeroed before
    and read after each decode run (attention layers x steps);
    ``serve_batch`` for the families that fit whole; prefill and decode
    timed against their bounds.  Returns (B5 launches, rows)."""
    import gc

    from repro_torch.kernels import decode_attn as tda
    from repro_torch.kernels.decode_attn import decode_attention_plain
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    peak_before = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    launched = 0
    rows = {}
    for arch, depth, b, lengths in runs:
        cfg = family_config(arch, depth)
        t0 = time.perf_counter()
        model = build_model(cfg, dev)
        plain = build_model(cfg, dev, attention=decode_attention_plain)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        w_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
        log(f"lm_families {arch}: {cfg.family}, {cfg.n_layers} layers"
            + (f" (of {depth and family_config(arch, None).n_layers})"
               if depth else "")
            + f", d={cfg.d_model}, {w_bytes / 1e9:.3f} GB of weights, "
            f"initialised in {time.perf_counter() - t0:.1f} s")
        n_attn = attn_layers(cfg)
        row = {"family": cfg.family, "layers": cfg.n_layers,
               "weights_gb": w_bytes / 1e9}
        for s in lengths:
            key = f"{arch}/S{s}"
            batch = family_batch(cfg, b, s, dev, torch, seed=s)
            prompt = dict(batch, tokens=batch["tokens"][:, :s])
            with torch.inference_mode():
                oracle = model.forward(params, batch)[0][:, -1].clone()
            pre_logits, cache = model.prefill(params, prompt,
                                              max_len=s + FAMILY_HEADROOM)
            # teacher-forced: token S, then seeded tokens, through B5 and
            # through the plain attention, every step from the B5 route's
            # cache (separate caches drift apart step by step).  Step 0 is
            # also the parity step against the forward.
            gen = torch.Generator(device=dev).manual_seed(s + 1)
            toks = torch.cat([batch["tokens"][:, s:s + 1],
                              torch.randint(1, cfg.vocab, (b, FAMILY_TEACHER - 1),
                                            generator=gen, device=dev)], 1)
            worst, flipped = 0.0, 0
            tda.reset_launches()
            for i in range(FAMILY_TEACHER):
                cache_plain = clone_cache(cache, torch)
                with RouteLog(cfg) as fast_route:
                    got, cache = model.decode_step(params, cache,
                                                   toks[:, i:i + 1])
                if i == 0:
                    parity = check_family_logits(
                        f"{key} prefill+decode vs forward", got, oracle, cfg,
                        torch)
                    del oracle
                with RouteLog(cfg) as plain_route:
                    want, _ = plain.decode_step(params, cache_plain,
                                                toks[:, i:i + 1])
                same = fast_route.same_rows(plain_route)
                flipped += 0 if same is None else int((~same).sum())
                worst = max(worst, check_family_logits(
                    f"{key} teacher step {i}: B5 vs plain", got, want, cfg,
                    torch, margin=True, rows=same))
            torch.cuda.synchronize()
            count = tda.launches[B5]
            if count != n_attn * FAMILY_TEACHER:
                raise AssertionError(f"{key}: B5 ran {count} times, not "
                                     f"{n_attn} x {FAMILY_TEACHER}")
            launched += count
            del cache_plain
            # timing: prefill against its FLOP bound, a decode step
            # against its byte bound (on the cache the steps above left)
            pre_ms = cuda_ms(lambda: model.prefill(
                params, prompt, max_len=s + FAMILY_HEADROOM), reps=3,
                warmup=1)
            pre_bound, pre_flops = prefill_bound(model, params, b, s)
            step_tok = toks[:, -1:]

            def one_step():
                nonlocal cache
                _, cache = model.decode_step(params, cache, step_tok)

            tda.reset_launches()
            dec_ms = cuda_ms(one_step, reps=FAMILY_DECODE_REPS, warmup=2)
            launched += tda.launches[B5]
            if tda.launches[B5] != n_attn * (FAMILY_DECODE_REPS + 2):
                raise AssertionError(f"{key}: B5 ran {tda.launches[B5]} "
                                     f"times in {FAMILY_DECODE_REPS + 2} steps")
            dec_bound, dec_bytes = decode_bound(params, cache, torch)
            log(f"lm_families {key}: B={b} prefill+decode vs forward "
                f"{parity:.3g} (bound {MOE_P90_BOUND if cfg.family == 'moe' else LOGIT_BOUND}); "
                f"{FAMILY_TEACHER} teacher-forced steps B5 vs plain worst {worst:.3g}"
                + (f" ({flipped} rows of {FAMILY_TEACHER * b} routed to another "
                   f"expert set)" if cfg.family == "moe" else "") + "; "
                f"B5 launches {count} = {n_attn} attention layers x "
                f"{FAMILY_TEACHER}; prefill ms={pre_ms:.3f} bound_ms={pre_bound:.3f} "
                f"({pre_flops / 1e12:.3f} TFLOP) share={pre_bound / pre_ms:.3f}"
                f"; decode ms/step={dec_ms:.3f} bound_ms={dec_bound:.3f} "
                f"({dec_bytes / 1e9:.3f} GB) share={dec_bound / dec_ms:.3f}")
            row[f"S{s}"] = dict(batch=b, parity=parity, teacher_worst=worst,
                                routing_flips=flipped, b5_launches=count, prefill_ms=pre_ms,
                                prefill_bound_ms=pre_bound, decode_ms=dec_ms,
                                decode_bound_ms=dec_bound)
            del batch, prompt, cache, pre_logits, got, want
        if not depth:
            tda.reset_launches()
            res = serve_batch(arch, smoke=False, device=dev, params=params,
                              **serve)
            count = tda.launches[B5]
            launched += count
            want_tokens = serve["n_requests"] * serve["max_new"]
            if (res["tokens"] != want_tokens
                    or count != n_attn * res["decode_steps"]):
                raise AssertionError(f"{arch} serve_batch: {res['tokens']} "
                                     f"tokens, B5 ran {count} times in "
                                     f"{res['decode_steps']} steps")
            row["serve"] = dict(tokens=res["tokens"],
                                decode_steps=res["decode_steps"],
                                ms_per_step=res["seconds"]
                                / res["decode_steps"] * 1e3,
                                b5_launches=count)
            log(f"lm_families {arch} serve_batch: {res['tokens']} tokens, "
                f"{res['decode_steps']} decode steps, "
                f"{row['serve']['ms_per_step']:.3f} ms per step, B5 {count}"
                f" = {n_attn} x {res['decode_steps']}")
        rows[arch] = row
        del model, plain, params
        gc.collect()
        torch.cuda.empty_cache()
    rows["chunked_attention"] = {
        "gemma-2b/S1024": time_chunked("gemma-2b S=1024", 4, 1024, 8, 1,
                                       256, 0, True, dev, torch),
        "gemma3-4b/S2048/global": time_chunked(
            "gemma3-4b S=2048 global", 2, 2048, 8, 4, 256, 0, True, dev,
            torch),
        "gemma3-4b/S2048/local": time_chunked(
            "gemma3-4b S=2048 window 1024", 2, 2048, 8, 4, 256, 1024,
            True, dev, torch),
        "zamba2-2.7b/S2048": time_chunked("zamba2-2.7b S=2048", 2, 2048,
                                          32, 32, 80, 0, True, dev,
                                          torch),
        "whisper-base/enc1500": time_chunked(
            "whisper-base encoder S=1500", 4, 1500, 8, 8, 64, 0, False,
            dev, torch),
        "qwen3-moe/S1024": time_chunked("qwen3-moe S=1024", 2, 1024, 64,
                                        4, 128, 0, True, dev, torch),
    }
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = time.perf_counter() - t_phase
    log(f"lm_families: {wall:.1f} s, peak device memory {peak:.2f} GB "
        f"(before the phase {peak_before:.2f} GB), B5 launched {launched} "
        f"times")
    rows["wall_s"], rows["peak_gb"] = wall, peak
    return launched, rows


# ------------------------------------------------------------ training
TRAIN_B, TRAIN_S = 2, 1024  # TokenStream(global_batch=2, seq_len=1024)
TRAIN_TIMED = 3  # timed steps after one warm-up step, per remat policy
TRAIN_REMATS = ("none", "full")
# "none" and "full" replay the same ops, so their first steps should agree
# to the bit; the gate allows f32 reassociation in a recomputed reduction.
TRAIN_RTOL = 1e-5
# the flash backward (bf16 gradients) against the dense f32 softmax's
FLASH_BWD_BOUND = 0.02
FLASH_REPS = 20  # timed calls of one layer's attention, after 2 warm-ups
# unembed's card route (layers._LogitsF32) against the upcast product: the
# logits, and the backward's two f32 products (the f32 logit gradient
# against the bf16 operands) before their one rounding to bf16, up to f32
# accumulation order
LOGITS_BOUND = LOGIT_GRAD_BOUND = 1e-5
TRAIN_FAMILIES = (("gemma-2b", "dense"), ("qwen2-vl-72b", "vlm"),
                  ("qwen3-moe-235b-a22b", "moe"), ("mamba2-370m", "ssm"),
                  ("zamba2-2.7b", "hybrid"), ("whisper-base", "encdec"))
TRAIN_LOOP = dict(steps=300, ckpt_every=50, inject_failures=True)


def train_bound(model, params, b: int, s: int):
    """(bound_ms, flops) of one train step: 6 x the non-embedding
    parameters x tokens, 6 x d x V x tokens for the tied unembedding, and
    12 x heads x head_dim x the live (query, key) pairs of every layer
    (forward 4, backward 8), over the bf16 tensor-core peak."""
    cfg = model.cfg
    n = sum(leaf.numel() for name, sub in params.items() if name != "embed"
            for leaf in _leaves(sub))
    tokens = b * s
    flops = 6.0 * n * tokens + 6.0 * cfg.d_model * cfg.vocab_padded * tokens
    flops += (12.0 * b * cfg.n_heads * cfg.head_dim
              * sum(live_pairs(s, w) for w in model.layer_windows()))
    return flops / BF16_FLOPS * 1e3, flops, n


def flash_layer_check(cfg, dev, torch) -> dict:
    """At one gemma-2b layer's shape (B=2, S=1,024, H=8, KV=1, hd=256,
    bf16): the chunked attention's dq, dk, dv against autograd through the
    dense masked softmax in f32 on the same values (each within
    FLASH_BWD_BOUND x its largest entry), and the backward's ms against the
    forward's and one SDPA forward + backward's."""
    import torch.nn.functional as F

    from repro_torch.models.flash import (NEG_INF, TileTable,
                                          flash_attention, pick_chunk)

    b, s, h, kv, hd = TRAIN_B, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev)
                     .to(torch.bfloat16) for shape in
                     ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                      (b, s, h, hd)))
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    cq, ck = pick_chunk(s, 512), pick_chunk(s, 1024)
    live = TileTable(pos, pos, cq, ck).live(0, True)
    scale = hd**-0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, pos, pos, 0, True, scale, cq, ck,
                          live=live)
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    g = h // kv
    sc = torch.einsum("bqkgh,btkh->bkgqt", ref[0].reshape(b, s, kv, g, hd),
                      ref[1]) * scale
    valid = pos[:, None, :] <= pos[:, :, None]
    sc = sc.masked_fill(~valid[:, None, None], NEG_INF)
    o = torch.einsum("bkgqt,btkh->bqkgh", torch.softmax(sc, -1), ref[2])
    want = torch.autograd.grad(o.reshape(b, s, h, hd), ref, dout.float())
    errs = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - w).abs().max()) / float(w.abs().max())
        errs[name] = err
        if not (a.dtype == torch.bfloat16 and err < FLASH_BWD_BOUND):
            raise AssertionError(f"lm_train flash backward {name}: "
                                 f"|d| / max = {err:.3g} ({a.dtype})")
    del sc, o, want, ref

    def forward():
        with torch.no_grad():
            return flash_attention(q, k, v, pos, pos, 0, True, scale, cq, ck,
                                   live=live)

    def backward():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dout.transpose(1, 2))

    row = dict(fwd_ms=cuda_ms(forward, reps=FLASH_REPS, warmup=2),
               bwd_ms=cuda_ms(backward, reps=FLASH_REPS, warmup=2),
               sdpa_fwd_bwd_ms=cuda_ms(sdpa, reps=FLASH_REPS, warmup=2),
               rel_err=errs)
    log(f"lm_train flash layer B={b} S={s} H={h} KV={kv} hd={hd} bf16: "
        f"dq/dk/dv against the dense f32 softmax "
        + ", ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + f" (bound {FLASH_BWD_BOUND}); forward {row['fwd_ms']:.3f} ms, "
        f"backward {row['bwd_ms']:.3f} ms "
        f"({row['bwd_ms'] / row['fwd_ms']:.2f}x), one SDPA forward + "
        f"backward {row['sdpa_fwd_bwd_ms']:.3f} ms")
    return row


def logits_check(cfg, dev, torch) -> dict:
    """At gemma-2b's tied unembedding (B=2 x S=1,024 rows against the
    256,000 x 2,048 bf16 table): ``unembed``'s card route
    (``layers._LogitsF32``) and its gradient against the upcast product on
    the same values, as relative L2 distances.  The logits against the f32
    upcast product (autograd's reference) within LOGITS_BOUND; the
    backward's f32 products (``layers._mm_f32``, the logit gradient kept
    in f32 as the reference keeps it) within LOGIT_GRAD_BOUND of the upcast
    product taken in float64, since cuBLAS's f32 product sums dx's 256,000
    terms with an error of its own (~9e-6, logged); their distance to the
    f32 upcast product is logged beside.  The bf16 gradients autograd
    returns must be those products rounded once."""
    from repro_torch.models.layers import _mm_f32, unembed

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm_train logits: TF32 products are on")
    d, vocab = cfg.d_model, cfg.vocab_padded
    gen = torch.Generator(device=dev).manual_seed(5)
    table = (torch.randn((vocab, d), generator=gen, device=dev)
             * d**-0.5).bfloat16()
    x = torch.randn((TRAIN_B, TRAIN_S, d), generator=gen,
                    device=dev).bfloat16()
    dlogits = torch.randn((TRAIN_B, TRAIN_S, vocab), generator=gen,
                          device=dev)
    xp, tp = x.clone().requires_grad_(), table.clone().requires_grad_()
    got = unembed({"table": tp}, xp, cfg)
    dx, dt = torch.autograd.grad(got, (xp, tp), dlogits)
    g2, x2 = dlogits.reshape(-1, vocab), x.reshape(-1, d)
    dx32 = _mm_f32(g2, table).reshape(dx.shape)
    dt32 = _mm_f32(x2.T, g2).T
    xr, tr = x.float().requires_grad_(), table.float().requires_grad_()
    want = xr @ tr.T
    dx_want, dt_want = torch.autograd.grad(want, (xr, tr), dlogits)
    del xr, tr

    def rel(a, b):
        a, b = a.detach().double(), b.detach().double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    errs = dict(logits=rel(got, want))
    del want
    g64 = g2.double()
    dx64 = (g64 @ table.double()).reshape(dx.shape)
    errs.update(dx=rel(dx32, dx64), dx_to_f32=rel(dx32, dx_want),
                dx_f32_to_f64=rel(dx_want, dx64), dx_bf16=rel(dx, dx_want))
    del dx64
    dt64 = (x2.double().T @ g64).T
    del g64
    errs.update(dtable=rel(dt32, dt64), dtable_to_f32=rel(dt32, dt_want),
                dtable_f32_to_f64=rel(dt_want, dt64),
                dtable_bf16=rel(dt, dt_want))
    rounded = (torch.equal(dx, dx32.bfloat16())
               and torch.equal(dt, dt32.bfloat16()))
    ok = (got.dtype == torch.float32 and dx.dtype == dt.dtype
          == torch.bfloat16 and errs["logits"] < LOGITS_BOUND
          and errs["dx"] < LOGIT_GRAD_BOUND
          and errs["dtable"] < LOGIT_GRAD_BOUND and rounded)
    log(f"lm_train logits (_LogitsF32), relative L2: "
        + ", ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + f" (bounds {LOGITS_BOUND} on logits against the f32 upcast "
        f"product, {LOGIT_GRAD_BOUND} on dx and dtable against the float64 "
        f"one; the bf16 gradients equal the f32 products rounded once: "
        f"{rounded})")
    if not ok:
        raise AssertionError(f"lm_train logits: {errs}")
    return errs


def train_full_width(torch, dev, cfg) -> dict:
    """(a): gemma-2b at its published width and depth, seeded weights, one
    warm-up and TRAIN_TIMED timed steps under each remat policy from the
    same initial state."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params0 = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    w_bytes = sum(p.numel() * p.element_size() for p in _leaves(params0))
    stream = TokenStream(vocab=cfg.vocab, seq_len=TRAIN_S,
                         global_batch=TRAIN_B)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch(i).items()
                if k in ("tokens", "labels")}
               for i in range(1 + TRAIN_TIMED)]
    bound_ms, flops, n_params = train_bound(model, params0, TRAIN_B, TRAIN_S)
    log(f"lm_train {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{w_bytes / 1e9:.3f} GB of bf16 weights ({n_params / 1e9:.3f}e9 "
        f"non-embedding parameters) initialised in "
        f"{time.perf_counter() - t0:.1f} s; batches TokenStream(vocab="
        f"{cfg.vocab}, seq_len={TRAIN_S}, global_batch={TRAIN_B}); step "
        f"bound {flops:.4g} FLOP = {bound_ms:.2f} ms at {BF16_FLOPS:.3g}/s")
    out = {"bound_ms": bound_ms, "flops": flops}
    first = {}
    for remat in TRAIN_REMATS:
        params = _clone_tree(params0, torch)
        opt = adamw_init(params)
        step = make_train_step(model, TrainConfig(remat=remat), donate=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, opt, m = step(params, opt, batches[0])
        first[remat] = (float(m["loss"]), float(m["grad_norm"]))
        if not all(math.isfinite(x) for x in first[remat]):
            raise AssertionError(f"lm_train {remat}: loss/grad_norm "
                                 f"{first[remat]}")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses = []
        for b in batches[1:]:
            params, opt, m = step(params, opt, b)
            losses.append(m["loss"])
        stop.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
        ms = start.elapsed_time(stop) / TRAIN_TIMED
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [float(x) for x in losses]
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(_leaves(params), _leaves(params0)))
        if not (all(math.isfinite(x) for x in losses) and moved):
            raise AssertionError(f"lm_train {remat}: losses {losses}, "
                                 f"{moved} leaves moved")
        row = dict(ms=ms, wall_ms=wall, tokens_per_s=TRAIN_B * TRAIN_S / ms
                   * 1e3, peak_gb=peak, first_loss=first[remat][0],
                   first_grad_norm=first[remat][1], losses=losses,
                   leaves_moved=moved, share_of_bound=bound_ms / ms)
        if remat == "none":
            prof = phase_profile(((f"lm_train/{cfg.name}/step",
                                   lambda: step(params, opt, batches[1])),),
                                 torch)
            p = next(iter(prof.values()))
            row["idle_share"] = 1 - p["device_ms"] / p["wall_ms"]
            row["profile"] = p
            row["split"] = step_split(model, params, opt, batches[1], torch)
        if "split" in row:
            sp = row["split"]
            log(f"lm_train {cfg.name} step split: forward "
                f"{sp['forward_ms']:.2f} ms, AdamW {sp['adamw_ms']:.2f} ms, "
                f"backward (the rest) "
                f"{ms - sp['forward_ms'] - sp['adamw_ms']:.2f} ms")
        log(f"lm_train {cfg.name} remat={remat}: {ms:.2f} ms a step "
            f"(events; wall {wall:.2f} ms) against the {bound_ms:.2f} ms "
            f"bound ({bound_ms / ms:.3f} of it), "
            f"{row['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB; first "
            f"step loss {first[remat][0]:.6f} grad_norm "
            f"{first[remat][1]:.6f}; timed losses {losses}; {moved} leaves "
            f"moved")
        out[remat] = row
        del params, opt, step, m
        gc_cuda(torch)
    (la, ga), (lb, gb) = first["none"], first["full"]
    if not (abs(la - lb) <= TRAIN_RTOL * abs(la)
            and abs(ga - gb) <= TRAIN_RTOL * abs(ga)):
        raise AssertionError(f"lm_train: remat none {first['none']} and full "
                             f"{first['full']} differ")
    out["remat_bit_equal"] = first["none"] == first["full"]
    log(f"lm_train remat none and full: loss and grad_norm within "
        f"{TRAIN_RTOL} (bit-equal: {out['remat_bit_equal']})")
    out["flash"] = flash_layer_check(cfg, dev, torch)
    gc_cuda(torch)
    out["logits"] = logits_check(cfg, dev, torch)
    del params0
    gc_cuda(torch)
    return out


def step_split(model, params, opt, batch, torch) -> dict:
    """Where a step's time goes (CUDA events): the loss's forward alone, and
    the in-place AdamW update alone on a gradient tree of the parameters'
    shapes; the backward is the rest of the step."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.steps import cross_entropy
    from repro_torch.optim import adamw_update

    def forward():
        with torch.no_grad():
            logits, _ = model.forward(params, batch)
            return cross_entropy(logits, batch["labels"])

    grads = _clone_tree(params, torch)
    split = dict(
        forward_ms=cuda_ms(forward, reps=3, warmup=1),
        adamw_ms=cuda_ms(lambda: adamw_update(grads, opt, params,
                                              TrainConfig(), inplace=True),
                         reps=3, warmup=1))
    del grads
    return split


def _clone_tree(tree, torch):
    if isinstance(tree, dict):
        return {k: _clone_tree(v, torch) for k, v in tree.items()}
    return tree.clone()


def gc_cuda(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def family_train_batch(cfg, b, s, dev, torch, seed) -> dict:
    """TokenStream tokens and labels (b rows of s), with whisper's stub
    frames and qwen2-vl's stub vision embeddings drawn on the card."""
    from repro_torch.data import TokenStream

    host = TokenStream(vocab=cfg.vocab, seq_len=s, global_batch=b,
                       seed=seed).batch(0)
    batch = {k: torch.from_numpy(host[k]).to(dev) for k in ("tokens",
                                                            "labels")}
    gen = torch.Generator(device=dev).manual_seed(seed)
    stub = {"encdec": ("frames", s), "vlm": ("vision_embeds", 8)}
    if cfg.family in stub:
        key, n = stub[cfg.family]
        batch[key] = (torch.randn((b, n, cfg.d_model), generator=gen,
                                  device=dev) * 0.1).to(torch.bfloat16)
    return batch


def train_families(torch, dev) -> dict:
    """(b): one train step of each family at its smoke configuration with
    microbatches=2; the moe step twice from one state, bit-equal."""
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    rows = {}
    for arch, family in TRAIN_FAMILIES:
        cfg = get_smoke(arch)
        model = build_model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        batch = family_train_batch(cfg, 4, 64, dev, torch, seed=1)
        step = make_train_step(model, TrainConfig(microbatches=2))
        t0 = time.perf_counter()
        p1, o1, m1 = step(params, adamw_init(params), batch)
        loss = float(m1["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(_leaves(p1), _leaves(params)))
        if not (math.isfinite(loss) and moved):
            raise AssertionError(f"lm_train {arch}: loss {loss}, {moved} "
                                 "leaves moved")
        row = dict(family=family, loss=loss, grad_norm=float(m1["grad_norm"]),
                   leaves_moved=moved, first_step_wall_ms=ms)
        if family == "moe":
            p2, o2, m2 = step(params, adamw_init(params), batch)
            same = (torch.equal(m1["loss"], m2["loss"])
                    and all(torch.equal(a, b) for a, b in
                            zip(_leaves((p1, o1.m, o1.v)),
                                _leaves((p2, o2.m, o2.v)))))
            if not same:
                raise AssertionError("lm_train moe: two steps from one "
                                     "state differ")
            row["repeat_bit_equal"] = True
        rows[arch] = row
        log(f"lm_train {arch} ({family}, smoke, microbatches=2): "
            f"{json.dumps(row)}")
    return rows


def train_loop_run(torch, dev) -> dict:
    """(c): ``train_loop`` at the smoke configuration on the card with a
    crash and a straggling step injected, into a temporary directory; the
    reference's gate (loss falls), 1 restart, >= 1 straggler event."""
    import tempfile

    from repro_torch.launch.train import train_loop

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        res = train_loop(LM_ARCH, ckpt_dir=d, device=dev, **TRAIN_LOOP)
    if not (res["loss_last10"] < res["loss_first10"]
            and res["restarts"] == 1 and res["straggler_events"] >= 1):
        raise AssertionError(f"lm_train train_loop: {res}")
    log(f"lm_train train_loop({LM_ARCH}, {TRAIN_LOOP}): {json.dumps(res)}")
    return res


def phase_lm_train(torch, dev="cuda", full_cfg=None) -> dict:
    """The training path: (a) gemma-2b at full width, (b) every family's
    smoke step, (c) ``train_loop`` with failures.  Launches none of B1-B5."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = full_cfg or get_config(LM_ARCH)
    rows = {"full": train_full_width(torch, dev, cfg),
            "families": train_families(torch, dev),
            "train_loop": train_loop_run(torch, dev)}
    rows["seconds"] = time.perf_counter() - t_phase
    log(f"lm_train took {rows['seconds']:.1f} s")
    return rows


MESH_B, MESH_S, MESH_STEPS = 2, 1024, 8  # (a): prefill B x S, decode steps
MESH_TIMED = 2  # (b): timed planned steps after the compared one
MESH_REPS = 5  # (a), (c): timed calls after the warm-ups
MESH_STORE = ROOT / "build" / "mesh" / "lm_mesh_store"  # git-ignored
MESH_ARCH = "qwen3-moe-235b-a22b"
MESH_DEPTH = 4  # of 94 layers, as lm_families cuts it


def mesh_moe(mesh, torch, dev, cfg, smi) -> dict:
    """(a): the moe serving path through the steps with their plans (the
    prefill's, the decode's serving layout, the cache held as
    ``cache_pspecs`` lays it out) against the same model without a mesh,
    bit for bit, and ``moe_ffn_ep`` against ``moe_ffn`` on one layer's
    experts at the prefill and the decode shape."""
    from repro_torch.distributed.sharding import (cache_pspecs,
                                                  param_shardings,
                                                  shard_params)
    from repro_torch.kernels import decode_attn as tda
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_ffn, moe_ffn_ep

    t0 = time.perf_counter()
    plain = build_model(cfg, dev)
    meshed = build_model(cfg, dev).set_mesh(mesh)
    params = plain.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"lm_mesh (a) {cfg.name}: {cfg.n_layers} layers, initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = family_batch(cfg, MESH_B, MESH_S, dev, torch, seed=MESH_S)
    prompt = dict(batch, tokens=batch["tokens"][:, :MESH_S])
    gen = torch.Generator(device=dev).manual_seed(MESH_S + 1)
    toks = torch.cat([batch["tokens"][:, MESH_S:], torch.randint(
        1, cfg.vocab, (MESH_B, MESH_STEPS - 1), generator=gen, device=dev)],
        1)
    axes, max_len = plain.logical_axes(), MESH_S + MESH_STEPS
    pplan = param_shardings(axes, params, mesh)
    dplan = param_shardings(axes, params, mesh, fsdp=False, moe_2d=True)
    cplan = cache_pspecs(build_model(cfg, "meta").init_cache(
        MESH_B, max_len), mesh, MESH_B)
    steps = {"plain": (lambda b: plain.prefill(params, b, max_len=max_len),
                       lambda c, t: plain.decode_step(params, c, t)),
             "mesh": (functools.partial(make_prefill_step(
                 meshed, param_shardings=pplan, cache_shardings=cplan,
                 max_len=max_len), shard_params(params, pplan)),
                 lambda c, t, d=make_decode_step(
                     meshed, param_shardings=dplan, cache_shardings=cplan),
                 blocks=shard_params(params, dplan): d(blocks, c, t)[1:])}
    runs, launches = {}, 0
    for name, (prefill, decode) in steps.items():
        logits, cache = prefill(prompt)
        out = [logits]
        if name == "mesh":
            tda.reset_launches()
        for i in range(MESH_STEPS):
            logits, cache = decode(cache, toks[:, i:i + 1])
            out.append(logits)
        torch.cuda.synchronize()
        if name == "mesh":
            launches = tda.launches[B5]
        runs[name] = out
        del cache
    if not all(torch.equal(a, b) for a, b in zip(runs["plain"],
                                                 runs["mesh"])):
        raise AssertionError("lm_mesh (a): logits of the planned steps on a "
                             "one-rank mesh differ from the logits without "
                             "a mesh")
    want = attn_layers(cfg) * MESH_STEPS
    if launches != want:
        raise AssertionError(f"lm_mesh (a): B5 ran {launches} times, not "
                             f"{want}")
    log(f"lm_mesh (a) prefill B={MESH_B} S={MESH_S} + {MESH_STEPS} decode "
        f"steps through make_prefill_step / make_decode_step with their "
        f"plans (the cache held as cache_pspecs lays it out): logits "
        f"bit-equal to the model's without a mesh at all {MESH_STEPS + 1} "
        f"steps; B5 launched {launches} times")
    row = {"logits_bit_equal": True, "b5_launches": launches}
    del steps
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    for label, s in (("prefill", MESH_S), ("decode", 1)):
        x = torch.randn((MESH_B, s, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            y0, a0 = moe_ffn(p, x, cfg)
            y1, a1 = moe_ffn_ep(p, x, cfg, mesh)
            if not (torch.equal(y0, y1) and torch.equal(a0, a1)):
                raise AssertionError(f"lm_mesh (a) moe_ffn_ep at {label}: "
                                     "y or aux differ from moe_ffn")
            ms_ep = cuda_ms(lambda: moe_ffn_ep(p, x, cfg, mesh), MESH_REPS)
            ms = cuda_ms(lambda: moe_ffn(p, x, cfg), MESH_REPS)
        row[label] = {"tokens": MESH_B * s, "moe_ffn_ep_ms": ms_ep,
                      "moe_ffn_ms": ms}
        log(f"lm_mesh (a) moe_ffn_ep at the {label} shape ({MESH_B} x {s} "
            f"tokens, layer 0's {cfg.n_experts} experts): y and aux "
            f"bit-equal to moe_ffn; {ms_ep:.3f} ms against moe_ffn's "
            f"{ms:.3f} ms (CUDA events, {MESH_REPS} calls; {smi})")
    del plain, meshed, params, runs
    gc_cuda(torch)
    return row


def mesh_train(mesh, torch, dev, cfg, smi) -> dict:
    """(b) the blocked step with a plan (the rank's blocks of the
    parameters and moments, ``shard_params``) against the step without
    one, from one state and one batch of ``sharded_batches`` over the mesh;
    (c) ``compressed_psum`` over 'data' on that batch's gradient tree
    against ``decompress(compress(g, e))``."""
    from repro_torch.checkpoint.store import _flatten, _unflatten
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenStream, sharded_batches
    from repro_torch.distributed.sharding import (
        batch_pspec, gather_params, param_shardings, shard_params)
    from repro_torch.launch.steps import cross_entropy, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import (adamw_init, compress, compressed_psum,
                                   decompress, init_error)

    model = build_model(cfg, dev)
    params0 = model.init(torch.Generator(device=dev).manual_seed(0))
    plan = param_shardings(model.logical_axes(), params0, mesh)
    stream = TokenStream(vocab=cfg.vocab, seq_len=TRAIN_S,
                         global_batch=TRAIN_B)
    spec = batch_pspec(TRAIN_B, mesh)
    batches = sharded_batches(stream, mesh, spec)
    first = next(batches)
    tc = TrainConfig()
    params, opt, m_a = make_train_step(model, tc, donate=True)(
        _clone_tree(params0, torch), adamw_init(params0), first)
    want = dict(m_a, params=params)
    del params, opt
    gc_cuda(torch)
    step = make_train_step(model, tc, param_shardings=plan, donate=True)
    params = shard_params(_clone_tree(params0, torch), plan)
    opt = adamw_init(params)
    params, opt, m_b = step(params, opt, first)
    for key in ("loss", "grad_norm"):
        if not torch.equal(m_a[key], m_b[key]):
            raise AssertionError(f"lm_mesh (b): {key} {float(m_b[key])} "
                                 f"with the plan, {float(m_a[key])} without")
    if not all(torch.equal(a, b) for a, b in zip(
            _leaves(want["params"]), _leaves(gather_params(params, plan)))):
        raise AssertionError("lm_mesh (b): updated parameters differ from "
                             "the step's without a plan")
    del want
    gc_cuda(torch)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    timed = [next(batches) for _ in range(MESH_TIMED)]
    torch.cuda.synchronize()
    start.record()
    for b in timed:
        params, opt, m = step(params, opt, b)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / MESH_TIMED
    row = {"spec": str(tuple(spec)), "loss": float(m_b["loss"]),
           "grad_norm": float(m_b["grad_norm"]), "ms_per_step": ms,
           "losses": [float(m["loss"])]}
    log(f"lm_mesh (b) {cfg.name} B={TRAIN_B} S={TRAIN_S}, sharded_batches "
        f"spec {row['spec']}: the blocked step's loss "
        f"{row['loss']:.6f}, grad norm {row['grad_norm']:.6f} and updated "
        f"parameters bit-equal to the step without a plan; {ms:.2f} ms a "
        f"step (CUDA events, {MESH_TIMED} steps; {smi})")
    del params, opt, step, m
    gc_cuda(torch)

    # (c) the gradient tree of the first batch at the initial state
    flat, _ = _flatten(params0)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        logits, aux = model.forward(_unflatten(params0, leaves), first)
        loss = cross_entropy(logits, first["labels"]) + 0.01 * aux
        grads = torch.autograd.grad(loss, leaves)
    grads = _unflatten(params0, list(grads))
    del logits, aux, loss, leaves, params0
    gc_cuda(torch)
    err = init_error(grads)
    mean, new_err = compressed_psum(grads, err, "data", mesh=mesh)
    for g, e, mn, ne in zip(_leaves(grads), _leaves(err), _leaves(mean),
                            _leaves(new_err)):
        q, sc, e2 = compress({"g": g}, {"g": e})
        if not (torch.equal(mn, decompress(q, sc)["g"])
                and torch.equal(ne, e2["g"])):
            raise AssertionError("lm_mesh (c): compressed_psum differs from "
                                 "decompress(compress(g, e))")
    del mean, new_err, g, e, mn, ne, q, sc, e2
    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    psum_ms = cuda_ms(lambda: compressed_psum(grads, err, "data", mesh=mesh),
                      MESH_TIMED, warmup=1)
    payload = sum(g.numel() for g in _leaves(grads))
    row["compressed_psum"] = {"ms": psum_ms, "int8_bytes": payload,
                              "peak_gb": torch.cuda.max_memory_allocated()
                              / 1e9,
                              "int32_allreduce_bytes": 4 * payload,
                              "leaves": len(list(_leaves(grads)))}
    log(f"lm_mesh (c) compressed_psum over 'data' on the gradient tree "
        f"({row['compressed_psum']['leaves']} leaves): mean and error "
        f"bit-equal to decompress(compress(g, e)); {psum_ms:.3f} ms "
        f"(CUDA events, {MESH_TIMED} calls; {smi}); int8 payload {payload} "
        f"bytes, summed as int32 ({4 * payload} bytes an all-reduce)")
    del grads, err
    gc_cuda(torch)
    return row


def mesh_specs(torch, dev) -> dict:
    """(d) every registry configuration's state and decode_32k cache on the
    meta device, and one rank's bytes of each under the (16, 16) plan."""
    from repro_torch.configs import SHAPES, get_config, list_archs
    from repro_torch.distributed.sharding import (
        MeshShape, _shard_bytes, cache_pspecs, param_pspecs)
    from repro_torch.launch.specs import cache_specs, state_specs
    from repro_torch.models import build_model

    pod = MeshShape((16, 16), ("data", "model"))
    shape = SHAPES["decode_32k"]
    before = torch.cuda.memory_allocated()
    rows = {}
    for arch in list_archs():
        model = build_model(get_config(arch), dev)
        params, opt, axes = state_specs(model)
        cache = cache_specs(model, shape)
        specs = param_pspecs(axes, params, pod)
        rows[arch] = {
            "params_bytes": sum(t.numel() * t.element_size()
                                for t in _leaves(params)),
            "params_bytes_per_rank": _shard_bytes(params, specs, pod),
            "opt_bytes_per_rank": _shard_bytes(opt.m, specs, pod)
            + _shard_bytes(opt.v, specs, pod),
            "decode_32k_cache_bytes_per_rank": _shard_bytes(
                cache, cache_pspecs(cache, pod, shape.global_batch), pod)}
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"lm_mesh (d): the specs moved the card's "
                             f"allocation from {before} to {after} bytes")
    log("lm_mesh (d) state_specs and cache_specs(decode_32k) of the "
        f"{len(rows)} registry configurations on the meta device, "
        f"memory_allocated unchanged ({after} bytes); bytes one rank holds "
        "under the (16, 16) plan, computed from the plan (not measured): "
        + json.dumps(rows))
    return rows


def mesh_roofline(torch, runs=FAMILY_RUNS) -> dict:
    """(e) ``roofline.model_flops`` beside this script's own FLOP counts for
    the shapes lm_families and lm_train run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    from repro_torch.models import build_model

    rows = {}
    cells = [(arch, depth, b, s, "prefill")
             for arch, depth, b, lengths in runs for s in lengths]
    cells.append((LM_ARCH, None, TRAIN_B, TRAIN_S, "train"))
    for arch, depth, b, s, kind in cells:
        cfg = (family_config(arch, depth) if kind == "prefill"
               else get_config(arch))
        model = build_model(cfg, "meta")
        params = model.init(torch.Generator())
        shape = ShapeConfig(f"{kind}_{s}", s, b, kind)
        mf = roofline.model_flops(arch, shape.name, cfg=cfg, shape=shape)
        own = (prefill_bound(model, params, b, s)[1] if kind == "prefill"
               else train_bound(model, params, b, s)[1])
        rows[f"{arch}/{kind}/B{b}xS{s}"] = {
            "model_flops": mf, "chip_smoke_flops": own, "ratio": mf / own}
    log("lm_mesh (e) roofline.model_flops against this script's bounds "
        "(prefill_bound, train_bound), which stay as they are: model_flops "
        "counts 2 (train: 6) x every parameter a token uses, the embedding "
        "table included, at every position (so the unembedding of all S "
        "positions), and s^2/2 causal pairs a full layer; prefill_bound "
        "counts the non-embedding parameters, the last position's "
        "unembedding and s(s+1)/2 live pairs, train_bound 6 x d x V a "
        "token for the unembedding and s(s+1)/2 pairs: " + json.dumps(rows))
    return rows


MESH_RANK_TIMEOUT = 600  # (f) and (g): seconds for their process
MESH_DECODE_CELL = ("command-r-35b", "decode_32k")  # (g)
MESH_SSD_CELL = ("zamba2-2.7b", "decode_32k")  # (h)
MESH_DECODE_REPS = 3  # (g), (h): timed steps after the measured one


def mesh_rank_run() -> int:
    """(f) and (g)'s process (``python3 chip_smoke.py --mesh-rank``): rank
    0 of :data:`DRYRUN_CELL` on the (16, 16) plan over a ``fake`` world of
    256 ranks, with real CUDA tensors holding its blocks of the parameters
    and moments and its block of the batch (seeded, values not checked):
    one train step as the dry run traces it (``microbatches`` its
    default, remat full, donated, sequence parallel over 'model'); then
    (g), :func:`mesh_decode_rank`.  Prints one JSON line: the card's
    ``max_memory_allocated`` over the step, the arguments' bytes, the
    step's seconds, (g)'s row under ``decode`` and (h)'s under
    ``ssd_decode``.  The fake group moves no bytes: its collectives leave
    their outputs as the allocator gave them."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, TrainConfig, get_config
    from repro_torch.distributed.sharding import (_axis_size, _map,
                                                  batch_pspec,
                                                  param_shardings)
    from repro_torch.launch.dryrun import _default_microbatches, _nbytes
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.specs import state_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    arch, shape_name = DRYRUN_CELL
    shape, cfg = SHAPES[shape_name], get_config(arch)
    mesh = make_fake_mesh((16, 16), ("data", "model"))
    try:
        model = build_model(cfg, "cuda").set_mesh(mesh)
        params_g, _, axes = state_specs(model)
        plan = param_shardings(axes, params_g, mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = _map(lambda t: (torch.randn(
            t.shape, generator=gen, device="cuda") * 0.02).to(t.dtype),
            state_specs(model, mesh)[0])
        opt = adamw_init(params)
        spec = batch_pspec(shape.global_batch, mesh)
        rows = shape.global_batch // _axis_size(mesh, spec[0])
        batch = {k: torch.randint(0, cfg.vocab, (rows, shape.seq_len),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        mb = _default_microbatches(arch, shape_name)
        step = make_train_step(model, TrainConfig(microbatches=mb,
                                                  remat="full"),
                               param_shardings=plan, donate=True)
        args = _nbytes((params, opt, batch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        row = {"max_memory_allocated": torch.cuda.max_memory_allocated(),
               "argument_bytes": args, "microbatches": mb, "rows": rows,
               "seconds": time.perf_counter() - t0}
        del params, opt, batch, step
        gc_cuda(torch)
        row["decode"] = mesh_decode_rank(mesh, torch)
        gc_cuda(torch)
        row["ssd_decode"] = mesh_decode_rank(mesh, torch, cell=MESH_SSD_CELL)
        print(json.dumps(row))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_decode_rank(mesh, torch, dev="cuda", cfg=None,
                     cell=MESH_DECODE_CELL) -> dict:
    """(g): rank 0 of :data:`MESH_DECODE_CELL` (command-r-35b x
    decode_32k; (h): :data:`MESH_SSD_CELL`, zamba2-2.7b x decode_32k) on
    ``mesh``'s plan (the (16, 16) ``fake`` world) at full width (``cfg``:
    another configuration, for rehearsals), with real tensors: its blocks
    of the serving layout's parameters (``fsdp=False, moe_2d=True``) and
    of a full cache seeded in the plan's layout (``cache_pspecs``: the
    batch over 'data', the head_dim over 'model' (command-r's attention,
    zamba2's SSM states; zamba2's attention: its kv heads), every slot but
    the last holding its position), and its 8 rows of tokens.  One decode
    step at position ``seq_len - 1``, as the dry run traces it, its
    collectives recorded (``dryrun.collective_counts``):
    ``max_memory_allocated`` over it, then :data:`MESH_DECODE_REPS` more
    timed with CUDA events (compute only: the fake group's collectives
    move nothing).  (g): B5 must not launch: the plan splits the cache's
    head_dim over 'model' (8 kv heads do not divide 16), so each rank
    attends over its head_dim block (``attention._attend_blocks``), by
    design, where B5 needs whole head dims.  (h): B5 launches once a
    shared attention layer (the rank's 2 of 32 kv heads, whole head
    dims); each mamba2 layer runs on the rank's 5 of 80 heads."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import (
        _axis_size, _map, _names, batch_pspec, block_shape, cache_pspecs,
        param_shardings)
    from repro_torch.kernels import decode_attn as tda
    from repro_torch.launch.dryrun import _nbytes
    from repro_torch.launch.specs import cache_specs, state_specs
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import build_model

    from repro_torch.launch.dryrun import collective_counts

    arch, shape_name = cell
    shape, cfg = SHAPES[shape_name], cfg or get_config(arch)
    serve = dict(fsdp=False, moe_2d=True)
    model = build_model(cfg, dev).set_mesh(mesh)
    params_g, _, axes = state_specs(model)
    plan = param_shardings(axes, params_g, mesh, **serve)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = _map(lambda t: (torch.randn(
        t.shape, generator=gen, device=dev) * 0.02).to(t.dtype),
        state_specs(model, mesh, **serve)[0])
    cache_s = cache_specs(model, shape)
    c_specs = cache_pspecs(cache_s, mesh, shape.global_batch)
    t = shape.seq_len

    def seeded(leaf, spec):
        sh = block_shape(leaf.shape, spec, mesh)
        if leaf.dtype == torch.int32:  # slot i holds position i; last free
            pos = torch.arange(t, dtype=torch.int32, device=dev)
            pos[-1] = -1
            return pos.expand(sh).contiguous()
        return (torch.randn(sh, generator=gen, device=dev)).to(leaf.dtype)

    layers = _map(seeded, cache_s["layers"], c_specs["layers"])
    held = c_specs["layers"][0]
    held = tuple(held["ssm"].state if isinstance(held, dict) else held.k)
    spec = batch_pspec(shape.global_batch, mesh)
    baxes = _names(spec[0])
    rows = shape.global_batch // _axis_size(mesh, baxes)
    tokens = torch.randint(0, cfg.vocab, (rows, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    step = make_decode_step(model, param_shardings=plan,
                            cache_shardings=c_specs, batch_axes=baxes)
    args = _nbytes((params, layers, tokens))
    b5 = tda.launches[B5]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with collective_counts(mesh) as coll:
        step(params, {"layers": layers, "len": t - 1}, tokens)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = tda.launches[B5] - b5
    ms = cuda_ms(lambda: step(params, {"layers": layers, "len": t - 1},
                              tokens), MESH_DECODE_REPS, warmup=0)
    attn = sum(isinstance(c, dict) and "attn" in c for c in layers)
    if cell == MESH_DECODE_CELL and launched:
        raise AssertionError(f"lm_mesh (g): B5 launched {launched} times "
                             f"over a cache held as {held}")
    if cell == MESH_SSD_CELL and launched != attn:
        raise AssertionError(f"lm_mesh (h): B5 launched {launched} times "
                             f"in a step of {attn} attention layers")
    return {"max_memory_allocated": peak, "argument_bytes": args,
            "rows": rows, "held": str(held), "b5_launches": launched,
            "ms_compute_only": ms, "layers": cfg.n_layers,
            "model_ops": coll["by_dim"].get("model", {}).get("ops", {}),
            "data_ops": coll["by_dim"].get("data", {}).get("ops", {})}


def mesh_rank(torch, smi, cell, dcell, scell) -> dict:
    """(f), (g) and (h): :func:`mesh_rank_run` in a process of its own (a
    process holds one process group: lm_mesh's NCCL one is up here), each
    peak against the dry run's fake-tensor peak of the same cell
    (``cell``: lm_dryrun's trace, ``dcell``: :data:`MESH_DECODE_CELL`'s,
    ``scell``: :data:`MESH_SSD_CELL`'s, all :func:`dryrun_cell_start`):
    within DRYRUN_MEM_BAND, and under the card's memory."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--mesh-rank"], capture_output=True, text=True,
                       timeout=MESH_RANK_TIMEOUT, cwd=str(ROOT))
    if r.returncode != 0:
        raise AssertionError(f"lm_mesh (f): the rank's step failed (rc "
                             f"{r.returncode}): {r.stderr[-4000:]}")
    row = json.loads(r.stdout.strip().splitlines()[-1])
    row["decode"] = mesh_decode_check(row["decode"], dcell, smi)
    row["ssd_decode"] = mesh_ssd_check(row["ssd_decode"], scell, smi)
    rec = dryrun_cell_end(cell, timeout=600)
    fake = rec["memory"]["peak_bytes"]
    if rec["memory"]["argument_size_in_bytes"] != row["argument_bytes"]:
        raise AssertionError(f"lm_mesh (f): the rank holds "
                             f"{row['argument_bytes']} bytes of arguments, "
                             f"the dry run traced "
                             f"{rec['memory']['argument_size_in_bytes']}")
    card = torch.cuda.get_device_properties(0).total_memory
    ratio = row["max_memory_allocated"] / fake
    row.update(fake_peak_bytes=fake, ratio=ratio, card_bytes=card,
               wall_s=time.perf_counter() - t0)
    log(f"lm_mesh (f) {DRYRUN_CELL[0]} x {DRYRUN_CELL[1]}, rank 0 of the "
        f"(16, 16) plan on a fake 256-rank group with real CUDA tensors "
        f"({row['rows']} rows, {row['microbatches']} microbatches, remat "
        f"full): max_memory_allocated {row['max_memory_allocated']} bytes "
        f"against the dry run's fake-tensor peak {fake} ({ratio:.4f}); "
        f"arguments {row['argument_bytes']} bytes (the plan's); the step "
        f"{row['seconds']:.2f} s, values not checked; {smi}")
    if abs(ratio - 1.0) > DRYRUN_MEM_BAND or row["max_memory_allocated"] \
            >= card:
        raise AssertionError(f"lm_mesh (f): peak {ratio:.4f} of the dry "
                             f"run's (band {DRYRUN_MEM_BAND}), card {card}")
    return row


def mesh_decode_check(row, dcell, smi) -> dict:
    """(g)'s row against the dry run's record of the same cell: the same
    arguments, the peak within DRYRUN_MEM_BAND."""
    rec = dryrun_cell_end(dcell, timeout=600, cell=MESH_DECODE_CELL)
    fake = rec["memory"]["peak_bytes"]
    if rec["memory"]["argument_size_in_bytes"] != row["argument_bytes"]:
        raise AssertionError(f"lm_mesh (g): the rank holds "
                             f"{row['argument_bytes']} bytes of arguments, "
                             f"the dry run traced "
                             f"{rec['memory']['argument_size_in_bytes']}")
    ratio = row["max_memory_allocated"] / fake
    row.update(fake_peak_bytes=fake, ratio=ratio)
    log(f"lm_mesh (g) {MESH_DECODE_CELL[0]} x {MESH_DECODE_CELL[1]}, rank 0 "
        f"of the (16, 16) plan's serving layout on the fake 256-rank group "
        f"with real CUDA tensors ({row['rows']} rows, the cache held as "
        f"{row['held']}, seeded): one decode step, max_memory_allocated "
        f"{row['max_memory_allocated']} bytes against the dry run's "
        f"fake-tensor peak {fake} ({ratio:.4f}); arguments "
        f"{row['argument_bytes']} bytes (the plan's); B5 launched "
        f"{row['b5_launches']} times, by design: the cache's head_dim is "
        f"split over 'model' (its 8 kv heads do not divide 16), so the rank "
        f"attends over its head_dim block with the reference's f32 scores "
        f"summed over 'model' (attention._attend_blocks), where B5 needs "
        f"whole head dims; {row['ms_compute_only']:.3f} ms a step, compute "
        f"only (the fake group moves no bytes; CUDA events, "
        f"{MESH_DECODE_REPS} steps); {smi}")
    if abs(ratio - 1.0) > DRYRUN_MEM_BAND:
        raise AssertionError(f"lm_mesh (g): peak {ratio:.4f} of the dry "
                             f"run's (band {DRYRUN_MEM_BAND})")
    return row


def mesh_ssd_check(row, scell, smi) -> dict:
    """(h)'s row against the dry run's record of :data:`MESH_SSD_CELL`:
    the same arguments and the same collectives over 'model' and 'data'
    (the rank's step and the trace run one code path), the peak within
    DRYRUN_MEM_BAND; and no SSM state gathered whole over 'model': the
    all-gathers there carry less than the layers' state blocks (each
    layer moves its state block to its heads and back by all-to-alls)."""
    rec = dryrun_cell_end(scell, timeout=600, cell=MESH_SSD_CELL)
    fake = rec["memory"]["peak_bytes"]
    if rec["memory"]["argument_size_in_bytes"] != row["argument_bytes"]:
        raise AssertionError(f"lm_mesh (h): the rank holds "
                             f"{row['argument_bytes']} bytes of arguments, "
                             f"the dry run traced "
                             f"{rec['memory']['argument_size_in_bytes']}")
    dims = rec["collectives"]["by_dim"]
    for dim, ops in (("model", row["model_ops"]), ("data", row["data_ops"])):
        want = dims.get(dim, {}).get("ops", {})
        if ops != want:
            raise AssertionError(f"lm_mesh (h): collectives over {dim!r} "
                                 f"{ops}, the dry run's {want}")
    from repro_torch.configs import SHAPES, get_config

    cfg, shape = get_config(MESH_SSD_CELL[0]), SHAPES[MESH_SSD_CELL[1]]
    state = (row["rows"] * cfg.ssm_heads * cfg.d_inner // cfg.ssm_heads
             * cfg.ssm_state * 4 // 16)  # a rank's f32 block of a layer's
    gathered = row["model_ops"].get("all-gather", {}).get("bytes", 0)
    moved = row["model_ops"].get("all-to-all", {}).get("bytes", 0)
    if gathered >= row["layers"] * state:
        raise AssertionError(f"lm_mesh (h): all-gathers over 'model' carry "
                             f"{gathered} bytes, not below the layers' "
                             f"state blocks ({row['layers']} x {state})")
    ratio = row["max_memory_allocated"] / fake
    row.update(fake_peak_bytes=fake, ratio=ratio, state_block_bytes=state)
    log(f"lm_mesh (h) {MESH_SSD_CELL[0]} x {MESH_SSD_CELL[1]}, rank 0 of "
        f"the (16, 16) plan's serving layout on the fake 256-rank group "
        f"with real CUDA tensors ({row['rows']} rows of "
        f"{shape.global_batch}, the SSM state held as {row['held']}, "
        f"seeded): one decode step, each mamba2 layer on the rank's "
        f"{cfg.ssm_heads // 16} of {cfg.ssm_heads} heads; "
        f"max_memory_allocated {row['max_memory_allocated']} bytes against "
        f"the dry run's fake-tensor peak {fake} ({ratio:.4f}); arguments "
        f"{row['argument_bytes']} bytes (the plan's); collectives over "
        f"'model' and 'data' the dry run's: all-to-all "
        f"{moved} bytes (the in_proj and conv columns, the states there and "
        f"back), all-gather {gathered} bytes (conv histories, the new "
        f"token's x, the argmax) against {row['layers']} state blocks of "
        f"{state}: no state gathered whole; B5 launched "
        f"{row['b5_launches']} times (the shared attention layers); "
        f"{row['ms_compute_only']:.3f} ms a step, compute only (CUDA "
        f"events, {MESH_DECODE_REPS} steps); {smi}")
    if abs(ratio - 1.0) > DRYRUN_MEM_BAND:
        raise AssertionError(f"lm_mesh (h): peak {ratio:.4f} of the dry "
                             f"run's (band {DRYRUN_MEM_BAND})")
    return row


MESH_SSD_ARCH = "mamba2-370m"  # (h) on one rank, at full width
MESH_SSD_SHAPE = (2, 512, 4)  # B, S (train and prefill), decode steps


def mesh_ssd(mesh, torch, dev, cfg, smi) -> dict:
    """(h) on the one-rank mesh: mamba2's planned train step (one step
    from one state and batch) and planned prefill + decode steps (the
    cache held as ``cache_pspecs`` lays it out) bit-equal to the unplanned
    ones: with one rank over 'model' the mixer runs whole."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenStream, sharded_batches
    from repro_torch.distributed.sharding import (
        batch_pspec, cache_pspecs, gather_params, param_shardings,
        shard_params)
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    b, s, steps = MESH_SSD_SHAPE
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params0 = model.init(torch.Generator(device=dev).manual_seed(0))
    axes = model.logical_axes()
    plan = param_shardings(axes, params0, mesh)
    stream = TokenStream(vocab=cfg.vocab, seq_len=s, global_batch=b)
    first = next(sharded_batches(stream, mesh, batch_pspec(b, mesh)))
    tc = TrainConfig()
    p_a, _, m_a = make_train_step(model, tc)(
        _clone_tree(params0, torch), adamw_init(params0), first)
    blocks = shard_params(_clone_tree(params0, torch), plan)
    p_b, _, m_b = make_train_step(model, tc, param_shardings=plan)(
        blocks, adamw_init(blocks), first)
    for key in ("loss", "grad_norm"):
        if not torch.equal(m_a[key], m_b[key]):
            raise AssertionError(f"lm_mesh (h): {key} {float(m_b[key])} "
                                 f"with the plan, {float(m_a[key])} without")
    if not all(torch.equal(x, y) for x, y in zip(
            _leaves(p_a), _leaves(gather_params(p_b, plan)))):
        raise AssertionError("lm_mesh (h): mamba2's updated parameters "
                             "differ from the step's without a plan")
    del p_a, p_b, blocks
    gc_cuda(torch)
    toks = torch.randint(1, cfg.vocab, (b, s + steps), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
    cplan = cache_pspecs(build_model(cfg, "meta").init_cache(b, s + steps),
                         mesh, b)
    dplan = param_shardings(axes, params0, mesh, fsdp=False, moe_2d=True)
    lg_a, c_a = model.prefill(params0, {"tokens": toks[:, :s]},
                              max_len=s + steps)
    lg_b, c_b = make_prefill_step(model, param_shardings=plan,
                                  cache_shardings=cplan, max_len=s + steps)(
        shard_params(params0, plan), {"tokens": toks[:, :s]})
    same = [torch.equal(lg_a, lg_b)]
    dec = make_decode_step(model, param_shardings=dplan,
                           cache_shardings=cplan)
    dblocks = shard_params(params0, dplan)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        lg_a, c_a = model.decode_step(params0, c_a, tok)
        _, lg_b, c_b = dec(dblocks, c_b, tok)
        same.append(torch.equal(lg_a, lg_b))
    if not all(same):
        raise AssertionError(f"lm_mesh (h): mamba2's planned prefill and "
                             f"decode logits against the unplanned: {same}")
    row = {"loss": float(m_b["loss"]), "grad_norm": float(m_b["grad_norm"]),
           "logits_equal": len(same), "seconds": time.perf_counter() - t0}
    log(f"lm_mesh (h) {cfg.name} at full width on the one-rank mesh: the "
        f"planned train step (B={b}, S={s}; loss {row['loss']:.6f}, grad "
        f"norm {row['grad_norm']:.6f}, every updated parameter) and the "
        f"planned prefill + {steps} decode steps ({len(same)} logits) "
        f"bit-equal to the unplanned ones; {row['seconds']:.1f} s; {smi}")
    del model, params0, dblocks, c_a, c_b
    gc_cuda(torch)
    return row


def phase_lm_mesh(torch, smi, dev="cuda", moe_cfg=None,
                  train_cfg=None, cell=None, dcell=None, scell=None,
                  ssd_cfg=None) -> tuple:
    """The multi-card layer on a one-rank NCCL mesh (``make_local_mesh(1,
    1)``, its ``file://`` store under ``build/``): (a) qwen3-moe's serving
    path through the planned steps and ``moe_ffn_ep``, (b) the blocked
    train step with a plan, (c) ``compressed_psum``, (d) the meta-device
    specs, (e) roofline FLOP counts, (h) mamba2's planned steps; then
    (f) one rank of the (16, 16) plan's train step, (g) one of its decode
    step and (h) one of zamba2's decode step with real allocations
    (``cell``, ``dcell``, ``scell``: the dry run's traces of the same
    cells; None skips them, for rehearsals).  The group is destroyed at the
    end, whatever happens.  Returns (B5 launches of (a)'s meshed decode,
    rows)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    moe_cfg = moe_cfg or family_config(MESH_ARCH, MESH_DEPTH)
    train_cfg = train_cfg or get_config(LM_ARCH)
    mesh = make_local_mesh(1, 1, device=dev, init_file=str(MESH_STORE))
    try:
        log(f"lm_mesh: a one-rank {dist.get_backend()} group, mesh "
            f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} on {smi}")
        rows = {"moe": mesh_moe(mesh, torch, dev, moe_cfg, smi),
                "train": mesh_train(mesh, torch, dev, train_cfg, smi),
                "specs": mesh_specs(torch, dev),
                "roofline": mesh_roofline(torch),
                "ssd": mesh_ssd(mesh, torch, dev,
                                ssd_cfg or get_config(MESH_SSD_ARCH), smi)}
    finally:
        dist.destroy_process_group()
        MESH_STORE.unlink(missing_ok=True)
    if cell is not None:
        gc_cuda(torch)
        rows["rank"] = mesh_rank(torch, smi, cell, dcell, scell)
    rows["seconds"] = time.perf_counter() - t_phase
    log(f"lm_mesh took {rows['seconds']:.1f} s")
    return rows["moe"]["b5_launches"], rows


# ------------------------------------------------------ LM dry-run phase
DRYRUN_OUT = ROOT / "build" / "dryrun"  # git-ignored
DRYRUN_CELL = ("gemma-2b", "train_4k")  # traced at full size beside (a)-(d)
DRYRUN_MEM_BAND = 0.15  # the fake-tensor peak against the card's, relative
DRYRUN_DECODE = (4, 1024)  # lm_serve's batch and max_len


def dryrun_cell_start(cell=DRYRUN_CELL):
    """``python -m repro_torch.launch.dryrun`` on ``cell`` (the (16, 16)
    mesh), on the CPU in a subprocess with no card visible, started with
    the LM phases so that it runs beside them (it is killed at exit if it
    still runs); its output goes to ``build/dryrun/``."""
    import atexit
    import os

    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    arch, shape = cell
    (DRYRUN_OUT / f"{arch}__{shape}__pod.json").unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(DRYRUN_OUT / f"{arch}__{shape}.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod", "--out",
             str(DRYRUN_OUT)], stdout=out, stderr=subprocess.STDOUT,
            env=env)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def dryrun_cell_end(proc, timeout: float, cell=DRYRUN_CELL) -> dict:
    """Wait for :func:`dryrun_cell_start`'s process on ``cell`` (killed
    past ``timeout`` seconds) and return its record; raises unless it is
    ok."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"lm_dryrun: the {cell} dry run took "
                             f"more than {timeout} s")
    arch, shape = cell
    path = DRYRUN_OUT / f"{arch}__{shape}__pod.json"
    rec = json.loads(path.read_text()) if path.exists() else {}
    out = (DRYRUN_OUT / f"{arch}__{shape}.log").read_text()
    if proc.returncode != 0 or rec.get("status") != "ok":
        raise AssertionError(f"lm_dryrun: the {cell} dry run failed "
                             f"(rc {proc.returncode}): {out[-4000:]}")
    log(f"lm_dryrun (e) {out.strip().splitlines()[-1]}")
    return rec


def _flops_of(fn, torch) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    torch.cuda.synchronize()
    return counter.get_total_flops(), out


def _same_flops(label: str, card: int, probe: float) -> None:
    if card != int(probe):
        raise AssertionError(f"lm_dryrun {label}: FlopCounterMode counted "
                             f"{card} FLOP on the card, the probe {probe:.0f}")


def dryrun_train(model, params, cfg, dev, torch) -> dict:
    """(a) the fake-tensor trace of the train step at lm_train's shape on
    the card's device (``dryrun.trace_step(device=dev)``), then the real
    step from the same state: its FLOPs equal the probe's, its peak within
    DRYRUN_MEM_BAND of the trace's."""
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.patch_probe import probe_cell
    from repro_torch.launch.specs import input_specs, state_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    shape = ShapeConfig("train_1k", TRAIN_S, TRAIN_B, "train")
    probe = probe_cell(cfg.name, shape.name, cfg=cfg, shape=shape)
    p_s, o_s, _ = state_specs(build_model(cfg, "meta"))
    step = make_train_step(model, TrainConfig(remat="full"), donate=True)
    est = dryrun.trace_step(step, (p_s, o_s, input_specs(cfg, shape)),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {k: torch.randint(1, cfg.vocab, (TRAIN_B, TRAIN_S),
                              generator=gen, device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    params = _clone_tree(params, torch)
    opt = adamw_init(params)
    gc_cuda(torch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    args = sum(t.numel() * t.element_size()
               for tree in (params, opt, batch) for t in _leaves(tree))
    torch.cuda.reset_peak_memory_stats()
    flops, (params, opt, m) = _flops_of(lambda: step(params, opt, batch),
                                        torch)
    peak = torch.cuda.max_memory_allocated() - held + args
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"lm_dryrun (a): loss {float(m['loss'])}")
    _same_flops("(a) train", flops, probe["flops"])
    ratio = est["memory"]["peak_bytes"] / peak
    log(f"lm_dryrun (a) {cfg.name} train B={TRAIN_B} S={TRAIN_S} "
        f"remat=full: FlopCounterMode on the card {flops} = probe "
        f"{probe['flops']:.0f} (probe {probe['probe_s']} s on the meta "
        f"device); peak {peak / 1e9:.3f} GB on the card (max_memory_"
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB less "
        f"{(held - args) / 1e9:.3f} GB held besides the step's arguments), "
        f"fake-tensor estimate {est['memory']['peak_bytes'] / 1e9:.3f} GB "
        f"(arguments {est['memory']['argument_size_in_bytes'] / 1e9:.3f}, "
        f"trace {est['seconds']:.1f} s): estimate / card {ratio:.4f}")
    if abs(ratio - 1) > DRYRUN_MEM_BAND:
        raise AssertionError(f"lm_dryrun (a): the memory estimate is "
                             f"{ratio:.4f} of the card's peak")
    del params, opt, m, batch
    gc_cuda(torch)
    return dict(flops=flops, probe_flops=probe["flops"], peak_bytes=peak,
                estimate_bytes=est["memory"]["peak_bytes"], ratio=ratio,
                trace_s=est["seconds"], probe_s=probe["probe_s"])


def dryrun_b5(dev, torch) -> dict:
    """(d) B5's operator against its plain version at lm_kernel's serve
    shape (two launches bit-equal), and ms a call of the wrapper
    (``decode_attention``, which with no dispatch mode launches the
    operator's CUDA kernel directly) against a call through the operator
    (18 copies taken in turn, as lm_time's (a); A B B A)."""
    from repro_torch.kernels import decode_attn as tda

    bf16 = torch.bfloat16
    q, k, v, pos, cur = _attn_case(dev, torch, 4, 1, 8, 256, 1024, bf16,
                                   (1, 200, 700, 1024), seed=300)
    bt = tda.block_size(1024)
    qg = q.reshape(4, 1, 8, 256)
    got = torch.ops.repro_torch.decode_attn(qg, k, v, pos, cur, 0, bt)
    again = torch.ops.repro_torch.decode_attn(qg, k, v, pos, cur, 0, bt)
    want = tda.decode_attention_plain(q, k, v, pos, cur).reshape(4, 1, 8, 256)
    torch.testing.assert_close(got, want, atol=LM_ATOL, rtol=LM_RTOL)
    if not torch.equal(got, again):
        raise AssertionError("lm_dryrun (d): two launches of the operator "
                             "differ")
    err = float((got - want).abs().max())
    sets = [_attn_case(dev, torch, 4, 1, 8, 256, 1024, bf16, (1024,) * 4,
                       seed=400 + i) for i in range(18)]
    turn = [0]

    def direct():
        turn[0] += 1
        return tda.decode_attention(*sets[turn[0] % len(sets)])

    def through_op():
        turn[0] += 1
        q, k, v, pos, cur = sets[turn[0] % len(sets)]
        out = torch.ops.repro_torch.decode_attn(q.reshape(4, 1, 8, 256), k,
                                                v, pos, cur, 0, bt)
        return out.reshape(4, 8, 256)

    times = {}
    for name, fn in (("direct", direct), ("op", through_op),
                     ("op2", through_op), ("direct2", direct)):
        times[name] = cuda_ms(fn, reps=200, warmup=5)
    op_ms = (times["op"] + times["op2"]) / 2
    direct_ms = (times["direct"] + times["direct2"]) / 2
    log(f"lm_dryrun (d) B5 operator against its plain version at B=4 KV=1 "
        f"G=8 hd=256 T=1024: max_abs_err={err:.3g}, two launches "
        f"bit-equal; ms a call through the operator {op_ms:.5f} against "
        f"the wrapper's direct launch {direct_ms:.5f} (A B B A: "
        f"{json.dumps(times)})")
    return dict(err=err, op_ms=op_ms, direct_ms=direct_ms, order=times)


def phase_lm_dryrun(torch, smi, cell, dev="cuda", cfg=None) -> tuple:
    """The dry run's counts against real steps on one card: (a) the train
    step at lm_train's shape, (b) prefill at B=4, S=1,024 (the chunked
    path), (c) the decode step at lm_serve's shape through B5, each
    counted by ``FlopCounterMode`` on the card and equal to
    ``patch_probe.probe_cell``'s count on the meta device; (a) also holds
    the fake-tensor memory estimate against the card's peak; (d) B5's
    operator; (e) the full-size dry run of one cell, ``cell``
    (:func:`dryrun_cell_start`'s process, on the CPU beside the LM
    phases).  Returns (B5 launches of (c), rows)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import decode_attn as tda
    from repro_torch.launch.patch_probe import probe_cell
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    try:
        cfg = cfg or get_config(LM_ARCH)
        props = torch.cuda.get_device_properties(0)
        log(f"lm_dryrun: {props.name} total_memory {props.total_memory} "
            f"bytes ({props.total_memory / 2**30:.3f} GiB) on {smi}")
        rows = {"total_memory": props.total_memory}
        model = build_model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        rows["train"] = dryrun_train(model, params, cfg, dev, torch)

        gen = torch.Generator(device=dev).manual_seed(6)
        shape = ShapeConfig("prefill_1k", 1024, 4, "prefill")
        probe = probe_cell(cfg.name, shape.name, cfg=cfg, shape=shape)
        tokens = torch.randint(1, cfg.vocab, (4, 1024), generator=gen,
                               device=dev, dtype=torch.int32)
        prefill = make_prefill_step(model)
        flops, _ = _flops_of(lambda: prefill(params, {"tokens": tokens}),
                             torch)
        _same_flops("(b) prefill", flops, probe["flops"])
        log(f"lm_dryrun (b) {cfg.name} prefill B=4 S=1024 (the chunked "
            f"path): FlopCounterMode on the card {flops} = probe "
            f"{probe['flops']:.0f}")
        rows["prefill"] = dict(flops=flops, probe_flops=probe["flops"])

        b, max_len = DRYRUN_DECODE
        shape = ShapeConfig("decode_1k", max_len, b, "decode")
        probe = probe_cell(cfg.name, shape.name, cfg=cfg, shape=shape)
        cache = model.init_cache(b, max_len)
        cache["len"] = max_len - 1  # the probe's position: a full cache
        toks = torch.randint(1, cfg.vocab, (b, 1), generator=gen, device=dev,
                             dtype=torch.int32)
        decode = make_decode_step(model)
        tda.reset_launches()
        flops, (nxt, logits, _) = _flops_of(
            lambda: decode(params, cache, toks), torch)
        launches = tda.launches[B5]
        _same_flops("(c) decode", flops, probe["flops"])
        if launches != cfg.n_layers:
            raise AssertionError(f"lm_dryrun (c): B5 launched {launches} "
                                 f"times, not {cfg.n_layers}")
        if not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
            raise AssertionError("lm_dryrun (c): logits not finite")
        log(f"lm_dryrun (c) {cfg.name} decode step B={b} max_len={max_len} "
            f"at position {max_len - 1}: FlopCounterMode on the card "
            f"{flops} = the fake trace's {probe['flops']:.0f} (B5 through "
            f"its FLOP formula), B5 launched {launches} times")
        rows["decode"] = dict(flops=flops, probe_flops=probe["flops"],
                              b5_launches=launches)
        del params, cache, model, logits, nxt
        gc_cuda(torch)
        rows["b5"] = dryrun_b5(dev, torch)
        gc_cuda(torch)
        rec = dryrun_cell_end(cell, timeout=600)
    finally:
        if cell.poll() is None:
            cell.kill()
            cell.wait()
    rows["cell"] = {k: rec[k] for k in ("lower_s", "memory", "cost",
                                        "microbatches")}
    rows["cell"]["probe_s"] = rec["probe"]["probe_s"]
    rows["seconds"] = time.perf_counter() - t_phase
    r = rows["train"]
    log(f"lm_dryrun ratios: (a) FLOPs card / probe "
        f"{r['flops'] / r['probe_flops']:.6f}, memory estimate / card "
        f"{r['ratio']:.4f}; (b) "
        f"{rows['prefill']['flops'] / rows['prefill']['probe_flops']:.6f}; "
        f"(c) {rows['decode']['flops'] / rows['decode']['probe_flops']:.6f}"
        f"; (e) {'x'.join(DRYRUN_CELL)} pod traced in {rec['lower_s']} s, "
        f"probed in {rec['probe']['probe_s']} s")
    log(f"lm_dryrun took {rows['seconds']:.1f} s")
    return rows["decode"]["b5_launches"], rows


def phase_lm_profile(model, params, torch, steps=PROFILE_STEPS,
                     batch=4, max_len=1024):
    """Device time and idle share over ``steps`` decode steps of the
    full-width serve loop: its decode step, on a cache that has wrapped (as
    the serve phase's is after its first 1,024 steps), so every block is
    live."""
    import numpy as np

    from repro_torch.launch.steps import make_decode_step

    decode = make_decode_step(model)
    cache = model.init_cache(batch, max_len)
    cache["len"] = last = max_len + 100
    for c in cache["layers"]:  # slot s holds the newest p with p % T == s
        slots = torch.arange(c.pos.shape[1], device=model.device)
        c.pos.copy_((last - 1 - (last - 1 - slots) % c.pos.shape[1])
                    .expand_as(c.pos))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        1, model.cfg.vocab, (steps, batch, 1)), device=model.device)

    def run():
        nonlocal cache
        for s in range(steps):
            nxt, _, cache = decode(params, cache, toks[s])
        return nxt.cpu()

    run()  # warm
    out = phase_profile(((f"lm_serve/{steps}_decode_steps", run),), torch)
    return next(iter(out.values()))


# ------------------------------------------------------------ the examples
EXAMPLES = ROOT / "examples_torch"
EXAMPLE_SCALE = 16  # graph_analytics: rmat(16, edge_factor=8, symmetrize)
EXAMPLE_CKPT = ROOT / "build" / "examples" / "ckpt"  # git-ignored
EXAMPLE_GRAPH_CALLS = ("run", "bfs", "pagerank", "coreness", "memory_report")


def run_example(name: str, argv, torch, smi, target=None, names=(),
                method=True):
    """A twin's ``main(argv)`` on the card, with ``target.<name>`` for each
    of ``names`` recorded (``tests/example_recording.py``'s ``Recorded``,
    which the twins' CPU tests use; ``target`` None: the twin's module);
    fails unless it exits 0.  Returns (calls, wall s)."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from example_recording import Recorded, load_example

    mod = load_example(name)
    with Recorded(mod if target is None else target, names, method) as rec:
        t0 = time.perf_counter()
        rc = mod.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"examples_torch/{name}.py {' '.join(argv)}: "
                             f"exit {rc}")
    log(f"examples {name} {' '.join(argv)}: exit 0, wall {wall:.3f} s "
        f"({smi})")
    return rec.calls, wall


def check_pagerank_oracle(label, res, g, damping=0.85, tol=1e-3) -> None:
    """Ranks finite and within tol / (1 - damping) in L1 of a numpy power
    iteration (phase 10's bound)."""
    import numpy as np

    vals = res.values.double().cpu().numpy()
    l1 = float(np.abs(vals - numpy_pagerank(g, damping)).sum())
    if not np.isfinite(vals).all() or l1 > tol / (1 - damping):
        raise AssertionError(f"{label}: L1 error {l1} vs numpy")


def phase_examples(torch, smi, dev="cuda"):
    """The six twins of ``examples/`` on the card, through their ``main``
    (see the module docstring).  Returns B5's launches and the phase's
    rows."""
    import numpy as np

    import repro_torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import decode_attn as tda
    from repro_torch.kernels.spmv import kernel as K

    card = ["--device", dev]
    graph = (repro_torch.Graph, EXAMPLE_GRAPH_CALLS)
    rows = {}
    K.reset_launches()

    calls, rows["custom_program"] = run_example("custom_program", card,
                                                torch, smi, *graph)
    (_, G, _, _, res), = calls
    if not np.array_equal(res.values.cpu().numpy(), numpy_wcc(G.host)):
        raise AssertionError("custom_program: labels differ from numpy")

    calls, rows["quickstart"] = run_example("quickstart", card, torch, smi,
                                            *graph)
    want = ["pagerank", "pagerank", "bfs", "coreness", "run", "pagerank",
            "memory_report", "memory_report", "pagerank"]
    if [c.name for c in calls] != want:
        raise AssertionError(f"quickstart calls {[c.name for c in calls]}")
    (_, g1, _, _, push), (_, _, _, _, pull), (_, _, _, _, bfs) = calls[:3]
    (_, gu, _, _, core), (_, _, _, _, wcc) = calls[3:5]
    for label, res in (("push", push), ("pull", pull)):
        check_pagerank_oracle(f"quickstart {label}", res, g1.host)
    if not np.array_equal(bfs.values.cpu().numpy(), numpy_bfs(g1.host, 0)):
        raise AssertionError("quickstart: BFS levels differ from numpy")
    kmax = int(numpy_coreness(gu.host).max())
    if int(core.values.max()) != kmax:
        raise AssertionError(f"quickstart: kmax {int(core.values.max())} "
                             f"against numpy's {kmax}")
    if not np.array_equal(wcc.values.cpu().numpy(), numpy_wcc(gu.host)):
        raise AssertionError("quickstart: WCC labels differ from numpy")
    if calls[6][4]["device_edge_total"] != 0:
        raise AssertionError("quickstart: the host session holds edges")
    log(f"examples quickstart: PageRank push and pull within the numpy "
        f"bound, BFS levels, kmax {kmax} and WCC labels equal numpy's; host "
        f"ranks bit-equal to the device run's (its own assert)")

    calls, rows["batched_queries"] = run_example("batched_queries", card,
                                                 torch, smi, *graph)
    (_, gb, _, kw, ppr) = calls[0]
    (_, _, (seeds,), _, multi) = calls[1 + 8]
    gh = gb.host
    one_hot = np.zeros((gh.n, len(seeds)))
    one_hot[seeds, np.arange(len(seeds))] = 1.0
    ref = numpy_ppr(gh, one_hot, 0.85)
    for q, s in enumerate(seeds):
        l1 = float(np.abs(ppr.values[:, q].double().cpu().numpy()
                          - ref[:, q]).sum())
        if l1 > 1e-3 / (1 - 0.85):
            raise AssertionError(f"batched_queries: PPR column {q} L1 {l1}")
        if not np.array_equal(multi.values[:, q].cpu().numpy(),
                              numpy_bfs(gh, s)):
            raise AssertionError(f"batched_queries: BFS column {q} differs")
    log("examples batched_queries: 8 PPR columns within the numpy bound, "
        "8 BFS columns equal numpy BFS")

    calls, rows["graph_analytics"] = run_example(
        "graph_analytics", ["--scale", str(EXAMPLE_SCALE)] + card, torch,
        smi, *graph)
    (_, ga, _, _, core), = [c for c in calls if c.name == "coreness"]
    kmax = int(numpy_coreness(ga.host).max())
    if int(core.values.max()) != kmax:
        raise AssertionError(f"graph_analytics: kmax {int(core.values.max())}"
                             f" against numpy's {kmax}")
    graph_launches = dict(K.launches)
    log(f"examples graph twins: B1-B4 launches {graph_launches} (their "
        f"policies pick scan and compact); graph_analytics n={ga.n} "
        f"m={ga.m}, kmax {kmax} equal numpy's")

    b5 = 0
    for argv in ([], ["--full"]):
        arch_cfg = (get_config if argv else get_smoke)("gemma3-4b")
        torch.cuda.reset_peak_memory_stats()
        tda.reset_launches()
        calls, wall = run_example("serve_lm", argv + card, torch, smi,
                                  names=("serve_batch",), method=False)
        launched = tda.launches[B5]
        (_, _, _, _, res), = calls
        steps = res["decode_steps"]
        if launched == 0 or launched != arch_cfg.n_layers * steps:
            raise AssertionError(f"serve_lm {argv}: B5 ran {launched} times,"
                                 f" not {arch_cfg.n_layers} x {steps}")
        b5 += launched
        name = "serve_lm" + (" --full" if argv else "")
        rows[name] = wall
        rows[f"{name} detail"] = dict(
            tokens=res["tokens"], decode_steps=steps,
            ms_per_step=res["seconds"] / steps * 1e3, b5_launches=launched,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"examples {name}: {res['tokens']} tokens, {steps} decode steps, "
            f"{rows[name + ' detail']['ms_per_step']:.3f} ms a step, B5 "
            f"{launched} launches ({arch_cfg.n_layers} layers x {steps}), "
            f"peak {rows[name + ' detail']['peak_gb']:.2f} GB ({smi})")
        del calls, res
        gc_cuda(torch)

    _, rows["train_lm"] = run_example(
        "train_lm", ["--ckpt", str(EXAMPLE_CKPT)] + card, torch, smi)
    return b5, {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in rows.items()}


def check_no_spill(lib: Path, kernel: str) -> None:
    """Fail if ptxas reports spill stores or loads for any instantiation of
    ``kernel`` in the build log of ``lib``."""
    import re

    entry = ""
    for line in Path(str(lib) + ".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "spill stores" in line and kernel in entry:
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                raise AssertionError(f"ptxas: {kernel} spills: {entry.strip()}"
                                     f" {line.strip()}")


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="chip smoke test of repro_torch")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the batched phase's reset matrix")
    ap.add_argument("--mesh-rank", action="store_true",
                    help="lm_mesh (f)'s process alone (mesh_rank_run)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.mesh_rank:
        return mesh_rank_run()
    import repro_torch
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels import decode_attn as tda
    from repro_torch.kernels.spmv import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        libs = list(pool.map(lambda build: build(),
                             (K.build_library, tda.build_library)))
    log(f"build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in Path(str(lib) + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"ptxas {lib.name.split('_')[0][3:]}: {line.strip()}")
    check_no_spill(libs[1], "decode_attn_ring")
    # B1-B4's passes by mangled name (every lane width), but the one-lane
    # B2/B4 pair kept as PR 15 wrote it (compact_windows1, _blocks1)
    for kernel in ("13spmv_segmentsI", "18spmv_segments_wideI",
                   "16combine_segmentsI", "12poison_tilesI",
                   "15compact_windowsI", "14compact_blocksI"):
        check_no_spill(libs[0], kernel)

    # The LM slice first, while the card holds nothing else; lm_dryrun's
    # full-size cell traces on the CPU meanwhile.
    cell = dryrun_cell_start()
    dcell = dryrun_cell_start(MESH_DECODE_CELL)
    scell = dryrun_cell_start(MESH_SSD_CELL)
    lm_err = phase_lm_kernel(torch)
    model, params, served, lm = phase_lm_serve(torch)
    lm_times = phase_lm_time(torch)
    lm_profile = phase_lm_profile(model, params, torch)
    del model, params
    torch.cuda.empty_cache()
    fam_launches, fam_rows = phase_lm_families(torch)
    train_rows = phase_lm_train(torch)
    mesh_launches, mesh_rows = phase_lm_mesh(torch, smi, cell=cell,
                                             dcell=dcell, scell=scell)
    dry_launches, dry_rows = phase_lm_dryrun(torch, smi, cell)

    t0 = time.perf_counter()
    g = rmat(16, edge_factor=16, seed=1)
    if (g.n, g.m) != (65536, 955396):
        raise AssertionError(f"rmat(16) gave n={g.n} m={g.m}")
    G = repro_torch.Graph(g, device="cuda")
    bg = G.device(blocked=True).out_blocked
    torch.cuda.synchronize()
    log(f"graph: n={g.n} m={g.m} tiles={bg.num_tiles} "
        f"({bg.tiles.nbytes / 1e9:.2f} GB on the card) built in "
        f"{time.perf_counter() - t0:.1f} s")
    payload_build("graph", bg, torch)
    report = G.memory_report()
    log(f"graph memory_report (the reference's tiles and schedule): "
        f"device_views={report['device_views']} device_edge_total="
        f"{report['device_edge_total']}; payload_nbytes={bg.payload_nbytes} "
        f"beside it (ROADMAP §C P14)")
    del bg  # G's cache alone holds its tiles (the analysis phase frees them)

    hub = int(np.argmax(np.diff(g.indptr)))
    phase_warmup()
    results, wall, counts = phase_main(G, hub, torch)
    phase_check(g, hub, results, torch)
    W, wg, wcc_wall, wcc_counts = phase_wcc(torch)
    batched_counts, batched_wall, ppr_bits = phase_batched(g, G, torch,
                                                           args.seed)
    algs_counts, algs_wall = phase_algs(wg, torch)
    Ha, Hb, host_counts, host_rows, rate = phase_host(torch)
    bhost_counts, bhost_rows = phase_batched_host(Ha, Hb, torch)
    errs = phase_kernels(G, W, torch)
    times = phase_time(g, G, wg, W, torch)
    rec_counts, rec_rows = phase_recovery(g, hub, G, W, Ha, Hb, torch)
    an_counts, an_rows = phase_analysis(G, W, Ha, Hb, torch)
    blocked = repro_torch.ExecutionPolicy(backend="blocked")
    compact = repro_torch.ExecutionPolicy(backend="blocked_compact")
    host_scan = repro_torch.ExecutionPolicy(residency="host")
    host_bc = repro_torch.ExecutionPolicy(backend="blocked_compact",
                                          residency="host")
    phase_profile((
        ("blocked/pr_push", lambda: G.pagerank(policy=blocked)),
        ("blocked/bfs_hub", lambda: G.bfs(hub, policy=blocked)),
        ("blocked/wcc", lambda: W.run(wcc_program(), policy=blocked)),
        ("blocked_compact/pr_push", lambda: G.pagerank(policy=compact)),
        ("blocked_compact/wcc", lambda: W.run(wcc_program(),
                                              policy=compact)),
        ("host/scan/pr_push", lambda: Ha.pagerank(
            max_iters=PROFILE_ITERS, policy=host_scan)),
        ("host/blocked_compact/wcc", lambda: Hb.run(wcc_program(),
                                                    policy=host_bc)),
        ("blocked/bfs_q32", lambda: G.bfs(top_degree(g, Q_MAIN).tolist(),
                                          policy=blocked)),
        ("blocked/ppr_q16", lambda: G.pagerank(
            reset=top_degree(g, Q_PPR).tolist(), policy=blocked)),
    ), torch)
    name_top_kernel("blocked/bfs_q32", lambda: G.bfs(
        top_degree(g, Q_MAIN).tolist(), policy=blocked), torch)

    # The chaos gate's workers build their own views: free the parent's.
    del G, W, Ha, Hb, results
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"chaos: parent holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "on the card before spawning its workers")
    chaos_row = phase_chaos(torch)
    ex_launches, ex_rows = phase_examples(torch, smi)

    # B1/B2: the main path and the batched, algorithm, host batched,
    # recovery and analysis paths; B3/B4: the WCC, recovery and analysis
    # paths.
    launched = {k: counts[k] + batched_counts[k] + algs_counts[k]
                + bhost_counts[k] + rec_counts[k] + an_counts[k]
                for k in ("spmv_blocked", "spmv_blocked_compact")}
    launched.update({k: wcc_counts[k] + rec_counts[k] + an_counts[k]
                     for k in ("spmv_blocked_min_plus",
                               "spmv_blocked_compact_min_plus")})
    kernels = [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/csrc/spmv.cu", "replaces": REPLACES[name],
         "launches": launched[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"],
         **{f"k{k}_{key}": times[name][f"k{k}_{key}"]
            for k in K_TIME if f"k{k}_ms" in times[name]
            for key in ("ms", "device_ms", "bound_ms", "library_ms")}}
        for name in KERNELS
    ]
    serve_t = lm_times["a"]
    kernels.append(
        {"name": B5, "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn/kernel.py:44",
         "launches": lm["launches"] + fam_launches + mesh_launches
         + dry_launches + ex_launches,
         "max_abs_err": max([lm_err] + [r["err"] for r in lm_times.values()]),
         "ms": serve_t["ms"], "plain_ms": serve_t["plain_ms"],
         "bound_ms": serve_t["bound_ms"], "bound_by": serve_t["bound_by"],
         "library_ms": serve_t["library_ms"]})
    log("lm: " + json.dumps({
        "decode_steps": served["decode_steps"], "tokens": served["tokens"],
        "seconds": served["seconds"], "ms_per_step": lm["step_ms"],
        "bound_ms_per_step": lm["bound_ms"],
        "idle_share": 1 - lm_profile["device_ms"] / lm_profile["wall_ms"],
        "b5_decode_32k": {k: lm_times[k] for k in ("b_full", "b_half")}}))
    log("lm_families: " + json.dumps(fam_rows))
    log("lm_train: " + json.dumps(train_rows))
    log("lm_mesh: " + json.dumps(mesh_rows))
    log("lm_dryrun: " + json.dumps(dry_rows))
    main_ms = {f"{b}/{r}": round(v, 3) for (b, r), v in wall.items()}
    log(f"main path wall ms: {json.dumps(main_ms)}")
    log(f"wcc wall ms: {json.dumps({b: round(v, 3) for b, v in wcc_wall.items()})}")
    log("host runs [device ms, host ms, streamed bytes]: " + json.dumps(
        {n: [round(d, 3), round(h, 3), b] for n, d, h, b in host_rows}))
    log(f"batched wall ms: {json.dumps(batched_wall)}; ppr columns bit-equal "
        f"to solo runs: "
        + json.dumps({f"{b}/{n}": v for (b, n), v in ppr_bits.items()}))
    log(f"algs wall ms: {json.dumps({k: round(v, 3) for k, v in algs_wall.items()})}")
    log(f"batched host: {json.dumps(bhost_rows)}")
    log(f"recovery: {json.dumps(rec_rows)}")
    log(f"analysis: {json.dumps(an_rows)}")
    log(f"chaos: {json.dumps(chaos_row)}")
    log(f"examples (wall s): {json.dumps(ex_rows)}")
    peak = max(an_rows["peak_gb/before"],
               torch.cuda.max_memory_allocated() / 1e9)
    log(f"peak device memory {peak:.2f} GB")
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
