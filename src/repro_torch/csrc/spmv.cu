// Blocked semiring SpMV: kernels B1-B4 for Hopper.
//
// Replaces the Pallas TPU kernels of repro/kernels/spmv/kernel.py:
//   B1  spmv_pallas          body _kernel_plus_times          (kernel.py:86)
//   B2  spmv_pallas_compact  body _kernel_plus_times_compact  (kernel.py:199)
//   B3  spmv_pallas          body _kernel_min_plus            (kernel.py:113)
//   B4  spmv_pallas_compact  body _kernel_min_plus_compact    (kernel.py:227)
//
// What they compute.  The TPU kernels stream dense tiles [T, Bd, Bs] f32 in a
// schedule whose consecutive tiles of one destination block form *runs*.  Per
// run a (Bd, K) accumulator starts at the semiring's identity and takes in
// each active tile t: plus_times adds tiles[t] @ x_blocks[sbid[t]]; min_plus
// takes the min of min_s(tiles[t][d, s] + x_blocks[sbid[t]][s, k]), where
// +inf marks an absent edge.  At the run's end the block's first run writes
// y, later runs combine into it (+ or min).  B1/B3 take every tile (skipping
// inactive ones), B2/B4 only the live work-list of the compacted schedule.
//
// No kernel here reads the dense tiles.  A 128x128 tile of an RMAT graph
// holds a few edges, so the tiles are >99.5% absent slots (15.7 GB a call on
// RMAT scale 16).  The kernels read the view's non-absent slots instead
// (ops.row_payload), 12 bytes an entry, in one of two orders:
//
//   row payload (B1/B3)  a CSR by destination row: (schedule position, x
//                        row, weight), a row's entries in schedule order,
//                        then column;
//   tile-major (B2/B4)   tile by tile: tile t's entries tile_ptr[t] ..
//                        tile_ptr[t+1] in row-major order, (row within the
//                        block, x row, weight).
//
// For each row r and lane k
//     y[r, k] = (+) over the live tiles' entries e of r of w[e] (x) x[src, k]
// and a row without a live entry gets the identity.  The sum equals the
// reference's per-run sums up to f32 order; min is order-free, so B3/B4
// equal their plain versions bit for bit.
//
// Non-finite x (ROADMAP §C P12).  The dense product of the reference also
// multiplies absent slots: 0 * (+-inf or NaN) is NaN under plus_times, and
// +inf + (-inf or NaN) is NaN under min_plus, and both min and the combine
// propagate NaN (jnp.min, jnp.minimum).  So row r of a live tile's block is
// NaN when the tile's source block holds such a "poisoning" value in a
// column c whose slot (r, c) is absent.  The kernels keep that rule at no
// cost on a finite x: one pass counts each source block's poisoning values
// per lane (pois[sb, k]); a live tile whose source block has none does
// nothing more, and otherwise row r is poisoned when fewer of its entries in
// the tile read a poisoning value than the block holds.  Min is a NaN-
// propagating min throughout.
//
// Design of B1/B3 (spmv_rows*).  A gather-heavy SpMV: 2 operations and
// ~12-16 bytes an entry, far below the f32 ridge, so bytes bound it; x (n K
// floats) and act (4 B a tile) sit in the 50 MB L2.  RMAT rows are skewed
// (mean ~15 entries, the hub ~6,000-10,000), so the build cuts every row into
// segments of at most 128 entries (seg_ptr, row_seg).  Pass 1, a group of 16
// lanes a segment (2 a warp: half the rows hold one entry or none): lane l of
// the group takes entries l, l + 16, ..., l + 112 of the segment with all
// eight (tile, src, w) loads and then all eight act and x loads in flight,
// sums its entries in order, and a fixed xor-shuffle tree reduces the group;
// extra thread blocks of the same launch count the poisoning values.  Pass
// 2, one thread a (row, lane): combines the row's partials in segment order
// into y.  Pass 3 (poison_tiles), a warp per 32 tiles: exits unless a live
// tile's source block holds a poisoning value.
//
// Design of B2/B4 (spmv_compact*).  The wrapper hands over the live
// work-list grouped by destination block (list, list_db; under 'dest' the
// schedule already is), and the kernel reads only the live tiles' entries,
// four words of list and pointers a live tile, the x rows they read and y.
// RMAT skew: a block holds from ~200 to ~12,000 live entries, so the work is
// cut by position, not by block: window w is the list positions [32 w,
// 32 w + 32), one thread block each.  Pass 0 (prep): each block's first and
// last list position (no memset: pass 2 validates a start against list_db)
// and the poisoning counts.  Pass 1 (windows): a thread block stages its
// window's entries, w (x) x[src] formed with all loads in flight, in shared
// memory, 2,048 at a time; then thread r owns row r and folds the staged
// entries of its row in order, flushing at each block boundary of the
// window (a *piece*), the staged entries read as 8-byte broadcasts in an
// unrolled loop.  A piece whose block lies wholly in the window goes to
// y; the block's first piece, when it continues, to part[w][1], and a
// later one to part[w][0].  Pass 2 (blocks), a thread block a destination
// block: the identity for a block with no live tile, and for a block over
// several windows the fold of part[first][1], part[first + 1][0], ... in
// window order.  No atomics and a fixed order: two launches give the same
// bits.  K > 1 restages the window for each lane, correct rather than fast
// (K = 1 is PageRank, BFS and WCC).  At RMAT scale 16 the bytes allow ~1 us;
// three launches and each window's chain of dependent loads (list, tile
// pointers, entries, x) set the time instead (PERF.md §6).
//
// min_plus has no tensor-core form (Hopper's DPX min-plus instructions are
// integer only), so every kernel here stays on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;      // B1/B3: lanes a segment (2 segments a warp)
constexpr int kSegUnroll = 8;   // entries a lane takes per pass: 128 a group
constexpr int kSegThreads = 256;  // 16 segments a thread block
constexpr int kCombineThreads = 256;
constexpr int kCountWarps = 8;  // (source block, lane) pairs a count block
constexpr int kPoisonWarps = 8;  // B1/B3 pass 3: 8 x 32 tiles a block
constexpr int kWin = 32;         // B2/B4: list positions a window
constexpr int kWinThreads = 128;  // threads of a window block: one a row
constexpr int kStageUnroll = 16;  // staged entries a thread per round
constexpr int kStage = kWinThreads * kStageUnroll;  // 2,048 a round
constexpr int kBlockThreads = 128;  // B2/B4 pass 2

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);
}

// A min that returns NaN when either side is NaN, as jnp.minimum does.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// The two semirings: the identity, one entry's value w (x) x, the fold of a
// value into an accumulator, and whether x poisons an absent slot.
template <bool kMinPlus>
struct Semiring;

template <>
struct Semiring<false> {  // plus_times
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ float value(float w, float x) {
    return __fmul_rn(w, x);
  }
  static __device__ __forceinline__ float step(float acc, float w, float x) {
    return fmaf(w, x, acc);
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ bool poisons(float x) {
    return !isfinite(x);  // 0 * x is NaN
  }
};

template <>
struct Semiring<true> {  // min_plus
  static __device__ __forceinline__ float identity() {
    return __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ float value(float w, float x) {
    return __fadd_rn(w, x);
  }
  static __device__ __forceinline__ float step(float acc, float w, float x) {
    return nan_min(acc, __fadd_rn(w, x));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return nan_min(a, b);
  }
  static __device__ __forceinline__ bool poisons(float x) {
    return x != x || x == -__int_as_float(0x7f800000);  // +inf + x is NaN
  }
};

// One warp: pois[item] = the poisoning values of x_blocks[sb, :, kk], item =
// sb * k + kk.
template <bool kMinPlus>
__device__ __forceinline__ void count_poison(const float* __restrict__ x,
                                             int* __restrict__ pois, int item,
                                             int n_items, int bs, int k) {
  if (item >= n_items) return;
  const int lane = threadIdx.x & 31;
  const int sb = item / k;
  const int kk = item % k;
  int cnt = 0;
  for (int c = lane; c < bs; c += 32) {
    cnt += Semiring<kMinPlus>::poisons(
        __ldg(x + (static_cast<size_t>(sb) * bs + c) * k + kk));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) pois[item] = cnt;
}

// Does row r of tile t (entries beg..end, row-major) lose a poisoning value
// of lane kk to an absent slot?  `want` is the source block's count.
template <bool kMinPlus>
__device__ bool row_poisoned(const float* __restrict__ x,
                             const int* __restrict__ tent_row,
                             const int* __restrict__ tent_src, int beg,
                             int end, int r, int kk, int k, int want) {
  int have = 0;
  for (int e = beg; e < end; ++e) {
    const int row = __ldg(tent_row + e);
    if (row > r) break;
    if (row == r) {
      have += Semiring<kMinPlus>::poisons(
          __ldg(x + static_cast<size_t>(__ldg(tent_src + e)) * k + kk));
    }
  }
  return have < want;
}

// ---------------------------------------------------------------- B1 / B3
// Pass 1: one group of kGroup lanes a segment [seg_ptr[s], seg_ptr[s+1]) of
// one row's entries; part[s, k] = the segment's (+) over its live entries.
// Thread blocks past the segments' count the poisoning values.
template <bool kMinPlus>
__global__ void __launch_bounds__(kSegThreads)
spmv_segments(const float* __restrict__ x, float* __restrict__ part,
              int* __restrict__ pois, const int* __restrict__ seg_ptr,
              const int* __restrict__ ent_tile,
              const int* __restrict__ ent_src,
              const float* __restrict__ ent_w, const int* __restrict__ act,
              int n_segs, int seg_blocks, int n_src_blocks, int bs, int k) {
  using S = Semiring<kMinPlus>;
  if (static_cast<int>(blockIdx.x) >= seg_blocks) {
    count_poison<kMinPlus>(
        x, pois, (blockIdx.x - seg_blocks) * kCountWarps + threadIdx.x / 32,
        n_src_blocks * k, bs, k);
    return;
  }
  const int seg = (blockIdx.x * kSegThreads + threadIdx.x) / kGroup;
  const int sub = threadIdx.x % kGroup;
  const bool have = seg < n_segs;  // every lane stays for the shuffles
  const int beg = have ? __ldg(seg_ptr + seg) : 0;
  const int end = have ? __ldg(seg_ptr + seg + 1) : 0;

  for (int kk = 0; kk < k; ++kk) {
    float acc = S::identity();
    for (int base = beg; base < end; base += kGroup * kSegUnroll) {
      int tile[kSegUnroll], src[kSegUnroll];
      float w[kSegUnroll], xv[kSegUnroll];
      bool live[kSegUnroll];
#pragma unroll
      for (int j = 0; j < kSegUnroll; ++j) {  // coalesced entry loads
        const int e = base + j * kGroup + sub;
        live[j] = e < end;
        tile[j] = live[j] ? __ldg(ent_tile + e) : 0;
        src[j] = live[j] ? __ldg(ent_src + e) : 0;
        w[j] = live[j] ? __ldg(ent_w + e) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kSegUnroll; ++j) {  // gathers, all in flight
        xv[j] = live[j] ? __ldg(x + static_cast<size_t>(src[j]) * k + kk)
                        : 0.f;
        live[j] = live[j] && __ldg(act + tile[j]) != 0;
      }
#pragma unroll
      for (int j = 0; j < kSegUnroll; ++j) {  // in entry order
        if (live[j]) acc = S::step(acc, w[j], xv[j]);
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      acc = S::combine(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (have && sub == 0) part[static_cast<size_t>(seg) * k + kk] = acc;
  }
}

// Pass 2: y[r, k] = (+) of row r's segment partials, in segment order.
template <bool kMinPlus>
__global__ void __launch_bounds__(kCombineThreads)
combine_segments(const float* __restrict__ part, float* __restrict__ y,
                 const int* __restrict__ row_seg, int n_rows, int k) {
  using S = Semiring<kMinPlus>;
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= static_cast<size_t>(n_rows) * k) return;
  const int r = static_cast<int>(i / k);
  const int kk = static_cast<int>(i % k);
  const int beg = __ldg(row_seg + r);
  const int end = __ldg(row_seg + r + 1);
  float acc = S::identity();
#pragma unroll 8
  for (int s = beg; s < end; ++s) {
    acc = S::combine(acc, __ldg(part + static_cast<size_t>(s) * k + kk));
  }
  y[i] = acc;
}

// Pass 3: NaN into the rows that the dense form poisons.  A warp checks 32
// tiles at once and leaves at once when none is live with a poisoned source
// block; otherwise it walks each such tile's row-major entries.
template <bool kMinPlus>
__global__ void __launch_bounds__(kPoisonWarps * 32)
poison_tiles(const float* __restrict__ x, float* __restrict__ y,
             const int* __restrict__ pois, const int* __restrict__ act,
             const int* __restrict__ dbid, const int* __restrict__ sbid,
             const int* __restrict__ tile_ptr,
             const int* __restrict__ tent_row,
             const int* __restrict__ tent_src, int n_tiles, int bd, int k) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kPoisonWarps + threadIdx.x / 32) * 32;
  const int t = base + lane;
  bool hit = false;
  if (t < n_tiles && __ldg(act + t) != 0) {
    const int sb = __ldg(sbid + t);
    for (int kk = 0; kk < k && !hit; ++kk) hit = pois[sb * k + kk] > 0;
  }
  unsigned todo = __ballot_sync(0xffffffffu, hit);
  while (todo) {
    const int tt = base + __ffs(todo) - 1;
    todo &= todo - 1;
    const int sb = __ldg(sbid + tt);
    const size_t yrow = static_cast<size_t>(__ldg(dbid + tt)) * bd;
    const int beg = __ldg(tile_ptr + tt);
    const int end = __ldg(tile_ptr + tt + 1);
    for (int kk = 0; kk < k; ++kk) {
      const int want = pois[sb * k + kk];
      if (want == 0) continue;
      for (int r = lane; r < bd; r += 32) {
        if (row_poisoned<kMinPlus>(x, tent_row, tent_src, beg, end, r, kk, k,
                                   want)) {
          y[(yrow + r) * k + kk] = nan_value();
        }
      }
    }
  }
}

template <bool kMinPlus>
int launch_rows(const float* x, float* y, float* part, int* pois,
                const int* row_seg, const int* seg_ptr, const int* ent_tile,
                const int* ent_src, const float* ent_w, const int* act,
                const int* dbid, const int* sbid, const int* tile_ptr,
                const int* tent_row, const int* tent_src, int n_rows,
                int n_segs, int n_tiles, int bd, int n_src_blocks, int bs,
                int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kSegsPerCta = kSegThreads / kGroup;
  const int seg_blocks = (n_segs + kSegsPerCta - 1) / kSegsPerCta;
  const int count_blocks =
      (n_src_blocks * k + kCountWarps - 1) / kCountWarps;
  if (seg_blocks + count_blocks > 0) {
    spmv_segments<kMinPlus><<<seg_blocks + count_blocks, kSegThreads, 0, s>>>(
        x, part, pois, seg_ptr, ent_tile, ent_src, ent_w, act, n_segs,
        seg_blocks, n_src_blocks, bs, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t outs = static_cast<size_t>(n_rows) * k;
  if (outs == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((outs + kCombineThreads - 1) / kCombineThreads);
  combine_segments<kMinPlus><<<blocks, kCombineThreads, 0, s>>>(
      part, y, row_seg, n_rows, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return static_cast<int>(err);
  constexpr int kTilesPerCta = kPoisonWarps * 32;
  poison_tiles<kMinPlus>
      <<<(n_tiles + kTilesPerCta - 1) / kTilesPerCta, kPoisonWarps * 32, 0,
         s>>>(x, y, pois, act, dbid, sbid, tile_ptr, tent_row, tent_src,
              n_tiles, bd, k);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- B2 / B4
// The live work-list, grouped by destination block: list [nact] tile ids
// (schedule order within a block), list_db [nact] their blocks (ascending).

// Pass 0: block b's live list positions are bstart[b] .. bend[b] (written
// only for blocks with a live tile; pass 2 validates), and the poisoning
// counts, in extra thread blocks.
template <bool kMinPlus>
__global__ void __launch_bounds__(kCountWarps * 32)
compact_prep(const float* __restrict__ x, int* __restrict__ pois,
             int* __restrict__ bstart, int* __restrict__ bend,
             const int* __restrict__ list_db, int nact, int count_blocks,
             int n_src_blocks, int bs, int k) {
  if (static_cast<int>(blockIdx.x) < count_blocks) {
    count_poison<kMinPlus>(x, pois,
                           blockIdx.x * kCountWarps + threadIdx.x / 32,
                           n_src_blocks * k, bs, k);
    return;
  }
  const int i = (blockIdx.x - count_blocks) * (kCountWarps * 32) + threadIdx.x;
  if (i >= nact) return;
  const int d = __ldg(list_db + i);
  if (i == 0 || __ldg(list_db + i - 1) != d) bstart[d] = i;
  if (i == nact - 1 || __ldg(list_db + i + 1) != d) bend[d] = i + 1;
}

// Pass 1: one window of kWin list positions a thread block.
template <bool kMinPlus>
__global__ void __launch_bounds__(kWinThreads)
compact_windows(const float* __restrict__ x, float* __restrict__ y,
                float* __restrict__ part, const int* __restrict__ pois,
                const int* __restrict__ list, const int* __restrict__ list_db,
                const int* __restrict__ sbid,
                const int* __restrict__ tile_ptr,
                const int* __restrict__ tent_row,
                const int* __restrict__ tent_src,
                const float* __restrict__ tent_w, int nact, int bd, int k) {
  using S = Semiring<kMinPlus>;
  __shared__ int s_beg[kWin];       // tile j's first entry
  __shared__ int s_off[kWin + 1];   // tile j's first staged slot
  __shared__ int s_sb[kWin];        // tile j's source block
  __shared__ int s_piece[kWin];     // tile j's piece
  __shared__ int s_pend[kWin];      // piece p's end slot
  __shared__ int s_pdst[kWin];      // piece p's output: 0/1 part slot, 2 y
  __shared__ int s_pdb[kWin];       // piece p's destination block
  __shared__ float2 s_ent[kStage];  // (row bits, w (x) x) of each slot
  __shared__ int s_pieces, s_poisoned;

  const int w = blockIdx.x;
  const int g0 = w * kWin;
  const int n = min(kWin, nact - g0);
  const int tid = threadIdx.x;

  if (tid < 32) {  // warp 0: the window's tiles, offsets and pieces
    int d = -1, beg = 0, cnt = 0, sb = 0;
    bool hit = false;
    if (tid < n) {
      const int t = __ldg(list + g0 + tid);
      d = __ldg(list_db + g0 + tid);
      beg = __ldg(tile_ptr + t);
      cnt = __ldg(tile_ptr + t + 1) - beg;
      sb = __ldg(sbid + t);
      for (int kk = 0; kk < k && !hit; ++kk) hit = pois[sb * k + kk] > 0;
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const int prev = __shfl_up_sync(0xffffffffu, d, 1);
    const int next = __shfl_down_sync(0xffffffffu, d, 1);
    const bool start = tid < n && (tid == 0 || d != prev);
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    const int piece = __popc(starts & ((2u << tid) - 1)) - 1;
    if (tid < n) {
      s_beg[tid] = beg;
      s_off[tid + 1] = incl;
      s_sb[tid] = sb;
      s_piece[tid] = piece;
      if (tid == n - 1 || d != next) {  // the piece's last tile
        const bool cont_in = piece == 0 && g0 > 0 && __ldg(list_db + g0 - 1) == d;
        const bool cont_out = tid == n - 1 && g0 + n < nact &&
                              __ldg(list_db + g0 + n) == d;
        s_pend[piece] = incl;
        s_pdst[piece] = cont_in ? 0 : (cont_out ? 1 : 2);
        s_pdb[piece] = d;
      }
    }
    if (tid == 0) {
      s_off[0] = 0;
      s_pieces = __popc(starts);
      s_poisoned = hits != 0;
    }
  }
  __syncthreads();
  const int total = s_off[n];
  const int pieces = s_pieces;

  // row r, lane kk of piece p := acc
  auto flush = [&](int p, int r, int kk, float acc) {
    const int dst = s_pdst[p];
    if (dst == 2) {
      y[(static_cast<size_t>(s_pdb[p]) * bd + r) * k + kk] = acc;
    } else {
      part[((static_cast<size_t>(w) * 2 + dst) * bd + r) * k + kk] = acc;
    }
  };

  for (int kk = 0; kk < k; ++kk) {
    for (int r0 = 0; r0 < bd; r0 += kWinThreads) {
      const int r = r0 + tid;
      float acc = S::identity();
      int p = 0;
      for (int base = 0; base < total; base += kStage) {
        int e[kStageUnroll], row[kStageUnroll], src[kStageUnroll];
        float wv[kStageUnroll], xv[kStageUnroll];
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {  // slot -> entry
          const int slot = base + u * kWinThreads + tid;
          e[u] = -1;
          if (slot < total) {
            int lo = 0, hi = n - 1;  // the tile j with s_off[j] <= slot
            while (lo < hi) {
              const int mid = (lo + hi + 1) >> 1;
              if (s_off[mid] <= slot) lo = mid; else hi = mid - 1;
            }
            e[u] = s_beg[lo] + slot - s_off[lo];
          }
        }
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {  // entry loads in flight
          row[u] = e[u] >= 0 ? __ldg(tent_row + e[u]) : 0;
          src[u] = e[u] >= 0 ? __ldg(tent_src + e[u]) : 0;
          wv[u] = e[u] >= 0 ? __ldg(tent_w + e[u]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {  // x gathers in flight
          xv[u] = e[u] >= 0
                      ? __ldg(x + static_cast<size_t>(src[u]) * k + kk)
                      : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {
          if (e[u] >= 0) {
            s_ent[u * kWinThreads + tid] =
                make_float2(__int_as_float(row[u]), S::value(wv[u], xv[u]));
          }
        }
        __syncthreads();
        if (r < bd) {
          const int lim = min(kStage, total - base);
          int i = 0;
          for (;;) {
            while (p < pieces && s_pend[p] <= base + i) {  // pieces ending
              flush(p, r, kk, acc);
              acc = S::identity();
              ++p;
            }
            if (i >= lim) break;
            const int end = min(s_pend[p] - base, lim);
#pragma unroll 8
            for (; i < end; ++i) {  // row r's entries of piece p, in order
              const float2 ev = s_ent[i];
              if (__float_as_int(ev.x) == r) acc = S::combine(acc, ev.y);
            }
          }
        }
        __syncthreads();
      }
      if (r < bd) {
        for (; p < pieces; ++p) {
          flush(p, r, kk, acc);
          acc = S::identity();
        }
      }
    }
  }

  if (s_poisoned) {  // rare: x holds a poisoning value some tile reads
    for (int j = 0; j < n; ++j) {
      const int sb = s_sb[j];
      const int beg = s_beg[j];
      const int end = beg + s_off[j + 1] - s_off[j];
      for (int kk = 0; kk < k; ++kk) {
        const int want = pois[sb * k + kk];
        if (want == 0) continue;
        for (int r = tid; r < bd; r += kWinThreads) {
          if (row_poisoned<kMinPlus>(x, tent_row, tent_src, beg, end, r, kk,
                                     k, want)) {
            flush(s_piece[j], r, kk, nan_value());
          }
        }
      }
    }
  }
}

// Pass 2: one destination block a thread block.
template <bool kMinPlus>
__global__ void __launch_bounds__(kBlockThreads)
compact_blocks(float* __restrict__ y, const float* __restrict__ part,
               const int* __restrict__ bstart, const int* __restrict__ bend,
               const int* __restrict__ list_db, int nact, int bd, int k) {
  using S = Semiring<kMinPlus>;
  const int b = blockIdx.x;
  const size_t width = static_cast<size_t>(bd) * k;
  float* yb = y + b * width;
  const int s = bstart[b];
  if (s < 0 || s >= nact || __ldg(list_db + s) != b) {  // no live tile
    for (size_t i = threadIdx.x; i < width; i += kBlockThreads) {
      yb[i] = S::identity();
    }
    return;
  }
  const int w0 = s / kWin;
  const int w1 = (bend[b] - 1) / kWin;
  if (w0 == w1) return;  // pass 1 wrote the block
  for (size_t i = threadIdx.x; i < width; i += kBlockThreads) {
    float acc = __ldg(part + (static_cast<size_t>(w0) * 2 + 1) * width + i);
    for (int w = w0 + 1; w <= w1; ++w) {
      acc = S::combine(acc,
                       __ldg(part + static_cast<size_t>(w) * 2 * width + i));
    }
    yb[i] = acc;
  }
}

template <bool kMinPlus>
int launch_compact(const float* x, float* y, float* part, int* ints,
                   const int* list, const int* list_db, const int* sbid,
                   const int* tile_ptr, const int* tent_row,
                   const int* tent_src, const float* tent_w, int nact,
                   int n_dst_blocks, int bd, int n_src_blocks, int bs, int k,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pois = ints;
  int* bstart = pois + static_cast<size_t>(n_src_blocks) * k;
  int* bend = bstart + n_dst_blocks;
  if (nact > 0) {
    const int count_blocks =
        (n_src_blocks * k + kCountWarps - 1) / kCountWarps;
    const int list_blocks = (nact + kCountWarps * 32 - 1) / (kCountWarps * 32);
    compact_prep<kMinPlus><<<count_blocks + list_blocks, kCountWarps * 32, 0,
                             s>>>(x, pois, bstart, bend, list_db, nact,
                                  count_blocks, n_src_blocks, bs, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compact_windows<kMinPlus><<<(nact + kWin - 1) / kWin, kWinThreads, 0, s>>>(
        x, y, part, pois, list, list_db, sbid, tile_ptr, tent_row, tent_src,
        tent_w, nact, bd, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_dst_blocks <= 0) return 0;
  compact_blocks<kMinPlus><<<n_dst_blocks, kBlockThreads, 0, s>>>(
      y, part, bstart, bend, list_db, nact, bd, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B1 (plus_times) / B3 (min_plus): the full schedule over the row payload.
// x [rows of x_blocks, K]; y [n_rows, K]; part [n_segs, K] scratch; pois
// [n_src_blocks, K] int scratch; row_seg [n_rows+1], seg_ptr [n_segs+1];
// ent_tile/ent_src/ent_w [E] the row payload; act [T] per-tile activity;
// dbid/sbid [T] and tile_ptr [T+1], tent_row/tent_src [E] for the
// non-finite rule.
int spmv_rows(const float* x, float* y, float* part, int* pois,
              const int* row_seg, const int* seg_ptr, const int* ent_tile,
              const int* ent_src, const float* ent_w, const int* act,
              const int* dbid, const int* sbid, const int* tile_ptr,
              const int* tent_row, const int* tent_src, int n_rows,
              int n_segs, int n_tiles, int bd, int n_src_blocks, int bs,
              int k, void* stream) {
  return launch_rows<false>(x, y, part, pois, row_seg, seg_ptr, ent_tile,
                            ent_src, ent_w, act, dbid, sbid, tile_ptr,
                            tent_row, tent_src, n_rows, n_segs, n_tiles, bd,
                            n_src_blocks, bs, k, stream);
}

int spmv_rows_min_plus(const float* x, float* y, float* part, int* pois,
                       const int* row_seg, const int* seg_ptr,
                       const int* ent_tile, const int* ent_src,
                       const float* ent_w, const int* act, const int* dbid,
                       const int* sbid, const int* tile_ptr,
                       const int* tent_row, const int* tent_src, int n_rows,
                       int n_segs, int n_tiles, int bd, int n_src_blocks,
                       int bs, int k, void* stream) {
  return launch_rows<true>(x, y, part, pois, row_seg, seg_ptr, ent_tile,
                           ent_src, ent_w, act, dbid, sbid, tile_ptr,
                           tent_row, tent_src, n_rows, n_segs, n_tiles, bd,
                           n_src_blocks, bs, k, stream);
}

// B2 (plus_times) / B4 (min_plus): the compacted live work-list over the
// tile-major payload.  y [n_dst_blocks * bd, K]; part [2 * windows, bd, K]
// scratch (windows = ceil(nact / 32)); ints [n_src_blocks * K + 2 *
// n_dst_blocks] int scratch; list/list_db [nact] the live tiles grouped by
// block; sbid [tiles] and tile_ptr [tiles+1], tent_row/tent_src/tent_w [E]
// the view's (or a host batch's) tile-major payload.
int spmv_compact(const float* x, float* y, float* part, int* ints,
                 const int* list, const int* list_db, const int* sbid,
                 const int* tile_ptr, const int* tent_row,
                 const int* tent_src, const float* tent_w, int nact,
                 int n_dst_blocks, int bd, int n_src_blocks, int bs, int k,
                 void* stream) {
  return launch_compact<false>(x, y, part, ints, list, list_db, sbid,
                               tile_ptr, tent_row, tent_src, tent_w, nact,
                               n_dst_blocks, bd, n_src_blocks, bs, k, stream);
}

int spmv_compact_min_plus(const float* x, float* y, float* part, int* ints,
                          const int* list, const int* list_db,
                          const int* sbid, const int* tile_ptr,
                          const int* tent_row, const int* tent_src,
                          const float* tent_w, int nact, int n_dst_blocks,
                          int bd, int n_src_blocks, int bs, int k,
                          void* stream) {
  return launch_compact<true>(x, y, part, ints, list, list_db, sbid,
                              tile_ptr, tent_row, tent_src, tent_w, nact,
                              n_dst_blocks, bd, n_src_blocks, bs, k, stream);
}

}  // extern "C"
