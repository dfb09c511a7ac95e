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
// segments of at most 128 entries (seg_ptr, row_seg).  Pass 1 at K = 1
// (spmv_segments), a group of 16 lanes a segment (2 a warp: half the rows
// hold one entry or none): lane l of the group takes entries l, l + 16, ...,
// l + 112 of the segment with all eight (tile, src, w) loads and then all
// eight act and x loads in flight, sums its entries in order, and a fixed
// xor-shuffle tree reduces the group.  Pass 1 at K > 1 (spmv_segments_wide)
// runs the lanes across threads: a group of G threads (G the power of two
// >= K, at most 32; 32 / G segments a warp) takes one segment, loads each
// entry's (tile, src, w) and act[tile] once, 32 entries a round, and shares
// them over the group with __shfl_sync; thread t folds lanes t, t + 32, ...
// (at most kMaxLanes / 32 of them) from the x row x[src, 0:K], which the
// group reads as consecutive words, 128 bytes a warp at K >= 32.  A column
// of a K-lane call must equal the K = 1 call on that column bit for bit, so
// each lane keeps the K = 1 order: 16 partials (entry i of the segment into
// partial i mod 16, in entry order) joined by the same tree, 16 registers a
// lane.  That is why the wide pass reads x as words and not float4: four
// lanes a thread would hold 64 partials.  Extra thread blocks of either
// launch count the poisoning values (a warp a source block, coalesced).
// Pass 2, one thread a row and lane (four lanes, as float4, where K % 4 ==
// 0): combines the row's partials in segment order into y.  Pass 3
// (poison_tiles), a warp per 32 tiles: exits unless a live tile's source
// block holds a poisoning value.
//
// Design of B2/B4 (spmv_compact*).  The wrapper hands over the live
// work-list grouped by destination block (list, list_db; under 'dest' the
// schedule already is), and the kernel reads only the live tiles' entries,
// four words of list and pointers a live tile, the x rows they read and y.
// RMAT skew: a block holds from ~200 to ~12,000 live entries, so the work is
// cut by position, not by block: window w is the list positions [32 w,
// 32 w + 32), one thread block each.  Row
// r's terms fold in list order of the tiles, then entry order, flushed at
// each block boundary of the window (a *piece*): a piece whose block lies
// wholly in the window goes to y, the block's first piece, when it
// continues, to part[w][1], a later one to part[w][0].  A block over
// several windows is then folded from part[first][1], part[first + 1][0],
// ... in window order, by a thread block a destination block, which also
// writes the identity into a block with no live tile.  No atomics and a
// fixed order: two launches give the same bits, and a column of a K-lane
// call the bits of the K = 1 call on that column.
//
// At K = 1 (PageRank, BFS, WCC) the passes are PR 15's: prep (each block's
// first and last list position, the poisoning counts), windows (a thread
// block stages its window's w (x) x, thread r folds the staged entries of
// row r in order), blocks.  At K > 1 two launches.  Pass 1
// (compact_windows) stages a window's (row, src, w) in shared memory, each
// entry read once whatever K is, and sorts the staged slots by row (a
// stable counting sort, no atomics), so each row's entries lie together in
// slot order.  Then it takes the rows in blocks of 256 / q rows, q = a
// row's chunks (a chunk a float4 of x's row where K % 4 == 0 and x is
// 16-byte aligned, else a word; K = 32: 32 rows a pass), a thread a (row,
// chunk), consecutive threads on consecutive chunks of one row.  A pass
// first gathers the values w (x) x of its rows' entries, all threads and
// all loads at once, each x row read as one coalesced row; then each thread
// folds its row's entries piece by piece (a binary search for the piece's
// end, then a tight loop over shared memory), so a hub row's entries of one
// window cost shared-memory reads, not dependent gathers.  The same
// launch writes each block's first and last list position and, in extra
// thread blocks, counts the poisoning values; pass 2 (compact_blocks)
// combines (float4s, several in flight) and then writes NaN into the rows
// the dense form poisons, if a live tile of the block reads a source block
// that holds a poisoning value.  A window whose entries pass kStage is
// staged in rounds, once per pass.  Tried and measured slower on the card (PERF.md §6): a walk over
// each row's ranges tile by tile, an in-order scan of the staged slots by
// every thread, and this K-lane pass at K = 1.

// min_plus has no tensor-core form (Hopper's DPX min-plus instructions are
// integer only), so every kernel here stays on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;      // B1/B3 at K = 1: lanes a segment
constexpr int kSegUnroll = 8;   // entries a lane takes per pass: 128 a group
constexpr int kSegThreads = 256;  // 16 segments a thread block
constexpr int kWideThreads = 256;  // B1/B3 at K > 1
constexpr int kRound = 32;      // entries a group loads per round (K > 1)
constexpr int kMaxLanes = 192;  // lanes a launch takes: 6 a thread at K > 32
constexpr int kCombineThreads = 256;
constexpr int kCountWarps = 8;  // source blocks a count block
constexpr int kPoisonWarps = 8;  // B1/B3 pass 3: 8 x 32 tiles a block
constexpr int kWin = 32;         // B2/B4: list positions a window
constexpr int kWinThreads = 256;  // threads of a window block
constexpr int kStage = 1024;      // K > 1: staged entries a window round
constexpr int kVals = 4096;       // K > 1: staged values w (x) x a round
constexpr int kWin1Threads = 128;  // K = 1: threads of a window block
constexpr int kStage1Unroll = 16;  // K = 1: staged entries a thread a round
constexpr int kStage1 = kWin1Threads * kStage1Unroll;  // 2,048 a round
constexpr int kBlockThreads = 256;  // B2/B4 pass 2

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

// One warp: pois[sb, k] = the poisoning values of lane k of x_blocks[sb]
// and pois_any[sb] = whether any lane has one.  The warp reads the block's
// bs x K floats in order: below 32 lanes it takes 32 / K rows at once
// (thread t: lane t % K, row t / K), and reduces each lane over its threads
// with a shuffle tree (K a power of two) or through `scratch` (32 ints).
template <bool kMinPlus>
__device__ void count_block(const float* __restrict__ x,
                            int* __restrict__ pois, int* __restrict__ pois_any,
                            int sb, int bs, int k, int* scratch) {
  using S = Semiring<kMinPlus>;
  const int lane = threadIdx.x & 31;
  const float* xb = x + static_cast<size_t>(sb) * bs * k;
  bool any = false;
  if (k < 32) {
    const int rows = 32 / k;
    int cnt = 0;
    if (lane < rows * k) {
#pragma unroll 8
      for (int c = lane / k; c < bs; c += rows) {
        cnt += S::poisons(__ldg(xb + static_cast<size_t>(c) * k + lane % k));
      }
    }
    if ((k & (k - 1)) == 0) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int v = __shfl_xor_sync(0xffffffffu, cnt, off);
        if (off >= k) cnt += v;
      }
    } else {
      scratch[lane] = cnt;
      __syncwarp();
      if (lane < k) {
        for (int g = 1; g < rows; ++g) cnt += scratch[lane + g * k];
      }
      __syncwarp();
    }
    if (lane < k) {
      pois[sb * k + lane] = cnt;
      any = cnt > 0;
    }
  } else {
    for (int kk = lane; kk < k; kk += 32) {
      int cnt = 0;
#pragma unroll 16
      for (int c = 0; c < bs; ++c) {
        cnt += S::poisons(__ldg(xb + static_cast<size_t>(c) * k + kk));
      }
      pois[sb * k + kk] = cnt;
      any = any || cnt > 0;
    }
  }
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) pois_any[sb] = any;
}

// Does row r of tile t (entries beg..end, row-major) lose a poisoning value
// of lane kk to an absent slot?  `want` is the source block's count.
template <bool kMinPlus>
__device__ __forceinline__ bool row_poisoned(const float* __restrict__ x,
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
// Pass 1 at K = 1: one group of kGroup lanes a segment [seg_ptr[s],
// seg_ptr[s+1]) of one row's entries; part[s] = the segment's (+) over its
// live entries.  Thread blocks past the segments' count the poisoning
// values.
template <bool kMinPlus>
__global__ void __launch_bounds__(kSegThreads)
spmv_segments(const float* __restrict__ x, float* __restrict__ part,
              int* __restrict__ pois, int* __restrict__ pois_any,
              const int* __restrict__ seg_ptr,
              const int* __restrict__ ent_tile,
              const int* __restrict__ ent_src,
              const float* __restrict__ ent_w, const int* __restrict__ act,
              int n_segs, int seg_blocks, int n_src_blocks, int bs) {
  using S = Semiring<kMinPlus>;
  __shared__ int s_count[kSegThreads];
  if (static_cast<int>(blockIdx.x) >= seg_blocks) {
    const int sb = (blockIdx.x - seg_blocks) * kCountWarps + threadIdx.x / 32;
    if (sb < n_src_blocks) {
      count_block<kMinPlus>(x, pois, pois_any, sb, bs, 1,
                            s_count + (threadIdx.x & ~31));
    }
    return;
  }
  const int seg = (blockIdx.x * kSegThreads + threadIdx.x) / kGroup;
  const int sub = threadIdx.x % kGroup;
  const bool have = seg < n_segs;  // every lane stays for the shuffles
  const int beg = have ? __ldg(seg_ptr + seg) : 0;
  const int end = have ? __ldg(seg_ptr + seg + 1) : 0;

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
      xv[j] = live[j] ? __ldg(x + src[j]) : 0.f;
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
  if (have && sub == 0) part[seg] = acc;
}

// The K = 1 pass's xor tree over its 16 lanes, as lane 0 sees it: lane i
// first takes in lane i ^ 8, then i ^ 4, i ^ 2 and i ^ 1, its own value on
// the left each time.
template <bool kMinPlus>
__device__ __forceinline__ float tree16(const float (&a)[16]) {
  using S = Semiring<kMinPlus>;
  float b[8], c[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = S::combine(a[i], a[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = S::combine(b[i], b[i + 4]);
  return S::combine(S::combine(c[0], c[2]), S::combine(c[1], c[3]));
}

// Pass 1 at K > 1: a group of kGw threads a segment (kGw a power of two >=
// K, at most 32), thread t of the group the lanes t + kGw * l, l < kLanes.
// Each round the group loads 32 of the segment's entries once (32 / kGw a
// thread, coalesced) and shares them by shuffles; entry i of the segment
// goes into partial i mod 16 of every lane, so each lane's partials, tree
// and bits are those of the K = 1 pass on that lane.
template <bool kMinPlus, int kGw, int kLanes>
__global__ void __launch_bounds__(kWideThreads)
spmv_segments_wide(const float* __restrict__ x, float* __restrict__ part,
                   int* __restrict__ pois, int* __restrict__ pois_any,
                   const int* __restrict__ seg_ptr,
                   const int* __restrict__ ent_tile,
                   const int* __restrict__ ent_src,
                   const float* __restrict__ ent_w,
                   const int* __restrict__ act, int n_segs, int seg_blocks,
                   int n_src_blocks, int bs, int k) {
  using S = Semiring<kMinPlus>;
  constexpr int kPer = kRound / kGw;  // entries a thread loads a round
  // entries whose x words a thread has in flight at once
  constexpr int kChunk = kLanes == 1 ? 16 : (kLanes == 2 ? 8 : (kLanes <= 4 ? 4 : 2));
  __shared__ int s_count[kWideThreads];
  if (static_cast<int>(blockIdx.x) >= seg_blocks) {
    const int sb = (blockIdx.x - seg_blocks) * (kWideThreads / 32) +
                   threadIdx.x / 32;
    if (sb < n_src_blocks) {
      count_block<kMinPlus>(x, pois, pois_any, sb, bs, k,
                            s_count + (threadIdx.x & ~31));
    }
    return;
  }
  const int t = threadIdx.x % kGw;
  const int seg = (blockIdx.x * kWideThreads + threadIdx.x) / kGw;
  const bool have = seg < n_segs;
  const int beg = have ? __ldg(seg_ptr + seg) : 0;
  const int cnt = have ? __ldg(seg_ptr + seg + 1) - beg : 0;
  const int most = __reduce_max_sync(0xffffffffu, cnt);  // warp-uniform

  float acc[kLanes][16];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
#pragma unroll
    for (int s = 0; s < 16; ++s) acc[l][s] = S::identity();
  }
  for (int base = 0; base < most; base += kRound) {
    int tile[kPer], src[kPer];
    float w[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {  // coalesced entry loads, once
      const int i = base + u * kGw + t;
      const bool in = i < cnt;
      tile[u] = in ? __ldg(ent_tile + beg + i) : 0;
      src[u] = in ? __ldg(ent_src + beg + i) : -1;
      w[u] = in ? __ldg(ent_w + beg + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {  // entries of inactive tiles drop out
      if (src[u] >= 0 && __ldg(act + tile[u]) == 0) src[u] = -1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (base + 16 * h >= most) break;
#pragma unroll
      for (int s0 = 0; s0 < 16; s0 += kChunk) {  // entries 16 h + s0 ..
        int sv[kChunk];
        float wv[kChunk], xv[kChunk][kLanes];
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          const int i = 16 * h + s0 + s;
          sv[s] = __shfl_sync(0xffffffffu, src[i / kGw], i % kGw, kGw);
          wv[s] = __shfl_sync(0xffffffffu, w[i / kGw], i % kGw, kGw);
        }
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {  // all gathers in flight
          const float* xr = x + static_cast<size_t>(max(sv[s], 0)) * k;
#pragma unroll
          for (int l = 0; l < kLanes; ++l) {
            xv[s][l] = __ldg(xr + min(t + l * kGw, k - 1));
          }
        }
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {  // entry 16 h + s0 + s: partial
#pragma unroll
          for (int l = 0; l < kLanes; ++l) {
            if (sv[s] >= 0 && t + l * kGw < k) {
              acc[l][s0 + s] = S::step(acc[l][s0 + s], wv[s], xv[s][l]);
            }
          }
        }
      }
    }
  }
  if (have) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      if (t + l * kGw < k) {
        part[static_cast<size_t>(seg) * k + t + l * kGw] =
            tree16<kMinPlus>(acc[l]);
      }
    }
  }
}

// Pass 2: y[r, k] = (+) of row r's segment partials, in segment order; a
// thread a row and kV lanes (4: float4 loads and stores).
template <bool kMinPlus, int kV>
__global__ void __launch_bounds__(kCombineThreads)
combine_segments(const float* __restrict__ part, float* __restrict__ y,
                 const int* __restrict__ row_seg, int n_rows, int k) {
  using S = Semiring<kMinPlus>;
  const int q = k / kV;
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= static_cast<size_t>(n_rows) * q) return;
  const int r = static_cast<int>(i / q);
  const int c = static_cast<int>(i % q);
  const int beg = __ldg(row_seg + r);
  const int end = __ldg(row_seg + r + 1);
  float acc[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) acc[v] = S::identity();
#pragma unroll 8
  for (int s = beg; s < end; ++s) {
    const float* src = part + static_cast<size_t>(s) * k + c * kV;
    if constexpr (kV == 4) {
      const float4 pv = __ldg(reinterpret_cast<const float4*>(src));
      acc[0] = S::combine(acc[0], pv.x);
      acc[1] = S::combine(acc[1], pv.y);
      acc[2] = S::combine(acc[2], pv.z);
      acc[3] = S::combine(acc[3], pv.w);
    } else {
      acc[0] = S::combine(acc[0], __ldg(src));
    }
  }
  float* out = y + static_cast<size_t>(r) * k + c * kV;
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
  } else {
    out[0] = acc[0];
  }
}

// Pass 3: NaN into the rows that the dense form poisons.  A warp checks 32
// tiles at once and leaves at once when none is live with a poisoned source
// block; otherwise it walks each such tile's row-major entries.
template <bool kMinPlus>
__global__ void __launch_bounds__(kPoisonWarps * 32)
poison_tiles(const float* __restrict__ x, float* __restrict__ y,
             const int* __restrict__ pois, const int* __restrict__ pois_any,
             const int* __restrict__ act, const int* __restrict__ dbid,
             const int* __restrict__ sbid, const int* __restrict__ tile_ptr,
             const int* __restrict__ tent_row,
             const int* __restrict__ tent_src, int n_tiles, int bd, int k) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kPoisonWarps + threadIdx.x / 32) * 32;
  const int t = base + lane;
  const bool hit = t < n_tiles && __ldg(act + t) != 0 &&
                   pois_any[__ldg(sbid + t)] != 0;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Pass 1 of a K-lane call: the segments of kGw threads, kLanes lanes a
// thread, and the poisoning counts.
template <bool kMinPlus, int kGw, int kLanes>
cudaError_t launch_wide(const float* x, float* part, int* pois,
                        int* pois_any, const int* seg_ptr,
                        const int* ent_tile, const int* ent_src,
                        const float* ent_w, const int* act, int n_segs,
                        int n_src_blocks, int bs, int k, cudaStream_t s) {
  constexpr int kSegsPerCta = kWideThreads / kGw;
  const int seg_blocks = (n_segs + kSegsPerCta - 1) / kSegsPerCta;
  const int count_blocks =
      (n_src_blocks + kWideThreads / 32 - 1) / (kWideThreads / 32);
  if (seg_blocks + count_blocks == 0) return cudaSuccess;
  spmv_segments_wide<kMinPlus, kGw, kLanes>
      <<<seg_blocks + count_blocks, kWideThreads, 0, s>>>(
          x, part, pois, pois_any, seg_ptr, ent_tile, ent_src, ent_w, act,
          n_segs, seg_blocks, n_src_blocks, bs, k);
  return cudaGetLastError();
}

template <bool kMinPlus>
cudaError_t launch_segments(const float* x, float* part, int* pois,
                            int* pois_any, const int* seg_ptr,
                            const int* ent_tile, const int* ent_src,
                            const float* ent_w, const int* act, int n_segs,
                            int n_src_blocks, int bs, int k,
                            cudaStream_t s) {
  if (k == 1) {
    constexpr int kSegsPerCta = kSegThreads / kGroup;
    const int seg_blocks = (n_segs + kSegsPerCta - 1) / kSegsPerCta;
    const int count_blocks = (n_src_blocks + kCountWarps - 1) / kCountWarps;
    if (seg_blocks + count_blocks == 0) return cudaSuccess;
    spmv_segments<kMinPlus><<<seg_blocks + count_blocks, kSegThreads, 0, s>>>(
        x, part, pois, pois_any, seg_ptr, ent_tile, ent_src, ent_w, act,
        n_segs, seg_blocks, n_src_blocks, bs);
    return cudaGetLastError();
  }
#define SPMV_WIDE(G, L)                                                     \
  return launch_wide<kMinPlus, G, L>(x, part, pois, pois_any, seg_ptr,      \
                                     ent_tile, ent_src, ent_w, act, n_segs, \
                                     n_src_blocks, bs, k, s)
  if (k <= 2) SPMV_WIDE(2, 1);
  if (k <= 4) SPMV_WIDE(4, 1);
  if (k <= 8) SPMV_WIDE(8, 1);
  if (k <= 16) SPMV_WIDE(16, 1);
  if (k <= 32) SPMV_WIDE(32, 1);
  if (k <= 64) SPMV_WIDE(32, 2);
  if (k <= 96) SPMV_WIDE(32, 3);
  if (k <= 128) SPMV_WIDE(32, 4);
  if (k <= 160) SPMV_WIDE(32, 5);
  if (k <= kMaxLanes) SPMV_WIDE(32, 6);
#undef SPMV_WIDE
  return cudaErrorInvalidValue;
}

template <bool kMinPlus>
int launch_rows(const float* x, float* y, float* part, int* pois,
                int* pois_any, const int* row_seg, const int* seg_ptr,
                const int* ent_tile, const int* ent_src, const float* ent_w,
                const int* act, const int* dbid, const int* sbid,
                const int* tile_ptr, const int* tent_row,
                const int* tent_src, int n_rows, int n_segs, int n_tiles,
                int bd, int n_src_blocks, int bs, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_segments<kMinPlus>(
      x, part, pois, pois_any, seg_ptr, ent_tile, ent_src, ent_w, act, n_segs,
      n_src_blocks, bs, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = k % 4 == 0 && aligned16(part) && aligned16(y);
  const size_t outs = static_cast<size_t>(n_rows) * (vec ? k / 4 : k);
  if (outs == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((outs + kCombineThreads - 1) / kCombineThreads);
  if (vec) {
    combine_segments<kMinPlus, 4><<<blocks, kCombineThreads, 0, s>>>(
        part, y, row_seg, n_rows, k);
  } else {
    combine_segments<kMinPlus, 1><<<blocks, kCombineThreads, 0, s>>>(
        part, y, row_seg, n_rows, k);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return static_cast<int>(err);
  constexpr int kTilesPerCta = kPoisonWarps * 32;
  poison_tiles<kMinPlus>
      <<<(n_tiles + kTilesPerCta - 1) / kTilesPerCta, kPoisonWarps * 32, 0,
         s>>>(x, y, pois, pois_any, act, dbid, sbid, tile_ptr, tent_row,
              tent_src, n_tiles, bd, k);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- B2 / B4
// The live work-list, grouped by destination block: list [nact] tile ids
// (schedule order within a block), list_db [nact] their blocks (ascending).

// The tile j of the window whose staged slots s_off[j] .. s_off[j+1] hold
// `slot` (tiles without entries are passed over).
__device__ __forceinline__ int window_tile(const int* s_off, int n,
                                           int slot) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_off[mid] <= slot) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// ---- K = 1: one lane.  Thread r of a window block owns row r and
// folds the staged entries of its row in order (the PR 15 pass, kept:
// measured faster at K = 1 than the K-lane pass below, PERF.md §6).

// Pass 0: block b's live list positions are bstart[b] .. bend[b] (written
// only for blocks with a live tile; pass 2 validates), and the poisoning
// counts, in extra thread blocks.
template <bool kMinPlus>
__global__ void __launch_bounds__(kCountWarps * 32)
compact_prep1(const float* __restrict__ x, int* __restrict__ pois,
              int* __restrict__ pois_any, int* __restrict__ bstart,
              int* __restrict__ bend, const int* __restrict__ list_db,
              int nact, int count_blocks, int n_src_blocks, int bs) {
  __shared__ int s_count[kCountWarps * 32];
  if (static_cast<int>(blockIdx.x) < count_blocks) {
    const int sb = blockIdx.x * kCountWarps + threadIdx.x / 32;
    if (sb < n_src_blocks) {
      count_block<kMinPlus>(x, pois, pois_any, sb, bs, 1,
                            s_count + (threadIdx.x & ~31));
    }
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
__global__ void __launch_bounds__(kWin1Threads)
compact_windows1(const float* __restrict__ x, float* __restrict__ y,
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
  __shared__ float2 s_ent[kStage1];  // (row bits, w (x) x) of each slot
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
    for (int r0 = 0; r0 < bd; r0 += kWin1Threads) {
      const int r = r0 + tid;
      float acc = S::identity();
      int p = 0;
      for (int base = 0; base < total; base += kStage1) {
        int e[kStage1Unroll], row[kStage1Unroll], src[kStage1Unroll];
        float wv[kStage1Unroll], xv[kStage1Unroll];
#pragma unroll
        for (int u = 0; u < kStage1Unroll; ++u) {  // slot -> entry
          const int slot = base + u * kWin1Threads + tid;
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
        for (int u = 0; u < kStage1Unroll; ++u) {  // entry loads in flight
          row[u] = e[u] >= 0 ? __ldg(tent_row + e[u]) : 0;
          src[u] = e[u] >= 0 ? __ldg(tent_src + e[u]) : 0;
          wv[u] = e[u] >= 0 ? __ldg(tent_w + e[u]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStage1Unroll; ++u) {  // x gathers in flight
          xv[u] = e[u] >= 0
                      ? __ldg(x + static_cast<size_t>(src[u]) * k + kk)
                      : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStage1Unroll; ++u) {
          if (e[u] >= 0) {
            s_ent[u * kWin1Threads + tid] =
                make_float2(__int_as_float(row[u]), S::value(wv[u], xv[u]));
          }
        }
        __syncthreads();
        if (r < bd) {
          const int lim = min(kStage1, total - base);
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
        for (int r = tid; r < bd; r += kWin1Threads) {
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
__global__ void __launch_bounds__(kWin1Threads)
compact_blocks1(float* __restrict__ y, const float* __restrict__ part,
               const int* __restrict__ bstart, const int* __restrict__ bend,
               const int* __restrict__ list_db, int nact, int bd, int k) {
  using S = Semiring<kMinPlus>;
  const int b = blockIdx.x;
  const size_t width = static_cast<size_t>(bd) * k;
  float* yb = y + b * width;
  const int s = bstart[b];
  if (s < 0 || s >= nact || __ldg(list_db + s) != b) {  // no live tile
    for (size_t i = threadIdx.x; i < width; i += kWin1Threads) {
      yb[i] = S::identity();
    }
    return;
  }
  const int w0 = s / kWin;
  const int w1 = (bend[b] - 1) / kWin;
  if (w0 == w1) return;  // pass 1 wrote the block
  for (size_t i = threadIdx.x; i < width; i += kWin1Threads) {
    float acc = __ldg(part + (static_cast<size_t>(w0) * 2 + 1) * width + i);
    for (int w = w0 + 1; w <= w1; ++w) {
      acc = S::combine(acc,
                       __ldg(part + static_cast<size_t>(w) * 2 * width + i));
    }
    yb[i] = acc;
  }
}


// ---- K > 1 lanes.

// Dynamic shared memory of a K-lane window block: the staged values
// w (x) x [kVals]; the staged (row, src, w) and the slots sorted by row
// [kStage] each; each row's first sorted position [bd + 1] and the sort's
// counts a (row, slice) [kWinThreads].
__host__ __device__ constexpr size_t window_smem(int bd) {
  return (static_cast<size_t>(kVals) + 4 * kStage + bd + 1 + kWinThreads) *
         4;
}

// The (row, src, w) of a window's staged slots r0 .. r1, one entry a
// thread at a time: each entry read once a round.
__device__ __forceinline__ void stage_slots(
    int r0, int r1, const int* s_off, const int* s_beg, int n,
    const int* __restrict__ tent_row, const int* __restrict__ tent_src,
    const float* __restrict__ tent_w, int* s_row, int* s_src, float* s_w) {
  for (int s = r0 + threadIdx.x; s < r1; s += kWinThreads) {
    const int j = window_tile(s_off, n, s);
    const int e = s_beg[j] + s - s_off[j];
    s_row[s - r0] = __ldg(tent_row + e);
    s_src[s - r0] = __ldg(tent_src + e);
    s_w[s - r0] = __ldg(tent_w + e);
  }
}

// A stable counting sort of the staged slots 0 .. m by row, without
// atomics: `ts` threads a row each count their slice of the slots (rows
// read 4 at a time), a warp turns the counts into each row's first
// position (s_start, and s_start[bd] = m), and each thread writes its
// slice's slots of its row there in slot order.
__device__ __forceinline__ void sort_slots(int m, int bd, const int* s_row,
                                           int* s_cnt, int* s_start,
                                           int* s_perm) {
  const int ts = max(1, kWinThreads / bd);  // threads a row
  const bool sliced = bd * ts <= kWinThreads;  // else one thread a row
  const int slice = ((m + ts - 1) / ts + 3) & ~3;
  for (int t = threadIdx.x; t < bd * ts; t += kWinThreads) {
    const int r = t / ts;
    const int lo = t % ts * slice;
    const int hi = min(m, lo + slice);
    int cnt = 0;
#pragma unroll 4
    for (int i = lo; i < hi; i += 4) {
      const int4 rr = *reinterpret_cast<const int4*>(s_row + i);
      cnt += (rr.x == r) + (i + 1 < hi && rr.y == r) +
             (i + 2 < hi && rr.z == r) + (i + 3 < hi && rr.w == r);
    }
    if (sliced) s_cnt[t] = cnt;
    else s_start[r] = cnt;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive scan over the rows
    const int lane = threadIdx.x;
    const int per = (bd + 31) / 32;
    const int rlo = min(bd, lane * per);
    const int rhi = min(bd, rlo + per);
    int sum = 0;
    for (int r = rlo; r < rhi; ++r) {
      if (sliced) {
        for (int h = 0; h < ts; ++h) sum += s_cnt[r * ts + h];
      } else {
        sum += s_start[r];
      }
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
    for (int r = rlo; r < rhi; ++r) {
      const int first = run;
      if (sliced) {
        for (int h = 0; h < ts; ++h) {
          const int ch = s_cnt[r * ts + h];
          s_cnt[r * ts + h] = run;  // the slice's first position
          run += ch;
        }
      } else {
        run += s_start[r];
      }
      s_start[r] = first;
    }
    if (lane == 31) s_start[bd] = incl;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < bd * ts; t += kWinThreads) {
    const int r = t / ts;
    const int lo = t % ts * slice;
    const int hi = min(m, lo + slice);
    int at = sliced ? s_cnt[t] : s_start[r];
    for (int i = lo; i < hi; i += 4) {
      const int4 rr = *reinterpret_cast<const int4*>(s_row + i);
      if (rr.x == r) s_perm[at++] = i;
      if (i + 1 < hi && rr.y == r) s_perm[at++] = i + 1;
      if (i + 2 < hi && rr.z == r) s_perm[at++] = i + 2;
      if (i + 3 < hi && rr.w == r) s_perm[at++] = i + 3;
    }
  }
  __syncthreads();
}

// Where a thread's lanes of row r (lanes `col` on) of piece p go: y for a
// block wholly in the window, else the window's part slot.
__device__ __forceinline__ float* piece_out(int p, const int* s_pdst,
                                            const int* s_pdb,
                                            float* __restrict__ y,
                                            float* __restrict__ part, int w,
                                            int bd, int k, int r, int col) {
  const int dst = s_pdst[p];
  return (dst == 2 ? y + (static_cast<size_t>(s_pdb[p]) * bd + r) * k
                   : part + ((static_cast<size_t>(w) * 2 + dst) * bd + r) *
                                k) + col;
}

// Pass 1 at K > 1: one window of kWin list positions a thread block;
// blocks past the windows count the poisoning values.  kV lanes a chunk
// (4: float4).
// Four blocks an SM: ptxas's default settled at 48 registers and spilled
// the float4 accumulator; 64 leave it in registers (and run faster).
template <bool kMinPlus, int kV>
__global__ void __launch_bounds__(kWinThreads, 4)
compact_windows(const float* __restrict__ x, float* __restrict__ y,
                float* __restrict__ part, int* __restrict__ pois,
                int* __restrict__ pois_any, int* __restrict__ bstart,
                int* __restrict__ bend, const int* __restrict__ list,
                const int* __restrict__ list_db,
                const int* __restrict__ tile_ptr,
                const int* __restrict__ tent_row,
                const int* __restrict__ tent_src,
                const float* __restrict__ tent_w, int nact, int n_windows,
                int n_src_blocks, int bd, int bs, int k) {
  using S = Semiring<kMinPlus>;
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= n_windows) {
    const int sb = (blockIdx.x - n_windows) * (kWinThreads / 32) + tid / 32;
    if (sb < n_src_blocks) {
      count_block<kMinPlus>(x, pois, pois_any, sb, bs, k,
                            smem + (tid & ~31));
    }
    return;
  }
  float* s_val = reinterpret_cast<float*>(smem);  // [sorted pos][chunk][kV]
  int* s_row = smem + kVals;                       // [slot - round]
  int* s_src = s_row + kStage;
  float* s_w = reinterpret_cast<float*>(s_src + kStage);
  int* s_perm = reinterpret_cast<int*>(s_w + kStage);  // slots by row
  int* s_start = s_perm + kStage;  // [r]: row r's first sorted position
  int* s_cnt = s_start + bd + 1;   // the sort's counts
  __shared__ int s_beg[kWin];       // tile j's first entry
  __shared__ int s_off[kWin + 1];   // tile j's first staged slot
  __shared__ int s_pend[kWin];      // piece p's end slot
  __shared__ int s_pdst[kWin];      // piece p's output: 0/1 part slot, 2 y
  __shared__ int s_pdb[kWin];       // piece p's destination block
  __shared__ int s_pieces;

  const int w = blockIdx.x;
  const int g0 = w * kWin;
  const int n = min(kWin, nact - g0);

  if (tid < 32) {  // warp 0: the window's tiles, offsets and pieces
    int d = -1, beg = 0, cnt = 0;
    if (tid < n) {
      const int t = __ldg(list + g0 + tid);
      d = __ldg(list_db + g0 + tid);
      beg = __ldg(tile_ptr + t);
      cnt = __ldg(tile_ptr + t + 1) - beg;
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
    const int piece = __popc(starts & ((2u << tid) - 1)) - 1;
    if (tid < n) {
      const bool cont_in =
          piece == 0 && g0 > 0 && __ldg(list_db + g0 - 1) == d;
      s_beg[tid] = beg;
      s_off[tid + 1] = incl;
      if (start && !cont_in) bstart[d] = g0 + tid;
      if (tid == n - 1 || d != next) {  // the piece's last tile
        const bool cont_out = tid == n - 1 && g0 + n < nact &&
                              __ldg(list_db + g0 + n) == d;
        s_pend[piece] = incl;
        s_pdst[piece] = cont_in ? 0 : (cont_out ? 1 : 2);
        s_pdb[piece] = d;
        if (!cont_out) bend[d] = g0 + tid + 1;
      }
    }
    if (tid == 0) {
      s_off[0] = 0;
      s_pieces = __popc(starts);
    }
  }
  __syncthreads();
  const int total = s_off[n];
  const int pieces = s_pieces;
  const int rounds = max(1, (total + kStage - 1) / kStage);

  // Passes over blocks of rows: q chunks (kV lanes each) a row, a thread a
  // (row, chunk), consecutive threads on consecutive chunks of one row.
  const int q = k / kV;
  const int rows_pp = max(1, min(bd, kWinThreads / q));
  const int cpp = min(q, kWinThreads);  // chunks a pass
  const int chunk_blocks = (q + cpp - 1) / cpp;
  const int passes = (bd + rows_pp - 1) / rows_pp * chunk_blocks;
  for (int pass = 0; pass < passes; ++pass) {
    const int rb = pass / chunk_blocks * rows_pp;  // the pass's first row
    const int re = min(bd, rb + rows_pp);
    const int c0 = pass % chunk_blocks * cpp;
    const int nc = min(cpp, q - c0);  // chunks a row this pass
    const int r = rb + tid / nc;
    const int c = c0 + tid % nc;
    const bool mine = r < re;
    const int per = kVals / (nc * kV);  // sorted positions a value round
    float acc[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[v] = S::identity();
    int p = 0;
    for (int round = 0; round < rounds; ++round) {
      const int r0 = round * kStage;
      const int r1 = min(total, r0 + kStage);
      if (pass == 0 || rounds > 1) {  // stage and sort this round's slots
        __syncthreads();
        stage_slots(r0, r1, s_off, s_beg, n, tent_row, tent_src, tent_w,
                    s_row, s_src, s_w);
        __syncthreads();
        sort_slots(r1 - r0, bd, s_row, s_cnt, s_start, s_perm);
      }
      // the pass's rows hold the sorted positions i0 .. i1
      const int i0 = s_start[rb];
      const int i1 = s_start[re];
      int at = mine ? s_start[r] : 0;     // this row's next position
      const int end = mine ? s_start[r + 1] : 0;
      for (int v0 = i0;;) {
        const int v1 = min(i1, v0 + per);
        __syncthreads();  // the last walk is done with s_val
#pragma unroll 4
        for (int it = tid; it < (v1 - v0) * nc; it += kWinThreads) {
          const int slot = s_perm[v0 + it / nc];
          const int pc = it % nc;
          const float wv = s_w[slot];
          const float* xr =
              x + static_cast<size_t>(s_src[slot]) * k + (c0 + pc) * kV;
          float* out = s_val + it * kV;
          if constexpr (kV == 4) {
            const float4 xv = __ldg(reinterpret_cast<const float4*>(xr));
            *reinterpret_cast<float4*>(out) =
                make_float4(S::value(wv, xv.x), S::value(wv, xv.y),
                            S::value(wv, xv.z), S::value(wv, xv.w));
          } else {
            out[0] = S::value(wv, __ldg(xr));
          }
        }
        __syncthreads();
        // Row r's positions at .. end in slot order, piece by piece: the
        // piece's last one found by a binary search, then a tight fold.
        while (mine && at < end && at < v1) {
          for (const int slot = r0 + s_perm[at];
               p < pieces && s_pend[p] <= slot; ++p) {  // pieces before it
            float* out = piece_out(p, s_pdst, s_pdb, y, part, w, bd, k, r,
                                   c * kV);
            if constexpr (kV == 4) {
              *reinterpret_cast<float4*>(out) =
                  make_float4(acc[0], acc[1], acc[2], acc[3]);
            } else {
              out[0] = acc[0];
            }
#pragma unroll
            for (int v = 0; v < kV; ++v) acc[v] = S::identity();
          }
          int lo = at, hi = end;  // the first position past the piece
          const int stop = s_pend[p] - r0;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_perm[mid] < stop) lo = mid + 1; else hi = mid;
          }
          const int lim = min(lo, v1);
#pragma unroll 4
          for (; at < lim; ++at) {
            const float* val = s_val + ((at - v0) * nc + (c - c0)) * kV;
#pragma unroll
            for (int v = 0; v < kV; ++v) acc[v] = S::combine(acc[v], val[v]);
          }
        }
        if (v1 >= i1) break;
        v0 = v1;
      }
      // every piece whose slots this round holds is done for row r
      for (; p < pieces && s_pend[p] <= r1; ++p) {
        if (mine) {
          float* out = piece_out(p, s_pdst, s_pdb, y, part, w, bd, k, r,
                                 c * kV);
          if constexpr (kV == 4) {
            *reinterpret_cast<float4*>(out) =
                make_float4(acc[0], acc[1], acc[2], acc[3]);
          } else {
            out[0] = acc[0];
          }
        }
#pragma unroll
        for (int v = 0; v < kV; ++v) acc[v] = S::identity();
      }
    }
  }
}

// Pass 2: one destination block a thread block: its identity, or its
// windows' partials in window order (kV floats a thread at once), then its
// poisoned rows.
template <bool kMinPlus, int kV>
__global__ void __launch_bounds__(kBlockThreads)
compact_blocks(const float* __restrict__ x, float* __restrict__ y,
               const float* __restrict__ part, const int* __restrict__ pois,
               const int* __restrict__ pois_any,
               const int* __restrict__ bstart, const int* __restrict__ bend,
               const int* __restrict__ list, const int* __restrict__ list_db,
               const int* __restrict__ sbid, const int* __restrict__ tile_ptr,
               const int* __restrict__ tent_row,
               const int* __restrict__ tent_src, int nact, int bd, int k) {
  using S = Semiring<kMinPlus>;
  constexpr int kUnroll = 2;
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
  const int e = bend[b];
  bool hit = false;  // its loads first, in flight beside the combine's
#pragma unroll 4
  for (int pos = s + threadIdx.x; pos < e; pos += kBlockThreads) {
    hit = hit || __ldg(pois_any + __ldg(sbid + __ldg(list + pos))) != 0;
  }
  const int w0 = s / kWin;
  const int w1 = (e - 1) / kWin;
  if (w0 != w1) {  // pass 1 wrote the block when one window held it
    const size_t step = static_cast<size_t>(kBlockThreads) * kV;
    for (size_t base = threadIdx.x * kV; base < width;
         base += step * kUnroll) {
      float acc[kUnroll][kV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t i = base + u * step;
        const float* src =
            part + (static_cast<size_t>(w0) * 2 + 1) * width + i;
        if (i < width) {
          if constexpr (kV == 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src));
            acc[u][0] = v.x, acc[u][1] = v.y, acc[u][2] = v.z, acc[u][3] = v.w;
          } else {
            acc[u][0] = __ldg(src);
          }
        }
      }
      for (int w = w0 + 1; w <= w1; ++w) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const size_t i = base + u * step;
          const float* src = part + static_cast<size_t>(w) * 2 * width + i;
          if (i < width) {
            if constexpr (kV == 4) {
              const float4 v = __ldg(reinterpret_cast<const float4*>(src));
              acc[u][0] = S::combine(acc[u][0], v.x);
              acc[u][1] = S::combine(acc[u][1], v.y);
              acc[u][2] = S::combine(acc[u][2], v.z);
              acc[u][3] = S::combine(acc[u][3], v.w);
            } else {
              acc[u][0] = S::combine(acc[u][0], __ldg(src));
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t i = base + u * step;
        if (i < width) {
#pragma unroll
          for (int v = 0; v < kV; ++v) yb[i + v] = acc[u][v];
        }
      }
    }
  }
  if (!__syncthreads_or(hit)) return;
  // rare: x holds a poisoning value some live tile of the block reads
  for (int pos = s; pos < e; ++pos) {
    const int t = __ldg(list + pos);
    const int sb = __ldg(sbid + t);
    if (__ldg(pois_any + sb) == 0) continue;
    const int beg = __ldg(tile_ptr + t);
    const int end = __ldg(tile_ptr + t + 1);
    for (int kk = 0; kk < k; ++kk) {
      const int want = __ldg(pois + sb * k + kk);
      if (want == 0) continue;
      for (int r = threadIdx.x; r < bd; r += kBlockThreads) {
        if (row_poisoned<kMinPlus>(x, tent_row, tent_src, beg, end, r, kk, k,
                                   want)) {
          yb[static_cast<size_t>(r) * k + kk] = nan_value();
        }
      }
    }
  }
}

template <bool kMinPlus, int kV>
cudaError_t launch_windows(const float* x, float* y, float* part, int* pois,
                           int* pois_any, int* bstart, int* bend,
                           const int* list, const int* list_db,
                           const int* tile_ptr, const int* tent_row,
                           const int* tent_src, const float* tent_w, int nact,
                           int n_src_blocks, int bd, int bs, int k,
                           cudaStream_t s) {
  const int n_windows = (nact + kWin - 1) / kWin;
  const int count_blocks =
      (n_src_blocks + kWinThreads / 32 - 1) / (kWinThreads / 32);
  const size_t smem = window_smem(bd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        compact_windows<kMinPlus, kV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  compact_windows<kMinPlus, kV>
      <<<n_windows + count_blocks, kWinThreads, smem, s>>>(
          x, y, part, pois, pois_any, bstart, bend, list, list_db, tile_ptr,
          tent_row, tent_src, tent_w, nact, n_windows, n_src_blocks, bd, bs,
          k);
  return cudaGetLastError();
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
  int* pois_any = pois + static_cast<size_t>(n_src_blocks) * k;
  int* bstart = pois_any + n_src_blocks;
  int* bend = bstart + n_dst_blocks;
  if (k == 1) {  // the one-lane passes: prep, windows, blocks
    if (nact > 0) {
      const int count_blocks = (n_src_blocks + kCountWarps - 1) / kCountWarps;
      const int list_blocks =
          (nact + kCountWarps * 32 - 1) / (kCountWarps * 32);
      compact_prep1<kMinPlus>
          <<<count_blocks + list_blocks, kCountWarps * 32, 0, s>>>(
              x, pois, pois_any, bstart, bend, list_db, nact, count_blocks,
              n_src_blocks, bs);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      compact_windows1<kMinPlus>
          <<<(nact + kWin - 1) / kWin, kWin1Threads, 0, s>>>(
              x, y, part, pois, list, list_db, sbid, tile_ptr, tent_row,
              tent_src, tent_w, nact, bd, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (n_dst_blocks <= 0) return 0;
    compact_blocks1<kMinPlus><<<n_dst_blocks, kWin1Threads, 0, s>>>(
        y, part, bstart, bend, list_db, nact, bd, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (nact > 0) {
    const bool vec = k % 4 == 0 && aligned16(x) && aligned16(y) &&
                     aligned16(part);
    const cudaError_t err =
        vec ? launch_windows<kMinPlus, 4>(x, y, part, pois, pois_any, bstart,
                                          bend, list, list_db, tile_ptr,
                                          tent_row, tent_src, tent_w, nact,
                                          n_src_blocks, bd, bs, k, s)
            : launch_windows<kMinPlus, 1>(x, y, part, pois, pois_any, bstart,
                                          bend, list, list_db, tile_ptr,
                                          tent_row, tent_src, tent_w, nact,
                                          n_src_blocks, bd, bs, k, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_dst_blocks <= 0) return 0;
  if (k % 4 == 0 && aligned16(y) && aligned16(part)) {
    compact_blocks<kMinPlus, 4><<<n_dst_blocks, kBlockThreads, 0, s>>>(
        x, y, part, pois, pois_any, bstart, bend, list, list_db, sbid,
        tile_ptr, tent_row, tent_src, nact, bd, k);
  } else {
    compact_blocks<kMinPlus, 1><<<n_dst_blocks, kBlockThreads, 0, s>>>(
        x, y, part, pois, pois_any, bstart, bend, list, list_db, sbid,
        tile_ptr, tent_row, tent_src, nact, bd, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B1 (plus_times) / B3 (min_plus): the full schedule over the row payload.
// x [rows of x_blocks, K]; y [n_rows, K]; part [n_segs, K] scratch; pois
// [n_src_blocks, K] and pois_any [n_src_blocks] int scratch; row_seg
// [n_rows+1], seg_ptr [n_segs+1]; ent_tile/ent_src/ent_w [E] the row
// payload; act [T] per-tile activity; dbid/sbid [T] and tile_ptr [T+1],
// tent_row/tent_src [E] for the non-finite rule.  K <= kMaxLanes.
int spmv_rows(const float* x, float* y, float* part, int* pois,
              int* pois_any, const int* row_seg, const int* seg_ptr,
              const int* ent_tile, const int* ent_src, const float* ent_w,
              const int* act, const int* dbid, const int* sbid,
              const int* tile_ptr, const int* tent_row, const int* tent_src,
              int n_rows, int n_segs, int n_tiles, int bd, int n_src_blocks,
              int bs, int k, void* stream) {
  return launch_rows<false>(x, y, part, pois, pois_any, row_seg, seg_ptr,
                            ent_tile, ent_src, ent_w, act, dbid, sbid,
                            tile_ptr, tent_row, tent_src, n_rows, n_segs,
                            n_tiles, bd, n_src_blocks, bs, k, stream);
}

int spmv_rows_min_plus(const float* x, float* y, float* part, int* pois,
                       int* pois_any, const int* row_seg, const int* seg_ptr,
                       const int* ent_tile, const int* ent_src,
                       const float* ent_w, const int* act, const int* dbid,
                       const int* sbid, const int* tile_ptr,
                       const int* tent_row, const int* tent_src, int n_rows,
                       int n_segs, int n_tiles, int bd, int n_src_blocks,
                       int bs, int k, void* stream) {
  return launch_rows<true>(x, y, part, pois, pois_any, row_seg, seg_ptr,
                           ent_tile, ent_src, ent_w, act, dbid, sbid,
                           tile_ptr, tent_row, tent_src, n_rows, n_segs,
                           n_tiles, bd, n_src_blocks, bs, k, stream);
}

// B2 (plus_times) / B4 (min_plus): the compacted live work-list over the
// tile-major payload.  y [n_dst_blocks * bd, K]; part [2 * windows, bd, K]
// scratch (windows = ceil(nact / 32)); ints [(K + 1) * n_src_blocks + 2 *
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
