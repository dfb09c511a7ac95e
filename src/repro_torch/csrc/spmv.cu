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
// B1/B3 (spmv_rows*): the row payload.  A 128x128 tile of an RMAT graph holds
// a few edges, so the dense tiles are >99.9% absent slots: streaming them
// bounds the dense form at 15.7 GB a call on RMAT scale 16.  B1/B3 read only
// the view's row payload instead (ops.row_payload): the non-absent slots as a
// CSR by destination row, 12 bytes an entry (schedule position, x row,
// weight), entries of a row in schedule order, then column.  For each row r
// and lane k
//     y[r, k] = (+) over entries e of r with act[ent_tile[e]] != 0 of
//               ent_w[e] (x) x[ent_src[e], k]
// and a row without a live entry gets the identity.  The sum over the whole
// row equals the reference's per-run sums up to f32 order; min is order-free,
// so B3 equals both plain versions bit for bit.  On an x holding +-inf or NaN
// the dense product gives NaN (0 * inf) on absent slots and the payload skips
// them (ROADMAP §C P12); no caller passes such an x.
//
// Design of B1/B3.  The work is a gather-heavy SpMV: 2 operations and ~12-16
// bytes an entry, far below the f32 ridge, so bytes bound it; x (n K floats)
// and act (4 B a tile) sit in the 50 MB L2.  RMAT rows are skewed (mean ~15
// entries, the hub ~6,000-10,000), so a thread or warp per row would leave
// the hub's warp running long after the rest.  The build cuts every row into
// segments of at most 128 entries (seg_ptr, row_seg).  Pass 1, a group of 16
// lanes a segment (2 a warp: half the rows hold one entry or none, and the
// ~44,000-54,000 segments then fit the card's resident warps about once):
// lane l of the group takes entries l, l + 16, ..., l + 112 of the segment
// with all eight (tile, src, w) loads and then all eight act and x loads in
// flight at once, sums its entries in order, and a fixed xor-shuffle tree
// reduces the group; its lane 0 writes the segment's partial.  Pass 2, one
// thread a (row, lane): combines the row's partials in segment order into y
// (the identity for a row without segments).  No atomics and a fixed order:
// two launches give the same bits.  K > 1 walks the entries once per lane,
// correct rather than fast (K = 1 is PageRank, BFS and WCC).  At RMAT scale
// 16 the bytes allow ~4-7 us; the two launches and each group's chain of
// dependent loads (pointers, entries, then x and act) set the time instead,
// a few times that (PERF.md §6).
//
// B2/B4 (spmv_compact*): the dense live tiles.  One thread block owns one
// 32-row slice of one destination block and walks that block's live tiles in
// schedule order, so no two thread blocks write the same output rows.  Warp w
// owns rows [8w, 8w+8) of the slice; lane l holds columns [4l, 4l+4) of each
// row, so a warp reads a 512-byte tile row as one coalesced 16-byte load per
// lane, eight rows in flight per lane.  A row's reduction is a lane's own 4
// columns then a warp shuffle: plus_times in full f32 (fmaf; no TF32),
// min_plus as fminf over w + x, each sum rounded once.  The run and block
// accumulators sit in shared memory, owned row by row by one lane, and the
// reference's per-run structure is kept: y = ((run_1) (+) run_2) (+) ... .
// Bound: the live tile bytes over 3.35 TB/s (2 operations a 4-byte slot and
// lane).
// min_plus has no tensor-core form (Hopper's DPX min-plus instructions are
// integer only), so every kernel here stays on the CUDA cores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // 32
constexpr int kGroup = 16;      // B1/B3: lanes a segment (2 segments a warp)
constexpr int kSegUnroll = 8;   // entries a lane takes per pass: 128 a group
constexpr int kSegThreads = 256;  // 16 segments a thread block
constexpr int kCombineThreads = 256;

// The two semirings: the accumulator identity (also the value of padding
// slots), one entry's step, one lane's reduction over 4 columns, and the
// combine.
template <bool kMinPlus>
struct Semiring;

template <>
struct Semiring<false> {  // plus_times
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ float step(float acc, float w, float x) {
    return fmaf(w, x, acc);
  }
  static __device__ __forceinline__ float dot4(float4 w, float4 x) {
    return fmaf(w.w, x.w, fmaf(w.z, x.z, fmaf(w.y, x.y, w.x * x.x)));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return a + b;
  }
};

template <>
struct Semiring<true> {  // min_plus
  static __device__ __forceinline__ float identity() { return CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float w, float x) {
    return fminf(acc, __fadd_rn(w, x));
  }
  static __device__ __forceinline__ float dot4(float4 w, float4 x) {
    return fminf(fminf(__fadd_rn(w.x, x.x), __fadd_rn(w.y, x.y)),
                 fminf(__fadd_rn(w.z, x.z), __fadd_rn(w.w, x.w)));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fminf(a, b);
  }
};

// ---------------------------------------------------------------- B1 / B3
// Pass 1: one group of kGroup lanes a segment [seg_ptr[s], seg_ptr[s+1]) of
// one row's entries; part[s, k] = the segment's (+) over its live entries.
template <bool kMinPlus>
__global__ void __launch_bounds__(kSegThreads)
spmv_segments(const float* __restrict__ x, float* __restrict__ part,
              const int* __restrict__ seg_ptr,
              const int* __restrict__ ent_tile,
              const int* __restrict__ ent_src,
              const float* __restrict__ ent_w, const int* __restrict__ act,
              int n_segs, int k) {
  using S = Semiring<kMinPlus>;
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

template <bool kMinPlus>
int launch_rows(const float* x, float* y, float* part, const int* row_seg,
                const int* seg_ptr, const int* ent_tile, const int* ent_src,
                const float* ent_w, const int* act, int n_rows, int n_segs,
                int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_segs > 0) {
    constexpr int kSegsPerCta = kSegThreads / kGroup;
    spmv_segments<kMinPlus>
        <<<(n_segs + kSegsPerCta - 1) / kSegsPerCta, kSegThreads, 0, s>>>(
            x, part, seg_ptr, ent_tile, ent_src, ent_w, act, n_segs, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t outs = static_cast<size_t>(n_rows) * k;
  if (outs == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((outs + kCombineThreads - 1) / kCombineThreads);
  combine_segments<kMinPlus><<<blocks, kCombineThreads, 0, s>>>(
      part, y, row_seg, n_rows, k);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- B2 / B4
// One (destination block, 32-row slice) per thread block.
//   ptr[b]..ptr[b+1]  the block's live tiles in `list` (schedule order)
//   run_first         per list position: 1 where a live run starts
template <bool kMinPlus>
__global__ void __launch_bounds__(kWarps * 32)
spmv_runs(const float* __restrict__ tiles, const float* __restrict__ x,
          float* __restrict__ y, const int* __restrict__ ptr,
          const int* __restrict__ list, const int* __restrict__ run_first,
          const int* __restrict__ sbid, int bd, int bs, int k) {
  using S = Semiring<kMinPlus>;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRowsPerCta + warp * kRowsPerWarp;
  const int nvals = kRowsPerWarp * k;
  float* acc = smem + warp * nvals;                       // this run
  float* ysum = smem + kRowsPerCta * k + warp * nvals;    // earlier runs
  const float ident = S::identity();
  const float4 pad = make_float4(ident, ident, ident, ident);

  for (int j = lane; j < nvals; j += 32) {
    acc[j] = ident;
    ysum[j] = ident;
  }
  __syncwarp();

  const int beg = ptr[b];
  const int end = ptr[b + 1];
  const int col = lane * 4;
  const bool col_ok = col < bs;
  const size_t tile_elems = static_cast<size_t>(bd) * bs;

  for (int i = beg; i < end; ++i) {
    const int t = list[i];
    if (run_first[i] && i > beg) {  // close the previous run: y (+)= acc
      for (int j = lane; j < nvals; j += 32) {
        ysum[j] = S::combine(ysum[j], acc[j]);
        acc[j] = ident;
      }
      __syncwarp();
    }

    const float* tp = tiles + static_cast<size_t>(t) * tile_elems +
                      static_cast<size_t>(row0) * bs + col;
    const float* xb = x + static_cast<size_t>(sbid[t]) * bs * k;
    float4 rv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      rv[r] = (col_ok && row0 + r < bd)
                  ? __ldg(reinterpret_cast<const float4*>(
                        tp + static_cast<size_t>(r) * bs))
                  : pad;
    }
    for (int kk = 0; kk < k; ++kk) {
      float4 xv = pad;
      if (col_ok) {
        if (k == 1) {
          xv = __ldg(reinterpret_cast<const float4*>(xb + col));
        } else {
          xv.x = __ldg(xb + (col + 0) * k + kk);
          xv.y = __ldg(xb + (col + 1) * k + kk);
          xv.z = __ldg(xb + (col + 2) * k + kk);
          xv.w = __ldg(xb + (col + 3) * k + kk);
        }
      }
      float s[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = S::dot4(rv[r], xv);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          s[r] = S::combine(s[r], __shfl_xor_sync(0xffffffffu, s[r], off));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          acc[r * k + kk] = S::combine(acc[r * k + kk], s[r]);
        }
      }
    }
    __syncwarp();
  }
  __syncwarp();

  for (int j = lane; j < nvals; j += 32) {
    const int row = row0 + j / k;
    if (row < bd) {
      y[(static_cast<size_t>(b) * bd + row) * k + j % k] =
          S::combine(ysum[j], acc[j]);
    }
  }
}

template <bool kMinPlus>
int launch_runs(const float* tiles, const float* x, float* y, const int* ptr,
                const int* list, const int* run_first, const int* sbid,
                int n_dst_blocks, int bd, int bs, int k, void* stream) {
  if (n_dst_blocks <= 0) return 0;
  const dim3 grid(n_dst_blocks, (bd + kRowsPerCta - 1) / kRowsPerCta);
  const size_t smem = 2 * static_cast<size_t>(kRowsPerCta) * k * sizeof(float);
  spmv_runs<kMinPlus>
      <<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          tiles, x, y, ptr, list, run_first, sbid, bd, bs, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B1 (plus_times) / B3 (min_plus): the full schedule over the row payload.
// x [rows of x_blocks, K]; y [n_rows, K]; part [n_segs, K] scratch;
// row_seg [n_rows+1], seg_ptr [n_segs+1]; ent_tile/ent_src/ent_w [E];
// act [T] per-tile activity.
int spmv_rows(const float* x, float* y, float* part, const int* row_seg,
              const int* seg_ptr, const int* ent_tile, const int* ent_src,
              const float* ent_w, const int* act, int n_rows, int n_segs,
              int k, void* stream) {
  return launch_rows<false>(x, y, part, row_seg, seg_ptr, ent_tile, ent_src,
                            ent_w, act, n_rows, n_segs, k, stream);
}

int spmv_rows_min_plus(const float* x, float* y, float* part,
                       const int* row_seg, const int* seg_ptr,
                       const int* ent_tile, const int* ent_src,
                       const float* ent_w, const int* act, int n_rows,
                       int n_segs, int k, void* stream) {
  return launch_rows<true>(x, y, part, row_seg, seg_ptr, ent_tile, ent_src,
                           ent_w, act, n_rows, n_segs, k, stream);
}

// B2 (plus_times) / B4 (min_plus): the compacted live work-list grouped by
// block.  seg_ptr [nDB+1] / seg_tiles [nact] list each block's live tiles in
// schedule order; seg_first [nact] marks the starts of live runs.
int spmv_compact(const float* tiles, const float* x, float* y,
                 const int* seg_ptr, const int* seg_tiles,
                 const int* seg_first, const int* sbid, int n_dst_blocks,
                 int bd, int bs, int k, void* stream) {
  return launch_runs<false>(tiles, x, y, seg_ptr, seg_tiles, seg_first, sbid,
                            n_dst_blocks, bd, bs, k, stream);
}

int spmv_compact_min_plus(const float* tiles, const float* x, float* y,
                          const int* seg_ptr, const int* seg_tiles,
                          const int* seg_first, const int* sbid,
                          int n_dst_blocks, int bd, int bs, int k,
                          void* stream) {
  return launch_runs<true>(tiles, x, y, seg_ptr, seg_tiles, seg_first, sbid,
                           n_dst_blocks, bd, bs, k, stream);
}

}  // extern "C"
