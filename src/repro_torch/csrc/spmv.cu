// Blocked plus_times SpMV over dense edge tiles: kernels B1 and B2 for Hopper.
//
// Replaces the Pallas TPU kernels of repro/kernels/spmv/kernel.py:
//   B1  spmv_pallas          body _kernel_plus_times          (kernel.py:86-110)
//   B2  spmv_pallas_compact  body _kernel_plus_times_compact  (kernel.py:199-224)
//
// What they compute.  Tiles [T, Bd, Bs] f32 are streamed in a schedule whose
// consecutive tiles of one destination block form *runs*.  Per run, a (Bd, K)
// accumulator starts at zero and gains tiles[t] @ x_blocks[sbid[t]] for each
// active tile t; at the run's end the block's first run writes y, later runs
// add into it.  B1 walks every tile (skipping inactive ones), B2 only the live
// work-list of the compacted schedule.
//
// Design.  The TPU kernel carries its accumulator along a sequential grid.
// Here one thread block owns one 32-row slice of one destination block and
// walks that block's tiles in schedule order, so no two thread blocks write
// the same output rows: no atomics, and the result is the same on every run.
// Inside a thread block, warp w owns rows [8w, 8w+8) of the slice; lane l
// holds columns [4l, 4l+4) of each row, so a warp reads a 512-byte tile row
// as one coalesced 16-byte load per lane, eight rows in flight per lane.  A
// row's dot product is reduced across the warp with shuffles, in full f32
// (fmaf; no TF32, no bf16), and added to the run accumulator.  The
// accumulators (run and block) sit in shared memory, owned row by row by one
// lane, so they need no synchronisation beyond __syncwarp.  The per-run
// structure of the reference is kept: y = ((run_1) + run_2) + ... .
//
// Bound.  The work is a GEMV (K = 1: PageRank, single-source BFS) or a skinny
// GEMM (K lanes) over the live tiles: 2 flops per 4-byte tile slot and lane,
// far below the ~20 FLOP/byte ridge of f32 (67 TFLOP/s over 3.35 TB/s), so
// the card's memory rate bounds it: live tile bytes / 3.35 TB/s (x and y are
// O(n K), small beside the tiles).  The design answers that bound by reading
// each live tile byte once, coalesced, with many loads in flight (eight
// 16-byte loads per thread, 128 threads per thread block, 7-8 thread blocks
// per SM at the 64-72 registers ptxas reports) and no second pass over y.
// Inactive tiles of B1 cost one flag read; B2 does not visit them at all.
// Not yet done: TMA/cp.async pipelining and wgmma, which later work may add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // 32

// One (destination block, 32-row slice) per thread block.
//   ptr[b]..ptr[b+1]  the block's entries in `list` (tile ids, schedule order)
//   run_first         B1: indexed by tile id (the schedule's `first` flags)
//                     B2: indexed by list position (recomputed live flags)
//   act               B1 only: per-tile activity flags
template <bool kCompact>
__global__ void __launch_bounds__(kWarps * 32)
spmv_runs(const float* __restrict__ tiles, const float* __restrict__ x,
          float* __restrict__ y, const int* __restrict__ ptr,
          const int* __restrict__ list, const int* __restrict__ run_first,
          const int* __restrict__ sbid, const int* __restrict__ act, int bd,
          int bs, int k) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRowsPerCta + warp * kRowsPerWarp;
  const int nvals = kRowsPerWarp * k;
  float* acc = smem + warp * nvals;                       // this run
  float* ysum = smem + kRowsPerCta * k + warp * nvals;    // earlier runs

  for (int j = lane; j < nvals; j += 32) {
    acc[j] = 0.f;
    ysum[j] = 0.f;
  }
  __syncwarp();

  const int beg = ptr[b];
  const int end = ptr[b + 1];
  const int col = lane * 4;
  const bool col_ok = col < bs;
  const size_t tile_elems = static_cast<size_t>(bd) * bs;

  for (int i = beg; i < end; ++i) {
    const int t = list[i];
    const int starts_run = kCompact ? run_first[i] : run_first[t];
    if (starts_run && i > beg) {  // close the previous run: y += acc
      for (int j = lane; j < nvals; j += 32) {
        ysum[j] += acc[j];
        acc[j] = 0.f;
      }
      __syncwarp();
    }
    if (!kCompact && act[t] == 0) continue;

    const float* tp = tiles + static_cast<size_t>(t) * tile_elems +
                      static_cast<size_t>(row0) * bs + col;
    const float* xb = x + static_cast<size_t>(sbid[t]) * bs * k;
    float4 rv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      rv[r] = (col_ok && row0 + r < bd)
                  ? __ldg(reinterpret_cast<const float4*>(
                        tp + static_cast<size_t>(r) * bs))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int kk = 0; kk < k; ++kk) {
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
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
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(rv[r].w, xv.w,
                    fmaf(rv[r].z, xv.z, fmaf(rv[r].y, xv.y, rv[r].x * xv.x)));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r * k + kk] += s[r];
      }
    }
    __syncwarp();
  }
  __syncwarp();

  for (int j = lane; j < nvals; j += 32) {
    const int row = row0 + j / k;
    if (row < bd) {
      y[(static_cast<size_t>(b) * bd + row) * k + j % k] = ysum[j] + acc[j];
    }
  }
}

int launch(bool compact, const float* tiles, const float* x, float* y,
           const int* ptr, const int* list, const int* run_first,
           const int* sbid, const int* act, int n_dst_blocks, int bd, int bs,
           int k, cudaStream_t stream) {
  if (n_dst_blocks <= 0) return 0;
  const dim3 grid(n_dst_blocks, (bd + kRowsPerCta - 1) / kRowsPerCta);
  const size_t smem = 2 * static_cast<size_t>(kRowsPerCta) * k * sizeof(float);
  if (compact) {
    spmv_runs<true><<<grid, kWarps * 32, smem, stream>>>(
        tiles, x, y, ptr, list, run_first, sbid, act, bd, bs, k);
  } else {
    spmv_runs<false><<<grid, kWarps * 32, smem, stream>>>(
        tiles, x, y, ptr, list, run_first, sbid, act, bd, bs, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B1: the full schedule.  blk_ptr [nDB+1] / blk_tiles [T] list each block's
// tiles in schedule order; first [T] marks run starts; act [T] activity.
int spmv_full(const float* tiles, const float* x, float* y, const int* blk_ptr,
              const int* blk_tiles, const int* first, const int* sbid,
              const int* act, int n_dst_blocks, int bd, int bs, int k,
              void* stream) {
  return launch(false, tiles, x, y, blk_ptr, blk_tiles, first, sbid, act,
                n_dst_blocks, bd, bs, k, static_cast<cudaStream_t>(stream));
}

// B2: the compacted live work-list grouped by block.  seg_ptr [nDB+1] /
// seg_tiles [nact] list each block's live tiles in schedule order;
// seg_first [nact] marks the starts of live runs.
int spmv_compact(const float* tiles, const float* x, float* y,
                 const int* seg_ptr, const int* seg_tiles,
                 const int* seg_first, const int* sbid, int n_dst_blocks,
                 int bd, int bs, int k, void* stream) {
  return launch(true, tiles, x, y, seg_ptr, seg_tiles, seg_first, sbid,
                nullptr, n_dst_blocks, bd, bs, k,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
