// B5: one-token grouped-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn/kernel.py:
// _kernel (line 44), launched by decode_attn_pallas (line 99, pallas_call at
// line 146).  For each row b and KV head h it computes, over the cache slots
// t whose stored position is live (0 <= pos <= cur, and pos > cur - window
// when window > 0),
//
//     s[g, t] = (q[b, h, g, :] . k[b, t, h, :]) * hd^-0.5
//     out[b, h, g, :] = sum_t softmax_t(s[g, :]) v[b, t, h, :]
//
// with the reference's online softmax: out = acc / max(l, 1e-30), so a row
// with no live slot gives 0.
//
// What bounds it on this card: bytes.  Each K/V element (2 bytes in bf16) is
// used by the G query heads of its KV head, 2 operations each in q.k and 2 in
// p.v: at gemma-2b's G=8 that is 8 operations a byte, against the ~295 a
// byte at which an H100's bf16 tensor cores, not its 3.35 TB/s memory, would
// be the limit.  So the least time is the live K/V blocks' bytes over the
// memory rate (4.3 GB at B=128, T=32768, hd=256: 1.288 ms).
//
// The bf16 kernel (decode_attn_ring), and what it does about that bound:
//   * A ring of kStages stages in shared memory, each holding kStage = 16
//     cache slots of K and V for one (row, KV head), filled by one producer
//     warp with two TMA copies a stage (cp.async.bulk.tensor, one box each of
//     K and V: 8 KB at hd=256), completing on a full mbarrier per stage.  Up
//     to kStages * 16 slots are in flight while the consumer warps compute;
//     no __syncthreads runs between the first stage and the last.  The box
//     lands segment-major with the TMA's swizzle (128-byte segments where hd
//     allows), so the eight slots an ldmatrix phase reads at one column fall
//     on eight distinct bank groups.  The tensor maps are encoded on the host
//     (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint) once
//     per cache address and shape, and passed as __grid_constant__ values.
//     (A copy per 512-byte slot row, tried first, could not keep up with the
//     memory; scripts/b5_probe.py times the copy path alone.)
//   * Block skipping (the paper's "limit superfluous reads"): the producer
//     reads the stored positions of 32 chunks (a lane each, prefetched one
//     group ahead) and tests them itself, in place of the TPU's
//     scalar-prefetched "needed" bits.  A chunk with no live slot is neither
//     read nor computed, so neither is a cache block with no live slot.  The
//     live mask of a copied chunk rides in the stage.  A ragged chunk (a
//     cache block not a multiple of 16 slots) is copied by the producer warp
//     itself, zeros past its end, so no slot outside it is read.
//   * Tensor cores for both products (mma.sync m16n8k16, bf16 in, f32
//     accumulate) in the FlashAttention-2 register layout: the G query heads,
//     padded with zero rows to 16, are the A operand of S = q.K^T (re-read
//     from shared memory each k-step, so they cost no registers); K is the B
//     operand through ldmatrix; S's accumulators become the A operand of P.V
//     with V through ldmatrix.trans, so the softmax's row max and sum need
//     only quad shuffles.  P is f32: it is split as p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi), two mma a step, so P.V keeps ~16 bits of p (bf16 V is
//     exact): the error stays near 2^-18 of |v| against the f32 plain
//     version, where rounding p to bf16 alone would cost ~4e-3.  Each head_dim
//     (a multiple of 16 up to 256) is its own instantiation, so no column
//     step is guarded at run time (a guard keeps the compiler from running
//     the next step's ldmatrix ahead of this step's mma).
//   * Stage i goes to consumer warp i % kConsumers (the ring is 2 *
//     kConsumers deep, so a warp always uses the same two stages); each warp
//     keeps its own (m, l, acc), rescales acc only when a row max moved, and
//     the warps merge in warp order at the end.
//   * Flash-decoding split sized from the card: the wrapper splits each row's
//     chunks over `nsplit` thread blocks, interleaved (split s takes chunks s,
//     s + nsplit, ...) so that a dead prefix or suffix of the cache idles no
//     thread block, choosing nsplit from the SM count and the blocks an SM
//     holds (decode_attn_bf16_ctas_per_sm).  With nsplit > 1 each block
//     writes its (m, l, acc) to a workspace and the last block of its (row,
//     KV head) to finish, found by an atomic ticket it resets itself, merges
//     them in split order:
//       M = max m_s,  L = sum l_s e^(m_s - M),  out = (sum acc_s e^(m_s - M))
//       / max(L, 1e-30).
//     One launch a call; every order is fixed, so two launches are bit-equal.
//     An empty range leaves m = -2e38, l = 0, acc = 0 and adds nothing; if
//     every range is empty, out = 0 as in one pass.
//
// Before this design (PR 13's kernel, CUDA cores, 16-byte loads, a
// __syncthreads per block and a second merge launch), on an H100 80GB HBM3 at
// 700 W: 4.426 ms at decode_32k against SDPA's 2.522 ms, and 0.0594 ms a call
// at the serve shape (B=4, T=1024).
//
// The f32 entry (decode_attn_f32, not on the serve path: gemma-2b serves bf16)
// keeps that earlier CUDA-core body (decode_attn_split + decode_attn_merge).
//
// Layouts (all contiguous): q [B, KV, G, hd], k/v [B, T, KV, hd] of the same
// element type, pos [B, T] int32, cur [B] int32, out [B, KV, G, hd] f32.  The
// workspace `work` (f32, when nsplit > 1 or for f32) holds acc partials
// [B, KV, nsplit, G, hd], then m and l partials [B, KV, nsplit, G] each;
// `tickets` [B * KV] int32 starts at 0 and is left at 0.  Limits checked by
// the wrapper: G <= 16; bf16 hd a multiple of 16 up to 256, f32 hd a
// multiple of 4 up to 256; T % block_t == 0; 16-byte aligned k, v; at most
// 32 splits (the merge stages every split's m and l in the ring).

#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNegInf = -2.0e38f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// ------------------------------------------------- bf16: the ring kernel

namespace ring {

constexpr int kStage = 16;                   // cache slots a stage holds
constexpr int kConsumers = 4;                // consumer warps
constexpr int kStages = 2 * kConsumers;      // ring depth
constexpr int kThreads = (kConsumers + 1) * 32;  // + one producer warp
constexpr int kGroup = 32;  // chunks whose positions the producer tests at once

// Columns a swizzle segment of a K/V row holds (its TMA box's inner
// dimension): 128-byte segments where hd allows, else 64 or 32 bytes.
__host__ __device__ constexpr int seg_cols(int hd) {
  return hd % 64 == 0 ? 64 : hd % 32 == 0 ? 32 : 16;
}

// A K or V stage, 16 slots x hd columns, is laid out as the TMA box (seg
// cols, 16 slots, hd / seg segments) lands it: segment-major, a 2*seg-byte
// line a slot, and the 16-byte units of each 128-byte span XORed with its
// span index (the TMA's 2*seg-byte swizzle), so the eight slots an ldmatrix
// phase reads at one column fall on eight distinct bank groups.
template <int SEG>
__host__ __device__ constexpr uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (SEG / 8 - 1)) << 4);
}

// Dynamic shared memory: 1024 bytes of alignment slack, the ring (kStages x
// (K, V) x 16 slots x hd bf16), q (16 rows of 2*hd + 16 bytes: padded so
// that ldmatrix's rows fall on distinct bank groups), a full and an empty
// mbarrier a stage, each stage's slot count and live mask, and one flag.
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return 1024 + static_cast<size_t>(kStages) * 64 * hd + 16 * (2 * hd + 16) +
         kStages * (2 * sizeof(uint64_t) + 2 * sizeof(int)) + 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The TMA box at coordinates (0, row, 0, head) of `map` into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int row, int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(0),
      "r"(head), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b: a 16x16 bf16 (rows: heads), b 16x8 bf16, d 16x8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float4 axpy4(float4 a, float f, float4 x) {
  a.x = fmaf(x.x, f, a.x);
  a.y = fmaf(x.y, f, a.y);
  a.z = fmaf(x.z, f, a.z);
  a.w = fmaf(x.w, f, a.w);
  return a;
}

__device__ __forceinline__ float4 scale4(float4 a, float r) {
  return make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
}

// Grid (nsplit, KV, B), kThreads threads, smem_bytes(HD) of dynamic shared
// memory; `km`/`vm` are the tensor maps of encode_maps.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    decode_attn_ring(const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm,
                     const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ pos, const int* __restrict__ cur,
                     float* __restrict__ work, int* __restrict__ tickets,
                     float* __restrict__ out, int t_len, int kv, int G,
                     int bt, int window, float scale) {
  constexpr int SEG = seg_cols(HD);
  constexpr int KV_BYTES = kStage * 2 * HD;  // a K (or V) stage
  constexpr int RS = 2 * HD + 16;            // a q row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_p =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_p = ring_p + kStages * 2 * KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(q_p + 16 * RS);
  uint64_t* empty = full + kStages;
  int* meta_n = reinterpret_cast<int*>(empty + kStages);
  unsigned* meta_mask = reinterpret_cast<unsigned*>(meta_n + kStages);
  int* is_last = reinterpret_cast<int*>(meta_mask + kStages);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = b * kv + h;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int cpb = (bt + kStage - 1) / kStage;  // chunks a cache block
  const int total = (t_len / bt) * cpb;        // chunks a row
  const int mine = split < total ? (total - split + nsplit - 1) / nsplit : 0;

  float acc[HD / 8][4];  // P.V, 16 heads x HD columns, 8 a tile
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads gid, gid+8
  const int quad = lane & 3, gid = lane >> 2;

  if (warp == kConsumers) {
    // ---- producer: test each chunk's positions, copy the live ones.
    const int c = cur[b];
    const int* pb = pos + static_cast<size_t>(b) * t_len;
    const size_t row = static_cast<size_t>(kv) * HD;  // elements a slot
    const __nv_bfloat16* kb =
        k + static_cast<size_t>(b) * t_len * row + static_cast<size_t>(h) * HD;
    const __nv_bfloat16* vb =
        v + static_cast<size_t>(b) * t_len * row + static_cast<size_t>(h) * HD;

    // This lane's chunk of the group starting at gb: first slot, count.
    auto chunk = [&](int gb, int& t0, int& n) {
      const int i = gb + lane;
      t0 = 0;
      n = 0;
      if (i < mine) {
        const int ci = split + i * nsplit;
        const int blk = ci / cpb, j = ci - blk * cpb;
        t0 = blk * bt + j * kStage;
        n = min(kStage, bt - j * kStage);
      }
    };
    int pv[kStage];
    auto load = [&](int gb) {
      int t0, n;
      chunk(gb, t0, n);
#pragma unroll
      for (int s = 0; s < kStage; ++s) pv[s] = s < n ? __ldg(pb + t0 + s) : -1;
    };

    load(0);
    int seq = 0;
    for (int gb = 0; gb < mine; gb += kGroup) {
      int t0, n;
      chunk(gb, t0, n);
      unsigned mask = 0;
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int p = pv[s];
        const bool ok = p >= 0 && p <= c && (window <= 0 || p > c - window);
        mask |= static_cast<unsigned>(ok) << s;
      }
      if (gb + kGroup < mine) load(gb + kGroup);  // in flight meanwhile
      unsigned live = __ballot_sync(kFull, mask != 0);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const unsigned cm = __shfl_sync(kFull, mask, src);
        const int ct0 = __shfl_sync(kFull, t0, src);
        const int cn = __shfl_sync(kFull, n, src);
        const int st = seq % kStages;
        unsigned char* stage = ring_p + st * 2 * KV_BYTES;
        const uint32_t bar = smem_u32(&full[st]);
        mbar_wait(smem_u32(&empty[st]), ((seq / kStages) & 1) ^ 1);
        if (lane == 0) {
          meta_n[st] = cn;
          meta_mask[st] = cm;
        }
        if (cn == kStage) {  // a whole chunk: one TMA box each of K and V
          if (lane == 0) {
            mbar_arrive_expect_tx(bar, 2 * KV_BYTES);
            tma_load(smem_u32(stage), &km, b * t_len + ct0, h, bar);
            tma_load(smem_u32(stage + KV_BYTES), &vm, b * t_len + ct0, h,
                     bar);
          }
        } else {
          // A ragged chunk (bt % 16 != 0): the warp copies its rows in the
          // swizzled layout itself and zeros the rest, so no slot outside
          // the chunk is read and P.V's p = 0 rows meet finite values.
          for (int i = lane; i < 2 * kStage * (HD / 8); i += 32) {
            const int rr = i / (HD / 8), u = i - rr * (HD / 8);
            const int r = rr % kStage;
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (r < cn)
              x = *reinterpret_cast<const uint4*>(
                  (rr < kStage ? kb : vb) +
                  static_cast<size_t>(ct0 + r) * row + u * 8);
            const uint32_t off = (u / (SEG / 8)) * 32 * SEG + r * 2 * SEG +
                                 (u % (SEG / 8)) * 16;
            *reinterpret_cast<uint4*>(stage + (rr / kStage) * KV_BYTES +
                                      swizzle<SEG>(off)) = x;
          }
          // order these writes before the TMA writes that reuse the stage
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(bar);
        }
        __syncwarp();
        ++seq;
      }
    }
    for (int i = 0; i < kConsumers; ++i, ++seq) {  // an end mark a consumer
      const int st = seq % kStages;
      mbar_wait(smem_u32(&empty[st]), ((seq / kStages) & 1) ^ 1);
      if (lane == 0) {
        meta_n[st] = 0;
        mbar_arrive(smem_u32(&full[st]));
      }
      __syncwarp();
    }
  } else {
    // ---- consumers: q into shared memory as bf16 rows 0..15 (rows G..15
    // zero) while the producer's first copies are in flight.
    const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * G * HD;
    for (int i = tid; i < 16 * HD; i += kConsumers * 32) {
      const int g = i / HD, col = i - g * HD;
      reinterpret_cast<__nv_bfloat16*>(q_p + g * RS)[col] =
          g < G ? qb[g * HD + col] : __float2bfloat16(0.f);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 32) : "memory");

    // Warp w takes stages w, w + kConsumers, ...  ldmatrix lane roles:
    // matrix j = lane / 8, its row r8.  K (non-transposed) matrix j holds
    // slots (j / 2) * 8 + r8 at column block 2 * kk + j % 2; V (transposed)
    // slots (j % 2) * 8 + r8 at column block 2 * np + j / 2.
    const int j = lane >> 3, r8 = lane & 7;
    const uint32_t q_addr =
        smem_u32(q_p) + ((j & 1) * 8 + r8) * RS + (j >> 1) * 16;
    const uint32_t k_row = ((j >> 1) * 8 + r8) * 2 * SEG;
    const uint32_t k_x = (j & 1) ^ ((k_row >> 7) & (SEG / 8 - 1));
    const uint32_t v_row = ((j & 1) * 8 + r8) * 2 * SEG;
    const uint32_t v_x = (j >> 1) ^ ((v_row >> 7) & (SEG / 8 - 1));
    const uint32_t ring0 = smem_u32(ring_p);
    for (int seq = warp;; seq += kConsumers) {
      const int st = seq % kStages;
      mbar_wait(smem_u32(&full[st]), (seq / kStages) & 1);
      if (meta_n[st] == 0) break;
      const unsigned mask = meta_mask[st];
      const uint32_t kbase = ring0 + st * 2 * KV_BYTES;
      const uint32_t vbase = kbase + KV_BYTES;

      // S = q . K^T: 16 heads x 16 slots (two 8-slot tiles).
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        constexpr int U = SEG / 8;  // 16-byte units a segment line
        const uint32_t seg_off = (2 * kk / U) * 32 * SEG;
        uint32_t a[4], bk[4];
        ldsm_x4(a, q_addr + kk * 32);
        ldsm_x4(bk, kbase + seg_off + k_row + (((2 * kk % U) ^ k_x) << 4));
        mma(s[0], a, bk[0], bk[1]);
        mma(s[1], a, bk[2], bk[3]);
      }

      // Online softmax.  Element e of tile jn: head gid + 8 * (e >> 1),
      // slot jn * 8 + 2 * quad + (e & 1); dead slots give p = 0.
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = jn * 8 + 2 * quad + (e & 1);
          const float x = (mask >> slot) & 1u ? s[jn][e] * scale : kNegInf;
          s[jn][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = jn * 8 + 2 * quad + (e & 1);
          const float p = (mask >> slot) & 1u
                              ? expf(s[jn][e] - (e < 2 ? mn0 : mn1))
                              : 0.f;
          s[jn][e] = p;
          if (e < 2)
            sum0 += p;
          else
            sum1 += p;
        }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      if (__any_sync(kFull, al0 != 1.f || al1 != 1.f)) {  // a max moved
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          acc[nt][0] *= al0;
          acc[nt][1] *= al0;
          acc[nt][2] *= al1;
          acc[nt][3] *= al1;
        }
      }

      // P as the A operand (k = slots), split into bf16 hi and lo parts.
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);

      // acc += P . V, 16 columns (two 8-column tiles) an ldmatrix.
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        constexpr int U = SEG / 8;
        const uint32_t seg_off = (2 * np / U) * 32 * SEG;
        uint32_t bv[4];
        ldsm_x4_trans(bv,
                      vbase + seg_off + v_row + (((2 * np % U) ^ v_x) << 4));
        mma(acc[2 * np], pl, bv[0], bv[1]);
        mma(acc[2 * np], ph, bv[0], bv[1]);
        mma(acc[2 * np + 1], pl, bv[2], bv[3]);
        mma(acc[2 * np + 1], ph, bv[2], bv[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
    }
    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
  }
  __syncthreads();  // the ring is free: it holds the warps' partials now

  float* red = reinterpret_cast<float*>(ring_p);  // [kConsumers][G][HD]
  float* red_m = red + kConsumers * G * HD;        // [kConsumers][16]
  float* red_l = red_m + kConsumers * 16;
  if (warp < kConsumers) {
    float* rw = red + warp * G * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + 2 * quad;
      if (gid < G) {
        rw[gid * HD + col] = acc[nt][0];
        rw[gid * HD + col + 1] = acc[nt][1];
      }
      if (gid + 8 < G) {
        rw[(gid + 8) * HD + col] = acc[nt][2];
        rw[(gid + 8) * HD + col + 1] = acc[nt][3];
      }
    }
    if (quad == 0) {
      red_m[warp * 16 + gid] = m0;
      red_m[warp * 16 + gid + 8] = m1;
      red_l[warp * 16 + gid] = l0;
      red_l[warp * 16 + gid + 8] = l1;
    }
  }
  __syncthreads();

  // Merge the warps in warp order: into out (one split) or the workspace.
  const size_t rows_all = static_cast<size_t>(gridDim.z) * kv * nsplit * G;
  float* acc_part = work;
  float* m_part = work + rows_all * HD;
  float* l_part = m_part + rows_all;
  constexpr int HD4 = HD / 4;
  const size_t self = (static_cast<size_t>(bh) * nsplit + split) * G;
  for (int i = tid; i < G * HD4; i += kThreads) {
    const int g = i / HD4, c4 = i - g * HD4;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) M = fmaxf(M, red_m[w * 16 + g]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float f = expf(red_m[w * 16 + g] - M);
      L = fmaf(red_l[w * 16 + g], f, L);
      A = axpy4(A, f,
                reinterpret_cast<const float4*>(red + (w * G + g) * HD)[c4]);
    }
    if (nsplit == 1) {
      // times 1 / max(L, 1e-30): one division an element, not four (an
      // empty row's 0 / 1e-30 takes the division's slow path)
      reinterpret_cast<float4*>(out)[(static_cast<size_t>(bh) * G + g) * HD4 +
                                     c4] = scale4(A, 1.f / fmaxf(L, 1e-30f));
    } else {
      reinterpret_cast<float4*>(acc_part)[(self + g) * HD4 + c4] = A;
      if (c4 == 0) {
        m_part[self + g] = M;
        l_part[self + g] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // The last block of this (row, KV head) merges the splits in split order.
  __threadfence();
  __syncthreads();
  if (tid == 0) *is_last = atomicAdd(&tickets[bh], 1) == nsplit - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  // Every split's (m, l) in one pass, then each head's weights e^(m_s - M)
  // and 1 / max(L, 1e-30) from shared memory.
  float* fs = reinterpret_cast<float*>(ring_p);  // [nsplit][16] m, weights
  float* ls = fs + nsplit * 16;                   // [nsplit][16] l
  float* inv = ls + nsplit * 16;                  // [16] 1 / max(L, 1e-30)
  const size_t first = static_cast<size_t>(bh) * nsplit * G;
  for (int i = tid; i < nsplit * G; i += kThreads) {
    const int s = i / G, g = i - s * G;
    fs[s * 16 + g] = __ldcg(m_part + first + i);
    ls[s * 16 + g] = __ldcg(l_part + first + i);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, fs[s * 16 + g]);
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float f = expf(fs[s * 16 + g] - M);
      fs[s * 16 + g] = f;
      L = fmaf(ls[s * 16 + g], f, L);
    }
    inv[g] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // acc in split order, eight splits' loads in flight at a time.
  const float4* acc4 = reinterpret_cast<const float4*>(acc_part);
  const size_t split_stride = static_cast<size_t>(G) * HD4;
  for (int i = tid; i < G * HD4; i += kThreads) {
    const int g = i / HD4, c4 = i - g * HD4;
    const float4* p = acc4 + (first + g) * HD4 + c4;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    int s = 0;
    for (; s + 8 <= nsplit; s += 8) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = __ldcg(p + (s + u) * split_stride);
#pragma unroll
      for (int u = 0; u < 8; ++u) A = axpy4(A, fs[(s + u) * 16 + g], x[u]);
    }
    for (; s < nsplit; ++s)
      A = axpy4(A, fs[s * 16 + g], __ldcg(p + s * split_stride));
    reinterpret_cast<float4*>(out)[(static_cast<size_t>(bh) * G + g) * HD4 +
                                   c4] = scale4(A, inv[g]);
  }
  if (tid == 0) tickets[bh] = 0;
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a [B, T, KV, hd] bf16 cache whose box is one K or V
// stage of decode_attn_ring: dimensions (seg columns, B*T slots, hd / seg
// segments, KV heads), box (seg, 16, hd / seg, 1), the 2*seg-byte swizzle.
int encode_map(CUtensorMap* map, const void* base, int B, int t_len, int kv,
               int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int seg = seg_cols(hd);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(seg),
                              static_cast<cuuint64_t>(B) * t_len,
                              static_cast<cuuint64_t>(hd / seg),
                              static_cast<cuuint64_t>(kv)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(kv) * hd * 2,
                                 static_cast<cuuint64_t>(seg) * 2,
                                 static_cast<cuuint64_t>(hd) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(seg), kStage,
                             static_cast<cuuint32_t>(hd / seg), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = seg == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : seg == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int HD>
int ctas_per_sm(int* n) {
  const size_t smem = smem_bytes(HD);
  cudaError_t e = cudaFuncSetAttribute(
      decode_attn_ring<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, decode_attn_ring<HD>, kThreads, smem));
}

template <int HD>
int launch(const void* maps, const void* q, const void* k, const void* v,
           const int* pos, const int* cur, float* work, int* tickets,
           float* out, int B, int t_len, int kv, int G, int bt, int nsplit,
           int window, float scale, cudaStream_t st) {
  CUtensorMap km, vm;
  memcpy(&km, maps, sizeof km);
  memcpy(&vm, static_cast<const unsigned char*>(maps) + sizeof km, sizeof vm);
  decode_attn_ring<HD><<<dim3(nsplit, kv, B), kThreads, smem_bytes(HD), st>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, cur, work, tickets, out,
      t_len, kv, G, bt, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring

// ------------------------------------------ f32: the CUDA-core body

namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;  // head_dim columns a lane owns (hd <= 32 * kCols)
constexpr int V = 4;      // floats a 16-byte load
constexpr int kChunks = kCols / V;  // 16-byte loads per lane per row

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

// Lane `lane`'s column jj (0 <= jj < kCols): chunk jj / V of 32 * V
// columns, vector lane * V within it, element jj % V.
__device__ __forceinline__ int col_of(int jj, int lane) {
  return (jj / V) * 32 * V + lane * V + jj % V;
}

// Grid (nsplit, KV, B).  GT >= G is a power of two: heads G..GT-1 carry
// zero queries and are never written out.  Dynamic shared memory (f32):
// q_s and red_s [GT * kCols * 32] (lane-interleaved: element
// (g * kCols + jj) * 32 + lane is column col_of(jj, lane) of head g),
// s_s [GT * bt], m_s, l_s, alpha_s [GT]; then live_s [bt] (int).  In q.k a
// warp takes a slot and reads its K row 16 bytes a lane; in p.v each warp
// takes every 8th slot of the block and keeps its own (G, columns)
// accumulators in registers, which the warps sum at the end.
template <int GT>
__global__ void __launch_bounds__(kThreads)
    decode_attn_split(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ pos,
                      const int* __restrict__ cur, float* __restrict__ m_part,
                      float* __restrict__ l_part,
                      float* __restrict__ acc_part, int t_len, int kv, int G,
                      int hd, int bt, int window, float scale) {
  extern __shared__ float smem_f[];
  float* q_s = smem_f;
  float* red_s = q_s + GT * kCols * 32;
  float* s_s = red_s + GT * kCols * 32;
  float* m_s = s_s + GT * bt;
  float* l_s = m_s + GT;
  float* alpha_s = l_s + GT;
  int* live_s = reinterpret_cast<int*>(alpha_s + GT);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = cur[b];
  const size_t row = static_cast<size_t>(kv) * hd;  // elements per slot
  const float* kb = k + static_cast<size_t>(b) * t_len * row +
                    static_cast<size_t>(h) * hd;
  const float* vb = v + static_cast<size_t>(b) * t_len * row +
                    static_cast<size_t>(h) * hd;
  const int* pb = pos + static_cast<size_t>(b) * t_len;

  const float* qb = q + (static_cast<size_t>(b) * kv + h) * G * hd;
  for (int i = tid; i < GT * kCols * 32; i += kThreads) {
    const int g = i / (kCols * 32), jj = (i / 32) % kCols;
    const int col = col_of(jj, i % 32);
    q_s[i] = (g < G && col < hd) ? qb[g * hd + col] : 0.f;
  }
  for (int g = tid; g < GT; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[GT][kCols];  // this warp's share of p.v, lane's columns
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[g][jj] = 0.f;

  const int n_blocks = t_len / bt;
  for (int blk = split; blk < n_blocks; blk += nsplit) {
    const int t0 = blk * bt;
    __syncthreads();  // the previous block's readers of s_s/live_s are done
    int any = 0;
    for (int t = tid; t < bt; t += kThreads) {
      const int p = pb[t0 + t];
      const int ok = p >= 0 && p <= c && (window <= 0 || p > c - window);
      live_s[t] = ok;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;  // skipped: no K/V byte read

    // s = q . k * scale: a warp per slot, all GT heads at once.  Dead
    // slots of a live block are computed too and masked below.
#pragma unroll 2
    for (int t = warp; t < bt; t += kWarps) {
      const float* kr = kb + static_cast<size_t>(t0 + t) * row;
      float part[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) part[g] = 0.f;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int col = ch * 32 * V + lane * V;
        if (col < hd) {
          float kf[V];
          load4(kr + col, kf);
#pragma unroll
          for (int jv = 0; jv < V; ++jv)
#pragma unroll
            for (int g = 0; g < GT; ++g)
              part[g] = fmaf(q_s[(g * kCols + ch * V + jv) * 32 + lane],
                             kf[jv], part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float sg = warp_sum(part[g]);
        if (lane == 0) s_s[g * bt + t] = sg * scale;
      }
    }
    __syncthreads();

    // Online softmax update of (m, l); s_s becomes p (0 on dead slots).
    for (int g = warp; g < GT; g += kWarps) {
      float* sg = s_s + g * bt;
      float mb = kNegInf;
      for (int t = lane; t < bt; t += 32)
        if (live_s[t]) mb = fmaxf(mb, sg[t]);
      mb = warp_max(mb);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mb);
      float sum = 0.f;
      for (int t = lane; t < bt; t += 32) {
        const float p = live_s[t] ? expf(sg[t] - m_new) : 0.f;
        sg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v over this warp's slots (dead slots carry
    // p = 0, as in the reference's masked product).
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[g][jj] *= a;
    }
#pragma unroll 2
    for (int t = warp; t < bt; t += kWarps) {
      const float* vr = vb + static_cast<size_t>(t0 + t) * row;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int col = ch * 32 * V + lane * V;
        if (col < hd) {
          float vf[V];
          load4(vr + col, vf);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float p = s_s[g * bt + t];
#pragma unroll
            for (int jv = 0; jv < V; ++jv)
              acc[g][ch * V + jv] = fmaf(p, vf[jv], acc[g][ch * V + jv]);
          }
        }
      }
    }
  }

  // Sum the warps' accumulators, one warp at a time (a fixed order).
  for (int w = 0; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          float* r = red_s + (g * kCols + jj) * 32 + lane;
          *r = (w == 0 ? 0.f : *r) + acc[g][jj];
        }
    }
  }
  __syncthreads();

  const size_t base =
      ((static_cast<size_t>(b) * kv + h) * nsplit + split) * G;
  for (int g = tid; g < G; g += kThreads) {
    m_part[base + g] = m_s[g];
    l_part[base + g] = l_s[g];
  }
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, col = i % hd;
    const int jj = (col / (32 * V)) * V + col % V;
    const int ln = (col % (32 * V)) / V;
    acc_part[(base + g) * hd + col] = red_s[(g * kCols + jj) * 32 + ln];
  }
}

// Grid (B*KV*G): merge the nsplit partial (m, l, acc) of one query head.
__global__ void __launch_bounds__(kThreads)
    decode_attn_merge(const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part,
                      float* __restrict__ out, int nsplit, int G, int hd) {
  const int bhg = blockIdx.x;  // (b * KV + h) * G + g
  const size_t first = static_cast<size_t>(bhg / G) * nsplit * G + bhg % G;
  float m_max = kNegInf;
  for (int s = 0; s < nsplit; ++s) m_max = fmaxf(m_max, m_part[first + s * G]);
  float l_sum = 0.f;
  for (int s = 0; s < nsplit; ++s)
    l_sum += l_part[first + s * G] * expf(m_part[first + s * G] - m_max);
  const float denom = fmaxf(l_sum, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = first + s * G;
      a += acc_part[i * hd + d] * expf(m_part[i] - m_max);
    }
    out[static_cast<size_t>(bhg) * hd + d] = a / denom;
  }
}

template <int GT>
int launch_split(const float* q, const float* k, const float* v,
                 const int* pos, const int* cur, float* m_part, float* l_part,
                 float* acc_part, int B, int t_len, int kv, int G, int hd,
                 int bt, int nsplit, int window, float scale,
                 cudaStream_t st) {
  const size_t smem =
      (2 * static_cast<size_t>(GT) * kCols * 32 +
       static_cast<size_t>(GT) * bt + 3 * GT) * sizeof(float) +
      static_cast<size_t>(bt) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_split<GT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attn_split<GT><<<dim3(nsplit, kv, B), kThreads, smem, st>>>(
      q, k, v, pos, cur, m_part, l_part, acc_part, t_len, kv, G, hd, bt,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* q, const float* k, const float* v, const int* pos,
           const int* cur, float* work, float* out, int B, int t_len, int kv,
           int G, int hd, int bt, int nsplit, int window, float scale,
           cudaStream_t st) {
  const size_t rows_all = static_cast<size_t>(B) * kv * nsplit * G;
  float* acc_part = work;
  float* m_part = work + rows_all * hd;
  float* l_part = m_part + rows_all;
  int e;
  if (G <= 1)
    e = launch_split<1>(q, k, v, pos, cur, m_part, l_part, acc_part, B, t_len,
                        kv, G, hd, bt, nsplit, window, scale, st);
  else if (G <= 2)
    e = launch_split<2>(q, k, v, pos, cur, m_part, l_part, acc_part, B, t_len,
                        kv, G, hd, bt, nsplit, window, scale, st);
  else if (G <= 4)
    e = launch_split<4>(q, k, v, pos, cur, m_part, l_part, acc_part, B, t_len,
                        kv, G, hd, bt, nsplit, window, scale, st);
  else if (G <= 8)
    e = launch_split<8>(q, k, v, pos, cur, m_part, l_part, acc_part, B, t_len,
                        kv, G, hd, bt, nsplit, window, scale, st);
  else
    e = launch_split<16>(q, k, v, pos, cur, m_part, l_part, acc_part, B,
                         t_len, kv, G, hd, bt, nsplit, window, scale, st);
  if (e != 0) return e;
  decode_attn_merge<<<B * kv * G, kThreads, 0, st>>>(m_part, l_part, acc_part,
                                                     out, nsplit, G, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

#define DECODE_ATTN_ARGS                                                      \
  const void *maps, const void *q, const void *k, const void *v,             \
      const int *pos, const int *cur, float *work, int *tickets, float *out, \
      int B, int t_len, int kv, int G, int hd, int bt, int nsplit,           \
      int window, float scale, void *stream

// The bf16 kernel's head_dims: each its own instantiation, so no column
// step is guarded at run time.
#define DECODE_ATTN_HDS(X)                                                    \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)     \
      X(192) X(208) X(224) X(240) X(256)

// `maps` holds the tensor maps of k and v from decode_attn_bf16_maps.
extern "C" int decode_attn_bf16(DECODE_ATTN_ARGS) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define DECODE_ATTN_LAUNCH(x)                                                \
  case x:                                                                    \
    return ring::launch<x>(maps, q, k, v, pos, cur, work, tickets, out, B,   \
                           t_len, kv, G, bt, nsplit, window, scale, st);
    DECODE_ATTN_HDS(DECODE_ATTN_LAUNCH)
#undef DECODE_ATTN_LAUNCH
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_attn_f32(DECODE_ATTN_ARGS) {
  (void)maps;
  (void)tickets;
  return f32::launch(static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v), pos, cur, work, out, B,
                     t_len, kv, G, hd, bt, nsplit, window, scale,
                     static_cast<cudaStream_t>(stream));
}

// Thread blocks of decode_attn_bf16's kernel for `hd` that one SM holds at
// once (its shared memory and registers allow), into *n.  Also raises the
// kernel's dynamic shared memory limit, which its launches need: call it
// once per device before the first launch at this head_dim.
extern "C" int decode_attn_bf16_ctas_per_sm(int hd, int *n) {
  switch (hd) {
#define DECODE_ATTN_OCCUPANCY(x) \
  case x:                        \
    return ring::ctas_per_sm<x>(n);
    DECODE_ATTN_HDS(DECODE_ATTN_OCCUPANCY)
#undef DECODE_ATTN_OCCUPANCY
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor maps of a bf16 cache's k and v ([B, T, KV, hd], 16-byte
// aligned) for decode_attn_bf16, into maps[0, 256).  Host work only: the
// caller keeps them for as long as k and v keep their address and shape.
extern "C" int decode_attn_bf16_maps(const void *k, const void *v, int B,
                                     int t_len, int kv, int hd, void *maps) {
  CUtensorMap m[2];
  int e = ring::encode_map(&m[0], k, B, t_len, kv, hd);
  if (e == 0) e = ring::encode_map(&m[1], v, B, t_len, kv, hd);
  if (e == 0) memcpy(maps, m, sizeof m);
  return e;
}
