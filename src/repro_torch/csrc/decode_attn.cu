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
// memory rate (4.3 GB at B=128, T=32768, hd=256: ~1.3 ms).
//
// What the design does about it:
//   * Block skipping (the paper's "limit superfluous reads"): a thread block
//     reads the block_t stored positions of a cache block and tests them
//     itself, in place of the TPU's scalar-prefetched "needed" bits; a block
//     with no live slot is neither read nor computed.
//   * The G query heads of one KV head ride in one thread block, so every K
//     and V element is loaded once and used G times.  Loads are 16 bytes a
//     lane (8 bf16 columns): in q.k a warp takes a slot and reads its K row
//     in one instruction; in p.v each warp takes every 8th slot of the
//     block and keeps its own (G, columns) accumulators in registers, which
//     the warps sum at the end.  (A first version with 2-byte loads and a
//     thread per V column walking all slots took 0.161 ms at the serve
//     shape and 13.9 ms at decode_32k on an H100 SXM at 700 W:
//     latency-bound.)
//   * Flash-decoding split: the TPU walks T in order in one program per
//     (b, h).  That gives B*KV thread blocks (4 at the serve shape) for 132
//     SMs, so the wrapper splits each row's cache blocks over `nsplit`
//     thread blocks, interleaved (split s takes blocks s, s + nsplit, ...)
//     so that a dead prefix or suffix of the cache idles no thread block;
//     each writes its (m, l, acc) and a second small kernel merges them:
//       M = max m_s,  L = sum l_s e^(m_s - M),  out = (sum acc_s e^(m_s - M))
//       / max(L, 1e-30).
//     An empty range leaves m = -2e38, l = 0, acc = 0 and adds nothing; if
//     every range is empty, out = 0 as in one pass.
//   * bf16 (or f32) loads, f32 arithmetic, expf, f32 output; no tensor cores
//     yet (wgmma, TMA and a tuned split are later work).
//
// Layouts (all contiguous): q [B, KV, G, hd], k/v [B, T, KV, hd] of the same
// element type, pos [B, T] int32, cur [B] int32, out [B, KV, G, hd] f32;
// partials m/l [B, KV, nsplit, G] and acc [B, KV, nsplit, G, hd] f32.
// Limits checked by the wrapper: G <= 16, hd <= 256 and a multiple of 8
// (bf16) or 4 (f32), T % block_t == 0, 16-byte aligned k, v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;  // head_dim columns a lane owns (hd <= 32 * kCols)
constexpr float kNegInf = -2.0e38f;  // the reference's NEG_INF

// 16 bytes of T as floats: 4 f32 or 8 bf16.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Lane `lane`'s column jj (0 <= jj < kCols): chunk jj / V of 32 * V
// columns, vector lane * V within it, element jj % V.
template <int V>
__device__ __forceinline__ int col_of(int jj, int lane) {
  return (jj / V) * 32 * V + lane * V + jj % V;
}

// Grid (nsplit, KV, B).  GT >= G is a power of two: heads G..GT-1 carry
// zero queries and are never written out.  Dynamic shared memory (f32):
// q_s and red_s [GT * kCols * 32] (lane-interleaved: element
// (g * kCols + jj) * 32 + lane is column col_of(jj, lane) of head g),
// s_s [GT * bt], m_s, l_s, alpha_s [GT]; then live_s [bt] (int).
template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_attn_split(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos,
                      const int* __restrict__ cur, float* __restrict__ m_part,
                      float* __restrict__ l_part,
                      float* __restrict__ acc_part, int t_len, int kv, int G,
                      int hd, int bt, int window, float scale) {
  constexpr int V = Vec<T>::n;
  constexpr int kChunks = kCols / V;  // 16-byte loads per lane per row
  extern __shared__ float smem[];
  float* q_s = smem;
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
  const T* kb = k + static_cast<size_t>(b) * t_len * row +
                static_cast<size_t>(h) * hd;
  const T* vb = v + static_cast<size_t>(b) * t_len * row +
                static_cast<size_t>(h) * hd;
  const int* pb = pos + static_cast<size_t>(b) * t_len;

  const T* qb = q + (static_cast<size_t>(b) * kv + h) * G * hd;
  for (int i = tid; i < GT * kCols * 32; i += kThreads) {
    const int g = i / (kCols * 32), jj = (i / 32) % kCols;
    const int col = col_of<V>(jj, i % 32);
    q_s[i] = (g < G && col < hd) ? to_f32(qb[g * hd + col]) : 0.f;
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
      const T* kr = kb + static_cast<size_t>(t0 + t) * row;
      float part[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) part[g] = 0.f;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int col = ch * 32 * V + lane * V;
        if (col < hd) {
          float kf[V];
          Vec<T>::load(kr + col, kf);
#pragma unroll
          for (int j = 0; j < V; ++j)
#pragma unroll
            for (int g = 0; g < GT; ++g)
              part[g] = fmaf(q_s[(g * kCols + ch * V + j) * 32 + lane], kf[j],
                             part[g]);
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
      const T* vr = vb + static_cast<size_t>(t0 + t) * row;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int col = ch * 32 * V + lane * V;
        if (col < hd) {
          float vf[V];
          Vec<T>::load(vr + col, vf);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float p = s_s[g * bt + t];
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[g][ch * V + j] = fmaf(p, vf[j], acc[g][ch * V + j]);
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

template <typename T, int GT>
int launch_split(const void* q, const void* k, const void* v, const int* pos,
                 const int* cur, float* m_part, float* l_part,
                 float* acc_part, int B, int t_len, int kv, int G, int hd,
                 int bt, int nsplit, int window, float scale,
                 cudaStream_t st) {
  const size_t smem =
      (2 * static_cast<size_t>(GT) * kCols * 32 +
       static_cast<size_t>(GT) * bt + 3 * GT) * sizeof(float) +
      static_cast<size_t>(bt) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_split<T, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attn_split<T, GT><<<dim3(nsplit, kv, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, cur, m_part, l_part, acc_part, t_len, kv,
      G, hd, bt, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const int* cur, float* m_part, float* l_part, float* acc_part,
           float* out, int B, int t_len, int kv, int G, int hd, int bt,
           int nsplit, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e;
  if (G <= 1)
    e = launch_split<T, 1>(q, k, v, pos, cur, m_part, l_part, acc_part, B,
                           t_len, kv, G, hd, bt, nsplit, window, scale, st);
  else if (G <= 2)
    e = launch_split<T, 2>(q, k, v, pos, cur, m_part, l_part, acc_part, B,
                           t_len, kv, G, hd, bt, nsplit, window, scale, st);
  else if (G <= 4)
    e = launch_split<T, 4>(q, k, v, pos, cur, m_part, l_part, acc_part, B,
                           t_len, kv, G, hd, bt, nsplit, window, scale, st);
  else if (G <= 8)
    e = launch_split<T, 8>(q, k, v, pos, cur, m_part, l_part, acc_part, B,
                           t_len, kv, G, hd, bt, nsplit, window, scale, st);
  else
    e = launch_split<T, 16>(q, k, v, pos, cur, m_part, l_part, acc_part, B,
                            t_len, kv, G, hd, bt, nsplit, window, scale, st);
  if (e != 0) return e;
  decode_attn_merge<<<B * kv * G, kThreads, 0, st>>>(m_part, l_part, acc_part,
                                                     out, nsplit, G, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DECODE_ATTN_ARGS                                                      \
  const void *q, const void *k, const void *v, const int *pos,               \
      const int *cur, float *m_part, float *l_part, float *acc_part,          \
      float *out, int B, int t_len, int kv, int G, int hd, int bt,            \
      int nsplit, int window, float scale, void *stream

extern "C" int decode_attn_bf16(DECODE_ATTN_ARGS) {
  return launch<__nv_bfloat16>(q, k, v, pos, cur, m_part, l_part, acc_part,
                               out, B, t_len, kv, G, hd, bt, nsplit, window,
                               scale, stream);
}

extern "C" int decode_attn_f32(DECODE_ATTN_ARGS) {
  return launch<float>(q, k, v, pos, cur, m_part, l_part, acc_part, out, B,
                       t_len, kv, G, hd, bt, nsplit, window, scale, stream);
}
