// The tensor-core tile loop of the Whisper encoder's self-attention, shared
// by the three entry points of encoder_attention.cu so they cannot drift:
// B11 (three bf16 (B, T, D) tensors), B6 (the s8 x s8 encoder's fused
// (B, T, 3D) bf16 buffer) and B19 (q/k/v (B, T, H, 64) in float32 or bf16,
// B19's own rounding: q scaled in f32, q/k/v rounded to bf16, the output
// rounded to bf16 before it is written in the input type).
//
// Layout: merged heads, head h at columns 64h..64h+63 of rows `ld` elements
// apart (a contiguous (B, T, H, 64) is the merged (B, T, 64 H) layout byte
// for byte); keys at index >= t_real masked; the output (B, T, D) rows D
// apart.  Sums are f32.
//
// What bounds it, and the design: per (batch, head) ~4 T^2 64 FLOP against
// 3 T 64 2 bytes of q/K/V (~T/3 FLOP per byte, ~500 at T = 1500, above the
// H100's ~295 bf16 balance point), so it is compute-bound once the
// quadratic score matrix stays out of device memory.  One block of 4 warps
// per (64-query tile, head, batch) streams K/V tiles of 64 keys through
// shared memory with an online (running max / running sum) softmax; both
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), and the score accumulators are re-packed in registers as
// the A operand of the value product, so neither scores nor probabilities
// touch memory.  Key tiles wholly at or past t_real are skipped.  The
// probabilities rounded to bf16 are the unnormalised exponentials of the
// online softmax; the TPU kernels round the normalised ones, which differs
// by up to one bf16 step per probability.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ttasr_enc {

constexpr int kDh = 64;           // head width (Whisper)
constexpr int kRowsPerWarp = 16;  // mma M
constexpr int kWarps = 4;
constexpr int kBlockQ = kRowsPerWarp * kWarps;  // 64 query rows per block
constexpr int kBlockK = 64;                     // keys per shared-memory tile
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kDh + 8;  // padded smem row (bf16): 144 B, 16 B aligned

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A (16x16, row) * B (16x8, col) + D; bf16 inputs, f32 accumulators.
// Fragment layout (lane = 4*g + t):
//   a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   b0: (k=2t..2t+1, n=g)  b1: (k=2t+8..2t+9, n=g)
//   c0,c1: (g, 2t..2t+1)  c2,c3: (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive elements as f32 (16 or 32 bytes, aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// Copy rows [row0, row0 + 64) of one head's 64 columns (row stride `ld`)
// into smem as bf16 (padded rows); rows at or past `rows` are zero-filled.
// bf16 input without a scale is copied as is; otherwise each element is
// read as f32, multiplied by `scale` when kScaled, and rounded to bf16.
template <typename In, bool kScaled>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLd], const In* src, int row0,
                                          int rows, int ld, float scale) {
  // 64 rows x 8 chunks of 8 elements = 512 chunks, 4 per thread
  for (int c = threadIdx.x; c < kBlockK * (kDh / 8); c += kThreads) {
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      const In* p = src + (size_t)(row0 + r) * ld + col;
      if constexpr (std::is_same<In, __nv_bfloat16>::value && !kScaled) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        float f[8];
        load8(p, f);
        if (kScaled) {
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] *= scale;
        }
        val = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                         pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
      }
    }
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

// Two adjacent outputs of a row: bf16 as is; float32 as the bf16-rounded
// value (B19 rounds its output to bf16 before the cast to q's type).
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// One block: query rows [64 blockIdx.x, +64) of head blockIdx.y of batch
// row blockIdx.z.  q/k/v rows `ld` elements apart, out rows D apart; q is
// multiplied by q_scale on load when kScaleQ.
template <typename In, bool kScaleQ>
__global__ void __launch_bounds__(kThreads)
attention_mma_kernel(const In* __restrict__ q, const In* __restrict__ k,
                     const In* __restrict__ v, In* __restrict__ out, int T, int ld, int D,
                     int t_real, float q_scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockQ][kLd];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][kLd];

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const size_t base = (size_t)blockIdx.z * T * ld + (size_t)head * kDh;  // inputs
  const size_t obase = (size_t)blockIdx.z * T * D + (size_t)head * kDh;  // output
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row group
  const int t = lane & 3;   // column pair

  load_tile<In, kScaleQ>(q_s, q + base, q0, T, ld, q_scale);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide dh chunk
  uint32_t qa[kDh / 16][4];
  const int wr = warp * kRowsPerWarp;
#pragma unroll
  for (int kc = 0; kc < kDh / 16; ++kc) {
    qa[kc][0] = *reinterpret_cast<const uint32_t*>(&q_s[wr + g][kc * 16 + 2 * t]);
    qa[kc][1] = *reinterpret_cast<const uint32_t*>(&q_s[wr + g + 8][kc * 16 + 2 * t]);
    qa[kc][2] = *reinterpret_cast<const uint32_t*>(&q_s[wr + g][kc * 16 + 8 + 2 * t]);
    qa[kc][3] = *reinterpret_cast<const uint32_t*>(&q_s[wr + g + 8][kc * 16 + 8 + 2 * t]);
  }

  float o[kDh / 8][4];
#pragma unroll
  for (int dt = 0; dt < kDh / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, rows g and g+8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial sums

  const int n_tiles = (t_real + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile fully consumed
    load_tile<In, false>(k_s, k + base, k0, T, ld, 1.f);
    load_tile<In, false>(v_s, v + base, k0, T, ld, 1.f);
    __syncthreads();

    // scores S (16 x 64) = Q K^T: 8 key n-tiles of 8
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDh / 16; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&k_s[nt * 8 + g][kc * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&k_s[nt * 8 + g][kc * 16 + 8 + 2 * t]);
        mma_16816(s[nt], qa[kc], b0, b1);
      }
    }

    // mask keys >= t_real, then the tile's row maxima
    float tmax_lo = -INFINITY, tmax_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (k0 + nt * 8 + 2 * t + j >= t_real) {
          s[nt][j] = -INFINITY;
          s[nt][2 + j] = -INFINITY;
        }
        tmax_lo = fmaxf(tmax_lo, s[nt][j]);
        tmax_hi = fmaxf(tmax_hi, s[nt][2 + j]);
      }
    }
    // the 4 lanes of a row group hold the row's 64 columns between them
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tmax_lo = fmaxf(tmax_lo, __shfl_xor_sync(0xffffffffu, tmax_lo, off));
      tmax_hi = fmaxf(tmax_hi, __shfl_xor_sync(0xffffffffu, tmax_hi, off));
    }
    // key 0 < t_real lies in tile 0, so every row max is finite from here
    const float mn_lo = fmaxf(m_lo, tmax_lo);
    const float mn_hi = fmaxf(m_hi, tmax_hi);
    const float corr_lo = __expf(m_lo - mn_lo);  // exp(-inf) = 0 on tile 0
    const float corr_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= corr_lo;
    l_hi *= corr_hi;
#pragma unroll
    for (int dt = 0; dt < kDh / 8; ++dt) {
      o[dt][0] *= corr_lo;
      o[dt][1] *= corr_lo;
      o[dt][2] *= corr_hi;
      o[dt][3] *= corr_hi;
    }
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn_lo);
      s[nt][1] = __expf(s[nt][1] - mn_lo);
      s[nt][2] = __expf(s[nt][2] - mn_hi);
      s[nt][3] = __expf(s[nt][3] - mn_hi);
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }

    // O += P V: P's accumulators re-packed as A fragments (16 keys each)
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const unsigned short* vs = reinterpret_cast<const unsigned short*>(&v_s[0][0]);
      const int r0 = kc * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kDh / 8; ++dt) {
        const int col = dt * 8 + g;
        const uint32_t b0 = (uint32_t)vs[r0 * kLd + col] |
                            ((uint32_t)vs[(r0 + 1) * kLd + col] << 16);
        const uint32_t b1 = (uint32_t)vs[(r0 + 8) * kLd + col] |
                            ((uint32_t)vs[(r0 + 9) * kLd + col] << 16);
        mma_16816(o[dt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo;
  const float inv_hi = 1.f / l_hi;
  const int row_lo = q0 + wr + g;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int dt = 0; dt < kDh / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_lo < T) store2(out + obase + (size_t)row_lo * D + col, o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    if (row_hi < T) store2(out + obase + (size_t)row_hi * D + col, o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
}

// Launch on `st`: B x heads blocks of query tiles.
template <typename In, bool kScaleQ>
cudaError_t launch_attention_mma(const In* q, const In* k, const In* v, In* out, int B, int T,
                                 int ld, int D, int t_real, float q_scale, cudaStream_t st) {
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, D / kDh, B);
  attention_mma_kernel<In, kScaleQ><<<grid, kThreads, 0, st>>>(q, k, v, out, T, ld, D, t_real,
                                                              q_scale);
  return cudaGetLastError();
}

}  // namespace ttasr_enc
