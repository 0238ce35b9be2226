// Whisper encoder self-attention for Hopper (sm_90a).
//
// Replaces ttasr/ops/encoder_attention_pallas.py::encoder_attention_merged
// (the TPU kernel the JAX encoder calls at model.py:208, 32 times per
// 30 s window).  Same contract: q/k/v (B, T, D) in merged-head layout
// (head h at columns 64h..64h+63), q already scaled by dh^-0.5, keys at
// index >= t_real masked, output (B, T, D) non-causal softmax attention in
// the input type.  Sums are f32.
//
// What bounds it on the card: per (batch, head) the kernel does about
// 2*2*T^2*dh FLOP (scores and the value product) against 3*T*dh*2 bytes of
// q/K/V, i.e. ~T/3 FLOP per byte -- ~500 at T=1500, above the H100's ~295
// bf16 ridge, so it is compute-bound once the quadratic score matrix stays
// out of device memory.  The design therefore:
//   * never writes scores to memory: one block per (query tile, head,
//     batch) streams K/V tiles of 64 keys through shared memory with an
//     online (running max / running sum) softmax, as K and V of one head at
//     T=1500 (192 KB each in bf16) do not fit a block's 227 KB together;
//   * runs both products on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate); the score accumulators are re-packed in registers as
//     the A operand of the value product, so probabilities never touch
//     shared memory either;
//   * gives 64 query rows to a block of 4 warps (16 rows each): at B=1,
//     T=1500, H=20 that is 24*20 = 480 blocks, several per SM on 132 SMs;
//   * skips key tiles that lie wholly at or beyond t_real.
// The TPU kernel's head-pair trick (two heads block-diagonal in one
// 128-lane tile) exists only for the TPU's lane width and is not carried
// over: each block reads its head's 64 columns directly.
//
// float32 inputs take a SIMT kernel templated on the element type (exact
// f32 products; the tensor cores would round to TF32).  It is the
// reference-precision path, not the main path.
//
// Built by ttasr_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Copy rows [row0, row0 + 64) of one head's 64 columns into smem (bf16,
// padded rows); rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16 (*dst)[kLd],
                                               const __nv_bfloat16* src,
                                               int row0, int rows, int D) {
  // 64 rows x 8 chunks of 16 bytes = 512 chunks, 4 per thread
  for (int c = threadIdx.x; c < kBlockK * (kDh / 8); c += kThreads) {
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
encoder_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out,
                              int T, int D, int t_real) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockQ][kLd];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][kLd];

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const size_t base = (size_t)blockIdx.z * T * D + (size_t)head * kDh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row group
  const int t = lane & 3;   // column pair

  load_tile_bf16(q_s, q + base, q0, T, D);
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
    load_tile_bf16(k_s, k + base, k0, T, D);
    load_tile_bf16(v_s, v + base, k0, T, D);
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
    if (row_lo < T) {
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row_lo * D + col) =
          pack_bf16x2(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    }
    if (row_hi < T) {
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row_hi * D + col) =
          pack_bf16x2(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// SIMT path (float32): one thread per query row, K/V tiles of 32 keys in
// shared memory read as broadcasts.
// ---------------------------------------------------------------------------

constexpr int kSimtRows = 64;  // query rows (= threads) per block
constexpr int kSimtKeys = 32;  // keys per tile

template <typename T>
__global__ void __launch_bounds__(kSimtRows)
encoder_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              int T_len, int D, int t_real) {
  __shared__ __align__(16) float k_s[kSimtKeys][kDh];
  __shared__ __align__(16) float v_s[kSimtKeys][kDh];

  const int row = blockIdx.x * kSimtRows + threadIdx.x;
  const size_t base = (size_t)blockIdx.z * T_len * D + (size_t)blockIdx.y * kDh;
  const bool live = row < T_len;

  float qr[kDh], acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = live ? static_cast<float>(q[base + (size_t)row * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < t_real; k0 += kSimtKeys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtKeys * kDh; i += kSimtRows) {
      const int r = i / kDh, d = i % kDh;
      const bool ok = k0 + r < t_real;
      k_s[r][d] = ok ? static_cast<float>(k[base + (size_t)(k0 + r) * D + d]) : 0.f;
      v_s[r][d] = ok ? static_cast<float>(v[base + (size_t)(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[kSimtKeys];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSimtKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&k_s[j][d]);
        dot = fmaf(qr[d], kv.x, dot);
        dot = fmaf(qr[d + 1], kv.y, dot);
        dot = fmaf(qr[d + 2], kv.z, dot);
        dot = fmaf(qr[d + 3], kv.w, dot);
      }
      s[j] = (k0 + j < t_real) ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float mn = fmaxf(m, tmax);
    const float corr = expf(m - mn);
    m = mn;
    l *= corr;
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kSimtKeys; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < kDh; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }
  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kDh; ++d) out[base + (size_t)row * D + d] = static_cast<T>(acc[d] * inv);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous (B, T, D) with
// D = 64 * heads; pointers 16-byte aligned (the wrapper checks both).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int ttasr_encoder_attention(const void* q, const void* k, const void* v,
                                       void* out, int B, int T, int D, int t_real,
                                       int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int heads = D / kDh;
  if (dtype == 1) {
    const dim3 grid((T + kBlockQ - 1) / kBlockQ, heads, B);
    encoder_attention_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, D,
        t_real);
  } else if (dtype == 0) {
    const dim3 grid((T + kSimtRows - 1) / kSimtRows, heads, B);
    encoder_attention_simt_kernel<float><<<grid, kSimtRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), T, D, t_real);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
