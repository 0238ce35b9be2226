// Skinny int8-weight GEMM for the decode step, shared by decoder_blocks.cu
// (B1, B3) and decoder_mlp.cu (B4).
//
//   out[r, n] = epilogue( sum_k bf16(prologue(a))[r, k] * W[k, n] * s[n] )
//
// for R <= ~16 activation rows against an int8 (K, N) weight with one f32
// scale per output column.  At these row counts every FLOP is paid for by
// ~1 byte of weight, far below the H100's ~295 FLOP/byte bf16 balance
// point: the kernel is bound by streaming the int8 weight once.  So:
//   * one block per 32 output columns; 256 threads = 64 K-groups x 4
//     column threads, each thread streaming 8 int8 codes (one 8-byte load)
//     per K row it owns, so a warp reads 8 whole 32-byte sectors per step;
//   * the activation rows (after the prologue: a cast, a LayerNorm, or
//     already bf16) sit in shared memory as bf16, rounded exactly where
//     the TPU kernels round them, and are read as warp broadcasts;
//   * bf16 values times int8 codes are exact in f32, so products are f32
//     FMAs; partial sums reduce in a fixed order (warp shuffles, then the
//     8 warps in index order), never with atomics, so the same input gives
//     the same bits on every run;
//   * rows are processed 8 at a time (register accumulators 8 x 8).
// The epilogue applies the column scale and, per kernel, the bias, the
// residual, the query pre-scale or the GELU.  Every multiply and add of an
// epilogue is an explicit _rn operation (no FMA contraction), in the order
// of the TPU kernel's expression.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ttasr {
// internal linkage: each .cu that includes this gets its own instantiations
namespace {

constexpr int kGemmThreads = 256;
constexpr int kColsPerThread = 8;
constexpr int kTileCols = 32;
constexpr int kColThreads = kTileCols / kColsPerThread;  // 4
constexpr int kKGroups = kGemmThreads / kColThreads;     // 64
constexpr int kRowChunk = 8;
constexpr int kGemmWarps = kGemmThreads / 32;
constexpr float kLnEps = 1e-5f;
static_assert(kRowChunk * kTileCols == kGemmThreads, "one epilogue output per thread");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Abramowitz-Stegun 7.1.26 erf, the TPU kernel's GELU (decoder_mlp_pallas.py)
__device__ __forceinline__ float gelu_as(float h) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float zs = __fmul_rn(h, 0.7071067811865476f);
  const float sgn = (zs > 0.f) ? 1.f : ((zs < 0.f) ? -1.f : 0.f);
  const float z = fabsf(zs);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(p, z)));
  float poly = __fadd_rn(a4, __fmul_rn(t, a5));
  poly = __fadd_rn(a3, __fmul_rn(t, poly));
  poly = __fadd_rn(a2, __fmul_rn(t, poly));
  poly = __fadd_rn(a1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float erf = __fmul_rn(sgn, __fsub_rn(1.f, __fmul_rn(poly, expf(-__fmul_rn(z, z)))));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, erf));
}

enum Prologue { kCast = 0, kLayerNorm = 1, kBf16 = 2 };
enum Epilogue {
  kBias = 0,         // v*s + b
  kResidual = 1,     // (x + v*s) + b
  kQScale = 2,       // (v*s + b) * qscale
  kGelu = 3,         // bf16(gelu(v*s + b))
  kResidualBias = 4  // (x + b) + v*s
};

struct GemmArgs {
  const void* a;         // (R, K) f32 or bf16
  const float* ln_s;     // (K,) for kLayerNorm
  const float* ln_b;
  const int8_t* w;       // (K, N)
  const float* w_scale;  // (N,)
  const float* bias;     // (N,)
  const float* resid;    // (R, N) for the residual epilogues
  void* out;             // (R, N) f32, or bf16 for kGelu
  int R, K, N;
  float qscale;
};

template <int P, int E>
__global__ void __launch_bounds__(kGemmThreads) skinny_gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(gemm_smem);  // kRowChunk x K
  float* s_red = reinterpret_cast<float*>(gemm_smem + sizeof(__nv_bfloat16) * kRowChunk * g.K);
  float* s_stats = s_red + kGemmWarps * kRowChunk * kTileCols;  // mean, rstd per row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = tid / kColThreads, ct = tid % kColThreads;
  const int col0 = blockIdx.x * kTileCols + ct * kColsPerThread;
  const int K = g.K, N = g.N;

  for (int r0 = 0; r0 < g.R; r0 += kRowChunk) {
    const int rc = min(kRowChunk, g.R - r0);
    if (P == kLayerNorm) {
      // warp w: mean and biased variance of row w (two passes, as the TPU's
      // _ln_f32), reduced in a fixed order
      const float* x = static_cast<const float*>(g.a);
      if (warp < rc) {
        const float* row = x + (size_t)(r0 + warp) * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += row[k];
        const float mean = __fdiv_rn(warp_sum(s), (float)K);
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float dlt = __fsub_rn(row[k], mean);
          v = __fadd_rn(v, __fmul_rn(dlt, dlt));
        }
        const float var = __fdiv_rn(warp_sum(v), (float)K);
        if (lane == 0) {
          s_stats[2 * warp] = mean;
          s_stats[2 * warp + 1] = __fdiv_rn(1.f, sqrtf(__fadd_rn(var, kLnEps)));
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < kRowChunk * K; i += kGemmThreads) {
      const int rr = i / K, k = i - rr * K;
      float v = 0.f;
      if (rr < rc) {
        const size_t src = (size_t)(r0 + rr) * K + k;
        if (P == kBf16) {
          v = __bfloat162float(static_cast<const __nv_bfloat16*>(g.a)[src]);
        } else if (P == kCast) {
          v = static_cast<const float*>(g.a)[src];
        } else {
          const float xv = static_cast<const float*>(g.a)[src];
          const float n = __fmul_rn(__fsub_rn(xv, s_stats[2 * rr]), s_stats[2 * rr + 1]);
          v = __fadd_rn(__fmul_rn(n, g.ln_s[k]), g.ln_b[k]);
        }
      }
      s_a[i] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    float acc[kRowChunk][kColsPerThread];
#pragma unroll
    for (int rr = 0; rr < kRowChunk; ++rr)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[rr][c] = 0.f;

    const int8_t* wp = g.w + col0;
#pragma unroll 4
    for (int k = kg; k < K; k += kKGroups) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(wp + (size_t)k * N));
      float wf[kColsPerThread];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        wf[c] = (float)(int8_t)(raw.x >> (8 * c));
        wf[c + 4] = (float)(int8_t)(raw.y >> (8 * c));
      }
#pragma unroll
      for (int rr = 0; rr < kRowChunk; ++rr) {
        const float av = __bfloat162float(s_a[rr * K + k]);
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[rr][c] = fmaf(av, wf[c], acc[rr][c]);
      }
    }
    // reduce the 8 K-groups of each warp (lanes with the same column thread)
#pragma unroll
    for (int rr = 0; rr < kRowChunk; ++rr)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        float v = acc[rr][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[rr][c] = v;
      }
    if (lane < kColThreads) {
#pragma unroll
      for (int rr = 0; rr < kRowChunk; ++rr)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          s_red[(warp * kRowChunk + rr) * kTileCols + lane * kColsPerThread + c] = acc[rr][c];
    }
    __syncthreads();
    {
      const int rr = tid / kTileCols, c = tid % kTileCols;  // 8 x 32 = 256 outputs
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kGemmWarps; ++w) v += s_red[(w * kRowChunk + rr) * kTileCols + c];
      if (rr < rc) {
        const int r = r0 + rr, n = blockIdx.x * kTileCols + c;
        const size_t o = (size_t)r * N + n;
        const float vs = __fmul_rn(v, g.w_scale[n]);
        if (E == kBias) {
          static_cast<float*>(g.out)[o] = __fadd_rn(vs, g.bias[n]);
        } else if (E == kResidual) {
          static_cast<float*>(g.out)[o] = __fadd_rn(__fadd_rn(g.resid[o], vs), g.bias[n]);
        } else if (E == kQScale) {
          static_cast<float*>(g.out)[o] = __fmul_rn(__fadd_rn(vs, g.bias[n]), g.qscale);
        } else if (E == kGelu) {
          static_cast<__nv_bfloat16*>(g.out)[o] =
              __float2bfloat16_rn(gelu_as(__fadd_rn(vs, g.bias[n])));
        } else {
          static_cast<float*>(g.out)[o] = __fadd_rn(__fadd_rn(g.resid[o], g.bias[n]), vs);
        }
      }
    }
    __syncthreads();  // s_a and s_red are reused by the next row chunk
  }
}

inline size_t gemm_smem_bytes(int K) {
  return sizeof(__nv_bfloat16) * kRowChunk * K +
         sizeof(float) * (kGemmWarps * kRowChunk * kTileCols + 2 * kRowChunk);
}

// Raise `kernel`'s dynamic shared-memory limit to at least `bytes`; the
// limit set so far is remembered in `*limit`, so cudaFuncSetAttribute runs
// only when a larger size first appears.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* limit) {
  if (bytes <= *limit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *limit = bytes;
  return err;
}

// Launch on `st`; N must be a multiple of kTileCols (the wrappers check).
template <int P, int E>
cudaError_t launch_skinny_gemm(const GemmArgs& g, cudaStream_t st) {
  static size_t limit = 0;
  const size_t smem = gemm_smem_bytes(g.K);
  const cudaError_t err = reserve_smem(skinny_gemm_kernel<P, E>, smem, &limit);
  if (err != cudaSuccess) return err;
  skinny_gemm_kernel<P, E><<<g.N / kTileCols, kGemmThreads, smem, st>>>(g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ttasr
