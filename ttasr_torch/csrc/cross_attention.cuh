// Per-head cross-attention of a decode step over the quantized cross-KV
// cache, shared by decoder_blocks.cu (B3, after its cross query) and
// cross_attention.cu (B13, on caller-given queries), so the two cannot
// drift -- as the TPU kernels share _cross_pairs_loop
// (ttasr/ops/decoder_blocks_pallas.py:119).
//
//   per head: softmax(bf16(q) . K^T * ks, slots >= s_real masked) * vs
//             -> bf16, @ V
//
// over int8 codes (B, S, D) or int4 nibble pairs (B, S/2, D) uint8 (byte
// [p, d] = slot p | slot p + S/2 << 4), with f32 scales (B, H, S).
//
// What bounds it on this card: every cross-KV byte (int4: two slots) is
// used for K <= 8 query rows -- a few FLOP per byte, far below the H100's
// ~295 FLOP/byte bf16 balance point -- so it is bound by reading the cache
// once per step (3.9 MB per audio at int8, 1.9 MB at int4, large-v3) and,
// at these sizes, by latency.  The design: one block per (head, audio)
// over all of the audio's beam rows, so each K/V byte is read once for all
// K beams; pass 1 scores every slot (an int4 byte holds slot p and p + S/2,
// so a thread scores both from one 64-byte read), the softmax normalises
// the whole row in shared memory before the probabilities are scaled and
// rounded to bf16 exactly where the TPU kernel rounds them, and pass 2
// streams V with 64 consecutive threads on 64 consecutive bytes.  The
// TPU's head-pair block-diagonal query tile is a lane-alignment device of
// the TPU and is not carried over.  Sums run in a fixed order (no atomics).

#pragma once

#include "skinny_gemm.cuh"

namespace ttasr {
namespace {

constexpr int kDh = 64;
constexpr int kCrossThreads = 256;
constexpr int kMaxBeams = 8;
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ int nibble(uint32_t byte, int hi) {
  const int v = hi ? (int)((byte >> 4) & 0xF) : (int)(byte & 0xF);
  return (v ^ 8) - 8;
}

// One block per (head h, audio b).  qc (B*K, D) f32 pre-scaled queries;
// ck/cv (B, S_rows, D) int8 codes or uint8 nibble pairs (S_rows = S/2);
// cks/cvs (B, H, S) f32; cross (B*K, D) f32.
__global__ void __launch_bounds__(kCrossThreads) cross_attention_kernel(
    const float* __restrict__ qc, const uint8_t* __restrict__ ck, const float* __restrict__ cks,
    const uint8_t* __restrict__ cv, const float* __restrict__ cvs, float* __restrict__ cross,
    int K, int D, int S, int s_real, int packed) {
  extern __shared__ __align__(16) float cross_smem[];
  float* s_q = cross_smem;                 // K x 64 bf16-rounded queries
  float* s_p = s_q + kMaxBeams * kDh;      // K x S scores, then probabilities
  float* s_red = s_p + (size_t)K * S;      // 4 slot groups x K x 64 partial outputs

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = packed ? S / 2 : S;
  const size_t kv_base = (size_t)b * rows * D + (size_t)h * kDh;
  const float* ks_row = cks + ((size_t)b * H + h) * S;
  const float* vs_row = cvs + ((size_t)b * H + h) * S;

  for (int i = tid; i < K * kDh; i += kCrossThreads) {
    const int r = i / kDh, d = i - r * kDh;
    s_q[i] = bf16_round(qc[((size_t)b * K + r) * D + h * kDh + d]);
  }
  __syncthreads();

  // pass 1: scores of every (beam row, slot)
  for (int p = tid; p < rows; p += kCrossThreads) {
    const uint4* src = reinterpret_cast<const uint4*>(ck + kv_base + (size_t)p * D);
    uint32_t words[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(src + q);
      words[4 * q] = v.x; words[4 * q + 1] = v.y; words[4 * q + 2] = v.z; words[4 * q + 3] = v.w;
    }
    float lo[kMaxBeams], hi[kMaxBeams];
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r) lo[r] = hi[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d) {
      const uint32_t byte = (words[d >> 2] >> (8 * (d & 3))) & 0xFFu;
      const float c_lo = packed ? (float)nibble(byte, 0) : (float)(int8_t)byte;
      const float c_hi = packed ? (float)nibble(byte, 1) : 0.f;
#pragma unroll
      for (int r = 0; r < kMaxBeams; ++r) {
        if (r < K) {
          lo[r] = fmaf(s_q[r * kDh + d], c_lo, lo[r]);
          if (packed) hi[r] = fmaf(s_q[r * kDh + d], c_hi, hi[r]);
        }
      }
    }
    const int s_lo = p, s_hi = p + rows;  // packed: slot p and p + S/2
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r) {
      if (r < K) {
        s_p[(size_t)r * S + s_lo] = s_lo < s_real ? __fmul_rn(lo[r], ks_row[s_lo]) : kNegInf;
        if (packed)
          s_p[(size_t)r * S + s_hi] = s_hi < s_real ? __fmul_rn(hi[r], ks_row[s_hi]) : kNegInf;
      }
    }
  }
  __syncthreads();

  // softmax over each row (warp r), then bf16(p * vs) as the TPU rounds it
  for (int r = warp; r < K; r += kCrossThreads / 32) {
    float* row = s_p + (size_t)r * S;
    float m = kNegInf;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float e = 0.f;
    for (int s = lane; s < S; s += 32) e += expf(row[s] - m);
    const float denom = warp_sum(e);
    for (int s = lane; s < S; s += 32)
      row[s] = bf16_round(__fmul_rn(__fdiv_rn(expf(row[s] - m), denom), vs_row[s]));
  }
  __syncthreads();

  // pass 2: out[r, d] = sum_s p[r, s] * v[s, d]; 4 slot groups x 64 columns
  {
    const int d = tid % kDh, grp = tid / kDh;
    float acc[kMaxBeams];
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r) acc[r] = 0.f;
    for (int p = grp; p < rows; p += kCrossThreads / kDh) {
      const uint32_t byte = cv[kv_base + (size_t)p * D + d];
      const float c_lo = packed ? (float)nibble(byte, 0) : (float)(int8_t)byte;
      const float c_hi = packed ? (float)nibble(byte, 1) : 0.f;
#pragma unroll
      for (int r = 0; r < kMaxBeams; ++r) {
        if (r < K) {
          acc[r] = fmaf(s_p[(size_t)r * S + p], c_lo, acc[r]);
          if (packed) acc[r] = fmaf(s_p[(size_t)r * S + p + rows], c_hi, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r)
      if (r < K) s_red[(grp * K + r) * kDh + d] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < K * kDh; i += kCrossThreads) {
    const int r = i / kDh, d = i - r * kDh;
    float v = 0.f;
    for (int grp = 0; grp < kCrossThreads / kDh; ++grp) v += s_red[(grp * K + r) * kDh + d];
    cross[((size_t)b * K + r) * D + h * kDh + d] = v;
  }
}

// Launch on `st` over B audios of K <= 8 rows each, D = 64 * heads; S is
// the logical slot count (even when packed).
inline cudaError_t launch_cross_attention(const float* qc, const uint8_t* ck, const float* cks,
                                          const uint8_t* cv, const float* cvs, float* cross,
                                          int B, int K, int D, int S, int s_real, int packed,
                                          cudaStream_t st) {
  if (D % kDh || K < 1 || K > kMaxBeams || (packed && S % 2) || s_real < 1 || s_real > S)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kMaxBeams * kDh + (size_t)K * S + 4 * K * kDh);
  static size_t limit = 0;
  const cudaError_t err = reserve_smem(cross_attention_kernel, smem, &limit);
  if (err != cudaSuccess) return err;
  cross_attention_kernel<<<dim3(D / kDh, B), kCrossThreads, smem, st>>>(
      qc, ck, cks, cv, cvs, cross, K, D, S, s_real, packed);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ttasr
