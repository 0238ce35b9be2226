// Fused int8 decoder-block kernels around the attentions, for Hopper
// (sm_90a): B1 and B3 of the decode step.
//
// Replaces ttasr/ops/decoder_blocks_pallas.py:
//   B1 qkv_int8_fused (:50)           out = LN1(x) @ W_qkv * s + b
//   B3 attnout_ln_q_cross_int8 (:180) x' = x + attn @ Wo * s_o + b_o;
//        qc = (LNc(x') @ Wq_c * s_qc + b_qc) * dh^-0.5;
//        per head: softmax(bf16(qc) . K^T * ks, slots >= s_real masked)
//        * vs -> bf16, @ V, over the int8 or int4 cross-KV cache.
// The decoder calls both once per token and layer (decode.py:410, :567).
//
// What bounds them on this card: at R = beam rows <= 16 every weight byte
// is used for R multiply-adds, and every cross-KV byte (int4: two slots)
// for K query rows -- a few FLOP per byte, two orders of magnitude below
// the H100's ~295 FLOP/byte bf16 balance point.  They are bound by reading
// the int8 weights (B1 4.9 MB, B3 3.3 MB at large-v3) and the cross-KV
// cache (1.9 MB per audio at int4) once per step, and at these sizes by
// latency as much as bandwidth.  The design:
//   * the weight products are the skinny GEMM of skinny_gemm.cuh (one block
//     per 32 output columns, int8 streamed once, bf16 activations in shared
//     memory, f32 sums in a fixed order);
//   * B3 is three launches from one C call: x' (which the LayerNorm needs
//     whole before any cross query exists -- the TPU's sequential grid gave
//     it that for free), then qc, then the cross-attention.  No atomics: the
//     same input decodes to the same bits on every run;
//   * the cross-attention runs one block per (head, audio) over all of the
//     audio's beam rows, so each K/V byte is read once for all K beams: pass
//     1 scores every slot (the int4 cache packs slot p and p + S/2 in one
//     byte, so a thread scores both from one 64-byte read), the softmax
//     normalises the whole row in shared memory before the probabilities
//     are scaled and rounded to bf16 exactly where the TPU kernel rounds
//     them, and pass 2 streams V with 64 consecutive threads on 64
//     consecutive bytes.  The TPU's head-pair block-diagonal query tile and
//     its audios-per-program grouping are lane-alignment devices of the
//     TPU and are not carried over.
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes; each entry point launches on the
// stream it is given and returns cudaGetLastError().

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

}  // namespace
}  // namespace ttasr

using ttasr::GemmArgs;
using ttasr::kTileCols;

// B1: out (R, M) = LN(x) @ W * s + b.
extern "C" int ttasr_qkv_int8(const void* x, const void* ln_s, const void* ln_b, const void* w,
                              const void* w_scale, const void* bias, void* out, int R, int D,
                              int M, void* stream) {
  if (M % kTileCols) return (int)cudaErrorInvalidValue;
  GemmArgs g{x, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
             static_cast<const int8_t*>(w), static_cast<const float*>(w_scale),
             static_cast<const float*>(bias), nullptr, out, R, D, M, 1.f};
  return (int)ttasr::launch_skinny_gemm<ttasr::kLayerNorm, ttasr::kBias>(
      g, static_cast<cudaStream_t>(stream));
}

// B3: xo = x + attn @ Wo * s + bo; qc (scratch) = (LNc(xo) @ Wqc * s + b) / 8;
// cross = per-head cross-attention of qc over the quantized cross-KV.
// x/attn/xo/qc/cross (B, K, D) f32; S is the logical slot count.
extern "C" int ttasr_attnout_cross_int8(
    const void* x, const void* attn, const void* wo, const void* wo_s, const void* bo,
    const void* lnc_s, const void* lnc_b, const void* wqc, const void* wqc_s, const void* bqc,
    const void* ck, const void* cks, const void* cv, const void* cvs, void* xo, void* qc,
    void* cross, int B, int K, int D, int S, int s_real, int packed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % kTileCols || D % ttasr::kDh || K < 1 || K > ttasr::kMaxBeams || (packed && S % 2))
    return (int)cudaErrorInvalidValue;
  const int R = B * K;
  GemmArgs g1{attn, nullptr, nullptr, static_cast<const int8_t*>(wo),
              static_cast<const float*>(wo_s), static_cast<const float*>(bo),
              static_cast<const float*>(x), xo, R, D, D, 1.f};
  cudaError_t err = ttasr::launch_skinny_gemm<ttasr::kCast, ttasr::kResidual>(g1, st);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g2{xo, static_cast<const float*>(lnc_s), static_cast<const float*>(lnc_b),
              static_cast<const int8_t*>(wqc), static_cast<const float*>(wqc_s),
              static_cast<const float*>(bqc), nullptr, qc, R, D, D, 0.125f /* 64^-0.5 */};
  err = ttasr::launch_skinny_gemm<ttasr::kLayerNorm, ttasr::kQScale>(g2, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (ttasr::kMaxBeams * ttasr::kDh + (size_t)K * S + 4 * K * ttasr::kDh);
  static size_t limit = 0;
  err = ttasr::reserve_smem(ttasr::cross_attention_kernel, smem, &limit);
  if (err != cudaSuccess) return (int)err;
  ttasr::cross_attention_kernel<<<dim3(D / ttasr::kDh, B), ttasr::kCrossThreads, smem, st>>>(
      static_cast<const float*>(qc), static_cast<const uint8_t*>(ck),
      static_cast<const float*>(cks), static_cast<const uint8_t*>(cv),
      static_cast<const float*>(cvs), static_cast<float*>(cross), K, D, S, s_real, packed);
  return (int)cudaGetLastError();
}
