// Fused int8 decoder-block kernels around the attentions, for Hopper
// (sm_90a): B1, B3, B12, B15 and B16 of the decode step.
//
// Replaces ttasr/ops/decoder_blocks_pallas.py:
//   B1  qkv_int8_fused (:50)           out = LN1(x) @ W_qkv * s + b
//   B12 attnout_ln_q_fused (:75)       x' = x + attn @ Wo * s_o + b_o;
//        qc = LNc(x') @ Wq_c * s_qc + b_qc (no dh^-0.5: the consumer scales)
//   B3  attnout_ln_q_cross_int8 (:180) B12 with qc * dh^-0.5, then per head
//        softmax(bf16(qc) . K^T * ks, slots >= s_real masked) * vs -> bf16,
//        @ V, over the int8 or int4 cross-KV cache (cross_attention.cuh).
//   B15 matmul_int8_partial (:292)     out = bf16(x) @ W * s, no bias: a
//        tensor-parallel shard's partial sum of a row-split projection
//   B16 ln_q_cross_int8 (:322)         B3 without its wo half: the cross
//        query of the residual stream after the row-parallel wo sum, then
//        the same cross-attention over the shard's heads
// The decoder calls B1 once per token and layer (decode.py:410), and B3
// (:567) or, when B3's condition fails -- a bf16 cross-KV, more than 8
// beams per audio, an odd head count -- B12 (:579).  Under tensor
// parallelism (decode.py:494-547, row-parallel) B15 runs twice per layer,
// for wo and wo_c, and B16 takes B3's place.  Under tensor parallelism the
// cross width DC = 64 * local heads is narrower than the residual width D.
//
// What bounds them on this card: at R = beam rows <= 16 every weight byte
// is used for R multiply-adds, and every cross-KV byte (int4: two slots)
// for K query rows -- a few FLOP per byte, two orders of magnitude below
// the H100's ~295 FLOP/byte bf16 balance point.  They are bound by reading
// the int8 weights (B1 4.9 MB, B3 and B12 3.3 MB at large-v3) and the
// cross-KV cache (1.9 MB per audio at int4) once per step, and at these
// sizes by latency as much as bandwidth.  The design:
//   * the weight products are the skinny GEMM of skinny_gemm.cuh (one block
//     per 32 output columns, int8 streamed once, bf16 activations in shared
//     memory, f32 sums in a fixed order, any row count in chunks of 8);
//   * B12 is two launches from one C call: x' (which the LayerNorm needs
//     whole before any cross query exists -- the TPU's sequential grid gave
//     it that for free), then qc; B3 is the same two launches with the query
//     pre-scale, then the cross-attention of cross_attention.cuh (shared
//     with B13).  No atomics: the same input decodes to the same bits on
//     every run;
//   * B15 is one launch of the skinny GEMM with the f32 -> bf16 cast
//     prologue and a scale-only epilogue (1.6 MB of W at n = 1): the bias
//     is not partial-summable, so the caller adds it once after the sum;
//   * B16 is B3's second and third launches: the LayerNorm query GEMM with
//     the 64^-0.5 pre-scale, then cross_attention.cuh over the local heads,
//     so B3, B13 and B16 share one attention and cannot drift apart.
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes; each entry point launches on the
// stream it is given and returns cudaGetLastError().

#include "cross_attention.cuh"
#include "skinny_gemm.cuh"

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

namespace {

// xo (R, D) = x + attn @ Wo * s + bo, then qc (R, DC) = (LNc(xo) @ Wqc * s + b)
// * qscale: B12 with qscale 1 (an exact identity), B3's first half with 64^-0.5.
cudaError_t attnout_ln_q(const void* x, const void* attn, const void* wo, const void* wo_s,
                         const void* bo, const void* lnc_s, const void* lnc_b, const void* wqc,
                         const void* wqc_s, const void* bqc, void* xo, void* qc, int R, int D,
                         int DC, float qscale, cudaStream_t st) {
  if (D % kTileCols || DC % kTileCols || R < 1) return cudaErrorInvalidValue;
  GemmArgs g1{attn, nullptr, nullptr, static_cast<const int8_t*>(wo),
              static_cast<const float*>(wo_s), static_cast<const float*>(bo),
              static_cast<const float*>(x), xo, R, D, D, 1.f};
  const cudaError_t err = ttasr::launch_skinny_gemm<ttasr::kCast, ttasr::kResidual>(g1, st);
  if (err != cudaSuccess) return err;
  GemmArgs g2{xo, static_cast<const float*>(lnc_s), static_cast<const float*>(lnc_b),
              static_cast<const int8_t*>(wqc), static_cast<const float*>(wqc_s),
              static_cast<const float*>(bqc), nullptr, qc, R, D, DC, qscale};
  return ttasr::launch_skinny_gemm<ttasr::kLayerNorm, ttasr::kQScale>(g2, st);
}

}  // namespace

// B12: xo (R, D) = x + attn @ Wo * s + bo; qc (R, DC) = LNc(xo) @ Wqc * s + b.
extern "C" int ttasr_attnout_ln_q(const void* x, const void* attn, const void* wo,
                                  const void* wo_s, const void* bo, const void* lnc_s,
                                  const void* lnc_b, const void* wqc, const void* wqc_s,
                                  const void* bqc, void* xo, void* qc, int R, int D, int DC,
                                  void* stream) {
  return (int)attnout_ln_q(x, attn, wo, wo_s, bo, lnc_s, lnc_b, wqc, wqc_s, bqc, xo, qc, R, D,
                           DC, 1.f, static_cast<cudaStream_t>(stream));
}

namespace {

// cross (B*K, DC) = per-head cross-attention of the pre-scaled queries qc
// (B*K, DC) over the quantized cross-KV (B, S or S/2, DC).
cudaError_t cross_of(const void* qc, const void* ck, const void* cks, const void* cv,
                     const void* cvs, void* cross, int B, int K, int DC, int S, int s_real,
                     int packed, cudaStream_t st) {
  return ttasr::launch_cross_attention(
      static_cast<const float*>(qc), static_cast<const uint8_t*>(ck),
      static_cast<const float*>(cks), static_cast<const uint8_t*>(cv),
      static_cast<const float*>(cvs), static_cast<float*>(cross), B, K, DC, S, s_real, packed,
      st);
}

}  // namespace

// B3: xo = x + attn @ Wo * s + bo; qc (scratch) = (LNc(xo) @ Wqc * s + b) / 8;
// cross = per-head cross-attention of qc over the quantized cross-KV.
// x/attn/xo (B, K, D) f32, qc/cross (B, K, DC) f32; S is the logical slot
// count.
extern "C" int ttasr_attnout_cross_int8(
    const void* x, const void* attn, const void* wo, const void* wo_s, const void* bo,
    const void* lnc_s, const void* lnc_b, const void* wqc, const void* wqc_s, const void* bqc,
    const void* ck, const void* cks, const void* cv, const void* cvs, void* xo, void* qc,
    void* cross, int B, int K, int D, int DC, int S, int s_real, int packed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DC % ttasr::kDh || K < 1 || K > ttasr::kMaxBeams) return (int)cudaErrorInvalidValue;
  const cudaError_t err = attnout_ln_q(x, attn, wo, wo_s, bo, lnc_s, lnc_b, wqc, wqc_s, bqc, xo,
                                       qc, B * K, D, DC, 0.125f /* 64^-0.5 */, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cross_of(qc, ck, cks, cv, cvs, cross, B, K, DC, S, s_real, packed, st);
}

// B15: out (R, M) = bf16(x) @ W * s for x (R, DL) f32 and W (DL, M) int8.
extern "C" int ttasr_matmul_int8_partial(const void* x, const void* w, const void* w_scale,
                                         void* out, int R, int DL, int M, void* stream) {
  if (M % kTileCols || R < 1) return (int)cudaErrorInvalidValue;
  GemmArgs g{x, nullptr, nullptr, static_cast<const int8_t*>(w),
             static_cast<const float*>(w_scale), nullptr, nullptr, out, R, DL, M, 1.f};
  return (int)ttasr::launch_skinny_gemm<ttasr::kCast, ttasr::kScale>(
      g, static_cast<cudaStream_t>(stream));
}

// B16: qc (scratch, B*K x DC) = (LNc(xo) @ Wqc * s + b) / 8; cross (B, K, DC)
// = per-head cross-attention of qc over the shard's quantized cross-KV.
// xo (B, K, D) f32 is the residual stream after the row-parallel wo sum.
extern "C" int ttasr_ln_q_cross_int8(const void* xo, const void* lnc_s, const void* lnc_b,
                                     const void* wqc, const void* wqc_s, const void* bqc,
                                     const void* ck, const void* cks, const void* cv,
                                     const void* cvs, void* qc, void* cross, int B, int K, int D,
                                     int DC, int S, int s_real, int packed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % kTileCols || DC % ttasr::kDh || K < 1 || K > ttasr::kMaxBeams)
    return (int)cudaErrorInvalidValue;
  GemmArgs g{xo, static_cast<const float*>(lnc_s), static_cast<const float*>(lnc_b),
             static_cast<const int8_t*>(wqc), static_cast<const float*>(wqc_s),
             static_cast<const float*>(bqc), nullptr, qc, B * K, D, DC, 0.125f /* 64^-0.5 */};
  const cudaError_t err = ttasr::launch_skinny_gemm<ttasr::kLayerNorm, ttasr::kQScale>(g, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cross_of(qc, ck, cks, cv, cvs, cross, B, K, DC, S, s_real, packed, st);
}
