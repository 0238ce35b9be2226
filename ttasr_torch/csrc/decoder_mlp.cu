// Fused int8 decoder MLPs, for Hopper (sm_90a): B4 and B14 of the decode
// step.
//
// Replaces ttasr/ops/decoder_mlp_pallas.py::mlp_with_crossout_int8 (:153),
// called once per token and layer (decode.py:595):
//   x' = x + cross @ Wo_c * s_oc + b_oc
//   y  = x' + GELU(LN2(x') @ W1 * s1 + b1) @ W2 * s2 + b2
// and ttasr/ops/decoder_mlp_pallas.py::mlp_int8_fused (:65), which the
// row-parallel tensor-parallel decode calls once per token and layer
// (decode.py:537) on a shard's column slice of W1/b1 and row slice of W2:
//   partial: y = GELU(LN2(x) @ W1 * s1 + b1) @ W2 * s2   (no residual, no b2:
//            the caller sums the shards and adds x + b2 once)
//   full:    y = (x + b2) + that
// with the LN2 output and the GELU output rounded to bf16 before their
// weight products, and GELU by the Abramowitz-Stegun erf polynomial the TPU
// kernel uses (decoder_mlp_pallas.py:28-48; the plain version uses it too).
//
// What bounds it on this card: the three int8 weights (1.6 + 6.6 + 6.6 MB
// at large-v3, 57 % of a decoder layer's weight bytes) are each used for
// R <= 16 rows, a few FLOP per byte against the H100's ~295 FLOP/byte bf16
// balance point: it is bound by streaming the weights once per step.  The
// design: three launches of the skinny GEMM (skinny_gemm.cuh) from one C
// call, each with K split over a thread-block cluster so the grid covers
// the 132 SMs (wo_c 40 column tiles x 4, W1 160 x 2, W2 40 x 8 blocks of
// 640 K rows at large-v3), each block's weight slab in flight at once, the
// second and third launch started early (programmatic dependent launch) so
// their weights arrive while the launch before runs.
// The TPU kernel carries x' in VMEM scratch and accumulates the ffn tiles
// into its output across its sequential grid; CUDA blocks run
// concurrently, so x' and the (R, F) bf16 hidden activations go through
// small device buffers the wrapper allocates, and every sum runs in a
// fixed order (inside a block, then over the cluster in rank order; no
// atomics, the same bits on every run).
//
// B14 is B4 without its wo_c launch: the LayerNorm + GELU GEMM into the
// bf16 hidden scratch, then the W2 GEMM with the scale-only epilogue
// (partial) or the residual + bias one.  The TPU kernel sums its ffn tiles
// in grid order into f32; here every column's sum runs in one cluster in a
// fixed order, so the two differ only by reassociation.  B14's products
// are B4's bit for bit at the same shapes.
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes.

#include "skinny_gemm.cuh"

using ttasr::GemmArgs;
using ttasr::kTileCols;

// x, cross, x_mid (scratch), out: (R, D) f32; h (scratch): (R, F) bf16.
extern "C" int ttasr_mlp_crossout_int8(
    const void* x, const void* cross, const void* woc, const void* woc_s, const void* boc,
    const void* ln_s, const void* ln_b, const void* w1, const void* w1_s, const void* b1,
    const void* w2, const void* w2_s, const void* b2, void* x_mid, void* h, void* out, int R,
    int D, int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % kTileCols || F % kTileCols) return (int)cudaErrorInvalidValue;
  GemmArgs g1{cross, nullptr, nullptr, static_cast<const int8_t*>(woc),
              static_cast<const float*>(woc_s), static_cast<const float*>(boc),
              static_cast<const float*>(x), x_mid, R, D, D, 1.f};
  cudaError_t err = ttasr::launch_skinny_gemm<ttasr::kCast, ttasr::kResidual>(g1, st);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g2{x_mid, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
              static_cast<const int8_t*>(w1), static_cast<const float*>(w1_s),
              static_cast<const float*>(b1), nullptr, h, R, D, F, 1.f};
  err = ttasr::launch_skinny_gemm<ttasr::kLayerNorm, ttasr::kGelu>(g2, st, true);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g3{h, nullptr, nullptr, static_cast<const int8_t*>(w2),
              static_cast<const float*>(w2_s), static_cast<const float*>(b2),
              static_cast<const float*>(x_mid), out, R, F, D, 1.f};
  return (int)ttasr::launch_skinny_gemm<ttasr::kBf16, ttasr::kResidualBias>(g3, st, true);
}

// B14: h (scratch, R x F) = bf16(GELU(LN2(x) @ W1 * s1 + b1)); out (R, D) =
// h @ W2 * s2 (partial) or (x + b2) + h @ W2 * s2.  x, out (R, D) f32; F is
// the shard's hidden width.
extern "C" int ttasr_mlp_int8(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                              const void* w1_s, const void* b1, const void* w2, const void* w2_s,
                              const void* b2, void* h, void* out, int R, int D, int F,
                              int partial, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % kTileCols || F % kTileCols || R < 1) return (int)cudaErrorInvalidValue;
  GemmArgs g1{x, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
              static_cast<const int8_t*>(w1), static_cast<const float*>(w1_s),
              static_cast<const float*>(b1), nullptr, h, R, D, F, 1.f};
  const cudaError_t err = ttasr::launch_skinny_gemm<ttasr::kLayerNorm, ttasr::kGelu>(g1, st);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g2{h, nullptr, nullptr, static_cast<const int8_t*>(w2),
              static_cast<const float*>(w2_s), static_cast<const float*>(b2),
              static_cast<const float*>(x), out, R, F, D, 1.f};
  if (partial) return (int)ttasr::launch_skinny_gemm<ttasr::kBf16, ttasr::kScale>(g2, st, true);
  return (int)ttasr::launch_skinny_gemm<ttasr::kBf16, ttasr::kResidualBias>(g2, st, true);
}
