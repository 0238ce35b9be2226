// Standalone int8/int4 cross-attention of one decode step, for Hopper
// (sm_90a): B13.
//
// Replaces ttasr/ops/cross_attention_pallas.py::cross_attention_int8 (:47):
// per audio b, beam row k <= 8 and head h,
//   out[b, k, h] = softmax(bf16(q) . K^T * ks, slots >= s_real masked) * vs
//                  -> bf16, @ V
// over the int8 (B, S, D) or int4 (B, S/2, D) uint8 cross-KV cache with
// (B, H, S) f32 scales, for any head count H (the TPU kernel asserts an
// even one: it pairs heads into one lane-aligned query tile, which this
// kernel, one cluster per head and audio, has no use for).  The decoder
// reaches it through _cross_attn_quantized (decode.py) on the unfused int8
// graph, once per token and layer, on one card or on a shard's local heads
// (an odd count, 5, for large-v3 on a 4-way model axis).  The queries arrive pre-scaled by dh^-0.5 in f32, as the
// TPU kernel takes them; the kernel rounds them to bf16.
//
// What bounds it, and the design: cross_attention.cuh, which B3 and B16
// launch too -- a cluster of blocks per (head, audio) splitting the cache
// rows, each K/V byte read once per step for all K beam rows, an exact
// softmax across the cluster.
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes.

#include "cross_attention.cuh"

// q (B, K, D) f32 pre-scaled; ck/cv (B, S or S/2, D); cks/cvs (B, H, S) f32;
// out (B, K, D) f32.  S is the logical slot count.
extern "C" int ttasr_cross_attention_int8(const void* q, const void* ck, const void* cks,
                                          const void* cv, const void* cvs, void* out, int B,
                                          int K, int D, int S, int s_real, int packed,
                                          void* stream) {
  return (int)ttasr::launch_cross_attention(
      static_cast<const float*>(q), static_cast<const uint8_t*>(ck),
      static_cast<const float*>(cks), static_cast<const uint8_t*>(cv),
      static_cast<const float*>(cvs), static_cast<float*>(out), B, K, D, S, s_real, packed,
      static_cast<cudaStream_t>(stream));
}
