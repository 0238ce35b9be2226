// Fused int8/int4 self-attention decode step for Hopper (sm_90a): B2 and
// B10 of the decode step, one template with and without the ancestry map.
//
// Replaces ttasr/ops/self_attention_pallas.py:
//   B10 self_attn_step_int8 (:47)            each beam row reads its own cache
//   B2  self_attn_step_indirect_int8 (:290)  beam row j reads position t from
//       physical row anc[b, j, t] of its audio's K rows (beam search never
//       reorders the cache; decode.py:440 beam, :457 greedy/fallback).
// Per (audio b, row j, head h): quantize the new K/V entry (codes
// clip(rint(x / scale)), scale = max(absmax, 1e-8) * (1/levels), levels 127,
// or 7 lane-packed), score cached positions pad[b, j] <= t < slot with the
// bf16-rounded pre-scaled query times the codes times the per-(head, slot)
// scale, merge the new entry's score (query times the new codes, times the
// new scale) and value (code * scale) inside the softmax, and sum the
// bf16-rounded scale-folded probabilities times the value codes in f32.
// The new codes and scales are outputs; the caller writes them at `slot`.
//
// What bounds it on this card: each (row, head) reads len x 64 code bytes
// of K and of V (half at int4) and two scale rows, for ~4 FLOP per byte --
// far below the H100's ~295 FLOP/byte balance point, so it is bound by the
// cache read and, at len <= 480, by latency.  The design:
//   * one block of 128 threads per (head, row, audio): 100 blocks at beam 5,
//     each reading exactly the bytes its row needs -- through `anc` it
//     reads position t of physical row anc[b, j, t] directly, where the TPU
//     kernel stacks all K beams' queries and scores every physical row with
//     a mask to fill its MXU (K times the work for the same softmax);
//   * pass 1 gives each thread one cache position (one 64-byte read of the
//     head's codes) and keeps the scores in shared memory, so the softmax
//     is normalised before the probabilities are scaled and rounded to bf16
//     exactly where the TPU kernel rounds them; pass 2 streams V with 64
//     consecutive threads on 64 consecutive bytes;
//   * the int4 lane packing puts column c and column c + D/2 in one byte,
//     which pairs head h with head h + H/2, so the block of head h < H/2
//     also quantizes head h + H/2 and writes the whole packed bytes of the
//     pair; the quantization is the same code in both blocks, so the codes
//     agree;
//   * all sums run in a fixed order (no atomics): the same input gives the
//     same bits on every run, and the new codes and scales equal the plain
//     version's exactly (rintf, a true division by the scale, no fast math).
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

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

// value of column d (0..63) of the head's 64 stored bytes
__device__ __forceinline__ float code_at(uint32_t byte, int int4, int hi) {
  if (!int4) return (float)(int8_t)byte;
  const int v = hi ? (int)((byte >> 4) & 0xF) : (int)(byte & 0xF);
  return (float)((v ^ 8) - 8);
}

// Quantize 64 values (two per lane) with the per-head symmetric scheme.
__device__ __forceinline__ void quantize_head(const float* src, int lane, float inv_lv, float lv,
                                              int* codes, float* scale) {
  const float x0 = src[lane], x1 = src[lane + 32];
  const float m = warp_max(fmaxf(fabsf(x0), fabsf(x1)));
  const float sc = __fmul_rn(fmaxf(m, 1e-8f), inv_lv);
  codes[lane] = (int)fminf(fmaxf(rintf(__fdiv_rn(x0, sc)), -lv), lv);
  codes[lane + 32] = (int)fminf(fmaxf(rintf(__fdiv_rn(x1, sc)), -lv), lv);
  if (lane == 0) *scale = sc;
}

// Block reduction in a fixed order: warps reduce, then warp 0 sums the
// warps' results in index order.  `op` 0 = sum, 1 = max.
__device__ __forceinline__ float block_reduce(float v, float* s_tmp, int op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = op ? warp_max(v) : warp_sum(v);
  if (lane == 0) s_tmp[warp] = v;
  __syncthreads();
  float r = s_tmp[0];
  for (int w = 1; w < kWarps; ++w) r = op ? fmaxf(r, s_tmp[w]) : r + s_tmp[w];
  __syncthreads();
  return r;
}

template <bool kIndirect>
__global__ void __launch_bounds__(kThreads) self_attn_step_kernel(
    const float* __restrict__ qkv, const uint8_t* __restrict__ kc, const float* __restrict__ ks,
    const uint8_t* __restrict__ vc, const float* __restrict__ vs, const int* __restrict__ anc,
    const int* __restrict__ pad, float* __restrict__ attn, uint8_t* __restrict__ k_new,
    float* __restrict__ ks_new, uint8_t* __restrict__ v_new, float* __restrict__ vs_new, int K,
    int len, int HP, int slot, int int4) {
  extern __shared__ __align__(16) unsigned char sa_smem[];
  float* s_score = reinterpret_cast<float*>(sa_smem);           // len: scores, then probs
  int* s_row = reinterpret_cast<int*>(s_score + len);           // len: physical row or -1
  __shared__ float s_q[kDh], s_vq[kDh], s_red[2 * kDh], s_tmp[kWarps], s_scale[4];
  __shared__ int s_codes[4][kDh];  // k, v of head h; k, v of the int4 partner head

  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.x, D = H * kDh, d_store = int4 ? D / 2 : D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = b * K + j;
  const float* q_src = qkv + (size_t)row * 3 * D;
  const float lv = int4 ? 7.f : 127.f;
  const float inv_lv = int4 ? (1.f / 7.f) : (1.f / 127.f);
  const bool pair_owner = int4 && h < H / 2;
  const int col_off = (int4 && h >= H / 2) ? (h - H / 2) * kDh : h * kDh;
  const int hi = int4 && h >= H / 2;

  // the new entry: k, v of head h (warps 0, 1) and of the partner head
  // h + H/2 whose nibbles share the packed bytes (warps 2, 3)
  if (warp < 2) {
    quantize_head(q_src + (warp + 1) * D + h * kDh, lane, inv_lv, lv, s_codes[warp],
                  &s_scale[warp]);
  } else if (pair_owner) {
    quantize_head(q_src + (warp - 1) * D + (h + H / 2) * kDh, lane, inv_lv, lv, s_codes[warp],
                  &s_scale[warp]);
  }
  if (tid < kDh) s_q[tid] = bf16_round(__fmul_rn(q_src[h * kDh + tid], 0.125f));
  __syncthreads();

  if (tid < kDh) {
    const int d = tid;
    if (!int4) {
      k_new[(size_t)row * D + h * kDh + d] = (uint8_t)(int8_t)s_codes[0][d];
      v_new[(size_t)row * D + h * kDh + d] = (uint8_t)(int8_t)s_codes[1][d];
    } else if (pair_owner) {
      const size_t o = (size_t)row * d_store + h * kDh + d;
      k_new[o] = (uint8_t)((s_codes[0][d] & 0xF) | ((s_codes[2][d] & 0xF) << 4));
      v_new[o] = (uint8_t)((s_codes[1][d] & 0xF) | ((s_codes[3][d] & 0xF) << 4));
    }
    s_vq[d] = __fmul_rn((float)s_codes[1][d], s_scale[1]);
    if (d == 0) {
      ks_new[(size_t)row * H + h] = s_scale[0];
      vs_new[(size_t)row * H + h] = s_scale[1];
    }
  }
  // the new entry's own score: bf16 query . new codes, then the new scale
  float self_part = 0.f;
  if (warp == 0) {
    self_part = warp_sum(fmaf(s_q[lane], (float)s_codes[0][lane],
                              __fmul_rn(s_q[lane + 32], (float)s_codes[0][lane + 32])));
  }
  if (warp == 0 && lane == 0) s_tmp[0] = __fmul_rn(self_part, s_scale[0]);
  __syncthreads();
  const float s_self = s_tmp[0];
  __syncthreads();

  // pass 1: scores of the cached positions pad <= t < slot
  const int T = min(slot, len);
  const int pad_j = pad[row];
  float m = s_self;
  for (int t = tid; t < T; t += kThreads) {
    int r = j;
    if (kIndirect) r = anc[(size_t)row * len + t];
    float score = kNegInf;
    if (t < pad_j || r < 0 || r >= K) {
      r = -1;
    } else {
      const size_t prow = (size_t)b * K + r;
      const uint4* src =
          reinterpret_cast<const uint4*>(kc + (prow * len + t) * d_store + col_off);
      float dot = 0.f;
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        const uint4 v = __ldg(src + qd);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const uint32_t byte = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
          dot = fmaf(s_q[qd * 16 + i], code_at(byte, int4, hi), dot);
        }
      }
      score = __fmul_rn(dot, ks[(prow * HP + h) * len + t]);
    }
    s_score[t] = score;
    s_row[t] = r;
    m = fmaxf(m, score);
  }
  m = block_reduce(m, s_tmp, 1);
  float e = 0.f;
  for (int t = tid; t < T; t += kThreads) e += expf(s_score[t] - m);
  const float e_self = expf(s_self - m);
  const float denom = block_reduce(e, s_tmp, 0) + e_self;
  for (int t = tid; t < T; t += kThreads) {
    const int r = s_row[t];
    float p = 0.f;
    if (r >= 0) {
      const float vsc = vs[(((size_t)b * K + r) * HP + h) * len + t];
      p = bf16_round(__fmul_rn(__fdiv_rn(expf(s_score[t] - m), denom), vsc));
    }
    s_score[t] = p;
  }
  __syncthreads();

  // pass 2: out[d] = sum_t p[t] * v[t, d] + p_self * vq[d]
  {
    const int d = tid % kDh, grp = tid / kDh;
    float acc = 0.f;
    for (int t = grp; t < T; t += kThreads / kDh) {
      const int r = s_row[t];
      if (r < 0) continue;
      const uint32_t byte = vc[(((size_t)b * K + r) * len + t) * d_store + col_off + d];
      acc = fmaf(s_score[t], code_at(byte, int4, hi), acc);
    }
    s_red[grp * kDh + d] = acc;
  }
  __syncthreads();
  if (tid < kDh) {
    const float p_self = __fdiv_rn(e_self, denom);
    attn[(size_t)row * D + h * kDh + tid] =
        __fadd_rn(__fadd_rn(s_red[tid], s_red[kDh + tid]), __fmul_rn(p_self, s_vq[tid]));
  }
}

}  // namespace

// qkv (B, K, 3D) f32; k/v (B, K, len, D) int8 or (B, K, len, D/2) uint8;
// ks/vs (B, K, HP, len) f32; anc (B, K, len) int32 or NULL; pad (B, K) int32;
// attn (B, K, D) f32; k_new/v_new (B, K, D or D/2); ks_new/vs_new (B, K, H).
extern "C" int ttasr_self_attn_step(const void* qkv, const void* k, const void* ks,
                                    const void* v, const void* vs, const void* anc,
                                    const void* pad, void* attn, void* k_new, void* ks_new,
                                    void* v_new, void* vs_new, int B, int K, int H, int len,
                                    int HP, int slot, int int4, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((int4 && H % 2) || HP < H || slot < 0 || slot > len || len < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)len * (sizeof(float) + sizeof(int));
  const dim3 grid(H, K, B);
  const auto* q = static_cast<const float*>(qkv);
  const auto* kk = static_cast<const uint8_t*>(k);
  const auto* vv = static_cast<const uint8_t*>(v);
  const auto* kss = static_cast<const float*>(ks);
  const auto* vss = static_cast<const float*>(vs);
  const auto* pd = static_cast<const int*>(pad);
  auto* out = static_cast<float*>(attn);
  auto* kn = static_cast<uint8_t*>(k_new);
  auto* vn = static_cast<uint8_t*>(v_new);
  auto* ksn = static_cast<float*>(ks_new);
  auto* vsn = static_cast<float*>(vs_new);
  // the cache length is at most a few hundred slots: the scores fit the
  // default 48 KB of dynamic shared memory, so no attribute is needed
  if (smem + 4096 > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (anc) {
    self_attn_step_kernel<true><<<grid, kThreads, smem, st>>>(
        q, kk, kss, vv, vss, static_cast<const int*>(anc), pd, out, kn, ksn, vn, vsn, K, len, HP,
        slot, int4);
  } else {
    self_attn_step_kernel<false><<<grid, kThreads, smem, st>>>(
        q, kk, kss, vv, vss, nullptr, pd, out, kn, ksn, vn, vsn, K, len, HP, slot, int4);
  }
  return (int)cudaGetLastError();
}
