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
// of K and of V and two scale rows (3.5 MB per layer at beam 5, len 480,
// int4, large-v3) for ~4 FLOP per byte -- far below the H100's ~295
// FLOP/byte balance point, so it is bound by the cache read and, at len <=
// 480, by latency (the byte bound, ~1 us, is below the launch floor).  The
// design:
//   * a thread-block cluster of 256-thread blocks per (head, row, audio),
//     the cache positions split into `splits` contiguous ranges, one block
//     each; sa_splits() takes the count from (len, H, B * K) alone (enough
//     blocks for the 132 SMs, at most 8, no range under 64 positions, more
//     where a range would not fit shared memory), so every sum's order is
//     fixed by the shape: B2 and B10 at one shape do the same arithmetic,
//     and a run gives the same bits every time.  At int4 a block reads the
//     64 bytes of its head's columns and uses one nibble of each (the
//     other is head h +- H/2); one cluster per head pair, reading each
//     byte once, measured slower (fewer blocks, twice the work in each);
//   * every byte a block reads from the cache is in flight at once: B2's
//     anc entries of a batch of positions first (one round trip), then its
//     K pieces (4 x 16 bytes per position, gathered by row) and scales by
//     cp.async in one group and the V pieces in the next, all issued before
//     the first wait, after the loads of the new entry (which would wait
//     behind the stage); pass 1 waits for the K group only;
//   * pass 1 scores the block's positions from shared memory with 4
//     threads per position (16 bytes each, codes to f32 by bit tricks, two
//     shuffles, two positions' chains in flight);
//   * an exact softmax across the cluster with two cluster barriers, no
//     flash-decoding rescale (the contract rounds the normalised
//     probability times vs): each block pushes its positions' scores and
//     its warps' maxima into every peer's shared memory, so after one
//     barrier every block holds the whole score row and computes the same
//     maximum and the same denominator -- each rank's sum of exp(s - m) as
//     that rank's threads would take it, the ranks' sums added in rank
//     order, e_self last -- keeping exp(s - m) of its own positions; this
//     costs each block the expf of every position (len / 256 per thread)
//     and saves the barrier that a separate exchange of maxima would take;
//   * pass 2 reads V from shared memory, 8 bytes (8 columns) per thread;
//     the blocks' partial outputs go into the shared memory of the rank
//     that owns each element (second barrier), which adds them in rank
//     order and p_self * vq last (cluster_add_outputs, shared with the
//     cross-attention); rank 0 alone writes the new codes and scales, at
//     the end (stores issued behind the stage wait for it);
//   * a one-block cluster (len < 128, or B * K * H >= 132) takes block
//     barriers for the cluster barriers; loops that run once per block are
//     kept rolled (the sums' loop unrolled over 8 ranks measured 0.9 us
//     against 0.5, likely its instruction fetch: each block runs it once);
//   * no programmatic dependent launch: B2 and B10 are C calls of their
//     own, which cannot know that the kernel before them in the stream is
//     B1 (a caller may have written the caches in the kernel just before),
//     so reading the cache before griddepcontrol.wait would not be safe.
// A block whose positions are all masked adds exp(finfo.min - m) = 0 to
// the sums and zeros to the output.  Every sum runs in a fixed order (no
// atomics), and the new codes and scales equal the plain version's exactly
// (rintf, a true division by the scale, no fast math).
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes.

#include "cross_attention.cuh"

namespace ttasr {
namespace {

constexpr int kSaThreads = 256;
constexpr int kSaWarps = kSaThreads / 32;
constexpr int kSaScoreRows = kSaThreads / 4;  // positions per pass-1 sweep
constexpr int kSaPvRows = kSaThreads / 8;     // positions per pass-2 sweep
constexpr int kSaBatch = 4;  // 16-byte pieces a thread issues per batch (B2: anc loads together)
constexpr int kSaMinPositions = 64;  // a range shorter than this is not worth a cluster barrier
constexpr size_t kSaMaxDynSmem = kMaxSmem - 4096;  // the static arrays take < 4 KB

struct SaArgs {
  const float* qkv;
  const uint8_t* kc;
  const float* ks;
  const uint8_t* vc;
  const float* vs;
  const int* anc;  // NULL for B10
  const int* pad;
  float* attn;
  uint8_t* k_new;
  float* ks_new;
  uint8_t* v_new;
  float* vs_new;
  int K, H, len, HP, slot;
};

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Quantize 64 values (x0 = value lane, x1 = value lane + 32) with the
// per-head symmetric scheme.
__device__ __forceinline__ void quantize_head(float x0, float x1, int lane, float inv_lv, float lv,
                                              int* codes, float* scale) {
  const float m = warp_max(fmaxf(fabsf(x0), fabsf(x1)));
  const float sc = __fmul_rn(fmaxf(m, 1e-8f), inv_lv);
  codes[lane] = (int)fminf(fmaxf(rintf(__fdiv_rn(x0, sc)), -lv), lv);
  codes[lane + 32] = (int)fminf(fmaxf(rintf(__fdiv_rn(x1, sc)), -lv), lv);
  if (lane == 0) *scale = sc;
}

// A thread's 4 * n_words codes of one head as f32: int8 bytes, or the
// nibbles at bit `shift` (0 low, 4 high) of each byte
__device__ __forceinline__ void unpack_head(const uint32_t* w, int n_words, bool int4, int shift,
                                            float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= n_words) break;
    if (int4) {
      const uint32_t u = (w[i] >> shift) ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < 4; ++j) c[4 * i + j] = int4_code(u, 2 * j);
    } else {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) c[4 * i + j] = int8_code(u, j);
    }
  }
}

__host__ __device__ inline int sa_per(int len, int splits) { return (len + splits - 1) / splits; }

// s_k and s_v (per x 64 bytes each), s_ks and s_vs (per each), s_sc (len),
// s_red (warps x 64), s_outg (splits x 64), s_live (per)
inline size_t sa_smem_bytes(int len, int splits) {
  const size_t per = sa_per(len, splits);
  return 2 * per * kDh + sizeof(float) * (2 * per + len + (size_t)(kSaWarps + splits) * kDh) + per;
}

// Blocks per cluster from the shapes alone: enough for the 132 SMs, at
// most 8, no range shorter than kSaMinPositions, and more where one
// block's range would not fit.
inline int sa_splits(int units, int len) {
  int s = std::min({kMaxSplits, (kTargetBlocks + units - 1) / units, len / kSaMinPositions});
  s = std::max(1, s);
  while (s < kMaxSplits && sa_smem_bytes(len, s) > kSaMaxDynSmem) ++s;
  return s;
}

// One cluster of `splits` blocks per (head, row): grid (H, B*K, splits).
// kInt4: the head's codes are one nibble of the bytes it shares with head
// h +- H/2 (low for h < H/2).
template <bool kIndirect, bool kInt4>
__global__ void __launch_bounds__(kSaThreads) self_attn_step_kernel(const SaArgs a) {
  extern __shared__ __align__(16) unsigned char sa_smem[];
  __shared__ float s_q[kDh], s_vq[kDh], s_scale[4], s_self, s_pself;
  __shared__ int s_codes[4][kDh];  // new k, v codes (int4: k, v of the pair's low head, then high)
  __shared__ float s_wmax[kMaxSplits][kSaWarps];  // every rank's warp maxima
  __shared__ float s_wsum[kMaxSplits][kSaWarps];  // each rank's sums of exp(s - m), by warp
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (splits > 1) cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, D = H * kDh, d_store = kInt4 ? D / 2 : D, len = a.len, half = H / 2;
  const int h = blockIdx.x, row = blockIdx.y, b = row / a.K, j = row - b * a.K;
  const int pair = kInt4 ? h % half : h;  // int4: the byte column block of the pair
  const int shift = kInt4 && h >= half ? 4 : 0;  // the head's nibble
  const int own = shift ? 2 : 0;  // int4: s_codes/s_scale index of the head's k

  const int per = sa_per(len, splits);
  const int lo = min(len, rank * per), n = min(len, lo + per) - lo;
  const int T = a.slot, live1 = min(lo + n, T);  // positions >= slot are masked
  const int pad_j = a.pad[row];  // masks in pass 1: the stage does not wait for it
  uint8_t* s_k = sa_smem;                                      // per x 64 K bytes
  uint8_t* s_v = s_k + (size_t)per * kDh;                      // per x 64 V bytes
  float* s_ks = reinterpret_cast<float*>(s_v + (size_t)per * kDh);  // per
  float* s_vs = s_ks + per;
  float* s_sc = s_vs + per;  // len: every rank's scores; own range then e, then p
  float* s_red = s_sc + len;               // warps x 64
  float* s_outg = s_red + kSaWarps * kDh;  // splits x 64: the ranks' partial outputs
  unsigned char* s_live = reinterpret_cast<unsigned char*>(s_outg + splits * kDh);

  // every byte of the block's range in flight at once, K and ks in one
  // group and V and vs in the next, so pass 1 waits for the first only:
  // piece i is quarter i & 3 of position lo + (i >> 2); B2 loads a batch's
  // anc entries first
  const size_t rows0 = (size_t)b * a.K;  // the audio's first physical row
  auto issue = [&](bool values) {
    for (int base = 0; base < n * 4; base += kSaThreads * kSaBatch) {
      int phys[kSaBatch];
#pragma unroll
      for (int u = 0; u < kSaBatch; ++u) {
        const int i = base + tid + u * kSaThreads, t = lo + (i >> 2);
        phys[u] = -1;
        if (i < n * 4 && t < live1) phys[u] = kIndirect ? __ldg(a.anc + (size_t)row * len + t) : j;
      }
#pragma unroll
      for (int u = 0; u < kSaBatch; ++u) {
        const int i = base + tid + u * kSaThreads, p = i >> 2, q = i & 3;
        if (i < n * 4) {
          const int r = phys[u];
          const bool live = r >= 0 && r < a.K;
          if (!values && q == 0) s_live[p] = live;
          if (live) {
            const size_t prow = rows0 + r, t = (size_t)lo + p;
            const size_t src = (prow * len + t) * d_store + pair * kDh + q * 16;
            cp_async16((values ? s_v : s_k) + p * kDh + q * 16, (values ? a.vc : a.kc) + src);
            if (q == (int)values)  // quarter 0: ks, 1: vs
              cp_async4((values ? s_vs : s_ks) + p,
                        (values ? a.vs : a.ks) + (prow * a.HP + h) * len + t);
          }
        }
      }
    }
    cp_async_commit();
  };
  // the new entry: int4 warps 0-3 quantize k, v of the pair's low head and
  // of its high head (both nibbles of the new bytes), int8 warps 0, 1 those
  // of head h; their loads go out before the stage, not behind it
  const float* q_src = a.qkv + (size_t)row * 3 * D;
  const bool quantizer = warp < (kInt4 ? 4 : 2);
  float x0 = 0.f, x1 = 0.f, qx = 0.f;
  if (quantizer) {
    const float* src = q_src + (1 + (warp & 1)) * D + (kInt4 ? pair + (warp >> 1) * half : h) * kDh;
    x0 = src[lane];
    x1 = src[lane + 32];
  }
  if (tid < kDh) qx = q_src[h * kDh + tid];
  issue(false);
  issue(true);
  if (quantizer) {
    const float lv = kInt4 ? 7.f : 127.f, inv_lv = kInt4 ? (1.f / 7.f) : (1.f / 127.f);
    quantize_head(x0, x1, lane, inv_lv, lv, s_codes[warp], &s_scale[warp]);
  }
  if (tid < kDh) s_q[tid] = bf16_round(__fmul_rn(qx, 0.125f));
  cp_async_wait_group<1>();  // K and ks
  __syncthreads();

  if (splits > 1) cluster_wait();  // every block runs: its shared memory may be written

  // pass 1: scores of the block's positions, 4 threads x 16 bytes each,
  // pushed into every rank's score row (quarter q writes ranks q, q + 4),
  // then each warp's maximum into every rank
  {
    const int quarter = tid & 3;
    float qv[16], m = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) qv[i] = s_q[quarter * 16 + i];
#pragma unroll 2  // two positions' chains in flight
    for (int p0 = 0; p0 < n; p0 += kSaScoreRows) {
      const int p = p0 + (tid >> 2);
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (p < n) raw = *reinterpret_cast<const uint4*>(s_k + p * kDh + quarter * 16);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float c[16];
      unpack_head(words, 4, kInt4, shift, c);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) dot = fmaf(qv[i], c[i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (p < n) {
        const bool live = s_live[p] && lo + p >= pad_j;
        const float sc = live ? __fmul_rn(dot, s_ks[p]) : kNegInf;
        m = fmaxf(m, sc);
        for (int dst = quarter; dst < splits; dst += 4)
          cluster_peer(cluster, s_sc, dst, rank)[lo + p] = sc;
      }
    }
    m = warp_max(m);
    if (lane < splits) cluster_peer(cluster, &s_wmax[0][0], lane, rank)[rank * kSaWarps + warp] = m;
  }
  // the new entry's score (bf16 query . new codes, then the new scale) and
  // f32 values
  if (warp == 0) {
    const float part = warp_sum(fmaf(s_q[lane], (float)s_codes[own][lane],
                                     __fmul_rn(s_q[lane + 32], (float)s_codes[own][lane + 32])));
    if (lane == 0) s_self = __fmul_rn(part, s_scale[own]);
  }
  if (tid < kDh) s_vq[tid] = __fmul_rn((float)s_codes[own + 1][tid], s_scale[own + 1]);
  cluster_barrier(cluster, splits);  // every block holds the whole score row and the warps' maxima

  // the maximum, in every warp: the ranks' warp maxima and the new entry
  float m;
  {
    float v = kNegInf;
    for (int i = lane; i < splits * kSaWarps; i += 32) v = fmaxf(v, (&s_wmax[0][0])[i]);
    m = fmaxf(warp_max(v), s_self);
  }
  // each rank's sum of exp(s - m) as its own threads would take it (thread
  // tid every 256th position of the range, a warp butterfly, the warps in
  // order); the block keeps exp(s - m) of its own positions
#pragma unroll 1
  for (int q = 0; q < splits; ++q) {
    const int qlo = min(len, q * per), qhi = min(min(len, qlo + per), T);
    float e_sum = 0.f;
    for (int t = qlo + tid; t < qhi; t += kSaThreads) {
      const float e = expf(s_sc[t] - m);
      if (q == rank) s_sc[t] = e;
      e_sum += e;
    }
    e_sum = warp_sum(e_sum);
    if (lane == 0) s_wsum[q][warp] = e_sum;
  }
  cp_async_wait_all();  // V and vs
  __syncthreads();
  // the denominator, in every thread: the ranks' sums in rank order (each
  // its warps' in order), then the new entry's
  float den;
  {
    float l = 0.f;
    for (int q = 0; q < splits; ++q) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kSaWarps; ++w) s += s_wsum[q][w];
      l += s;
    }
    const float e_self = expf(s_self - m);
    den = l + e_self;
    if (tid == 0) s_pself = __fdiv_rn(e_self, den);
  }
  // bf16(p * vs) of the own positions, exactly where the TPU kernel rounds
  const int n_live = max(0, live1 - lo);
  for (int p = tid; p < n_live; p += kSaThreads) {
    const float e = s_sc[lo + p];
    s_sc[lo + p] = e > 0.f ? bf16_round(__fmul_rn(__fdiv_rn(e, den), s_vs[p])) : 0.f;
  }
  __syncthreads();

  // pass 2: out[d] = sum_t p[t] * v[t, d] over the own positions; a thread
  // takes 8 columns (8 bytes: at int4 both nibbles) of every 32nd position
  {
    const int cgp = tid & 7, prow = tid >> 3;
    float acc[1][8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[0][c] = 0.f;
    for (int p = prow; p < n_live; p += kSaPvRows) {
      const uint2 raw = *reinterpret_cast<const uint2*>(s_v + p * kDh + cgp * 8);
      const uint32_t words[2] = {raw.x, raw.y};
      float cv[8];
      unpack_head(words, 2, kInt4, shift, cv);
      const float pr = s_sc[lo + p];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[0][c] = fmaf(pr, cv[c], acc[0][c]);
    }
    // the block's partial output into the rank that owns each element; the
    // owners add them in rank order, then p_self * vq
    cluster_add_outputs<kSaThreads>(cluster, acc, 1, s_red, s_outg, [&](int d, float v) {
      a.attn[(size_t)row * D + h * kDh + d] = __fadd_rn(v, __fmul_rn(s_pself, s_vq[d]));
    });
  }
  // rank 0 writes the new codes and scales (last: stores issued behind the
  // stage would wait for it)
  if (rank == 0 && tid < kDh) {
    const int d = tid;
    if (!kInt4) {
      a.k_new[(size_t)row * D + h * kDh + d] = (uint8_t)(int8_t)s_codes[0][d];
      a.v_new[(size_t)row * D + h * kDh + d] = (uint8_t)(int8_t)s_codes[1][d];
    } else if (h < half) {  // the pair's packed bytes, once
      const size_t o = (size_t)row * d_store + pair * kDh + d;
      a.k_new[o] = (uint8_t)((s_codes[0][d] & 0xF) | ((s_codes[2][d] & 0xF) << 4));
      a.v_new[o] = (uint8_t)((s_codes[1][d] & 0xF) | ((s_codes[3][d] & 0xF) << 4));
    }
    if (d == 0) {
      a.ks_new[(size_t)row * H + h] = s_scale[own];
      a.vs_new[(size_t)row * H + h] = s_scale[own + 1];
    }
  }
}

template <bool kIndirect, bool kInt4>
cudaError_t launch_step(const SaArgs& a, int B, int splits, size_t smem, cudaStream_t st) {
  static size_t limit = 0;
  const cudaError_t err = reserve_smem(self_attn_step_kernel<kIndirect, kInt4>, smem, &limit);
  if (err != cudaSuccess) return err;
  return launch_cluster(self_attn_step_kernel<kIndirect, kInt4>, dim3(a.H, B * a.K, splits),
                        dim3(1, 1, splits), kSaThreads, smem, st, false, a);
}

}  // namespace
}  // namespace ttasr

// qkv (B, K, 3D) f32; k/v (B, K, len, D) int8 or (B, K, len, D/2) uint8;
// ks/vs (B, K, HP, len) f32; anc (B, K, len) int32 or NULL; pad (B, K) int32;
// attn (B, K, D) f32; k_new/v_new (B, K, D or D/2); ks_new/vs_new (B, K, H).
extern "C" int ttasr_self_attn_step(const void* qkv, const void* k, const void* ks,
                                    const void* v, const void* vs, const void* anc,
                                    const void* pad, void* attn, void* k_new, void* ks_new,
                                    void* v_new, void* vs_new, int B, int K, int H, int len,
                                    int HP, int slot, int int4, void* stream) {
  using namespace ttasr;
  if ((int4 && H % 2) || H < 1 || HP < H || B < 1 || K < 1 || B * K > 65535 || slot < 0 ||
      slot > len || len < 1 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  const int splits = sa_splits(B * K * H, len);
  const size_t smem = sa_smem_bytes(len, splits);
  if (smem > kSaMaxDynSmem) return (int)cudaErrorInvalidValue;  // no split holds this len
  const SaArgs a{static_cast<const float*>(qkv), static_cast<const uint8_t*>(k),
                 static_cast<const float*>(ks),  static_cast<const uint8_t*>(v),
                 static_cast<const float*>(vs),  static_cast<const int*>(anc),
                 static_cast<const int*>(pad),   static_cast<float*>(attn),
                 static_cast<uint8_t*>(k_new),   static_cast<float*>(ks_new),
                 static_cast<uint8_t*>(v_new),   static_cast<float*>(vs_new),
                 K, H, len, HP, slot};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (anc)
    err = int4 ? launch_step<true, true>(a, B, splits, smem, st)
               : launch_step<true, false>(a, B, splits, smem, st);
  else
    err = int4 ? launch_step<false, true>(a, B, splits, smem, st)
               : launch_step<false, false>(a, B, splits, smem, st);
  return (int)err;
}
