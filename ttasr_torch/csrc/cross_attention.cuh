// Per-head cross-attention of a decode step over the quantized cross-KV
// cache, shared by decoder_blocks.cu (B3 and B16, after their cross query)
// and cross_attention.cu (B13, on caller-given queries), so the three
// cannot drift -- as the TPU kernels share _cross_pairs_loop
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
// at these sizes, by latency.  One (head, audio) is 20 of the 132 SMs at
// beam 5, so the design splits S over a thread-block cluster:
//   * the grid is (H, B, splits), one cluster of `splits` blocks per (head,
//     audio), splits = 1 when H * B fills the card, else enough for 132
//     blocks, at most 8 (the portable cluster size); each block owns a
//     contiguous range of cache rows (int4: packed row p holds slots p and
//     p + S/2) and reads each K/V byte of it once for all K beam rows;
//   * every byte a block reads from the cache (its K and V rows by 16-byte
//     cp.async, its slots' scales by 4-byte ones) is in flight at once,
//     while the queries load; pass 1 scores its slots from shared memory
//     with 4 threads per row (16 bytes each, two shuffles);
//   * an exact softmax across the cluster, no flash-decoding rescale (that
//     would round an unnormalised probability, and the contract rounds the
//     normalised one times vs): the blocks exchange their row maxima
//     through distributed shared memory, each sums exp(s - m) over its own
//     slots (expf once per slot), the sums are exchanged and added in rank
//     order, and each block writes bf16(exp(s - m) / denom * vs) for its
//     slots, exactly where the TPU kernel rounds;
//   * pass 2 reads V from shared memory 8 bytes (8 columns) per thread,
//     and the blocks' partial outputs (K x 64 f32) are added in rank order
//     through distributed shared memory, then written once;
//   * every exchange pushes: a block writes its maxima, sums and partial
//     outputs into the shared memory of the blocks that need them, and one
//     cluster barrier per exchange makes them visible (three in all; a
//     block barrier for a one-block cluster); the partial outputs' exchange
//     is cluster_add_outputs, which the self-attention step
//     (self_attention.cu) shares; codes become f32 by a bit trick
//     (int8_code, int4_code), not by I2F;
//   * after B3's and B16's query GEMM it starts early (programmatic
//     dependent launch): the cache rows are in flight before it waits for
//     the queries.
// A block whose slots are all masked contributes exp(finfo.min - m) = 0 to
// the sums and zeros to the output.  The TPU's head-pair block-diagonal
// query tile is a lane-alignment device of the TPU and is not carried
// over.  Sums run in a fixed order (no atomics): the same input gives the
// same bits on every run.

#pragma once

#include "skinny_gemm.cuh"

namespace ttasr {
namespace {

constexpr int kDh = 64;
constexpr int kCrossThreads = 256;
constexpr int kCrossWarps = kCrossThreads / 32;
constexpr int kMaxBeams = 8;
static_assert(kMaxBeams * kDh <= 2 * kCrossThreads, "two queries per thread");
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
// s_stat: warp partials (8 warps x 8 rows), the block's value per row, the
// peers' maxima and sums (8 ranks x 8 rows each), the global maximum and
// the denominator per row
constexpr int kStatBlock = kCrossWarps * kMaxBeams, kStatMaxes = kStatBlock + kMaxBeams;
constexpr int kStatSums = kStatMaxes + kMaxSplits * kMaxBeams;
constexpr int kStatGlobalMax = kStatSums + kMaxSplits * kMaxBeams;
constexpr int kStatDenom = kStatGlobalMax + kMaxBeams, kStatFloats = kStatDenom + kMaxBeams;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// int4 code j (0..7, low nibble first) of u = word ^ 0x88888888 as f32, exactly
__device__ __forceinline__ float int4_code(uint32_t u, int j) {
  return __fadd_rn(__uint_as_float(((u >> (4 * j)) & 0xFu) | 0x4B000000u), -8388616.f);
}

// Rank dst's copy of the shared array p (the block's own, directly)
template <typename T>
__device__ __forceinline__ T* cluster_peer(cg::cluster_group& cluster, T* p, int dst, int rank) {
  return dst == rank ? p : cluster.map_shared_rank(p, dst);
}

// The cluster barrier where the cluster has peers, else the block's (no
// release of the block's global writes to wait for)
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster, int splits) {
  if (splits > 1)
    cluster.sync();
  else
    __syncthreads();
}

// The blocks' P.V partial outputs (rows x 64 each) added and stored once.
// acc[r][c] is a thread's sum for column 8 * (tid & 7) + c of row r over
// its positions (every kThreads / 8-th).  The 4 threads of a warp with the
// same columns are paired (xor 8, 16), the warps added in order into the
// rank that owns each element (i % splits), and the owner adds the ranks'
// parts in rank order and calls store(i, v), i = r * 64 + d.  s_red: warps
// x rows x 64; s_outg: splits x rows x 64.
template <int kThreads, int kRows, typename Store>
__device__ __forceinline__ void cluster_add_outputs(cg::cluster_group& cluster,
                                                    float (&acc)[kRows][8], int rows,
                                                    float* s_red, float* s_outg, Store store) {
  constexpr int kWarps = kThreads / 32;
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, cgp = tid & 7;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float v = acc[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][c] = v;
      }
    }
  }
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows)
#pragma unroll
        for (int c = 0; c < 8; ++c) s_red[(warp * rows + r) * kDh + cgp * 8 + c] = acc[r][c];
  }
  __syncthreads();
  for (int i = tid; i < rows * kDh; i += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += s_red[w * rows * kDh + i];
    cluster_peer(cluster, s_outg, i % splits, rank)[rank * rows * kDh + i] = v;
  }
  cluster_barrier(cluster, splits);  // the last access to a peer's shared memory is before this
  for (int i = rank + splits * tid; i < rows * kDh; i += splits * kThreads) {
    float v = 0.f;
    for (int q = 0; q < splits; ++q) v += s_outg[q * rows * kDh + i];
    store(i, v);
  }
}

__host__ __device__ inline int cross_rows_per_block(int rows, int splits) {
  return (rows + splits - 1) / splits;
}

// s_k and s_v (per x 64 bytes each), s_q, s_red, s_outg (splits x K x 64),
// s_stat, the block's ks and vs (stride each) and s_p (K x stride)
inline size_t cross_smem_bytes(int K, int S, int packed, int splits) {
  const size_t per = cross_rows_per_block(packed ? S / 2 : S, splits);
  const size_t stride = packed ? 2 * per : per;
  return 2 * per * kDh +
         sizeof(float) * (kMaxBeams * kDh + (kCrossWarps + splits) * (size_t)K * kDh +
                          kStatFloats + (2 + (size_t)K) * stride);
}

// Each thread's 16 codes of one cache row (4 words) as f32, low and high
// nibbles (int4: slots p and p + S/2) or the bytes (int8)
__device__ __forceinline__ void unpack_codes(const uint32_t* w, int n_words, int packed, float* lo,
                                             float* hi) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= n_words) break;
    if (packed) {
      const uint32_t u = w[i] ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[4 * i + j] = int4_code(u, 2 * j);
        hi[4 * i + j] = int4_code(u, 2 * j + 1);
      }
    } else {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) lo[4 * i + j] = int8_code(u, j);
    }
  }
}

// One cluster of `splits` blocks per (head h, audio b).  qc (B*K, D) f32
// pre-scaled queries; ck/cv (B, S_rows, D) int8 codes or uint8 nibble pairs
// (S_rows = S/2); cks/cvs (B, H, S) f32; cross (B*K, D) f32.  Instantiated
// for KB = 1 and 5 beam rows (greedy rows, beam 5), whose row loops unroll
// without a branch, and KB = 0 for any K <= 8; PACKED: int4 nibble pairs.
template <int KB, int PACKED>
__global__ void __launch_bounds__(kCrossThreads) cross_attention_kernel(
    const float* __restrict__ qc, const uint8_t* __restrict__ ck, const float* __restrict__ cks,
    const uint8_t* __restrict__ cv, const float* __restrict__ cvs, float* __restrict__ cross,
    int k_rows, int D, int S, int s_real) {
  constexpr bool packed = PACKED;
  const int K = KB ? KB : k_rows;  // a constant where KB > 0: the r < K tests fold away
  extern __shared__ __align__(16) unsigned char cross_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = packed ? S / 2 : S;
  const int per = cross_rows_per_block(rows, splits);
  const int p_lo = min(rows, rank * per), nr = min(rows, p_lo + per) - p_lo;
  const int nslot = packed ? 2 * nr : nr, stride = packed ? 2 * per : per;
  uint8_t* s_k = cross_smem;                // per x 64 K bytes
  uint8_t* s_v = s_k + (size_t)per * kDh;   // per x 64 V bytes
  float* s_q = reinterpret_cast<float*>(s_v + (size_t)per * kDh);  // 8 x 64 queries
  float* s_red = s_q + kMaxBeams * kDh;     // 8 warps x K x 64 partial outputs
  float* s_outg = s_red + kCrossWarps * K * kDh;  // splits x K x 64: the ranks' partial outputs
  float* s_stat = s_outg + splits * K * kDh;
  float* s_ks = s_stat + kStatFloats;  // the block's slots' scales
  float* s_vs = s_ks + stride;
  float* s_p = s_vs + stride;  // K x stride: scores, exponentials, probabilities
  // local slot j < nr is slot p_lo + j; j >= nr (packed) is slot p_lo + j - nr + S/2
  const size_t kv_base = (size_t)b * rows * D + (size_t)h * kDh;
  const float* ks_row = cks + ((size_t)b * H + h) * S;
  const float* vs_row = cvs + ((size_t)b * H + h) * S;

  // every byte the block reads from the cache, in flight at once
  for (int i = tid; i < nr * 4; i += kCrossThreads) {
    const size_t src = kv_base + (size_t)(p_lo + (i >> 2)) * D + (i & 3) * 16;
    cp_async16(s_k + i * 16, ck + src);
    cp_async16(s_v + i * 16, cv + src);
  }
  for (int j = tid; j < nslot; j += kCrossThreads) {
    const int slot = j < nr ? p_lo + j : p_lo + j - nr + rows;
    cp_async4(s_ks + j, ks_row + slot);
    cp_async4(s_vs + j, vs_row + slot);
  }
  cp_async_commit();
  griddep_launch_dependents();
  griddep_wait();  // the queries may come from the launch before

  {
    // K <= 8 rows of 64: at most two queries per thread, both loads in flight together
    float q[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kCrossThreads, r = i / kDh, d = i - r * kDh;
      q[j] = i < K * kDh ? qc[((size_t)b * K + r) * D + h * kDh + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (tid + j * kCrossThreads < K * kDh) s_q[tid + j * kCrossThreads] = bf16_round(q[j]);
  }
  cp_async_wait_all();
  __syncthreads();

  // pass 1: scores of the block's slots, 4 threads x 16 bytes per cache row
  {
    const int quarter = tid & 3;
    for (int p0 = 0; p0 < nr; p0 += kCrossThreads / 4) {
      const int p = p0 + (tid >> 2);
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (p < nr) raw = *reinterpret_cast<const uint4*>(s_k + p * kDh + quarter * 16);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float c_lo[16], c_hi[16];
      unpack_codes(words, 4, packed, c_lo, c_hi);
      float lo[kMaxBeams], hi[kMaxBeams];
#pragma unroll
      for (int r = 0; r < kMaxBeams; ++r) {
        lo[r] = hi[r] = 0.f;
        if (r < K) {
#pragma unroll
          for (int d4 = 0; d4 < 4; ++d4) {
            const float4 q = *reinterpret_cast<const float4*>(s_q + r * kDh + quarter * 16 + 4 * d4);
            const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              lo[r] = fmaf(qv[j], c_lo[4 * d4 + j], lo[r]);
              if (packed) hi[r] = fmaf(qv[j], c_hi[4 * d4 + j], hi[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxBeams; ++r) {
        if (r < K) {
          lo[r] += __shfl_xor_sync(0xffffffffu, lo[r], 1);
          lo[r] += __shfl_xor_sync(0xffffffffu, lo[r], 2);
          if (packed) {
            hi[r] += __shfl_xor_sync(0xffffffffu, hi[r], 1);
            hi[r] += __shfl_xor_sync(0xffffffffu, hi[r], 2);
          }
        }
      }
      if (quarter == 0 && p < nr) {
        const int s_lo = p_lo + p, s_hi = s_lo + rows;  // packed: slot p and p + S/2
#pragma unroll
        for (int r = 0; r < kMaxBeams; ++r) {
          if (r < K) {
            s_p[r * stride + p] = s_lo < s_real ? __fmul_rn(lo[r], s_ks[p]) : kNegInf;
            if (packed)
              s_p[r * stride + nr + p] = s_hi < s_real ? __fmul_rn(hi[r], s_ks[nr + p]) : kNegInf;
          }
        }
      }
    }
  }
  __syncthreads();

  // the softmax over the cluster: each block's row maxima go to every peer,
  {
    float m[kMaxBeams];
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r) m[r] = kNegInf;
    for (int j = tid; j < nslot; j += kCrossThreads)
#pragma unroll
      for (int r = 0; r < kMaxBeams; ++r)
        if (r < K) m[r] = fmaxf(m[r], s_p[r * stride + j]);
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r) {
      if (r < K) {
        m[r] = warp_max(m[r]);
        if (lane == 0) s_stat[warp * kMaxBeams + r] = m[r];
      }
    }
  }
  __syncthreads();
  if (tid < K) {
    float m = kNegInf;
    for (int w = 0; w < kCrossWarps; ++w) m = fmaxf(m, s_stat[w * kMaxBeams + tid]);
    s_stat[kStatBlock + tid] = m;
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster runs: its shared memory may be written
  if (tid < K * splits) {
    const int q = tid / K, r = tid - q * K;
    cluster_peer(cluster, s_stat, q, rank)[kStatMaxes + rank * kMaxBeams + r] =
        s_stat[kStatBlock + r];
  }
  cluster_barrier(cluster, splits);
  if (tid < K) {
    float m = kNegInf;
    for (int q = 0; q < splits; ++q) m = fmaxf(m, s_stat[kStatMaxes + q * kMaxBeams + tid]);
    s_stat[kStatGlobalMax + tid] = m;
  }
  __syncthreads();
  // then each block's sums of exp(s - m) over its slots, added in rank order
  {
    float e_sum[kMaxBeams];
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r) e_sum[r] = 0.f;
    for (int j = tid; j < nslot; j += kCrossThreads)
#pragma unroll
      for (int r = 0; r < kMaxBeams; ++r)
        if (r < K) {
          const float e = expf(s_p[r * stride + j] - s_stat[kStatGlobalMax + r]);
          s_p[r * stride + j] = e;
          e_sum[r] += e;
        }
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r) {
      if (r < K) {
        e_sum[r] = warp_sum(e_sum[r]);
        if (lane == 0) s_stat[warp * kMaxBeams + r] = e_sum[r];
      }
    }
  }
  __syncthreads();
  if (tid < K) {
    float l = 0.f;
    for (int w = 0; w < kCrossWarps; ++w) l += s_stat[w * kMaxBeams + tid];
    s_stat[kStatBlock + tid] = l;
  }
  __syncthreads();
  if (tid < K * splits) {
    const int q = tid / K, r = tid - q * K;
    cluster_peer(cluster, s_stat, q, rank)[kStatSums + rank * kMaxBeams + r] =
        s_stat[kStatBlock + r];
  }
  cluster_barrier(cluster, splits);
  if (tid < K) {
    float l = 0.f;
    for (int q = 0; q < splits; ++q) l += s_stat[kStatSums + q * kMaxBeams + tid];
    s_stat[kStatDenom + tid] = l;
  }
  __syncthreads();
  // bf16(p * vs) as the TPU rounds it
  for (int j = tid; j < nslot; j += kCrossThreads) {
    const float vs = s_vs[j];
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r)
      if (r < K)
        s_p[r * stride + j] =
            bf16_round(__fmul_rn(__fdiv_rn(s_p[r * stride + j], s_stat[kStatDenom + r]), vs));
  }
  __syncthreads();

  // pass 2: out[r, d] = sum_s p[r, s] * v[s, d] over the block's rows; a
  // thread takes 8 columns (8 bytes) of every 32nd row
  {
    const int cgp = tid & 7, prow = tid >> 3;
    float acc[kMaxBeams][8];
#pragma unroll
    for (int r = 0; r < kMaxBeams; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int p = prow; p < nr; p += kCrossThreads / 8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(s_v + p * kDh + cgp * 8);
      const uint32_t words[2] = {raw.x, raw.y};
      float c_lo[16], c_hi[16];
      unpack_codes(words, 2, packed, c_lo, c_hi);
#pragma unroll
      for (int r = 0; r < kMaxBeams; ++r) {
        if (r < K) {
          const float pl = s_p[r * stride + p];
          const float ph = packed ? s_p[r * stride + nr + p] : 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            acc[r][c] = fmaf(pl, c_lo[c], acc[r][c]);
            if (packed) acc[r][c] = fmaf(ph, c_hi[c], acc[r][c]);
          }
        }
      }
    }
    // the rows' partial outputs, added over the warps and the cluster
    cluster_add_outputs<kCrossThreads>(cluster, acc, K, s_red, s_outg, [&](int i, float v) {
      const int r = i / kDh, d = i - r * kDh;
      cross[((size_t)b * K + r) * D + h * kDh + d] = v;
    });
  }
}

// Blocks per cluster: 1 when H * B blocks fill the card, else enough for
// 132, at most 8, and more where one block's slots would not fit.
inline int cross_splits(int H, int B, int K, int S, int packed) {
  int s = std::min(kMaxSplits, std::max(1, (kTargetBlocks + H * B - 1) / (H * B)));
  while (s < kMaxSplits && cross_smem_bytes(K, S, packed, s) > kMaxSmem) ++s;
  return s;
}

template <int KB, int PACKED>
cudaError_t launch_cross_kernel(const float* qc, const uint8_t* ck, const float* cks,
                                const uint8_t* cv, const float* cvs, float* cross, int H, int B,
                                int K, int D, int S, int s_real, int splits, size_t smem,
                                cudaStream_t st, bool after_own) {
  static size_t limit = 0;
  const cudaError_t err = reserve_smem(cross_attention_kernel<KB, PACKED>, smem, &limit);
  if (err != cudaSuccess) return err;
  return launch_cluster(cross_attention_kernel<KB, PACKED>, dim3(H, B, splits),
                        dim3(1, 1, splits), kCrossThreads, smem, st, after_own, qc, ck, cks, cv,
                        cvs, cross, K, D, S, s_real);
}

// Launch on `st` over B audios of K <= 8 rows each, D = 64 * heads; S is
// the logical slot count (even when packed).  `after_own`: see
// launch_cluster.
inline cudaError_t launch_cross_attention(const float* qc, const uint8_t* ck, const float* cks,
                                          const uint8_t* cv, const float* cvs, float* cross,
                                          int B, int K, int D, int S, int s_real, int packed,
                                          cudaStream_t st, bool after_own = false) {
  if (D % kDh || B < 1 || K < 1 || K > kMaxBeams || (packed && S % 2) || s_real < 1 ||
      s_real > S || reinterpret_cast<uintptr_t>(ck) % 16 || reinterpret_cast<uintptr_t>(cv) % 16)
    return cudaErrorInvalidValue;
  const int H = D / kDh;
  const int splits = cross_splits(H, B, K, S, packed);
  const size_t smem = cross_smem_bytes(K, S, packed, splits);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
#define TTASR_CROSS(KB, P) \
  launch_cross_kernel<KB, P>(qc, ck, cks, cv, cvs, cross, H, B, K, D, S, s_real, splits, smem, \
                             st, after_own)
  if (packed) return K == 5 ? TTASR_CROSS(5, 1) : K == 1 ? TTASR_CROSS(1, 1) : TTASR_CROSS(0, 1);
  return K == 5 ? TTASR_CROSS(5, 0) : K == 1 ? TTASR_CROSS(1, 0) : TTASR_CROSS(0, 0);
#undef TTASR_CROSS
}

}  // namespace
}  // namespace ttasr
