// Skinny int8-weight GEMM for the decode step: the kernel of
// decoder_blocks.cu (B1, B3, B12, B15, B16), and the pieces of a block's
// work (the slab, the prologues, the dot product, the epilogues) that
// decoder_mlp.cu's persistent kernel (B4, B14) runs unit by unit.
//
//   out[r, n] = epilogue( sum_k bf16(prologue(a))[r, k] * W[k, n] * s[n] )
//
// for a few activation rows (a decode step's beam rows; any R, in chunks of
// 8) against an int8 (K, N) weight with one f32 scale per output column.
// At these row counts every FLOP is paid for by ~1 byte of weight, far
// below the H100's ~295 FLOP/byte bf16 balance point: the kernel is bound
// by streaming the int8 weight once, and at 1.6-6.6 MB by the latency of
// that stream more than by its rate.  So:
//   * split K over a thread-block cluster: the grid is (N / 32 column
//     tiles) x splits, one cluster of `splits` blocks per tile along K,
//     each block owning a contiguous K range; gemm_splits() picks splits
//     from (K, N) alone -- enough blocks for the 132 SMs, at most 640 K
//     rows per block, at most 8 blocks per cluster (the portable size);
//     where that would put more blocks than SMs but a tile's 2 ranges fit
//     one block, two teams of 256 threads in one block take them instead
//     (gemm_teams: B1), one wave with every SM streaming one tile;
//   * every weight byte of a block is in flight at once: one thread issues
//     the block's whole (K range x 32 columns) slab as 2-D TMA boxes into
//     shared memory before anything else (the tensor map is encoded once
//     per weight and kept), the prologue overlaps its flight, and every row
//     chunk reads it from there, so the weight leaves device memory once
//     per call whatever R is;
//   * the prologue (a cast, a LayerNorm, or already bf16) fills the block's
//     K range of 8 activation rows in shared memory, bf16-rounded exactly
//     where the TPU kernels round them and kept as f32, k-major, each
//     thread's global loads issued in batches (one L2 round trip for a
//     batch, where a plain loop pays one per element -- measured to hold
//     every block back longer than the slab's whole flight); the
//     LayerNorm's mean and variance take the whole row, which every block
//     reads (from L2, the whole block at once) into shared memory for the
//     two passes of the TPU's _ln_f32 (a warp per row) -- measured cheaper
//     than exchanging per-range sums over the cluster, which costs two
//     cluster barriers;
//   * 256 threads = 32 K-groups x 8 column threads of 4 columns, the inner
//     loop instantiated for 1, 2, 4, 5 or 8 rows; bf16 values times int8
//     codes are exact in f32, so products are f32 FMAs, the codes turned
//     into f32 by a byte permute and one subtraction (int8_code); a thread
//     sums its K rows in order, a warp's 4 K-groups pair by two shuffles,
//     the 8 warps add in index order, then the cluster's blocks in rank
//     order: each block writes its sums into the shared memory of the rank
//     that owns them (one cluster barrier per row chunk) -- no atomics, so
//     the same input gives the same bits on every run, and since the order
//     depends on (K, N) only, every prologue and epilogue gets the same
//     bits of the dot product (B3's wo equals B15's, B16's query B3's,
//     B14's W1/W2 B4's);
//   * a call's second and third launch start early (programmatic
//     dependent launch): they fetch their slab, then wait for the launch
//     before only where they read what it wrote.
// The epilogue applies the column scale and, per kernel, the bias, the
// residual, the query pre-scale or the GELU -- or nothing more: the
// tensor-parallel partial sums (B14, B15) leave the bias to the caller.
// Every multiply and add of an epilogue is an explicit _rn operation (no
// FMA contraction), in the order of the TPU kernel's expression.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <unordered_map>

namespace ttasr {
// internal linkage: each .cu that includes this gets its own instantiations
namespace {

namespace cg = cooperative_groups;

constexpr int kGemmThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kTileCols = 32;
constexpr int kColThreads = kTileCols / kColsPerThread;  // 8
constexpr int kKGroups = kGemmThreads / kColThreads;     // 32
constexpr int kRowChunk = 8;
constexpr int kGemmWarps = kGemmThreads / 32;
constexpr int kRedFloats = kGemmWarps * kRowChunk * kTileCols;  // s_red: a block's sums
constexpr int kMaxSplits = 8;         // the portable cluster size
constexpr int kMaxKPerBlock = 640;    // K rows one block streams, at most
constexpr int kTargetBlocks = 132;    // the H100 SXM's SMs
constexpr int kMaxBoxRows = 256;      // a TMA box's largest dimension
constexpr int kLoadBatch = 8;         // global loads a thread keeps in flight together
constexpr int kRowBatch = 32;         // the same for the LayerNorm's whole rows
constexpr size_t kMaxSmem = 232448;   // a block's shared memory on sm_90
constexpr float kLnEps = 1e-5f;
constexpr int kLnMaxPerLane = 40;     // ln_stats_fill: a row of at most 32 x 40 values in registers
static_assert(kRowChunk * kTileCols == kGemmThreads, "a thread per output of a chunk");

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA unit
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One (32 columns, box rows) box of a 2-D tensor map at (c0, c1) into
// shared memory at `dst`; completes `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Programmatic dependent launch: a kernel lets the next one in its stream
// start (launch_dependents), and the next one, launched with the
// programmatic-serialization attribute, waits for this one's completion and
// memory (wait) only where it first reads what this one wrote.  Without the
// attribute, or without a predecessor, both are no-ops.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The cluster barrier split in two: every block arrives at its start and
// waits before its first write to a peer's shared memory, which is legal
// only once every block of the cluster runs.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// int8 code j (0..3) of u = word ^ 0x80808080 as f32, exactly: the biased
// byte becomes the low mantissa bits of 2^23 (a byte permute), and one
// subtraction takes the bias off -- two full-rate instructions where I2F
// runs at an eighth of the FMA rate
__device__ __forceinline__ float int8_code(uint32_t u, int j) {
  return __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)), -8388736.f);
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

// kLayerNorm normalises rows held in shared memory (s_x), kLayerNormRows
// the same rows read from L2; both by the statistics in s_stats
enum Prologue { kCast = 0, kLayerNorm = 1, kBf16 = 2, kLayerNormRows = 3 };
enum Epilogue {
  kBias = 0,         // v*s + b
  kResidual = 1,     // (x + v*s) + b
  kQScale = 2,       // (v*s + b) * qscale
  kGelu = 3,         // bf16(gelu(v*s + b))
  kResidualBias = 4,  // (x + b) + v*s
  kScale = 5          // v*s (a partial sum: no bias, no residual)
};

struct GemmArgs {
  const void* a;         // (R, K) f32 or bf16
  const float* ln_s;     // (K,) for kLayerNorm
  const float* ln_b;
  const int8_t* w;       // (K, N), 16-byte aligned
  const float* w_scale;  // (N,)
  const float* bias;     // (N,); unused by kScale
  const float* resid;    // (R, N) for the residual epilogues
  void* out;             // (R, N) f32, or bf16 for kGelu
  int R, K, N;
  float qscale;
};

// K ranges (splits) per column tile of a (K, N) weight, a function of the
// shape alone so that every user of one shape sums in one order: enough
// for the 132 SMs, at most 640 K rows per range, at most 8.  At large-v3:
// 4 for B15, wo, wo_c and the cross query, 2 for B1 and W1, 8 for W2.
inline int gemm_splits(int K, int N) {
  const int tiles = N / kTileCols;
  const int s =
      std::max((kTargetBlocks + tiles - 1) / tiles, (K + kMaxKPerBlock - 1) / kMaxKPerBlock);
  return std::max(1, std::min(s, std::min(kMaxSplits, K)));
}

// 256-thread teams per block that take a tile's K ranges in place of a
// cluster's blocks: 2 where a tile's 2 ranges in one block make one wave
// that a cluster per tile would not (more blocks than SMs, at most one
// tile per SM): B1's (1280, 3840), 120 blocks where a cluster of 2 per
// tile put 240 on 132 SMs.  Every SM then streams at most one tile's
// slab, reads the LayerNorm's rows once, and needs no cluster barrier.
// The teams add their sums in rank order as a cluster's blocks do: the
// same order, the same bits.  1 for every other shape.
inline int gemm_teams(int K, int N) {
  const int tiles = N / kTileCols, splits = gemm_splits(K, N);
  return (splits == 2 && tiles <= kTargetBlocks && tiles * splits > kTargetBlocks) ? 2 : 1;
}

// A block's K range and the TMA boxes that bring it: n_box boxes of
// box_rows rows (a multiple of 8, at most 256) cover the kper rows
struct Slab {
  int kper, box_rows, n_box;
};

__host__ __device__ inline Slab slab_of(int K, int splits) {
  const int kper = (K + splits - 1) / splits;
  const int n_box = (kper + kMaxBoxRows - 1) / kMaxBoxRows;
  const int per_box = (kper + n_box - 1) / n_box;
  return Slab{kper, (per_box + 7) / 8 * 8, n_box};
}

// per team: s_w (the slab's rows x 32 codes), its mbarrier, s_a (kper x 8
// f32), s_red; then s_gather (2 chunks x splits x 256), the LayerNorm
// statistics and, for the LayerNorm, s_x (the chunk's rows, at most 8 x K
// f32) and with teams the LayerNorm's vectors (2 x K f32)
inline size_t gemm_smem_bytes(int K, int splits, int R, bool layer_norm, int teams) {
  const Slab sl = slab_of(K, splits);
  const size_t rows = std::min(R, kRowChunk);
  return teams * ((size_t)sl.n_box * sl.box_rows * kTileCols + 16) +
         sizeof(float) * (teams * ((size_t)sl.kper * kRowChunk + kRedFloats) +
                          2 * (size_t)splits * kGemmThreads + 2 * kRowChunk +
                          (layer_norm ? (rows + (teams > 1 ? 2 : 0)) * K : 0));
}

// Rows of a chunk the inner loop is unrolled for: 1, 2, 4, 5 or 8
__device__ __forceinline__ int padded_rows(int rc) {
  return rc <= 2 ? rc : rc <= 4 ? 4 : rc == 5 ? 5 : kRowChunk;
}

// The block's sums of a chunk's ROWS rows over its K range into s_red (8
// warps x 8 rows x 32 columns): thread (kg, ct) takes every 32nd K row of
// the range in order, then a warp's 4 K-groups pair by two shuffles
template <int ROWS>
__device__ __forceinline__ void chunk_sums(const int8_t* s_w, const float* s_a, float* s_red,
                                           int kr, int kg, int ct, int lane, int warp) {
  float acc[ROWS][kColsPerThread];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[rr][c] = 0.f;

#pragma unroll 4
  for (int k = kg; k < kr; k += kKGroups) {
    const uint32_t u =
        *reinterpret_cast<const uint32_t*>(s_w + k * kTileCols + ct * kColsPerThread) ^
        0x80808080u;
    float a[ROWS];
    if (ROWS >= 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(s_a + k * kRowChunk);
      a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
    }
    if (ROWS == 8) {
      const float4 a4 = *reinterpret_cast<const float4*>(s_a + k * kRowChunk + 4);
      a[4] = a4.x, a[5] = a4.y, a[6] = a4.z, a[7] = a4.w;
    }
    if (ROWS == 5) a[4] = s_a[k * kRowChunk + 4];
    if (ROWS < 4) {
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) a[rr] = s_a[k * kRowChunk + rr];
    }
    float wf[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) wf[c] = int8_code(u, c);
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[rr][c] = fmaf(a[rr], wf[c], acc[rr][c]);
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      float v = acc[rr][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[rr][c] = v;
    }
  if (lane < kColThreads) {
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        s_red[(warp * kRowChunk + rr) * kTileCols + lane * kColsPerThread + c] = acc[rr][c];
  }
}

// Warp w < rc: the mean and biased variance of row w of s_x over all K in
// two passes, as the TPU's _ln_f32, in a fixed order -- every block and
// kernel that normalises a row gets the same statistics.
__device__ __forceinline__ void ln_stats_smem(const float* s_x, int rc, int K, float* s_stats) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < rc) {
    const float* row = s_x + warp * K;
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

// Rows [0, rc) of x (rc x K f32) into s_x by the block's NTHR threads,
// each thread's loads of a batch in flight before the first store; then
// their statistics (ln_stats_smem).
template <int NTHR>
__device__ __forceinline__ void ln_rows(const float* x, int rc, int K, float* s_x,
                                        float* s_stats) {
  constexpr int nthr = NTHR;
  const int tid = threadIdx.x;
  const int n = rc * K;
  for (int i0 = tid; i0 < n; i0 += kRowBatch * nthr) {
    float v[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int i = i0 + j * nthr;
      v[j] = i < n ? x[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j)
      if (i0 + j * nthr < n) s_x[i0 + j * nthr] = v[j];
  }
  __syncthreads();
  ln_stats_smem(s_x, rc, K, s_stats);
}

// ln_rows without s_x: warp w < rc holds row w of x (rc x K, from L2) in
// registers for the two passes, in ln_rows' order (the same statistics),
// and writes the K range [k_lo, k_lo + kr) of its row, normalised, into s_a
// as fill_rows<kLayerNormRows> would (warps rc..rows-1 write the padding
// rows' zeros); K <= 32 * kLnMaxPerLane.  The caller synchronises.
__device__ __forceinline__ void ln_stats_fill(const float* x, int rc, int rows, int K, int k_lo,
                                              int kr, const float* ln_s, const float* ln_b,
                                              float* s_stats, float* s_a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= rc && warp < rows) {
    for (int k = lane; k < kr; k += 32) s_a[k * kRowChunk + warp] = 0.f;
  } else if (warp < rc) {
    const float* row = x + (size_t)warp * K;
    float v[kLnMaxPerLane];
#pragma unroll
    for (int i = 0; i < kLnMaxPerLane; ++i)
      v[i] = lane + 32 * i < K ? __ldcg(row + lane + 32 * i) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxPerLane; ++i)
      if (lane + 32 * i < K) s += v[i];
    const float mean = __fdiv_rn(warp_sum(s), (float)K);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxPerLane; ++i) {
      if (lane + 32 * i < K) {
        const float dlt = __fsub_rn(v[i], mean);
        q = __fadd_rn(q, __fmul_rn(dlt, dlt));
      }
    }
    const float var = __fdiv_rn(warp_sum(q), (float)K);
    const float rstd = __fdiv_rn(1.f, sqrtf(__fadd_rn(var, kLnEps)));
    if (lane == 0) {
      s_stats[2 * warp] = mean;
      s_stats[2 * warp + 1] = rstd;
    }
#pragma unroll
    for (int i = 0; i < kLnMaxPerLane; ++i) {
      const int k = lane + 32 * i;
      if (k >= k_lo && k < k_lo + kr) {
        const float nv = __fmul_rn(__fsub_rn(v[i], mean), rstd);
        s_a[(k - k_lo) * kRowChunk + warp] = bf16_round(__fadd_rn(__fmul_rn(nv, ln_s[k]), ln_b[k]));
      }
    }
  }
}

// The K range [k_lo, k_lo + kr) of activation rows [r0, r0 + rc) of a (R,
// K) input into s_a (kr x 8, k-major), `rows` rows (the chunk padded with
// zeros), bf16-rounded exactly where the TPU kernels round them: a cast
// of f32 (kCast), bf16 (kBf16) or the LayerNorm by s_stats of the rows in
// s_x (kLayerNorm) or at a (kLayerNormRows).  Thread t of nthr; each
// thread's loads of a batch go out together (one round trip, not one per
// element).  ROW_FAST: neighbouring threads take neighbouring rows of one
// k, whose s_a words are neighbours, where neighbouring k (8 words apart)
// put 8 threads of a warp on one bank.  L2: the activations come from L2
// (another block of the same kernel wrote them), not through L1.
template <int P, bool ROW_FAST = false, bool L2 = false>
__device__ __forceinline__ void fill_rows(const void* a, const float* ln_s, const float* ln_b,
                                          const float* s_x, const float* s_stats, int r0,
                                          int rc, int rows, int K, int k_lo, int kr,
                                          float* s_a, int t, int nthr) {
  for (int i0 = t; i0 < rows * kr; i0 += kLoadBatch * nthr) {
    float v[kLoadBatch], ls[kLoadBatch], lb[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * nthr;
      const int rr = ROW_FAST ? i % rows : i / kr, k = ROW_FAST ? i / rows : i - rr * kr;
      v[j] = ls[j] = lb[j] = 0.f;
      if (i < rows * kr && rr < rc) {
        const size_t src = (size_t)(r0 + rr) * K + k_lo + k;
        if (P == kBf16) {
          const unsigned short* p = static_cast<const unsigned short*>(a) + src;
          v[j] = __bfloat162float(__ushort_as_bfloat16(L2 ? __ldcg(p) : *p));
        } else if (P == kCast) {
          const float* p = static_cast<const float*>(a) + src;
          v[j] = L2 ? __ldcg(p) : *p;
        } else {
          v[j] = P == kLayerNorm ? s_x[rr * K + k_lo + k]
                                 : __ldcg(static_cast<const float*>(a) + src);
          ls[j] = ln_s[k_lo + k];
          lb[j] = ln_b[k_lo + k];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * nthr;
      const int rr = ROW_FAST ? i % rows : i / kr, k = ROW_FAST ? i / rows : i - rr * kr;
      if (i >= rows * kr) continue;
      float val = v[j];
      if ((P == kLayerNorm || P == kLayerNormRows) && rr < rc) {
        const float nv = __fmul_rn(__fsub_rn(val, s_stats[2 * rr]), s_stats[2 * rr + 1]);
        val = __fadd_rn(__fmul_rn(nv, ls[j]), lb[j]);
      }
      s_a[k * kRowChunk + rr] = bf16_round(val);
    }
  }
}

// chunk_sums for a chunk of `rows` rows (1, 2, 4, 5 or 8)
__device__ __forceinline__ void chunk_sums_rows(int rows, const int8_t* s_w, const float* s_a,
                                                float* s_red, int kr, int kg, int ct, int lane,
                                                int warp) {
  switch (rows) {
    case 1: chunk_sums<1>(s_w, s_a, s_red, kr, kg, ct, lane, warp); break;
    case 2: chunk_sums<2>(s_w, s_a, s_red, kr, kg, ct, lane, warp); break;
    case 4: chunk_sums<4>(s_w, s_a, s_red, kr, kg, ct, lane, warp); break;
    case 5: chunk_sums<5>(s_w, s_a, s_red, kr, kg, ct, lane, warp); break;
    default: chunk_sums<kRowChunk>(s_w, s_a, s_red, kr, kg, ct, lane, warp); break;
  }
}

// The block's sum of output t (row t / 32, column t % 32 of the chunk)
// over its K range: the 8 warps of s_red in index order
__device__ __forceinline__ float block_sum(const float* s_red, int t) {
  const int rr = t / kTileCols, c = t % kTileCols;
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kGemmWarps; ++w) v += s_red[(w * kRowChunk + rr) * kTileCols + c];
  return v;
}

// out[oi] from the dot product v of column n: the column scale, then the
// epilogue E, each operation an explicit _rn in the TPU kernel's order
template <int E>
__device__ __forceinline__ void store_out(void* out, size_t oi, float v, float col_scale,
                                          float col_bias, float resid, float qscale) {
  const float vs = __fmul_rn(v, col_scale);
  if (E == kBias) {
    static_cast<float*>(out)[oi] = __fadd_rn(vs, col_bias);
  } else if (E == kResidual) {
    static_cast<float*>(out)[oi] = __fadd_rn(__fadd_rn(resid, vs), col_bias);
  } else if (E == kQScale) {
    static_cast<float*>(out)[oi] = __fmul_rn(__fadd_rn(vs, col_bias), qscale);
  } else if (E == kGelu) {
    static_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16_rn(gelu_as(__fadd_rn(vs, col_bias)));
  } else if (E == kResidualBias) {
    static_cast<float*>(out)[oi] = __fadd_rn(__fadd_rn(resid, col_bias), vs);
  } else {
    static_cast<float*>(out)[oi] = vs;
  }
}

// TEAMS == 1: a cluster of `splits` blocks per column tile, rank q the K
// range q.  TEAMS == 2: one block of two 256-thread teams per tile, team q
// the K range q (gemm_teams), added in rank order as a cluster's blocks.
template <int P, int E, int TEAMS>
__global__ void __launch_bounds__(kGemmThreads * TEAMS)
    skinny_gemm_kernel(const __grid_constant__ CUtensorMap w_map, GemmArgs g) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  if (TEAMS == 1) cluster_arrive_relaxed();
  const int team = threadIdx.x / kGemmThreads;
  const int splits = TEAMS == 1 ? (int)cluster.num_blocks() : TEAMS;
  const int rank = TEAMS == 1 ? (int)cluster.block_rank() : team;
  const int K = g.K, N = g.N;
  const Slab sl = slab_of(K, splits);
  const int kper = sl.kper;
  const int k_lo = min(K, rank * kper), kr = min(K, k_lo + kper) - k_lo;
  const int slab_bytes = sl.n_box * sl.box_rows * kTileCols;
  // per team: its slab (rows x 32 weight codes), its mbarrier, s_a (kper x
  // 8, k-major) and s_red (8 warps x 8 rows x 32 columns); then the
  // block's s_gather (2 chunks x splits x 256 sums), the LayerNorm
  // statistics (per row: mean, rstd) and s_x (the chunk's rows)
  int8_t* s_w = reinterpret_cast<int8_t*>(gemm_smem) + team * slab_bytes;
  const uint32_t bar = smem_u32(gemm_smem + TEAMS * slab_bytes + 16 * team);
  float* s_a0 = reinterpret_cast<float*>(gemm_smem + TEAMS * (slab_bytes + 16));
  float* s_a = s_a0 + (size_t)team * kper * kRowChunk;
  float* s_red = s_a0 + (size_t)TEAMS * kper * kRowChunk + team * kRedFloats;
  float* s_gather = s_a0 + (size_t)TEAMS * (kper * kRowChunk + kRedFloats);
  float* s_stats = s_gather + 2 * splits * kGemmThreads;
  float* s_x = s_stats + 2 * kRowChunk;

  const int tid = threadIdx.x % kGemmThreads, lane = tid & 31, warp = tid >> 5;
  const int kg = tid / kColThreads, ct = tid % kColThreads;
  const int n0 = blockIdx.x * kTileCols;

  // the team's weight slab, all of it in flight by TMA before the prologue
  auto request_slab = [&]() {
    if (tid == 0 && kr > 0) {
      mbar_init(bar, 1);
      mbar_expect_tx(bar, slab_bytes);
      for (int j = 0; j < sl.n_box; ++j)
        tma_load_2d(smem_u32(s_w + j * sl.box_rows * kTileCols), &w_map, bar, n0,
                    k_lo + j * sl.box_rows);
    }
  };
  // teams (B1, K <= 1280): the first chunk's LayerNorm rows and the
  // LayerNorm's vectors are requested before the slab, so they come back
  // ahead of it instead of behind it, then stored into s_x and s_ln
  const float* ln_s = g.ln_s;
  const float* ln_b = g.ln_b;
  if (TEAMS > 1 && P == kLayerNorm) {
    constexpr int kPer = (kRowChunk + 2) * 2 * kMaxKPerBlock / (TEAMS * kGemmThreads);
    const int rc = min(g.R, kRowChunk), n = rc * K;
    float* s_ln = s_x + (size_t)rc * K;
    griddep_wait();
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * TEAMS * kGemmThreads;
      v[j] = i < n ? static_cast<const float*>(g.a)[i]
                   : (i < n + K ? g.ln_s[i - n] : (i < n + 2 * K ? g.ln_b[i - n - K] : 0.f));
    }
    request_slab();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * TEAMS * kGemmThreads;
      if (i < n + 2 * K) s_x[i] = v[j];  // s_ln follows s_x
    }
    __syncthreads();
    ln_stats_smem(s_x, rc, K, s_stats);
    ln_s = s_ln;
    ln_b = s_ln + K;
  } else {
    request_slab();
  }
  __syncthreads();  // no thread waits on the barrier before its init
  griddep_launch_dependents();

  // rank q owns the outputs o = q + splits * j of a row chunk's 8 x 32; the
  // epilogue's column vectors are fetched while the slab is in flight
  const int o = rank + splits * tid;
  const bool has_out = o < kGemmThreads;
  const int o_rr = o / kTileCols, n = n0 + o % kTileCols;
  const float col_scale = has_out ? g.w_scale[n] : 0.f;
  const float col_bias = (has_out && E != kScale) ? g.bias[n] : 0.f;
  griddep_wait();  // the activations and the residual may come from the launch before

  for (int r0 = 0, chunk = 0; r0 < g.R; r0 += kRowChunk, ++chunk) {
    const int rc = min(kRowChunk, g.R - r0), rows = padded_rows(rc);
    const bool out_here = has_out && o_rr < rc;
    const size_t oi = (size_t)(r0 + o_rr) * N + n;
    const float resid = (out_here && (E == kResidual || E == kResidualBias)) ? g.resid[oi] : 0.f;
    if (P == kLayerNorm && (TEAMS == 1 || chunk > 0))
      ln_rows<TEAMS * kGemmThreads>(static_cast<const float*>(g.a) + (size_t)r0 * K, rc, K, s_x,
                                    s_stats);
    fill_rows<P>(g.a, ln_s, ln_b, s_x, s_stats, r0, rc, rows, K, k_lo, kr, s_a, tid,
                 kGemmThreads);
    if (chunk == 0 && kr > 0) mbar_wait(bar, 0);
    __syncthreads();
    chunk_sums_rows(rows, s_w, s_a, s_red, kr, kg, ct, lane, warp);
    __syncthreads();
    {
      // the team's sum of output tid, written into the shared memory of
      // the rank that owns it
      const float v = (tid / kTileCols < rc) ? block_sum(s_red, tid) : 0.f;
      const int slot = ((chunk & 1) * splits + rank) * kGemmThreads + tid;
      if (TEAMS == 1) {
        if (chunk == 0) cluster_wait();
        cluster.map_shared_rank(s_gather, tid % splits)[slot] = v;
      } else {
        s_gather[slot] = v;
      }
    }
    // every push of this chunk is visible to its owner; a push of the next
    // chunk goes to the other half of s_gather, and one two chunks on waits
    // for this barrier's successor, which its owner reaches only after
    // reading this one
    if (TEAMS == 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    if (out_here) {  // the sums in rank order, then the epilogue
      const float* part = s_gather + (chunk & 1) * splits * kGemmThreads + o;
      float v = 0.f;
      for (int q = 0; q < splits; ++q) v += part[q * kGemmThreads];
      store_out<E>(g.out, oi, v, col_scale, col_bias, resid, g.qscale);
    }
  }
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

// Launch `kernel` on `st` over `grid` in clusters of `cluster` blocks of
// `threads`; a refused launch returns its error.  `after_own`: the launch
// before it on `st` is a kernel of the same C call, so this one may start
// early (programmatic dependent launch) -- never for a call's first launch,
// whose inputs, weights included, may come from any earlier work.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 cluster, int threads,
                           size_t smem, cudaStream_t st, bool after_own, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_own ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once through the runtime (nothing links
// libcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The (K, N) int8 weight as a 2-D tensor map of (32 columns, box_rows)
// boxes, rows past K read as zeros.  A decode launches every weight every
// step, so each map is encoded once per (address, shape, box) and kept: it
// holds only those, so it stays right for whatever tensor later lies there.
inline bool weight_map(CUtensorMap* map, const int8_t* w, int K, int N, int box_rows) {
  struct Key {
    const void* w;
    int K, N, box;
    bool operator==(const Key& o) const { return w == o.w && K == o.K && N == o.N && box == o.box; }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.w) ^ ((size_t)k.K << 16) ^ ((size_t)k.N << 36) ^
             ((size_t)k.box << 56);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> maps;
  const Key key{w, K, N, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)kTileCols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *map);
  return true;
}

// Launch on `st`; N must be a multiple of kTileCols (the wrappers check).
// `after_own`: see launch_cluster.
template <int P, int E>
cudaError_t launch_skinny_gemm(const GemmArgs& g, cudaStream_t st, bool after_own = false) {
  if (g.R < 1 || g.K < 1 || g.N < kTileCols || g.N % kTileCols ||
      reinterpret_cast<uintptr_t>(g.w) % 16)
    return cudaErrorInvalidValue;
  static size_t limit = 0, limit_teams = 0;
  const int splits = gemm_splits(g.K, g.N), teams = gemm_teams(g.K, g.N);
  const size_t smem = gemm_smem_bytes(g.K, splits, g.R, P == kLayerNorm, teams);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!weight_map(&map, g.w, g.K, g.N, slab_of(g.K, splits).box_rows))
    return cudaErrorInvalidValue;
  if (teams == 1) {
    const cudaError_t err = reserve_smem(skinny_gemm_kernel<P, E, 1>, smem, &limit);
    if (err != cudaSuccess) return err;
    return launch_cluster(skinny_gemm_kernel<P, E, 1>, dim3(g.N / kTileCols, splits),
                          dim3(1, splits, 1), kGemmThreads, smem, st, after_own, map, g);
  }
  const cudaError_t err = reserve_smem(skinny_gemm_kernel<P, E, 2>, smem, &limit_teams);
  if (err != cudaSuccess) return err;
  return launch_cluster(skinny_gemm_kernel<P, E, 2>, dim3(g.N / kTileCols, 1), dim3(1, 1, 1),
                        2 * kGemmThreads, smem, st, after_own, map, g);
}

}  // namespace
}  // namespace ttasr
