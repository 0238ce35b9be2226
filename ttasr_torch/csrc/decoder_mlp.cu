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
// balance point: the bound is streaming 14.7 MB once per step, 4.4 us at
// 3.35 TB/s.  What holds it far above that is latency: three dependent
// products (the LayerNorm needs all of x', W2 its K range of h), each a
// chain of slab flight, activation loads from L2, the dot product (f32
// FMAs, ~2 us for a 640-row unit at 8 warps) and a cross-block sum.
//
// The design: one persistent cooperative launch, two 256-thread blocks per
// SM (16 warps hide each other's latencies; two blocks' registers and
// shared memory fit).  The three products are cut into units, a (column
// tile of 32, K range) of one weight -- the skinny GEMM's blocks:
// gemm_splits' K ranges (4 for wo_c, 2 for W1, 8 for W2 at large-v3), its
// slab, its prologue, its 32 K-groups, shuffles and warps in index order
// -- and a schedule made on the host (ops/decoder_mlp.py::mlp_plan) deals
// them out: at most one wo_c unit and two of W1 and of W2 per block at
// large-v3, slab bytes within one unit of the mean.  A block runs its
// units phase by phase:
//   1. wo_c (B4 only): the cast of `cross`, the partial sums;
//   2. W1: waits until every tile of x' is done, then LN2 with a warp per
//      row holding the row in registers (the two passes of _ln_f32),
//      written normalised straight into the unit's activations;
//   3. W2: waits until the tiles of h in its K range are done, then the
//      bf16 rows of h.
// A unit writes its partial sums to a device buffer and arrives at its
// tile's counter (a release, not waited for); the tile's finisher, the
// holder of its range 0, waits for the other ranges, adds them in rank
// order and applies the phase's epilogue: x' = (x + v*s) + b_oc, h =
// bf16(GELU(v*s + b1)), out = (x' + b2) + v*s (B14: (x + b2) + v*s, or
// v*s); for x' and h it then counts the tile done for the waits.  The sums
// are the skinny GEMM's in its order, so B4 equals the three-launch B4 it
// replaces bit for bit, its wo_c products equal B15's and its W1/W2
// products B14's, and the same input gives the same bits on every run (no
// atomics on values; the counters only order the work).
//
// The slabs: thread 0 requests a block's first unit's slab at entry and
// the others while it polls another block's count, so the weights stream
// during the waits.  Requesting all of them at entry (~56-112 KB an SM)
// fills the SM's TMA queue, and thread 0, with its block behind it, waited
// ~4.5 us on the queue before the first unit could start.
//
// Co-residency: the waits spin on counters that other blocks raise, so the
// launch is cooperative (cudaLaunchAttributeCooperative): it runs with
// every block resident or is refused, and the wrapper raises.  A wait of 2
// s is taken for a fault and traps instead of hanging.  The counters
// (`sync`, zeros between calls) reset themselves: a tile's arrivals by its
// finisher, the done counts by the last block to leave.
//
// B14 is the same kernel without phase 1.
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes.

#include "skinny_gemm.cuh"

namespace ttasr {
namespace {

constexpr int kMlpPhases = 3;  // wo_c, W1, W2
// a unit in the schedule: phase, column tile, K range, slab offset, and
// whether this block finishes the tile
constexpr int kUnitInts = 5;
constexpr long long kSpinLimitNs = 2000000000LL;
constexpr int kLineInts = 32;  // a 128-byte line of the counters

struct MlpArgs {
  const float* x;      // (R, D)
  const float* cross;  // (R, D): phase 0's activations (B4 only)
  const float* ln_s;
  const float* ln_b;
  const float* scale[kMlpPhases];  // column scales of wo_c, W1, W2
  const float* bias[kMlpPhases];   // b_oc, b1, b2
  float* x_mid;                    // (R, D): x' (B4 only)
  __nv_bfloat16* h;                // (R, F): the hidden rows
  float* out;                      // (R, D)
  float* part[kMlpPhases];         // (splits, R, N): each unit's partial sums
  int* sync;                       // mlp_sync_ints(D, F) ints, zeros between calls
  const int* sched;                // (gridDim.x, 1 + kUnitInts * max_units)
  int R, D, F, max_units, weight_bytes;
  int splits[kMlpPhases];
};

__host__ __device__ inline int phase_k(int p, int D, int F) { return p == 2 ? F : D; }
__host__ __device__ inline int phase_n(int p, int D, int F) { return p == 1 ? F : D; }

// sync, one 128-byte line each: the blocks that have left; the finished
// tiles of x'; per K range of W2 (at most 8) the finished tiles of h with
// columns in it; then per column tile of each phase the units that have
// arrived
constexpr int kLeft = 0, kXDone = kLineInts, kHDone = 2 * kLineInts, kArrived = 3 * kLineInts;
inline int mlp_sync_ints(int D, int F) { return kArrived + 2 * (D / kTileCols) + F / kTileCols; }

// the units' mbarriers, after the slabs
__host__ __device__ inline int mlp_bar_bytes(int max_units) { return (8 * max_units + 15) / 16 * 16; }

// K rows of the largest unit's activations in s_a
__host__ __device__ inline int mlp_a_rows(int D, int F, const int* splits, bool cross) {
  const int w1 = slab_of(D, splits[1]).kper, w2 = slab_of(F, splits[2]).kper;
  const int rows = w1 > w2 ? w1 : w2, woc = slab_of(D, splits[0]).kper;
  return cross && woc > rows ? woc : rows;
}

// the slabs (weight_bytes), the mbarriers, s_ln (LN2's scale and bias),
// s_a, s_red and the statistics
inline size_t mlp_smem_bytes(int D, int F, const int* splits, bool cross, int max_units,
                             int weight_bytes) {
  return (size_t)weight_bytes + mlp_bar_bytes(max_units) +
         sizeof(float) * (2 * (size_t)D + (size_t)mlp_a_rows(D, F, splits, cross) * kRowChunk +
                          kRedFloats + 2 * kRowChunk);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0: until the counter reaches `target`, calling meanwhile() between
// polls (a pause of 100 ns when it has nothing to do).  The blocks that
// count are resident (a cooperative launch); a wait of 2 s is a fault,
// which traps rather than hangs.
template <typename Meanwhile>
__device__ __forceinline__ void wait_count(const int* counter, int target, Meanwhile meanwhile) {
  if (ld_acquire(counter) >= target) return;
  const long long t0 = global_ns();
  while (ld_acquire(counter) < target) {
    if (!meanwhile()) __nanosleep(100);
    if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// W1 tiles whose columns fall in W2's K range j
__device__ __forceinline__ int h_tiles_in(int j, int kper, int F) {
  const int lo = min(F, j * kper), hi = min(F, lo + kper);
  return hi > lo ? (hi - 1) / kTileCols - lo / kTileCols + 1 : 0;
}

// The last unit of column tile `tile` of phase p: the ranges' partial sums
// in rank order, then the phase's epilogue
template <bool CROSS, int E3>
__device__ __forceinline__ void finish_tile(const MlpArgs& g, int p, int tile) {
  const int N = phase_n(p, g.D, g.F), splits = g.splits[p];
  for (int i = threadIdx.x; i < g.R * kTileCols; i += kGemmThreads) {
    const int r = i / kTileCols, n = tile * kTileCols + i % kTileCols;
    const size_t oi = (size_t)r * N + n;
    float part[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      part[q] = q < splits ? __ldcg(g.part[p] + (size_t)q * g.R * N + oi) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) v += part[q];
    if (p == 0) {
      store_out<kResidual>(g.x_mid, oi, v, g.scale[0][n], g.bias[0][n], g.x[oi], 1.f);
    } else if (p == 1) {
      store_out<kGelu>(g.h, oi, v, g.scale[1][n], g.bias[1][n], 0.f, 1.f);
    } else {
      const float resid = E3 == kScale ? 0.f : (CROSS ? __ldcg(g.x_mid + oi) : g.x[oi]);
      store_out<E3>(g.out, oi, v, g.scale[2][n], E3 == kScale ? 0.f : g.bias[2][n], resid, 1.f);
    }
  }
}

template <bool CROSS, int E3>
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_persistent_kernel(const __grid_constant__ CUtensorMap m0,
                          const __grid_constant__ CUtensorMap m1,
                          const __grid_constant__ CUtensorMap m2, MlpArgs g) {
  extern __shared__ __align__(128) unsigned char mlp_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = tid / kColThreads, ct = tid % kColThreads;
  const int R = g.R, D = g.D, F = g.F;
  const int* unit = g.sched + (size_t)blockIdx.x * (1 + kUnitInts * g.max_units);
  const int n_units = *unit++;
  const int td = D / kTileCols;
  int* const arrived[kMlpPhases] = {g.sync + kArrived, g.sync + kArrived + td,
                                    g.sync + kArrived + td + F / kTileCols};
  Slab sl[kMlpPhases];
#pragma unroll
  for (int p = 0; p < kMlpPhases; ++p) sl[p] = slab_of(phase_k(p, D, F), g.splits[p]);
  uint64_t* bars = reinterpret_cast<uint64_t*>(mlp_smem + g.weight_bytes);
  float* s_ln = reinterpret_cast<float*>(mlp_smem + g.weight_bytes + mlp_bar_bytes(g.max_units));
  float* s_a = s_ln + 2 * D;
  float* s_red = s_a + (size_t)mlp_a_rows(D, F, g.splits, CROSS) * kRowChunk;
  float* s_stats = s_red + kRedFloats;

  // Thread 0 requests the units' slabs in order by TMA: the first before
  // anything else, the rest while it waits for another block, and a
  // unit's own before it computes if it is not out by then.  A request
  // waits while the SM's TMA queue is full, and the block would wait with
  // it: no request runs ahead of the unit that computes but in a wait.
  int requested = 0;  // thread 0: the units whose slabs are requested
  auto request_next = [&]() {
    if (requested >= n_units) return false;
    const int* un = unit + kUnitInts * requested;
    const int p = un[0], K = phase_k(p, D, F);
    const int k_lo = min(K, un[2] * sl[p].kper), kr = min(K, k_lo + sl[p].kper) - k_lo;
    if (kr > 0) {
      const uint32_t bar = smem_u32(bars + requested);
      mbar_expect_tx(bar, sl[p].n_box * sl[p].box_rows * kTileCols);
      const CUtensorMap* map = p == 0 ? &m0 : (p == 1 ? &m1 : &m2);
      for (int j = 0; j < sl[p].n_box; ++j)
        tma_load_2d(smem_u32(mlp_smem + un[3] + j * sl[p].box_rows * kTileCols), map, bar,
                    un[1] * kTileCols, k_lo + j * sl[p].box_rows);
    }
    ++requested;
    return true;
  };
  if (tid == 0) {
    for (int u = 0; u < n_units; ++u) mbar_init(smem_u32(bars + u), 1);
    request_next();
  }
  __syncthreads();  // no thread waits on a barrier before its init

  int ln_chunk = -1;  // the row chunk whose LayerNorm statistics s_stats holds
  int in_a = -1;      // (phase, K range, row chunk) whose activations s_a holds
  for (int p = CROSS ? 0 : 1, u = 0; p < kMlpPhases; ++p) {
    // the phase's units: each unit's partial sums out, then its arrival
    // (none from a tile's finisher), without waiting for it
    const int u0 = u;
    const int K = phase_k(p, D, F), N = phase_n(p, D, F);
    for (; u < n_units && unit[kUnitInts * u] == p; ++u) {
      const int* un = unit + kUnitInts * u;
      const int tile = un[1], split = un[2];
      const int k_lo = min(K, split * sl[p].kper), kr = min(K, k_lo + sl[p].kper) - k_lo;
      const int8_t* s_w = reinterpret_cast<const int8_t*>(mlp_smem + un[3]);
      if (tid == 0)
        while (requested <= u && request_next()) {
        }
      if (p == 1 && u == u0) {
        // LN2's vectors into s_ln; the LayerNorm takes whole rows of x'
        for (int i0 = tid; i0 < 2 * D; i0 += kLoadBatch * kGemmThreads) {
          float v[kLoadBatch];
#pragma unroll
          for (int j = 0; j < kLoadBatch; ++j) {
            const int i = i0 + j * kGemmThreads;
            v[j] = i < D ? g.ln_s[i] : (i < 2 * D ? g.ln_b[i - D] : 0.f);
          }
#pragma unroll
          for (int j = 0; j < kLoadBatch; ++j)
            if (i0 + j * kGemmThreads < 2 * D) s_ln[i0 + j * kGemmThreads] = v[j];
        }
        if (CROSS && tid == 0) wait_count(g.sync + kXDone, td, request_next);
        __syncthreads();
      }
      if (p == 2) {  // the tiles of h in this K range
        if (tid == 0)
          wait_count(g.sync + kHDone + split, h_tiles_in(split, sl[2].kper, F), request_next);
        __syncthreads();
      }
      for (int r0 = 0, chunk = 0; r0 < R; r0 += kRowChunk, ++chunk) {
        const int rc = min(kRowChunk, R - r0), rows = padded_rows(rc);
        const int key = (p * kMaxSplits + split) * 4096 + chunk;
        if (key != in_a) {
          if (p == 0) {
            fill_rows<kCast, true>(g.cross, nullptr, nullptr, nullptr, nullptr, r0, rc, rows, K,
                                   k_lo, kr, s_a, tid, kGemmThreads);
          } else if (p == 1 && ln_chunk != chunk) {
            ln_stats_fill((CROSS ? g.x_mid : g.x) + (size_t)r0 * D, rc, rows, D, k_lo, kr, s_ln,
                          s_ln + D, s_stats, s_a);
            __syncthreads();
            ln_chunk = chunk;
          } else if (p == 1) {
            fill_rows<kLayerNormRows, true>(CROSS ? g.x_mid : g.x, s_ln, s_ln + D, nullptr,
                                            s_stats, r0, rc, rows, K, k_lo, kr, s_a, tid,
                                            kGemmThreads);
          } else {
            fill_rows<kBf16, true, true>(g.h, nullptr, nullptr, nullptr, nullptr, r0, rc, rows,
                                         K, k_lo, kr, s_a, tid, kGemmThreads);
          }
          in_a = key;
        }
        if (chunk == 0 && kr > 0) mbar_wait(smem_u32(bars + u), 0);
        __syncthreads();
        chunk_sums_rows(rows, s_w, s_a, s_red, kr, kg, ct, lane, warp);
        __syncthreads();
        if (tid / kTileCols < rc)  // the block's sums into the range's partial sums
          g.part[p][((size_t)split * R + r0 + tid / kTileCols) * N + tile * kTileCols +
                    tid % kTileCols] = block_sum(s_red, tid);
      }
      __syncthreads();
      if (tid == 0 && !un[4]) red_release(arrived[p] + tile, 1);
    }
    // the tiles this block finishes: the other ranges' arrivals, then the
    // ranges in rank order and the phase's epilogue, and for x' and h the
    // count that the next phase waits for
    for (int v = u0; v < u; ++v) {
      const int* un = unit + kUnitInts * v;
      if (!un[4]) continue;
      const int tile = un[1];
      if (tid == 0) {
        wait_count(arrived[p] + tile, g.splits[p] - 1, request_next);
        arrived[p][tile] = 0;
      }
      __syncthreads();
      finish_tile<CROSS, E3>(g, p, tile);
      if (p < 2) {
        __syncthreads();
        if (tid == 0 && p == 0) red_release(g.sync + kXDone, 1);
        if (tid == 0 && p == 1)  // each K range of W2 that holds the tile's columns
          for (int j = tile * kTileCols / sl[2].kper;
               j <= (tile * kTileCols + kTileCols - 1) / sl[2].kper && j < g.splits[2]; ++j)
            red_release(g.sync + kHDone + j, 1);
      }
    }
  }

  // the last block to leave resets the done counts: every wait is over
  __syncthreads();
  if (tid == 0 && atom_add_acq_rel(g.sync + kLeft, 1) == (int)gridDim.x - 1) {
    g.sync[kXDone] = 0;
    for (int j = 0; j < kMaxSplits; ++j) g.sync[kHDone + j] = 0;
    g.sync[kLeft] = 0;
  }
}

// One cooperative launch of `grid` blocks on `st`, or the error that
// refused it (cudaErrorCooperativeLaunchTooLarge when they cannot all be
// resident).  w: wo_c (B4 only), W1, W2.
template <bool CROSS, int E3>
cudaError_t launch_mlp(MlpArgs g, const void* const w[kMlpPhases], void* part, int grid,
                       int part_numel, int sync_numel, cudaStream_t st) {
  static size_t limit = 0;
  const int D = g.D, F = g.F;
  if (g.R < 1 || D < kTileCols || F < kTileCols || D % kTileCols || F % kTileCols || grid < 1 ||
      D > 32 * kLnMaxPerLane || g.max_units < 0 || g.weight_bytes < 0 ||
      sync_numel < mlp_sync_ints(D, F))
    return cudaErrorInvalidValue;
  size_t need = 0;
  for (int p = 0; p < kMlpPhases; ++p) {
    const bool here = CROSS || p > 0;
    const int K = phase_k(p, D, F), N = phase_n(p, D, F);
    g.splits[p] = here ? gemm_splits(K, N) : 1;
    g.part[p] = static_cast<float*>(part) + need;
    if (here) need += (size_t)g.splits[p] * g.R * N;
    if (here && reinterpret_cast<uintptr_t>(w[p]) % 16) return cudaErrorInvalidValue;
  }
  if ((size_t)part_numel < need) return cudaErrorInvalidValue;
  const size_t smem = mlp_smem_bytes(D, F, g.splits, CROSS, g.max_units, g.weight_bytes);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap maps[kMlpPhases];
  for (int p = kMlpPhases - 1; p >= 0; --p) {
    const int K = phase_k(p, D, F), N = phase_n(p, D, F);
    if (!CROSS && p == 0) {
      maps[0] = maps[1];  // unused
    } else if (!weight_map(&maps[p], static_cast<const int8_t*>(w[p]), K, N,
                           slab_of(K, g.splits[p]).box_rows)) {
      return cudaErrorInvalidValue;
    }
  }
  const cudaError_t err = reserve_smem(mlp_persistent_kernel<CROSS, E3>, smem, &limit);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched =
      cudaLaunchKernelEx(&cfg, mlp_persistent_kernel<CROSS, E3>, maps[0], maps[1], maps[2], g);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace
}  // namespace ttasr

// B4.  x, cross, x_mid (scratch: x'), out: (R, D) f32; h (scratch): (R, F)
// bf16; part (scratch): part_numel f32; sync: sync_numel int32, zeros
// between calls; sched: the schedule of n_blocks blocks
// (ops/decoder_mlp.py::mlp_plan).
extern "C" int ttasr_mlp_crossout_int8(
    const void* x, const void* cross, const void* woc, const void* woc_s, const void* boc,
    const void* ln_s, const void* ln_b, const void* w1, const void* w1_s, const void* b1,
    const void* w2, const void* w2_s, const void* b2, void* x_mid, void* h, void* out,
    void* part, void* sync, const void* sched, int R, int D, int F, int n_blocks,
    int max_units, int weight_bytes, int part_numel, int sync_numel, void* stream) {
  ttasr::MlpArgs g{};
  g.x = static_cast<const float*>(x);
  g.cross = static_cast<const float*>(cross);
  g.ln_s = static_cast<const float*>(ln_s);
  g.ln_b = static_cast<const float*>(ln_b);
  g.scale[0] = static_cast<const float*>(woc_s);
  g.scale[1] = static_cast<const float*>(w1_s);
  g.scale[2] = static_cast<const float*>(w2_s);
  g.bias[0] = static_cast<const float*>(boc);
  g.bias[1] = static_cast<const float*>(b1);
  g.bias[2] = static_cast<const float*>(b2);
  g.x_mid = static_cast<float*>(x_mid);
  g.h = static_cast<__nv_bfloat16*>(h);
  g.out = static_cast<float*>(out);
  g.sync = static_cast<int*>(sync);
  g.sched = static_cast<const int*>(sched);
  g.R = R, g.D = D, g.F = F, g.max_units = max_units, g.weight_bytes = weight_bytes;
  const void* const w[3] = {woc, w1, w2};
  return (int)ttasr::launch_mlp<true, ttasr::kResidualBias>(
      g, w, part, n_blocks, part_numel, sync_numel, static_cast<cudaStream_t>(stream));
}

// B14: h (scratch, R x F bf16) = bf16(GELU(LN2(x) @ W1 * s1 + b1)); out (R,
// D) = h @ W2 * s2 (partial) or (x + b2) + h @ W2 * s2.  x, out (R, D) f32;
// F is the shard's hidden width; part, sync, sched as for B4.
extern "C" int ttasr_mlp_int8(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                              const void* w1_s, const void* b1, const void* w2, const void* w2_s,
                              const void* b2, void* h, void* out, void* part, void* sync,
                              const void* sched, int R, int D, int F, int partial, int n_blocks,
                              int max_units, int weight_bytes, int part_numel, int sync_numel,
                              void* stream) {
  ttasr::MlpArgs g{};
  g.x = static_cast<const float*>(x);
  g.ln_s = static_cast<const float*>(ln_s);
  g.ln_b = static_cast<const float*>(ln_b);
  g.scale[1] = static_cast<const float*>(w1_s);
  g.scale[2] = static_cast<const float*>(w2_s);
  g.bias[1] = static_cast<const float*>(b1);
  g.bias[2] = static_cast<const float*>(b2);
  g.h = static_cast<__nv_bfloat16*>(h);
  g.out = static_cast<float*>(out);
  g.sync = static_cast<int*>(sync);
  g.sched = static_cast<const int*>(sched);
  g.R = R, g.D = D, g.F = F, g.max_units = max_units, g.weight_bytes = weight_bytes;
  const void* const w[3] = {nullptr, w1, w2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (partial)
    return (int)ttasr::launch_mlp<false, ttasr::kScale>(g, w, part, n_blocks, part_numel,
                                                        sync_numel, st);
  return (int)ttasr::launch_mlp<false, ttasr::kResidualBias>(g, w, part, n_blocks, part_numel,
                                                             sync_numel, st);
}
