// The Whisper encoder's self-attention on Hopper's tensor cores, shared by
// the three entry points of encoder_attention.cu so they cannot drift: B11
// (three bf16 (B, T, D) tensors), B6 (the s8 x s8 encoder's fused
// (B, T, 3D) bf16 buffer) and B19 (q/k/v (B, T, H, 64), its scores scaled
// by 64^-0.5 here; float32 inputs are rounded to bf16 by a pass before).
// B11's and B6's float32 inputs take the same kernel on 3xTF32 tiles
// (Tf32Tiles, at the end of this file).
//
// Layout: merged heads, head h at columns 64h..64h+63 of rows `ld`
// elements apart (a contiguous (B, T, H, 64) is the merged (B, T, 64 H)
// layout byte for byte); keys at index >= t_real masked; the output
// (B, T, D) rows D apart, bf16, or float32 holding bf16-rounded values.
// Sums are f32.
//
// What bounds it: per (batch, head) ~4 T^2 64 FLOP against 3 T 64 2 bytes
// of q/K/V (~T/3 FLOP per byte, ~500 at T = 1500, above the H100's ~295
// bf16 balance point), so it is compute-bound once the quadratic score
// matrix stays out of device memory, and only wgmma reaches the tensor
// cores' full rate.  At a head width of 64 each score costs 256 FLOP of
// products but also one exp2, and the SFU's 16 exp2 per clock per SM
// match the tensor cores' 4096 FLOP per clock: the softmax has to run
// under the products.
//
// The design: one block of 384 threads per SM, persistent over work items
// of (128-query tile, head, batch row):
// * warpgroup 0 is the producer: one thread loads each item's Q tile (two
//   buffers, so the next item's Q arrives during this one) and keeps K and
//   V tiles of 128 keys x 64 columns (16 KB each) in flight by TMA through
//   rings of 3 stages, with a full and an empty barrier per stage of each
//   (a K stage is freed once its scores are in registers, a V stage after
//   its P V).  The tensor maps are 3-D (D, T, B) with the
//   128-B swizzle, so a box past T is zero-filled (never the next batch
//   row) and each 128-B row lands in the layout the wgmma descriptors read.
// * warpgroups 1 and 2 are consumers of 64 query rows each: S = Q K^T by
//   four wgmma.m64n128k16 from shared memory (Q and K K-major), an online
//   softmax in registers in f32 (score scale and log2(e) folded into one
//   multiply before exp2; keys >= t_real masked in the last tile only;
//   tiles wholly past t_real are never loaded), then O += P V by eight
//   wgmma.m64n64k16 with P in registers as bf16 and V read MN-major from
//   shared memory through the descriptor's transpose bit.  Tile j's score
//   product is issued together with tile j-1's P V, so the softmax of tile
//   j runs while the tensor cores do P V; and the two warpgroups take turns
//   to issue (two named barriers), so one's softmax runs under the other's
//   products.
// * setmaxnreg moves registers from the producer to the consumers.
// The pipeline is one kernel template, attention_wgmma_kernel, over a
// tile type that gives the tile shapes, the loads and the products:
// Bf16Tiles (above) or Tf32Tiles.
// The probabilities rounded to bf16 are the unnormalised exponentials of
// the online softmax; the TPU kernels round the normalised ones, which
// differs by up to one bf16 step per probability.

#pragma once

#include <cuda.h>  // CUtensorMap (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ttasr_enc {

constexpr int kDh = 64;         // head width (Whisper): one 128-B bf16 row
constexpr int kBlockQ = 128;    // query rows per work item
constexpr int kBlockK = 128;    // keys per ring stage (bf16)
constexpr int kConsumers = 2;   // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileBytes = kBlockK * kDh * 2;  // 16 KB: a bf16 Q, K or V tile

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Until the phase of parity `parity` has completed (parity 1 passes at
// once on a fresh barrier: the producer's first pass over empty stages).
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

// One box (64 columns, 128 rows, 1 batch row) at (c0, c1, c2) into shared
// memory at `dst`; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor for a tile of 128-B rows written by TMA
// with SWIZZLE_128B: start address >> 4, leading offset 1 (unused by
// swizzled K-major tiles and by MN-major tiles one swizzle atom, 64
// bf16, wide), stride 1024 B between groups of 8 rows, layout 1 (128-B
// swizzle).  A k16 step inside a row advances the start by 32 B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or reuse of registers that an
// in-flight wgmma writes or reads across the wait that ends it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, K-major smem) * B (16 x 128, K-major
// smem).  Warp w of the warpgroup holds rows 16w..16w+15; with lane =
// 4 g + t, d[4 j + e] is row g (+8 for e >= 2), column 8 j + 2 t + (e & 1).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a_desc,
                                                    uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers: a[0] row g keys
// 2t..2t+1, a[1] row g+8, a[2] row g keys 2t+8.., a[3] row g+8) * B (16 x 64,
// MN-major smem: the transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// Named barriers 1 and 2 (0 is __syncthreads) order the two consumer
// warpgroups' products: a warpgroup syncs on its own before it issues and
// arrives on the other's after, so one's softmax runs under the other's
// products.  256 threads each: the syncing warpgroup and the arriving one.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// ---------------------------------------------------------------------------
// The consumers' pieces
// ---------------------------------------------------------------------------

// s = Q K^T for this warpgroup's 64 rows and one 128-key tile: dh = 64 in
// four k16 steps of 32 B.
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_m64n128k16_ss(s, smem_desc(q_tile + 32 * kk), smem_desc(k_tile + 32 * kk), kk > 0);
}

// o += P V over one 128-key tile: eight k16 steps of 16 keys (2 KB of V).
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_m64n64k16_rs(o, a, smem_desc(v_tile + 2048 * kk));
  }
}

// One tile of N keys of the online softmax over this thread's rows g (lo)
// and g + 8 (hi), from the scores of a wgmma.m64nN accumulator: masks keys
// >= t_real when the tile reaches past it, updates the running maxima (raw
// scores) and sums, returns each row's correction factor for the earlier
// sums, and leaves the unnormalised probabilities exp2(scale_log2 (s - m))
// in s.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], int k0, int t_real, int t,
                                             float scale_log2, float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi, float& corr_lo,
                                             float& corr_hi) {
  constexpr int C = N / 16;  // partial maxima and sums per row
  if (k0 + N > t_real) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= t_real) s[4 * j + e] = -INFINITY;
  }
  // row maxima and sums as trees over the N / 8 n-chunks: short dependency
  // chains
  float a_lo[C], a_hi[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    a_lo[j] = fmaxf(fmaxf(s[4 * j], s[4 * j + 1]), fmaxf(s[4 * j + 4 * C], s[4 * j + 4 * C + 1]));
    a_hi[j] =
        fmaxf(fmaxf(s[4 * j + 2], s[4 * j + 3]), fmaxf(s[4 * j + 4 * C + 2], s[4 * j + 4 * C + 3]));
  }
#pragma unroll
  for (int w = C / 2; w >= 1; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      a_lo[j] = fmaxf(a_lo[j], a_lo[j + w]);
      a_hi[j] = fmaxf(a_hi[j], a_hi[j + w]);
    }
  float mx_lo = fmaxf(m_lo, a_lo[0]), mx_hi = fmaxf(m_hi, a_hi[0]);
  // the 4 lanes of a row group hold the row's N columns between them
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  // key 0 < t_real lies in tile 0, so every max is finite from there on;
  // on tile 0 the old max is -inf and the correction exp2(-inf) = 0
  corr_lo = fast_exp2((m_lo - mx_lo) * scale_log2);
  corr_hi = fast_exp2((m_hi - mx_hi) * scale_log2);
  m_lo = mx_lo;
  m_hi = mx_hi;
  const float off_lo = mx_lo * scale_log2, off_hi = mx_hi * scale_log2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = fast_exp2(fmaf(s[4 * j], scale_log2, -off_lo));
    s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -off_lo));
    s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -off_hi));
    s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -off_hi));
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    a_lo[j] = (s[4 * j] + s[4 * j + 1]) + (s[4 * j + 4 * C] + s[4 * j + 4 * C + 1]);
    a_hi[j] = (s[4 * j + 2] + s[4 * j + 3]) + (s[4 * j + 4 * C + 2] + s[4 * j + 4 * C + 3]);
  }
#pragma unroll
  for (int w = C / 2; w >= 1; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      a_lo[j] += a_lo[j + w];
      a_hi[j] += a_hi[j + w];
    }
  l_lo = l_lo * corr_lo + a_lo[0];
  l_hi = l_hi * corr_hi + a_hi[0];
}

// The probabilities as the A operand of P V: k16 step kk takes the score
// columns 16 kk..16 kk + 15, i.e. n-chunks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_probs(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
}

// Two adjacent outputs of a row: bf16, or float32 holding the bf16-rounded
// value (B19 rounds its output to bf16 before the cast to q's type).
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the same ring
// ---------------------------------------------------------------------------
//
// B11's and B6's float32 inputs keep exact-f32 accuracy on the tensor
// cores: each operand a is split into a_hi = rna_tf32(a) and a_lo =
// rna_tf32(a - a_hi) (a - a_hi is exact in f32), and a b is taken as
// a_hi b_hi + a_hi b_lo + a_lo b_hi, each term a wgmma .tf32 product (k = 8)
// added in f32: ~2^-21 relative per product, where one TF32 product keeps
// ~2^-11.  Three products per FLOP at half the bf16 rate: 6x the bf16
// kernel's tensor time for the same attention.
//
// A .tf32 operand read from shared memory must be K-major (wgmma's
// transpose bit is for 16-bit types only), so P V needs V with the keys
// contiguous.  A pre-pass (split_tf32_kernel in the .cu) writes the hi and
// lo planes of q and K as (B, T, D) and of V transposed as (B H, 64,
// t_pad), t_pad = T rounded up to kKeysF32, zeros past T.  Within each
// group of 8 keys V's columns are permuted (position j holds key 2 j for
// j < 4, key 2 (j - 4) + 1 above): the score accumulator gives a thread
// keys 2t and 2t + 1 of an n-chunk, and the tf32 A fragment in registers
// wants k indices t and t + 4, so the permutation puts P straight into the
// A operand of P V with no shuffle.
//
// The bf16 kernel's pipeline on tiles resized for 4-byte planes
// (Tf32Tiles): 64-key tiles (a 64-column f32 row is two 128-B swizzle
// atoms, so each plane of a tile is two TMA boxes of 32 columns and a k8
// step advances 32 B inside an atom); one Q buffer of 128 rows (hi + lo,
// 64 KB: not double-buffered) and K and V rings of 2 stages of 32 KB (hi +
// lo); S = Q K^T by 3 x 8 wgmma.m64n64k8 from shared memory, P V by 3 x 8
// wgmma.m64n64k8 with P's hi and lo in registers.  The probabilities stay
// f32 (hi + lo), the output is f32.

constexpr int kKeysF32 = 64;       // keys per ring stage
constexpr int kAtomF32 = 32;       // f32 columns per 128-B swizzle atom
constexpr int kQPlaneF32 = kBlockQ * kDh * 4;    // 32 KB: one plane of a Q tile
constexpr int kKvPlaneF32 = kKeysF32 * kDh * 4;  // 16 KB: one plane of a K or V tile

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, both tf32 (f32 bit patterns with the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d (64 x 64, f32) (+)= A (64 x 8, K-major smem) * B (8 x 64, K-major smem).
// The accumulator's layout is the bf16 products': d[4 j + e] is row g (+8
// for e >= 2), column 8 j + 2 t + (e & 1).
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32], uint64_t a_desc,
                                                       uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 8, tf32 in registers: a[0] row g k index t,
// a[1] row g + 8, a[2] row g k index t + 4, a[3] row g + 8) * B (8 x 64,
// K-major smem).
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// The descriptor of k8 step kk of a plane stored as two atoms of `rows`
// rows x 128 B: atom kk / 4, 32 B per step inside it.
__device__ __forceinline__ uint64_t tf32_desc(uint32_t plane, int rows, int kk) {
  return smem_desc(plane + (kk / 4) * rows * 128 + 32 * (kk % 4));
}

// s = Q K^T over one 64-key tile, 3xTF32: for each k8 step of dh = 64,
// hi.hi, hi.lo, lo.hi.  `q` is this warpgroup's rows in the hi plane (lo at
// + kQPlaneF32), `k` the stage's hi plane (lo at + kKvPlaneF32).
__device__ __forceinline__ void issue_scores_tf32(float (&s)[32], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk) {
    const uint64_t qh = tf32_desc(q, kBlockQ, kk), ql = tf32_desc(q + kQPlaneF32, kBlockQ, kk);
    const uint64_t kh = tf32_desc(k, kKeysF32, kk), kl = tf32_desc(k + kKvPlaneF32, kKeysF32, kk);
    wgmma_m64n64k8_tf32_ss(s, qh, kh, kk > 0);
    wgmma_m64n64k8_tf32_ss(s, qh, kl, 1);
    wgmma_m64n64k8_tf32_ss(s, ql, kh, 1);
  }
}

// o += P V over one 64-key tile, 3xTF32: k8 step kk takes n-chunk kk of
// the scores (keys 8 kk + 2 t, + 1 for rows g and g + 8) as k indices t and
// t + 4, which V's permuted columns hold.  `v` is the stage's hi plane of
// V^T (lo at + kKvPlaneF32).
__device__ __forceinline__ void issue_pv_tf32(float (&o)[32], const uint32_t (&ph)[32],
                                              const uint32_t (&pl)[32], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kKeysF32 / 8; ++kk) {
    const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1], ph[4 * kk + 3]};
    const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1], pl[4 * kk + 3]};
    const uint64_t vh = tf32_desc(v, kDh, kk), vl = tf32_desc(v + kKvPlaneF32, kDh, kk);
    wgmma_m64n64k8_tf32_rs(o, ah, vh);
    wgmma_m64n64k8_tf32_rs(o, ah, vl);
    wgmma_m64n64k8_tf32_rs(o, al, vh);
  }
}

__device__ __forceinline__ void split_probs(uint32_t (&ph)[32], uint32_t (&pl)[32],
                                            const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) split_tf32(s[i], ph[i], pl[i]);
}

// ---------------------------------------------------------------------------
// The two tile types
// ---------------------------------------------------------------------------
//
// What attention_wgmma_kernel asks of its tile type: kKeys keys per ring
// stage, kStages stages in each of the K and V rings, kQBufs Q buffers of
// kQBytes, K and V stages of kKvBytes; Probs, the probabilities as the A
// operand of P V; load_q / load_k / load_v, one tile's TMA loads into
// `dst` on barrier `bar` (rows from `row0`, this head's columns from `col`;
// `bh` = batch row x heads + head, `bh_rows` = B heads); scores and pv,
// the products; pack, the softmax's probabilities into Probs; fence, the
// register fence over Probs; store2, two adjacent outputs of a row.

// bf16 q/K/V: (D, T, B) maps with 64 x 128 x 1 boxes; one wgmma chain per
// product; the output bf16, or float32 holding bf16-rounded values.
template <typename OutT>
struct Bf16Tiles {
  using Out = OutT;
  static constexpr int kKeys = kBlockK;
  static constexpr int kStages = 3;
  static constexpr int kQBufs = 2;
  static constexpr int kQBytes = kTileBytes;
  static constexpr int kKvBytes = kTileBytes;
  struct Probs {
    uint32_t p[32];
  };

  static __device__ __forceinline__ void load_q(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int col, int row0, int batch, int) {
    tma_load_3d(dst, map, bar, col, row0, batch);
  }
  static __device__ __forceinline__ void load_k(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int col, int row0, int batch, int) {
    tma_load_3d(dst, map, bar, col, row0, batch);
  }
  static __device__ __forceinline__ void load_v(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int col, int row0, int batch, int,
                                                int) {
    tma_load_3d(dst, map, bar, col, row0, batch);
  }
  static __device__ __forceinline__ void scores(float (&s)[kKeys / 2], uint32_t q, uint32_t k) {
    issue_scores(s, q, k);
  }
  static __device__ __forceinline__ void pv(float (&o)[32], const Probs& p, uint32_t v) {
    issue_pv(o, p.p, v);
  }
  static __device__ __forceinline__ void pack(Probs& p, const float (&s)[kKeys / 2]) {
    pack_probs(p.p, s);
  }
  static __device__ __forceinline__ void fence(Probs& p) { reg_fence(p.p); }
  static __device__ __forceinline__ void store2(Out* dst, float a, float b) {
    ttasr_enc::store2(dst, a, b);
  }
};

// The split planes of split_tf32_kernel: q_map and k_map are (D, T, 2B)
// with 32 x 128 x 1 and 32 x 64 x 1 boxes (batch row B + b is b's lo
// plane), v_map is (t_pad, 64, 2 B H) with 32 x 64 x 1 boxes (B H + bh is
// bh's lo plane); three wgmma chains per product; the output f32.
struct Tf32Tiles {
  using Out = float;
  static constexpr int kKeys = kKeysF32;
  static constexpr int kStages = 2;
  static constexpr int kQBufs = 1;
  static constexpr int kQBytes = 2 * kQPlaneF32;  // hi + lo
  static constexpr int kKvBytes = 2 * kKvPlaneF32;
  struct Probs {
    uint32_t hi[32], lo[32];
  };

  static __device__ __forceinline__ void load_q(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int col, int row0, int batch, int B) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      tma_load_3d(dst + a * kBlockQ * 128, map, bar, col + kAtomF32 * a, row0, batch);
      tma_load_3d(dst + kQPlaneF32 + a * kBlockQ * 128, map, bar, col + kAtomF32 * a, row0,
                  B + batch);
    }
  }
  static __device__ __forceinline__ void load_k(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int col, int row0, int batch, int B) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      tma_load_3d(dst + a * kKeysF32 * 128, map, bar, col + kAtomF32 * a, row0, batch);
      tma_load_3d(dst + kKvPlaneF32 + a * kKeysF32 * 128, map, bar, col + kAtomF32 * a, row0,
                  B + batch);
    }
  }
  static __device__ __forceinline__ void load_v(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int, int row0, int, int bh,
                                                int bh_rows) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      tma_load_3d(dst + a * kDh * 128, map, bar, row0 + kAtomF32 * a, 0, bh);
      tma_load_3d(dst + kKvPlaneF32 + a * kDh * 128, map, bar, row0 + kAtomF32 * a, 0,
                  bh_rows + bh);
    }
  }
  static __device__ __forceinline__ void scores(float (&s)[kKeys / 2], uint32_t q, uint32_t k) {
    issue_scores_tf32(s, q, k);
  }
  static __device__ __forceinline__ void pv(float (&o)[32], const Probs& p, uint32_t v) {
    issue_pv_tf32(o, p.hi, p.lo, v);
  }
  static __device__ __forceinline__ void pack(Probs& p, const float (&s)[kKeys / 2]) {
    split_probs(p.hi, p.lo, s);
  }
  static __device__ __forceinline__ void fence(Probs& p) {
    reg_fence(p.hi);
    reg_fence(p.lo);
  }
  static __device__ __forceinline__ void store2(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
};

// The dynamic shared memory of attention_wgmma_kernel<Tiles>: the Q
// buffers, the K ring, the V ring, the barriers, and slack to align to
// 1024 B (the 128-B swizzle repeats every 8 rows of 128 B).
template <typename Tiles>
constexpr int smem_bytes() {
  return Tiles::kQBufs * Tiles::kQBytes + 2 * Tiles::kStages * Tiles::kKvBytes +
         8 * (2 * Tiles::kQBufs + 4 * Tiles::kStages) + 1024;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Persistent: block b takes work items b, b + gridDim.x, ... of n_qt x H x
// B (128-query tile fastest, then head, then batch row), so the producer
// loads the next items' tiles while the consumers finish the current one.
// The maps as the tile type reads them; out rows D apart; scores
// multiplied by scale_log2 / log2(e).
template <typename Tiles>
__global__ void __launch_bounds__(kThreads, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       typename Tiles::Out* __restrict__ out, int B, int T, int D, int t_real,
                       float scale_log2) {
  constexpr int kKeys = Tiles::kKeys, kStages = Tiles::kStages, kQBufs = Tiles::kQBufs;
  constexpr int kQBytes = Tiles::kQBytes, kKvBytes = Tiles::kKvBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t q_buf = base;  // kQBufs buffers: items take them in turn
  const uint32_t k_ring = q_buf + kQBufs * kQBytes;
  const uint32_t v_ring = k_ring + kStages * kKvBytes;
  const uint32_t q_full = v_ring + kStages * kKvBytes;  // kQBufs barriers each
  const uint32_t q_empty = q_full + 8 * kQBufs;
  const uint32_t k_full = q_empty + 8 * kQBufs;  // kStages barriers each
  const uint32_t k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  const int n_qt = (T + kBlockQ - 1) / kBlockQ;
  const int heads = D / kDh;
  const int n_items = n_qt * heads * B;
  const int n_tiles = (t_real + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, kConsumers * 4);  // every consumer warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, kConsumers * 4);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(v_empty + 8 * i, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int ring = 0;  // tiles through the K and V rings so far
      for (int i = 0, item = blockIdx.x; item < n_items; ++i, item += gridDim.x) {
        const int head = (item / n_qt) % heads, batch = item / (n_qt * heads);
        const int col = head * kDh, bh = batch * heads + head;
        const int qi = i % kQBufs;
        mbar_wait(q_empty + 8 * qi, ((i / kQBufs) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qi, kQBytes);
        Tiles::load_q(q_buf + qi * kQBytes, &q_map, q_full + 8 * qi, col, item % n_qt * kBlockQ,
                      batch, B);
        for (int kt = 0; kt < n_tiles; ++kt, ++ring) {
          const int st = ring % kStages, phase = ((ring / kStages) & 1) ^ 1;
          mbar_wait(k_empty + 8 * st, phase);
          mbar_expect_tx(k_full + 8 * st, kKvBytes);
          Tiles::load_k(k_ring + st * kKvBytes, &k_map, k_full + 8 * st, col, kt * kKeys, batch,
                        B);
          mbar_wait(v_empty + 8 * st, phase);
          mbar_expect_tx(v_full + 8 * st, kKvBytes);
          Tiles::load_v(v_ring + st * kKvBytes, &v_map, v_full + 8 * st, col, kt * kKeys, batch,
                        bh, B * heads);
        }
      }
    }
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float o[32], s[kKeys / 2];
    typename Tiles::Probs p;

    int ring = 0;
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    for (int i = 0, item = blockIdx.x; item < n_items; ++i, item += gridDim.x) {
      const int q0 = item % n_qt * kBlockQ;
      const int col = (item / n_qt) % heads * kDh, batch = item / (n_qt * heads);
      const int qi = i % kQBufs;
      // this warpgroup's rows (of each 128-B atom of a plane)
      const uint32_t my_q = q_buf + qi * kQBytes + wg * 64 * 128;
#pragma unroll
      for (int j = 0; j < 32; ++j) o[j] = 0.f;
      float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, corr_lo, corr_hi;

      int st = ring % kStages;
      mbar_wait(q_full + 8 * qi, (i / kQBufs) & 1);
      mbar_wait(k_full + 8 * st, (ring / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      Tiles::scores(s, my_q, k_ring + st * kKvBytes);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      reg_fence(s);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * st);
        if (n_tiles == 1) mbar_arrive(q_empty + 8 * qi);  // the item's last use of Q
      }
      softmax_tile<kKeys>(s, 0, t_real, t, scale_log2, m_lo, m_hi, l_lo, l_hi, corr_lo, corr_hi);
      Tiles::pack(p, s);

      for (int kt = 1; kt < n_tiles; ++kt) {
        const int prev = st;
        st = (ring + kt) % kStages;
        mbar_wait(k_full + 8 * st, ((ring + kt) / kStages) & 1);
        mbar_wait(v_full + 8 * prev, ((ring + kt - 1) / kStages) & 1);
        turn_wait(wg);
        wgmma_fence();
        Tiles::scores(s, my_q, k_ring + st * kKvBytes);
        wgmma_commit();
        Tiles::pv(o, p, v_ring + prev * kKvBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();  // the scores; P V of tile kt - 1 runs on
        reg_fence(s);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * st);
          if (kt == n_tiles - 1) mbar_arrive(q_empty + 8 * qi);
        }
        softmax_tile<kKeys>(s, kt * kKeys, t_real, t, scale_log2, m_lo, m_hi, l_lo, l_hi,
                            corr_lo, corr_hi);
        wgmma_wait<0>();
        reg_fence(o);
        Tiles::fence(p);
        if (lane == 0) mbar_arrive(v_empty + 8 * prev);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= corr_lo;
          o[4 * j + 1] *= corr_lo;
          o[4 * j + 2] *= corr_hi;
          o[4 * j + 3] *= corr_hi;
        }
        Tiles::pack(p, s);
      }
      mbar_wait(v_full + 8 * st, ((ring + n_tiles - 1) / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      Tiles::pv(o, p, v_ring + st * kKvBytes);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      reg_fence(o);
      Tiles::fence(p);
      if (lane == 0) mbar_arrive(v_empty + 8 * st);
      ring += n_tiles;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
      const int row_lo = q0 + wg * 64 + warp * 16 + g;
      const int row_hi = row_lo + 8;
      typename Tiles::Out* dst = out + (size_t)batch * T * D + col + 2 * t;
#pragma unroll
      for (int j = 0; j < kDh / 8; ++j) {
        if (row_lo < T)
          Tiles::store2(dst + (size_t)row_lo * D + 8 * j, o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
        if (row_hi < T)
          Tiles::store2(dst + (size_t)row_hi * D + 8 * j, o[4 * j + 2] * inv_hi,
                        o[4 * j + 3] * inv_hi);
      }
    }
    if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass: none left pending
  }
}

}  // namespace ttasr_enc
