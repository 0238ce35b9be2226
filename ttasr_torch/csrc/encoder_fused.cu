// Row producer + dynamic int8 quantize of the s8 x s8 encoder, for Hopper
// (sm_90a): B5, B7, B8 and B9, B9, B5 and B8 reading the int8 GEMM's int32
// accumulators, and the qkv GEMM's epilogue.
//
// Replace ttasr/ops/encoder_fused_pallas.py (called per encoder layer at
// model.py:409, :295, :412 and :319):
//   ln_quant      LN(x)                     -> int8 codes + row scale
//   quant_only    x                         -> int8 codes + row scale
//   add_ln_quant  x + y -> bf16 residual;  LN(f32 x + y) -> codes + scale
//   gelu_quant    GELU(h) (A&S erf)         -> int8 codes + row scale
// and, with the s8 x s8 GEMM's epilogue (ttasr/ops/quant.py:156-171, an XLA
// dot whose epilogue XLA fuses) folded in front:
//   gelu_quant_acc    h = bf16(acc * xs * ws + b); GELU(h) -> codes + scale
//                     (W1, ttasr_torch/models/whisper/model.py::_mlp_act8_acc)
//   ln_quant_acc      y = bf16(acc * xs * ws + b); x' = bf16(x + y) -> bf16
//                     residual; LN(x') -> codes + scale (W2, the next
//                     layer's LN1 in model.py::encode)
//   add_ln_quant_acc  y = bf16(acc * xs * ws + b); s = f32 x + y; bf16(s)
//                     -> residual; LN(s) -> codes + scale (wo, LN2 in
//                     model.py::encode)
//   qkv_epilogue_acc  bf16(acc * xs * ws' + b') -> the merged qkv buffer
//                     that B6 reads (model.py::_self_attn_act8); ws' and b'
//                     are ws and b with their first q_cols columns times
//                     q_scale, the dh^-0.5 query scale that
//                     ttasr/models/whisper/model.py:264-269 folds in
// Rows are bf16 or, through the entries named ..._f32, float32 (the int8
// engine on float32 params): the Pallas kernels read any float rows
// (encoder_fused_pallas.py:122) and write the residual in x's own type
// (:169).  The template takes the row type as a parameter; on f32 rows the
// roundings to the row type drop out (x', the residuals, the qkv output,
// add_ln_quant_acc's y), those to bf16 that the plain versions keep for any
// x stay (W1's output before the GELU, W2's before ln_quant_acc's add), and
// gelu_quant computes gelu_as on its f32 h (the table holds bf16 values).
// The f32 instantiations hold twice the row words and spill more at 128
// registers (ptxas: up to 180 bytes of spill stores); the bf16 ones are the
// same code as before.
// The epilogue is the written expression, ((f32(acc) * xs) * ws) + b, one
// _rn operation each (no FMA contraction), then the bf16 rounding of the
// GEMM's output type; x' is the eager bf16 add (an f32 sum, rounded), and
// its LayerNorm reads the rounded x', as ln_quant does (add_ln_quant and
// add_ln_quant_acc instead normalise the f32 sum: the two contracts differ
// on purpose).  The qkv epilogue's ws' and b' are the f32 products the
// host used to form per call (the scale is f32(q_scale), b is f32(b)),
// taken as the block copies its column vectors.  It has no reduction and
// no codes: one pass of int32 in and bf16 out, which is what the
// template's row loads, stores and column-vector copy already do, so it is
// a mode of the template, not a kernel of its own.
// Each producer runs in f32 and its f32 output is quantized directly (no
// bf16 intermediate, the fused contract of encoder_fused_pallas.py:18-27):
//   scale = max(absmax, 1e-8) * f32(1/127), codes = rint(v / scale)
// The multiply by the reciprocal is what the JAX kernels compute (XLA
// rewrites the division by the constant 127 inside the kernel); the codes
// are those of the true IEEE division (quant_code), rounded half to even.
// Every multiply and add of a producer is an explicit _rn operation (no
// FMA contraction), in the order of the JAX expression.
//
// What bounds it on this card: one pass over rows of D = 1280, 3D = 3840
// or F = 5120 values (bf16, or int32 accumulators at twice the bytes).  The LayerNorm
// entries are memory-bound; the GELU entries are not: the A&S erf costs
// two IEEE divisions, an expf and a polynomial per value, more issue time
// than the bytes take.  The design, one template for all eight entries:
//   * a row per team of G warps, G = ceil(width / 1280): one warp per
//     D-row, three per qkv row, four per F-row; each lane holds 5 chunks of 8 consecutive
//     values (40 at D and F), all its loads of a row issued together (16
//     bytes per bf16 chunk, 2 x 16 per int32 chunk), the next row's issued
//     before this row's stores; stores of 16 bytes (bf16) and 8 bytes
//     (codes: a warp writes 256 contiguous bytes);
//   * reductions by warp shuffles, then, for G > 1, the G warps' partials
//     through shared memory under one named barrier of the team (bar.sync
//     id, 32 G), added in warp order: a fixed order per row, so the same
//     input gives the same bits on every run; the LayerNorm stays two-pass
//     (mean, then the biased variance, each a sum times f32(1/D));
//   * persistent blocks of 8 warps (two per SM: 128 registers a thread),
//     each team walking its rows; the team's first row is in flight while
//     the block copies its column vectors (ws and b of the epilogue, the
//     LayerNorm's scale and bias, bf16 or f32) into shared memory as f32,
//     16-byte loads issued together;
//   * GELU by a shared-memory table of gelu_as over the bf16 values of
//     magnitude 2^-10 to 64 (h is bf16 on both GELU entries), the rest
//     computed; the code division by a multiply whose rounding is checked
//     against the half-integers (quant_code); bf16 roundings two at a
//     time.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): without the GELU
// the accumulator entry streams at ~89 % of the memory rate at 48
// windows; the lookups cost a third of its time.  Tried and dropped: an L2 bulk prefetch of the
// next row (no gain), 4-value chunks at three blocks per SM (mixed), one
// pass of lookups and codes with rare fix-ups after (spills at 128
// registers, twice as slow), __frcp_rn in gelu_as (1 %).
//
// The split entries (the encoder on a mesh, B7 and B9 on a rank's columns of
// rows that the model axis splits): each row's scale needs the absmax of the
// whole row, so the template runs in two passes around a MAX all-reduce of
// the (rows,) partials over the axis (ttasr_torch/models/whisper/model.py).
// The absmax pass (kAbsmax) computes the producer exactly as the whole-row
// entry does and writes the absmax of its columns; the codes pass (kCodes)
// computes it again and takes its scale, max(absmax, 1e-8) * f32(1/127),
// from the reduced absmax instead of its own, so the codes and scales of a
// rank's columns are the whole-row entry's bit for bit.  B9's absmax pass
// also writes h (W1's epilogue, rounded to bf16: the value the GELU reads),
// which the codes pass reads back through the kGelu mode, with the same
// shared-memory table: 2 bytes a value where reading the accumulators again
// takes 4 and the epilogue (H100 80GB HBM3 at 700 W, phase 5 of
// chip_smoke.py: 0.0107 ms against 0.0127 at 1500 x 1280, PERF.md §6).
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes.

#include "skinny_gemm.cuh"

namespace {

constexpr int kVec = 8;                          // consecutive values per chunk
constexpr int kChunks = 5;                       // chunks per lane
constexpr int kWarps = 8;                        // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTeamWidth = 32 * kVec * kChunks;  // values one warp holds: 1280
constexpr int kMaxWidth = 8192;
constexpr float kInv127 = 1.f / 127.f;

// kAccAddLn: ln_quant_acc (LN of the rounded x'); kAccAddLnSum:
// add_ln_quant_acc (LN of the f32 sum); kAccOut: the qkv epilogue
enum Mode { kLn, kAddLn, kGelu, kIdentity, kAccGelu, kAccAddLn, kAccAddLnSum, kAccOut };
// the pass of a mode: the whole row's codes, or the split entries' absmax
// pass and codes pass (scale from the reduced absmax)
enum Split { kWhole, kAbsmax, kCodes };

// what each mode reads and computes (host and device)
__host__ __device__ constexpr bool reads_acc(int m) { return m >= kAccGelu; }
__host__ __device__ constexpr bool has_ln(int m) {
  return m == kLn || m == kAddLn || m == kAccAddLn || m == kAccAddLnSum;
}
__host__ __device__ constexpr bool has_gelu(int m) { return m == kGelu || m == kAccGelu; }
__host__ __device__ constexpr bool two_inputs(int m) {
  return m == kAddLn || m == kAccAddLn || m == kAccAddLnSum;
}
// the GELU of bf16 values by table (gelu_bf16): h is bf16 but in gelu_quant
// on f32 rows, which computes gelu_as
__host__ __device__ constexpr bool gelu_table_used(int m, bool f32) {
  return has_gelu(m) && !(f32 && m == kGelu);
}
// f32 column vectors in shared memory: the epilogue's (ws, b), then the
// LayerNorm's (scale, bias)
__host__ __device__ constexpr int col_vectors(int m) {
  return (reads_acc(m) ? 2 : 0) + (has_ln(m) ? 2 : 0);
}

struct RowArgs {
  const void* a;            // x / h (bf16 or f32 rows), or the int32 accumulators
  const void* x2;           // add_ln_quant: y; ln_quant_acc, add_ln_quant_acc: the residual x
  const float* xs;          // accumulators: row scales (rows,)
  const float* ws;          // accumulators: column scales (W,), f32
  const void* b;            // accumulators: bias (W,) or NULL
  int q_cols;               // accumulators: ws and b of columns < q_cols times q_scale
  float q_scale;
  const void* ln_s;         // LayerNorm scale and bias (W,)
  const void* ln_b;
  int vec_bf16;             // bit 0: b, bit 1: ln_s, bit 2: ln_b are bf16 (else f32)
  void* resid;              // two inputs: the residual; qkv epilogue: its output (row type)
  int8_t* codes;            // (rows, W)
  float* scales;            // (rows,)
  float* absmax;            // split entries: (rows,), out of kAbsmax, into kCodes
};

__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// value i of 8 bf16 packed in a uint4, as f32
__device__ __forceinline__ float bf16_at(const uint4& q, int i) {
  const uint32_t w = word(q, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// two f32 rounded to bf16 by one conversion: lo in the low half
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// value i of a chunk of 8 row values: 8 bf16 in q[0], or 8 f32 in q[0..1]
template <bool kF32>
__device__ __forceinline__ float row_at(const uint4* q, int i) {
  if constexpr (kF32) return __uint_as_float(word(q[i >> 2], i & 3));
  return bf16_at(q[0], i);
}

// A column vector of W values (bf16 or f32; NULL: zeros) into shared
// memory as f32, 8 values per load, a thread's loads all issued before
// its stores (one L2 round trip, not one per value).
__device__ __forceinline__ void fill_vec(float* dst, const void* src, bool bf16, int W) {
  constexpr int kPer = kMaxWidth / kVec / kThreads;  // chunks per thread at most
  uint4 raw[kPer][2];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = (k * kThreads + threadIdx.x) * kVec;
    raw[k][0] = raw[k][1] = make_uint4(0u, 0u, 0u, 0u);
    if (j >= W || !src) continue;
    if (bf16) {
      raw[k][0] = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(src) + j));
    } else {
      const uint4* f = reinterpret_cast<const uint4*>(static_cast<const float*>(src) + j);
      raw[k][0] = __ldg(f);
      raw[k][1] = __ldg(f + 1);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = (k * kThreads + threadIdx.x) * kVec;
    if (j >= W) continue;
    float4 lo, hi;
    if (bf16) {
      lo = make_float4(bf16_at(raw[k][0], 0), bf16_at(raw[k][0], 1), bf16_at(raw[k][0], 2),
                       bf16_at(raw[k][0], 3));
      hi = make_float4(bf16_at(raw[k][0], 4), bf16_at(raw[k][0], 5), bf16_at(raw[k][0], 6),
                       bf16_at(raw[k][0], 7));
    } else {
      lo = *reinterpret_cast<const float4*>(&raw[k][0]);
      hi = *reinterpret_cast<const float4*>(&raw[k][1]);
    }
    reinterpret_cast<float4*>(dst + j)[0] = lo;
    reinterpret_cast<float4*>(dst + j)[1] = hi;
  }
}

// The first `cols` values of the column vectors at v and v + W times mult
// (one _rn multiply each), by the threads that filled them (fill_vec's
// layout), so no barrier comes between.
__device__ __forceinline__ void scale_cols(float* v, int W, int cols, float mult) {
  constexpr int kPer = kMaxWidth / kVec / kThreads;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = (k * kThreads + threadIdx.x) * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (j + i < cols) {
        v[j + i] = __fmul_rn(v[j + i], mult);
        v[W + j + i] = __fmul_rn(v[W + j + i], mult);
      }
  }
}

// 8 consecutive f32 of a shared-memory vector (two 16-byte loads)
__device__ __forceinline__ void smem8(const float* v, float out[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(v)[0];
  const float4 b = reinterpret_cast<const float4*>(v)[1];
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// GELU of bf16 values by table lookup: the values of exponent 2^-10 to
// 2^5 (both signs, 4096 entries) are tabled in shared memory by gelu_as
// itself, so a lookup gives gelu_as's bits; the others (zeros, tiny and
// large magnitudes) compute gelu_as.
constexpr uint32_t kGeluExpLo = 117, kGeluExps = 16;
constexpr int kGeluTable = 2 * kGeluExps * 128;

__device__ __forceinline__ float gelu_bf16(uint32_t bits, const float* table) {
  const uint32_t e = ((bits >> 7) & 0xffu) - kGeluExpLo;
  if (e < kGeluExps) return table[(bits >> 15 << 11) | (e << 7) | (bits & 0x7fu)];
  return ttasr::gelu_as(__uint_as_float(bits << 16));
}

__device__ __forceinline__ void fill_gelu_table(float* table) {
  for (int i = threadIdx.x; i < kGeluTable; i += blockDim.x) {
    const uint32_t bits = (i >> 11 << 15) | ((((i >> 7) & 15) + kGeluExpLo) << 7) | (i & 127);
    table[i] = ttasr::gelu_as(__uint_as_float(bits << 16));
  }
}

__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// rint(v / scale) with the IEEE quotient, given inv = 1/scale rounded.
// v * inv is within 2e-5 of v / scale (|v / scale| <= 127, two roundings
// of 2^-24 relative), so unless it lies within 1e-4 of a half-integer it
// rounds to the integer the rounded quotient does; those few take the
// true division.  The rounding of q itself is an add of 1.5 * 2^23, whose
// round-to-nearest-even leaves rint(q) in the low mantissa bits (|q| <
// 2^22): two adds where rintf and a conversion cost two conversions, which
// issue at a quarter of the add rate.
__device__ __forceinline__ uint32_t quant_code(float v, float scale, float inv) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  const float q = __fmul_rn(v, inv), t = __fadd_rn(q, kRound);
  int code = __float_as_int(t) - __float_as_int(kRound);
  if (!(__fsub_rn(0.5f, fabsf(__fsub_rn(q, __fsub_rn(t, kRound)))) > 1e-4f))
    code = __float2int_rn(__fdiv_rn(v, scale));
  return (uint8_t)(int8_t)code;
}

// Sum (or max, for non-negative values) over a team of G warps, the same
// value in every lane: shuffles, then the warps' partials in warp order.
// `part` alternates between two halves, so a third reduction never
// overwrites partials a slower warp has yet to read (the second one's
// barrier comes between).
template <bool kMax>
__device__ __forceinline__ float team_reduce(float v, float* part, int& half, int G, int team,
                                             int warp) {
  v = kMax ? ttasr::warp_max(v) : ttasr::warp_sum(v);
  if (G == 1) return v;
  float* p = part + half * kWarps + team * G;
  half ^= 1;
  if ((threadIdx.x & 31) == 0) p[warp - team * G] = v;
  team_sync(1 + team, 32 * G);
  float r = p[0];
  for (int i = 1; i < G; ++i) r = kMax ? fmaxf(r, p[i]) : __fadd_rn(r, p[i]);
  return r;
}

// One row's raw inputs in a lane's registers: 8 values per chunk, as 8 bf16
// (a[c][0]) or 8 int32 or f32 (a[c][0..1]), and the second input (b[c], bf16
// or, with kF32, f32 rows).
template <int M, bool kF32, int S>
struct RowRaw {
  static constexpr int kRowWords = kF32 ? 2 : 1;  // uint4 per chunk of a row input
  uint4 a[kChunks][reads_acc(M) ? 2 : kRowWords];
  uint4 b[kChunks][kRowWords];
  float xs;
  float amax;  // kCodes: the whole row's absmax

  // 8 row values at element e: one 16-byte load (bf16) or two (f32)
  __device__ __forceinline__ static void load_row(uint4* dst, const void* src, size_t e) {
    if constexpr (kF32) {
      const uint4* f = reinterpret_cast<const uint4*>(static_cast<const float*>(src) + e);
      dst[0] = __ldg(f);
      dst[kRowWords - 1] = __ldg(f + 1);
    } else {
      dst[0] = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(src) + e));
    }
  }

  // every load of row r issued at once
  __device__ __forceinline__ void load(const RowArgs& p, int r, int W, int t, int team_threads) {
    const size_t off = (size_t)r * W;
    if (reads_acc(M)) xs = p.xs[r];
    if (S == kCodes) amax = p.absmax[r];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * team_threads + t) * kVec;
      if (col >= W) continue;
      if (reads_acc(M)) {
        const uint4* src =
            reinterpret_cast<const uint4*>(static_cast<const int32_t*>(p.a) + off + col);
        a[c][0] = __ldg(src);
        a[c][reads_acc(M) ? 1 : 0] = __ldg(src + 1);
      } else {
        load_row(a[c], p.a, off + col);
      }
      if (two_inputs(M)) load_row(b[c], p.x2, off + col);
    }
  }
};

// 8 row-type values at element e of dst: v as 8 f32 (two 16-byte stores) or
// the 4 words of 8 bf16 already rounded (one)
template <bool kF32>
__device__ __forceinline__ void store_row(void* dst, size_t e, const float* v,
                                          const uint32_t* bf16_words) {
  if constexpr (kF32) {
    uint4* d = reinterpret_cast<uint4*>(static_cast<float*>(dst) + e);
    d[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
    d[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]), __float_as_uint(v[6]),
                      __float_as_uint(v[7]));
  } else {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(dst) + e) =
        make_uint4(bf16_words[0], bf16_words[1], bf16_words[2], bf16_words[3]);
  }
}

// kF32: the row inputs (x, h, y and the residual x) and the row outputs (the
// residual, the qkv epilogue's output) are f32, else bf16.  The producer
// runs in f32 either way; only the roundings to the row type drop out.
template <int M, bool kF32, int S>
__global__ void __launch_bounds__(kThreads, 2)
row_quant_kernel(const RowArgs p, int rows, int W, int G) {
  extern __shared__ float cols[];  // col_vectors(M) x W, then the GELU table
  __shared__ float part[2 * kWarps];
  const int warp = threadIdx.x >> 5, teams = kWarps / G, team = warp / G;
  const int t = threadIdx.x - team * G * 32, team_threads = 32 * G;
  const int stride = gridDim.x * teams;
  int r = blockIdx.x * teams + team;
  const bool live_team = team < teams;

  // the team's first row in flight while the block fills its column vectors
  RowRaw<M, kF32, S> raw;
  if (live_team && r < rows) raw.load(p, r, W, t, team_threads);
  constexpr int kLnCols = reads_acc(M) ? 2 : 0;
  if (reads_acc(M)) {
    fill_vec(cols, p.ws, false, W);
    fill_vec(cols + W, p.b, p.vec_bf16 & 1, W);
    if constexpr (M == kAccOut) scale_cols(cols, W, p.q_cols, p.q_scale);
  }
  if (has_ln(M)) {
    fill_vec(cols + kLnCols * W, p.ln_s, p.vec_bf16 & 2, W);
    fill_vec(cols + (kLnCols + 1) * W, p.ln_b, p.vec_bf16 & 4, W);
  }
  float* gelu_table = cols + col_vectors(M) * W;
  if (gelu_table_used(M, kF32)) fill_gelu_table(gelu_table);
  __syncthreads();
  if (!live_team) return;
  const float* ws = cols;
  const float* bias = cols + W;
  const float* ln_s = cols + kLnCols * W;
  const float* ln_b = cols + (kLnCols + 1) * W;
  const bool add_b = p.b != nullptr;
  const float inv_d = __fdiv_rn(1.f, (float)W);
  int half = 0;

  for (; r < rows; r += stride) {
    const size_t off = (size_t)r * W;
    // the producer's input in f32; the residual out (the qkv epilogue's
    // output kept until the next row's loads are issued)
    float v[kChunks][kVec];
    uint32_t out[M == kAccOut ? kChunks : 1][kF32 ? kVec : kVec / 2];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * team_threads + t) * kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[c][i] = 0.f;
      if (col >= W) continue;
      float w8[kVec], b8[kVec];
      if (reads_acc(M)) {
        smem8(ws + col, w8);
        smem8(bias + col, b8);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (reads_acc(M)) {
          const int32_t acc = (int32_t)word(raw.a[c][i >> 2], i & 3);
          v[c][i] = __fmul_rn(__fmul_rn(__int2float_rn(acc), raw.xs), w8[i]);
          if (add_b) v[c][i] = __fadd_rn(v[c][i], b8[i]);
        } else {
          v[c][i] = row_at<kF32>(raw.a[c], i);
          if (M == kAddLn) v[c][i] = __fadd_rn(v[c][i], row_at<kF32>(raw.b[c], i));
        }
      }
      // bf16 roundings two at a time: the GEMM's output (in the row type,
      // but always bf16 before GELU and before ln_quant_acc's add), then x'
      // (or the add_ln_quant residuals, whose LayerNorm reads the f32 sum)
      // in the row type; with f32 rows those to the row type drop out
      constexpr bool kRoundY = !kF32 || M == kAccGelu || M == kAccAddLn;
      uint32_t res[kVec / 2];
#pragma unroll
      for (int i = 0; i < kVec; i += 2) {
        uint32_t w = kF32 ? 0u : bf16x2_bits(v[c][i], v[c][i + 1]);
        if (reads_acc(M)) {
          if (kRoundY) {
            w = bf16x2_bits(v[c][i], v[c][i + 1]);
            v[c][i] = lo_f32(w), v[c][i + 1] = hi_f32(w);
          }
          if (M == kAccAddLn || M == kAccAddLnSum) {
            v[c][i] = __fadd_rn(row_at<kF32>(raw.b[c], i), v[c][i]);
            v[c][i + 1] = __fadd_rn(row_at<kF32>(raw.b[c], i + 1), v[c][i + 1]);
            if (!kF32) w = bf16x2_bits(v[c][i], v[c][i + 1]);
            if (M == kAccAddLn && !kF32) v[c][i] = lo_f32(w), v[c][i + 1] = hi_f32(w);
          }
        }
        res[i >> 1] = w;
      }
      if (two_inputs(M)) store_row<kF32>(p.resid, off + col, v[c], res);
      if constexpr (S == kAbsmax && M == kAccGelu) {  // h for the codes pass
        if (p.resid) store_row<false>(p.resid, off + col, nullptr, res);
      }
      if constexpr (M == kAccOut) {
        if constexpr (kF32) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) out[c][i] = __float_as_uint(v[c][i]);
        } else {
#pragma unroll
          for (int i = 0; i < kVec / 2; ++i) out[c][i] = res[i];
        }
      }
    }

    if constexpr (M == kAccOut) {
      if (r + stride < rows) raw.load(p, r + stride, W, t, team_threads);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = (c * team_threads + t) * kVec;
        if (col >= W) continue;
        if constexpr (kF32) {
          float vals[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) vals[i] = __uint_as_float(out[c][i]);
          store_row<true>(p.resid, off + col, vals, nullptr);
        } else {
          store_row<false>(p.resid, off + col, nullptr, out[c]);
        }
      }
      continue;
    }

    if (has_ln(M)) {
      // two-pass mean and biased variance, as _ln_rows (encoder_fused_pallas.py:84-88)
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int i = 0; i < kVec; ++i) s = __fadd_rn(s, v[c][i]);
      const float mean = __fmul_rn(team_reduce<false>(s, part, half, G, team, warp), inv_d);
      float q = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if ((c * team_threads + t) * kVec >= W) continue;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = __fsub_rn(v[c][i], mean);
          q = __fadd_rn(q, __fmul_rn(d, d));
        }
      }
      const float var = __fmul_rn(team_reduce<false>(q, part, half, G, team, warp), inv_d);
      const float rstd = __fdiv_rn(1.f, sqrtf(__fadd_rn(var, ttasr::kLnEps)));
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = (c * team_threads + t) * kVec;
        if (col >= W) continue;
        float s8[kVec], b8[kVec];
        smem8(ln_s + col, s8);
        smem8(ln_b + col, b8);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float n = __fmul_rn(__fsub_rn(v[c][i], mean), rstd);
          v[c][i] = __fadd_rn(__fmul_rn(n, s8[i]), b8[i]);
        }
      }
    } else if (has_gelu(M)) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int i = 0; i < kVec; ++i)  // GELU(0) = 0 for dead chunks
          v[c][i] = gelu_table_used(M, kF32)
                        ? gelu_bf16(__float_as_uint(v[c][i]) >> 16, gelu_table)
                        : ttasr::gelu_as(v[c][i]);  // f32 h: no table
    }

    float am = 0.f;
    if constexpr (S != kCodes) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if ((c * team_threads + t) * kVec >= W) continue;
#pragma unroll
        for (int i = 0; i < kVec; ++i) am = fmaxf(am, fabsf(v[c][i]));
      }
      am = team_reduce<true>(am, part, half, G, team, warp);
    } else {
      am = raw.amax;
    }
    if constexpr (S == kAbsmax) {
      if (r + stride < rows) raw.load(p, r + stride, W, t, team_threads);
      if (t == 0) p.absmax[r] = am;
      continue;
    }
    const float scale = __fmul_rn(fmaxf(am, 1e-8f), kInv127);
    const float inv = __frcp_rn(scale);
    // the next row's loads go out before this row's stores
    if (r + stride < rows) raw.load(p, r + stride, W, t, team_threads);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * team_threads + t) * kVec;
      if (col >= W) continue;
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        packed[i >> 2] |= quant_code(v[c][i], scale, inv) << (8 * (i & 3));
      *reinterpret_cast<uint2*>(p.codes + off + col) = make_uint2(packed[0], packed[1]);
    }
    if (t == 0) p.scales[r] = scale;
  }
}

template <int M, bool kF32, int S>
int launch_rows_as(const RowArgs& args, int rows, int W, void* stream) {
  if (W % kVec || W < kVec || W > kMaxWidth || rows < 1 || args.q_cols < 0 ||
      args.q_cols > W)
    return (int)cudaErrorInvalidValue;
  const int G = (W + kTeamWidth - 1) / kTeamWidth, teams = kWarps / G;
  const size_t smem =
      ((size_t)col_vectors(M) * W + (gelu_table_used(M, kF32) ? kGeluTable : 0)) * sizeof(float);
  static size_t smem_limit = 48 * 1024;
  cudaError_t err = ttasr::reserve_smem(row_quant_kernel<M, kF32, S>, smem, &smem_limit);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_quant_kernel<M, kF32, S>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min((rows + teams - 1) / teams, std::max(per_sm, 1) * sms);
  row_quant_kernel<M, kF32, S><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args, rows, W, G);
  return (int)cudaGetLastError();
}

// The instantiation for the row type: f32 rows or bf16 rows.
template <int M, int S = kWhole>
int launch_rows(const RowArgs& args, int rows, int W, bool f32, void* stream) {
  if (S != kWhole && !args.absmax) return (int)cudaErrorInvalidValue;
  if constexpr (M == kAccGelu) {  // no row input: its h is the GEMM's bf16 output
    if (f32) return (int)cudaErrorInvalidValue;
  } else {
    if (f32) return launch_rows_as<M, true, S>(args, rows, W, stream);
  }
  return launch_rows_as<M, false, S>(args, rows, W, stream);
}

}  // namespace

// Rows of W contiguous values (W a multiple of 8, at most 8192), 16-byte
// aligned: x, y and h bf16 rows (the entries named ..._f32: f32 rows), or
// int32 accumulators acc (rows, W) with f32 row scales xs (rows,), f32 column
// scales w_scale (W,) and bias b (W,) or NULL; ln_s/ln_b (W,); b, ln_s and
// ln_b bf16 where bits 0, 1 and 2 of vec_bf16 say so, else f32; codes int8
// (rows, W); scales f32 (rows,); resid (rows, W) of the rows' type.  Each
// launches on `stream` and returns cudaGetLastError().  Every entry but
// gelu_quant_acc (its GELU reads the bf16 GEMM output whatever x is) has an
// f32 twin of the same signature.
namespace {

int ln_quant_rows(const void* x, const void* ln_s, const void* ln_b, void* codes, void* scales,
                  int rows, int D, int vec_bf16, bool f32, void* stream) {
  RowArgs a = {};
  a.a = x;
  a.ln_s = ln_s;
  a.ln_b = ln_b;
  a.vec_bf16 = vec_bf16;
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  return launch_rows<kLn>(a, rows, D, f32, stream);
}

int add_ln_quant_rows(const void* x, const void* y, const void* ln_s, const void* ln_b,
                      void* resid, void* codes, void* scales, int rows, int D, int vec_bf16,
                      bool f32, void* stream) {
  RowArgs a = {};
  a.a = x;
  a.x2 = y;
  a.ln_s = ln_s;
  a.ln_b = ln_b;
  a.vec_bf16 = vec_bf16;
  a.resid = resid;
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  return launch_rows<kAddLn>(a, rows, D, f32, stream);
}

// gelu_quant (kGelu) and quant_only (kIdentity): one row input, codes out
template <int M>
int one_input_rows(const void* x, void* codes, void* scales, int rows, int W, bool f32,
                   void* stream) {
  RowArgs a = {};
  a.a = x;
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  return launch_rows<M>(a, rows, W, f32, stream);
}

// the operands of ln_quant_acc and add_ln_quant_acc
RowArgs acc_add_ln_args(const void* x, const void* acc, const void* xs, const void* w_scale,
                        const void* b, const void* ln_s, const void* ln_b, void* resid,
                        void* codes, void* scales, int vec_bf16) {
  RowArgs a = {};
  a.a = acc;
  a.x2 = x;
  a.xs = static_cast<const float*>(xs);
  a.ws = static_cast<const float*>(w_scale);
  a.b = b;
  a.ln_s = ln_s;
  a.ln_b = ln_b;
  a.vec_bf16 = vec_bf16;
  a.resid = resid;
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  return a;
}

int qkv_epilogue_rows(const void* acc, const void* xs, const void* w_scale, const void* b,
                      void* out, int rows, int W, int q_cols, float q_scale, int vec_bf16,
                      bool f32, void* stream) {
  RowArgs a = {};
  a.a = acc;
  a.xs = static_cast<const float*>(xs);
  a.ws = static_cast<const float*>(w_scale);
  a.b = b;
  a.q_cols = q_cols;
  a.q_scale = q_scale;
  a.vec_bf16 = vec_bf16;
  a.resid = out;
  return launch_rows<kAccOut>(a, rows, W, f32, stream);
}

}  // namespace

// B5, B8, B9, B7 on bf16 rows and, as ..._f32, on f32 rows
#define TTASR_ROW_ENTRY(name, impl, params, args)                            \
  extern "C" int ttasr_##name params { return impl(args, false, stream); } \
  extern "C" int ttasr_##name##_f32 params { return impl(args, true, stream); }
#define TTASR_ARGS(...) __VA_ARGS__

TTASR_ROW_ENTRY(ln_quant, ln_quant_rows,
                (const void* x, const void* ln_s, const void* ln_b, void* codes, void* scales,
                 int rows, int D, int vec_bf16, void* stream),
                TTASR_ARGS(x, ln_s, ln_b, codes, scales, rows, D, vec_bf16))
TTASR_ROW_ENTRY(add_ln_quant, add_ln_quant_rows,
                (const void* x, const void* y, const void* ln_s, const void* ln_b, void* resid,
                 void* codes, void* scales, int rows, int D, int vec_bf16, void* stream),
                TTASR_ARGS(x, y, ln_s, ln_b, resid, codes, scales, rows, D, vec_bf16))
TTASR_ROW_ENTRY(gelu_quant, one_input_rows<kGelu>,
                (const void* h, void* codes, void* scales, int rows, int F, void* stream),
                TTASR_ARGS(h, codes, scales, rows, F))
TTASR_ROW_ENTRY(quant_only, one_input_rows<kIdentity>,
                (const void* x, void* codes, void* scales, int rows, int D, void* stream),
                TTASR_ARGS(x, codes, scales, rows, D))

// B9 from W1's accumulators: no row input, so no f32 twin
extern "C" int ttasr_gelu_quant_acc(const void* acc, const void* xs, const void* w_scale,
                                    const void* b, void* codes, void* scales, int rows, int F,
                                    int vec_bf16, void* stream) {
  RowArgs a = {};
  a.a = acc;
  a.xs = static_cast<const float*>(xs);
  a.ws = static_cast<const float*>(w_scale);
  a.b = b;
  a.vec_bf16 = vec_bf16;
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  return launch_rows<kAccGelu>(a, rows, F, false, stream);
}

namespace {

template <int M>
int acc_add_ln_rows(const void* x, const void* acc, const void* xs, const void* w_scale,
                    const void* b, const void* ln_s, const void* ln_b, void* resid, void* codes,
                    void* scales, int rows, int D, int vec_bf16, bool f32, void* stream) {
  return launch_rows<M>(
      acc_add_ln_args(x, acc, xs, w_scale, b, ln_s, ln_b, resid, codes, scales, vec_bf16), rows,
      D, f32, stream);
}

}  // namespace

// B5 after W2 (x' = x + y, LN of x') and B8 after wo (LN of the f32 sum)
TTASR_ROW_ENTRY(ln_quant_acc, acc_add_ln_rows<kAccAddLn>,
                (const void* x, const void* acc, const void* xs, const void* w_scale,
                 const void* b, const void* ln_s, const void* ln_b, void* resid, void* codes,
                 void* scales, int rows, int D, int vec_bf16, void* stream),
                TTASR_ARGS(x, acc, xs, w_scale, b, ln_s, ln_b, resid, codes, scales, rows, D,
                           vec_bf16))
TTASR_ROW_ENTRY(add_ln_quant_acc, acc_add_ln_rows<kAccAddLnSum>,
                (const void* x, const void* acc, const void* xs, const void* w_scale,
                 const void* b, const void* ln_s, const void* ln_b, void* resid, void* codes,
                 void* scales, int rows, int D, int vec_bf16, void* stream),
                TTASR_ARGS(x, acc, xs, w_scale, b, ln_s, ln_b, resid, codes, scales, rows, D,
                           vec_bf16))

// The qkv epilogue: out (rows, W) bf16 (..._f32: f32); the first q_cols
// columns of w_scale and b are multiplied by q_scale.
TTASR_ROW_ENTRY(qkv_epilogue_acc, qkv_epilogue_rows,
                (const void* acc, const void* xs, const void* w_scale, const void* b, void* out,
                 int rows, int W, int q_cols, float q_scale, int vec_bf16, void* stream),
                TTASR_ARGS(acc, xs, w_scale, b, out, rows, W, q_cols, q_scale, vec_bf16))

// The split entries.  absmax (rows,) f32: written by the absmax passes,
// read by the codes passes (the MAX over the model axis of every rank's).
namespace {

// B7: the absmax of x's columns (kIdentity, kAbsmax), or x's codes and row
// scales at the given absmax (kCodes)
template <int S>
int quant_only_split_rows(const void* x, void* absmax, void* codes, void* scales, int rows,
                          int W, bool f32, void* stream) {
  RowArgs a = {};
  a.a = x;
  a.absmax = static_cast<float*>(absmax);
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  return launch_rows<kIdentity, S>(a, rows, W, f32, stream);
}

}  // namespace

TTASR_ROW_ENTRY(quant_only_absmax, quant_only_split_rows<kAbsmax>,
                (const void* x, void* absmax, int rows, int D, void* stream),
                TTASR_ARGS(x, absmax, nullptr, nullptr, rows, D))
TTASR_ROW_ENTRY(quant_only_scaled, quant_only_split_rows<kCodes>,
                (const void* x, const void* absmax, void* codes, void* scales, int rows, int D,
                 void* stream),
                TTASR_ARGS(x, const_cast<void*>(absmax), codes, scales, rows, D))

// B9 from W1's accumulators of the rank's columns: the absmax of GELU(h) and,
// where h is not NULL, h (rows, F) bf16 for ttasr_gelu_quant_scaled
extern "C" int ttasr_gelu_quant_acc_absmax(const void* acc, const void* xs, const void* w_scale,
                                           const void* b, void* h, void* absmax, int rows, int F,
                                           int vec_bf16, void* stream) {
  RowArgs a = {};
  a.a = acc;
  a.xs = static_cast<const float*>(xs);
  a.ws = static_cast<const float*>(w_scale);
  a.b = b;
  a.vec_bf16 = vec_bf16;
  a.resid = h;
  a.absmax = static_cast<float*>(absmax);
  return launch_rows<kAccGelu, kAbsmax>(a, rows, F, false, stream);
}

// B9's codes pass from the stored bf16 h: codes and row scales of GELU(h)
// at the given absmax
extern "C" int ttasr_gelu_quant_scaled(const void* h, const void* absmax, void* codes,
                                       void* scales, int rows, int F, void* stream) {
  RowArgs a = {};
  a.a = h;
  a.absmax = static_cast<float*>(const_cast<void*>(absmax));
  a.codes = static_cast<int8_t*>(codes);
  a.scales = static_cast<float*>(scales);
  return launch_rows<kGelu, kCodes>(a, rows, F, false, stream);
}

#undef TTASR_ROW_ENTRY
#undef TTASR_ARGS
