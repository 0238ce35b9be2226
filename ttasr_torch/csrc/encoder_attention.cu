// Whisper encoder self-attention for Hopper (sm_90a).
//
// Replaces three TPU kernels of ttasr/ops/encoder_attention_pallas.py:
//   * encoder_attention_merged (B11, model.py:208/:290, 32 times per 30 s
//     window): q/k/v are three (B, T, D) tensors, q pre-scaled;
//   * encoder_attention_merged_qkv (B6, model.py:270, the s8 x s8 encoder,
//     32 times per window): q, K and V are the column blocks 0:D, D:2D and
//     2D:3D of one (B, T, 3D) buffer, the int8 GEMM's output, read in place
//     through three tensor maps over the one buffer;
//   * encoder_self_attention (B19, :23, the head-split kernel; no caller in
//     the engine): q/k/v (B, T, H, 64) in float32 or bf16, q/k/v rounded
//     to bf16, the scores scaled by 64^-0.5, the output rounded to bf16 and
//     written in the input type.  64^-0.5 = 2^-3 commutes with rounding
//     (round_bf16(q 2^-3) = round_bf16(q) 2^-3, and the f32 dot products
//     scale exactly), so the TPU kernel's scaling of q becomes the kernel's
//     score scale.  float32 inputs are first rounded to bf16 into scratch
//     the wrapper allocates.  A contiguous (B, T, H, 64) is the merged
//     (B, T, 64 H) layout, so unlike the TPU kernel it needs no transpose
//     and no padding of T.
// All three run the wgmma kernel of encoder_attention.cuh (what bounds it
// and its design are described there).  The TPU kernels' head-pair trick
// (two heads block-diagonal in one 128-lane tile) exists only for the
// TPU's lane width and is not carried over.
//
// float32 inputs of B11 (and B6) take a SIMT kernel templated on the
// element type (exact f32 products; the tensor cores would round to
// TF32).  It is the reference-precision path, not the main path.
//
// Tensor maps are encoded on the host for every call (cuTensorMapEncodeTiled,
// fetched once through cudaGetDriverEntryPoint, so nothing links libcuda)
// and passed to the kernel by value: a CUDA graph that captures a launch
// keeps that launch's pointers.
//
// Built by ttasr_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "encoder_attention.cuh"

namespace {

using ttasr_enc::kDh;

// ---------------------------------------------------------------------------
// SIMT path (float32): one thread per query row, K/V tiles of 32 keys in
// shared memory read as broadcasts.
// ---------------------------------------------------------------------------

constexpr int kSimtRows = 64;  // query rows (= threads) per block
constexpr int kSimtKeys = 32;  // keys per tile

template <typename T>
__global__ void __launch_bounds__(kSimtRows)
encoder_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              int T_len, int ld, int D, int t_real) {
  __shared__ __align__(16) float k_s[kSimtKeys][kDh];
  __shared__ __align__(16) float v_s[kSimtKeys][kDh];

  const int row = blockIdx.x * kSimtRows + threadIdx.x;
  const size_t base = (size_t)blockIdx.z * T_len * ld + (size_t)blockIdx.y * kDh;
  const size_t obase = (size_t)blockIdx.z * T_len * D + (size_t)blockIdx.y * kDh;
  const bool live = row < T_len;

  float qr[kDh], acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = live ? static_cast<float>(q[base + (size_t)row * ld + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < t_real; k0 += kSimtKeys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtKeys * kDh; i += kSimtRows) {
      const int r = i / kDh, d = i % kDh;
      const bool ok = k0 + r < t_real;
      k_s[r][d] = ok ? static_cast<float>(k[base + (size_t)(k0 + r) * ld + d]) : 0.f;
      v_s[r][d] = ok ? static_cast<float>(v[base + (size_t)(k0 + r) * ld + d]) : 0.f;
    }
    __syncthreads();

    float s[kSimtKeys];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSimtKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&k_s[j][d]);
        dot = fmaf(qr[d], kv.x, dot);
        dot = fmaf(qr[d + 1], kv.y, dot);
        dot = fmaf(qr[d + 2], kv.z, dot);
        dot = fmaf(qr[d + 3], kv.w, dot);
      }
      s[j] = (k0 + j < t_real) ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float mn = fmaxf(m, tmax);
    const float corr = expf(m - mn);
    m = mn;
    l *= corr;
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kSimtKeys; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < kDh; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }
  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kDh; ++d) out[obase + (size_t)row * D + d] = static_cast<T>(acc[d] * inv);
  }
}

// ---------------------------------------------------------------------------
// The wgmma kernel's launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// One head's 64 columns of bf16 rows `ld` elements apart, as a (D, T, B)
// tensor with 64 x 128 x 1 boxes and the 128-B swizzle; rows past T read
// as zeros.
bool make_map(CUtensorMap* map, const void* base, int B, int T, int ld, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)T * ld * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kDh, (cuuint32_t)ttasr_enc::kBlockK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 q/k/v rows `ld` elements apart; out (B, T, D) contiguous; scores
// times `scale`.
template <typename Out>
int launch_wgmma(const void* q, const void* k, const void* v, Out* out, int B, int T, int ld,
                 int D, int t_real, float scale, cudaStream_t st) {
  CUtensorMap maps[3];
  if (!make_map(&maps[0], q, B, T, ld, D) || !make_map(&maps[1], k, B, T, ld, D) ||
      !make_map(&maps[2], v, B, T, ld, D))
    return (int)cudaErrorInvalidValue;
  static int n_sms[64] = {};  // per device: the attribute is per context
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = dev < 64 ? n_sms[dev] : 0;
  if (sms == 0) {
    err = cudaFuncSetAttribute(ttasr_enc::attention_wgmma_kernel<Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ttasr_enc::kSmemBytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) n_sms[dev] = sms;
  }
  // one block per SM (384 threads at 168 registers fill its register file)
  const long items = (long)((T + ttasr_enc::kBlockQ - 1) / ttasr_enc::kBlockQ) * (D / kDh) * B;
  const int grid = (int)(items < sms ? items : sms);
  ttasr_enc::attention_wgmma_kernel<Out><<<grid, ttasr_enc::kThreads, ttasr_enc::kSmemBytes, st>>>(
      maps[0], maps[1], maps[2], out, B, T, D, t_real, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// B19's float32 inputs rounded to bf16: blockIdx.y picks q, k or v; n
// elements each (a multiple of 4), written to dst + blockIdx.y * n.
__global__ void round_to_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, __nv_bfloat16* __restrict__ dst,
                                     size_t n) {
  const float4* src = reinterpret_cast<const float4*>(blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v);
  uint2* out = reinterpret_cast<uint2*>(dst + blockIdx.y * n);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 x = src[i];
    out[i] = make_uint2(ttasr_enc::pack_bf16x2(x.x, x.y), ttasr_enc::pack_bf16x2(x.z, x.w));
  }
}

// q/k/v rows `ld` elements apart (D for three tensors, 3D for the fused
// buffer); out (B, T, D) contiguous.
int launch_attention(const void* q, const void* k, const void* v, void* out, int B, int T,
                     int ld, int D, int t_real, int dtype, cudaStream_t st) {
  const int heads = D / kDh;
  if (dtype == 1) {
    return launch_wgmma(q, k, v, static_cast<__nv_bfloat16*>(out), B, T, ld, D, t_real, 1.f, st);
  } else if (dtype == 0) {
    const dim3 grid((T + kSimtRows - 1) / kSimtRows, heads, B);
    encoder_attention_simt_kernel<float><<<grid, kSimtRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), T, ld, D, t_real);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous with D = 64 *
// heads; pointers 16-byte aligned (the wrappers check both).  Each launches
// on `stream` and returns cudaGetLastError() (0 = launched).

// B11: q/k/v (B, T, D).
extern "C" int ttasr_encoder_attention(const void* q, const void* k, const void* v,
                                       void* out, int B, int T, int D, int t_real,
                                       int dtype, void* stream) {
  return launch_attention(q, k, v, out, B, T, D, D, t_real, dtype,
                          static_cast<cudaStream_t>(stream));
}

// B6: qkv (B, T, 3D), q/K/V at column offsets 0, D, 2D.
extern "C" int ttasr_encoder_attention_qkv(const void* qkv, void* out, int B, int T, int D,
                                           int t_real, int dtype, void* stream) {
  const size_t elem = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* base = static_cast<const char*>(qkv);
  return launch_attention(base, base + D * elem, base + 2 * D * elem, out, B, T, 3 * D, D,
                          t_real, dtype, static_cast<cudaStream_t>(stream));
}

// B19: q/k/v (B, T, H, 64) contiguous, D = 64 H; out likewise, in q's type.
// float32 inputs are rounded into `scratch` (3 B T D bf16; unused for bf16).
extern "C" int ttasr_encoder_self_attention(const void* q, const void* k, const void* v,
                                            void* scratch, void* out, int B, int T, int D,
                                            int dtype, void* stream) {
  const float scale = 0.125f;  // 64^-0.5, exact
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_wgmma(q, k, v, static_cast<__nv_bfloat16*>(out), B, T, D, D, T, scale, st);
  }
  if (dtype == 0) {
    const size_t n = (size_t)B * T * D;
    const size_t want = (n / 4 + 255) / 256;
    const unsigned blocks = (unsigned)(want < 1024 ? want : 1024);
    __nv_bfloat16* bf = static_cast<__nv_bfloat16*>(scratch);
    round_to_bf16_kernel<<<dim3(blocks, 3), 256, 0, st>>>(static_cast<const float*>(q),
                                                          static_cast<const float*>(k),
                                                          static_cast<const float*>(v), bf, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_wgmma(bf, bf + n, bf + 2 * n, static_cast<float*>(out), B, T, D, D, T, scale,
                        st);
  }
  return (int)cudaErrorInvalidValue;
}
