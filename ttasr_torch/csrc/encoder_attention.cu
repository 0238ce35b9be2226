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
// float32 inputs of B11 and B6 (the fine-tuning evaluation's encoder, and
// any f32 caller) keep f32 accuracy on the tensor cores: a pre-pass splits
// q, K and V into tf32 hi and lo planes (V transposed, its keys permuted
// within groups of 8) in scratch the wrapper allocates, and the wgmma
// kernel runs on them with 3xTF32 tiles (Tf32Tiles).
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

// A 3-D tensor map (dims[0] contiguous, strides of dims 1 and 2 in bytes)
// with the 128-B swizzle; boxes past the dims read as zeros.
bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                 const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
                 const cuuint32_t (&box)[3]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One head's 64 columns of bf16 rows `ld` elements apart, as a (D, T, B)
// tensor with 64 x 128 x 1 boxes; rows past T read as zeros.
bool make_map(CUtensorMap* map, const void* base, int B, int T, int ld, int D) {
  return make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                     {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B},
                     {(cuuint64_t)ld * 2, (cuuint64_t)T * ld * 2},
                     {(cuuint32_t)kDh, (cuuint32_t)ttasr_enc::kBlockK, 1});
}

// The SM count of the current device, after raising `kernel`'s dynamic
// shared memory limit to `smem` on first use on the device (the attribute
// is per context; `cache` is the caller's, one per kernel); 0 on failure,
// with the error in *err.
int sm_count(const void* kernel, int smem, int (&cache)[64], cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  int sms = dev < 64 ? cache[dev] : 0;
  if (sms == 0) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    if (dev < 64) cache[dev] = sms;
  }
  return sms;
}

// attention_wgmma_kernel<Tiles> over `maps`, one block per SM (384 threads
// at 168 registers fill its register file); scores times `scale`.
template <typename Tiles>
int launch_persistent(const CUtensorMap (&maps)[3], typename Tiles::Out* out, int B, int T, int D,
                      int t_real, float scale, cudaStream_t st) {
  constexpr int smem = ttasr_enc::smem_bytes<Tiles>();
  static int n_sms[64] = {};  // per instantiation
  cudaError_t err;
  const int sms = sm_count(reinterpret_cast<const void*>(ttasr_enc::attention_wgmma_kernel<Tiles>),
                           smem, n_sms, &err);
  if (sms == 0) return (int)err;
  const long items = (long)((T + ttasr_enc::kBlockQ - 1) / ttasr_enc::kBlockQ) * (D / kDh) * B;
  const int grid = (int)(items < sms ? items : sms);
  ttasr_enc::attention_wgmma_kernel<Tiles><<<grid, ttasr_enc::kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], out, B, T, D, t_real, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
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
  return launch_persistent<ttasr_enc::Bf16Tiles<Out>>(maps, out, B, T, D, t_real, scale, st);
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

// The 3xTF32 pre-pass: block (x, h, b) takes keys/rows 64 x .. 64 x + 63 of
// head h of batch row b.  q and K (rows `ld` elements apart) go to their
// (B, T, D) hi and lo planes element for element; V goes through shared
// memory to its (B H, 64, t_pad) planes, transposed, each group of 8 keys
// in the order 0 2 4 6 1 3 5 7 (encoder_attention.cuh), zeros past T.
// planes: q hi, q lo, K hi, K lo (B T D each), V^T hi, V^T lo (B D t_pad
// each).
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ planes, int T, int ld, int D,
                  int t_pad) {
  __shared__ float vs[ttasr_enc::kKeysF32][kDh + 1];
  const int t0 = blockIdx.x * ttasr_enc::kKeysF32, head = blockIdx.y, batch = blockIdx.z;
  const int heads = gridDim.y;
  const size_t n = (size_t)gridDim.z * T * D;
  for (int i = threadIdx.x; i < ttasr_enc::kKeysF32 * kDh / 4; i += blockDim.x) {
    const int r = i / (kDh / 4), c = head * kDh + 4 * (i % (kDh / 4)), row = t0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < T) {
      const size_t src = ((size_t)batch * T + row) * ld + c;
      const size_t dst = ((size_t)batch * T + row) * D + c;
      const float4* pair[2] = {reinterpret_cast<const float4*>(q + src),
                               reinterpret_cast<const float4*>(k + src)};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float4 y = *pair[m];
        uint4 hi, lo;
        ttasr_enc::split_tf32(y.x, hi.x, lo.x);
        ttasr_enc::split_tf32(y.y, hi.y, lo.y);
        ttasr_enc::split_tf32(y.z, hi.z, lo.z);
        ttasr_enc::split_tf32(y.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(planes + 2 * m * n + dst) = hi;
        *reinterpret_cast<uint4*>(planes + (2 * m + 1) * n + dst) = lo;
      }
      x = *reinterpret_cast<const float4*>(v + src);
    }
    const int cc = c - head * kDh;
    vs[r][cc] = x.x;
    vs[r][cc + 1] = x.y;
    vs[r][cc + 2] = x.z;
    vs[r][cc + 3] = x.w;
  }
  __syncthreads();
  float* vh = planes + 4 * n;
  float* vl = vh + (size_t)gridDim.z * D * t_pad;
  const size_t row0 = ((size_t)batch * heads + head) * kDh;
  for (int i = threadIdx.x; i < kDh * ttasr_enc::kKeysF32; i += blockDim.x) {
    const int d = i / ttasr_enc::kKeysF32, p = i % ttasr_enc::kKeysF32;
    const int j = p & 7, key = (p & ~7) | (j < 4 ? 2 * j : 2 * (j - 4) + 1);
    uint32_t hi, lo;
    ttasr_enc::split_tf32(vs[key][d], hi, lo);
    const size_t at = (row0 + d) * t_pad + t0 + p;
    vh[at] = __uint_as_float(hi);
    vl[at] = __uint_as_float(lo);
  }
}

// float32 q/k/v rows `ld` elements apart; out (B, T, D) contiguous; scratch
// as split_tf32_kernel's planes.
int launch_tf32(const float* q, const float* k, const float* v, float* scratch, float* out,
                int B, int T, int ld, int D, int t_real, cudaStream_t st) {
  using namespace ttasr_enc;
  const int heads = D / kDh;
  const int t_pad = (T + kKeysF32 - 1) / kKeysF32 * kKeysF32;
  split_tf32_kernel<<<dim3(t_pad / kKeysF32, heads, B), 256, 0, st>>>(q, k, v, scratch, T, ld, D,
                                                                      t_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * T * D;
  CUtensorMap maps[3];
  const cuuint64_t qk_dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)(2 * B)};
  const cuuint64_t qk_strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)T * D * 4};
  const cuuint64_t v_dims[3] = {(cuuint64_t)t_pad, (cuuint64_t)kDh, (cuuint64_t)(2 * B * heads)};
  const cuuint64_t v_strides[2] = {(cuuint64_t)t_pad * 4, (cuuint64_t)kDh * t_pad * 4};
  if (!make_map_3d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scratch, qk_dims, qk_strides,
                   {(cuuint32_t)kAtomF32, (cuuint32_t)kBlockQ, 1}) ||
      !make_map_3d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scratch + 2 * n, qk_dims,
                   qk_strides, {(cuuint32_t)kAtomF32, (cuuint32_t)kKeysF32, 1}) ||
      !make_map_3d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scratch + 4 * n, v_dims, v_strides,
                   {(cuuint32_t)kAtomF32, (cuuint32_t)kDh, 1}))
    return (int)cudaErrorInvalidValue;
  return launch_persistent<Tf32Tiles>(maps, out, B, T, D, t_real, 1.f, st);
}

// q/k/v rows `ld` elements apart (D for three tensors, 3D for the fused
// buffer); out (B, T, D) contiguous; scratch for float32 only.
int launch_attention(const void* q, const void* k, const void* v, void* scratch, void* out,
                     int B, int T, int ld, int D, int t_real, int dtype, cudaStream_t st) {
  if (dtype == 1)
    return launch_wgmma(q, k, v, static_cast<__nv_bfloat16*>(out), B, T, ld, D, t_real, 1.f, st);
  if (dtype == 0)
    return launch_tf32(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(scratch),
                       static_cast<float*>(out), B, T, ld, D, t_real, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous with D = 64 *
// heads; pointers 16-byte aligned (the wrappers check both).  float32
// takes `scratch`: 4 B T D + 2 B D t_pad floats, t_pad = T rounded up to
// 64 (unused for bf16).  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).

// B11: q/k/v (B, T, D).
extern "C" int ttasr_encoder_attention(const void* q, const void* k, const void* v,
                                       void* scratch, void* out, int B, int T, int D,
                                       int t_real, int dtype, void* stream) {
  return launch_attention(q, k, v, scratch, out, B, T, D, D, t_real, dtype,
                          static_cast<cudaStream_t>(stream));
}

// B6: qkv (B, T, 3D), q/K/V at column offsets 0, D, 2D.
extern "C" int ttasr_encoder_attention_qkv(const void* qkv, void* scratch, void* out, int B,
                                           int T, int D, int t_real, int dtype, void* stream) {
  const size_t elem = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* base = static_cast<const char*>(qkv);
  return launch_attention(base, base + D * elem, base + 2 * D * elem, scratch, out, B, T,
                          3 * D, D, t_real, dtype, static_cast<cudaStream_t>(stream));
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
