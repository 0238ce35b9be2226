// Beam-reorder gather of the flat int8/int4 self-KV cache, for Hopper
// (sm_90a): B17.
//
// Replaces ttasr/ops/beam_gather_pallas.py::gather_cache_rows (:23):
//   out[l, i] = in[l, idx[i]]  for k, v (L, BK, T, D or D/2) codes and
//                              ks, vs (L, BK, HP, T) f32 scales.
// Beam search without the ancestry map (DecodingOptions(beam_indirect=
// False), decode.py:1156) calls it once per step after the top-k, on all
// layers at once.
//
// What bounds it on this card: it is a permuted copy -- no arithmetic --
// so it is bound by the bytes, each read once and written once (at
// large-v3, beam 5, T = 480, int4: ~113 MB each way, ~0.068 ms at 3.35
// TB/s).  The design: the copy is out of place (the caller passes a second
// set of buffers and swaps them each step), since out[l, i] = in[l, idx[i]]
// cannot be done in place.  One launch moves all four tensors: the grid is
// (chunks, destination row, layer), each block copies its chunk of the
// row's (T, D) code slab of k and v and of the (HP, T) scale slab of ks and
// vs, with 16-byte loads and stores, four in flight per thread, consecutive
// threads on consecutive 16-byte words.  The TPU kernel's scalar-prefetched
// index maps become one index read per block.  The result equals
// index_select byte for byte.
//
// Built by ttasr_torch/ops/_build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a) and called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 32 * 1024;  // code bytes per block

// copy part `c` of `chunks` of an n-word slab
__device__ __forceinline__ void copy_part(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                          long long n, int c, int chunks) {
  const long long per = (n + chunks - 1) / chunks;
  const long long hi = min(n, (c + 1) * per);
  long long u = c * per + threadIdx.x;
  for (; u + 3 * kThreads < hi; u += 4 * kThreads) {
    const uint4 a = __ldg(src + u), b = __ldg(src + u + kThreads);
    const uint4 e = __ldg(src + u + 2 * kThreads), f = __ldg(src + u + 3 * kThreads);
    dst[u] = a;
    dst[u + kThreads] = b;
    dst[u + 2 * kThreads] = e;
    dst[u + 3 * kThreads] = f;
  }
  for (; u < hi; u += kThreads) dst[u] = __ldg(src + u);
}

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const uint4* __restrict__ k, const uint4* __restrict__ v, const uint4* __restrict__ ks,
    const uint4* __restrict__ vs, const int* __restrict__ idx, uint4* __restrict__ ok,
    uint4* __restrict__ ov, uint4* __restrict__ oks, uint4* __restrict__ ovs, int BK,
    long long kv_words, long long sc_words) {
  const int c = blockIdx.x, i = blockIdx.y, l = blockIdx.z, chunks = gridDim.x;
  const int src = idx[i];
  if (src < 0 || src >= BK) __trap();  // a bad index is a caller's fault, never a silent copy
  const size_t s_row = (size_t)l * BK + src, d_row = (size_t)l * BK + i;
  copy_part(k + s_row * kv_words, ok + d_row * kv_words, kv_words, c, chunks);
  copy_part(v + s_row * kv_words, ov + d_row * kv_words, kv_words, c, chunks);
  copy_part(ks + s_row * sc_words, oks + d_row * sc_words, sc_words, c, chunks);
  copy_part(vs + s_row * sc_words, ovs + d_row * sc_words, sc_words, c, chunks);
}

}  // namespace

// k/v (L, BK, kv_row_bytes) and ks/vs (L, BK, sc_row_bytes), the outputs
// alike; idx (BK,) int32 source rows.  Row sizes and pointers must be
// multiples of 16 bytes.
extern "C" int ttasr_gather_cache_rows(const void* k, const void* v, const void* ks,
                                       const void* vs, const void* idx, void* ok, void* ov,
                                       void* oks, void* ovs, int L, int BK, int kv_row_bytes,
                                       int sc_row_bytes, void* stream) {
  if (L < 1 || BK < 1 || kv_row_bytes < 16 || sc_row_bytes < 16 || kv_row_bytes % 16 ||
      sc_row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {k, v, ks, vs, (const void*)ok, (const void*)ov, (const void*)oks,
                        (const void*)ovs})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  const int chunks = (int)((kv_row_bytes + kChunkBytes - 1) / kChunkBytes);
  gather_rows_kernel<<<dim3(chunks, BK, L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v), static_cast<const uint4*>(ks),
      static_cast<const uint4*>(vs), static_cast<const int*>(idx), static_cast<uint4*>(ok),
      static_cast<uint4*>(ov), static_cast<uint4*>(oks), static_cast<uint4*>(ovs), BK,
      kv_row_bytes / 16, sc_row_bytes / 16);
  return (int)cudaGetLastError();
}
