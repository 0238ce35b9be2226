// Whisper log-mel spectrogram for Hopper (sm_90a): B18.
//
// Replaces ttasr/ops/mel_pallas.py::log_mel_spectrogram_pallas (:114, body
// _mel_kernel :83): per 30 s window, framing (hop 160, n_fft 400, the
// signal reflect-padded by 200), the Hann-windowed 201-bin real DFT, the
// power, the (201, n_mels) Slaney mel projection and log10(max(mel,
// 1e-10)), frames and power spectra kept out of device memory.  The
// per-window max - 8 clamp and (x + 4) / 4 stay outside the kernel, as in
// the TPU version (:178-180).
//
// What bounds the function: a real FFT of each frame and the Slaney bank's
// ~400 nonzeros need ~11k FLOP per frame (~1.5 GFLOP for 48 windows at 128
// mels, ~0.023 ms at the float32 peak of 67 TFLOP/s), against 1.9 MB of
// audio in and 1.5 MB out per window (~0.05 ms for 48 at 3.35 TB/s): it is
// bound by bytes.  This design does not reach that bound.  It computes the
// DFT densely, 3000 x 400 x 201 x 2 x 2 FLOP per window, and the projection
// over the whole bank, 3000 x 201 x n_mels x 2 (~1.1 GFLOP per window at 128
// mels, ~35x the FFT's count), in float32 FMA (TF32 would keep about three
// digits against a 2e-4 contract), so it is bound by FMA issue; an in-kernel
// FFT and a sparse projection are what would take it to the byte bound.
// Within the dense design the FMA units are fed from registers:
//   * one block of 8 warps per 64 frames of one window stages those frames'
//     10480 samples in shared memory once (pad to 480000 and cut, and the
//     reflect padding, done by index: no padded copy of the audio);
//   * the DFT is a register-tiled SIMT product: a warp owns 8 frames, a
//     lane 7 frequencies (l, l + 32, ..., 201 padded to 224), so each
//     thread keeps 8 x 7 (re, im) sums and does 112 FMA per sample row
//     for 8 broadcast sample reads and 7 basis reads;
//   * the (400, 224) interleaved (cos, sin) basis, window folded in, is
//     read from L2 in chunks of 16 rows into a double buffer in shared
//     memory with cp.async, the next chunk in flight while this one is
//     used;
//   * the power goes to shared memory (over the basis buffers), and the
//     projection runs with a lane per mel, the filterbank read through L1;
//     the log10 is written in frame order, so no gather follows.
// The TPU kernel's four pre-shifted (1280, 256) bases and frame % 4
// grouping exist only because Mosaic cannot slice at unaligned offsets;
// a block here reads a frame at any offset, so neither is carried over.
//
// Built by ttasr_torch/ops/_build.py and called through ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNSamples = 480000;  // 30 s at 16 kHz
constexpr int kNFrames = 3000;
constexpr int kHop = 160;
constexpr int kNFft = 400;
constexpr int kHalf = kNFft / 2;
constexpr int kNFreqs = 201;
constexpr int kFreqPad = 224;  // 7 per lane
constexpr int kFreqSlots = kFreqPad / 32;
constexpr int kFrames = 64;  // frames per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFramesPerWarp = kFrames / kWarps;  // 8
constexpr int kSpan = (kFrames - 1) * kHop + kNFft;  // 10480 samples
constexpr int kChunk = 16;  // basis rows per shared-memory chunk
constexpr int kChunks = kNFft / kChunk;  // 25
constexpr int kPowLd = kFrames + 1;  // power rows, padded: no bank conflicts
constexpr size_t kBasisBytes = 2 * kChunk * kFreqPad * sizeof(float2);
constexpr size_t kPowBytes = kNFreqs * kPowLd * sizeof(float);
constexpr size_t kSmemBytes =
    kSpan * sizeof(float) + (kBasisBytes > kPowBytes ? kBasisBytes : kPowBytes);

static_assert(kNFft % kChunk == 0, "chunks tile the frame");
static_assert(kChunk % 4 == 0, "samples are read four at a time");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Chunk c of the basis (rows 16 c .. 16 c + 15, 224 float2 each) into dst.
__device__ __forceinline__ void load_basis_chunk(float2* dst, const float2* basis, int c) {
  const float2* src = basis + (size_t)c * kChunk * kFreqPad;
  constexpr int kVec = kChunk * kFreqPad / 2;  // 16-byte pieces
  for (int i = threadIdx.x; i < kVec; i += kThreads) cp_async16(dst + 2 * i, src + 2 * i);
  cp_async_commit();
}

// One block: frames [64 blockIdx.x, +64) of window blockIdx.y.
// x (B, n) float32; basis (400, 224) float2 (cos, sin) with the window
// folded in, zero past bin 200; fb (201, n_mels); out (B, n_mels, 3000).
template <int kMelSlots>
__global__ void __launch_bounds__(kThreads, 1)
log_mel_kernel(const float* __restrict__ x, const float2* __restrict__ basis,
               const float* __restrict__ fb, float* __restrict__ out, int n, int n_mels) {
  extern __shared__ __align__(16) unsigned char mel_smem[];
  float* samp = reinterpret_cast<float*>(mel_smem);
  float2* bas = reinterpret_cast<float2*>(mel_smem + kSpan * sizeof(float));
  float* pw = reinterpret_cast<float*>(bas);  // reused after the DFT

  const int f0 = blockIdx.x * kFrames;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fr0 = warp * kFramesPerWarp;  // this warp's first frame in the block

  load_basis_chunk(bas, basis, 0);

  // samples of the reflect-padded window: padded index p is signal index
  // p - 200 mirrored at both ends of [0, 480000); signal past n is zero
  const float* xb = x + (size_t)b * n;
  const int p0 = f0 * kHop;
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    int s = p0 + i - kHalf;
    float val = 0.f;
    if (p0 + i < kNSamples + kNFft) {
      if (s < 0) s = -s;
      if (s >= kNSamples) s = 2 * (kNSamples - 1) - s;
      if (s < n) val = xb[s];
    }
    samp[i] = val;
  }

  float re[kFramesPerWarp][kFreqSlots], im[kFramesPerWarp][kFreqSlots];
#pragma unroll
  for (int j = 0; j < kFramesPerWarp; ++j) {
#pragma unroll
    for (int i = 0; i < kFreqSlots; ++i) re[j][i] = im[j][i] = 0.f;
  }

  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) {
      load_basis_chunk(bas + ((c + 1) & 1) * kChunk * kFreqPad, basis, c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and, at c = 0, the samples) visible to all
    const float2* bk = bas + (c & 1) * kChunk * kFreqPad;
#pragma unroll
    for (int k4 = 0; k4 < kChunk; k4 += 4) {
      float4 sv[kFramesPerWarp];
#pragma unroll
      for (int j = 0; j < kFramesPerWarp; ++j) {
        sv[j] = *reinterpret_cast<const float4*>(&samp[(fr0 + j) * kHop + c * kChunk + k4]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float2 w[kFreqSlots];
#pragma unroll
        for (int i = 0; i < kFreqSlots; ++i) w[i] = bk[(k4 + kk) * kFreqPad + lane + 32 * i];
#pragma unroll
        for (int j = 0; j < kFramesPerWarp; ++j) {
          const float s = kk == 0 ? sv[j].x : kk == 1 ? sv[j].y : kk == 2 ? sv[j].z : sv[j].w;
#pragma unroll
          for (int i = 0; i < kFreqSlots; ++i) {
            re[j][i] = fmaf(s, w[i].x, re[j][i]);
            im[j][i] = fmaf(s, w[i].y, im[j][i]);
          }
        }
      }
    }
    __syncthreads();  // chunk c consumed before its buffer is refilled
  }

  // power spectrum, (201, 64) padded rows, over the basis buffers
#pragma unroll
  for (int i = 0; i < kFreqSlots; ++i) {
    const int f = lane + 32 * i;
    if (f < kNFreqs) {
#pragma unroll
      for (int j = 0; j < kFramesPerWarp; ++j) {
        pw[f * kPowLd + fr0 + j] = re[j][i] * re[j][i] + im[j][i] * im[j][i];
      }
    }
  }
  __syncthreads();

  // mel projection: lane l owns mels l, l + 32, ...; the warp's 8 frames
  float acc[kFramesPerWarp][kMelSlots];
#pragma unroll
  for (int j = 0; j < kFramesPerWarp; ++j) {
#pragma unroll
    for (int i = 0; i < kMelSlots; ++i) acc[j][i] = 0.f;
  }
  for (int f = 0; f < kNFreqs; ++f) {
    float wv[kMelSlots];
#pragma unroll
    for (int i = 0; i < kMelSlots; ++i) {
      const int m = lane + 32 * i;
      wv[i] = m < n_mels ? __ldg(&fb[f * n_mels + m]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kFramesPerWarp; ++j) {
      const float p = pw[f * kPowLd + fr0 + j];
#pragma unroll
      for (int i = 0; i < kMelSlots; ++i) acc[j][i] = fmaf(p, wv[i], acc[j][i]);
    }
  }

  // 3000 = 375 x 8: a warp's 8 frames are all real or all past the end
  if (f0 + fr0 >= kNFrames) return;
#pragma unroll
  for (int i = 0; i < kMelSlots; ++i) {
    const int m = lane + 32 * i;
    if (m < n_mels) {
      float* dst = out + ((size_t)b * n_mels + m) * kNFrames + f0 + fr0;
      float lg[kFramesPerWarp];
#pragma unroll
      for (int j = 0; j < kFramesPerWarp; ++j) lg[j] = log10f(fmaxf(acc[j][i], 1e-10f));
      reinterpret_cast<float4*>(dst)[0] = make_float4(lg[0], lg[1], lg[2], lg[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(lg[4], lg[5], lg[6], lg[7]);
    }
  }
}

template <int kMelSlots>
cudaError_t launch_log_mel(const float* x, const float2* basis, const float* fb, float* out,
                           int B, int n, int n_mels, cudaStream_t st) {
  static bool reserved = false;
  if (!reserved) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel<kMelSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    reserved = true;
  }
  const dim3 grid((kNFrames + kFrames - 1) / kFrames, B);
  log_mel_kernel<kMelSlots><<<grid, kThreads, kSmemBytes, st>>>(x, basis, fb, out, n, n_mels);
  return cudaGetLastError();
}

}  // namespace

// x (B, n) float32 contiguous, any n >= 1 (padded with zeros or cut to
// 480000 by index); basis (400, 224) float2; fb (201, n_mels) float32 with
// n_mels <= 128; out (B, n_mels, 3000) float32 contiguous: log10(max(mel,
// 1e-10)).  Launches on `stream`, returns cudaGetLastError() (0 = launched).
extern "C" int ttasr_log_mel(const void* x, const void* basis, const void* fb, void* out,
                             int B, int n, int n_mels, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float2* bs = static_cast<const float2*>(basis);
  const float* fbs = static_cast<const float*>(fb);
  float* o = static_cast<float*>(out);
  if (n_mels < 1 || n_mels > 128 || n < 1) return (int)cudaErrorInvalidValue;
  if (n_mels <= 96) return (int)launch_log_mel<3>(xs, bs, fbs, o, B, n, n_mels, st);
  return (int)launch_log_mel<4>(xs, bs, fbs, o, B, n, n_mels, st);
}
