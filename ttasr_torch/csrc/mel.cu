// Whisper log-mel spectrogram for Hopper (sm_90a): B18.
//
// Replaces ttasr/ops/mel_pallas.py::log_mel_spectrogram_pallas (:114, body
// _mel_kernel :83): per 30 s window, framing (hop 160, n_fft 400, the
// signal reflect-padded by 200), the periodic-Hann-windowed 201-bin real
// transform, the power, the Slaney mel projection, log10(max(mel, 1e-10)),
// then the window's max - 8 clamp and (x + 4) / 4.  Frames, spectra and
// powers stay in shared memory; no torch op runs on the output.
//
// What bounds the function: a real FFT of each frame and the Slaney bank's
// ~400 nonzeros need ~11k FLOP per frame (~1.5 GFLOP for 48 windows at 128
// mels, ~0.023 ms at the float32 peak of 67 TFLOP/s, ~0.045 ms at the
// float64 peak of 34), against 1.9 MB of audio in and 1.5 MB out per window
// (~0.05 ms for 48 at 3.35 TB/s): it is bound by bytes.  The design before
// this one computed the transform as a dense (400, 224) DFT product and the
// projection over the whole bank (35x the FFT's operations, bound by FMA
// issue, 2.62 ms at 48 windows) and left the clamp to four torch launches.
// This one:
//   * log_mel_kernel, a persistent grid of 128-thread blocks (3 per SM, at
//     most one per tile), each walking tiles of 16 frames of one window
//     (188 tiles a window, so one window alone puts 188 blocks on the 132
//     SMs).  The block copies the tables once: the host's float64
//     twiddles (no sin/cos on the card), the window, and the mel bank as
//     runs of bins (CSR: a first bin, a count and the weights per mel).
//     Per tile:
//       - the next tile's 2800 samples are requested by cp.async into the
//         other half of a double buffer before this tile's work starts (16
//         bytes at a time inside the signal; padding, cut and reflection by
//         index, zero-filled 4-byte copies, at the ends: no padded copy of
//         the audio);
//       - the 400-point real transform of a frame as a 200-point complex
//         FFT of z[n] = x[2n] + i x[2n+1], the window applied as the pairs
//         are read.  200 = 8 x 25: a thread per (frame, n2), two at a time,
//         takes the eight points n = 25 n1 + n2 through a radix-8 butterfly
//         in registers and the twiddles W_200^(n2 k1) (400 tasks), stored
//         as float32; then a thread per (frame, k1) takes its 25 values
//         through a 25-point transform in registers, radix 5,
//         W_200^(8 m2 q1), radix 5 (128 tasks).  Position p of a frame's
//         buffer sits at p + p / 8, rows 232 float2 apart: both stages'
//         accesses are free of bank conflicts;
//       - the split step in the same thread, from its Z[k] and Z[200 - k],
//         which lies in the registers of column 8 - k1's thread of the same
//         warp (a shuffle; columns 0 and 4 hold their own):
//         E = (Z[k] + conj Z[200-k]) / 2, O = (Z[k] - conj Z[200-k]) / 2i,
//         |X[k]|^2 = |E + W_400^k O|^2, and |X[200]|^2 = |E - O|^2 at k = 0;
//       - the projection, a thread per (frame, mel), four mels at a time,
//         over that mel's run of bins in bin order (394 nonzeros at 128
//         mels, against 201 x 128 for the dense bank), then log10, stored
//         in frame order, and the tile's max into tile_max;
//   * log_mel_tail_kernel: a block per (chunk, window) reduces the window's
//     188 tile maxima and applies max(v, peak - 8) and (v + 4) * 0.25 in
//     place (each one rounding in float32, as the torch ops do: the same
//     bits).  One more read and write of the output.  Two alternatives: a
//     thread-block cluster holding a window's 1.5 MB in distributed shared
//     memory would put one window on at most 16 SMs; one cooperative launch
//     in which the block that counts a window's last tile makes its peak
//     and blocks rescale ready windows' chunks between tiles, from L2, gave
//     the same bits and was slower at B = 1 and at 48 windows: thread 0's
//     L2 round trips to count a tile and take a chunk stall its block, and
//     claiming chunks by compare-and-swap on one counter serialised them.
// Precision: the FFT stages and the split run in float64 (the H100 issues
// float64 at half the float32 rate) on float32 window products, stage 1's
// output stored as float32.  In float32 throughout, a first version put a
// loud onset over faint noise past the 2e-4 contract on the card: the
// roundings of a packed pair's large values (a loud bin and its mirror
// 200 - k share them) land on the quiet bins near the max - 8 floor.  The
// CPU emulation (tests/test_torch_mel_fft.py) traced it to the 25-point
// stage, Z's float32 storage and the split.  With this precision the card
// puts that clip at 3.0e-5 and a loud tone over faint noise at 6.4e-5,
// where the dense float32 DFT before it gave 3.1e-5 and 7.8e-5
// (chip_compare.py --mel).
// What paces it (chip_compare.py --mel: clock64 per phase, thread 0 of each
// block, 48 windows, cycles per tile, NVIDIA H100 80GB HBM3 at 700 W):
// staging wait 581, stage 1 5104, stage 2 with the split 5547, the
// projection 5885, the tile max 387.  The float64 pipe (conversions from
// and to float32 at a quarter of its rate among its work) sets the pace of
// the FFT stages, at 3 blocks an SM (the registers of stage 2's 25 values
// and 74 KB of shared memory); the staging wait is short because the next
// tile's copies are in flight, and the projection's shared-memory chains
// are short because each mel is a run of bins, four mels at a time.
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
constexpr int kPad = kNFft / 2;  // reflect padding
constexpr int kN = kNFft / 2;  // complex FFT points
constexpr int kPowLd = kN + 1;  // 201 bins; odd: conflict-free columns
constexpr int kFrames = 16;  // frames per tile
constexpr int kThreads = 128;
constexpr int kTiles = (kNFrames + kFrames - 1) / kFrames;  // 188 per window
constexpr int kSpan = (kFrames - 1) * kHop + kNFft;  // 2800 samples
constexpr int kRow = 232;  // float2 per frame: p + p / 8 < 225, 232 = 8 mod 16
constexpr int kTw = kN + kN / 2 + 1;  // W_200^0..199, W_400^0..100
constexpr int kMaxMels = 128;
constexpr int kMaxNnz = 2 * kPowLd;  // each bin lies in at most two triangles
constexpr int kTailThreads = 256;
constexpr int kTailVec = 4;  // float4 per thread in the tail

static_assert(kHop % 2 == 0, "frames start at even samples: float2 pairs");
static_assert(kFrames * 8 == kThreads, "stage 2: a thread per (frame, k1)");
static_assert((kFrames & (kFrames - 1)) == 0, "the projection's frame is tid % kFrames");

struct Smem {
  double2 tw[kTw];
  float samp[2][kSpan];  // this tile's samples and the next tile's, in flight
  float2 fft[kFrames * kRow];
  float pw[kFrames * kPowLd];
  float win[kNFft];
  float wts[kMaxNnz];
  int first[kMaxMels];
  int indptr[kMaxMels + 1];
  float red[kThreads / 32];
};

struct Cx {  // a complex value in float64
  double x, y;
};

__device__ __forceinline__ Cx add2(Cx a, Cx b) { return {a.x + b.x, a.y + b.y}; }

__device__ __forceinline__ Cx sub2(Cx a, Cx b) { return {a.x - b.x, a.y - b.y}; }

__device__ __forceinline__ Cx neg_i(Cx a) { return {a.y, -a.x}; }

// a times the twiddle w = (cos, -sin) of the table
__device__ __forceinline__ Cx cmul(Cx a, double2 w) {
  return {a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x};
}

// 4-point DFT, in place, natural order
__device__ __forceinline__ void dft4(Cx& c0, Cx& c1, Cx& c2, Cx& c3) {
  const Cx d0 = add2(c0, c2), d1 = sub2(c0, c2), d2 = add2(c1, c3);
  const Cx d3 = neg_i(sub2(c1, c3));
  c0 = add2(d0, d2);
  c1 = add2(d1, d3);
  c2 = sub2(d0, d2);
  c3 = sub2(d1, d3);
}

// 8-point DFT, in place, natural order: a radix-2 split, W_8^1..3 on the
// odd half (c = cos(pi / 4) from the table), two 4-point DFTs
__device__ __forceinline__ void dft8(Cx (&a)[8], double c) {
  Cx b[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[i] = add2(a[i], a[i + 4]);
    b[i + 4] = sub2(a[i], a[i + 4]);
  }
  b[5] = {c * (b[5].x + b[5].y), c * (b[5].y - b[5].x)};
  b[6] = neg_i(b[6]);
  b[7] = {c * (b[7].y - b[7].x), -c * (b[7].x + b[7].y)};
  dft4(b[0], b[1], b[2], b[3]);
  dft4(b[4], b[5], b[6], b[7]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[2 * q] = b[q];
    a[2 * q + 1] = b[q + 4];
  }
}

// 5-point DFT, in place, natural order; k = (cos 72, sin 72, cos 144,
// sin 144) from the table
__device__ __forceinline__ void dft5(Cx& x0, Cx& x1, Cx& x2, Cx& x3, Cx& x4,
                                     const double (&k)[4]) {
  const Cx t1 = add2(x1, x4), t2 = add2(x2, x3), t3 = sub2(x1, x4), t4 = sub2(x2, x3);
  const Cx a1 = {x0.x + k[0] * t1.x + k[2] * t2.x, x0.y + k[0] * t1.y + k[2] * t2.y};
  const Cx b1 = {k[1] * t3.x + k[3] * t4.x, k[1] * t3.y + k[3] * t4.y};
  const Cx a2 = {x0.x + k[2] * t1.x + k[0] * t2.x, x0.y + k[2] * t1.y + k[0] * t2.y};
  const Cx b2 = {k[3] * t3.x - k[1] * t4.x, k[3] * t3.y - k[1] * t4.y};
  x0 = add2(add2(x0, t1), t2);
  x1 = add2(a1, neg_i(b1));
  x4 = sub2(a1, neg_i(b1));
  x2 = add2(a2, neg_i(b2));
  x3 = sub2(a2, neg_i(b2));
}

// Slot of Z[k1 + 8 k2] in stage 2's registers: k2 = q1 + 5 q2 at 5 q1 + q2.
__host__ __device__ constexpr int zslot(int k2) { return 5 * (k2 % 5) + k2 / 5; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

// Tile `tile`'s samples of the reflect-padded window into dst, by cp.async:
// padded index p is signal index p - 200 mirrored at both ends of
// [0, 480000); signal past n, and padding past 480400, is zero-filled.  A
// tile inside the signal, in rows of 16-byte multiples, goes 16 bytes at a
// time (its first sample, 2560 t - 200, is a multiple of 4).
__device__ __forceinline__ void stage_samples(float* dst, const float* x, int tile, int n) {
  const int b = tile / kTiles;
  const int p0 = (tile - b * kTiles) * kFrames * kHop;
  const float* xb = x + (size_t)b * n;
  if ((n & 3) == 0 && p0 >= kPad && p0 - kPad + kSpan <= min(n, kNSamples)) {
    for (int i = 4 * threadIdx.x; i < kSpan; i += 4 * kThreads) cp_async16(dst + i, xb + p0 - kPad + i);
    return;
  }
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    const int p = p0 + i;
    int s = p - kPad;
    if (s < 0) s = -s;
    if (s >= kNSamples) s = 2 * (kNSamples - 1) - s;
    const bool valid = p < kNSamples + kNFft && s < n;
    cp_async4(dst + i, xb + (valid ? s : 0), valid);
  }
}

// x (B, n); out (B, n_mels, 3000) log10(max(mel, 1e-10)); tile_max (B, 188)
__global__ void __launch_bounds__(kThreads, 3)
log_mel_kernel(const float* __restrict__ x, const double2* __restrict__ twiddles,
               const float* __restrict__ window, const int* __restrict__ indptr,
               const int* __restrict__ first, const float* __restrict__ weights,
               float* __restrict__ out, float* __restrict__ tile_max, int n_tiles, int n,
               int n_mels, int nnz) {
  extern __shared__ __align__(16) unsigned char mel_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(mel_smem);
  const int tid = threadIdx.x, lane = tid & 31;
  if (blockIdx.x < n_tiles) stage_samples(sm.samp[0], x, blockIdx.x, n);
  cp_async_commit();
  for (int i = tid; i < kTw; i += kThreads) sm.tw[i] = twiddles[i];
  for (int i = tid; i < kNFft; i += kThreads) sm.win[i] = window[i];
  for (int i = tid; i < nnz; i += kThreads) sm.wts[i] = weights[i];
  for (int i = tid; i < n_mels; i += kThreads) sm.first[i] = first[i];
  for (int i = tid; i <= n_mels; i += kThreads) sm.indptr[i] = indptr[i];
  const float2* win2 = reinterpret_cast<const float2*>(sm.win);

  int cur = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, cur ^= 1) {
    const int b = tile / kTiles;
    const int f0 = (tile - b * kTiles) * kFrames;
    const int nf = min(kFrames, kNFrames - f0);
    if (tile + gridDim.x < n_tiles) stage_samples(sm.samp[cur ^ 1], x, tile + gridDim.x, n);
    cp_async_commit();
    cp_async_wait1();  // this tile's samples (the group before the newest)
    __syncthreads();   // ... from every thread; the tables are in

    // stage 1, float64: a thread per (frame j, n2) takes z[25 n1 + n2],
    // windowed as the pairs are read (float32 products), through radix 8,
    // then W_200^(n2 k1); stored as float32
    const float2* samp = reinterpret_cast<const float2*>(sm.samp[cur]);
    const double c8 = sm.tw[25].x;
    // two tasks at a time, the second clamped to the last task (a thread
    // that repeats it writes the same values)
    for (int t0 = tid; t0 < kFrames * 25; t0 += 2 * kThreads) {
      Cx a[2][8];
      int tt[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tt[h] = min(t0 + h * kThreads, kFrames * 25 - 1);
        const int j = tt[h] / 25, n2 = tt[h] - j * 25;
#pragma unroll
        for (int n1 = 0; n1 < 8; ++n1) {
          const int m = 25 * n1 + n2;
          const float2 s = samp[j * (kHop / 2) + m], w = win2[m];
          a[h][n1] = {s.x * w.x, s.y * w.y};
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dft8(a[h], c8);
        const int j = tt[h] / 25, n2 = tt[h] - j * 25;
        float2* dst = sm.fft + j * kRow + n2 * 9;
#pragma unroll
        for (int k1 = 0; k1 < 8; ++k1) {
          const Cx v = k1 == 0 ? a[h][0] : cmul(a[h][k1], sm.tw[n2 * k1]);
          dst[k1] = make_float2((float)v.x, (float)v.y);
        }
      }
    }
    __syncthreads();

    // stage 2, float64, a thread per (frame j, k1): 25 points over
    // n2 = 5 m1 + m2 (radix 5 over m1, W_200^(8 m2 q1), radix 5 over m2)
    // give Z[k1 + 8 k2] in registers; then the split for each of its k,
    // with Z[200 - k] from the thread of column 8 - k1 in the same warp
    // (columns 0 and 4 hold their own mirrors):
    // E = (Z[k] + conj Z[200-k]) / 2, O = (Z[k] - conj Z[200-k]) / 2i,
    // |X[k]|^2 = |E + W_400^k O|^2, and |X[200]|^2 = |E - O|^2 at k = 0
    {
      const int j = tid >> 3, k1 = tid & 7;
      const float2* col = sm.fft + j * kRow + k1;
      const double k5[4] = {sm.tw[40].x, -sm.tw[40].y, sm.tw[80].x, -sm.tw[80].y};
      Cx a[25];
#pragma unroll
      for (int i = 0; i < 25; ++i) {
        const float2 v = col[9 * i];
        a[i] = {v.x, v.y};
      }
#pragma unroll
      for (int m2 = 0; m2 < 5; ++m2) {
        dft5(a[m2], a[5 + m2], a[10 + m2], a[15 + m2], a[20 + m2], k5);
      }
#pragma unroll
      for (int m2 = 1; m2 < 5; ++m2) {
#pragma unroll
        for (int q1 = 1; q1 < 5; ++q1) a[5 * q1 + m2] = cmul(a[5 * q1 + m2], sm.tw[8 * m2 * q1]);
      }
#pragma unroll
      for (int q1 = 0; q1 < 5; ++q1) {
        dft5(a[5 * q1], a[5 * q1 + 1], a[5 * q1 + 2], a[5 * q1 + 3], a[5 * q1 + 4], k5);
      }
      const int partner = (lane & ~7) | ((8 - k1) & 7);
      float* pj = sm.pw + j * kPowLd;
#pragma unroll
      for (int k2 = 0; k2 < 25; ++k2) {
        // columns 1-7: 200 - (k1 + 8 k2) = (8 - k1) + 8 (24 - k2); column 4
        // is its own partner; column 0: 200 - 8 k2 = 8 ((25 - k2) mod 25)
        const Cx mine = a[zslot(24 - k2)];
        Cx zb = {__shfl_sync(0xffffffffu, mine.x, partner),
                 __shfl_sync(0xffffffffu, mine.y, partner)};
        if (k1 == 0) zb = a[zslot((25 - k2) % 25)];
        const Cx za = a[zslot(k2)];
        const Cx e = {0.5 * (za.x + zb.x), 0.5 * (za.y - zb.y)};
        const Cx o = {0.5 * (za.y + zb.y), -0.5 * (za.x - zb.x)};
        const int k = k1 + 8 * k2;
        // W_400^k = -conj(W_400^(200 - k)) past k = 100
        const double2 wt = sm.tw[kN + (k <= kN / 2 ? k : kN - k)];
        const Cx xk = add2(e, cmul(o, k <= kN / 2 ? wt : make_double2(-wt.x, wt.y)));
        pj[k] = (float)(xk.x * xk.x + xk.y * xk.y);
        if (k == 0) {
          const Cx xn = sub2(e, o);
          pj[kN] = (float)(xn.x * xn.x + xn.y * xn.y);
        }
      }
    }
    __syncthreads();

    // mel m of frame j over its bins first[m] .. in order, log10, frame
    // order: thread (j, g) takes mels g, g + 8, ..., four at a time
    float vmax = -INFINITY;
    const int j = tid & (kFrames - 1);
    if (j < nf) {
      constexpr int kGroups = kThreads / kFrames;  // 8
      const float* pj = sm.pw + j * kPowLd;
      float* oj = out + (size_t)b * n_mels * kNFrames + f0 + j;
      for (int m0 = tid / kFrames; m0 < n_mels; m0 += 4 * kGroups) {
        int o[4], c[4];
        const float* pm[4];
        float acc[4];
        int cmax = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = min(m0 + u * kGroups, n_mels - 1);
          o[u] = sm.indptr[m];
          c[u] = m0 + u * kGroups < n_mels ? sm.indptr[m + 1] - o[u] : 0;
          pm[u] = pj + sm.first[m];
          acc[u] = 0.f;
          cmax = max(cmax, c[u]);
        }
        for (int i = 0; i < cmax; ++i) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (i < c[u]) acc[u] = fmaf(sm.wts[o[u] + i], pm[u][i], acc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = m0 + u * kGroups;
          if (m < n_mels) {
            const float v = __log10f(fmaxf(acc[u], 1e-10f));  // <= 3 ulp
            oj[(size_t)m * kNFrames] = v;
            vmax = fmaxf(vmax, v);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
    if (lane == 0) sm.red[tid >> 5] = vmax;
    __syncthreads();
    if (tid == 0) {
      float m = sm.red[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, sm.red[w]);
      tile_max[tile] = m;
    }
  }
}

// out (B, n4 float4 per window): max(v, peak - 8), then (v + 4) * 0.25,
// peak the window's max over its tile maxima
__global__ void __launch_bounds__(kTailThreads)
log_mel_tail_kernel(float* __restrict__ out, const float* __restrict__ tile_max, int n4) {
  __shared__ float red[kTailThreads / 32];
  const int b = blockIdx.y;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < kTiles; i += kTailThreads) m = fmaxf(m, tile_max[b * kTiles + i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kTailThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float floor_v = __fsub_rn(m, 8.f);

  float4* o = reinterpret_cast<float4*>(out) + (size_t)b * n4;
  const int base = blockIdx.x * (kTailThreads * kTailVec) + threadIdx.x;
  float4 v[kTailVec];
#pragma unroll
  for (int u = 0; u < kTailVec; ++u) {
    const int i = base + u * kTailThreads;
    if (i < n4) v[u] = o[i];
  }
#pragma unroll
  for (int u = 0; u < kTailVec; ++u) {
    const int i = base + u * kTailThreads;
    if (i < n4) {
      float4 r = v[u];
      r.x = __fmul_rn(__fadd_rn(fmaxf(r.x, floor_v), 4.f), 0.25f);
      r.y = __fmul_rn(__fadd_rn(fmaxf(r.y, floor_v), 4.f), 0.25f);
      r.z = __fmul_rn(__fadd_rn(fmaxf(r.z, floor_v), 4.f), 0.25f);
      r.w = __fmul_rn(__fadd_rn(fmaxf(r.w, floor_v), 4.f), 0.25f);
      o[i] = r;
    }
  }
}

}  // namespace

// x (B, n) float32 contiguous, any n >= 1 (padded with zeros or cut to
// 480000 by index); twiddles (301, 2) float64: W_200^0..199, W_400^0..100 as
// (cos, -sin); window (400,) float32; the mel bank over mels, each mel's
// nonzeros a run of bins: indptr (n_mels + 1,) and first bin (n_mels,)
// int32, weights (nnz,) float32, n_mels <= 128, nnz <= 402; out (B, n_mels, 3000) float32 contiguous: log10(max(mel,
// 1e-10)); tile_max (B, 188) float32, the tiles' maxima for
// ttasr_log_mel_tail.  Launches on `stream`, returns cudaGetLastError().
extern "C" int ttasr_log_mel(const void* x, const void* twiddles, const void* window,
                             const void* indptr, const void* first, const void* weights, void* out,
                             void* tile_max, int B, int n, int n_mels, int nnz, void* stream) {
  if (n_mels < 1 || n_mels > kMaxMels || n < 1 || B < 1 || nnz < 0 || nnz > kMaxNnz) {
    return (int)cudaErrorInvalidValue;
  }
  static int grid_cap = 0;  // blocks resident on the whole card
  if (grid_cap == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
      return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log_mel_kernel, kThreads,
                                                        sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = B * kTiles;
  log_mel_kernel<<<tiles < grid_cap ? tiles : grid_cap, kThreads, sizeof(Smem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const double2*>(twiddles),
      static_cast<const float*>(window), static_cast<const int*>(indptr),
      static_cast<const int*>(first), static_cast<const float*>(weights), static_cast<float*>(out),
      static_cast<float*>(tile_max), tiles, n, n_mels, nnz);
  return (int)cudaGetLastError();
}

// out (B, n_mels, 3000) float32 from ttasr_log_mel, rescaled in place with
// its tile_max (B, 188).  Launches on `stream`, returns cudaGetLastError().
extern "C" int ttasr_log_mel_tail(void* out, const void* tile_max, int B, int n_mels,
                                  void* stream) {
  if (n_mels < 1 || n_mels > kMaxMels || B < 1) return (int)cudaErrorInvalidValue;
  const int n4 = n_mels * kNFrames / 4;  // 3000 = 4 x 750
  const dim3 grid((n4 + kTailThreads * kTailVec - 1) / (kTailThreads * kTailVec), B);
  log_mel_tail_kernel<<<grid, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(tile_max), n4);
  return (int)cudaGetLastError();
}
