// ttasr_torch native host helpers (a copy of ttasr/native/ttasr_native.cpp).
//
// The host-side hot loops of the serving and evaluation paths, in C++:
//
//   - pcm16 <-> float32 conversion (streaming ingest path)
//   - windowed-sinc polyphase resampling (arbitrary rate -> 16 kHz)
//   - Levenshtein distance over unicode codepoints (corpus CER metric)
//   - WAV (RIFF) PCM16 header parse + payload offset discovery
//
// Host code, not a device kernel: ttasr_torch/native/__init__.py builds it
// with g++ into ttasr_torch/_build/ at first use and binds it with ctypes
// (plain C ABI); every entry point has a numpy/Python fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// PCM conversion
// --------------------------------------------------------------------------

void ttasr_pcm16_to_f32(const int16_t* in, int64_t n, float* out) {
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * kScale;
}

void ttasr_f32_to_pcm16(const float* in, int64_t n, int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i];
        v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
        out[i] = static_cast<int16_t>(v * 32767.0f);
    }
}

// --------------------------------------------------------------------------
// Polyphase resampling (windowed sinc, Kaiser beta=8)
// --------------------------------------------------------------------------

static double bessel_i0(double x) {
    // series expansion, converges fast for |x| < ~20
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 32; ++k) {
        term *= (x / (2.0 * k)) * (x / (2.0 * k));
        sum += term;
        if (term < 1e-16 * sum) break;
    }
    return sum;
}

int64_t ttasr_resample_out_len(int64_t n_in, int32_t sr_from, int32_t sr_to) {
    int64_t g = std::gcd<int64_t>(sr_from, sr_to);
    int64_t up = sr_to / g, down = sr_from / g;
    return (n_in * up + down - 1) / down;
}

// Polyphase windowed-sinc resampler. Returns number of output samples.
int64_t ttasr_resample(const float* in, int64_t n_in, int32_t sr_from,
                       int32_t sr_to, float* out, int32_t half_width) {
    if (sr_from == sr_to) {
        std::memcpy(out, in, sizeof(float) * n_in);
        return n_in;
    }
    const int64_t g = std::gcd<int64_t>(sr_from, sr_to);
    const int64_t up = sr_to / g, down = sr_from / g;
    const int64_t n_out = (n_in * up + down - 1) / down;
    const double cutoff = 1.0 / std::max<int64_t>(up, down);
    const int taps = 2 * half_width + 1;
    const double beta = 8.0;
    const double i0b = bessel_i0(beta);

    // one filter per output phase
    std::vector<float> kernel(static_cast<size_t>(up) * taps);
    for (int64_t p = 0; p < up; ++p) {
        const double frac = std::fmod(static_cast<double>(p) * down / up, 1.0);
        for (int t = 0; t < taps; ++t) {
            const double x = (t - half_width) - frac;
            const double arg = x * up * cutoff;
            const double sinc =
                arg == 0.0 ? 1.0 : std::sin(M_PI * arg) / (M_PI * arg);
            const double w_pos = static_cast<double>(t) / (taps - 1) * 2.0 - 1.0;
            const double kaiser = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - w_pos * w_pos))) / i0b;
            kernel[p * taps + t] =
                static_cast<float>(sinc * kaiser * up * cutoff);
        }
    }

    for (int64_t o = 0; o < n_out; ++o) {
        const int64_t phase = (o * down) % up;
        const int64_t base = (o * down) / up;
        const float* k = &kernel[phase * taps];
        float acc = 0.0f;
        for (int t = 0; t < taps; ++t) {
            int64_t src = base + t - half_width;
            if (src < 0) src = 0;
            if (src >= n_in) src = n_in - 1;
            acc += in[src] * k[t];
        }
        out[o] = acc;
    }
    return n_out;
}

// --------------------------------------------------------------------------
// Levenshtein distance over uint32 codepoints (CER metric core)
// --------------------------------------------------------------------------

int64_t ttasr_levenshtein_u32(const uint32_t* a, int64_t la,
                              const uint32_t* b, int64_t lb) {
    if (la == 0) return lb;
    if (lb == 0) return la;
    std::vector<int64_t> prev(lb + 1), cur(lb + 1);
    std::iota(prev.begin(), prev.end(), 0);
    for (int64_t i = 1; i <= la; ++i) {
        cur[0] = i;
        const uint32_t ca = a[i - 1];
        for (int64_t j = 1; j <= lb; ++j) {
            const int64_t sub = prev[j - 1] + (ca != b[j - 1] ? 1 : 0);
            cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
        }
        std::swap(prev, cur);
    }
    return prev[lb];
}

// --------------------------------------------------------------------------
// RIFF/WAV PCM16 probe: returns 0 on success and fills rate/channels/
// payload offset/length (bytes). Only handles the common PCM16 layout the
// streaming path writes; Python handles exotic variants.
// --------------------------------------------------------------------------

int32_t ttasr_wav_probe_pcm16(const uint8_t* data, int64_t n,
                              int32_t* rate, int32_t* channels,
                              int64_t* payload_off, int64_t* payload_len) {
    if (n < 44 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WAVE", 4))
        return -1;
    int64_t pos = 12;
    bool have_fmt = false;
    while (pos + 8 <= n) {
        const uint32_t size = *reinterpret_cast<const uint32_t*>(data + pos + 4);
        if (!std::memcmp(data + pos, "fmt ", 4) && pos + 8 + 16 <= n) {
            const uint16_t fmt = *reinterpret_cast<const uint16_t*>(data + pos + 8);
            const uint16_t ch = *reinterpret_cast<const uint16_t*>(data + pos + 10);
            const uint32_t sr = *reinterpret_cast<const uint32_t*>(data + pos + 12);
            const uint16_t bits = *reinterpret_cast<const uint16_t*>(data + pos + 22);
            if ((fmt != 1 && fmt != 0xFFFE) || bits != 16) return -2;
            *rate = static_cast<int32_t>(sr);
            *channels = ch;
            have_fmt = true;
        } else if (!std::memcmp(data + pos, "data", 4)) {
            *payload_off = pos + 8;
            *payload_len = std::min<int64_t>(size, n - pos - 8);
            return have_fmt ? 0 : -3;
        }
        pos += 8 + size + (size & 1);
    }
    return -4;
}

}  // extern "C"
