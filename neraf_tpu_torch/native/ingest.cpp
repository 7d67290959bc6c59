// neraf native ingest: WAV decode + polyphase resample + STFT magnitudes
// (the port's copy of neraf_tpu/native/ingest.cpp, same C interface; its
// STFT is a radix-2 FFT where that library sums a direct DFT).
//
// The reference's data path runs on native code: torchaudio's C++ wav
// decode and Spectrogram kernels (NeRAF_dataset.py:67,113) behind torch
// DataLoader worker processes (NeRAF_datamanager.py:84-104). This library is
// the host-side ingest: RIFF WAV parsing, the Kaiser-windowed polyphase
// resampler of dsp/resample.py, torch-convention center/reflect STFT
// magnitudes matching dsp/stft.py, and a std::thread batch runner in place of
// the DataLoader workers. It is host code: the card sees only its output.
//
// A plain C ABI for ctypes, built with g++ at first use by native/__init__.py.
// Parity with the port's Python path and with the JAX package's native
// library is pinned by tests/test_torch_native_ingest.py.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------- WAV parse

struct WavHeader {
  int sample_rate = 0;
  int channels = 0;
  int frames = 0;   // samples per channel
  int bits = 0;
  int fmt = 0;      // resolved format code (1=PCM, 3=float)
  long data_offset = 0;
  long data_size = 0;
};

struct WavData {
  int sample_rate = 0;
  int channels = 0;
  int frames = 0;  // samples per channel
  std::vector<float> samples;  // deinterleaved: channel-major [c][t]
};

// Header-only RIFF/WAVE parse: fmt chunk (incl. WAVE_FORMAT_EXTENSIBLE
// subformat resolution) + data chunk location, with validation so malformed
// files fail cleanly instead of dividing by zero or over-allocating.
bool parse_wav_header(const char* path, WavHeader* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  auto read_u32 = [&](uint32_t* v) {
    return std::fread(v, 4, 1, f) == 1;
  };
  auto read_u16 = [&](uint16_t* v) {
    return std::fread(v, 2, 1, f) == 1;
  };

  char tag[5] = {0};
  uint32_t riff_size = 0;
  if (std::fread(tag, 1, 4, f) != 4 || std::strncmp(tag, "RIFF", 4) != 0 ||
      !read_u32(&riff_size) || std::fread(tag, 1, 4, f) != 4 ||
      std::strncmp(tag, "WAVE", 4) != 0) {
    std::fclose(f);
    return false;
  }

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool have_fmt = false, have_data = false;
  long data_offset = 0, data_size = 0;

  while (std::fread(tag, 1, 4, f) == 4) {
    uint32_t chunk = 0;
    if (!read_u32(&chunk)) break;
    if (std::strncmp(tag, "fmt ", 4) == 0) {
      uint16_t block_align = 0;
      uint32_t byte_rate = 0;
      if (!read_u16(&fmt) || !read_u16(&channels) || !read_u32(&sample_rate) ||
          !read_u32(&byte_rate) || !read_u16(&block_align) || !read_u16(&bits)) {
        std::fclose(f);
        return false;
      }
      long extra = static_cast<long>(chunk) - 16;
      if (fmt == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: the real format code is the first u16 of
        // the SubFormat GUID (after cbSize, validBits, channelMask)
        uint16_t cb = 0, valid_bits = 0, sub = 0;
        uint32_t mask = 0;
        if (extra < 10 || !read_u16(&cb) || !read_u16(&valid_bits) ||
            !read_u32(&mask) || !read_u16(&sub)) {
          std::fclose(f);
          return false;
        }
        fmt = sub;
        extra -= 10;
      }
      if (extra > 0) std::fseek(f, extra + (chunk & 1), SEEK_CUR);
      else if (chunk & 1) std::fseek(f, 1, SEEK_CUR);
      have_fmt = true;
    } else if (std::strncmp(tag, "data", 4) == 0) {
      data_offset = std::ftell(f);
      data_size = static_cast<long>(chunk);
      have_data = true;
      std::fseek(f, chunk + (chunk & 1), SEEK_CUR);
    } else {
      std::fseek(f, chunk + (chunk & 1), SEEK_CUR);
    }
  }
  // validate: supported format/bit depths, sane channel count, real data
  const long fsize = [&] {
    std::fseek(f, 0, SEEK_END);
    return std::ftell(f);
  }();
  std::fclose(f);
  if (!have_fmt || !have_data || data_size <= 0) return false;
  if (channels == 0 || channels > 64) return false;
  if (fmt != 1 && fmt != 3) return false;
  if (fmt == 3 && bits != 32) return false;
  if (fmt == 1 && bits != 8 && bits != 16 && bits != 24 && bits != 32)
    return false;
  if (data_offset + data_size > fsize) data_size = fsize - data_offset;
  if (data_size <= 0) return false;

  const int bytes_per = bits / 8;
  h->sample_rate = static_cast<int>(sample_rate);
  h->channels = channels;
  h->bits = bits;
  h->fmt = fmt;
  h->data_offset = data_offset;
  h->data_size = data_size;
  h->frames = static_cast<int>(data_size / (bytes_per * channels));
  return h->frames > 0;
}

// Full decode, matching the scaling in utils/wav.py and scipy
// (int16/32768, int24/32 via int32/2^31, uint8 offset-binary, float pass).
bool read_wav_file(const char* path, WavData* out) {
  WavHeader h;
  if (!parse_wav_header(path, &h)) return false;
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, h.data_offset, SEEK_SET);
  const int bytes_per = h.bits / 8;
  const size_t need =
      static_cast<size_t>(h.frames) * h.channels * bytes_per;
  std::vector<uint8_t> data(need);
  const bool ok = std::fread(data.data(), 1, need, f) == need;
  std::fclose(f);
  if (!ok) return false;

  out->sample_rate = h.sample_rate;
  out->channels = h.channels;
  out->frames = h.frames;
  out->samples.assign(static_cast<size_t>(h.frames) * h.channels, 0.0f);

  const uint8_t* p = data.data();
  for (int t = 0; t < h.frames; ++t) {
    for (int c = 0; c < h.channels; ++c) {
      const uint8_t* s =
          p + (static_cast<size_t>(t) * h.channels + c) * bytes_per;
      float v = 0.0f;
      if (h.fmt == 3) {
        float fv;
        std::memcpy(&fv, s, 4);
        v = fv;
      } else if (h.bits == 16) {
        int16_t iv;
        std::memcpy(&iv, s, 2);
        v = static_cast<float>(iv) / 32768.0f;
      } else if (h.bits == 24) {
        // little-endian signed 24-bit -> int32 (scipy loads 24-bit into the
        // high bytes of int32), scaled by 2^31
        const int32_t iv = static_cast<int32_t>(
            (static_cast<uint32_t>(s[0]) << 8) |
            (static_cast<uint32_t>(s[1]) << 16) |
            (static_cast<uint32_t>(s[2]) << 24));
        v = static_cast<float>(static_cast<double>(iv) / 2147483648.0);
      } else if (h.bits == 32) {
        int32_t iv;
        std::memcpy(&iv, s, 4);
        v = static_cast<float>(static_cast<double>(iv) / 2147483648.0);
      } else {  // 8-bit offset binary
        v = (static_cast<float>(s[0]) - 128.0f) / 128.0f;
      }
      out->samples[static_cast<size_t>(c) * h.frames + t] = v;
    }
  }
  return true;
}

// ------------------------------------------------------- polyphase resample

double bessel_i0(double x) {
  // power series; converges fast for the beta range used here
  double sum = 1.0, term = 1.0;
  const double y = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= y / (static_cast<double>(k) * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// Identical filter to dsp/resample.py::_kaiser_sinc_kernel.
std::vector<double> kaiser_sinc_taps(int up, int down, int num_zeros,
                                     double beta) {
  const int m = up > down ? up : down;
  const double cutoff = 0.5 / m;
  const int half = num_zeros * m;
  const int n = 2 * half + 1;
  std::vector<double> taps(n);
  const double denom = bessel_i0(beta);
  for (int i = 0; i < n; ++i) {
    const double t = i - half;
    const double x = 2.0 * cutoff * t;
    const double sinc = x == 0.0 ? 1.0 : std::sin(kPi * x) / (kPi * x);
    // np.kaiser(n, beta): window over [0, n-1] centered at (n-1)/2
    const double r = 2.0 * i / (n - 1.0) - 1.0;
    const double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / denom;
    taps[i] = 2.0 * cutoff * sinc * w * up;
  }
  return taps;
}

// Matches dsp/resample.py::resample_poly: zero-stuff by `up`, convolve the
// symmetric Kaiser-sinc, take every `down`-th sample; out_len = ceil(L*up/down).
void resample_poly(const float* x, int len, int up, int down, int num_zeros,
                   double beta, float* out, int out_len) {
  if (up == down) {
    const int n = len < out_len ? len : out_len;
    std::memcpy(out, x, sizeof(float) * n);
    for (int i = n; i < out_len; ++i) out[i] = 0.0f;
    return;
  }
  const std::vector<double> taps = kaiser_sinc_taps(up, down, num_zeros, beta);
  const int half = (static_cast<int>(taps.size()) - 1) / 2;
  for (int m = 0; m < out_len; ++m) {
    // y[m] = sum_j taps[j] * u[m*down + half - j], u[q] = x[q/up] iff q%up==0
    const long q0 = static_cast<long>(m) * down + half;
    double acc = 0.0;
    // j such that (q0 - j) % up == 0  ->  j = q0 % up, q0 % up + up, ...
    for (long j = q0 % up; j < static_cast<long>(taps.size()); j += up) {
      const long q = (q0 - j) / up;
      if (q >= 0 && q < len) acc += taps[j] * x[q];
    }
    out[m] = static_cast<float>(acc);
  }
}

// ------------------------------------------------------------ STFT magnitude

// torch.stft(center=True, pad_mode='reflect') conventions, identical to
// dsp/stft.py: reflect pad by n_fft/2, Hann(win) periodic zero-padded to
// n_fft, T = 1 + L // hop, onesided F = n_fft/2 + 1 magnitudes. Each frame
// is one radix-2 FFT in float64 (n_fft a power of two), the window in
// float64 too, so the magnitudes are the float64 STFT's rounded to float32.
struct StftPlan {
  int n_fft, hop, win, n_freq;
  std::vector<double> window;        // n_fft
  std::vector<double> cos_t, sin_t;  // n_fft / 2 twiddles, cos/sin(2 pi k / n)
  std::vector<int> rev;              // bit-reversed frame index
};

bool is_pow2(int n) { return n >= 2 && (n & (n - 1)) == 0; }

StftPlan make_stft_plan(int n_fft, int hop, int win) {
  StftPlan p;
  p.n_fft = n_fft;
  p.hop = hop;
  p.win = win;
  p.n_freq = n_fft / 2 + 1;
  p.window.assign(n_fft, 0.0);
  const int left = (n_fft - win) / 2;
  for (int i = 0; i < win; ++i) {
    p.window[left + i] = 0.5 * (1.0 - std::cos(2.0 * kPi * i / win));
  }
  p.cos_t.resize(n_fft / 2);
  p.sin_t.resize(n_fft / 2);
  for (int k = 0; k < n_fft / 2; ++k) {
    p.cos_t[k] = std::cos(2.0 * kPi * k / n_fft);
    p.sin_t[k] = std::sin(2.0 * kPi * k / n_fft);
  }
  int bits = 0;
  while ((1 << bits) < n_fft) ++bits;
  p.rev.resize(n_fft);
  for (int i = 0; i < n_fft; ++i) {
    int r = 0;
    for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
    p.rev[i] = r;
  }
  return p;
}

inline float padded_sample(const float* x, int len, long i) {
  // numpy 'reflect' (no edge repeat) on [0, len); zeros beyond the padded
  // domain (the framing pads the tail with zeros, dsp/stft.py:97-99)
  if (len <= 0) return 0.0f;
  if (i < 0) i = -i;
  if (i >= len) {
    const long r = 2L * (len - 1) - i;
    if (r < 0) return 0.0f;
    i = r;
  }
  return x[i];
}

void stft_mag_one(const StftPlan& p, const float* x, int len, float* out,
                  int n_frames) {
  // out: (n_freq, n_frames), frequency-major to match (C, F, T) layouts
  const int n = p.n_fft;
  std::vector<double> re(n), im(n);
  const int pad = n / 2;
  for (int t = 0; t < n_frames; ++t) {
    const long start = static_cast<long>(t) * p.hop - pad;
    for (int i = 0; i < n; ++i) {
      re[p.rev[i]] =
          static_cast<double>(padded_sample(x, len, start + i)) * p.window[i];
      im[p.rev[i]] = 0.0;
    }
    // iterative decimation in time: X[k] = sum_i x[i] e^{-2 pi i k i / n}
    for (int size = 2; size <= n; size <<= 1) {
      const int half = size / 2, step = n / size;
      for (int s = 0; s < n; s += size) {
        for (int j = 0; j < half; ++j) {
          const double wr = p.cos_t[j * step], wi = -p.sin_t[j * step];
          const int a = s + j, b = a + half;
          const double tr = re[b] * wr - im[b] * wi;
          const double ti = re[b] * wi + im[b] * wr;
          re[b] = re[a] - tr;
          im[b] = im[a] - ti;
          re[a] += tr;
          im[a] += ti;
        }
      }
    }
    for (int k = 0; k < p.n_freq; ++k) {
      out[static_cast<size_t>(k) * n_frames + t] =
          static_cast<float>(std::sqrt(re[k] * re[k] + im[k] * im[k]));
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success. sr/frames/channels describe the file.
// Header-only: no sample decode (the batch processors decode once).
int neraf_wav_info(const char* path, int* sr, int* frames, int* channels) {
  try {
    WavHeader h;
    if (!parse_wav_header(path, &h)) return 1;
    *sr = h.sample_rate;
    *frames = h.frames;
    *channels = h.channels;
    return 0;
  } catch (...) {
    return 3;
  }
}

// out must hold frames*channels floats; layout channel-major [c][t].
int neraf_wav_read(const char* path, float* out, int capacity) {
  try {
    WavData w;
    if (!read_wav_file(path, &w)) return 1;
    const int n = w.frames * w.channels;
    if (n > capacity) return 2;
    std::memcpy(out, w.samples.data(), sizeof(float) * n);
    return 0;
  } catch (...) {
    return 3;
  }
}

int neraf_resample_poly(const float* x, int len, int up, int down,
                        int num_zeros, double beta, float* out, int out_len) {
  try {
    resample_poly(x, len, up, down, num_zeros, beta, out, out_len);
    return 0;
  } catch (...) {
    return 3;
  }
}

// x: (len,) signal. out: (n_freq, n_frames) magnitudes.
int neraf_stft_mag(const float* x, int len, int n_fft, int hop, int win,
                   float* out, int n_frames) {
  if (!is_pow2(n_fft)) return 4;
  try {
    const StftPlan p = make_stft_plan(n_fft, hop, win);
    stft_mag_one(p, x, len, out, n_frames);
    return 0;
  } catch (...) {
    return 3;
  }
}

// Batched RIR ingest (the DataLoader-worker replacement): for each path,
// read wav -> clip to [-1,1] -> (optional) resample to target_fs ->
// front-pad `front_pad` zeros -> zero-extend to >= min_samples ->
// (optional) truncate to max_samples -> STFT magnitudes per channel.
// out: (n, max_channels, n_freq, n_frames); absent channels zero-filled.
// channels_out: per-file channel count. do_clip: clamp samples to [-1,1]
// before processing (the SoundSpaces preprocess convention; the RAF loader
// does not clip). Returns count of failed files; -1 if n_fft is not a power
// of two.
int neraf_process_rir_batch(const char* const* paths, int n, int target_fs,
                            int n_fft, int hop, int win, int front_pad,
                            int min_samples, int max_samples, int max_channels,
                            int n_frames, int n_threads, int do_clip,
                            float* out, int* channels_out) {
  if (!is_pow2(n_fft)) return -1;
  const StftPlan plan = make_stft_plan(n_fft, hop, win);
  const int n_freq = plan.n_freq;
  std::vector<int> failures(n, 0);

  auto work = [&](int begin, int end) {
    for (int idx = begin; idx < end; ++idx) {
     try {
      WavData w;
      if (!read_wav_file(paths[idx], &w)) {
        failures[idx] = 1;
        channels_out[idx] = 0;
        continue;
      }
      const int C = w.channels < max_channels ? w.channels : max_channels;
      channels_out[idx] = C;
      for (int c = 0; c < C; ++c) {
        const float* ch = &w.samples[static_cast<size_t>(c) * w.frames];
        std::vector<float> sig(ch, ch + w.frames);
        if (do_clip) {
          for (float& v : sig) v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
        }
        if (target_fs > 0 && w.sample_rate != target_fs) {
          int g = 1;
          {  // gcd
            int a = target_fs, b = w.sample_rate;
            while (b) {
              const int t = a % b;
              a = b;
              b = t;
            }
            g = a;
          }
          const int up = target_fs / g, down = w.sample_rate / g;
          const long out_len =
              (static_cast<long>(sig.size()) * up + down - 1) / down;
          std::vector<float> res(out_len);
          resample_poly(sig.data(), static_cast<int>(sig.size()), up, down,
                        24, 8.555, res.data(), static_cast<int>(out_len));
          sig.swap(res);
        }
        if (front_pad > 0) sig.insert(sig.begin(), front_pad, 0.0f);
        if (static_cast<int>(sig.size()) < min_samples)
          sig.resize(min_samples, 0.0f);
        if (max_samples > 0 && static_cast<int>(sig.size()) > max_samples)
          sig.resize(max_samples);

        const int T_sig = 1 + static_cast<int>(sig.size()) / hop;
        const int T = T_sig < n_frames ? T_sig : n_frames;
        std::vector<float> mag(static_cast<size_t>(n_freq) * T);
        stft_mag_one(plan, sig.data(), static_cast<int>(sig.size()),
                     mag.data(), T);
        float* dst = out + ((static_cast<size_t>(idx) * max_channels + c) *
                            n_freq) * n_frames;
        for (int k = 0; k < n_freq; ++k) {
          std::memcpy(dst + static_cast<size_t>(k) * n_frames,
                      &mag[static_cast<size_t>(k) * T], sizeof(float) * T);
          for (int t = T; t < n_frames; ++t)
            dst[static_cast<size_t>(k) * n_frames + t] = 0.0f;
        }
      }
      // zero absent channels
      for (int c = C; c < max_channels; ++c) {
        float* dst = out + ((static_cast<size_t>(idx) * max_channels + c) *
                            n_freq) * n_frames;
        std::memset(dst, 0, sizeof(float) * n_freq * n_frames);
      }
     } catch (...) {  // never let an exception cross the thread boundary
       failures[idx] = 1;
       channels_out[idx] = 0;
     }
    }
  };

  if (n_threads <= 1 || n <= 1) {
    work(0, n);
  } else {
    const int k = n_threads < n ? n_threads : n;
    std::vector<std::thread> pool;
    const int per = (n + k - 1) / k;
    for (int i = 0; i < k; ++i) {
      const int b = i * per;
      const int e = (b + per) < n ? (b + per) : n;
      if (b >= e) break;
      pool.emplace_back(work, b, e);
    }
    for (auto& t : pool) t.join();
  }

  int failed = 0;
  for (int i = 0; i < n; ++i) failed += failures[i];
  return failed;
}

}  // extern "C"
