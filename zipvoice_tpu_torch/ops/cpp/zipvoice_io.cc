// Native audio-IO runtime for the TPU data pipeline.
//
// The training input path is host-bound: every batch reads O(100) wav files,
// converts PCM -> float32, downmixes, and resamples to 24 kHz before the
// device fbank program runs.  The reference delegates this to torchaudio /
// lhotse (C++ inside); this library is the equivalent native component for
// the rebuild: a thread-pooled batch WAV decoder + windowed-sinc polyphase
// resampler, exposed through a C ABI consumed via ctypes
// (zipvoice_tpu/ops/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libzipvoice_io.so zipvoice_io.cc -lpthread

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Wav {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sample_rate = 0;
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

Wav decode_wav(const std::string& path) {
  Wav w;
  std::ifstream f(path, std::ios::binary);
  if (!f) return w;
  std::vector<uint8_t> data((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  if (data.size() < 44 || std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return w;

  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* body = nullptr;
  size_t body_size = 0;
  while (pos + 8 <= data.size()) {
    const uint8_t* cid = data.data() + pos;
    uint32_t size = rd_u32(data.data() + pos + 4);
    if (pos + 8 + size > data.size()) size = data.size() - pos - 8;
    if (std::memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
      fmt = rd_u16(data.data() + pos + 8);
      channels = rd_u16(data.data() + pos + 10);
      rate = rd_u32(data.data() + pos + 12);
      bits = rd_u16(data.data() + pos + 22);
      if (fmt == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: the real format code is the first word
        // of the SubFormat GUID at fmt-chunk offset 24
        uint16_t sub = (size >= 26) ? rd_u16(data.data() + pos + 8 + 24) : 1;
        fmt = (sub == 3) ? 3 : 1;
      }
    } else if (std::memcmp(cid, "data", 4) == 0) {
      body = data.data() + pos + 8;
      body_size = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!body || channels == 0) return w;

  size_t n = 0;
  if (fmt == 1 && bits == 16) {
    n = body_size / 2;
    w.samples.resize(n);
    for (size_t i = 0; i < n; ++i) {
      int16_t v;
      std::memcpy(&v, body + 2 * i, 2);
      w.samples[i] = static_cast<float>(v) / 32768.0f;
    }
  } else if (fmt == 1 && bits == 24) {
    n = body_size / 3;
    w.samples.resize(n);
    for (size_t i = 0; i < n; ++i) {
      int32_t v = body[3 * i] | (body[3 * i + 1] << 8) |
                  (static_cast<int8_t>(body[3 * i + 2]) << 16);
      w.samples[i] = static_cast<float>(v) / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 32) {
    n = body_size / 4;
    w.samples.resize(n);
    for (size_t i = 0; i < n; ++i) {
      int32_t v;
      std::memcpy(&v, body + 4 * i, 4);
      w.samples[i] = static_cast<float>(v) / 2147483648.0f;
    }
  } else if (fmt == 3 && bits == 32) {
    n = body_size / 4;
    w.samples.resize(n);
    std::memcpy(w.samples.data(), body, n * 4);
  } else {
    return w;
  }
  w.channels = channels;
  w.sample_rate = static_cast<int>(rate);
  w.ok = true;
  return w;
}

// Windowed-sinc polyphase resampler (Hann window, zero-phase), mono input.
std::vector<float> resample_mono(const std::vector<float>& x, int sr_in,
                                 int sr_out, int half_taps = 64) {
  if (sr_in == sr_out) return x;
  int g = 1;
  {  // gcd
    int a = sr_in, b = sr_out;
    while (b) { int t = a % b; a = b; b = t; }
    g = a;
  }
  const int up = sr_out / g, down = sr_in / g;
  const double cutoff = 0.5 / std::max(up, down);
  const int taps_per_phase = 2 * half_taps;
  // filter h[k] = sinc windowed, length up * taps_per_phase (phase-major)
  std::vector<float> h(static_cast<size_t>(up) * taps_per_phase);
  const int total = up * taps_per_phase;
  for (int i = 0; i < total; ++i) {
    const double t = (i - total / 2) * cutoff * 2.0;
    const double sinc = (t == 0.0) ? 1.0 : std::sin(kPi * t) / (kPi * t);
    const double win = 0.5 - 0.5 * std::cos(2.0 * kPi * i / (total - 1));
    h[i] = static_cast<float>(sinc * win * cutoff * 2.0 * up);
  }
  const int64_t n_out =
      (static_cast<int64_t>(x.size()) * up + down - 1) / down;
  std::vector<float> y(n_out, 0.0f);
  const int center = total / 2;
  for (int64_t m = 0; m < n_out; ++m) {
    // output sample m corresponds to input position m*down/up
    const int64_t num = m * down;
    const int64_t in_center = num / up;
    const int phase = static_cast<int>(num % up);
    double acc = 0.0;
    // h index for input sample j: center + phase - (j - in_center)*up
    for (int k = -half_taps; k < half_taps; ++k) {
      const int64_t j = in_center + k;
      if (j < 0 || j >= static_cast<int64_t>(x.size())) continue;
      const int hi = center + phase - k * up;
      if (hi < 0 || hi >= total) continue;
      acc += static_cast<double>(x[j]) * h[hi];
    }
    y[m] = static_cast<float>(acc);
  }
  return y;
}

}  // namespace

extern "C" {

// Decode + downmix + resample a batch of wav files in parallel.
//
//   paths:        num_files zero-terminated strings, concatenated
//   path_offsets: start offset of each path in `paths`
//   target_sr:    output rate (0 = keep native rate; mixed rates then error)
//   out:          caller buffer, num_files * max_len floats (zero padded)
//   out_lens:     per-file output sample counts (0 on failure)
//   num_threads:  worker threads (<=0: hardware concurrency)
//
// Returns 0 on success, -1 if any file failed.
int batch_load_wav(const char* paths, const int64_t* path_offsets,
                   int num_files, int target_sr, float* out, int64_t max_len,
                   int64_t* out_lens, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= num_files) break;
      const std::string path(paths + path_offsets[i]);
      Wav w = decode_wav(path);
      if (!w.ok) {
        out_lens[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      const size_t frames = w.samples.size() / w.channels;
      std::vector<float> mono(frames);
      if (w.channels == 1) {
        mono = std::move(w.samples);
      } else {
        for (size_t t = 0; t < frames; ++t) {
          float acc = 0.0f;
          for (int c = 0; c < w.channels; ++c)
            acc += w.samples[t * w.channels + c];
          mono[t] = acc / static_cast<float>(w.channels);
        }
      }
      if (target_sr > 0 && w.sample_rate != target_sr)
        mono = resample_mono(mono, w.sample_rate, target_sr);
      const int64_t n =
          std::min<int64_t>(static_cast<int64_t>(mono.size()), max_len);
      std::memcpy(out + static_cast<int64_t>(i) * max_len, mono.data(),
                  n * sizeof(float));
      if (n < max_len)
        std::memset(out + static_cast<int64_t>(i) * max_len + n, 0,
                    (max_len - n) * sizeof(float));
      out_lens[i] = n;
    }
  };

  int nthreads = num_threads > 0
                     ? num_threads
                     : static_cast<int>(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, num_files));
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load() ? -1 : 0;
}

// Single-file variants for probing / testing.
int wav_info(const char* path, int* sample_rate, int* channels,
             int64_t* num_frames) {
  Wav w = decode_wav(path);
  if (!w.ok) return -1;
  *sample_rate = w.sample_rate;
  *channels = w.channels;
  *num_frames = static_cast<int64_t>(w.samples.size()) / w.channels;
  return 0;
}

int resample_f32(const float* x, int64_t n, int sr_in, int sr_out, float* out,
                 int64_t out_cap, int64_t* out_n) {
  std::vector<float> xin(x, x + n);
  std::vector<float> y = resample_mono(xin, sr_in, sr_out);
  const int64_t m = std::min<int64_t>(static_cast<int64_t>(y.size()), out_cap);
  std::memcpy(out, y.data(), m * sizeof(float));
  *out_n = m;
  return 0;
}

}  // extern "C"
