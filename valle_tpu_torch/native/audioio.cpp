// Native audio I/O + resampling for valle_tpu_torch (a copy of the JAX
// package's valle_tpu/native/audioio.cpp: the port imports nothing of it).
//
// Replaces the reference's torchaudio/sox C++ path (reference
// valle/data/tokenizer.py:22,245-254 loads wavs with torchaudio and
// resamples to 24 kHz mono via encodec.utils.convert_audio). Exposed to
// Python over a minimal C ABI (ctypes) — no pybind11 dependency.
//
// Components:
//   - RIFF/WAVE reader: PCM 8/16/24/32-bit and IEEE float32/64 -> float32
//   - WAVE writer: PCM16 or float32
//   - windowed-sinc polyphase resampler (Kaiser window), julius-style
//     parameters (zeros=24, rolloff 0.945) like the encodec/julius
//     resampler the reference uses
//   - channel mixdown to mono
//
// Built with g++ at first use by valle_tpu_torch/native/__init__.py into
// build/valle_tpu_torch/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// WAV reading
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int64_t frames;      // samples per channel
  int32_t format;      // 1 = PCM, 3 = IEEE float
  int32_t bits;
};

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Returns 0 on success. On success *out is malloc'd interleaved float32
// (frames * channels); caller frees with valle_free.
int valle_read_wav(const char* path, float** out, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return -2;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  std::vector<uint8_t> data;
  bool got_fmt = false, got_data = false;
  uint8_t chdr[8];
  while (fread(chdr, 1, 8, f) == 8) {
    uint32_t sz = rd_u32(chdr + 4);
    if (!memcmp(chdr, "fmt ", 4)) {
      if (sz < 16) { fclose(f); return -3; }  // truncated fmt chunk
      std::vector<uint8_t> buf(sz);
      if (fread(buf.data(), 1, sz, f) != sz) { fclose(f); return -3; }
      fmt = rd_u16(&buf[0]);
      channels = rd_u16(&buf[2]);
      sample_rate = rd_u32(&buf[4]);
      bits = rd_u16(&buf[14]);
      if (fmt == 0xFFFE && sz >= 40) fmt = rd_u16(&buf[24]);  // extensible
      got_fmt = true;
    } else if (!memcmp(chdr, "data", 4)) {
      // clamp the untrusted chunk size to the remaining file bytes:
      // streaming writers emit 0xFFFFFFFF sizes, and resize(4GB) would
      // throw bad_alloc through the extern "C" boundary (std::terminate)
      long at = ftell(f);
      fseek(f, 0, SEEK_END);
      long remain = ftell(f) - at;
      fseek(f, at, SEEK_SET);
      if (remain < 0) remain = 0;
      if ((uint64_t)sz > (uint64_t)remain) sz = (uint32_t)remain;
      data.resize(sz);
      size_t got = fread(data.data(), 1, sz, f);
      data.resize(got);
      got_data = true;
    } else {
      fseek(f, (long)(sz + (sz & 1)), SEEK_CUR);
      continue;
    }
    if (sz & 1) fseek(f, 1, SEEK_CUR);
  }
  fclose(f);
  if (!got_fmt || !got_data || channels == 0 || bits == 0) return -4;
  if (fmt != 1 && fmt != 3) return -5;

  const size_t bytes_per = bits / 8;
  const int64_t total = (int64_t)(data.size() / bytes_per);
  const int64_t frames = total / channels;
  float* buf = (float*)malloc(sizeof(float) * (size_t)total);
  if (!buf) return -6;

  const uint8_t* p = data.data();
  for (int64_t i = 0; i < total; i++) {
    float v = 0.f;
    if (fmt == 1 && bits == 16) {
      int16_t s = (int16_t)rd_u16(p + i * 2);
      v = (float)s / 32768.0f;
    } else if (fmt == 1 && bits == 24) {
      int32_t s = (int32_t)((uint32_t)p[i * 3] | ((uint32_t)p[i * 3 + 1] << 8) |
                            ((uint32_t)p[i * 3 + 2] << 16));
      if (s & 0x800000) s |= ~0xFFFFFF;
      v = (float)s / 8388608.0f;
    } else if (fmt == 1 && bits == 32) {
      int32_t s; memcpy(&s, p + i * 4, 4);
      v = (float)((double)s / 2147483648.0);
    } else if (fmt == 1 && bits == 8) {
      v = ((float)p[i] - 128.0f) / 128.0f;
    } else if (fmt == 3 && bits == 32) {
      memcpy(&v, p + i * 4, 4);
    } else if (fmt == 3 && bits == 64) {
      double d; memcpy(&d, p + i * 8, 8);
      v = (float)d;
    } else {
      free(buf);
      return -7;
    }
    buf[i] = v;
  }
  *out = buf;
  info->sample_rate = (int32_t)sample_rate;
  info->channels = channels;
  info->frames = frames;
  info->format = fmt;
  info->bits = bits;
  return 0;
}

void valle_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// WAV writing (interleaved float32 in [-1,1] -> PCM16 or float32)
// ---------------------------------------------------------------------------

static void wr_u32(FILE* f, uint32_t v) {
  uint8_t b[4] = {(uint8_t)v, (uint8_t)(v >> 8), (uint8_t)(v >> 16),
                  (uint8_t)(v >> 24)};
  fwrite(b, 1, 4, f);
}
static void wr_u16(FILE* f, uint16_t v) {
  uint8_t b[2] = {(uint8_t)v, (uint8_t)(v >> 8)};
  fwrite(b, 1, 2, f);
}

int valle_write_wav(const char* path, const float* data, int64_t frames,
                    int32_t channels, int32_t sample_rate, int32_t bits) {
  if (bits != 16 && bits != 32) return -1;
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  const uint16_t fmt = (bits == 32) ? 3 : 1;
  const bool ieee = (fmt == 3);
  const uint32_t data_bytes = (uint32_t)(frames * channels * (bits / 8));
  // WAVE_FORMAT_IEEE_FLOAT conformance: non-PCM formats carry cbSize
  // (fmt chunk size 18) and a 'fact' chunk with the sample-frame count
  const uint32_t fmt_sz = ieee ? 18 : 16;
  const uint32_t extra = ieee ? (2 /*cbSize*/ + 12 /*fact*/) : 0;
  fwrite("RIFF", 1, 4, f);
  wr_u32(f, 36 + extra + data_bytes);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  wr_u32(f, fmt_sz);
  wr_u16(f, fmt);
  wr_u16(f, (uint16_t)channels);
  wr_u32(f, (uint32_t)sample_rate);
  wr_u32(f, (uint32_t)(sample_rate * channels * (bits / 8)));
  wr_u16(f, (uint16_t)(channels * (bits / 8)));
  wr_u16(f, (uint16_t)bits);
  if (ieee) {
    wr_u16(f, 0);                 // cbSize
    fwrite("fact", 1, 4, f);
    wr_u32(f, 4);
    wr_u32(f, (uint32_t)frames);
  }
  fwrite("data", 1, 4, f);
  wr_u32(f, data_bytes);
  const int64_t total = frames * channels;
  if (bits == 16) {
    for (int64_t i = 0; i < total; i++) {
      float v = data[i];
      v = std::max(-1.0f, std::min(1.0f, v));
      int16_t s = (int16_t)lrintf(v * 32767.0f);
      uint8_t b[2] = {(uint8_t)(uint16_t)s, (uint8_t)((uint16_t)s >> 8)};
      fwrite(b, 1, 2, f);
    }
  } else {
    fwrite(data, sizeof(float), (size_t)total, f);
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Mixdown
// ---------------------------------------------------------------------------

void valle_to_mono(const float* in, int64_t frames, int32_t channels,
                   float* out) {
  for (int64_t t = 0; t < frames; t++) {
    float acc = 0.f;
    for (int32_t c = 0; c < channels; c++) acc += in[t * channels + c];
    out[t] = acc / (float)channels;
  }
}

// ---------------------------------------------------------------------------
// Windowed-sinc polyphase resampler (Kaiser window)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; k++) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) { int64_t t = a % b; a = b; b = t; }
  return a;
}

int64_t valle_resample_out_len(int64_t n_in, int32_t sr_in, int32_t sr_out) {
  return (int64_t)((__int128)n_in * sr_out + sr_in - 1) / sr_in;  // ceil
}

// Mono resample. out must have valle_resample_out_len capacity.
// zeros: half-width in zero crossings (24 == julius/encodec default);
// rolloff keeps the transition band below Nyquist.
int valle_resample(const float* in, int64_t n_in, int32_t sr_in,
                   int32_t sr_out, float* out, int32_t zeros,
                   double rolloff, double beta) {
  if (sr_in == sr_out) {
    memcpy(out, in, sizeof(float) * (size_t)n_in);
    return 0;
  }
  int64_t g = gcd64(sr_in, sr_out);
  const int64_t up = sr_out / g, down = sr_in / g;
  const double ratio = (double)up / (double)down;
  const double cutoff = rolloff * 0.5 * std::min(1.0, ratio);
  // kernel half width in INPUT samples
  const double half_width = (double)zeros / (2.0 * cutoff);
  const int64_t n_out = valle_resample_out_len(n_in, sr_in, sr_out);
  const double i0b = bessel_i0(beta);

  // For each output sample t_out, input time = t_out * down / up.
  // Phase-dependent kernels: phase p = (t_out * down) % up.
  std::vector<std::vector<float>> kernels((size_t)up);
  std::vector<int64_t> offsets((size_t)up);
  for (int64_t p = 0; p < up; p++) {
    // output index t with t*down % up == p sits at input position
    // floor(t*down/up) + p/up
    const double frac = (double)p / (double)up;
    // input center = integer part + frac
    const int64_t lo = (int64_t)floor(frac - half_width) + 1;
    const int64_t hi = (int64_t)ceil(frac + half_width) - 1;
    offsets[(size_t)p] = lo;
    std::vector<float>& k = kernels[(size_t)p];
    k.resize((size_t)(hi - lo + 1));
    double sum = 0.0;
    for (int64_t j = lo; j <= hi; j++) {
      const double x = ((double)j - frac);  // distance in input samples
      const double t = x / half_width;      // [-1, 1]
      double w = 0.0;
      if (t > -1.0 && t < 1.0) w = bessel_i0(beta * sqrt(1.0 - t * t)) / i0b;
      const double arg = 2.0 * M_PI * x * cutoff;
      const double s = (fabs(arg) < 1e-12) ? 1.0 : sin(arg) / arg;
      const double v = 2.0 * cutoff * w * s;
      k[(size_t)(j - lo)] = (float)v;
      sum += v;
    }
    // normalize DC gain to 1
    if (sum != 0.0)
      for (auto& v : k) v = (float)(v / sum);
  }

  for (int64_t t = 0; t < n_out; t++) {
    const int64_t num = t * down;
    const int64_t base = num / up;          // integer input index
    const int64_t phase = num % up;
    const std::vector<float>& k = kernels[(size_t)phase];
    const int64_t lo = offsets[(size_t)phase];
    double acc = 0.0;
    for (size_t j = 0; j < k.size(); j++) {
      int64_t idx = base + lo + (int64_t)j;
      if (idx < 0) idx = 0;                  // edge: replicate
      if (idx >= n_in) idx = n_in - 1;
      acc += (double)k[j] * (double)in[idx];
    }
    out[t] = (float)acc;
  }
  return 0;
}

}  // extern "C"
