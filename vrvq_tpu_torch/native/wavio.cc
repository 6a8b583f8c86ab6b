// Native WAV reader and BS.1770 loudness meter for the training data
// pipeline of vrvq_tpu_torch: the port's copy of the JAX package's wavio.cc,
// with the same extern "C" API.
//
// The dataloader decodes many small random excerpts per second across
// loader threads. This library does seek-exact excerpt reads of PCM/float
// WAVs with zero Python overhead; vrvq_tpu_torch/native/io.py builds it with
// g++ at first use, binds it via ctypes, and the numpy parser of
// vrvq_tpu_torch/data/audio_io.py serves where it cannot be built.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <cmath>

namespace {

struct WavFmt {
  uint16_t audio_format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = -1;
  long data_size = 0;
};

bool parse_header(FILE* f, WavFmt* out) {
  unsigned char riff[12];
  if (fread(riff, 1, 12, f) != 12) return false;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0)
    return false;

  bool have_fmt = false, have_data = false;
  while (!(have_fmt && have_data)) {
    unsigned char hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, hdr + 4, 4);
    if (memcmp(hdr, "fmt ", 4) == 0) {
      unsigned char buf[64];
      size_t n = std::min<size_t>(size, sizeof(buf));
      if (fread(buf, 1, n, f) != n) return false;
      if (size > n && fseek(f, (long)(size - n), SEEK_CUR) != 0) return false;
      memcpy(&out->audio_format, buf + 0, 2);
      memcpy(&out->channels, buf + 2, 2);
      memcpy(&out->sample_rate, buf + 4, 4);
      memcpy(&out->bits, buf + 14, 2);
      // WAVE_FORMAT_EXTENSIBLE: real format lives in the extension
      if (out->audio_format == 0xFFFE && size >= 40)
        memcpy(&out->audio_format, buf + 24, 2);
      if (size % 2 && fseek(f, 1, SEEK_CUR) != 0) return false;
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      out->data_offset = ftell(f);
      out->data_size = (long)size;
      if (fseek(f, (long)size + (size % 2), SEEK_CUR) != 0) return false;
      have_data = true;
    } else {
      if (fseek(f, (long)size + (size % 2), SEEK_CUR) != 0) return false;
    }
  }
  return have_fmt && have_data;
}

inline float pcm16(const unsigned char* p) {
  int16_t v;
  memcpy(&v, p, 2);
  return (float)v / 32768.0f;
}

inline float pcm24(const unsigned char* p) {
  int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
  if (v >= (1 << 23)) v -= (1 << 24);
  return (float)v / 8388608.0f;
}

inline float pcm32(const unsigned char* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return (float)v / 2147483648.0f;
}

}  // namespace

extern "C" {

// Returns 0 on success.
int vrvqio_wav_info(const char* path, int* sample_rate, int* channels,
                    long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  WavFmt fmt;
  bool ok = parse_header(f, &fmt);
  fclose(f);
  if (!ok || fmt.channels == 0 || fmt.bits == 0) return 2;
  *sample_rate = (int)fmt.sample_rate;
  *channels = (int)fmt.channels;
  *frames = fmt.data_size / (fmt.channels * (fmt.bits / 8));
  return 0;
}

// Reads interleaved float32 frames into out (capacity cap floats).
// duration < 0 reads to EOF. Returns 0 on success.
int vrvqio_read_wav(const char* path, double offset, double duration,
                    float* out, long cap, int* sample_rate, int* channels,
                    long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  WavFmt fmt;
  if (!parse_header(f, &fmt) || fmt.channels == 0 || fmt.bits == 0) {
    fclose(f);
    return 2;
  }
  const int bytes_per_sample = fmt.bits / 8;
  const long frame_bytes = (long)fmt.channels * bytes_per_sample;
  const long total_frames = fmt.data_size / frame_bytes;

  long start = (long)(offset * fmt.sample_rate + 0.5);
  long want = duration < 0
                  ? total_frames - start
                  : (long)(duration * fmt.sample_rate + 0.5);
  want = std::max(0L, std::min(want, total_frames - start));
  if (want * fmt.channels > cap) want = cap / fmt.channels;

  if (fseek(f, fmt.data_offset + start * frame_bytes, SEEK_SET) != 0) {
    fclose(f);
    return 3;
  }

  const long n_bytes = want * frame_bytes;
  unsigned char* raw = (unsigned char*)malloc(n_bytes > 0 ? n_bytes : 1);
  long got = (long)fread(raw, 1, n_bytes, f);
  fclose(f);
  const long got_frames = got / frame_bytes;
  const long n = got_frames * fmt.channels;

  if (fmt.audio_format == 1) {  // integer PCM
    switch (fmt.bits) {
      case 16:
        for (long i = 0; i < n; ++i) out[i] = pcm16(raw + i * 2);
        break;
      case 24:
        for (long i = 0; i < n; ++i) out[i] = pcm24(raw + i * 3);
        break;
      case 32:
        for (long i = 0; i < n; ++i) out[i] = pcm32(raw + i * 4);
        break;
      case 8:
        for (long i = 0; i < n; ++i)
          out[i] = ((float)raw[i] - 128.0f) / 128.0f;
        break;
      default:
        free(raw);
        return 4;
    }
  } else if (fmt.audio_format == 3) {  // IEEE float
    if (fmt.bits == 32) {
      memcpy(out, raw, n * 4);
    } else if (fmt.bits == 64) {
      const double* d = (const double*)raw;
      for (long i = 0; i < n; ++i) out[i] = (float)d[i];
    } else {
      free(raw);
      return 4;
    }
  } else {
    free(raw);
    return 4;
  }

  free(raw);
  *sample_rate = (int)fmt.sample_rate;
  *channels = (int)fmt.channels;
  *frames = got_frames;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BS.1770-4 integrated loudness (K-weighting + absolute/relative gating).
// The salient-excerpt dataloader calls loudness once per candidate excerpt
// (reference data/loaders.py:81-86); the scipy implementation costs ~1 ms
// per 0.38 s clip, which at batch 64 x up to 8 tries rivals the train step.
// This C++ path is ~30x faster and GIL-free.

extern "C" {

// audio: interleaved (frames x channels) float32. Returns LUFS or -1e9 on
// silence/error.
double vrvqio_loudness(const float* audio, long frames, int channels,
                       int sample_rate, double block_size) {
  if (frames <= 0 || channels <= 0) return -1e9;
  const double fs = (double)sample_rate;
  const double pi = 3.14159265358979323846;

  // Stage 1: spherical-head high shelf (BS.1770-4 pre-filter)
  double f0 = 1681.9744509555319, G = 3.99984385397917,
         Q = 0.7071752369554193;
  double K = tan(pi * f0 / fs);
  double Vh = pow(10.0, G / 20.0);
  double Vb = pow(Vh, 0.499666774155);
  double a0 = 1.0 + K / Q + K * K;
  const double sb0 = (Vh + Vb * K / Q + K * K) / a0;
  const double sb1 = 2.0 * (K * K - Vh) / a0;
  const double sb2 = (Vh - Vb * K / Q + K * K) / a0;
  const double sa1 = 2.0 * (K * K - 1.0) / a0;
  const double sa2 = (1.0 - K / Q + K * K) / a0;

  // Stage 2: high pass
  f0 = 38.13547087613982;
  Q = 0.5003270373253953;
  K = tan(pi * f0 / fs);
  a0 = 1.0 + K / Q + K * K;
  const double ha1 = 2.0 * (K * K - 1.0) / a0;
  const double ha2 = (1.0 - K / Q + K * K) / a0;

  long block = (long)(block_size * fs);
  if (block <= 0) return -1e9;
  long padded = frames < block ? block : frames;
  long hop = block / 4;
  long n_blocks = 1 + (padded - block) / hop;
  if (n_blocks < 1) n_blocks = 1;

  // per-channel filtered energy accumulation per block
  double* zw = (double*)calloc(n_blocks, sizeof(double));

  for (int c = 0; c < channels; ++c) {
    double x1 = 0, x2 = 0, y1 = 0, y2 = 0;   // shelf state
    double u1 = 0, u2 = 0, v1 = 0, v2 = 0;   // hp state
    // running filtered signal with square accumulation into blocks via
    // prefix sums
    double* sq = (double*)malloc(sizeof(double) * (padded + 1));
    sq[0] = 0.0;
    for (long i = 0; i < padded; ++i) {
      double x = i < frames ? (double)audio[i * channels + c] : 0.0;
      double y = sb0 * x + sb1 * x1 + sb2 * x2 - sa1 * y1 - sa2 * y2;
      x2 = x1; x1 = x; y2 = y1; y1 = y;
      double v = y - 2.0 * u1 + u2 - ha1 * v1 - ha2 * v2;
      u2 = u1; u1 = y; v2 = v1; v1 = v;
      sq[i + 1] = sq[i] + v * v;
    }
    double g = (channels >= 4 && c >= 3) ? 1.41 : 1.0;
    for (long b = 0; b < n_blocks; ++b) {
      long s = b * hop;
      zw[b] += g * (sq[s + block] - sq[s]) / (double)block;
    }
    free(sq);
  }

  // gating
  double z_abs = 0.0;
  long n_abs = 0;
  for (long b = 0; b < n_blocks; ++b) {
    double lb = -0.691 + 10.0 * log10(zw[b] > 1e-12 ? zw[b] : 1e-12);
    if (lb > -70.0) { z_abs += zw[b]; ++n_abs; }
  }
  if (n_abs == 0) { free(zw); return -1e9; }
  double rel = -0.691 + 10.0 * log10(z_abs / n_abs) - 10.0;
  double z_gated = 0.0;
  long n_gated = 0;
  for (long b = 0; b < n_blocks; ++b) {
    double lb = -0.691 + 10.0 * log10(zw[b] > 1e-12 ? zw[b] : 1e-12);
    if (lb > -70.0 && lb > rel) { z_gated += zw[b]; ++n_gated; }
  }
  free(zw);
  if (n_gated == 0) return -1e9;
  return -0.691 + 10.0 * log10(z_gated / n_gated);
}

}  // extern "C"
