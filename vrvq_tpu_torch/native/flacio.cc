// Native FLAC decoder for the training data pipeline of vrvq_tpu_torch: the
// port's copy of the JAX package's flacio.cc, with the same extern "C" API.
//
// Twin of the pure-Python decoder in vrvq_tpu_torch/data/flac_py.py (the
// plain version, held bit for bit against this one in
// tests/test_torch_native_io.py): STREAMINFO, frame headers with UTF-8 coded
// numbers and CRC-8 verification, constant / verbatim / fixed / LPC
// subframes, Rice/Rice2 partitioned residuals, wasted bits, and the four
// channel assignments. No external dependencies; vrvq_tpu_torch/native/io.py
// builds it with g++ at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <vector>

namespace {

struct FlacStreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits = 0;
  uint64_t total_samples = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  bool read(int n, uint64_t* out) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      size_t byte = pos_ >> 3;
      if (byte >= size_) return false;
      int bit = 7 - (pos_ & 7);
      v = (v << 1) | ((data_[byte] >> bit) & 1);
      ++pos_;
    }
    *out = v;
    return true;
  }

  bool read_signed(int n, int64_t* out) {
    uint64_t v;
    if (!read(n, &v)) return false;
    if (n > 0 && (v >> (n - 1)) & 1) {
      *out = (int64_t)(v - ((uint64_t)1 << n));
    } else {
      *out = (int64_t)v;
    }
    return true;
  }

  bool unary(uint32_t* out) {
    uint32_t q = 0;
    for (;;) {
      size_t byte = pos_ >> 3;
      if (byte >= size_) return false;
      int bit = 7 - (pos_ & 7);
      ++pos_;
      if ((data_[byte] >> bit) & 1) break;
      ++q;
    }
    *out = q;
    return true;
  }

  void align() { pos_ = (pos_ + 7) & ~(size_t)7; }
  size_t byte_pos() const { return pos_ >> 3; }
  bool eof() const { return pos_ >= size_ * 8; }
  size_t bits_left() const { return size_ * 8 - pos_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
};

uint8_t crc8(const uint8_t* data, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= data[i];
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

bool parse_streaminfo(FILE* f, FlacStreamInfo* info, long* first_frame) {
  unsigned char magic[4];
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "fLaC", 4) != 0) return false;
  bool have_info = false;
  for (;;) {
    unsigned char hdr[4];
    if (fread(hdr, 1, 4, f) != 4) return false;
    bool last = hdr[0] & 0x80;
    int type = hdr[0] & 0x7F;
    uint32_t size = ((uint32_t)hdr[1] << 16) | ((uint32_t)hdr[2] << 8) | hdr[3];
    if (type == 0 && size >= 34) {
      unsigned char si[34];
      if (fread(si, 1, 34, f) != 34) return false;
      if (size > 34) fseek(f, size - 34, SEEK_CUR);
      BitReader br(si, 34);
      uint64_t v;
      br.read(16, &v);  // min block
      br.read(16, &v);  // max block
      br.read(24, &v);
      br.read(24, &v);
      br.read(20, &v); info->sample_rate = (uint32_t)v;
      br.read(3, &v); info->channels = (int)v + 1;
      br.read(5, &v); info->bits = (int)v + 1;
      br.read(36, &v); info->total_samples = v;
      have_info = true;
    } else {
      fseek(f, size, SEEK_CUR);
    }
    if (last) break;
  }
  if (!have_info) return false;
  *first_frame = ftell(f);
  return true;
}

const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kFixedOrders = 5;
const int kFixedCoefs[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

bool read_utf8_number(BitReader* br, uint64_t* out) {
  uint64_t b0;
  if (!br->read(8, &b0)) return false;
  if (b0 < 0x80) { *out = b0; return true; }
  int n = 0;
  uint64_t mask = 0x40;
  while (b0 & mask) { ++n; mask >>= 1; }
  uint64_t val = b0 & (mask - 1);
  for (int i = 0; i < n; ++i) {
    uint64_t c;
    if (!br->read(8, &c)) return false;
    val = (val << 6) | (c & 0x3F);
  }
  *out = val;
  return true;
}

bool decode_residual(BitReader* br, int block_size, int order,
                     int64_t* out /* block_size - order */) {
  uint64_t method, po;
  if (!br->read(2, &method) || method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint64_t escape = ((uint64_t)1 << plen) - 1;
  if (!br->read(4, &po)) return false;
  int nparts = 1 << po;
  if (block_size % nparts) return false;
  int idx = 0;
  for (int p = 0; p < nparts; ++p) {
    int n = (block_size >> po) - (p == 0 ? order : 0);
    uint64_t param;
    if (!br->read(plen, &param)) return false;
    if (param == escape) {
      uint64_t raw;
      if (!br->read(5, &raw)) return false;
      for (int i = 0; i < n; ++i) {
        int64_t v = 0;
        if (raw && !br->read_signed((int)raw, &v)) return false;
        out[idx++] = v;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        uint32_t q;
        uint64_t r = 0;
        if (!br->unary(&q)) return false;
        if (param && !br->read((int)param, &r)) return false;
        uint64_t v = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
  }
  return true;
}

bool decode_subframe(BitReader* br, int block_size, int bps,
                     std::vector<int64_t>* out) {
  uint64_t pad, stype, wflag;
  if (!br->read(1, &pad) || pad) return false;
  if (!br->read(6, &stype)) return false;
  if (!br->read(1, &wflag)) return false;
  int wasted = 0;
  if (wflag) {
    uint32_t k;
    if (!br->unary(&k)) return false;
    wasted = (int)k + 1;
    bps -= wasted;
  }
  out->assign(block_size, 0);
  int64_t* x = out->data();

  if (stype == 0) {  // constant
    int64_t v;
    if (!br->read_signed(bps, &v)) return false;
    for (int i = 0; i < block_size; ++i) x[i] = v;
  } else if (stype == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i)
      if (!br->read_signed(bps, &x[i])) return false;
  } else if (stype >= 8 && stype <= 12) {  // fixed
    int order = (int)stype - 8;
    if (order >= kFixedOrders) return false;
    for (int i = 0; i < order; ++i)
      if (!br->read_signed(bps, &x[i])) return false;
    std::vector<int64_t> res(block_size - order);
    if (!decode_residual(br, block_size, order, res.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += kFixedCoefs[order][j] * x[i - 1 - j];
      x[i] = res[i - order] + pred;
    }
  } else if (stype >= 32) {  // LPC
    int order = (int)(stype & 31) + 1;
    for (int i = 0; i < order; ++i)
      if (!br->read_signed(bps, &x[i])) return false;
    uint64_t prec;
    if (!br->read(4, &prec) || prec == 15) return false;
    int precision = (int)prec + 1;
    int64_t shift;
    if (!br->read_signed(5, &shift)) return false;
    std::vector<int64_t> coefs(order);
    for (int j = 0; j < order; ++j)
      if (!br->read_signed(precision, &coefs[j])) return false;
    std::vector<int64_t> res(block_size - order);
    if (!decode_residual(br, block_size, order, res.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * x[i - 1 - j];
      x[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;
  }

  if (wasted)
    for (int i = 0; i < block_size; ++i) x[i] <<= wasted;
  return true;
}

// Decodes one frame into chans (resized); returns block size or -1.
int decode_frame(BitReader* br, const FlacStreamInfo& info,
                 const uint8_t* base,
                 std::vector<std::vector<int64_t>>* chans) {
  size_t start_byte = br->byte_pos();
  uint64_t sync;
  if (!br->read(14, &sync) || sync != 0x3FFE) return -1;
  uint64_t v;
  br->read(1, &v);  // reserved
  br->read(1, &v);  // blocking strategy
  uint64_t bs_code, sr_code, ch_code, ss_code;
  if (!br->read(4, &bs_code) || !br->read(4, &sr_code) ||
      !br->read(4, &ch_code) || !br->read(3, &ss_code) || !br->read(1, &v))
    return -1;
  uint64_t num;
  if (!read_utf8_number(br, &num)) return -1;

  int block_size;
  if (bs_code == 0) return -1;
  else if (bs_code == 6) { if (!br->read(8, &v)) return -1; block_size = (int)v + 1; }
  else if (bs_code == 7) { if (!br->read(16, &v)) return -1; block_size = (int)v + 1; }
  else block_size = kBlockSizes[bs_code];

  if (sr_code == 12) { if (!br->read(8, &v)) return -1; }
  else if (sr_code == 13 || sr_code == 14) { if (!br->read(16, &v)) return -1; }
  else if (sr_code == 15) return -1;

  int bps;
  switch (ss_code) {
    case 0: bps = info.bits; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
  }

  size_t crc_end = br->byte_pos();
  uint64_t stored_crc;
  if (!br->read(8, &stored_crc)) return -1;
  if (crc8(base + start_byte, crc_end - start_byte) != (uint8_t)stored_crc)
    return -1;

  if (ch_code < 8) {
    int nch = (int)ch_code + 1;
    chans->resize(nch);
    for (int c = 0; c < nch; ++c)
      if (!decode_subframe(br, block_size, bps, &(*chans)[c])) return -1;
  } else if (ch_code == 8) {  // left/side
    chans->resize(2);
    std::vector<int64_t> left, side;
    if (!decode_subframe(br, block_size, bps, &left)) return -1;
    if (!decode_subframe(br, block_size, bps + 1, &side)) return -1;
    (*chans)[0] = left;
    (*chans)[1].resize(block_size);
    for (int i = 0; i < block_size; ++i) (*chans)[1][i] = left[i] - side[i];
  } else if (ch_code == 9) {  // right/side
    chans->resize(2);
    std::vector<int64_t> side, right;
    if (!decode_subframe(br, block_size, bps + 1, &side)) return -1;
    if (!decode_subframe(br, block_size, bps, &right)) return -1;
    (*chans)[1] = right;
    (*chans)[0].resize(block_size);
    for (int i = 0; i < block_size; ++i) (*chans)[0][i] = side[i] + right[i];
  } else if (ch_code == 10) {  // mid/side
    chans->resize(2);
    std::vector<int64_t> mid, side;
    if (!decode_subframe(br, block_size, bps, &mid)) return -1;
    if (!decode_subframe(br, block_size, bps + 1, &side)) return -1;
    (*chans)[0].resize(block_size);
    (*chans)[1].resize(block_size);
    for (int i = 0; i < block_size; ++i) {
      int64_t m = (mid[i] << 1) | (side[i] & 1);
      (*chans)[0][i] = (m + side[i]) >> 1;
      (*chans)[1][i] = (m - side[i]) >> 1;
    }
  } else {
    return -1;
  }

  br->align();
  if (!br->read(16, &v)) return -1;  // frame CRC-16 (not verified)
  return block_size;
}

}  // namespace

extern "C" {

// Returns 0 on success.
int vrvqio_flac_info(const char* path, int* sample_rate, int* channels,
                     long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  FlacStreamInfo info;
  long first;
  bool ok = parse_streaminfo(f, &info, &first);
  fclose(f);
  if (!ok) return 2;
  *sample_rate = (int)info.sample_rate;
  *channels = info.channels;
  *frames = (long)info.total_samples;
  return 0;
}

// Decode interleaved float32 frames into out (capacity cap floats).
// duration < 0 => to EOF. Returns 0 on success.
int vrvqio_read_flac(const char* path, double offset, double duration,
                     float* out, long cap, int* sample_rate, int* channels,
                     long* frames_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  FlacStreamInfo info;
  long first;
  if (!parse_streaminfo(f, &info, &first)) { fclose(f); return 2; }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, first, SEEK_SET);
  std::vector<uint8_t> payload(fsize - first);
  if (!payload.empty() &&
      fread(payload.data(), 1, payload.size(), f) != payload.size()) {
    fclose(f);
    return 3;
  }
  fclose(f);

  BitReader br(payload.data(), payload.size());
  long start = (long)(offset * info.sample_rate + 0.5);
  long want = duration < 0 ? -1 : (long)(duration * info.sample_rate + 0.5);

  long got = 0, seen = 0;
  std::vector<std::vector<int64_t>> chans;
  double scale = 1.0 / (double)((int64_t)1 << (info.bits - 1));
  while (!br.eof() && br.bits_left() >= 32) {
    int n = decode_frame(&br, info, payload.data(), &chans);
    if (n < 0) break;
    long lo = std::max(start - seen, 0L);
    seen += n;
    if (lo >= n) continue;
    int nch = (int)chans.size();
    for (long i = lo; i < n; ++i) {
      if (want >= 0 && got >= want) break;
      if ((got + 1) * nch > cap) { return 4; }
      for (int c = 0; c < nch; ++c)
        out[got * nch + c] = (float)(chans[c][i] * scale);
      ++got;
    }
    if (want >= 0 && got >= want) break;
  }

  *sample_rate = (int)info.sample_rate;
  *channels = info.channels;
  *frames_out = got;
  return 0;
}

}  // extern "C"
