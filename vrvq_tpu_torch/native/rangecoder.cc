// Native backend of vrvq_tpu_torch/ops/rangecoder.py: the port's copy of the
// JAX package's rangecoder.cc, with the same extern "C" API and output
// byte-identical to the Python coder.
//
// Same construction: carry-counting byte-wise range coder (Subbotin/LZMA
// ShiftLow), per-context Fenwick frequency trees, +32 per hit, halved at
// total >= 2^16 with max(1, c/2). The Python implementation is the
// specification; tests assert the two produce identical bytes, so files
// and wire packets interoperate regardless of which side coded them.
//
// Stateful model handles support the cross-packet adaptation the live
// streaming transport (infer/streaming.PacketCodec) relies on.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kInc = 32;
constexpr int kLimit = 1 << 16;

struct Fenwick {
  int n = 0;
  int size = 1;
  int64_t total = 0;
  std::vector<int64_t> tree;  // 1-based

  void init(int n_symbols) {
    n = n_symbols;
    size = 1;
    while (size < n) size *= 2;
    tree.assign(size + 1, 0);
    total = 0;
    for (int i = 0; i < n; ++i) add(i, 1);
  }

  void add(int i, int64_t delta) {
    total += delta;
    for (int j = i + 1; j <= size; j += j & (-j)) tree[j] += delta;
  }

  int64_t prefix(int i) const {
    int64_t s = 0;
    for (; i > 0; i -= i & (-i)) s += tree[i];
    return s;
  }

  // (symbol, start) with prefix(sym) <= cum < prefix(sym)+count(sym)
  void find(int64_t cum, int* sym, int64_t* start) const {
    int idx = 0;
    int64_t rest = cum;
    for (int bit = size; bit; bit >>= 1) {
      int nxt = idx + bit;
      if (nxt <= size && tree[nxt] <= rest) {
        rest -= tree[nxt];
        idx = nxt;
      }
    }
    *sym = idx;
    *start = cum - rest;
  }

  void update(int sym) {
    add(sym, kInc);
    if (total >= kLimit) {
      std::vector<int64_t> counts(n);
      for (int i = 0; i < n; ++i) {
        int64_t c = prefix(i + 1) - prefix(i);
        int64_t h = c / 2;
        counts[i] = h < 1 ? 1 : h;
      }
      tree.assign(size + 1, 0);
      total = 0;
      for (int i = 0; i < n; ++i) add(i, counts[i]);
    }
  }
};

struct Models {
  int n_symbols;
  std::vector<Fenwick> ctx;
  Models(int n_sym, int n_ctx) : n_symbols(n_sym), ctx(n_ctx) {
    for (auto& f : ctx) f.init(n_sym);
  }
};

struct Encoder {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cache_size = 1;
  uint8_t* out;
  long cap;
  long pos = 0;
  bool overflow = false;

  Encoder(uint8_t* buf, long capacity) : out(buf), cap(capacity) {}

  void put(uint8_t b) {
    if (pos < cap) out[pos++] = b;
    else overflow = true;
  }

  void shift_low() {
    if (low < 0xFF000000ull || low > 0xFFFFFFFFull) {
      uint64_t carry = low >> 32;
      put(static_cast<uint8_t>(cache + carry));
      while (cache_size > 1) {
        put(static_cast<uint8_t>(0xFF + carry));
        --cache_size;
      }
      cache = static_cast<uint8_t>(low >> 24);
    } else {
      ++cache_size;
    }
    low = (low << 8) & 0xFFFFFFFFull;
  }

  void encode(int64_t start, int64_t size, int64_t total) {
    range /= static_cast<uint32_t>(total);
    low += static_cast<uint64_t>(start) * range;
    range *= static_cast<uint32_t>(size);
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }

  long flush() {
    for (int i = 0; i < 5; ++i) shift_low();
    return overflow ? -1 : pos;
  }
};

struct Decoder {
  const uint8_t* data;
  long len;
  long pos = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  Decoder(const uint8_t* d, long l) : data(d), len(l) {
    for (int i = 0; i < 5; ++i) code = (code << 8) | byte();
  }

  uint8_t byte() { return pos < len ? data[pos++] : 0; }

  int64_t get_cum(int64_t total) {
    range /= static_cast<uint32_t>(total);
    int64_t cum = code / range;
    return cum < total ? cum : total - 1;
  }

  void decode(int64_t start, int64_t size) {
    code -= static_cast<uint32_t>(start) * range;
    range *= static_cast<uint32_t>(size);
    while (range < kTop) {
      code = (code << 8) | byte();
      range <<= 8;
    }
  }
};

}  // namespace

extern "C" {

void* vrvq_rc_model_new(int n_symbols, int n_contexts) {
  if (n_symbols < 2 || n_contexts < 1) return nullptr;
  return new Models(n_symbols, n_contexts);
}

void vrvq_rc_model_free(void* handle) {
  delete static_cast<Models*>(handle);
}

// Returns bytes written, or -1 if out_cap is too small. Models adapt.
long vrvq_rc_encode(void* handle, const int32_t* symbols,
                    const int32_t* contexts, long n, uint8_t* out,
                    long out_cap) {
  Models* m = static_cast<Models*>(handle);
  Encoder enc(out, out_cap);
  for (long i = 0; i < n; ++i) {
    Fenwick& f = m->ctx[contexts[i]];
    int s = symbols[i];
    int64_t start = f.prefix(s);
    int64_t size = f.prefix(s + 1) - start;
    enc.encode(start, size, f.total);
    f.update(s);
  }
  return enc.flush();
}

// Decodes `count` symbols into out (uint32). Models adapt. Returns count.
long vrvq_rc_decode(void* handle, const uint8_t* data, long data_len,
                    const int32_t* contexts, long count, uint32_t* out) {
  Models* m = static_cast<Models*>(handle);
  Decoder dec(data, data_len);
  for (long i = 0; i < count; ++i) {
    Fenwick& f = m->ctx[contexts[i]];
    int sym;
    int64_t start;
    int64_t cum = dec.get_cum(f.total);
    f.find(cum, &sym, &start);
    int64_t size = f.prefix(sym + 1) - start;
    dec.decode(start, size);
    f.update(sym);
    out[i] = static_cast<uint32_t>(sym);
  }
  return count;
}

}  // extern "C"
