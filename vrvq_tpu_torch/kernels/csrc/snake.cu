// Snake activation y = x + sin^2(alpha * x) / (alpha + 1e-9): the forward in
// four modes (the exact sin^2 or the polynomial one, on float32 or bfloat16
// x and y; float32 alpha and arithmetic in every mode), and the backward of
// the two float32 modes (at the end of this file).
//
// Replaces the TPU kernel vrvq_tpu/ops/snake.py: snake_pallas -> _snake_kernel,
// which streams channels-last (B, T, C) blocks through VMEM once. Here the
// tensor stays in PyTorch's (B, C, T) layout. The polynomial mode is the JAX
// package's snake_approx (vrvq_tpu/ops/snake.py), which is plain jnp there;
// in the port every Snake goes through this kernel, so it is a mode of it.
//
// Bound on the H100: bytes. 2 * sizeof(T) bytes move per element against a
// handful of operations and one sinf (or a degree-6 polynomial), so the
// least time is 2 * sizeof(T) * n / 3.35 TB/s. On the serve path most launches
// move 5-23 MB (a 1 s window's activations), a few microseconds of memory
// time, so what holds a launch back is how soon and how many bytes it has in
// flight, not arithmetic.
//
// Design. The grid is (B * C rows, tiles of T): a block works inside one row,
// so each thread reads alpha and computes its reciprocal once, with no
// division or modulo per element. Each thread issues all of its 16-byte loads
// (kVec of them: 4 floats or 8 bfloat16s each) before it computes any, so a
// block has 16 KB in flight. A row starts 16-byte aligned only when T is a
// multiple of 16 / sizeof(T) (on the serve path T is 44538, 44532, 22229,
// ...), so the first block of a row peels a scalar head up to the first
// 16-byte boundary of x and a scalar tail after the last whole 16 bytes. The
// head is taken from the address itself, never assumed: a contiguous view can
// carry a storage offset. Where x and y are misaligned against each other
// (such a view with an odd offset), the block runs the same tile with scalar
// accesses. Small rows get smaller blocks (down to one warp) so threads are
// not left idle. No tensor cores apply to an elementwise pass.
//
// Numerics follow the plain versions (ops/snake.py: snake_reference,
// snake_approx_reference) term for term, so the kernel is bit-identical to
// them: x widened to float32, the IEEE reciprocal 1 / (alpha + 1e-9) first,
// every product and sum rounded on its own (__fmul_rn / __fadd_rn keep the
// compiler from contracting them into an FMA), the result rounded to T once
// (round to nearest even). The polynomial: u = alpha x, k = rint(u / pi) (to
// nearest even, as torch.round and jnp.round), the Cody-Waite reduction
// r = (u - k PI_HI) - k PI_LO, sin^2 ~= s P(s) with s = r^2 and P of degree 6
// by Horner. Its constants are the float32 values of the JAX package's
// (_INV_PI, _PI_HI, _PI_LO, _SIN2_C), written as hex floats so that no
// decimal rounding differs. Build without --use_fast_math: it would turn sinf
// into __sinf and the division into an approximation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kVec = 4;  // 16-byte loads in flight per thread
constexpr unsigned kMaxGridY = 65535;

constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kPiHi = 0x1.92p+1f;
constexpr float kPiLo = 0x1.fb5444p-11f;
constexpr float kC0 = 0x1p+0f;
constexpr float kC1 = -0x1.555556p-2f;
constexpr float kC2 = 0x1.6c16b6p-5f;
constexpr float kC3 = -0x1.a01830p-9f;
constexpr float kC4 = 0x1.27c1c6p-13f;
constexpr float kC5 = -0x1.1c35dap-18f;
constexpr float kC6 = 0x1.5e1a36p-24f;
// P'(s): kDi = float32(i * kCi), ops/snake.py: SIN2_DC
constexpr float kD1 = -0x1.555556p-2f;
constexpr float kD2 = 0x1.6c16b6p-4f;
constexpr float kD3 = -0x1.381224p-7f;
constexpr float kD4 = 0x1.27c1c6p-11f;
constexpr float kD5 = -0x1.634350p-16f;
constexpr float kD6 = 0x1.0693a8p-21f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The polynomial's reduction: r = (u - k PI_HI) - k PI_LO with k = rint(u / pi)
// (to nearest even), s = r^2; and P(s) by Horner.
__device__ __forceinline__ float reduce_pi(float u, float& s) {
  const float k = rintf(__fmul_rn(u, kInvPi));
  const float r = __fsub_rn(__fsub_rn(u, __fmul_rn(k, kPiHi)),
                            __fmul_rn(k, kPiLo));
  s = __fmul_rn(r, r);
  return r;
}

__device__ __forceinline__ float sin2_poly(float s) {
  float acc = __fadd_rn(__fmul_rn(kC6, s), kC5);
  acc = __fadd_rn(__fmul_rn(acc, s), kC4);
  acc = __fadd_rn(__fmul_rn(acc, s), kC3);
  acc = __fadd_rn(__fmul_rn(acc, s), kC2);
  acc = __fadd_rn(__fmul_rn(acc, s), kC1);
  return __fadd_rn(__fmul_rn(acc, s), kC0);
}

template <bool POLY>
__device__ __forceinline__ float snake1(float v, float a, float inv) {
  float sin2;
  if (POLY) {
    float s;
    reduce_pi(__fmul_rn(a, v), s);
    sin2 = __fmul_rn(s, sin2_poly(s));
  } else {
    const float s = sinf(__fmul_rn(a, v));
    sin2 = __fmul_rn(s, s);
  }
  return __fadd_rn(v, __fmul_rn(inv, sin2));
}

// 16 bytes of T as E floats, and back.
template <typename T>
struct Vec16 {
  static constexpr int E = 16 / sizeof(T);
  __device__ __forceinline__ static void widen_all(const uint4& u, float (&f)[E]) {
    const T* p = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = widen(p[j]);
  }
  __device__ __forceinline__ static uint4 narrow_all(const float (&f)[E]) {
    uint4 u;
    T* p = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < E; ++j) p[j] = narrow<T>(f[j]);
    return u;
  }
};

template <typename T, bool POLY>
__global__ void __launch_bounds__(kMaxThreads)
snake_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
             T* __restrict__ y, unsigned channels, long long length,
             long long tiles) {
  constexpr int E = Vec16<T>::E;  // elements per 16 bytes
  // every load of the block is issued before the first result is computed:
  // alpha, the 16-byte vectors, and the scalar head and tail of the row
  const float a = __ldg(alpha + blockIdx.x % channels);
  const long long row = blockIdx.x;
  const T* xr = x + row * length;
  T* yr = y + row * length;
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const bool vector = ((reinterpret_cast<uintptr_t>(xr) ^
                        reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const long long head =
      vector ? min((long long)(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) /
                               sizeof(T)),
                   length)
             : 0;
  const long long nvec = vector ? (length - head) / E : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* yv = reinterpret_cast<uint4*>(yr + head);

  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    if (vector) {
      const long long v0 = tile * nt * kVec + t;
      uint4 buf[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const long long v = v0 + (long long)i * nt;
        if (v < nvec) buf[i] = xv[v];
      }
      // the head (before xr's first 16-byte boundary) and the tail (after the
      // last whole 16 bytes), by the first block of the row
      const bool edge = tile == 0 && t < E;
      const long long tail = head + E * nvec + t;
      const float hv = edge && t < head ? widen(xr[t]) : 0.0f;
      const float tv = edge && tail < length ? widen(xr[tail]) : 0.0f;
      const float inv = 1.0f / (a + 1e-9f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const long long v = v0 + (long long)i * nt;
        if (v < nvec) {
          float f[E];
          Vec16<T>::widen_all(buf[i], f);
#pragma unroll
          for (int j = 0; j < E; ++j) f[j] = snake1<POLY>(f[j], a, inv);
          yv[v] = Vec16<T>::narrow_all(f);
        }
      }
      if (edge && t < head) yr[t] = narrow<T>(snake1<POLY>(hv, a, inv));
      if (edge && tail < length) yr[tail] = narrow<T>(snake1<POLY>(tv, a, inv));
    } else {
      const float inv = 1.0f / (a + 1e-9f);
      const long long e0 = tile * nt * kVec * E;
      for (int i = t; i < nt * kVec * E; i += nt) {
        const long long e = e0 + i;
        if (e < length) yr[e] = narrow<T>(snake1<POLY>(widen(xr[e]), a, inv));
      }
    }
  }
}

template <typename T, bool POLY>
int launch(const void* x, const float* alpha, void* y, long long rows,
           long long channels, long long length, cudaStream_t stream) {
  constexpr int E = Vec16<T>::E;
  // tiles of at most kMaxThreads * kVec vectors; threads spread evenly over
  // them, in whole warps
  const long long per_tile = (long long)kMaxThreads * kVec * E;
  const long long tiles = (length + per_tile - 1) / per_tile;
  const long long per_thread = (long long)kVec * E * tiles;
  long long threads = (length + per_thread - 1) / per_thread;
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const unsigned grid_y = tiles < kMaxGridY ? (unsigned)tiles : kMaxGridY;
  snake_kernel<T, POLY><<<dim3((unsigned)rows, grid_y), (unsigned)threads, 0,
                          stream>>>(
      static_cast<const T*>(x), alpha, static_cast<T*>(y), (unsigned)channels,
      length, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, C, T) of `dtype` (0 float32, 1 bfloat16), contiguous (x may start
// anywhere an element may); alpha: (C,) float32. rows = B * C. poly: 1 for
// the polynomial sin^2. Returns the cudaError_t of the launch (0 on success).
extern "C" int vrvq_snake_forward(const void* x, const float* alpha, void* y,
                                  long long rows, long long channels,
                                  long long length, int dtype, int poly,
                                  void* stream) {
  if (rows <= 0 || length <= 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return poly ? launch<float, true>(x, alpha, y, rows, channels, length, s)
                : launch<float, false>(x, alpha, y, rows, channels, length, s);
  if (dtype == 1)
    return poly ? launch<__nv_bfloat16, true>(x, alpha, y, rows, channels, length, s)
                : launch<__nv_bfloat16, false>(x, alpha, y, rows, channels, length, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ channels-last
//
// The same four modes over channels-last memory, (B, T, C) with C innermost,
// the layout of the bfloat16 decoder's activations (nn/layers.py), where
// every conv runs as an NHWC implicit GEMM on the tensor cores. Element e of
// the flat buffer belongs to channel e % C, so alpha changes along the
// innermost axis instead of once a row.
//
// Design. The tensor is one flat run of n elements in tiles of kMaxThreads *
// kVec 16-byte vectors, as in the row kernel: every thread issues its kVec
// loads before it computes any. A block first writes alpha and the IEEE
// reciprocal 1 / (alpha + 1e-9) of every channel into shared memory (8 bytes
// a channel), then walks tiles grid-stride, so the C divisions are paid once
// a block and not once an element. Where C is a multiple of the vector's
// elements and x starts 16-byte aligned (every activation of the decoder:
// its widths are multiples of 8, its tensors fresh allocations), a vector
// holds E consecutive channels of one row, and its alphas and reciprocals
// are read from the table as 16-byte vectors too. Otherwise (an odd C, a view
// with an offset) each element looks its channel up on its own, with a
// scalar head and tail peeled as in the row kernel, or scalar accesses where
// x and y are misaligned against each other. Above kClTableChannels channels
// the table would not fit the default shared memory and each element reads
// alpha and divides itself. Same arithmetic as the row kernel (snake1), so
// the result is bit-identical to the plain versions.

namespace {

constexpr unsigned kClTableChannels = 6144;  // 48 KB of alpha and reciprocals
constexpr unsigned kClMaxBlocks = 2048;

// alpha of channel c and its reciprocal, from the shared table or computed.
__device__ __forceinline__ float cl_alpha(const float* table, const float* alpha,
                                          bool cached, unsigned channels,
                                          unsigned c, float& inv) {
  if (cached) {
    inv = table[channels + c];
    return table[c];
  }
  const float a = __ldg(alpha + c);
  inv = 1.0f / (a + 1e-9f);
  return a;
}

template <typename T, bool POLY>
__global__ void __launch_bounds__(kMaxThreads)
snake_cl_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                T* __restrict__ y, unsigned channels, long long n,
                long long tiles) {
  constexpr int E = Vec16<T>::E;
  extern __shared__ float4 table4[];  // alpha (C), then the reciprocals (C)
  float* table = reinterpret_cast<float*>(table4);
  const bool cached = channels <= kClTableChannels;
  if (cached) {
    for (unsigned c = threadIdx.x; c < channels; c += blockDim.x) {
      const float a = __ldg(alpha + c);
      table[c] = a;
      table[channels + c] = 1.0f / (a + 1e-9f);
    }
    __syncthreads();
  }
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const bool vector = ((reinterpret_cast<uintptr_t>(x) ^
                        reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long head =
      vector ? min((long long)(((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) /
                               sizeof(T)),
                   n)
             : 0;
  // whole vectors of E channels read their table entries as vectors
  const bool grouped = cached && head == 0 && channels % E == 0;
  const long long nvec = vector ? (n - head) / E : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  // a thread's next vector lies nt * E elements further on
  const unsigned step = (unsigned)(((long long)nt * E) % channels);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (vector) {
      const long long v0 = tile * nt * kVec + t;
      uint4 buf[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const long long v = v0 + (long long)i * nt;
        if (v < nvec) buf[i] = xv[v];
      }
      const bool edge = tile == 0 && t < E;
      const long long tail = head + E * nvec + t;
      const float hv = edge && t < head ? widen(x[t]) : 0.0f;
      const float tv = edge && tail < n ? widen(x[tail]) : 0.0f;
      unsigned c = (unsigned)((head + v0 * E) % channels);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const long long v = v0 + (long long)i * nt;
        if (v < nvec) {
          float f[E];
          Vec16<T>::widen_all(buf[i], f);
          if (grouped) {
            float a[E], inv[E];
#pragma unroll
            for (int j = 0; j < E; j += 4) {
              *reinterpret_cast<float4*>(a + j) = table4[(c + j) / 4];
              *reinterpret_cast<float4*>(inv + j) = table4[(channels + c + j) / 4];
            }
#pragma unroll
            for (int j = 0; j < E; ++j) f[j] = snake1<POLY>(f[j], a[j], inv[j]);
          } else {
            unsigned cj = c;
#pragma unroll
            for (int j = 0; j < E; ++j) {
              float inv;
              const float a = cl_alpha(table, alpha, cached, channels, cj, inv);
              f[j] = snake1<POLY>(f[j], a, inv);
              if (++cj == channels) cj = 0;
            }
          }
          yv[v] = Vec16<T>::narrow_all(f);
        }
        c += step;
        if (c >= channels) c -= channels;
      }
      if (edge && t < head) {
        float inv;
        const float a = cl_alpha(table, alpha, cached, channels,
                                 (unsigned)(t % channels), inv);
        y[t] = narrow<T>(snake1<POLY>(hv, a, inv));
      }
      if (edge && tail < n) {
        float inv;
        const float a = cl_alpha(table, alpha, cached, channels,
                                 (unsigned)(tail % channels), inv);
        y[tail] = narrow<T>(snake1<POLY>(tv, a, inv));
      }
    } else {
      const long long e0 = tile * nt * kVec * E;
      for (int i = t; i < nt * kVec * E; i += nt) {
        const long long e = e0 + i;
        if (e < n) {
          float inv;
          const float a = cl_alpha(table, alpha, cached, channels,
                                   (unsigned)(e % channels), inv);
          y[e] = narrow<T>(snake1<POLY>(widen(x[e]), a, inv));
        }
      }
    }
  }
}

template <typename T, bool POLY>
int launch_cl(const void* x, const float* alpha, void* y, long long n,
              long long channels, cudaStream_t stream) {
  constexpr int E = Vec16<T>::E;
  const long long per_tile = (long long)kMaxThreads * kVec * E;
  const long long tiles = (n + per_tile - 1) / per_tile;
  const unsigned grid = tiles < kClMaxBlocks ? (unsigned)tiles : kClMaxBlocks;
  const size_t smem =
      channels <= kClTableChannels ? 2 * sizeof(float) * (size_t)channels : 0;
  snake_cl_kernel<T, POLY><<<grid, kMaxThreads, smem, stream>>>(
      static_cast<const T*>(x), alpha, static_cast<T*>(y), (unsigned)channels,
      n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n elements of `dtype` (0 float32, 1 bfloat16) in channels-last order,
// channel innermost (element e is channel e % channels; x may start anywhere
// an element may); alpha: (channels,) float32. poly: 1 for the polynomial
// sin^2. Returns the cudaError_t of the launch (0 on success).
extern "C" int vrvq_snake_forward_cl(const void* x, const float* alpha, void* y,
                                     long long n, long long channels, int dtype,
                                     int poly, void* stream) {
  if (n <= 0) return 0;
  if (channels <= 0 || channels > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return poly ? launch_cl<float, true>(x, alpha, y, n, channels, s)
                : launch_cl<float, false>(x, alpha, y, n, channels, s);
  if (dtype == 1)
    return poly ? launch_cl<__nv_bfloat16, true>(x, alpha, y, n, channels, s)
                : launch_cl<__nv_bfloat16, false>(x, alpha, y, n, channels, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- backward
//
// The gradient of the two float32 modes, for training. The JAX package has
// no Pallas backward: XLA differentiates snake_reference (exact) and
// snake_approx (polynomial, conf/vrvq/vrvq_a2_fast.yml) and fuses the result
// into the convs' epilogues. Eager PyTorch would launch ~8 kernels (~20 for
// the polynomial) and keep several temporaries per Snake, so the port
// computes it here, from x alone (the forward saves only x). With
// u = alpha x, inv = 1 / (alpha + 1e-9), sin2 the mode's sin(u)^2 and slope
// its derivative in u:
//
//   dx     = g (1 + slope (alpha inv))
//   dalpha = sum_{B,T} g (x slope inv - sin2 (inv inv))
//
// Exact: sin2 = sin(u)^2, slope = sin(2u) = 2 sin(u) cos(u). Polynomial:
// sin2 = s P(s), slope = 2r (P(s) + s P'(s)) with r, s = r^2 the reduction of
// the forward, k's rounding carrying no gradient (as JAX's autodiff of
// snake_approx gives), P' a second Horner chain over the coefficients i C_i.
// Term for term as ops/snake.py: snake_backward_reference and
// snake_approx_backward_reference, every product and sum rounded on its own
// (__fmul_rn, __fadd_rn), so dx is bit-identical to the plain version; dalpha
// is a sum in another order and agrees to float32 rounding.
//
// Bound on the H100: bytes. Each element reads x and g and writes dx, 12
// bytes, against one sinf and one cosf (or two degree-6 Horner chains) and
// ~12 more flops; the dalpha partials are (C, B * tiles) floats, a few KB.
//
// Design: simple and deterministic. The grid is (B * C rows, tiles of T), as
// in the forward: a block works inside one row, so alpha and the two
// per-channel factors are computed once per thread. Each thread loads its
// kBwdPerThread elements of x and g (neighbouring threads on neighbouring
// addresses) before it computes any. The block sums its dalpha terms with a
// fixed shuffle tree and its warps' sums in warp order, and writes one
// partial per (channel, batch, tile). A second launch gives each channel a
// warp that adds its partials in a fixed order. No float atomics: two
// launches on the same inputs give the same bits, so a resumed training run
// replays an uninterrupted one as far as this kernel is concerned. The mode
// is a template parameter: the two modes share every line but the two
// values above.

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdPerThread = 8;
constexpr int kReduceWarps = 8;

__host__ __device__ inline long long bwd_tiles(long long length) {
  const long long per_tile = (long long)kBwdThreads * kBwdPerThread;
  return (length + per_tile - 1) / per_tile;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// sin(u)^2 and its derivative in u, of the mode POLY.
template <bool POLY>
__device__ __forceinline__ float sin2_slope(float u, float& slope) {
  if (POLY) {
    float s;
    const float r = reduce_pi(u, s);
    const float p = sin2_poly(s);
    float dp = __fadd_rn(__fmul_rn(kD6, s), kD5);
    dp = __fadd_rn(__fmul_rn(dp, s), kD4);
    dp = __fadd_rn(__fmul_rn(dp, s), kD3);
    dp = __fadd_rn(__fmul_rn(dp, s), kD2);
    dp = __fadd_rn(__fmul_rn(dp, s), kD1);
    slope = __fmul_rn(__fmul_rn(2.0f, r), __fadd_rn(p, __fmul_rn(s, dp)));
    return __fmul_rn(s, p);
  }
  const float sn = sinf(u);
  slope = __fmul_rn(__fmul_rn(2.0f, sn), cosf(u));
  return __fmul_rn(sn, sn);
}

template <bool POLY>
__global__ void __launch_bounds__(kBwdThreads)
snake_backward_kernel(const float* __restrict__ x,
                      const float* __restrict__ alpha,
                      const float* __restrict__ g, float* __restrict__ dx,
                      float* __restrict__ partials, unsigned channels,
                      unsigned tiles, long long per_channel, long long length) {
  __shared__ float warp_sums[kBwdThreads / 32];
  const unsigned row = blockIdx.x;
  const unsigned c = row % channels;
  const unsigned b = row / channels;
  const float a = __ldg(alpha + c);
  const float inv = 1.0f / (a + 1e-9f);
  const float ai = __fmul_rn(a, inv);
  const float ii = __fmul_rn(inv, inv);
  const long long base = (long long)row * length;
  const int nt = blockDim.x;
  const long long start = (long long)blockIdx.y * nt * kBwdPerThread + threadIdx.x;

  float xv[kBwdPerThread], gv[kBwdPerThread];
#pragma unroll
  for (int i = 0; i < kBwdPerThread; ++i) {
    const long long e = start + (long long)i * nt;
    xv[i] = e < length ? __ldg(x + base + e) : 0.0f;
    gv[i] = e < length ? __ldg(g + base + e) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kBwdPerThread; ++i) {
    const long long e = start + (long long)i * nt;
    if (e < length) {
      float slope;
      const float sin2 = sin2_slope<POLY>(__fmul_rn(a, xv[i]), slope);
      dx[base + e] = __fmul_rn(gv[i], __fadd_rn(1.0f, __fmul_rn(slope, ai)));
      const float t = __fsub_rn(__fmul_rn(__fmul_rn(xv[i], slope), inv),
                                __fmul_rn(sin2, ii));
      acc = __fadd_rn(acc, __fmul_rn(gv[i], t));
    }
  }
  acc = warp_sum(acc);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < nt / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
    partials[(long long)c * per_channel + (long long)b * tiles + blockIdx.y] = total;
  }
}

__global__ void __launch_bounds__(kReduceWarps * 32)
snake_alpha_reduce_kernel(const float* __restrict__ partials,
                          float* __restrict__ dalpha, unsigned channels,
                          long long per_channel) {
  const unsigned c = blockIdx.x * kReduceWarps + threadIdx.x / 32;
  if (c >= channels) return;  // whole warps leave together
  const float* p = partials + (long long)c * per_channel;
  float acc = 0.0f;
  for (long long i = threadIdx.x & 31; i < per_channel; i += 32)
    acc = __fadd_rn(acc, p[i]);
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) dalpha[c] = acc;
}

}  // namespace

// Tiles of T per row: the partials buffer holds (C, B * this) floats.
extern "C" long long vrvq_snake_backward_tiles(long long length) {
  return length > 0 ? bwd_tiles(length) : 0;
}

// x, g, dx: (B, C, T) float32 contiguous; alpha, dalpha: (C,) float32;
// partials: (C, B * vrvq_snake_backward_tiles(T)) float32 scratch; poly: 1
// for the polynomial mode. Two launches on `stream`; returns the cudaError_t
// of the launches (0 on success).
extern "C" int vrvq_snake_backward(const float* x, const float* alpha,
                                   const float* g, float* dx, float* partials,
                                   float* dalpha, long long batch,
                                   long long channels, long long length,
                                   int poly, void* stream) {
  if (batch <= 0 || channels <= 0 || length <= 0) return 0;
  const long long rows = batch * channels;
  const long long tiles = bwd_tiles(length);
  if (rows > 0x7fffffffLL || tiles > (long long)kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const long long per_thread = (long long)kBwdPerThread * tiles;
  long long threads = (length + per_thread - 1) / per_thread;
  threads = (threads + 31) / 32 * 32;
  if (threads > kBwdThreads) threads = kBwdThreads;
  const long long per_channel = batch * tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)rows, (unsigned)tiles);
  if (poly)
    snake_backward_kernel<true><<<grid, (unsigned)threads, 0, s>>>(
        x, alpha, g, dx, partials, (unsigned)channels, (unsigned)tiles,
        per_channel, length);
  else
    snake_backward_kernel<false><<<grid, (unsigned)threads, 0, s>>>(
        x, alpha, g, dx, partials, (unsigned)channels, (unsigned)tiles,
        per_channel, length);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((channels + kReduceWarps - 1) / kReduceWarps);
  snake_alpha_reduce_kernel<<<blocks, kReduceWarps * 32, 0, s>>>(
      partials, dalpha, (unsigned)channels, per_channel);
  return (int)cudaGetLastError();
}

extern "C" const char* vrvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
