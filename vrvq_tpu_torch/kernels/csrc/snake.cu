// Snake activation y = x + sin^2(alpha * x) / (alpha + 1e-9), forward only.
//
// Replaces the TPU kernel vrvq_tpu/ops/snake.py: snake_pallas -> _snake_kernel,
// which streams channels-last (B, T, C) blocks through VMEM once. Here the
// tensor stays in PyTorch's (B, C, T) layout.
//
// Bound on the H100: bytes. 8 bytes move per element against a handful of
// operations and one sinf, so the least time is 8 * n / 3.35 TB/s. On the
// serve path most launches move 10-23 MB (a 1 s window's activations), a few
// microseconds of memory time, so what holds a launch back is how soon and
// how many bytes it has in flight, not arithmetic.
//
// Design. The grid is (B * C rows, tiles of T): a block works inside one row,
// so each thread reads alpha and computes its reciprocal once, with no
// division or modulo per element. Each thread issues all of its 16-byte loads
// (kVec float4) before it computes any, so a block has 16 KB in flight and the
// first wave covers the whole of a serve-path tensor. A row starts 16-byte
// aligned only when T % 4 == 0 (on the serve path T is 44538, 44532, 22229,
// ...), so the first block of a row peels a scalar head up to the first
// 16-byte boundary of x and a scalar tail after the last whole float4. The
// head is taken from the address itself, never assumed: a contiguous view can
// carry a storage offset. Where x and y are misaligned against each other
// (such a view with an odd offset), the block runs the same tile with scalar
// accesses. Small rows get smaller blocks (down to one warp) so threads are
// not left idle. No tensor cores apply to an elementwise pass.
//
// Numerics follow the plain version (ops/snake.py: snake_reference) term for
// term, so the kernel is bit-identical to it: the IEEE reciprocal
// 1 / (alpha + 1e-9) first, then the product with s * s, then the sum, each
// rounded on its own (__fmul_rn / __fadd_rn keep the compiler from contracting
// them into an FMA). Build without --use_fast_math: it would turn sinf into
// __sinf and the division into an approximation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kVec = 4;  // float4 loads in flight per thread
constexpr unsigned kMaxGridY = 65535;

__device__ __forceinline__ float snake1(float v, float a, float inv) {
  const float s = sinf(__fmul_rn(a, v));
  return __fadd_rn(v, __fmul_rn(inv, __fmul_rn(s, s)));
}

__global__ void __launch_bounds__(kMaxThreads)
snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
             float* __restrict__ y, unsigned channels, long long length,
             long long tiles) {
  // every load of the block is issued before the first result is computed:
  // alpha, the float4s, and the scalar head and tail of the row
  const float a = __ldg(alpha + blockIdx.x % channels);
  const long long row = blockIdx.x;
  const float* xr = x + row * length;
  float* yr = y + row * length;
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const bool vector = ((reinterpret_cast<uintptr_t>(xr) ^
                        reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const long long head =
      vector ? min((long long)(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / 4),
                   length)
             : 0;
  const long long nvec = vector ? (length - head) / 4 : 0;
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  float4* yv = reinterpret_cast<float4*>(yr + head);

  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    if (vector) {
      const long long v0 = tile * nt * kVec + t;
      float4 buf[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const long long v = v0 + (long long)i * nt;
        if (v < nvec) buf[i] = xv[v];
      }
      // the head (before xr's first 16-byte boundary) and the tail (after the
      // last whole float4), by the first block of the row
      const bool edge = tile == 0 && t < 4;
      const long long tail = head + 4 * nvec + t;
      const float hv = edge && t < head ? xr[t] : 0.0f;
      const float tv = edge && tail < length ? xr[tail] : 0.0f;
      const float inv = 1.0f / (a + 1e-9f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const long long v = v0 + (long long)i * nt;
        if (v < nvec) {
          float4 o;
          o.x = snake1(buf[i].x, a, inv);
          o.y = snake1(buf[i].y, a, inv);
          o.z = snake1(buf[i].z, a, inv);
          o.w = snake1(buf[i].w, a, inv);
          yv[v] = o;
        }
      }
      if (edge && t < head) yr[t] = snake1(hv, a, inv);
      if (edge && tail < length) yr[tail] = snake1(tv, a, inv);
    } else {
      const float inv = 1.0f / (a + 1e-9f);
      const long long e0 = tile * nt * kVec * 4;
      for (int i = t; i < nt * kVec * 4; i += nt) {
        const long long e = e0 + i;
        if (e < length) yr[e] = snake1(xr[e], a, inv);
      }
    }
  }
}

}  // namespace

// x, y: (B, C, T) float32, contiguous (x may start anywhere a float may);
// alpha: (C,) float32. rows = B * C. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int vrvq_snake_forward(const float* x, const float* alpha, float* y,
                                  long long rows, long long channels,
                                  long long length, void* stream) {
  if (rows <= 0 || length <= 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // tiles of at most kMaxThreads * kVec float4; threads spread evenly over
  // them, in whole warps
  const long long per_tile = (long long)kMaxThreads * kVec * 4;
  const long long tiles = (length + per_tile - 1) / per_tile;
  const long long per_thread = (long long)kVec * 4 * tiles;
  long long threads = (length + per_thread - 1) / per_thread;
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const unsigned grid_y = tiles < kMaxGridY ? (unsigned)tiles : kMaxGridY;
  snake_kernel<<<dim3((unsigned)rows, grid_y), (unsigned)threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, alpha, y, (unsigned)channels, length, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* vrvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
