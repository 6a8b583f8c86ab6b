// Snake activation y = x + sin^2(alpha * x) / (alpha + 1e-9), forward only.
//
// Replaces the TPU kernel vrvq_tpu/ops/snake.py: snake_pallas -> _snake_kernel,
// which streams channels-last (B, T, C) blocks through VMEM once. Here the
// tensor stays in PyTorch's (B, C, T) layout and the kernel is one grid-stride
// pass over memory: each element is read once and written once, and the
// channel of flat index i is (i / T) % C.
//
// Bound on the H100: bytes. 8 bytes move per element against a handful of
// operations plus one sinf, so the least time is 8 * n / 3.35 TB/s. The design
// keeps the pass single and coalesced (neighbouring threads touch neighbouring
// addresses); alpha is read through the read-only cache.
//
// Numerics follow the plain version (ops/snake.py: snake_reference) term for
// term: the reciprocal 1 / (alpha + 1e-9) first, then the product with s * s,
// then the sum, each rounded on its own (__fmul_rn / __fadd_rn keep the
// compiler from contracting them into an FMA). Build without --use_fast_math:
// it would turn sinf into __sinf and the division into an approximation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;
constexpr long long kMaxBlocks = 1LL << 20;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
             float* __restrict__ y, Index n, Index channels, Index length) {
  const Index step = (Index)gridDim.x * kThreads;
  for (Index i = (Index)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    const float a = __ldg(alpha + (i / length) % channels);
    const float v = x[i];
    const float s = sinf(a * v);
    const float inv = 1.0f / (a + 1e-9f);
    y[i] = __fadd_rn(v, __fmul_rn(inv, __fmul_rn(s, s)));
  }
}

}  // namespace

// x, y: (B, C, T) float32, contiguous; alpha: (C,) float32. n = B * C * T.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vrvq_snake_forward(const float* x, const float* alpha, float* y,
                                  long long n, long long channels,
                                  long long length, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + (long long)kThreads * kItemsPerThread - 1) /
                     ((long long)kThreads * kItemsPerThread);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < (1LL << 31)) {
    snake_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, alpha, y, (uint32_t)n, (uint32_t)channels, (uint32_t)length);
  } else {
    snake_kernel<uint64_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, alpha, y, (uint64_t)n, (uint64_t)channels, (uint64_t)length);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vrvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
