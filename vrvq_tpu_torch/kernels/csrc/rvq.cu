// Fused residual vector quantization, forward only: all Nq stages for a tile
// of frames in one block, with the residual and the z_q sum kept in shared
// memory from the first stage to the last.
//
// Replaces the TPU kernel vrvq_tpu/ops/rvq_kernel.py: fused_rvq -> _rvq_kernel.
// Per stage and frame, in float32:
//   e      = residual @ wi + bi                      (in_proj D -> d)
//   en     = e / max(|e|, 1e-12)
//   dist_k = (|en|^2 - 2 en . cn_k) + |cn_k|^2         (cn: normalized codebook)
//   code   = argmin_k dist_k, lowest k on ties       (= argmax(-dist), first max)
//   zq_e   = e + (cb[code] - e)                      (straight-through arithmetic)
//   out    = zq_e @ wo + bo                          (out_proj d -> D)
//   residual -= out;  z_q += out * mask[:, stage]
// The TPU kernel looks the codebook row up with a one-hot matmul; here it is a
// gather. The wrapper prepares the weights once per call: wi transposed to
// (Nq, d, D), the codebook normalized and transposed to (Nq, d, K), and
// |cn_k|^2 (Nq, K), so that the score expression is the plain version's
// (ops/rvq_kernel.py: fused_rvq_reference).
//
// Bound on the H100: operations. 2 (D d + K d + d D) FLOPs per frame and stage
// against reading z and writing z_q once. The design keeps the residual on
// chip across the stages, so device memory sees z once and z_q once; each
// stage's wi and normalized codebook are staged in shared memory once per
// block and read from there by all warps. A simple first version: one block
// of 256 threads per tile of 16 frames, scalar FMAs, no tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileF = 16;               // frames per block
constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = kTileF / kWarps;

__host__ __device__ inline size_t smem_floats(int D, int K, int DC) {
  // res, acc: kTileF * D each; wi^T: DC * D; cn^T: DC * K; |cn|^2: K;
  // e, en, zq_e: kTileF * DC each; |en|^2, mask: kTileF each; codes: kTileF.
  return 2 * (size_t)kTileF * D + (size_t)DC * D + (size_t)DC * K + K +
         3 * (size_t)kTileF * DC + 3 * (size_t)kTileF;
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
rvq_kernel(const float* __restrict__ z, const float* __restrict__ wiT,
           const float* __restrict__ bi, const float* __restrict__ wo,
           const float* __restrict__ bo, const float* __restrict__ cb,
           const float* __restrict__ cnT, const float* __restrict__ cn2,
           const float* __restrict__ mask, float* __restrict__ zq,
           int32_t* __restrict__ codes, int F, int D, int NQ, int K) {
  extern __shared__ float smem[];
  float* res = smem;                        // (kTileF, D)
  float* acc = res + kTileF * D;            // (kTileF, D)
  float* wi_s = acc + kTileF * D;           // (DC, D)
  float* cn_s = wi_s + DC * D;              // (DC, K)
  float* cn2_s = cn_s + DC * K;             // (K,)
  float* e_s = cn2_s + K;                   // (kTileF, DC)
  float* en_s = e_s + kTileF * DC;          // (kTileF, DC)
  float* zqe_s = en_s + kTileF * DC;        // (kTileF, DC)
  float* en2_s = zqe_s + kTileF * DC;       // (kTileF,)
  float* mask_s = en2_s + kTileF;           // (kTileF,)
  int* idx_s = reinterpret_cast<int*>(mask_s + kTileF);  // (kTileF,)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.x * kTileF;
  const int nf = min(kTileF, F - f0);

  // Frames past F (the ragged last tile) run on zeros and are never stored.
  for (int i = tid; i < kTileF * D; i += kThreads) {
    res[i] = (i / D) < nf ? z[(size_t)f0 * D + i] : 0.0f;
    acc[i] = 0.0f;
  }

  for (int s = 0; s < NQ; ++s) {
    const float* wi_g = wiT + (size_t)s * DC * D;
    for (int i = tid; i < DC * D; i += kThreads) wi_s[i] = wi_g[i];
    const float* cn_g = cnT + (size_t)s * DC * K;
    for (int i = tid; i < DC * K; i += kThreads) cn_s[i] = cn_g[i];
    for (int i = tid; i < K; i += kThreads) cn2_s[i] = cn2[(size_t)s * K + i];
    if (tid < kTileF) {
      mask_s[tid] = (mask != nullptr && tid < nf)
                        ? mask[(size_t)(f0 + tid) * NQ + s] : 1.0f;
    }
    __syncthreads();

    // in_proj: each warp owns kFramesPerWarp frames; lanes split the D axis.
    {
      float part[kFramesPerWarp][DC];
#pragma unroll
      for (int q = 0; q < kFramesPerWarp; ++q)
#pragma unroll
        for (int j = 0; j < DC; ++j) part[q][j] = 0.0f;
      for (int c = lane; c < D; c += 32) {
        float w[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) w[j] = wi_s[j * D + c];
#pragma unroll
        for (int q = 0; q < kFramesPerWarp; ++q) {
          const float r = res[(warp + q * kWarps) * D + c];
#pragma unroll
          for (int j = 0; j < DC; ++j) part[q][j] = fmaf(r, w[j], part[q][j]);
        }
      }
#pragma unroll
      for (int q = 0; q < kFramesPerWarp; ++q)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          float v = part[q][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          part[q][j] = v;
        }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kFramesPerWarp; ++q)
#pragma unroll
          for (int j = 0; j < DC; ++j)
            e_s[(warp + q * kWarps) * DC + j] =
                __fadd_rn(part[q][j], bi[(size_t)s * DC + j]);
      }
    }
    __syncthreads();

    // L2-normalize e, dividing by max(|e|, 1e-12) as F.normalize does.
    if (tid < kTileF) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float v = e_s[tid * DC + j];
        ss = __fadd_rn(ss, __fmul_rn(v, v));
      }
      const float den = fmaxf(sqrtf(ss), 1e-12f);
      float n2 = 0.0f;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float v = e_s[tid * DC + j] / den;
        en_s[tid * DC + j] = v;
        n2 = __fadd_rn(n2, __fmul_rn(v, v));
      }
      en2_s[tid] = n2;
    }
    __syncthreads();

    // Scores and argmin over the codebook; ties keep the lowest index.
    {
      float en[kFramesPerWarp][DC];
      float en2[kFramesPerWarp];
      float best[kFramesPerWarp];
      int arg[kFramesPerWarp];
#pragma unroll
      for (int q = 0; q < kFramesPerWarp; ++q) {
        const int f = warp + q * kWarps;
#pragma unroll
        for (int j = 0; j < DC; ++j) en[q][j] = en_s[f * DC + j];
        en2[q] = en2_s[f];
        best[q] = INFINITY;
        arg[q] = 0;
      }
      for (int k = lane; k < K; k += 32) {
        float c[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) c[j] = cn_s[j * K + k];
        const float ck = cn2_s[k];
#pragma unroll
        for (int q = 0; q < kFramesPerWarp; ++q) {
          float dot = __fmul_rn(en[q][0], c[0]);
#pragma unroll
          for (int j = 1; j < DC; ++j) dot = fmaf(en[q][j], c[j], dot);
          const float dist = __fadd_rn(__fsub_rn(en2[q], __fmul_rn(2.0f, dot)), ck);
          if (dist < best[q]) {
            best[q] = dist;
            arg[q] = k;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kFramesPerWarp; ++q) {
        float b = best[q];
        int a = arg[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, b, off);
          const int oa = __shfl_xor_sync(0xffffffffu, a, off);
          if (ob < b || (ob == b && oa < a)) {
            b = ob;
            a = oa;
          }
        }
        if (lane == 0) {
          const int f = warp + q * kWarps;
          idx_s[f] = a;
          if (f < nf) codes[(size_t)(f0 + f) * NQ + s] = a;
        }
      }
    }
    __syncthreads();

    // Codebook gather (the un-normalized row) and the straight-through sum.
    for (int t = tid; t < kTileF * DC; t += kThreads) {
      const int f = t / DC;
      const int j = t - f * DC;
      const float e = e_s[t];
      const float q = cb[((size_t)s * K + idx_s[f]) * DC + j];
      zqe_s[t] = __fadd_rn(e, __fsub_rn(q, e));
    }
    __syncthreads();

    // out_proj, the unmasked residual update and the masked z_q sum.
    for (int c = tid; c < D; c += kThreads) {
      float w[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) w[j] = wo[((size_t)s * DC + j) * D + c];
      const float b = bo[(size_t)s * D + c];
      for (int f = 0; f < kTileF; ++f) {
        float o = __fmul_rn(zqe_s[f * DC], w[0]);
#pragma unroll
        for (int j = 1; j < DC; ++j) o = fmaf(zqe_s[f * DC + j], w[j], o);
        o = __fadd_rn(o, b);
        res[f * D + c] = __fsub_rn(res[f * D + c], o);
        acc[f * D + c] = __fadd_rn(acc[f * D + c], __fmul_rn(o, mask_s[f]));
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nf * D; i += kThreads) zq[(size_t)f0 * D + i] = acc[i];
}

template <int DC>
cudaError_t launch(const float* z, const float* wiT, const float* bi,
                   const float* wo, const float* bo, const float* cb,
                   const float* cnT, const float* cn2, const float* mask,
                   float* zq, int32_t* codes, int F, int D, int NQ, int K,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats(D, K, DC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rvq_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((F + kTileF - 1) / kTileF);
  rvq_kernel<DC><<<blocks, kThreads, bytes, stream>>>(
      z, wiT, bi, wo, bo, cb, cnT, cn2, mask, zq, codes, F, D, NQ, K);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block asks for, in bytes (the wrapper checks it against
// the card's limit before launching).
extern "C" long long vrvq_rvq_smem_bytes(int D, int K, int DC) {
  return (long long)(smem_floats(D, K, DC) * sizeof(float));
}

// z (F, D); wiT (NQ, DC, D); bi (NQ, DC); wo (NQ, DC, D); bo (NQ, D);
// cb and the normalized cn^T: (NQ, K, DC) and (NQ, DC, K); cn2 (NQ, K);
// mask (F, NQ) or null for all stages kept; zq (F, D); codes (F, NQ) int32.
// All float32 and contiguous. Returns the cudaError_t of the launch.
extern "C" int vrvq_rvq_forward(const float* z, const float* wiT,
                                const float* bi, const float* wo,
                                const float* bo, const float* cb,
                                const float* cnT, const float* cn2,
                                const float* mask, float* zq, int* codes,
                                int F, int D, int NQ, int K, int DC,
                                void* stream) {
  if (F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DC) {
    case 4:
      return (int)launch<4>(z, wiT, bi, wo, bo, cb, cnT, cn2, mask, zq, codes,
                            F, D, NQ, K, s);
    case 8:
      return (int)launch<8>(z, wiT, bi, wo, bo, cb, cnT, cn2, mask, zq, codes,
                            F, D, NQ, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
