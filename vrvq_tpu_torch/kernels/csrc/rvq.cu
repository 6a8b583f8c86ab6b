// Fused residual vector quantization, forward only: all Nq stages for a tile
// of frames in one thread-block cluster, the residual and the z_q sum kept in
// shared memory from the first stage to the last.
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
// read of one row.
//
// Bound on the H100: operations, 2 (D d + K d + d D) FLOPs per frame and
// stage, under a microsecond for a serve window. What holds the kernel back
// is latency: the stages run one after another, and each is a chain of
// dependent steps (in-projection, argmin over K codes, out-projection) on a
// few kilobytes. The first version of this kernel ran one block of 256
// threads per 16 frames with 198 KB of shared memory: 5 blocks on 132 SMs for
// a 72-frame window, each stage first copying 64 KB of weights with nothing
// to overlap, then six block-wide barriers.
//
// Design. One cluster of cs CTAs (cs <= 8, portable) per tile of TF frames;
// CTA r owns channels [r D/cs, (r+1) D/cs) of the residual and of the z_q sum
// and codes [r K/cs, (r+1) K/cs), with the matching slices of wi^T, wo, bo,
// the normalized codebook^T, |cn|^2 and the codebook. A warp owns a frame;
// each lane keeps the same D/(32 cs) channels of it from the in-projection to
// the out-projection, so the residual needs no barrier between stages. One
// stage:
//   1. each CTA sums e over its channels (a partial); the warp reduces it so
//      that each lane ends with one component (reduce-scatter), and the lanes
//      send the components into every CTA's shared memory (distributed
//      shared memory), counted on that CTA's mbarrier;
//   2. each CTA waits on its own mbarrier for the cs partials;
//   3. every CTA adds them in rank order 0..cs-1, then bi: every CTA holds a
//      bit-identical e (another order in another CTA could pick another
//      code);
//   4. each CTA normalizes e and scans its K/cs codes, (dist, index) with the
//      lowest index on ties, and sends that candidate with its un-normalized
//      codebook row to every CTA, as in 1;
//   5. each CTA waits for the cs candidates and takes their minimum in rank
//      order, so on equal distances the lowest index wins, as argmax's first
//      maximum does;
//   6. each CTA runs the out-projection of the winning row on its own
//      channels.
// Sends are asynchronous remote stores (st.async) that count their bytes on
// the receiver's mbarrier: no fence on the sending side and no cluster-wide
// barrier; each CTA waits only on its own barriers, so a stage costs two
// one-way trips between SMs. No global store happens inside the loop (the
// codes wait in shared memory until the end), since a release would wait for
// it. The two exchanges gate each other, so one buffer of each suffices: no
// CTA can send stage s + 1's partial before every CTA has read stage s's
// candidates. A stage's weight slices (about 17 KB at cs 8) arrive by TMA bulk
// copies (cp.async.bulk, completing on an mbarrier) into two buffers: a buffer
// is refilled with the stage after next once the CTA has every partial of the
// next stage, which its own frames send only after they are done with the
// buffer, so each copy overlaps a stage of work. prepare_rvq
// (ops/rvq_kernel.py) packs each (stage, rank) slice contiguously, once per
// compress, so each is one copy.
//
// Numerics: float32 throughout and no tensor cores (TF32 would round the
// projections to ~10 mantissa bits and flip codes). Every rounding step of
// the plain version's norm and score is its own (__fmul_rn / __fadd_rn keep
// the compiler from contracting them); only the summation order of the two
// projections differs from the plain version's matmuls. The ragged last tile
// runs on zeros and is never stored.
//
// Shapes. Any codebook_dim d from 1 to 32, any D and K. The kernel is built
// for d in {1, 2, 4, 8, 16, 32} (a warp's reduce-scatter halves d at each
// level); prepare_rvq pads d up to the next of these with zero components,
// and D and K up to cs slices of a multiple of 4 floats with zero channels
// and with codes whose |cn|^2 is +inf: a zero component adds exact zeros to
// every sum, a padded code never wins (its distance is +inf), and padded
// channels keep a zero residual and are never stored. The kernel reads z and
// writes z_q at the real width D (with scalar accesses where D is not the
// padded width) and never stores a padded channel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;       // threads that share one frame: a warp
// Frames per cluster (a warp each). On an H100, 4 was faster than 8 and 16
// both at a 72-frame window and at 862 frames: more clusters, the same
// latency per stage.
constexpr int TF = 4;
constexpr int kMaxCluster = 8;   // portable cluster sizes
constexpr int kRing = 2;         // stages of weights in shared memory
constexpr int kMaxDevices = 64;  // cards whose shared-memory limit is kept
// mbarriers: the ring's, then the two exchanges' (partial e, candidates)
constexpr int kBarrierBytes = 16 * (((kRing + 2) * 8 + 15) / 16);
constexpr unsigned kFull = 0xffffffffu;

// Floats of one (stage, rank) slice as prepare_rvq packs it:
// wi^T (d, Dc) | wo (d, Dc) | bo (Dc) | cn^T (d, Kc) | |cn|^2 (Kc) |
// codebook (Kc, d) | bi (d) | zeros to a multiple of 4 (16-byte copies).
__host__ __device__ inline int stage_floats(int Dc, int Kc, int DC) {
  return (2 * DC * Dc + Dc + DC * Kc + Kc + Kc * DC + DC + 3) / 4 * 4;
}

// A candidate as a CTA sends it: distance, code (int bits), two floats of
// padding, the code's un-normalized codebook row (zero-padded to 4 floats
// when d < 4); whole float4s.
__host__ __device__ inline constexpr int cand_floats(int DC) {
  return 4 + (DC < 4 ? 4 : DC);
}

__host__ inline size_t smem_bytes(int cs, int Dc, int Kc, int DC, int NQ) {
  return kBarrierBytes +
         sizeof(float) * ((size_t)kRing * stage_floats(Dc, Kc, DC) +
                          2 * (size_t)TF * Dc +
                          (size_t)cs * TF * (DC + cand_floats(DC)) +
                          2 * (size_t)TF * NQ);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the phase of `parity` to complete; acquire at cluster scope, so
// what other CTAs wrote here before they arrived is visible.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void init_barrier(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Announces `bytes` more to arrive on this CTA's barrier in its current
// phase (the phase's one local arrival).
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// The shared::cluster address of `p`'s place in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t remote_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// An asynchronous 16-byte store into another CTA's shared memory, counted on
// that CTA's barrier (both as remote_addr gives them): no fence on this side,
// the receiver sees the bytes once its barrier's phase completes.
__device__ __forceinline__ void send1(uint32_t to, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      :: "r"(to), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void send4(uint32_t to, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(to), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

template <int DC>
__global__ void __launch_bounds__(TF * kLanes)
rvq_kernel(const float* __restrict__ z, const float* __restrict__ packed,
           const float* __restrict__ mask, float* __restrict__ zq,
           int32_t* __restrict__ codes, int F, int D, int Dp, int NQ, int Kp) {
  constexpr int CF = cand_floats(DC);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int Dc = Dp / cs;  // this CTA's channels, padding included
  const int Kc = Kp / cs;
  const int SF = stage_floats(Dc, Kc, DC);

  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(smem);  // (kRing,)
  uint64_t* part_bar = ring_bar + kRing;
  uint64_t* cand_bar = part_bar + 1;
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);  // (kRing, SF)
  float* res = ring + kRing * SF;          // (TF, Dc)
  float* acc = res + TF * Dc;              // (TF, Dc)
  float* part_in = acc + TF * Dc;          // (cs, TF, DC) each CTA's partial e
  float* cand_in = part_in + cs * TF * DC; // (cs, TF, CF) each CTA's best
  float* mask_s = cand_in + cs * TF * CF;  // (TF, NQ)
  int* codes_s = reinterpret_cast<int*>(mask_s + TF * NQ);  // (TF, NQ)

  const int tid = threadIdx.x;
  const int f = tid / kLanes;  // this warp's frame
  const int sub = tid % kLanes;
  const int f0 = (blockIdx.x / cs) * TF;
  const int nf = min(TF, F - f0);
  const float* mine = packed + (size_t)rank * SF;  // stage s at s * cs * SF
  // A frame's partial ends reduced so that lane `sub` holds component
  // sub / G; that lane sends it to CTAs sub % G, sub % G + G, ... (slot
  // `rank` there). Lane `sub` < cs sends the frame's candidate to CTA `sub`.
  constexpr int G = kLanes / DC;
  constexpr int KD = (kMaxCluster + G - 1) / G;
  uint32_t part_to[KD], part_bar_to[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const int d = min(sub % G + k * G, cs - 1);
    part_to[k] = remote_addr(part_in + (rank * TF + f) * DC + sub / G, d);
    part_bar_to[k] = remote_addr(part_bar, d);
  }
  const int to = sub < cs ? sub : rank;
  const uint32_t cand_to = remote_addr(cand_in + (rank * TF + f) * CF, to);
  const uint32_t cand_bar_to = remote_addr(cand_bar, to);
  // each phase of an exchange barrier: one local arrival, and the bytes of
  // every CTA's partials (candidates) of every frame
  const uint32_t part_bytes = cs * TF * DC * sizeof(float);
  const uint32_t cand_bytes = cs * TF * CF * sizeof(float);

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) init_barrier(ring_bar + i, 1);
    init_barrier(part_bar, 1);
    init_barrier(cand_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect_bytes(part_bar, part_bytes);  // stage 0's phases
    expect_bytes(cand_bar, cand_bytes);
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < min(kRing, NQ); ++s)
      bulk_load(ring + (size_t)s * SF, mine + (size_t)s * cs * SF,
                SF * sizeof(float), ring_bar + s);
  }
  // this CTA's channels of z (zeros past F and past D) in float4s where D
  // is the padded width, loads unrolled so that several are in flight, else
  // one by one; the z_q sum; the mask tile
  if (D == Dp) {
    const int q4 = Dc / 4;
#pragma unroll 4
    for (int i = tid; i < TF * q4; i += blockDim.x) {
      const int ff = i / q4;
      const int c = 4 * (i - ff * q4);
      const float4 v = ff < nf ? *reinterpret_cast<const float4*>(
                                     z + (size_t)(f0 + ff) * D + rank * Dc + c)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(res + ff * Dc + c) = v;
      *reinterpret_cast<float4*>(acc + ff * Dc + c) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int i = tid; i < TF * Dc; i += blockDim.x) {
      const int ff = i / Dc;
      const int g = rank * Dc + (i - ff * Dc);
      res[i] = (ff < nf && g < D) ? z[(size_t)(f0 + ff) * D + g] : 0.0f;
      acc[i] = 0.0f;
    }
  }
  for (int i = tid; i < TF * NQ; i += blockDim.x)
    mask_s[i] = (mask != nullptr && i < nf * NQ) ? mask[(size_t)f0 * NQ + i]
                                                 : 1.0f;
  // every CTA's barriers are set up before any CTA sends to them
  cluster.sync();

  const float* rf = res + f * Dc;
  for (int s = 0; s < NQ; ++s) {
    const int slot = s % kRing;
    wait_parity(ring_bar + slot, (uint32_t)((s / kRing) & 1));
    const float* wiT = ring + (size_t)slot * SF;  // (DC, Dc)
    const float* wo = wiT + DC * Dc;              // (DC, Dc)
    const float* bo = wo + DC * Dc;               // (Dc,)
    const float* cnT = bo + Dc;                   // (DC, Kc)
    const float* cn2 = cnT + DC * Kc;             // (Kc,)
    const float* cb = cn2 + Kc;                   // (Kc, DC)
    const float* bi = cb + Kc * DC;               // (DC,)

    // 1. partial in-projection over this CTA's channels, sent to every CTA
    float p[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) p[j] = 0.0f;
#pragma unroll 4
    for (int c = sub; c < Dc; c += kLanes) {
      const float r = rf[c];
#pragma unroll
      for (int j = 0; j < DC; ++j) p[j] = fmaf(r, wiT[j * Dc + c], p[j]);
    }
    // reduce-scatter: each level halves the components a lane keeps
#pragma unroll
    for (int lvl = 0; (DC >> lvl) > 1; ++lvl) {
      const int half = DC >> (lvl + 1);
      const bool upper = (sub & (16 >> lvl)) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float give = upper ? p[i] : p[half + i];
        const float keep = upper ? p[half + i] : p[i];
        p[i] = keep + __shfl_xor_sync(kFull, give, 16 >> lvl);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      p[0] += __shfl_xor_sync(kFull, p[0], off);
#pragma unroll
    for (int k = 0; k < KD; ++k)
      if (sub % G + k * G < cs) send1(part_to[k], p[0], part_bar_to[k]);

    // 2. every CTA's partial is here
    wait_parity(part_bar, (uint32_t)(s & 1));
    if (tid == 0) {
      // every frame of this CTA has sent its partial, so none can send the
      // next stage's before this phase is announced, and stage s - 1 is over
      if (s + 1 < NQ) expect_bytes(part_bar, part_bytes);
      const int t = s - 1 + kRing;
      if (s >= 1 && t < NQ)
        bulk_load(ring + (size_t)(t % kRing) * SF, mine + (size_t)t * cs * SF,
                  SF * sizeof(float), ring_bar + t % kRing);
    }

    // 3. e: the partials in rank order, then bi; the same bits in every CTA
    float ej = 0.0f;  // lane j < DC keeps component j
    {
      float v[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        v[r] = (r < cs && sub < DC) ? part_in[(r * TF + f) * DC + sub] : 0.0f;
      ej = v[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < cs) ej = __fadd_rn(ej, v[r]);
      if (sub < DC) ej = __fadd_rn(ej, bi[sub]);
    }
    float e[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) e[j] = __shfl_sync(kFull, ej, j);

    // 4. normalize as F.normalize does (lane j divides component j), then
    //    scan this CTA's codes
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) ss = __fadd_rn(ss, __fmul_rn(e[j], e[j]));
    const float enj = ej / fmaxf(sqrtf(ss), 1e-12f);
    float en[DC];
    float n2 = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      en[j] = __shfl_sync(kFull, enj, j);
      n2 = __fadd_rn(n2, __fmul_rn(en[j], en[j]));
    }
    float best = INFINITY;
    int arg = INT_MAX;
#pragma unroll 4
    for (int k = sub; k < Kc; k += kLanes) {
      float dot = __fmul_rn(en[0], cnT[k]);
#pragma unroll
      for (int j = 1; j < DC; ++j) dot = fmaf(en[j], cnT[j * Kc + k], dot);
      const float dist = __fadd_rn(__fsub_rn(n2, __fmul_rn(2.0f, dot)), cn2[k]);
      if (dist < best) {
        best = dist;
        arg = k;
      }
    }
    {
      // the warp's minimum: distances as order-preserving keys (-0 as +0, so
      // that equal distances have equal keys), then the lowest index of
      // those at the minimum
      const uint32_t u = __float_as_uint(best == 0.0f ? 0.0f : best);
      const uint32_t key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      const uint32_t low = __reduce_min_sync(kFull, key);
      arg = (int)__reduce_min_sync(kFull, key == low ? (uint32_t)arg : 0xffffffffu);
      best = __uint_as_float((low & 0x80000000u) ? (low & 0x7fffffffu) : ~low);
    }
    if (arg == INT_MAX) arg = 0;  // every score NaN: stay in range
    if (sub < cs) {  // the candidate, with its row, to every CTA
      send4(cand_to, make_float4(best, __int_as_float(rank * Kc + arg), 0.0f, 0.0f),
            cand_bar_to);
      if constexpr (DC >= 4) {
#pragma unroll
        for (int j = 0; j < DC; j += 4)
          send4(cand_to + 4 * (4 + j),
                *reinterpret_cast<const float4*>(cb + arg * DC + j), cand_bar_to);
      } else {
        const float* row = cb + arg * DC;
        send4(cand_to + 16,
              make_float4(row[0], DC == 2 ? row[DC - 1] : 0.0f, 0.0f, 0.0f),
              cand_bar_to);
      }
    }

    // 5. every CTA's candidate is here: the minimum in rank order, so on
    //    equal distances the lowest index wins, as argmax's first maximum does
    wait_parity(cand_bar, (uint32_t)(s & 1));
    if (tid == 0 && s + 1 < NQ) expect_bytes(cand_bar, cand_bytes);
    int win = 0;
    {
      float d[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        d[r] = r < cs ? cand_in[(r * TF + f) * CF] : INFINITY;
      best = d[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (d[r] < best) {
          best = d[r];
          win = r;
        }
    }
    const float* w = cand_in + (win * TF + f) * CF;
    if (sub == 0) codes_s[f * NQ + s] = __float_as_int(w[1]);

    // 6. the straight-through sum, then the out-projection on this CTA's
    //    channels: residual and masked z_q sum
    const float zj = sub < DC ? __fadd_rn(ej, __fsub_rn(w[4 + sub], ej)) : 0.0f;
    float zqe[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) zqe[j] = __shfl_sync(kFull, zj, j);
    const float m = mask_s[f * NQ + s];
    float* rw = res + f * Dc;
    float* aw = acc + f * Dc;
#pragma unroll 4
    for (int c = sub; c < Dc; c += kLanes) {
      float o = __fmul_rn(zqe[0], wo[c]);
#pragma unroll
      for (int j = 1; j < DC; ++j) o = fmaf(zqe[j], wo[j * Dc + c], o);
      o = __fadd_rn(o, bo[c]);
      rw[c] = __fsub_rn(rw[c], o);
      aw[c] = __fadd_rn(aw[c], __fmul_rn(o, m));
    }
  }

  // each warp stores the z_q channels and the codes of its frame (no global
  // store inside the loop); every write into this CTA's shared memory from
  // another CTA came before the last wait, so it may leave
  if (f < nf) {
    const int real = min(Dc, D - rank * Dc);  // channels past D are padding
    for (int c = sub; c < real; c += kLanes)
      zq[(size_t)(f0 + f) * D + rank * Dc + c] = acc[f * Dc + c];
    if (rank == 0)
      for (int t = sub; t < NQ; t += kLanes)
        codes[(size_t)(f0 + f) * NQ + t] = codes_s[f * NQ + t];
  }
}

template <int DC>
cudaError_t launch(const float* z, const float* packed, const float* mask,
                   float* zq, int32_t* codes, int F, int D, int Dp, int NQ,
                   int Kp, int cs, cudaStream_t stream) {
  const size_t bytes = smem_bytes(cs, Dp / cs, Kp / cs, DC, NQ);
  // raised once per size and card (the attribute is the current card's),
  // not per launch (a CUDA graph can then capture it)
  static size_t configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || bytes > configured[dev]) {
    err = cudaFuncSetAttribute(rvq_kernel<DC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((F + TF - 1) / TF) * cs));
  cfg.blockDim = dim3(TF * kLanes);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rvq_kernel<DC>, z, packed, mask, zq, codes,
                           F, D, Dp, NQ, Kp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid(int D, int Dp, int Kp, int DC, int NQ, int cs) {
  return (DC == 1 || DC == 2 || DC == 4 || DC == 8 || DC == 16 || DC == 32) &&
         cs >= 1 && cs <= kMaxCluster && Dp % cs == 0 && Kp % cs == 0 &&
         (Dp / cs) % 4 == 0 && (Kp / cs) % 4 == 0 && D >= 1 && D <= Dp &&
         NQ >= 1;
}

}  // namespace

// Floats of one (stage, rank) slice of the packed weights, at the padded
// widths Dp, Kp and d: prepare_rvq packs (Nq, cs, this) and the wrapper
// checks its layout against it.
extern "C" int vrvq_rvq_stage_floats(int Dp, int Kp, int DC, int cs) {
  return stage_floats(Dp / cs, Kp / cs, DC);
}

// Shared memory one CTA asks for, in bytes (the wrapper checks it against the
// card's limit before launching).
extern "C" long long vrvq_rvq_smem_bytes(int Dp, int Kp, int DC, int NQ, int cs) {
  return (long long)smem_bytes(cs, Dp / cs, Kp / cs, DC, NQ);
}

// z (F, D); packed (NQ, cs, stage_floats) from prepare_rvq at the padded
// widths Dp >= D, Kp and DC (a power of two up to 32); mask (F, NQ) or null
// for all stages kept; zq (F, D); codes (F, NQ) int32. All float32 and
// contiguous, z and packed 16-byte aligned. cs: cluster size (divides Dp and
// Kp, the slices a multiple of 4). Returns the cudaError_t of the launch.
extern "C" int vrvq_rvq_forward(const float* z, const float* packed,
                                const float* mask, float* zq, int* codes,
                                int F, int D, int Dp, int NQ, int Kp, int DC,
                                int cs, void* stream) {
  if (F <= 0) return 0;
  if (!valid(D, Dp, Kp, DC, NQ, cs) ||
      ((reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(z)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DC) {
    case 1: return (int)launch<1>(z, packed, mask, zq, codes, F, D, Dp, NQ, Kp, cs, s);
    case 2: return (int)launch<2>(z, packed, mask, zq, codes, F, D, Dp, NQ, Kp, cs, s);
    case 4: return (int)launch<4>(z, packed, mask, zq, codes, F, D, Dp, NQ, Kp, cs, s);
    case 8: return (int)launch<8>(z, packed, mask, zq, codes, F, D, Dp, NQ, Kp, cs, s);
    case 16: return (int)launch<16>(z, packed, mask, zq, codes, F, D, Dp, NQ, Kp, cs, s);
    default: return (int)launch<32>(z, packed, mask, zq, codes, F, D, Dp, NQ, Kp, cs, s);
  }
}
