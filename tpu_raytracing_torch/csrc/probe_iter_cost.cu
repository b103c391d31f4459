// P3: the cost of one iteration of a brute-group-shaped loop body.
//
// Replaces the Pallas probe scripts/probe_iter_cost.py:155 (the kernel that
// make(R, roll, dynamic, chain, loop) builds). Each iteration q reads
// triangle block q % 8 of a resident (128, 128) table, rolls its lanes by
// s = (q % 12) * 10, and runs Moller-Trumbore of the block's 16 rows
// against R x 128 rays, keeping each ray's least t and its triangle id:
//
//   row i of block b:  tris[(b * 16 + i) * 128 + (s + k) % 128]
//                      k 0-2 p0, 3-5 e1, 6-8 e2, 9 triangle id as int32 bits
//   ray (r, lane):     o, d rows ax * R + r (ax = 0..2), t_min row r
//   out (R, 128):      t_best + float(best)
//
// Only the script's five configurations are built, all with roll and the
// dynamic block read: R = 4 with loop fori, dynfori and while, and the chain
// (while) at R = 4 and R = 1. fori's trip count is a template constant,
// built for the two counts the port runs (256, the card tests' count, and
// 4,096, the script's default); dynfori and while take it at run time, and
// without the chain they are the same loop here. In the chain the next
// address is q + 1 + (drain & 1), where the drain is the script's wrapping
// int32 sum of min(best, 1) over every ray of the tile: its parity is the
// parity of the number of odd terms, which __syncthreads_count gives
// exactly. That one block barrier per iteration is the dependency the probe
// prices (the TPU's vector-to-scalar drain).
//
// Layout: one block for the probe's one tile, S = kRaysPerThread rays a
// thread (R x 128 / S threads; thread x holds rays x, x + R * 128 / S,
// ...), the whole table staged once in 64 KB of shared memory (the TPU
// kernel held it in VMEM).
// The roll is an address offset (s <= 110, so no row wraps); a row's ten
// words are five 8-byte broadcast loads, shared by the thread's S rays.
//
// What bounds it on the H100: it runs on one SM by design, as the TPU probe
// runs one tile on one core, so it measures the latency of an iteration,
// not the card's throughput. The script writes 16 x 44 fp32 operations for
// each of R x 128 rays, three of them IEEE divides (about ten instructions
// each). The design (redesigned for Hopper after its first port):
//
// - K3's exact prefilter (probe_common.cuh::group): a first pass computes
//   each (row, ray)'s den and numerators and rejects, without a divide, the
//   pairs whose triangle the ray's line misses by more than about 2^-16 of
//   |den|; a second takes only the others, about 3% on the script's inputs,
//   through the full test. Each ray's result is the one-pass fold's, bit
//   for bit.
// - A ray a thread. The kernel is written for S rays a thread (a row's
//   loads shared by S rays, S chains in flight), but on an H100 80GB HBM3
//   at 700 W S = 2 and 4 ran 8-12% and 77-100% slower than S = 1 at R = 4
//   without the chain, and 49% and 262-285% slower with the chain at R = 1
//   (scripts/torch_probe_ab.py):
//   fewer warps hide less of the second pass's latency (a row load, then
//   the divides), and a warp's trips there grow with S (2.4, 3.5 and 5.4
//   a warp an iteration at S = 1, 2, 4). So kRaysPerThread is 1.
//
// So one SM's fp32 issue bounds the loops without the chain (the first
// pass, 44 operations a (row, ray), none of which fuse); with it, each
// iteration also waits on the barrier, and the warps cannot overlap one
// iteration's tail with the next one's head. With the chain, a thread's
// drain term is the parity of its S rays' min(best, 1) terms, so the
// parity of __syncthreads_count over the block is still the tile's.
//
// Numerics: no fast math and -fmad=false, so every operation rounds as the
// plain PyTorch version's does; ids move as bits only (small ids are
// denormal floats). The group body lives in probe_common.cuh, which P1's
// leaf loop shares.

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using probe::kLane;
using probe::kRows;
constexpr int kBlocks = 8;       // blocks of the table
constexpr int kTableBytes = kBlocks * kRows * kLane * 4;

enum Loop { kFori = 0, kDynFori = 1, kWhile = 2 };

// Rays a thread (S): 1, 2 or 4; 1 measured fastest in every configuration.
constexpr int kRaysPerThread = 1;

// One iteration for this thread's rays.
template <int S>
__device__ __forceinline__ void group(const float* table, int q,
                                      probe::MtRay (&ray)[S]) {
  probe::group<S>(table + (q % kBlocks) * kRows * kLane, (q % 12) * 10, ~0u,
                  ray);
}

template <int R, int S, bool CHAIN, int LOOP, int FIXED>
__global__ void __launch_bounds__(R * kLane / S)
    probe_iter_cost(const float* __restrict__ tris,
                    const float* __restrict__ o_in,
                    const float* __restrict__ d_in,
                    const float* __restrict__ t_min_in,
                    float* __restrict__ out, int* __restrict__ iters_run,
                    int iters) {
  constexpr int kThreads = R * kLane / S;
  extern __shared__ float4 table4[];
  const float4* src = reinterpret_cast<const float4*>(tris);
  for (int k = threadIdx.x; k < kTableBytes / 16; k += kThreads)
    table4[k] = src[k];
  const float* table = reinterpret_cast<const float*>(table4);
  probe::MtRay ray[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = threadIdx.x + k * kThreads;  // ray (j / 128, j % 128)
    const int r = j / kLane, lane = j % kLane;
    const auto at = [&](const float* x, int ax) {
      return x[(ax * R + r) * kLane + lane];
    };
    ray[k].ray = tpu_rt::Ray{at(o_in, 0), at(o_in, 1), at(o_in, 2),
                             at(d_in, 0), at(d_in, 1), at(d_in, 2),
                             0.0f,        0.0f,        0.0f,
                             t_min_in[j]};
    ray[k].t_best = INFINITY;
    ray[k].best = -1;
  }
  int n_run = 0;
  __syncthreads();
  if constexpr (LOOP == kFori) {
    for (int q = 0; q < FIXED; ++q) group<S>(table, q, ray);
    n_run = FIXED;
  } else if constexpr (LOOP == kDynFori) {
    for (int q = 0; q < iters; ++q) group<S>(table, q, ray);
    n_run = iters;
  } else {
    int q = 0;
    while (q < iters) {
      group<S>(table, q, ray);
      if constexpr (CHAIN) {
        int odd = 0;
#pragma unroll
        for (int k = 0; k < S; ++k) odd ^= min(ray[k].best, 1) & 1;
        q += 1 + (__syncthreads_count(odd) & 1);
      } else {
        q += 1;
      }
      ++n_run;
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k)
    out[threadIdx.x + k * kThreads] = ray[k].t_best + (float)ray[k].best;
  if (iters_run != nullptr && threadIdx.x == 0) *iters_run = n_run;
}

template <int R, int S, bool CHAIN, int LOOP, int FIXED = 0>
int launch(const float* tris, const float* o, const float* d,
           const float* t_min, float* out, int* iters_run, int iters,
           cudaStream_t stream) {
  auto kernel = probe_iter_cost<R, S, CHAIN, LOOP, FIXED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, R * kLane / S, kTableBytes, stream>>>(tris, o, d, t_min, out,
                                                     iters_run, iters);
  return (int)cudaGetLastError();
}

// fori at R = 4: the instantiation whose compiled trip count is iters.
int launch_fori(const float* tris, const float* o, const float* d,
                const float* t_min, float* out, int* iters_run, int iters,
                cudaStream_t stream) {
  constexpr int S = kRaysPerThread;
  if (iters == 256)
    return launch<4, S, false, kFori, 256>(tris, o, d, t_min, out, iters_run,
                                           iters, stream);
  if (iters == 4096)
    return launch<4, S, false, kFori, 4096>(tris, o, d, t_min, out,
                                            iters_run, iters, stream);
  return (int)cudaErrorInvalidValue;  // a trip count that is not built
}

}  // namespace

extern "C" int tpu_rt_probe_iter_cost(const float* tris, const float* o,
                                      const float* d, const float* t_min,
                                      float* out, int* iters_run, int R,
                                      int chain, int loop, int iters,
                                      void* stream_ptr) {
  constexpr int S = kRaysPerThread;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (iters < 0) return (int)cudaErrorInvalidValue;
  if (R == 4 && !chain && loop == kFori)
    return launch_fori(tris, o, d, t_min, out, iters_run, iters, stream);
  if (R == 4 && !chain && loop == kDynFori)
    return launch<4, S, false, kDynFori>(tris, o, d, t_min, out, iters_run,
                                         iters, stream);
  if (R == 4 && !chain && loop == kWhile)
    return launch<4, S, false, kWhile>(tris, o, d, t_min, out, iters_run,
                                       iters, stream);
  if (R == 4 && chain && loop == kWhile)
    return launch<4, S, true, kWhile>(tris, o, d, t_min, out, iters_run,
                                      iters, stream);
  if (R == 1 && chain && loop == kWhile)
    return launch<1, S, true, kWhile>(tris, o, d, t_min, out, iters_run,
                                      iters, stream);
  return (int)cudaErrorInvalidValue;  // not one of the script's five
}
