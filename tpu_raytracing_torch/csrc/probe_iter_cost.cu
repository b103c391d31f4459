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
// Layout: one block for the probe's one tile, one thread per ray (R x 128
// threads), the whole table staged once in 64 KB of shared memory (the
// TPU kernel held it in VMEM). The roll is an address offset; the reads are
// broadcasts, since every thread of the block reads the same row.
//
// What bounds it on the H100: it runs on one SM by design, as the TPU probe
// runs one tile on one core, so it measures the latency of an iteration,
// not the card's throughput. An iteration is 16 x 44 fp32 operations for
// each of R x 128 rays, three of them IEEE divides, so one SM's fp32 issue
// bounds the loops without the chain; with it, each iteration also waits
// on the barrier, so the SM's 16 (R = 4) or 4 (R = 1) warps cannot overlap
// one iteration's tail with the next one's head.
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

// One iteration for this thread's ray: (t_best, best) updated in place.
__device__ __forceinline__ void group(const float* table, int q,
                                      const float o[3], const float d[3],
                                      float t_min, float& t_best, int& best) {
  probe::group(table + (q % kBlocks) * kRows * kLane, (q % 12) * 10, true, o,
               d, t_min, t_best, best);
}

template <int R, bool CHAIN, int LOOP, int FIXED>
__global__ void __launch_bounds__(R * kLane)
    probe_iter_cost(const float* __restrict__ tris,
                    const float* __restrict__ o_in,
                    const float* __restrict__ d_in,
                    const float* __restrict__ t_min_in,
                    float* __restrict__ out, int* __restrict__ iters_run,
                    int iters) {
  extern __shared__ float4 table4[];
  const float4* src = reinterpret_cast<const float4*>(tris);
  for (int k = threadIdx.x; k < kTableBytes / 16; k += blockDim.x)
    table4[k] = src[k];
  const float* table = reinterpret_cast<const float*>(table4);
  const int r = threadIdx.x / kLane, lane = threadIdx.x % kLane;
  float o[3], d[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = o_in[(ax * R + r) * kLane + lane];
    d[ax] = d_in[(ax * R + r) * kLane + lane];
  }
  const float t_min = t_min_in[r * kLane + lane];
  float t_best = INFINITY;
  int best = -1;
  int n_run = 0;
  __syncthreads();
  if constexpr (LOOP == kFori) {
    for (int q = 0; q < FIXED; ++q) group(table, q, o, d, t_min, t_best, best);
    n_run = FIXED;
  } else if constexpr (LOOP == kDynFori) {
    for (int q = 0; q < iters; ++q) group(table, q, o, d, t_min, t_best, best);
    n_run = iters;
  } else {
    int q = 0;
    while (q < iters) {
      group(table, q, o, d, t_min, t_best, best);
      if constexpr (CHAIN)
        q += 1 + (__syncthreads_count(min(best, 1) & 1) & 1);
      else
        q += 1;
      ++n_run;
    }
  }
  out[r * kLane + lane] = t_best + (float)best;
  if (iters_run != nullptr && threadIdx.x == 0) *iters_run = n_run;
}

template <int R, bool CHAIN, int LOOP, int FIXED = 0>
int launch(const float* tris, const float* o, const float* d,
           const float* t_min, float* out, int* iters_run, int iters,
           cudaStream_t stream) {
  auto kernel = probe_iter_cost<R, CHAIN, LOOP, FIXED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, R * kLane, kTableBytes, stream>>>(tris, o, d, t_min, out,
                                                 iters_run, iters);
  return (int)cudaGetLastError();
}

// fori at R = 4: the instantiation whose compiled trip count is iters.
int launch_fori(const float* tris, const float* o, const float* d,
                const float* t_min, float* out, int* iters_run, int iters,
                cudaStream_t stream) {
  if (iters == 256)
    return launch<4, false, kFori, 256>(tris, o, d, t_min, out, iters_run,
                                        iters, stream);
  if (iters == 4096)
    return launch<4, false, kFori, 4096>(tris, o, d, t_min, out, iters_run,
                                         iters, stream);
  return (int)cudaErrorInvalidValue;  // a trip count that is not built
}

}  // namespace

extern "C" int tpu_rt_probe_iter_cost(const float* tris, const float* o,
                                      const float* d, const float* t_min,
                                      float* out, int* iters_run, int R,
                                      int chain, int loop, int iters,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (iters < 0) return (int)cudaErrorInvalidValue;
  if (R == 4 && !chain && loop == kFori)
    return launch_fori(tris, o, d, t_min, out, iters_run, iters, stream);
  if (R == 4 && !chain && loop == kDynFori)
    return launch<4, false, kDynFori>(tris, o, d, t_min, out, iters_run,
                                      iters, stream);
  if (R == 4 && !chain && loop == kWhile)
    return launch<4, false, kWhile>(tris, o, d, t_min, out, iters_run, iters,
                                    stream);
  if (R == 4 && chain && loop == kWhile)
    return launch<4, true, kWhile>(tris, o, d, t_min, out, iters_run, iters,
                                   stream);
  if (R == 1 && chain && loop == kWhile)
    return launch<1, true, kWhile>(tris, o, d, t_min, out, iters_run, iters,
                                   stream);
  return (int)cudaErrorInvalidValue;  // not one of the script's five
}
