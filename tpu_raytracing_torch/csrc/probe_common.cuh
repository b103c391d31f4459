// What the probe kernels share: the Moller-Trumbore group body of P3 and P1,
// the block-wide drain of P2 and P1, and the scripts' _ffs.
//
// Numerics as in every kernel of the port: no fast math and -fmad=false, so
// each operation rounds as the plain PyTorch version's does.

#pragma once

#include <climits>
#include <cmath>

#include <cuda_runtime.h>

namespace probe {

constexpr int kLane = 128;
constexpr int kRows = 16;        // triangle rows of a block
constexpr int kNoId = 1 << 30;   // the scripts' id of a row that did not win

// One Moller-Trumbore pass of this thread's ray over the 16-row triangle
// block at `tb` (row i at tb + i * 128), lanes s .. s + 9 (mod 128) of each
// row: p0, e1, e2 and the triangle id as int32 bits. A ray whose `gate` is
// false takes no hit. (t_best, best) are updated in place, with the
// scripts' rule: least t, and of equal t the least id.
__device__ __forceinline__ void group(const float* __restrict__ tb, int s,
                                      bool gate, const float o[3],
                                      const float d[3], float t_min,
                                      float& t_best, int& best) {
  const int* ib = reinterpret_cast<const int*>(tb);
  float t_sl[kRows];
  float tg = INFINITY;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float* row = tb + i * kLane;
    float p0[3], e1[3], e2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p0[k] = row[(s + k) % kLane];
      e1[k] = row[(s + 3 + k) % kLane];
      e2[k] = row[(s + 6 + k) % kLane];
    }
    const float pv0 = d[1] * e2[2] - d[2] * e2[1];
    const float pv1 = d[2] * e2[0] - d[0] * e2[2];
    const float pv2 = d[0] * e2[1] - d[1] * e2[0];
    const float den = pv0 * e1[0] + pv1 * e1[1] + pv2 * e1[2];
    const float sden = den == 0.0f ? 1.0f : den;
    const float tv0 = o[0] - p0[0], tv1 = o[1] - p0[1], tv2 = o[2] - p0[2];
    const float u = (pv0 * tv0 + pv1 * tv1 + pv2 * tv2) / sden;
    const float qv0 = tv1 * e1[2] - tv2 * e1[1];
    const float qv1 = tv2 * e1[0] - tv0 * e1[2];
    const float qv2 = tv0 * e1[1] - tv1 * e1[0];
    const float v = (qv0 * d[0] + qv1 * d[1] + qv2 * d[2]) / sden;
    const float t = (qv0 * e2[0] + qv1 * e2[1] + qv2 * e2[2]) / sden;
    const bool ok = den != 0.0f && u >= -1e-5f && u <= 1.00001f &&
                    v >= -1e-5f && u + v <= 1.00001f && t >= t_min &&
                    t <= t_best && gate;
    t_sl[i] = ok ? t : INFINITY;
    tg = fminf(tg, t_sl[i]);
  }
  int idw = INT_MAX;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    idw = min(idw, t_sl[i] == tg ? ib[i * kLane + (s + 9) % kLane] : kNoId);
  if (tg < INFINITY) {
    t_best = tg;
    best = idw;
  }
}

// The drain: the OR of every thread's word over the block, returned to
// every thread, with one __syncthreads. Each warp ORs its words
// (__reduce_or_sync) and its lane 0 ORs that into words[v % 3] of shared
// memory; after the barrier every thread reads it. Visit v's word was zeroed
// in visit v - 2 (thread 0 zeroes words[(v + 2) % 3], which no thread reads
// after this barrier and none writes before the next one), so one barrier a
// visit suffices. `words` holds 3 zeros before visit 0; the whole block
// calls this, the same number of times. It is the dependency the probes
// price: the TPU's one vector-to-scalar drain a visit.
__device__ __forceinline__ unsigned block_or(unsigned m, unsigned* words,
                                             int v) {
  const unsigned w = __reduce_or_sync(0xffffffffu, m);
  unsigned* word = words + v % 3;
  if ((threadIdx.x & 31) == 0) atomicOr(word, w);
  __syncthreads();
  const unsigned all = *word;
  if (threadIdx.x == 0) words[(v + 2) % 3] = 0u;
  return all;
}

// traverse_pallas.py::_ffs(m, 16): the index of the lowest set bit, and 0
// for m = 0 (where __ffs(0) - 1 would be -1).
__device__ __forceinline__ int ffs_slot(unsigned m) {
  return m ? __ffs(static_cast<int>(m)) - 1 : 0;
}

// The ray-slab test of one box: t0, t1 folded axis by axis from -inf and inf
// as the scripts fold them (fminf / fmaxf agree with jnp.minimum / maximum
// on the NaN-free values the probes take).
__device__ __forceinline__ void slab(const float lo[3], const float hi[3],
                                     const float o[3], const float inv[3],
                                     float& t0, float& t1) {
  t0 = -INFINITY;
  t1 = INFINITY;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float a = (lo[ax] - o[ax]) * inv[ax];
    const float b = (hi[ax] - o[ax]) * inv[ax];
    t0 = fmaxf(t0, fminf(a, b));
    t1 = fminf(t1, fmaxf(a, b));
  }
}

// A node's slot box at `p` (lo xyz, hi xyz; p 32-byte aligned): one 16-byte
// and one 8-byte load.
__device__ __forceinline__ void load_box(const float* p, float lo[3],
                                         float hi[3]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 4);
  lo[0] = a.x;
  lo[1] = a.y;
  lo[2] = a.z;
  hi[0] = a.w;
  hi[1] = b.x;
  hi[2] = b.y;
}

}  // namespace probe
