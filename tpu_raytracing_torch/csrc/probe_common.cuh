// What the probe kernels share: the Moller-Trumbore group body of P3 and P1,
// the block-wide drain of P2 and P1, and the scripts' _ffs.
//
// Numerics as in every kernel of the port: no fast math and -fmad=false, so
// each operation rounds as the plain PyTorch version's does.

#pragma once

#include <climits>
#include <cmath>
#include <type_traits>

#include <cuda_runtime.h>

#include "traverse_common.cuh"

namespace probe {

constexpr int kLane = 128;
constexpr int kRows = 16;        // triangle rows of a block
constexpr int kNoId = 1 << 30;   // the scripts' id of a row that did not win
// group() runs K3's exact prefilter before the divides (false: every gated
// (row, ray) takes the full test; scripts/torch_probe_ab.py times that)
constexpr bool kPrefilter = true;

// A ray of a group pass: origin, direction and t_min (its 1 / d unread
// here), and its winner so far.
struct MtRay {
  tpu_rt::Ray ray;
  float t_best;
  int best;
};

// A triangle row's ten words: p0, e1, e2, and the id as int32 bits.
struct TriRow {
  float p0[3], e1[3], e2[3];
  int id;
};

// The row at `p` (8-byte aligned): five 8-byte loads. Every thread of the
// block reads the same row, so in shared memory each is a broadcast.
__device__ __forceinline__ TriRow load_row(const float* p) {
  const float2* q = reinterpret_cast<const float2*>(p);
  const float2 a = q[0], b = q[1], c = q[2], e = q[3], f = q[4];
  return TriRow{{a.x, a.y, b.x}, {b.y, c.x, c.y}, {e.x, e.y, f.x},
                __float_as_int(f.y)};
}

// den and the numerators nu, nv of u = nu / den and v = nv / den, in
// tpu_rt::tri_hit's operations (so with its bits).
__device__ __forceinline__ void numerators(const tpu_rt::Ray& r,
                                           const TriRow& w, float& den,
                                           float& nu, float& nv) {
  const float pv0 = r.dy * w.e2[2] - r.dz * w.e2[1];
  const float pv1 = r.dz * w.e2[0] - r.dx * w.e2[2];
  const float pv2 = r.dx * w.e2[1] - r.dy * w.e2[0];
  den = pv0 * w.e1[0] + pv1 * w.e1[1] + pv2 * w.e1[2];
  const float tv0 = r.ox - w.p0[0], tv1 = r.oy - w.p0[1],
              tv2 = r.oz - w.p0[2];
  nu = pv0 * tv0 + pv1 * tv1 + pv2 * tv2;
  const float qv0 = tv1 * w.e1[2] - tv2 * w.e1[1];
  const float qv1 = tv2 * w.e1[0] - tv0 * w.e1[2];
  const float qv2 = tv0 * w.e1[1] - tv1 * w.e1[0];
  nv = qv0 * r.dx + qv1 * r.dy + qv2 * r.dz;
}

__device__ __forceinline__ int lowest_bit(unsigned m) { return __ffs(m) - 1; }

__device__ __forceinline__ int lowest_bit(unsigned long long m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}

// One Moller-Trumbore pass of this thread's S rays over the 16-row triangle
// block at `tb` (row i at tb + i * 128), lanes s .. s + 9 of each row (s
// even and at most 118, so a row never wraps and its loads are 8-byte
// aligned): p0, e1, e2 and the triangle id as int32 bits. Ray k takes no
// hit where bit k of `gate` is clear. Each ray's (t_best, best) is updated
// with the scripts' rule: every row is tested against the t_best from
// before the block; the least t wins, and of equal t the least id, where
// an id is kNoId unless all 16 rows hold that t (the scripts'
// min(where(t_sl == tg, id, NO_ID))).
//
// The full test is tpu_rt::tri_hit: the scripts' Moller-Trumbore
// (probe_iter_cost.py:83-111) op for op, with their bounds (1.00001f is
// 1.0f + 1e-5f), so K3's prefilter proof covers it.
//
// Two passes. The first computes each (row, ray)'s den and numerators and
// keeps, as one bit each, the pairs K3's prefilter (tpu_rt::surely_misses)
// cannot reject: 36 operations and 8 for the filter, no divide; on the
// script's inputs about 3% of them. The second takes only those, in
// (ray, row) order, through the full test with its three IEEE divides,
// reloading the row: a warp runs the most any of its threads keeps, not
// 16 x S. The prefilter rejects only rows the full test rejects, and each
// ray's rows come in row order, so the running minimum (fminf, as the
// scripts fold t) and the ids of its ties end as the one-pass fold's.
template <int S>
__device__ __forceinline__ void group(const float* tb, int s, unsigned gate,
                                      MtRay (&ray)[S]) {
  static_assert(S >= 1 && S * kRows <= 64, "at most 4 rays a thread");
  using Bits = std::conditional_t<(S * kRows <= 32), unsigned,
                                  unsigned long long>;
  Bits keep = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const TriRow w = load_row(tb + i * kLane + s);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      float den, nu, nv;
      numerators(ray[k].ray, w, den, nu, nv);
      if (((gate >> k) & 1u) &&
          (!kPrefilter || !tpu_rt::surely_misses(den, nu, nv)))
        keep |= Bits(1) << (k * kRows + i);
    }
  }
  float tg[S];
  int idw[S], ties[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    tg[k] = INFINITY;
    idw[k] = INT_MAX;
    ties[k] = 0;
  }
  while (keep != 0) {
    const int b = lowest_bit(keep);
    keep &= keep - 1;
    const int k = b / kRows;
    MtRay r = ray[0];
#pragma unroll
    for (int j = 1; j < S; ++j)
      if (k == j) r = ray[j];
    const TriRow w = load_row(tb + (b % kRows) * kLane + s);
    float t;
    const bool ok = tpu_rt::tri_hit(r.ray, w.p0[0], w.p0[1], w.p0[2], w.e1[0],
                                    w.e1[1], w.e1[2], w.e2[0], w.e2[1],
                                    w.e2[2], r.t_best, &t);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (ok && k == j) {
        if (t < tg[j]) {
          idw[j] = w.id;
          ties[j] = 1;
        } else if (t == tg[j]) {
          idw[j] = min(idw[j], w.id);
          ++ties[j];
        }
        tg[j] = fminf(tg[j], t);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (tg[k] < INFINITY) {
      ray[k].t_best = tg[k];
      ray[k].best = ties[k] == kRows ? idw[k] : min(idw[k], kNoId);
    }
  }
}

// The drain: the OR of every thread's word over the block of THREADS
// threads, returned to every thread, with one __syncthreads. Each warp ORs
// its words (__reduce_or_sync) and its lane 0 stores that in the warp's
// slot of set v % 2 of `words`; after the barrier every thread ORs the
// set's slots (16-byte broadcast loads). A thread stores into set v % 2
// again only in visit v + 2, after visit v + 1's barrier, which every
// thread reaches after its loads of visit v; so two sets suffice, and no
// slot is zeroed but once: `words` (kDrainWords, 16-byte aligned) holds
// zeros before visit 0. The whole block calls this, the same number of
// times. It is the dependency the probes price: the TPU's one
// vector-to-scalar drain a visit. (Slots, not one word every warp
// atomicOr's: the atomics on one address queue before the barrier.)
constexpr int kDrainWords = 64;  // two sets of a slot a warp, up to 32 warps

template <int THREADS>
__device__ __forceinline__ unsigned block_or(unsigned m, unsigned* words,
                                             int v) {
  constexpr int kWarps = THREADS / 32;
  static_assert(THREADS % 32 == 0 && kWarps <= 32, "whole warps, at most 32");
  const unsigned w = __reduce_or_sync(0xffffffffu, m);
  unsigned* set = words + (v & 1) * 32;
  if ((threadIdx.x & 31) == 0) set[threadIdx.x >> 5] = w;
  __syncthreads();
  unsigned all = 0u;
#pragma unroll
  for (int i = 0; i < kWarps; i += 4) {  // slots past kWarps hold zeros
    const uint4 x = *reinterpret_cast<const uint4*>(set + i);
    all |= x.x | x.y | x.z | x.w;
  }
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
