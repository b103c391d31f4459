// P1: a bvh8t node visit rebuilt level by level, to see what each part
// costs.
//
// Replaces the Pallas probe scripts/probe_walk_cost.py:240 (the kernel that
// make(level) builds), at the script's defaults NB = 16 and TILES = 1. One
// block of R x 128 threads, a thread a ray, runs `iters` visits. Visit q
// reads node nid of a (256, 128) table (the box of slot w at lanes
// s .. s + 5 of row (nid / 16) * 16 + w, s = (nid % 16) * 8, which never
// wraps), tests every ray against every slot (the slab of probe_common.cuh),
// and drains the slots w < ni that some ray hit into one int mask_s over the
// block (probe_common.cuh::block_or: a warp OR, a slot a warp in shared
// memory, one __syncthreads). The levels, one instantiation each:
//
//   kSlab     nid = q % 256, ni = 8, lbase = q % 64, computed by every
//             thread alike
//   kSmem     + the scalar state of a walk: a 64-entry stack in shared
//             memory, owned by thread 0, which pops the top entry
//             (stack[max(sp - 1, 0)]), clears its lowest set bit, forms
//             nid = (base + slot + q) % 256, reads ni and lbase from the
//             (1024, 2) meta table and publishes (nid, ni, lbase) in shared
//             memory for the block, behind one more barrier. That handoff
//             is what the TPU's scalar core does for its vector unit
//   kWhen     + thread 0 pushes (128 << 16) | imask when imask != 0, and sp
//             steps to at most 60 (every thread keeps sp alike)
//   kInner0   + the leaf loop, with its trip mask 0 & mask_s formed from an
//             argument the host passes as 0, so that the compiler keeps the
//             loop it cannot prove empty
//   kInner50  + the leaf loop's trip on even visits whose mask_s is odd:
//             P3's Moller-Trumbore (probe_common.cuh::group) of triangle
//             group gq = (lbase + 15) % 192, block gq / 12 rolled by
//             (gq % 12) * 10 lanes, each ray gated on its own hit of slot 0
//   kCond, kCond50  kWhen and kInner50 with the loop's condition also
//             reading the last visit's mask_s (>= 0, which the compiler
//             cannot prove)
//
// Without the leaf loop, the script keeps its slab alive with
// t_best = where(hits of ray row 0, slots 0-3, & mask_s > 1 << 20, t_best *
// 0.5, t_best); the port does the same, through row 0's hit masks in shared
// memory, though no 16-slot mask_s ever passes the test. Thread 0 writes
// each visit's mask_s to `visits` (optional) and `stats` = (visits run, the
// wrapping fold f = f * 33 + mask_s), so no level's slab or drain is dead.
//
// Memory: the node table (128 KB) and meta (8 KB) are staged once in shared
// memory, since every visit reads them; the triangle table (128 KB), which
// only the leaf trips read, is read through L1 and L2: the three, 264 KB,
// are more than a block's 227 KB. What bounds it on the H100: one block on
// one SM by design, as the TPU probe runs one tile on one core, so it
// measures a visit's latency: the slab (16 x 24 operations a ray, of which
// the ni slots that the drain keeps are needed), the drain's barrier (two
// barriers a visit from kSmem on), and on the leaf trips 16 x 44 operations
// a ray (needed for the rays the gate lets through) with three IEEE divides
// a row, which since P3's redesign only the rows K3's prefilter keeps take
// (probe_common.cuh::group, shared with P3; P1's own redesign is to come).
// Numerics: no fast math, -fmad=false; inv = 1 / d with the IEEE divide.

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using probe::kLane;
constexpr int kSlots = 16;
constexpr int kR = 4;
constexpr int kThreads = kR * kLane;
constexpr int kNodes = 256;        // NB * 16
constexpr int kTriGroups = 192;    // NB * 12
constexpr int kMetaRows = 1024;
constexpr int kStack = 64;
constexpr int kSpCap = 60;
constexpr unsigned kPushBase = kNodes / 2;
constexpr int kNodeFloats = kNodes * kLane;
constexpr int kSmemBytes = (kNodeFloats + kMetaRows * 2) * 4;

enum Level {
  kSlab = 0, kSmem = 1, kWhen = 2, kInner0 = 3, kInner50 = 4, kCond = 5,
  kCond50 = 6
};

template <int L>
__global__ void __launch_bounds__(kThreads)
    probe_walk_cost(const float* __restrict__ nodes,
                    const float* __restrict__ tris,
                    const int* __restrict__ meta,
                    const float* __restrict__ o_in,
                    const float* __restrict__ d_in,
                    const float* __restrict__ t_min_in,
                    float* __restrict__ out, int* __restrict__ visits,
                    int* __restrict__ stats, int iters, int zero) {
  constexpr bool kUseSmem = L != kSlab;
  constexpr bool kUseWhen = L != kSlab && L != kSmem;
  constexpr bool kUseInner = L == kInner0 || L == kInner50 || L == kCond50;
  constexpr bool kLeafRate = L == kInner50 || L == kCond50;
  constexpr bool kCondOnDrain = L == kCond || L == kCond50;

  extern __shared__ float4 dyn4[];
  float* nodes_s = reinterpret_cast<float*>(dyn4);
  int* meta_s = reinterpret_cast<int*>(nodes_s + kNodeFloats);
  __shared__ __align__(16) unsigned words[probe::kDrainWords];
  __shared__ int stack[kStack];
  __shared__ int state[3];                     // nid, ni, lbase
  __shared__ unsigned short row0[3][kLane];    // ray row 0's slot hits

  const int tid = threadIdx.x, r = tid / kLane, lane = tid % kLane;
  {
    const float4* src = reinterpret_cast<const float4*>(nodes);
    for (int i = tid; i < kNodeFloats / 4; i += kThreads) dyn4[i] = src[i];
    const int4* msrc = reinterpret_cast<const int4*>(meta);
    int4* mdst = reinterpret_cast<int4*>(meta_s);
    for (int i = tid; i < kMetaRows * 2 / 4; i += kThreads) mdst[i] = msrc[i];
  }
  if (tid < probe::kDrainWords) words[tid] = 0u;
  if (tid == 0) stack[0] = 1;
  float o[3], d[3], inv[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = o_in[(ax * kR + r) * kLane + lane];
    d[ax] = d_in[(ax * kR + r) * kLane + lane];
    inv[ax] = 1.0f / d[ax];
  }
  const float t_min = t_min_in[r * kLane + lane];
  float t_best = INFINITY;
  int best = -1;
  unsigned fold = 0u;
  int sp = 1, ms = 0, q = 0;
  __syncthreads();
  while (q < iters && (!kCondOnDrain || ms >= 0)) {
    int nid, ni, lbase;
    if constexpr (kUseSmem) {
      if (tid == 0) {
        const int top = max(sp - 1, 0);
        const unsigned e = static_cast<unsigned>(stack[top]);
        const unsigned mask = e & 0xffffu, base = e >> 16;
        const int slot = probe::ffs_slot(mask);
        const unsigned low = mask & (0u - mask);
        stack[top] = static_cast<int>((base << 16) | (mask - low));
        const int id = static_cast<int>((base + slot + q) % kNodes);
        const int m0 = meta_s[(id & (kMetaRows - 1)) * 2];
        const int m1 = meta_s[(id & (kMetaRows - 1)) * 2 + 1];
        state[0] = id;
        state[1] = m0 & 31;
        state[2] = static_cast<int>(static_cast<unsigned>(m1) >> 5);
      }
      __syncthreads();
      nid = state[0];
      ni = state[1];
      lbase = state[2];
    } else {
      nid = q % kNodes;
      ni = 8;
      lbase = q % 64;
    }
    const float* row =
        nodes_s + (nid / kSlots) * kSlots * kLane + (nid % kSlots) * 8;
    unsigned hm = 0u;
#pragma unroll
    for (int w = 0; w < kSlots; ++w) {
      float lo[3], hi[3], t0, t1;
      probe::load_box(row + w * kLane, lo, hi);
      probe::slab(lo, hi, o, inv, t0, t1);
      hm |= static_cast<unsigned>(t0 <= t1 && t1 >= t_min && t0 <= t_best)
            << w;
    }
    const unsigned valid = ni >= kSlots ? 0xffffu : (1u << ni) - 1u;
    if constexpr (!kUseInner) {
      if (r == 0) row0[q % 3][lane] = static_cast<unsigned short>(hm);
    }
    const int mask_s =
        static_cast<int>(probe::block_or<kThreads>(hm & valid, words, q));
    if (tid == 0 && visits != nullptr) visits[q] = mask_s;
    fold = fold * 33u + static_cast<unsigned>(mask_s);
    // ni <= 31: the script's int32 (1 << ni) - 1, in uint32 without overflow
    const unsigned imask = static_cast<unsigned>(mask_s) & ((1u << ni) - 1u);
    if constexpr (kUseWhen) {
      if (imask != 0u) {
        if (tid == 0) stack[sp] = static_cast<int>((kPushBase << 16) | imask);
        sp = min(sp + 1, kSpCap);
      }
    } else if constexpr (kUseSmem) {
      sp = max(sp, 1);
    }
    if constexpr (kUseInner) {
      unsigned lm = kLeafRate ? ((q & 1) == 0 ? mask_s & 1 : 0)
                              : static_cast<unsigned>(zero) &
                                    static_cast<unsigned>(mask_s);
      while (lm != 0u) {
        const int sl = probe::ffs_slot(lm);
        lm -= lm & (0u - lm);
        const int gq = (lbase + kSlots - 1 - sl) % kTriGroups;
        probe::MtRay ray[1] = {{{o[0], o[1], o[2], d[0], d[1], d[2], inv[0],
                                 inv[1], inv[2], t_min},
                                t_best, best}};
        probe::group<1>(tris + (gq / 12) * probe::kRows * kLane,
                        (gq % 12) * 10, (hm >> sl) & 1u, ray);
        t_best = ray[0].t_best;
        best = ray[0].best;
      }
    } else {
      if (mask_s > (1 << 20) && ((row0[q % 3][lane] >> r) & 1u))
        t_best = t_best * 0.5f;
    }
    ms = mask_s;
    ++q;
  }
  out[r * kLane + lane] = t_best + static_cast<float>(best);
  if (tid == 0) {
    stats[0] = q;
    stats[1] = static_cast<int>(fold);
  }
}

template <int L>
int launch(const float* nodes, const float* tris, const int* meta,
           const float* o, const float* d, const float* t_min, float* out,
           int* visits, int* stats, int iters, cudaStream_t stream) {
  auto kernel = probe_walk_cost<L>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, kSmemBytes, stream>>>(nodes, tris, meta, o, d, t_min,
                                               out, visits, stats, iters, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpu_rt_probe_walk_cost(const float* nodes, const float* tris,
                                      const int* meta, const float* o,
                                      const float* d, const float* t_min,
                                      float* out, int* visits, int* stats,
                                      int level, int iters,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (level) {
    case kSlab:
      return launch<kSlab>(nodes, tris, meta, o, d, t_min, out, visits,
                           stats, iters, stream);
    case kSmem:
      return launch<kSmem>(nodes, tris, meta, o, d, t_min, out, visits,
                           stats, iters, stream);
    case kWhen:
      return launch<kWhen>(nodes, tris, meta, o, d, t_min, out, visits,
                           stats, iters, stream);
    case kInner0:
      return launch<kInner0>(nodes, tris, meta, o, d, t_min, out, visits,
                             stats, iters, stream);
    case kInner50:
      return launch<kInner50>(nodes, tris, meta, o, d, t_min, out, visits,
                              stats, iters, stream);
    case kCond:
      return launch<kCond>(nodes, tris, meta, o, d, t_min, out, visits,
                           stats, iters, stream);
    case kCond50:
      return launch<kCond50>(nodes, tris, meta, o, d, t_min, out, visits,
                             stats, iters, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
