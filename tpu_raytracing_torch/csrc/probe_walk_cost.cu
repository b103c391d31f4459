// P1: a bvh8t node visit rebuilt level by level, to see what each part
// costs.
//
// Replaces the Pallas probe scripts/probe_walk_cost.py:240 (the kernel that
// make(level) builds), at the script's defaults NB = 16 and TILES = 1. One
// block of R x 128 rays, one a thread, runs `iters` visits. Visit q reads
// node nid of a (256, 128) table (the box of slot w at lanes s .. s + 5 of
// row (nid / 16) * 16 + w, s = (nid % 16) * 8, which never wraps), tests
// every ray against the node's slots (the slab of probe_common.cuh), and
// drains the slots w < ni that some ray hit into one int mask_s over the
// block (probe_common.cuh::block_or: a warp OR, a slot a warp in shared
// memory, one __syncthreads). The levels, one instantiation each:
//
//   kSlab     nid = q % 256, ni = 8, lbase = q % 64
//   kSmem     + the scalar state of a walk: a 64-entry stack in shared
//             memory; the visit pops the top entry (stack[max(sp - 1, 0)]),
//             clears its lowest set bit, forms nid = (base + slot + q) %
//             256, and reads ni and lbase from the (1024, 2) meta table
//   kWhen     + a push of (128 << 16) | imask when imask != 0, and sp steps
//             to at most 60
//   kInner0   + the leaf loop, with its trip mask 0 & mask_s formed from an
//             argument the host passes as 0, so that the compiler keeps the
//             loop it cannot prove empty
//   kInner50  + the leaf loop's trip on even visits whose mask_s is odd:
//             P3's Moller-Trumbore of triangle group gq = (lbase + 15) %
//             192, block gq / 12 rolled by (gq % 12) * 10 lanes, each ray
//             gated on its own hit of slot 0
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
// What bounds it on the H100: one block on one SM by design, as the TPU
// probe runs one tile on one core, so it measures a visit's latency and the
// SM's issue rate. The design keeps a visit to the work it needs, with the
// drain (the TPU's one vector-to-scalar reduction a visit) as the only
// dependency between the block's warps:
// - one barrier a visit, the drain's (kWarpState): every warp computes the
//   visit's scalar state itself from the drained mask_s, which block_or
//   gives every thread, on its own copy of the stack (64 ints a warp in
//   shared memory, written by its lane 0 and read after __syncwarp; one
//   stack for the block would be a race, since a fast warp's pop of the
//   next visit could overwrite an entry a slow warp has not read). The TPU
//   does this on its scalar core; the first port did it in thread 0 and
//   handed (nid, ni, lbase) to the block behind a second barrier;
// - only the slots below the node's child count are tested (kNeededSlots):
//   8 at kSlab, min(ni, 16) from kSmem on, the slots the drain keeps (the
//   TPU's 16-row vector costs the same for any ni; here each slot is its
//   own instructions). A slot not tested contributes no bit, as the drain's
//   mask would remove it; the row0 term above reads only hit bits of slots
//   0-3 behind a guard that never fires;
// - a leaf trip tests only the rays its gate lets through (kWarpLeaf),
//   across the lanes of their warp: two rays a pass, lanes 0-15 the first
//   ray's 16 rows and lanes 16-31 the second's, each ray broadcast by
//   __shfl_sync, then a fold over each half (leaf_trip below). On the
//   scripts' inputs about 31 of 512 rays pass a trip's gate;
// - the triangle groups' used words are staged in shared memory with the
//   boxes (kStageTris), so a trip's rows are a shared-memory load and not
//   an L2 round trip after the drain.
// Numerics: no fast math, -fmad=false; inv = 1 / d with the IEEE divide.
//
// Memory: staged once a launch, 218 KB of the 227 KB a block may have: the
// 4,096 boxes (lanes 0-5 of each slot's 8), meta's rows of the 256 nodes
// (id < 256, so the script's row id & 1023 is id) and the 192 triangle
// groups' 16 rows of 10 words.

#include <climits>

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using probe::kLane;
using probe::kRows;
constexpr int kSlots = 16;
constexpr int kR = 4;
constexpr int kThreads = kR * kLane;  // ray x in thread x
constexpr int kWarps = kThreads / 32;
constexpr int kNodes = 256;        // NB * 16
constexpr int kTriGroups = 192;    // NB * 12
constexpr int kStack = 64;
constexpr int kSpCap = 60;
constexpr unsigned kPushBase = kNodes / 2;
constexpr int kNodeFloats = kNodes * kLane;
constexpr int kBoxFloats = kNodes * kSlots * 6;    // the boxes' 6 words of 8
constexpr int kTriFloats = kTriGroups * kRows * 10;  // the groups' used words
constexpr unsigned kFull = 0xffffffffu;
// The design's steps (scripts/torch_probe_ab.py times each one undone):
// - every warp forms the visit's state (false: thread 0 forms it and hands
//   it to the block behind a second barrier);
// - only the slots below ni are tested (false: all 16, masked in the
//   drain), kSlotUnroll of them a trip of the slot loop, a remainder loop
//   taking the rest;
// - a leaf trip tests its gated rays across their warps' lanes (false:
//   every thread runs probe::group on its ray, the gate applied at the
//   end);
// - shared memory holds the boxes' 6 words of 8 (96 KB), meta's rows of
//   nodes 0-255 (2 KB) and the triangle groups' 16 x 10 words (120 KB), so
//   a leaf trip reads its rows there (false: the node table as it is,
//   128 KB, and the triangles through L1 and L2).
constexpr bool kWarpState = true;
constexpr bool kNeededSlots = true;
constexpr int kSlotUnroll = 4;
constexpr bool kWarpLeaf = true;
constexpr bool kStageTris = true;
constexpr int kSmemBytes =
    (kStageTris ? kBoxFloats + kTriFloats : kNodeFloats) * 4 + kNodes * 8;

enum Level {
  kSlab = 0, kSmem = 1, kWhen = 2, kInner0 = 3, kInner50 = 4, kCond = 5,
  kCond50 = 6
};

// One leaf trip of one ray a lane (ray `r`, its gate bit, its (t_best,
// best)) across the warp: the warp's gated rays two at a time, lanes 0-15
// testing the 16 rows of a triangle group (row i's 10 words at rows + i *
// stride) against the first, lanes 16-31 against the second. Each ray's
// winner follows probe::group's rule: the least t, of equal t the least id,
// where the id is kNoId unless all 16 rows hold that t. The halves fold
// their rows in lane order, not row order; that is exact here, since
// tri_hit accepts only t >= t_min (1e-3 on every input set of the probe)
// and t <= t_best, so no NaN and no signed zero reaches the fold, and min
// over such values is the same in any order. A warp with no gated ray runs
// none of it.
__device__ __forceinline__ void leaf_trip(const float* rows, int stride,
                                          bool gate, const tpu_rt::Ray& r,
                                          float& t_best, int& best) {
  unsigned gm = __ballot_sync(kFull, gate);
  if (gm == 0u) return;
  const int lane = threadIdx.x & 31, half = lane >> 4;
  const probe::TriRow w =
      probe::load_row(rows + (lane & (kRows - 1)) * stride);
  while (gm != 0u) {
    const int a = __ffs(gm) - 1;
    gm &= gm - 1u;
    const int b = gm != 0u ? __ffs(gm) - 1 : -1;
    gm &= gm - 1u;  // gm == 0 stays 0
    const int src = half ? b : a;
    const int from = src < 0 ? lane : src;
    tpu_rt::Ray x;
    x.ox = __shfl_sync(kFull, r.ox, from);
    x.oy = __shfl_sync(kFull, r.oy, from);
    x.oz = __shfl_sync(kFull, r.oz, from);
    x.dx = __shfl_sync(kFull, r.dx, from);
    x.dy = __shfl_sync(kFull, r.dy, from);
    x.dz = __shfl_sync(kFull, r.dz, from);
    x.t_min = __shfl_sync(kFull, r.t_min, from);
    const float tb_x = __shfl_sync(kFull, t_best, from);
    float t = INFINITY;
    const bool ok = src >= 0 && tpu_rt::tri_hit(x, w.p0[0], w.p0[1], w.p0[2],
                                            w.e1[0], w.e1[1], w.e1[2],
                                            w.e2[0], w.e2[1], w.e2[2], tb_x,
                                            &t);
    float tg = ok ? t : INFINITY;
#pragma unroll
    for (int m = 8; m >= 1; m >>= 1)
      tg = fminf(tg, __shfl_xor_sync(kFull, tg, m));
    const bool tie = ok && t == tg;
    int id = tie ? w.id : INT_MAX;
#pragma unroll
    for (int m = 8; m >= 1; m >>= 1)
      id = min(id, __shfl_xor_sync(kFull, id, m));
    const int ties =
        __popc(__ballot_sync(kFull, tie) >> (half * 16) & 0xffffu);
    // the lanes of rays a and b read their half's fold (lane 0's, 16's)
    const int head = lane == a ? 0 : 16;
    const float gt = __shfl_sync(kFull, tg, head);
    const int gid = __shfl_sync(kFull, id, head);
    const int gties = __shfl_sync(kFull, ties, head);
    if ((lane == a || lane == b) && gt < INFINITY) {
      t_best = gt;
      best = gties == kRows ? gid : min(gid, probe::kNoId);
    }
  }
}

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
  // the slots a visit tests when that count is a constant
  constexpr int kFixedSlots = !kNeededSlots ? kSlots : (kUseSmem ? 0 : 8);

  extern __shared__ float4 dyn4[];
  float* nodes_s = reinterpret_cast<float*>(dyn4);
  float* tris_s = nodes_s + kBoxFloats;
  int* meta_s = reinterpret_cast<int*>(
      nodes_s + (kStageTris ? kBoxFloats + kTriFloats : kNodeFloats));
  __shared__ __align__(16) unsigned words[probe::kDrainWords];
  __shared__ int stacks[kWarpState ? kWarps : 1][kStack];
  __shared__ int state[3];                     // nid, ni, lbase (handoff)
  __shared__ unsigned short row0[3][kLane];    // ray row 0's slot hits

  const int tid = threadIdx.x, lane = tid & 31;
  if constexpr (kStageTris) {
    // box (node n, slot w) at ((n / 16 * 16 + w) * 16 + n % 16) * 6, from
    // lanes (n % 16) * 8 .. + 5 of row n / 16 * 16 + w; row i of group g at
    // (g * 16 + i) * 10, from lanes (g % 12) * 10 .. + 9 of row g / 12 * 16
    // + i
    for (int i = tid; i < kNodes * kSlots; i += kThreads) {
      const float* src = nodes + (i >> 4) * kLane + (i & 15) * 8;
      float2* dst = reinterpret_cast<float2*>(nodes_s + i * 6);
      for (int j = 0; j < 3; ++j)
        dst[j] = reinterpret_cast<const float2*>(src)[j];
    }
    for (int i = tid; i < kTriGroups * kRows * 5; i += kThreads) {
      const int row = i / 5, g = row / kRows;
      const float* src = tris + ((g / 12) * kRows + row % kRows) * kLane +
                         (g % 12) * 10;
      reinterpret_cast<float2*>(tris_s)[i] =
          reinterpret_cast<const float2*>(src)[i % 5];
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(nodes);
    for (int i = tid; i < kNodeFloats / 4; i += kThreads) dyn4[i] = src[i];
  }
  for (int i = tid; i < kNodes * 2 / 4; i += kThreads)
    reinterpret_cast<int4*>(meta_s)[i] =
        reinterpret_cast<const int4*>(meta)[i];
  if (tid < probe::kDrainWords) words[tid] = 0u;
  int* stack = stacks[kWarpState ? tid >> 5 : 0];
  // the lane that writes this thread's stack: each warp's lane 0, or
  // thread 0 alone with the handoff
  const bool writer = kWarpState ? lane == 0 : tid == 0;
  if (writer) stack[0] = 1;
  const int r = tid / kLane, c = tid % kLane;
  float o[3], d[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = o_in[(ax * kR + r) * kLane + c];
    d[ax] = d_in[(ax * kR + r) * kLane + c];
  }
  const tpu_rt::Ray ray{o[0], o[1], o[2], d[0], d[1], d[2], 1.0f / d[0],
                        1.0f / d[1], 1.0f / d[2], t_min_in[tid]};
  float t_best = INFINITY;
  int best = -1;
  unsigned fold = 0u;
  int sp = 1, ms = 0, q = 0;
  __syncthreads();
  while (q < iters && (!kCondOnDrain || ms >= 0)) {
    int nid, ni, lbase;
    if constexpr (kUseSmem) {
      int id, m0, m1;
      if constexpr (kWarpState) {
        __syncwarp();  // lane 0's push of the last visit is seen
        const int top = max(sp - 1, 0);
        const unsigned e = static_cast<unsigned>(stack[top]);
        __syncwarp();  // every lane has read the entry before lane 0 pops it
        const unsigned mask = e & 0xffffu, base = e >> 16;
        const int slot = probe::ffs_slot(mask);
        const unsigned low = mask & (0u - mask);
        if (writer) stack[top] = static_cast<int>((base << 16) | (mask - low));
        id = static_cast<int>((base + slot + q) % kNodes);
        m0 = meta_s[id * 2];  // the script's row id & 1023: id < 256
        m1 = meta_s[id * 2 + 1];
      } else {
        if (writer) {
          const int top = max(sp - 1, 0);
          const unsigned e = static_cast<unsigned>(stack[top]);
          const unsigned mask = e & 0xffffu, base = e >> 16;
          const int slot = probe::ffs_slot(mask);
          const unsigned low = mask & (0u - mask);
          stack[top] = static_cast<int>((base << 16) | (mask - low));
          const int x = static_cast<int>((base + slot + q) % kNodes);
          state[0] = x;
          state[1] = meta_s[x * 2];
          state[2] = meta_s[x * 2 + 1];
        }
        __syncthreads();
        id = state[0];
        m0 = state[1];
        m1 = state[2];
      }
      nid = id;
      ni = m0 & 31;
      lbase = static_cast<int>(static_cast<unsigned>(m1) >> 5);
    } else {
      nid = q % kNodes;
      ni = 8;
      lbase = q % 64;
    }
    // slot w's box at row + w * step
    const int blk = nid / kSlots, n = nid % kSlots;
    const float* row =
        kStageTris ? nodes_s + (blk * kSlots * kSlots + n) * 6
                   : nodes_s + blk * kSlots * kLane + n * 8;
    constexpr int step = kStageTris ? kSlots * 6 : kLane;
    unsigned hit = 0u;
    auto test_slot = [&](int w) {
      float lo[3], hi[3];
      if constexpr (kStageTris) {  // 8-byte aligned: three 8-byte loads
        const float2* p = reinterpret_cast<const float2*>(row + w * step);
        const float2 x = p[0], y = p[1], z = p[2];
        lo[0] = x.x; lo[1] = x.y; lo[2] = y.x;
        hi[0] = y.y; hi[1] = z.x; hi[2] = z.y;
      } else {
        probe::load_box(row + w * step, lo, hi);
      }
      const float org[3] = {ray.ox, ray.oy, ray.oz};
      const float inv[3] = {ray.ix, ray.iy, ray.iz};
      float t0, t1;
      probe::slab(lo, hi, org, inv, t0, t1);
      hit |= static_cast<unsigned>(t0 <= t1 && t1 >= ray.t_min &&
                                   t0 <= t_best)
             << w;
    };
    if constexpr (kFixedSlots > 0) {
#pragma unroll
      for (int w = 0; w < kFixedSlots; ++w) test_slot(w);
    } else {
      const int nt = min(ni, kSlots);  // the same in every thread
      int w = 0;
#pragma unroll 1
      for (; w + kSlotUnroll <= nt; w += kSlotUnroll) {
#pragma unroll
        for (int u = 0; u < kSlotUnroll; ++u) test_slot(w + u);
      }
#pragma unroll 1
      for (; w < nt; ++w) test_slot(w);
    }
    const unsigned hm = hit;  // this ray's hits, for the leaf gate
    if (!kNeededSlots) hit &= ni >= kSlots ? 0xffffu : (1u << ni) - 1u;
    if constexpr (!kUseInner) {
      if (tid < kLane) row0[q % 3][tid] = static_cast<unsigned short>(hm);
    }
    const int mask_s =
        static_cast<int>(probe::block_or<kThreads>(hit, words, q));
    if (tid == 0 && visits != nullptr) visits[q] = mask_s;
    fold = fold * 33u + static_cast<unsigned>(mask_s);
    // ni <= 31: the script's int32 (1 << ni) - 1, in uint32 without overflow
    const unsigned imask = static_cast<unsigned>(mask_s) & ((1u << ni) - 1u);
    if constexpr (kUseWhen) {
      if (imask != 0u) {
        if (writer) stack[sp] = static_cast<int>((kPushBase << 16) | imask);
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
        const float* tb = tris + (gq / 12) * kRows * kLane;
        const int s = (gq % 12) * 10;
        if constexpr (kWarpLeaf) {
          const float* rows = kStageTris ? tris_s + gq * kRows * 10 : tb + s;
          leaf_trip(rows, kStageTris ? 10 : kLane, (hm >> sl) & 1u, ray,
                    t_best, best);
        } else {
          probe::MtRay mt[1] = {{ray, t_best, best}};
          probe::group<1>(tb, s, (hm >> sl) & 1u, mt);
          t_best = mt[0].t_best;
          best = mt[0].best;
        }
      }
    } else {
      if (mask_s > (1 << 20) && ((row0[q % 3][c] >> r) & 1u))
        t_best = t_best * 0.5f;
    }
    ms = mask_s;
    ++q;
  }
  out[tid] = t_best + static_cast<float>(best);
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
