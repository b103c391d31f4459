// P2: the cost of a bvh8t visit's slab phase, in five variants.
//
// Replaces the Pallas probe scripts/probe_slab_cost.py:210 (the kernel that
// make(variant) builds). A while loop visits nodes until q reaches iters:
// visit q reads node nid = q % 1024 of a (1024, 128) table, whose block
// nid / 16 holds the box of slot w at lanes s .. s + 5 of row
// (nid / 16) * 16 + w, s = (nid % 16) * 8 (s + 5 <= 125: the script's roll
// never wraps a box); runs the variant's slab; drains the slots hit into one
// int mask_s over the whole block; and steps q by 1 + (mask_s & 1). Four
// instantiations:
//
//   kFloor  the block read and the drain: mask_s = 128 * the bits of the
//           slots whose lo.x > 0 (the script sums 128 lanes of them: 128
//           threads compare, the script's (16, 128); the block is kCur's)
//   kCur    cur and hoist, which differ only in where the TPU kept the
//           rays' row broadcasts; here each thread's rays are in registers
//           either way. Each of R x 128 rays (kCurRays a thread) tests each
//           slot twice, as the script's KN = 2 nodes (the same box standing in
//           for both). The second pass reads its ray through an offset the
//           host passes as 0, which the compiler cannot see, so it cannot
//           fold the two passes into one: the written work stays. mask_s =
//           OR of pass 0 + OR of pass 1 (= 2 * OR); t_best takes
//           min(t_best, t_best + mask_s * 0 + 1e30), as the script does
//   kRow0   the 128 row-0 rays (a thread each; rows 1-3 only receive row 0's
//           t_best), plus an interval slab of each slot against the tile's
//           envelope, the min and max of o, inv and t_min over the 4 x 128
//           rays (reduced once a launch); lanes 0-15 of warp 0 test one slot
//           each. mask_s = OR; t_best = min(t_best, |t0 of slot 0| + 1)
//   kMxu    g = (the block rolled by s, stacked 6 times) @ rhs in float32,
//           (96, 128) @ (128, 128), where rhs cycles the rays' o and inv
//           rows (probe_slab_cost.py:100-103) and is staged once in shared
//           memory (64 KB). 384 threads: thread (k, c) computes the 16 rows
//           of group k in columns c and c + 64 (kCols = 2), each a running
//           sum over the 128 products in order (FMUL then FADD; no tensor
//           cores, whose TF32 would round the inputs), reading the rolled
//           block straight from its ring stage (s is a multiple of 8, so a
//           16-byte load never straddles the roll). Then the block's
//           threads fold the six groups' min/max tree, a (slot, column)
//           pair each in turn, into h = (t0 <= t1) & (t1 >= 0). mask_s = OR
//
// Every visit ends in the block-wide drain (probe_common.cuh::block_or):
// a warp OR, a slot a warp in shared memory and one __syncthreads (then
// every thread ORs the slots), which every visit waits on, as the TPU probe
// waits on its vector-to-scalar drain; kMxu adds one barrier (the groups). Thread 0 writes each visit's mask_s to
// `visits` (optional) and `stats` = (visits run, the wrapping fold
// f = f * 33 + mask_s), so no variant's slab or drain is dead code.
//
// What bounds it on the H100: one block on one SM by design, as the TPU
// probe runs one tile on one core, so it measures a visit's latency. The
// operations (24 a slab test, 16 x 512 x 2 tests a kCur visit) are one
// SM's fp32 issue at best: a slab has no multiply-add to fuse, so the SM's
// 128 fp32 instructions a clock are half the 67 TFLOP/s bound, and with
// half of kCur's written tests needed, its needed-operations share of one
// SM can reach about 25%. kCur's 32 slab tests a ray are 12 FMNMX, 4
// FSETP and 12 FADD or FMUL each (1,103 SASS instructions a visit), so
// the ALU pipe's min/max and compares set its pace more than the fp32
// lanes. kFloor and kRow0 do little arithmetic and wait on their loads and
// the drain; kMxu is 3.1 M FMUL and FADD a visit (88% of its loop).
//
// The design (redesigned for Hopper after its first port, which read each
// visit's boxes from L2 after the drain that named the node): the node
// table is 512 KB, more than a block's 227 KB of shared memory, but a
// visit's 16 boxes lie in one 8 KB block of 16 rows, and since q steps by
// 1 or 2 the walk meets the blocks in order, each for 8-16 visits. So the
// blocks stream through a ring of kStages = 3 stages in shared memory:
// thread 0 fills a stage with one bulk copy (TMA) that completes on the
// stage's mbarrier, and refills it with the block kStages ahead once the
// walk has left it (after a drain, which every thread's reads precede).
// The next blocks arrive while the walk is in this one, and a visit's box
// loads are shared-memory broadcasts, as the TPU's VMEM reads were: none
// waits on L2 after a drain. kMxu holds two columns a thread (one and four
// ran 18% and 21% slower on an H100 80GB HBM3 at 700 W), kCur two rays a
// thread (a box's loads serve both, and half the warps meet at the drain:
// one ray a thread ran 8% slower, kFloor on its 512 threads 26%), and the
// drain is a slot a warp (probe_common.cuh::block_or);
// scripts/torch_probe_ab.py times each choice undone. Numerics: no fast
// math, -fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using probe::kLane;
constexpr int kSlots = 16;
constexpr int kR = 4;              // ray rows
constexpr int kRays = kR * kLane;
constexpr int kNodes = 1024;
constexpr int kTableBlocks = kNodes / kSlots;
constexpr int kGroups = 6;         // the mxu's stacked copies of the block
constexpr int kCols = 2;           // the mxu's columns a thread
constexpr int kColThreads = kLane / kCols;
constexpr int kCurRays = 2;        // kCur's rays a thread (and kFloor's
                                   // threads: the rays / kCurRays)
// The ring of node blocks (false: each visit reads its boxes from device
// memory through L1; scripts/torch_probe_ab.py times that)
constexpr bool kStaged = true;
constexpr int kStages = 3;

enum Variant { kFloor = 0, kCur = 1, kRow0 = 2, kMxu = 3 };

__host__ __device__ constexpr int threads_of(int v) {
  return v == kRow0  ? kLane
         : v == kMxu ? kGroups * kColThreads
                     : kRays / kCurRays;
}

// Dynamic shared memory: the ring (kStages blocks of (16, 128)); then for
// kMxu rhs (128, 128) and the groups (6, 16, 128).
constexpr int kRhsFloats = kLane * kLane;
constexpr int kBlockFloats = kSlots * kLane;
constexpr int kBlockBytes = kBlockFloats * 4;
constexpr int kRingFloats = kStaged ? kStages * kBlockFloats : 0;
constexpr int smem_of(int v) {
  return (kRingFloats +
          (v == kMxu ? kRhsFloats + kGroups * kBlockFloats : 0)) * 4;
}

// Thread 0: copy block `seq` of the walk's order (table block seq % 64)
// into the stage at `dst`; the copy completes on `bar`.
__device__ __forceinline__ void fill(float* dst, const float* nodes, int seq,
                                     uint64_t* bar) {
  tpu_rt::expect_bytes(bar, kBlockBytes);
  tpu_rt::bulk_load(dst, nodes + (seq % kTableBlocks) * kBlockFloats,
                    kBlockBytes, bar);
}

// rhs row k: [o0, o1, o2, inv0, inv1, inv2][(k / 4) % 6], ray row k % 4
__device__ __forceinline__ float rhs_at(const float* o, const float* inv,
                                        int k, int n) {
  const int x = (k / kR) % 6, r = k % kR;
  const float* src = x < 3 ? o + x * kRays : inv + (x - 3) * kRays;
  return src[r * kLane + n];
}

// kRow0's envelope: (min, max) of o[ax] and inv[ax] over the 4 x 128 rays,
// and the least t_min, reduced by the block's 128 threads. env[ax * 4 + j]:
// olo, ohi, ilo, ihi.
__device__ void envelope(const float* o, const float* inv,
                         const float* t_min, float* env, float* red) {
  const int lane = threadIdx.x, warp = lane / 32;
  float v[13];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float olo = INFINITY, ohi = -INFINITY, ilo = INFINITY, ihi = -INFINITY;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float a = o[ax * kRays + r * kLane + lane];
      const float b = inv[ax * kRays + r * kLane + lane];
      olo = fminf(olo, a);
      ohi = fmaxf(ohi, a);
      ilo = fminf(ilo, b);
      ihi = fmaxf(ihi, b);
    }
    v[ax * 4 + 0] = olo;
    v[ax * 4 + 1] = ohi;
    v[ax * 4 + 2] = ilo;
    v[ax * 4 + 3] = ihi;
  }
  float tlo = INFINITY;
#pragma unroll
  for (int r = 0; r < kR; ++r) tlo = fminf(tlo, t_min[r * kLane + lane]);
  v[12] = tlo;
#pragma unroll
  for (int j = 0; j < 13; ++j) {
    const bool is_max = j < 12 && (j & 1);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float other = __shfl_xor_sync(0xffffffffu, v[j], off);
      v[j] = is_max ? fmaxf(v[j], other) : fminf(v[j], other);
    }
    if (lane % 32 == 0) red[warp * 13 + j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < 13) {
    const int j = threadIdx.x;
    const bool is_max = j < 12 && (j & 1);
    float x = red[j];
    for (int w = 1; w < kLane / 32; ++w)
      x = is_max ? fmaxf(x, red[w * 13 + j]) : fminf(x, red[w * 13 + j]);
    env[j] = x;
  }
  __syncthreads();
}

// kRow0's interval slab of one slot against the envelope
// (probe_slab_cost.py:137-153).
__device__ __forceinline__ bool interval_hit(const float lo[3],
                                             const float hi[3],
                                             const float* env) {
  float i0 = -INFINITY, i1 = INFINITY;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float olo = env[ax * 4], ohi = env[ax * 4 + 1];
    const float ilo = env[ax * 4 + 2], ihi = env[ax * 4 + 3];
    const float dlo = lo[ax] - ohi, dhi = hi[ax] - olo;
    const float p1 = dlo * ilo, p2 = dlo * ihi, p3 = dhi * ilo, p4 = dhi * ihi;
    i0 = fmaxf(i0, fminf(fminf(p1, p2), fminf(p3, p4)));
    i1 = fminf(i1, fmaxf(fmaxf(p1, p2), fmaxf(p3, p4)));
  }
  return i0 <= i1 && i1 >= env[12];
}

template <int V>
__global__ void __launch_bounds__(threads_of(V))
    probe_slab_cost(const float* __restrict__ nodes,
                    const float* __restrict__ o_in,
                    const float* __restrict__ inv_in,
                    const float* __restrict__ t_min_in,
                    const float* __restrict__ act_in,
                    float* __restrict__ out, int* __restrict__ visits,
                    int* __restrict__ stats, int iters, int zero) {
  constexpr int kThreads = threads_of(V);
  __shared__ __align__(16) unsigned words[probe::kDrainWords];
  __shared__ float env[13];
  __shared__ float red[(kLane / 32) * 13];
  __shared__ __align__(8) uint64_t full[kStages];
  extern __shared__ float4 dyn4[];
  float* ring = reinterpret_cast<float*>(dyn4);
  float* rhs = ring + kRingFloats;
  float* grp_s = rhs + kRhsFloats;

  const int tid = threadIdx.x, lane = tid % kLane;
  if (tid < probe::kDrainWords) words[tid] = 0u;
  if constexpr (kStaged) {
    if (tid == 0) {
      for (int j = 0; j < kStages; ++j) tpu_rt::bar_init(&full[j]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int j = 0; j < kStages && j * kSlots < iters; ++j)
        fill(ring + j * kBlockFloats, nodes, j, &full[j]);
    }
  }
  // this thread's rays, and for kCur the second pass's copies of them:
  // kCur's thread x holds rays x, x + kThreads, ...; row0's thread ray
  // (0, lane); the others' one ray, x % 512, serves no slab
  constexpr int kHeld = V == kCur ? kCurRays : 1;
  float o[kHeld][3], inv[kHeld][3], o2[kHeld][3], inv2[kHeld][3];
  float t_min[kHeld], t_best[kHeld];
  bool live[kHeld];
#pragma unroll
  for (int h = 0; h < kHeld; ++h) {
    const int j = V == kRow0 ? lane : (tid + h * kThreads) % kRays;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int at = ax * kRays + j;
      o[h][ax] = o_in[at];
      inv[h][ax] = inv_in[at];
      o2[h][ax] = o_in[at + zero];
      inv2[h][ax] = inv_in[at + zero];
    }
    t_min[h] = t_min_in[j];
    live[h] = act_in[j] > 0.0f;
    t_best[h] = INFINITY;
  }
  if constexpr (V == kMxu) {
    for (int i = tid; i < kRhsFloats; i += kThreads)
      rhs[i] = rhs_at(o_in, inv_in, i / kLane, i % kLane);
  }
  if constexpr (V == kRow0) envelope(o_in, inv_in, t_min_in, env, red);
  __syncthreads();

  unsigned fold = 0u;
  int q = 0, v = 0;
  int cur = -1;  // the walk's block in its order (q / 16), once it has one
  while (q < iters) {
    const int nid = q % kNodes;
    const int s = (nid % kSlots) * 8;
    const float* row;  // the node's block: slot w's box at row + w * 128 + s
    if constexpr (kStaged) {
      const int j = q / kSlots;  // cur or cur + 1: q steps by 1 or 2
      if (j != cur) {
        // every thread read stage cur % kStages before the last drain
        if (tid == 0 && cur >= 0 && (cur + kStages) * kSlots < iters) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          fill(ring + (cur % kStages) * kBlockFloats, nodes, cur + kStages,
               &full[cur % kStages]);
        }
        cur = j;
        tpu_rt::bar_wait(&full[j % kStages], (j / kStages) & 1);
      }
      row = ring + (j % kStages) * kBlockFloats;
    } else {
      row = nodes + (nid / kSlots) * kBlockFloats;
    }
    int mask_s;
    if constexpr (V == kFloor) {
      // the script's (16, 128) compare: 128 threads, 16 slots each
      unsigned m = 0u;
      if (tid < kLane) {
#pragma unroll
        for (int w = 0; w < kSlots; ++w)
          m |= static_cast<unsigned>(row[w * kLane + s] > 0.0f) << w;
      }
      mask_s = kLane * static_cast<int>(probe::block_or<kThreads>(m, words,
                                                                  v));
    } else if constexpr (V == kCur) {
      unsigned m0 = 0u, m1 = 0u;
#pragma unroll
      for (int w = 0; w < kSlots; ++w) {
        float lo[3], hi[3], t0, t1;
        probe::load_box(row + w * kLane + s, lo, hi);
#pragma unroll
        for (int h = 0; h < kHeld; ++h) {
          probe::slab(lo, hi, o[h], inv[h], t0, t1);
          m0 |= static_cast<unsigned>(t0 <= t1 && t1 >= t_min[h] &&
                                      t0 <= t_best[h] && live[h]) << w;
          probe::slab(lo, hi, o2[h], inv2[h], t0, t1);
          m1 |= static_cast<unsigned>(t0 <= t1 && t1 >= t_min[h] &&
                                      t0 <= t_best[h] && live[h]) << w;
        }
      }
      const unsigned all =
          probe::block_or<kThreads>(m0 | (m1 << 16), words, v);
      mask_s = static_cast<int>((all & 0xffffu) + (all >> 16));
#pragma unroll
      for (int h = 0; h < kHeld; ++h)
        t_best[h] = fminf(t_best[h], t_best[h] +
                                         static_cast<float>(mask_s) * 0.0f +
                                         1e30f);
    } else if constexpr (V == kRow0) {
      unsigned m = 0u;
      float take = 0.0f;
#pragma unroll
      for (int w = 0; w < kSlots; ++w) {
        float lo[3], hi[3], t0, t1;
        probe::load_box(row + w * kLane + s, lo, hi);
        probe::slab(lo, hi, o[0], inv[0], t0, t1);
        m |= static_cast<unsigned>(t0 <= t1 && t1 >= t_min[0] &&
                                   t0 <= t_best[0]) << w;
        if (w == 0) take = t0;
      }
      if (tid < kSlots) {
        float lo[3], hi[3];
        probe::load_box(row + tid * kLane + s, lo, hi);
        m |= static_cast<unsigned>(interval_hit(lo, hi, env)) << tid;
      }
      mask_s = static_cast<int>(probe::block_or<kThreads>(m, words, v));
      t_best[0] = fminf(t_best[0], fabsf(take) + 1.0f);
    } else {  // kMxu
      const int g = tid / kColThreads, c0 = tid % kColThreads;
      float acc[kSlots][kCols];
#pragma unroll
      for (int w = 0; w < kSlots; ++w)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[w][c] = 0.0f;
      for (int k = 0; k < kLane; k += 4) {
        const int ka = (k + s) % kLane;  // the rolled block's lane k
        float b[4][kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            b[i][c] = rhs[(k + i) * kLane + c0 + c * kColThreads];
#pragma unroll
        for (int w = 0; w < kSlots; ++w) {
          const float4 a =
              *reinterpret_cast<const float4*>(row + w * kLane + ka);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[w][c] = acc[w][c] + a.x * b[0][c];
            acc[w][c] = acc[w][c] + a.y * b[1][c];
            acc[w][c] = acc[w][c] + a.z * b[2][c];
            acc[w][c] = acc[w][c] + a.w * b[3][c];
          }
        }
      }
#pragma unroll
      for (int w = 0; w < kSlots; ++w)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          grp_s[(g * kSlots + w) * kLane + c0 + c * kColThreads] = acc[w][c];
      __syncthreads();
      unsigned m = 0u;
      for (int i = tid; i < kSlots * kLane; i += kThreads) {
        const int w = i / kLane, n = i % kLane;
        float x[kGroups];
#pragma unroll
        for (int k = 0; k < kGroups; ++k)
          x[k] = grp_s[(k * kSlots + w) * kLane + n];
        const float t0 = fmaxf(fmaxf(fminf(x[0], x[3]), fminf(x[1], x[4])),
                               fminf(x[2], x[5]));
        const float t1 = fminf(fminf(fmaxf(x[0], x[3]), fmaxf(x[1], x[4])),
                               fmaxf(x[2], x[5]));
        m |= static_cast<unsigned>(t0 <= t1 && t1 >= 0.0f) << w;
      }
      mask_s = static_cast<int>(probe::block_or<kThreads>(m, words, v));
    }
    if (tid == 0 && visits != nullptr) visits[v] = mask_s;
    fold = fold * 33u + static_cast<unsigned>(mask_s);
    q += 1 + (mask_s & 1);
    ++v;
  }
  if constexpr (kStaged) {
    // the blocks the ring took ahead of where the walk stopped land before
    // the block exits
    if (tid == 0)
      for (int j = cur + 1; j < cur + kStages && j * kSlots < iters; ++j)
        tpu_rt::bar_wait(&full[j % kStages], (j / kStages) & 1);
  }
  // best stays -1 in every variant: out = t_best + float(best); row0's
  // t_best is every ray row's, and kFloor's and kMxu's threads all hold inf
  if constexpr (V == kRow0) {
#pragma unroll
    for (int rr = 0; rr < kR; ++rr)
      out[rr * kLane + lane] = t_best[0] + -1.0f;
  } else if constexpr (V == kCur) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h)
      out[tid + h * kThreads] = t_best[h] + -1.0f;
  } else {
    for (int i = tid; i < kRays; i += kThreads) out[i] = t_best[0] + -1.0f;
  }
  if (tid == 0) {
    stats[0] = v;
    stats[1] = static_cast<int>(fold);
  }
}

template <int V>
int launch(const float* nodes, const float* o, const float* inv,
           const float* t_min, const float* act, float* out, int* visits,
           int* stats, int iters, cudaStream_t stream) {
  auto kernel = probe_slab_cost<V>;
  constexpr int smem = smem_of(V);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<1, threads_of(V), smem, stream>>>(nodes, o, inv, t_min, act, out,
                                             visits, stats, iters, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpu_rt_probe_slab_cost(const float* nodes, const float* o,
                                      const float* inv, const float* t_min,
                                      const float* act, float* out,
                                      int* visits, int* stats, int variant,
                                      int iters, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case kFloor:
      return launch<kFloor>(nodes, o, inv, t_min, act, out, visits, stats,
                            iters, stream);
    case kCur:
      return launch<kCur>(nodes, o, inv, t_min, act, out, visits, stats,
                          iters, stream);
    case kRow0:
      return launch<kRow0>(nodes, o, inv, t_min, act, out, visits, stats,
                           iters, stream);
    case kMxu:
      return launch<kMxu>(nodes, o, inv, t_min, act, out, visits, stats,
                          iters, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
