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
//           slots whose lo.x > 0 (the script sums 128 lanes of them)
//   kCur    cur and hoist, which differ only in where the TPU kept the
//           rays' row broadcasts; here each thread's ray is in registers
//           either way. Each of R x 128 rays (a thread each) tests each slot
//           twice, as the script's KN = 2 nodes (the same box standing in
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
//           memory (64 KB). 768 threads: thread (k, n) computes the 16 rows
//           of group k in column n, a running sum over the 128 products in
//           order (FMUL then FADD; no tensor cores, whose TF32 would round
//           the inputs). Then column n's threads of group 0 fold the six
//           groups' min/max tree into h = (t0 <= t1) & (t1 >= 0). mask_s = OR
//
// Every visit ends in the block-wide drain (probe_common.cuh::block_or):
// a warp OR, a shared atomicOr and one __syncthreads, which every visit
// waits on, as the TPU probe waits on its vector-to-scalar drain; kMxu adds
// two barriers (the staged block, the groups). Thread 0 writes each visit's
// mask_s to `visits` (optional) and `stats` = (visits run, the wrapping fold
// f = f * 33 + mask_s), so no variant's slab or drain is dead code.
//
// The node table is 512 KB, more than a block's 227 KB of shared memory, so
// a visit reads its 16 boxes (or kMxu its 8 KB block) from device memory
// through L1 and L2: the TPU held the table in VMEM. Those reads wait on the
// last drain, since nid does.
//
// What bounds it on the H100: one block on one SM by design, as the TPU
// probe runs one tile on one core, so it measures a visit's latency. The
// operations (24 a slab test, 16 x 512 x 2 tests a kCur visit) are one SM's
// fp32 issue at best; kFloor and kRow0 do little arithmetic and wait on the
// load and the drain. Numerics: no fast math, -fmad=false.

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using probe::kLane;
constexpr int kSlots = 16;
constexpr int kR = 4;              // ray rows
constexpr int kRays = kR * kLane;
constexpr int kNodes = 1024;
constexpr int kGroups = 6;         // the mxu's stacked copies of the block

enum Variant { kFloor = 0, kCur = 1, kRow0 = 2, kMxu = 3 };

constexpr int threads_of(int v) {
  return v == kRow0 ? kLane : v == kMxu ? kGroups * kLane : kRays;
}

// kMxu's dynamic shared memory: rhs (128, 128), the block (16, 128), the
// groups (6, 16, 128).
constexpr int kRhsFloats = kLane * kLane;
constexpr int kBlockFloats = kSlots * kLane;
constexpr int kMxuBytes =
    (kRhsFloats + kBlockFloats + kGroups * kBlockFloats) * 4;

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
  __shared__ unsigned words[3];
  __shared__ float env[13];
  __shared__ float red[(kLane / 32) * 13];
  extern __shared__ float4 dyn4[];
  float* rhs = reinterpret_cast<float*>(dyn4);
  float* blk_s = rhs + kRhsFloats;
  float* grp_s = blk_s + kBlockFloats;

  const int tid = threadIdx.x;
  const int r = V == kRow0 ? 0 : (tid / kLane) % kR, lane = tid % kLane;
  if (tid < 3) words[tid] = 0u;
  // this thread's ray, and for kCur the second pass's copy of it
  float o[3], inv[3], o2[3], inv2[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int at = ax * kRays + r * kLane + lane;
    o[ax] = o_in[at];
    inv[ax] = inv_in[at];
    o2[ax] = o_in[at + zero];
    inv2[ax] = inv_in[at + zero];
  }
  const float t_min = t_min_in[r * kLane + lane];
  const bool live = act_in[r * kLane + lane] > 0.0f;
  if constexpr (V == kMxu) {
    for (int i = tid; i < kRhsFloats; i += blockDim.x)
      rhs[i] = rhs_at(o_in, inv_in, i / kLane, i % kLane);
  }
  if constexpr (V == kRow0) envelope(o_in, inv_in, t_min_in, env, red);
  __syncthreads();

  float t_best = INFINITY;
  unsigned fold = 0u;
  int q = 0, v = 0;
  while (q < iters) {
    const int nid = q % kNodes;
    const float* row = nodes + (nid / kSlots) * kSlots * kLane;
    const int s = (nid % kSlots) * 8;
    int mask_s;
    if constexpr (V == kFloor) {
      unsigned m = 0u;
#pragma unroll
      for (int w = 0; w < kSlots; ++w)
        m |= static_cast<unsigned>(row[w * kLane + s] > 0.0f) << w;
      mask_s = kLane * static_cast<int>(probe::block_or(m, words, v));
    } else if constexpr (V == kCur) {
      unsigned m0 = 0u, m1 = 0u;
#pragma unroll
      for (int w = 0; w < kSlots; ++w) {
        float lo[3], hi[3], t0, t1;
        probe::load_box(row + w * kLane + s, lo, hi);
        probe::slab(lo, hi, o, inv, t0, t1);
        m0 |= static_cast<unsigned>(t0 <= t1 && t1 >= t_min &&
                                    t0 <= t_best && live) << w;
        probe::slab(lo, hi, o2, inv2, t0, t1);
        m1 |= static_cast<unsigned>(t0 <= t1 && t1 >= t_min &&
                                    t0 <= t_best && live) << w;
      }
      const unsigned all = probe::block_or(m0 | (m1 << 16), words, v);
      mask_s = static_cast<int>((all & 0xffffu) + (all >> 16));
      t_best = fminf(t_best,
                     t_best + static_cast<float>(mask_s) * 0.0f + 1e30f);
    } else if constexpr (V == kRow0) {
      unsigned m = 0u;
      float take = 0.0f;
#pragma unroll
      for (int w = 0; w < kSlots; ++w) {
        float lo[3], hi[3], t0, t1;
        probe::load_box(row + w * kLane + s, lo, hi);
        probe::slab(lo, hi, o, inv, t0, t1);
        m |= static_cast<unsigned>(t0 <= t1 && t1 >= t_min &&
                                   t0 <= t_best) << w;
        if (w == 0) take = t0;
      }
      if (tid < kSlots) {
        float lo[3], hi[3];
        probe::load_box(row + tid * kLane + s, lo, hi);
        m |= static_cast<unsigned>(interval_hit(lo, hi, env)) << tid;
      }
      mask_s = static_cast<int>(probe::block_or(m, words, v));
      t_best = fminf(t_best, fabsf(take) + 1.0f);
    } else {  // kMxu
      for (int i = tid; i < kBlockFloats; i += blockDim.x)
        blk_s[i] = row[(i / kLane) * kLane + (i % kLane + s) % kLane];
      __syncthreads();
      const int g = tid / kLane;
      float acc[kSlots];
#pragma unroll
      for (int w = 0; w < kSlots; ++w) acc[w] = 0.0f;
      for (int k = 0; k < kLane; k += 4) {
        float b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = rhs[(k + c) * kLane + lane];
#pragma unroll
        for (int w = 0; w < kSlots; ++w) {
          const float4 a =
              *reinterpret_cast<const float4*>(blk_s + w * kLane + k);
          acc[w] = acc[w] + a.x * b[0];
          acc[w] = acc[w] + a.y * b[1];
          acc[w] = acc[w] + a.z * b[2];
          acc[w] = acc[w] + a.w * b[3];
        }
      }
#pragma unroll
      for (int w = 0; w < kSlots; ++w)
        grp_s[(g * kSlots + w) * kLane + lane] = acc[w];
      __syncthreads();
      unsigned m = 0u;
      if (g == 0) {
#pragma unroll
        for (int w = 0; w < kSlots; ++w) {
          float x[kGroups];
#pragma unroll
          for (int k = 0; k < kGroups; ++k)
            x[k] = grp_s[(k * kSlots + w) * kLane + lane];
          const float t0 = fmaxf(fmaxf(fminf(x[0], x[3]), fminf(x[1], x[4])),
                                 fminf(x[2], x[5]));
          const float t1 = fminf(fminf(fmaxf(x[0], x[3]), fmaxf(x[1], x[4])),
                                 fmaxf(x[2], x[5]));
          m |= static_cast<unsigned>(t0 <= t1 && t1 >= 0.0f) << w;
        }
      }
      mask_s = static_cast<int>(probe::block_or(m, words, v));
    }
    if (tid == 0 && visits != nullptr) visits[v] = mask_s;
    fold = fold * 33u + static_cast<unsigned>(mask_s);
    q += 1 + (mask_s & 1);
    ++v;
  }
  // best stays -1 in every variant: out = t_best + float(best)
  if constexpr (V == kRow0) {
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) out[rr * kLane + lane] = t_best + -1.0f;
  } else if (tid < kRays) {
    out[tid] = t_best + -1.0f;
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
  const int smem = V == kMxu ? kMxuBytes : 0;
  if (smem > 0) {
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
