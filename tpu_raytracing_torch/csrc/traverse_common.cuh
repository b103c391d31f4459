// Shared pieces of the port's triangle walks (one thread per ray).
//
// Every walk in this directory answers the query of
// tpu_raytracing/ops/traverse_pallas.py::intersect_tris_pallas: the closest
// (or any) triangle hit of a ray batch, as (t, best) with t = t_max and
// best = -1 where there is none. They share the ray load, the slab test and
// Moller-Trumbore below, written exactly as the TPU kernels and the plain
// PyTorch walks write them (traverse_pallas.py:227-253), so that with
// -fmad=false and IEEE divides every walk's t is bit-equal to its plain
// version's.
//
// Optional per-ray counters (`counts`, nullptr in normal launches): three
// int32 per ray, node visits, box (slab) tests and triangle tests. They
// count the work the query needs: tests of real triangles and boxes of real
// children, not the zero rows that pad a bvh8t group or the empty slots of
// a node. chip_smoke.py computes the card's bound for a launch from them.
//
// The persistent grid of the stack walks K1/K2 (bvh8t_walk.cu), K4
// (quad_walk.cu) and K5 (pair_walk.cu) and of the skip-link walk K6
// (skip_walk.cu) is here too: the ray fetch (`RayFetch`, `ray_at`), the
// launch (`persistent_launch`) and the cross-lane minimum (`warp_min`); so
// is the leaf phase that K4, K5 and K6 share (`test_leaves`), which tests a
// sparse warp's leaves across its lanes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpu_rt {

constexpr int kStackCap = 64;  // traverse_pallas.py STACK_CAP; wrappers check the bound
constexpr int kRow = 128;      // f32 lanes per packed table row
constexpr float kBaryEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCoop = 4;  // lanes with leaves at or below which test_leaves
                          // tests them across the warp, a leaf an 8 lanes

// min / max that propagate NaN as jnp.minimum / torch.minimum do (fminf
// would drop it): a ray lying in a slab plane with a zero direction
// component then misses as it does in the plain walks.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// The same two as one instruction each: PTX min.NaN / max.NaN (sm_80 on)
// give NaN where either operand is, and min / max otherwise. Their NaN has
// another payload than the two above, which no walk reads: a slab's NaN only
// fails the comparisons of slab_hit.
template <bool PTX_NAN>
__device__ __forceinline__ float slab_min(float a, float b) {
#ifdef __CUDA_ARCH__
  if (PTX_NAN) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
#endif
  return nan_min(a, b);
}

template <bool PTX_NAN>
__device__ __forceinline__ float slab_max(float a, float b) {
#ifdef __CUDA_ARCH__
  if (PTX_NAN) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
#endif
  return nan_max(a, b);
}

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;  // 1 / d, IEEE (inf on a zero component)
  float t_min;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        const float* __restrict__ t_min, int i) {
  Ray r;
  r.ox = origin[3 * i];
  r.oy = origin[3 * i + 1];
  r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i];
  r.dy = direction[3 * i + 1];
  r.dz = direction[3 * i + 2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  r.t_min = t_min[i];
  return r;
}

// Slab test of the box (min3, max3) at `box`: hit iff t0 <= t1,
// t1 >= t_min and t0 <= t_best. Writes the entry distance t0 (a NaN's
// payload depends on PTX_NAN). K4, K5 and K6 take PTX_NAN = true (measured
// faster on the H100, PERF.md); K1/K2 keep the select form.
template <bool PTX_NAN = false>
__device__ __forceinline__ bool slab_hit(const Ray& r, const float* box,
                                         float t_best, float* t_entry) {
  const float ax = (box[0] - r.ox) * r.ix, bx = (box[3] - r.ox) * r.ix;
  const float ay = (box[1] - r.oy) * r.iy, by = (box[4] - r.oy) * r.iy;
  const float az = (box[2] - r.oz) * r.iz, bz = (box[5] - r.oz) * r.iz;
  float t0 = -INFINITY, t1 = INFINITY;
  t0 = slab_max<PTX_NAN>(t0, slab_min<PTX_NAN>(ax, bx));
  t1 = slab_min<PTX_NAN>(t1, slab_max<PTX_NAN>(ax, bx));
  t0 = slab_max<PTX_NAN>(t0, slab_min<PTX_NAN>(ay, by));
  t1 = slab_min<PTX_NAN>(t1, slab_max<PTX_NAN>(ay, by));
  t0 = slab_max<PTX_NAN>(t0, slab_min<PTX_NAN>(az, bz));
  t1 = slab_min<PTX_NAN>(t1, slab_max<PTX_NAN>(az, bz));
  *t_entry = t0;
  return t0 <= t1 && t1 >= r.t_min && t0 <= t_best;
}

// Moller-Trumbore against the triangle (p0, e1 = p1 - p0, e2 = p2 - p0),
// seam-inclusive barycentric bounds: true (and t) iff the ray hits it in
// [t_min, t_best].
__device__ __forceinline__ bool tri_hit(const Ray& r, float p0x, float p0y,
                                        float p0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, float t_best, float* t_out) {
  const float pv0 = r.dy * e2z - r.dz * e2y;
  const float pv1 = r.dz * e2x - r.dx * e2z;
  const float pv2 = r.dx * e2y - r.dy * e2x;
  const float den = pv0 * e1x + pv1 * e1y + pv2 * e1z;
  const float sden = den == 0.0f ? 1.0f : den;
  const float tv0 = r.ox - p0x, tv1 = r.oy - p0y, tv2 = r.oz - p0z;
  const float u = (pv0 * tv0 + pv1 * tv1 + pv2 * tv2) / sden;
  const float qv0 = tv1 * e1z - tv2 * e1y;
  const float qv1 = tv2 * e1x - tv0 * e1z;
  const float qv2 = tv0 * e1y - tv1 * e1x;
  const float v = (qv0 * r.dx + qv1 * r.dy + qv2 * r.dz) / sden;
  const float t = (qv0 * e2x + qv1 * e2y + qv2 * e2z) / sden;
  *t_out = t;
  return den != 0.0f && u >= -kBaryEps && u <= 1.0f + kBaryEps &&
         v >= -kBaryEps && u + v <= 1.0f + kBaryEps && t >= r.t_min &&
         t <= t_best;
}

__device__ __forceinline__ void store_counts(int* __restrict__ counts, int i,
                                             int visits, int boxes, int tests) {
  if (counts != nullptr) {
    counts[3 * i] = visits;
    counts[3 * i + 1] = boxes;
    counts[3 * i + 2] = tests;
  }
}

// ---------------------------------------------------------------------------
// The persistent grid: SMs x the blocks that fit on one SM. Once a
// kernel's refill threshold of a warp's lanes are idle (all 32 in K1), the
// idle lanes take the next fetch positions from a counter in device memory
// that the launch zeroes (atomicAdd on a scratch int the wrapper
// allocates); a run of costly rays then holds no launch open after the
// others are done.

// The ray behind fetch position k: positions go out in order, and each
// aligned 32 of them take CHUNK consecutive rays from 32 / CHUNK places
// n_batches chunks apart (CHUNK = 32: the next 32 rays). Returns -1 past
// the last ray.
template <int CHUNK>
__device__ __forceinline__ int ray_at(int k, int n_batches, int n_rays) {
  static_assert(32 % CHUNK == 0, "a warp's 32 positions take whole chunks");
  const int j = (k % 32) / CHUNK;
  const int r = ((k / 32) + j * n_batches) * CHUNK + k % CHUNK;
  return r < n_rays ? r : -1;
}

// One warp's side of the fetch. `open` is warp-uniform: false once the
// counter has handed out every ray.
template <int CHUNK>
struct RayFetch {
  int n_rays, n_batches;
  bool open;

  __device__ explicit RayFetch(int n) : n_rays(n), open(true) {
    const int n_chunks = (n + CHUNK - 1) / CHUNK;
    n_batches = (n_chunks + 32 / CHUNK - 1) / (32 / CHUNK);
  }

  // Called by every lane of the warp when at least `refill` of its lanes
  // are idle (32: all of them): the idle lanes take the next fetch
  // positions in lane order. This lane's next ray, or -1 (busy or none
  // left).
  __device__ int next(int* __restrict__ counter, int lane, bool idle,
                      int refill) {
    const unsigned idle_mask = __ballot_sync(kFull, idle);
    const int n_idle = __popc(idle_mask);
    if (!open || n_idle < refill) return -1;
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, n_idle);
    base = __shfl_sync(kFull, base, 0);
    if (base + n_idle >= 32 * n_batches) open = false;
    const int k = base + __popc(idle_mask & ((1u << lane) - 1u));
    return idle && k < 32 * n_batches ? ray_at<CHUNK>(k, n_batches, n_rays)
                                      : -1;
  }
};

// The lowest (t, key) across each aligned group of WIDTH lanes (the whole
// warp by default): the least t, and of equal t the least key.
template <int WIDTH = 32>
__device__ __forceinline__ void warp_min(float* t, int* key) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    const float ot = __shfl_xor_sync(kFull, *t, o);
    const int ok = __shfl_xor_sync(kFull, *key, o);
    if (ot < *t || (ot == *t && ok < *key)) {
      *t = ot;
      *key = ok;
    }
  }
}

// The SMs and the blocks of one kernel that fit on one, asked again only
// when the device changes, not at every launch (a host cost): one a
// kernel instantiation.
struct GridCache {
  int dev = -1, sms = 0, per_sm = 0;
};

// Launch `kernel` at `threads` a block on a persistent grid, SMs x the
// blocks one SM holds (no more than n_rays need), behind a memset of its
// fetch counter; `cache` is the instantiation's.
template <typename Kernel, typename... Args>
inline cudaError_t persistent_launch(Kernel kernel, int threads, int n_rays,
                                     GridCache* cache, int* counter,
                                     cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cache->dev) {
    err = cudaDeviceGetAttribute(&cache->sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cache->per_sm,
                                                          kernel, threads, 0);
    }
    if (err != cudaSuccess) return err;
    cache->dev = dev;
  }
  if (cache->per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid =
      min(cache->sms * cache->per_sm, (n_rays + threads - 1) / threads);
  err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, 0, stream>>>(args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Leaves of the quad and skip-link tables, read as 16-byte records.

// p0 p1 p2 of a triangle record (and, in a tri_rows slot, the id's bits at
// word 9, c.y): three 16-byte loads.
struct TriRec {
  float4 a, b, c;
};

__device__ __forceinline__ TriRec load_tri(const float4* __restrict__ p) {
  return TriRec{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// The same test on a TriRec's p0, p1, p2 (the skip-link, pair and quad
// tables store vertices; the kernels form the edges as the TPU's do).
__device__ __forceinline__ bool tri_hit_rec(const Ray& r, const TriRec& q,
                                            float t_best, float* t_out) {
  const float p0x = q.a.x, p0y = q.a.y, p0z = q.a.z;
  return tri_hit(r, p0x, p0y, p0z, q.a.w - p0x, q.b.x - p0y, q.b.y - p0z,
                 q.b.z - p0x, q.b.w - p0y, q.c.x - p0z, t_best, t_out);
}

// Record k of the leaf at `first`: a packed triangle (tri_pack_pk, 16 f32
// a triangle, clamped to the last one) or slot k of row `first` of
// tri_rows (ROWREC).
template <bool ROWREC>
__device__ __forceinline__ const float4* leaf_tri(
    const float4* __restrict__ tris, int first, int k, int n_tris) {
  return ROWREC ? tris + static_cast<size_t>(first) * (kRow / 4) + 4 * k
                : tris + static_cast<size_t>(min(first + k, n_tris - 1)) * 4;
}

// The winner that record k of the leaf at `first` stands for.
template <bool ROWREC>
__device__ __forceinline__ int leaf_id(int first, int k, const TriRec& q) {
  return ROWREC ? __float_as_int(q.c.y) : first + k;
}

// Up to N metas of a lane's visit in order: its hit leaves ((first << 3) |
// count, in the order they are tested) or its hit internal children.
// `meta` is indexed with constants only, so it stays in registers.
template <int N>
struct Pending {
  int meta[N];
  int n;
};

template <int N>
__device__ __forceinline__ void append(Pending<N>* p, int meta) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (p->n == j) p->meta[j] = meta;
  }
  ++p->n;
}

// The leaf phase of one visit of every lane of the warp (all lanes call
// it): each lane's pending leaves in order, the first minimum inside a
// leaf, then a <= update of t_best, as every TPU walk's leaf phase does
// (its ok test holds t <= t_best). When at most kCoop lanes have leaves,
// the warp tests them together: the j-th leaves of up to four lanes at once, a leaf an 8 lanes and a record a lane, each against
// its lane's t_best from before the visit's first leaf, and an 8-lane
// minimum of (t, k). Folding a lane's leaves with t <= the fold's t gives
// what the leaf-by-leaf updates give: a record that passes against a later,
// lower t_best passes against the earlier one, and the least t of all the
// visit's leaves passes every update from its leaf on, so the last leaf
// that holds it wins, at its first record with that t. Otherwise each lane
// tests its own leaves a record at a time, the next record's loads issued
// before the current record's test.
template <bool ROWREC, int N>
__device__ __forceinline__ void test_leaves(const Ray& ray,
                                            const float4* __restrict__ tris,
                                            const Pending<N>& p, int n_tris,
                                            float* t_best, int* best,
                                            int* n_tests) {
  const unsigned leafy = __ballot_sync(kFull, p.n > 0);
  if (leafy == 0) return;
  const int lane = threadIdx.x & 31;
  if (__popc(leafy) <= kCoop) {
    const int g = lane >> 3, k = lane & 7;
    float fold_t = INFINITY;
    int fold_id = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned mask = __ballot_sync(kFull, p.n > j);
      if (mask == 0) break;
      unsigned m = mask;  // group g takes the g-th lane of the mask
      for (int x = 0; x < g; ++x) m &= m - 1;
      const int src = m != 0 ? __ffs(m) - 1 : 0;
      Ray rs{};
      rs.ox = __shfl_sync(kFull, ray.ox, src);
      rs.oy = __shfl_sync(kFull, ray.oy, src);
      rs.oz = __shfl_sync(kFull, ray.oz, src);
      rs.dx = __shfl_sync(kFull, ray.dx, src);
      rs.dy = __shfl_sync(kFull, ray.dy, src);
      rs.dz = __shfl_sync(kFull, ray.dz, src);
      rs.t_min = __shfl_sync(kFull, ray.t_min, src);
      const float tb = __shfl_sync(kFull, *t_best, src);
      const int meta = __shfl_sync(kFull, p.n > j ? p.meta[j] : 0, src);
      const int first = meta >> 3, count = meta & 7;
      float t = INFINITY;
      int kk = k, id = 0;
      if (m != 0 && k < count) {
        const TriRec q = load_tri(leaf_tri<ROWREC>(tris, first, k, n_tris));
        float th;
        if (tri_hit_rec(rs, q, tb, &th)) t = th;
        id = leaf_id<ROWREC>(first, k, q);
      }
      warp_min<8>(&t, &kk);  // the group's first minimum, and its winner
      id = __shfl_sync(kFull, id, (lane & ~7) | kk);
      // a lane with a j-th leaf reads its group's minimum
      const int from = (8 * __popc(mask & ((1u << lane) - 1u))) & 31;
      const float gt = __shfl_sync(kFull, t, from);
      const int gid = __shfl_sync(kFull, id, from);
      if (p.n > j) {
        *n_tests += p.meta[j] & 7;
        if (gt < INFINITY && gt <= fold_t) {
          fold_t = gt;
          fold_id = gid;
        }
      }
    }
    if (fold_t < INFINITY) {
      *t_best = fold_t;
      *best = fold_id;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j >= p.n) break;
    const int first = p.meta[j] >> 3, count = p.meta[j] & 7;
    float cur_t = INFINITY;
    int cur_id = 0;
    TriRec q = load_tri(leaf_tri<ROWREC>(tris, first, 0, n_tris));
    for (int k = 0; k < count; ++k) {
      TriRec nq = q;
      if (k + 1 < count) {
        nq = load_tri(leaf_tri<ROWREC>(tris, first, k + 1, n_tris));
      }
      float t;
      if (tri_hit_rec(ray, q, *t_best, &t) && t < cur_t) {
        cur_t = t;
        cur_id = leaf_id<ROWREC>(first, k, q);
      }
      q = nq;
    }
    *n_tests += count;
    if (cur_t < INFINITY) {
      *t_best = cur_t;
      *best = cur_id;
    }
  }
}

// ---------------------------------------------------------------------------
// The TMA ring of K3 (t8_brute.cu) and P2 (probe_slab_cost.cu): mbarriers in
// shared memory that one thread arms with the bytes it expects, and bulk
// copies (cp.async.bulk) from device memory that complete on them.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Block until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Arm `bar` for one phase that completes when `bytes` have landed.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` from `src` in device memory to `dst` in shared memory; the
// copy completes on `bar`. Both addresses 16-byte aligned, bytes a multiple
// of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The exact prefilter of K3 (t8_brute.cu), which the probes P3 and P1 share
// (probe_common.cuh::group): their Moller-Trumbore bounds are tri_hit's.

constexpr float kMargin = 0x1p-16f;  // the prefilter's margin

// True only where tpu_rt::tri_hit rejects the row, decided without a
// divide from den and the numerators nu, nv of u = nu / den, v = nv / den
// (tri_hit's own values, computed in its operations by K3's test_row and
// P3's probe::group). Write a = |den|, N = nu sgn(den),
// M = nv sgn(den) (sign flips, exact) and T = a 2^-16 rounded up. IEEE
// division is symmetric in sign, so tri_hit's u = fl(N / a), v = fl(M / a).
// The rules:
//   R1  N < -T                  (u below 0 by more than 2^-16)
//   R2  M < -T                  (v likewise)
//   R3  fl(fl(N - a) + M) >= T  (u + v above 1 by about 2^-16 or more)
// One of them holds outside the triangle grown by about 2^-16; u <= 1 needs
// no rule, as v >= 0 and u + v <= 1 give it. Suppose tri_hit accepts the
// row: den != 0, no NaN, u >= -eps, v >= -eps, u <= c and fl(u + v) <= c,
// with eps = fl(1e-5) < 84 2^-23 and c = 1 + 84 2^-23; and
// T >= a 2^-16 = 128 2^-23 a. If a = inf, T = inf and N, M are finite (else
// u or v would be NaN): no rule holds. Else a is finite and positive, and
// - R1: N / a <= -2^-16 would round to at most -2^-16 < -eps (rounding is
//   monotone), so N > -a 2^-16 >= -T. R2 the same with v.
// - R3: here |u|, |v| < 1.0001, so N / a and M / a lie within 0.51 2^-23
//   of u and v, and u + v <= c + 2^-24: N + M - a <= 85.52 2^-23 a.
//   fl(N - a) is exact (Sterbenz) unless N < a / 2, where it adds at most
//   0.51 2^-23 a, and fl(. + M) adds a relative 2^-24 or 2^-150: the left
//   side is below 86.04 2^-23 a + 2^-150 < T while a > 2^-132.4. Below
//   that every value is a multiple of 2^-149 under 2^-126, so both sums
//   are exact and it is at most 85.52 2^-23 a < T.
// So no rule holds. Neither den == 0 nor NaN needs a rule: tri_hit rejects
// those rows itself. Nothing here depends on t_min or t.
__device__ __forceinline__ bool surely_misses(float den, float nu,
                                              float nv) {
  const int sign = __float_as_int(den) & 0x80000000;
  const float n = __int_as_float(__float_as_int(nu) ^ sign);
  const float m = __int_as_float(__float_as_int(nv) ^ sign);
  const float a = fabsf(den);
  const float t = __fmul_ru(a, kMargin);
  return (n < -t) | (m < -t) | ((n - a) + m >= t);
}

}  // namespace tpu_rt
