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

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpu_rt {

constexpr int kStackCap = 64;  // traverse_pallas.py STACK_CAP; wrappers check the bound
constexpr int kRow = 128;      // f32 lanes per packed table row
constexpr float kBaryEps = 1e-5f;

// min / max that propagate NaN as jnp.minimum / torch.minimum do (fminf
// would drop it): a ray lying in a slab plane with a zero direction
// component then misses as it does in the plain walks.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
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
// t1 >= t_min and t0 <= t_best. Writes the entry distance t0.
__device__ __forceinline__ bool slab_hit(const Ray& r, const float* box,
                                         float t_best, float* t_entry) {
  const float ax = (box[0] - r.ox) * r.ix, bx = (box[3] - r.ox) * r.ix;
  const float ay = (box[1] - r.oy) * r.iy, by = (box[4] - r.oy) * r.iy;
  const float az = (box[2] - r.oz) * r.iz, bz = (box[5] - r.oz) * r.iz;
  float t0 = -INFINITY, t1 = INFINITY;
  t0 = nan_max(t0, nan_min(ax, bx));
  t1 = nan_min(t1, nan_max(ax, bx));
  t0 = nan_max(t0, nan_min(ay, by));
  t1 = nan_min(t1, nan_max(ay, by));
  t0 = nan_max(t0, nan_min(az, bz));
  t1 = nan_min(t1, nan_max(az, bz));
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

// The same test on a packed record p0, p1, p2 (the skip-link, pair and
// quad tables store vertices; the kernels form the edges as the TPU's do).
__device__ __forceinline__ bool tri_hit_verts(const Ray& r, const float* v,
                                              float t_best, float* t_out) {
  const float p0x = v[0], p0y = v[1], p0z = v[2];
  return tri_hit(r, p0x, p0y, p0z, v[3] - p0x, v[4] - p0y, v[5] - p0z,
                 v[6] - p0x, v[7] - p0y, v[8] - p0z, t_best, t_out);
}

// A leaf of `count` consecutive packed records from triangle `first` of
// (T8, 16) records: the first minimum inside the leaf, then a <= update
// against t_best (the ok test holds t <= t_best), as every TPU walk's
// leaf phase does.
__device__ __forceinline__ void packed_leaf(const Ray& r,
                                            const float* __restrict__ tris,
                                            int first, int count, int n_tris,
                                            float* t_best, int* best,
                                            int* n_tests) {
  float cur_t = INFINITY;
  int cur_k = 0;
  for (int k = 0; k < count; ++k) {
    const int ti = min(first + k, n_tris - 1);
    float t;
    if (tri_hit_verts(r, tris + (size_t)ti * 16, *t_best, &t) && t < cur_t) {
      cur_t = t;
      cur_k = k;
    }
  }
  *n_tests += count;
  if (cur_t < INFINITY) {
    *t_best = cur_t;
    *best = first + cur_k;
  }
}

__device__ __forceinline__ void store_counts(int* __restrict__ counts, int i,
                                             int visits, int boxes, int tests) {
  if (counts != nullptr) {
    counts[3 * i] = visits;
    counts[3 * i + 1] = boxes;
    counts[3 * i + 2] = tests;
  }
}

}  // namespace tpu_rt
