// Stackless skip-link walk: closest-hit and any-hit, one thread per ray.
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_walk_kernel (launched by
// _walk_tiles), which the JAX package runs when TPU_RT_PALLAS_KERNEL names
// none of its other kinds. It walks the JAX package's packed tables
// (traverse_pallas.py::pack_tables):
//
//   node n:      nodes[n * 8 + k], k 0-2 box min, 3-5 box max,
//                6 bits((first << 3) | count), count 0 = internal, 7 bits(skip)
//   triangle t:  tris[t * 16 + k], k 0-2 p0, 3-5 p1, 6-8 p2
//
// in preorder: on an internal hit descend to n + 1, else jump to skip[n],
// until the sentinel n_bvh_nodes. A hit leaf takes its first minimum, then
// a <= update against t_best. Any-hit stops at the first hit.
//
// The TPU kernel moved a whole 1,024-ray tile with one scalar node pointer
// (descend when any lane hits) because Mosaic has no per-lane gather; here
// every thread follows its own pointer. Box containment makes the lane's
// hit set, and so its winner, the same in both.
//
// What bounds it on the H100: latency. Every visit is a dependent 32-byte
// load of the next node, with no near-first order to tighten t_best early,
// so a ray visits more nodes than the stack walks do, and rays of a warp
// diverge. The design keeps no stack at all (nothing in local memory);
// the node records are read through the read-only cache.

#include "traverse_common.cuh"

namespace {

template <bool EARLY_EXIT>
__global__ void skip_walk(const float* __restrict__ nodes,
                          const float* __restrict__ tris,
                          const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const float* __restrict__ t_min_in,
                          const float* __restrict__ t_max_in,
                          const bool* __restrict__ active,
                          float* __restrict__ t_out, int* __restrict__ best_out,
                          int* __restrict__ counts, int n_rays, int sentinel,
                          int n_tris) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  float t_best = t_max_in[i];
  int best = -1;
  int visits = 0, tests = 0;
  if (active[i]) {
    const tpu_rt::Ray ray = tpu_rt::load_ray(origin, direction, t_min_in, i);
    int node = 0;
    while (node < sentinel) {
      const float* rec = nodes + (size_t)node * 8;
      ++visits;
      float t0;
      const bool hit = tpu_rt::slab_hit(ray, rec, t_best, &t0);
      const int meta = __float_as_int(rec[6]);
      const int skip = __float_as_int(rec[7]);
      const int count = meta & 7;
      if (hit && count > 0) {
        tpu_rt::packed_leaf(ray, tris, meta >> 3, count, n_tris, &t_best, &best,
                            &tests);
        if (EARLY_EXIT && best >= 0) break;
      }
      node = (hit && count == 0) ? node + 1 : skip;
    }
  }
  t_out[i] = t_best;
  best_out[i] = best;
  tpu_rt::store_counts(counts, i, visits, visits, tests);
}

}  // namespace

extern "C" int tpu_rt_skip_walk(const float* nodes, const float* tris,
                                const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const bool* active, float* t_out, int* best_out,
                                int* counts, int n_rays, int sentinel,
                                int n_tris, int early_exit, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0 || sentinel <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((n_rays + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (early_exit) {
    skip_walk<true><<<grid, block, 0, s>>>(nodes, tris, origin, direction, t_min,
                                           t_max, active, t_out, best_out,
                                           counts, n_rays, sentinel, n_tris);
  } else {
    skip_walk<false><<<grid, block, 0, s>>>(nodes, tris, origin, direction,
                                            t_min, t_max, active, t_out,
                                            best_out, counts, n_rays, sentinel,
                                            n_tris);
  }
  return (int)cudaGetLastError();
}
