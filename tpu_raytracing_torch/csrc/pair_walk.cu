// Child-pair BVH2 walk: closest-hit and any-hit, one thread per ray.
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_pair_kernel (launched by
// _pair_tiles), which the JAX package runs for TPU_RT_PALLAS_KERNEL=pair. It
// walks the JAX package's child-pair rows (scene_buffers.py::
// _child_pair_layout, packed 8 to a row as bvh2_rows_pk) and packed
// triangles:
//
//   row m:       rows[m * 16 + k], k 0-5 left box, 6-11 right box,
//                12 bits(meta_l), 13 bits(meta_r), 14 bits(split axis)
//   meta:        leaf (first << 3) | count (count > 0), internal row << 3
//   triangle t:  tris[t * 16 + k], k 0-2 p0, 3-5 p1, 6-8 p2
//
// Both child boxes are tested at the parent. Hit leaf children are
// intersected at once (left, then right), under their own box hit; when
// both internal children hit, the far one is pushed and the near one
// visited. Any-hit stops after the visit that found a hit.
//
// The TPU kernel shared one scalar stack across a tile and ordered children
// by a tile-majority vote of direction signs. Here each thread keeps a
// private stack (64 entries, local memory; the wrapper raises when
// bvh2_depth exceeds it) and takes the left child as near unless its own
// direction is negative on the stored split axis. The same leaves are
// reached, so winners agree except on equal-t ties between leaves.
//
// What bounds it on the H100: latency of the dependent 64-byte row loads
// (one per visit, two slab tests each) and divergence between the rays of a
// warp; the stack traffic stays in L1.

#include "traverse_common.cuh"

namespace {

constexpr int kDone = -1;

__device__ __forceinline__ float axis_dir(const tpu_rt::Ray& r, int axis) {
  return axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
}

template <bool EARLY_EXIT>
__global__ void pair_walk(const float* __restrict__ rows,
                          const float* __restrict__ tris,
                          const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const float* __restrict__ t_min_in,
                          const float* __restrict__ t_max_in,
                          const bool* __restrict__ active,
                          float* __restrict__ t_out, int* __restrict__ best_out,
                          int* __restrict__ counts, int n_rays, int root_meta,
                          int n_tris) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  float t_best = t_max_in[i];
  int best = -1;
  int visits = 0, tests = 0;
  if (active[i] && root_meta >= 0) {
    const tpu_rt::Ray ray = tpu_rt::load_ray(origin, direction, t_min_in, i);
    if (root_meta & 7) {
      // single-leaf tree: every live ray tests the leaf
      tpu_rt::packed_leaf(ray, tris, root_meta >> 3, root_meta & 7, n_tris,
                          &t_best, &best, &tests);
    } else {
      int stack[tpu_rt::kStackCap];
      int sp = 0;
      int cur = root_meta;
      while (cur != kDone) {
        const float* rec = rows + (size_t)(cur >> 3) * 16;
        ++visits;
        float t0l, t0r;
        const bool hit_l = tpu_rt::slab_hit(ray, rec, t_best, &t0l);
        const bool hit_r = tpu_rt::slab_hit(ray, rec + 6, t_best, &t0r);
        const int meta_l = __float_as_int(rec[12]);
        const int meta_r = __float_as_int(rec[13]);
        const int axis = __float_as_int(rec[14]);
        const bool leaf_l = (meta_l & 7) > 0;
        const bool leaf_r = (meta_r & 7) > 0;
        if (hit_l && leaf_l)
          tpu_rt::packed_leaf(ray, tris, meta_l >> 3, meta_l & 7, n_tris,
                              &t_best, &best, &tests);
        if (hit_r && leaf_r)
          tpu_rt::packed_leaf(ray, tris, meta_r >> 3, meta_r & 7, n_tris,
                              &t_best, &best, &tests);
        if (EARLY_EXIT && best >= 0) break;
        const bool go_l = hit_l && !leaf_l;
        const bool go_r = hit_r && !leaf_r;
        const bool l_near = !(axis_dir(ray, axis) < 0.0f);
        if (go_l && go_r) {
          stack[sp++] = l_near ? meta_r : meta_l;
          cur = l_near ? meta_l : meta_r;
        } else if (go_l) {
          cur = meta_l;
        } else if (go_r) {
          cur = meta_r;
        } else {
          cur = sp > 0 ? stack[--sp] : kDone;
        }
      }
    }
  }
  t_out[i] = t_best;
  best_out[i] = best;
  tpu_rt::store_counts(counts, i, visits, 2 * visits, tests);
}

}  // namespace

extern "C" int tpu_rt_pair_walk(const float* rows, const float* tris,
                                const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const bool* active, float* t_out, int* best_out,
                                int* counts, int n_rays, int root_meta,
                                int n_tris, int early_exit, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((n_rays + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (early_exit) {
    pair_walk<true><<<grid, block, 0, s>>>(rows, tris, origin, direction, t_min,
                                           t_max, active, t_out, best_out,
                                           counts, n_rays, root_meta, n_tris);
  } else {
    pair_walk<false><<<grid, block, 0, s>>>(rows, tris, origin, direction,
                                            t_min, t_max, active, t_out,
                                            best_out, counts, n_rays, root_meta,
                                            n_tris);
  }
  return (int)cudaGetLastError();
}
