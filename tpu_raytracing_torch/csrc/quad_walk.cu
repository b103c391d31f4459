// BVH4 walk over quad records: closest-hit and any-hit, one thread per ray,
// for the `quad` and `quadrow` layouts (template ROWREC).
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_quad_kernel, wrapped by
// _gridless_kernel and launched by _quad_tiles, which the JAX package runs
// for TPU_RT_PALLAS_KERNEL=quad or quadrow. It walks the JAX package's
// tables (scene_buffers.py::_bvh4_layout, _rowrec_layout):
//
//   record n (32 f32):  quad:    recs[n * 32 + k]  (bvh4_recs_pk)
//                       quadrow: recs[n * 128 + k] (bvh4_rows, lanes 0-31)
//                       k 6j..6j+5 box of slot j < 4, 24 + j bits(meta_j),
//                       28 bits(axes = a_top | a_l << 2 | a_r << 4
//                                      | nkids << 6 | nleft << 9)
//   meta:               leaf (first << 3) | count, internal record << 3,
//                       -1 absent; slots j >= nkids are absent
//   leaf, quad:         triangles first .. first + count - 1 of tris
//                       (tri_pack_pk, 16 f32 each: p0 p1 p2); winner first + k
//   leaf, quadrow:      `first` is a ROW of tri_rows: slot k holds p0 p1 p2 at
//                       lanes 16k..16k+8 and the triangle id as int32 bits at
//                       lane 16k+9; the winner is that id, not first + k
//
// A visit tests the (up to) four child boxes, then goes through the slots
// near to far: hit leaves are intersected at once, and of the hit internal
// children the nearest becomes the next node while the others are pushed
// far to near. Any-hit uses storage order and stops after the visit that
// found a hit.
//
// The TPU kernel walked a tile in lockstep with one scalar stack and ordered
// slots by a tile-majority vote of direction signs on the record's split
// axes. Here every thread keeps a private 64-entry stack (the wrapper raises
// when bvh4_stack exceeds it) and orders by its own direction signs on the
// same axes. The same leaves are reached, so winners agree except on
// equal-t ties between leaves. The TPU_RT_KERNEL_PROBE cost copies and the
// TPU_RT_TILE_K tile width only measured the TPU and are left out.
//
// What bounds it on the H100: latency of the dependent 128-byte record loads
// and of the leaf reads behind them, and divergence between the rays of a
// warp. quadrow reads a leaf's triangles as one 512-byte row instead of up
// to four scattered 64-byte records.

#include "traverse_common.cuh"

namespace {

constexpr int kDone = -1;

__device__ __forceinline__ bool negative(const tpu_rt::Ray& r, int axis) {
  return (axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz)) < 0.0f;
}

template <bool ROWREC>
__device__ __forceinline__ void quad_leaf(const tpu_rt::Ray& r,
                                          const float* __restrict__ tris,
                                          int meta, int n_tris, float* t_best,
                                          int* best, int* tests) {
  const int first = meta >> 3;
  const int count = meta & 7;
  if (!ROWREC) {
    tpu_rt::packed_leaf(r, tris, first, count, n_tris, t_best, best, tests);
    return;
  }
  const float* row = tris + (size_t)first * tpu_rt::kRow;
  float cur_t = INFINITY;
  int cur_id = 0;
  for (int k = 0; k < count; ++k) {
    float t;
    if (tpu_rt::tri_hit_verts(r, row + 16 * k, *t_best, &t) && t < cur_t) {
      cur_t = t;
      cur_id = __float_as_int(row[16 * k + 9]);
    }
  }
  *tests += count;
  if (cur_t < INFINITY) {
    *t_best = cur_t;
    *best = cur_id;
  }
}

template <bool ROWREC, bool EARLY_EXIT>
__global__ void quad_walk(const float* __restrict__ recs,
                          const float* __restrict__ tris,
                          const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const float* __restrict__ t_min_in,
                          const float* __restrict__ t_max_in,
                          const bool* __restrict__ active,
                          float* __restrict__ t_out, int* __restrict__ best_out,
                          int* __restrict__ counts, int n_rays, int root_meta,
                          int n_tris) {
  constexpr int kStride = ROWREC ? tpu_rt::kRow : 32;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  float t_best = t_max_in[i];
  int best = -1;
  int visits = 0, boxes = 0, tests = 0;
  if (active[i] && root_meta >= 0) {
    const tpu_rt::Ray ray = tpu_rt::load_ray(origin, direction, t_min_in, i);
    if (root_meta & 7) {
      quad_leaf<ROWREC>(ray, tris, root_meta, n_tris, &t_best, &best, &tests);
    } else {
      int stack[tpu_rt::kStackCap];
      int sp = 0;
      int cur = root_meta;
      while (cur != kDone) {
        const float* rec = recs + (size_t)(cur >> 3) * kStride;
        const int axes = __float_as_int(rec[28]);
        const int nkids = (axes >> 6) & 7;
        const int nleft = (axes >> 9) & 3;
        int metas[4];
        bool hits[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          metas[j] = __float_as_int(rec[24 + j]);
          float t0;
          hits[j] = j < nkids && tpu_rt::slab_hit(ray, rec + 6 * j, t_best, &t0);
        }
        ++visits;
        boxes += nkids;

        int order[4] = {0, 1, 2, 3};
        if (!EARLY_EXIT) {
          const bool sgn_top = negative(ray, axes & 3);
          const bool sgn_l = negative(ray, (axes >> 2) & 3);
          const bool sgn_r = negative(ray, (axes >> 4) & 3);
          const bool two_l = nleft == 2;
          const bool two_r = nkids - nleft == 2;
          const int l0 = (two_l && sgn_l) ? 1 : 0;
          const int l1 = two_l ? 1 - l0 : -1;
          const int r0 = nleft + ((two_r && sgn_r) ? 1 : 0);
          const int r1 = two_r ? nleft + (1 - (r0 - nleft)) : -1;
          order[0] = sgn_top ? r0 : l0;
          order[1] = sgn_top ? r1 : l1;
          order[2] = sgn_top ? l0 : r0;
          order[3] = sgn_top ? l1 : r1;
        }

        // near to far: leaves now, internal hits collected in order
        int go_meta[4];
        int n_go = 0;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int s = order[o];
          if (s < 0 || !hits[s]) continue;
          const int m = metas[s];
          if (m == kDone) continue;
          if (m & 7) {
            quad_leaf<ROWREC>(ray, tris, m, n_tris, &t_best, &best, &tests);
          } else {
            go_meta[n_go++] = m;
          }
        }
        if (EARLY_EXIT && best >= 0) break;
        if (n_go > 0) {
          for (int k = n_go - 1; k >= 1; --k) stack[sp++] = go_meta[k];
          cur = go_meta[0];
        } else {
          cur = sp > 0 ? stack[--sp] : kDone;
        }
      }
    }
  }
  t_out[i] = t_best;
  best_out[i] = best;
  tpu_rt::store_counts(counts, i, visits, boxes, tests);
}

template <bool ROWREC>
cudaError_t launch(bool early_exit, dim3 grid, dim3 block, cudaStream_t s,
                   const float* recs, const float* tris, const float* origin,
                   const float* direction, const float* t_min,
                   const float* t_max, const bool* active, float* t_out,
                   int* best_out, int* counts, int n_rays, int root_meta,
                   int n_tris) {
  if (early_exit) {
    quad_walk<ROWREC, true><<<grid, block, 0, s>>>(
        recs, tris, origin, direction, t_min, t_max, active, t_out, best_out,
        counts, n_rays, root_meta, n_tris);
  } else {
    quad_walk<ROWREC, false><<<grid, block, 0, s>>>(
        recs, tris, origin, direction, t_min, t_max, active, t_out, best_out,
        counts, n_rays, root_meta, n_tris);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpu_rt_quad_walk(const float* recs, const float* tris,
                                const float* origin, const float* direction,
                                const float* t_min, const float* t_max,
                                const bool* active, float* t_out, int* best_out,
                                int* counts, int n_rays, int root_meta,
                                int n_tris, int rowrec, int early_exit,
                                void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((n_rays + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ee = early_exit != 0;
  if (rowrec) {
    return (int)launch<true>(ee, grid, block, s, recs, tris, origin, direction,
                             t_min, t_max, active, t_out, best_out, counts,
                             n_rays, root_meta, n_tris);
  }
  return (int)launch<false>(ee, grid, block, s, recs, tris, origin, direction,
                            t_min, t_max, active, t_out, best_out, counts,
                            n_rays, root_meta, n_tris);
}
