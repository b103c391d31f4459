// bvh8t wide-node walk: closest-hit and any-hit ray queries, one thread per ray.
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_t8_kernel (launched by
// _t8_tiles). It walks the same tables the JAX package builds
// (device/scene_buffers.py::_bvh8t_layout), so winners compare slot for slot:
//
//   node nid, child slot s:  nodes[((nid / 16) * W + s) * 128 + (nid % 16) * 8 + k]
//                            k 0-2 box min, 3-5 box max (NaN in empty slots)
//   meta[nid] = (child_base << FLD | n_int, leaf_base << FLD | n_leaf),
//                            FLD = 5 (6 at W = 32); internal children in slots
//                            s < n_int lead to node child_base + s, leaf groups
//                            in slots s >= W - n_leaf lead to group
//                            leaf_base + (W - 1 - s)
//   group q, row r < LG:     tris[((q / 12) * LG + r) * 128 + (q % 12) * 10 + k]
//                            k 0-2 p0, 3-5 e1, 6-8 e2, 9 triangle id as int32 bits;
//                            unused rows are zero and fail den != 0
//
// The TPU kernel walked a 512-ray tile in lockstep with a shared scalar stack
// because Mosaic has no per-lane gather; here each thread walks its own ray
// with a private (child_base, pending bitmask) stack in local memory and pops
// with ffs. Leaf groups use the TPU kernel's Moller-Trumbore exactly: the
// lowest id among equal t inside a group, and t <= t_best to update.
//
// What bounds it on the H100: each visit is a chain of dependent loads (meta,
// then up to W child boxes at a 512-byte stride, then LG triangle rows), rays
// of one warp diverge in depth and leaf count, and the stack lives in local
// memory. This is the simple first version; a Hopper-shaped layout (boxes
// packed per node, quantized) or a wavefront scheduler is later work.
//
// Numerics: build without fast math and with -fmad=false, so every divide is
// IEEE and t matches the plain PyTorch walk. The slab test and
// Moller-Trumbore are traverse_common.cuh's (NaN-propagating min/max);
// empty slots are masked by the slot counts besides.

#include "traverse_common.cuh"

namespace {

using tpu_rt::kRow;
using tpu_rt::kStackCap;

constexpr int kNodesPerBlock = 16;
constexpr int kGroupsPerBlock = 12;

template <int W, bool EARLY_EXIT>
__global__ void bvh8t_walk(const float* __restrict__ nodes,
                           const float* __restrict__ tris,
                           const int* __restrict__ meta,
                           const float* __restrict__ origin,
                           const float* __restrict__ direction,
                           const float* __restrict__ t_min_in,
                           const float* __restrict__ t_max_in,
                           const bool* __restrict__ active,
                           float* __restrict__ t_out,
                           int* __restrict__ best_out,
                           int* __restrict__ counts,
                           int n_rays, int leaf_rows) {
  constexpr int FLD = (W == 32) ? 6 : 5;
  constexpr int FLD_MASK = (1 << FLD) - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  float t_best = t_max_in[i];
  int best = -1;
  int visits = 0, boxes = 0, tests = 0;
  if (!active[i]) {
    t_out[i] = t_best;
    best_out[i] = best;
    tpu_rt::store_counts(counts, i, visits, boxes, tests);
    return;
  }
  const tpu_rt::Ray ray = tpu_rt::load_ray(origin, direction, t_min_in, i);

  int stack_base[kStackCap];
  uint32_t stack_mask[kStackCap];
  stack_base[0] = 0;
  stack_mask[0] = 1u;  // the root: node 0 = base 0 + slot 0
  int sp = 1;

  while (sp > 0) {
    uint32_t pending = stack_mask[sp - 1];
    const int base = stack_base[sp - 1];
    const int slot = __ffs(pending) - 1;
    pending &= pending - 1;
    if (pending == 0) {
      --sp;
    } else {
      stack_mask[sp - 1] = pending;
    }
    const int nid = base + slot;
    const int m0 = meta[2 * nid];
    const int m1 = meta[2 * nid + 1];
    const int child_base = (int)((uint32_t)m0 >> FLD);
    const int n_int = m0 & FLD_MASK;
    const int leaf_base = (int)((uint32_t)m1 >> FLD);
    const int n_leaf = m1 & FLD_MASK;
    ++visits;
    boxes += n_int + n_leaf;

    const float* blk = nodes + (size_t)(nid / kNodesPerBlock) * W * kRow +
                       (nid % kNodesPerBlock) * 8;
    uint32_t hit = 0;
#pragma unroll 4
    for (int s = 0; s < W; ++s) {
      if (s >= n_int && s < W - n_leaf) continue;  // empty slot: NaN box
      float t0;
      if (tpu_rt::slab_hit(ray, blk + s * kRow, t_best, &t0)) hit |= 1u << s;
    }
    const uint32_t int_mask =
        n_int >= 32 ? 0xffffffffu : ((1u << n_int) - 1u);
    const uint32_t imask = hit & int_mask;
    if (imask != 0) {
      stack_base[sp] = child_base;
      stack_mask[sp] = imask;
      ++sp;
    }

    uint32_t lm = hit & ~int_mask;
    while (lm != 0) {
      const int s = __ffs(lm) - 1;
      lm &= lm - 1;
      const int q = leaf_base + (W - 1 - s);
      const float* grp = tris + (size_t)(q / kGroupsPerBlock) * leaf_rows * kRow +
                         (q % kGroupsPerBlock) * 10;
      float tg = INFINITY;
      int idg = 0x7fffffff;
      for (int r = 0; r < leaf_rows; ++r) {
        const float* row = grp + r * kRow;
        float t;
        if (tpu_rt::tri_hit(ray, row[0], row[1], row[2], row[3], row[4], row[5],
                            row[6], row[7], row[8], t_best, &t)) {
          const int id = __float_as_int(row[9]);
          if (t < tg || (t == tg && id < idg)) {
            tg = t;
            idg = id;
          }
        }
      }
      if (counts != nullptr) tests += tpu_rt::t8_used_rows(grp, leaf_rows);
      if (tg < INFINITY) {
        t_best = tg;
        best = idg;
        if (EARLY_EXIT) {
          sp = 0;
          break;
        }
      }
    }
  }
  t_out[i] = t_best;
  best_out[i] = best;
  tpu_rt::store_counts(counts, i, visits, boxes, tests);
}

template <int W>
cudaError_t launch(bool early_exit, dim3 grid, dim3 block, cudaStream_t stream,
                   const float* nodes, const float* tris, const int* meta,
                   const float* origin, const float* direction, const float* t_min,
                   const float* t_max, const bool* active, float* t_out,
                   int* best_out, int* counts, int n_rays, int leaf_rows) {
  if (early_exit) {
    bvh8t_walk<W, true><<<grid, block, 0, stream>>>(
        nodes, tris, meta, origin, direction, t_min, t_max, active, t_out,
        best_out, counts, n_rays, leaf_rows);
  } else {
    bvh8t_walk<W, false><<<grid, block, 0, stream>>>(
        nodes, tris, meta, origin, direction, t_min, t_max, active, t_out,
        best_out, counts, n_rays, leaf_rows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpu_rt_bvh8t_walk(const float* nodes, const float* tris,
                                 const int* meta, const float* origin,
                                 const float* direction, const float* t_min,
                                 const float* t_max, const bool* active,
                                 float* t_out, int* best_out, int* counts,
                                 int n_rays, int width, int leaf_rows,
                                 int early_exit, void* stream) {
  if (n_rays <= 0) return 0;
  if (leaf_rows <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((n_rays + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ee = early_exit != 0;
  switch (width) {
    case 8:
      return (int)launch<8>(ee, grid, block, s, nodes, tris, meta, origin,
                            direction, t_min, t_max, active, t_out, best_out,
                            counts, n_rays, leaf_rows);
    case 16:
      return (int)launch<16>(ee, grid, block, s, nodes, tris, meta, origin,
                             direction, t_min, t_max, active, t_out, best_out,
                             counts, n_rays, leaf_rows);
    case 32:
      return (int)launch<32>(ee, grid, block, s, nodes, tris, meta, origin,
                             direction, t_min, t_max, active, t_out, best_out,
                             counts, n_rays, leaf_rows);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
