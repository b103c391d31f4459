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
// IEEE and t matches the plain PyTorch walk. Min/max propagate NaN as
// jnp.minimum does (fminf would drop it), so a ray lying in a slab plane with
// a zero direction component misses as it does in the plain walk; empty
// slots are masked by the slot counts besides.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStackCap = 64;  // traverse_pallas.py STACK_CAP; the wrapper checks t8_stack
constexpr int kNodesPerBlock = 16;
constexpr int kGroupsPerBlock = 12;
constexpr int kRow = 128;
constexpr float kBaryEps = 1e-5f;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

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
                           int n_rays, int leaf_rows) {
  constexpr int FLD = (W == 32) ? 6 : 5;
  constexpr int FLD_MASK = (1 << FLD) - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  float t_best = t_max_in[i];
  int best = -1;
  if (!active[i]) {
    t_out[i] = t_best;
    best_out[i] = best;
    return;
  }
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1], dz = direction[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float t_min = t_min_in[i];

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

    const float* blk = nodes + (size_t)(nid / kNodesPerBlock) * W * kRow +
                       (nid % kNodesPerBlock) * 8;
    uint32_t hit = 0;
#pragma unroll 4
    for (int s = 0; s < W; ++s) {
      if (s >= n_int && s < W - n_leaf) continue;  // empty slot: NaN box
      const float* box = blk + s * kRow;
      const float ax = (box[0] - ox) * ix, bx = (box[3] - ox) * ix;
      const float ay = (box[1] - oy) * iy, by = (box[4] - oy) * iy;
      const float az = (box[2] - oz) * iz, bz = (box[5] - oz) * iz;
      float t0 = -INFINITY, t1 = INFINITY;
      t0 = nan_max(t0, nan_min(ax, bx));
      t1 = nan_min(t1, nan_max(ax, bx));
      t0 = nan_max(t0, nan_min(ay, by));
      t1 = nan_min(t1, nan_max(ay, by));
      t0 = nan_max(t0, nan_min(az, bz));
      t1 = nan_min(t1, nan_max(az, bz));
      if (t0 <= t1 && t1 >= t_min && t0 <= t_best) hit |= 1u << s;
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
        const float p0x = row[0], p0y = row[1], p0z = row[2];
        const float e1x = row[3], e1y = row[4], e1z = row[5];
        const float e2x = row[6], e2y = row[7], e2z = row[8];
        const float pv0 = dy * e2z - dz * e2y;
        const float pv1 = dz * e2x - dx * e2z;
        const float pv2 = dx * e2y - dy * e2x;
        const float den = pv0 * e1x + pv1 * e1y + pv2 * e1z;
        const float sden = den == 0.0f ? 1.0f : den;
        const float tv0 = ox - p0x, tv1 = oy - p0y, tv2 = oz - p0z;
        const float u = (pv0 * tv0 + pv1 * tv1 + pv2 * tv2) / sden;
        const float qv0 = tv1 * e1z - tv2 * e1y;
        const float qv1 = tv2 * e1x - tv0 * e1z;
        const float qv2 = tv0 * e1y - tv1 * e1x;
        const float v = (qv0 * dx + qv1 * dy + qv2 * dz) / sden;
        const float t = (qv0 * e2x + qv1 * e2y + qv2 * e2z) / sden;
        const bool ok = den != 0.0f && u >= -kBaryEps && u <= 1.0f + kBaryEps &&
                        v >= -kBaryEps && u + v <= 1.0f + kBaryEps &&
                        t >= t_min && t <= t_best;
        if (ok) {
          const int id = __float_as_int(row[9]);
          if (t < tg || (t == tg && id < idg)) {
            tg = t;
            idg = id;
          }
        }
      }
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
}

template <int W>
cudaError_t launch(bool early_exit, dim3 grid, dim3 block, cudaStream_t stream,
                   const float* nodes, const float* tris, const int* meta,
                   const float* origin, const float* direction, const float* t_min,
                   const float* t_max, const bool* active, float* t_out,
                   int* best_out, int n_rays, int leaf_rows) {
  if (early_exit) {
    bvh8t_walk<W, true><<<grid, block, 0, stream>>>(
        nodes, tris, meta, origin, direction, t_min, t_max, active, t_out,
        best_out, n_rays, leaf_rows);
  } else {
    bvh8t_walk<W, false><<<grid, block, 0, stream>>>(
        nodes, tris, meta, origin, direction, t_min, t_max, active, t_out,
        best_out, n_rays, leaf_rows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpu_rt_bvh8t_walk(const float* nodes, const float* tris,
                                 const int* meta, const float* origin,
                                 const float* direction, const float* t_min,
                                 const float* t_max, const bool* active,
                                 float* t_out, int* best_out, int n_rays,
                                 int width, int leaf_rows, int early_exit,
                                 void* stream) {
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
                            n_rays, leaf_rows);
    case 16:
      return (int)launch<16>(ee, grid, block, s, nodes, tris, meta, origin,
                             direction, t_min, t_max, active, t_out, best_out,
                             n_rays, leaf_rows);
    case 32:
      return (int)launch<32>(ee, grid, block, s, nodes, tris, meta, origin,
                             direction, t_min, t_max, active, t_out, best_out,
                             n_rays, leaf_rows);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
