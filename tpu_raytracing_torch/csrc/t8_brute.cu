// Treeless brute-force triangle query: every ray tests every bvh8t group.
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_t8_brute_kernel
// (launched by _t8_brute_tiles), which the JAX package selects for the
// bvh8t kind when the scene has at most TPU_RT_BRUTE_GROUPS triangle
// groups. It reads the bvh8t triangle blocks as the walk does
// (bvh8t_walk.cu):
//
//   block b, row r < LG:  tris[(b * LG + r) * 128 + j * 10 + k], group 12 b + j,
//                         k 0-2 p0, 3-5 e1, 6-8 e2, 9 triangle id as int32 bits;
//                         padding rows and groups are zero and fail den != 0
//
// The TPU kernel looped over all groups for a tile of rays in the vector
// unit. Here a block of 128 threads (one ray each) stages one triangle block
// (12 groups x LG rows, 8 KB at LG = 16) in shared memory with coalesced
// loads, and every thread tests all of it; the reads are broadcasts. That is
// the natural first design for a dense rays x triangles loop.
//
// Tie rules are the TPU kernel's (traverse_pallas.py:1551-1568): inside a
// group the least t wins and equal t goes to the lowest id; across groups a
// group whose minimum passes t <= t_best replaces the winner, so the later
// group wins an equal t. There is no early exit: any-hit calls get the
// closest hit, as in JAX.
//
// What bounds it on the H100: arithmetic. Every ray does NG x LG
// Moller-Trumbore tests (40,896 on the bunny, of which 28,586 are on real
// triangles and the rest on the zero rows that pad the groups), each with
// three IEEE divides, so it is bound by fp32 issue, not by memory; the
// staged tiles come from L2.
// A later version would test several rays per thread against register-held
// triangles, or drop to the walk, which prunes all but a few groups.

#include "traverse_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kGroupsPerBlock = 12;

__global__ void t8_brute(const float* __restrict__ tris,
                         const float* __restrict__ origin,
                         const float* __restrict__ direction,
                         const float* __restrict__ t_min_in,
                         const float* __restrict__ t_max_in,
                         const bool* __restrict__ active,
                         float* __restrict__ t_out, int* __restrict__ best_out,
                         int* __restrict__ counts, int n_rays,
                         int n_tri_blocks, int leaf_rows) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  const bool live = in_range && active[i];
  float t_best = in_range ? t_max_in[i] : 0.0f;
  int best = -1;
  int groups = 0, tests = 0;  // the counters: groups and rows that hold data
  tpu_rt::Ray ray{};
  if (live) ray = tpu_rt::load_ray(origin, direction, t_min_in, i);

  const int tile_f4 = leaf_rows * tpu_rt::kRow / 4;
  for (int b = 0; b < n_tri_blocks; ++b) {
    __syncthreads();  // every thread is done with the previous tile
    const float4* src =
        reinterpret_cast<const float4*>(tris) + (size_t)b * tile_f4;
    for (int k = threadIdx.x; k < tile_f4; k += blockDim.x) tile4[k] = src[k];
    __syncthreads();
    if (!live) continue;
    if (counts != nullptr) {
      for (int j = 0; j < kGroupsPerBlock; ++j) {
        const int used = tpu_rt::t8_used_rows(tile + j * 10, leaf_rows);
        groups += used > 0;
        tests += used;
      }
    }
    for (int j = 0; j < kGroupsPerBlock; ++j) {
      float tg = INFINITY;
      int idg = 0x7fffffff;
      for (int r = 0; r < leaf_rows; ++r) {
        const float* row = tile + r * tpu_rt::kRow + j * 10;
        float t;
        if (tpu_rt::tri_hit(ray, row[0], row[1], row[2], row[3], row[4],
                            row[5], row[6], row[7], row[8], t_best, &t)) {
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
      }
    }
  }
  if (!in_range) return;
  t_out[i] = t_best;
  best_out[i] = best;
  tpu_rt::store_counts(counts, i, groups, 0, tests);
}

}  // namespace

extern "C" int tpu_rt_t8_brute(const float* tris, const float* origin,
                               const float* direction, const float* t_min,
                               const float* t_max, const bool* active,
                               float* t_out, int* best_out, int* counts,
                               int n_rays, int n_tri_blocks, int leaf_rows,
                               void* stream) {
  if (n_rays <= 0) return 0;
  if (leaf_rows <= 0 || leaf_rows > 32 || n_tri_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)leaf_rows * tpu_rt::kRow * sizeof(float);
  const dim3 grid((n_rays + kBlock - 1) / kBlock);
  t8_brute<<<grid, dim3(kBlock), smem, static_cast<cudaStream_t>(stream)>>>(
      tris, origin, direction, t_min, t_max, active, t_out, best_out, counts,
      n_rays, n_tri_blocks, leaf_rows);
  return (int)cudaGetLastError();
}
