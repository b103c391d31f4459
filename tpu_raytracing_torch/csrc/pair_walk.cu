// Child-pair BVH2 walk: closest-hit and any-hit, a lane per ray, persistent
// warps.
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_pair_kernel (launched by
// _pair_tiles), which the JAX package runs for TPU_RT_PALLAS_KERNEL=pair. It
// walks the JAX package's child-pair rows (scene_buffers.py::
// _child_pair_layout, packed 8 to a row as bvh2_rows_pk) and packed
// triangles:
//
//   row m:       rows[m * 16 + k], k 0-5 left box, 6-11 right box,
//                12 bits(meta_l), 13 bits(meta_r), 14 bits(split axis),
//                15 unused
//   meta:        leaf (first << 3) | count (count > 0), internal row << 3
//   triangle t:  tris[t * 16 + k], k 0-2 p0, 3-5 p1, 6-8 p2
//
// A visit tests both child boxes against the t_best it opens with. Hit leaf
// children are intersected left, then right (the right one against the
// t_best the left one leaves); when both internal children hit, the far one
// is pushed and the near one visited, where near is the left child unless
// the ray's direction is negative on the row's split axis; with no internal
// hit the walk pops. Any-hit stops after the visit that found a hit.
//
// The TPU kernel walked a tile in lockstep with one scalar stack and ordered
// children by a tile-majority vote of direction signs. Here every lane keeps
// its own stack and orders by its own sign, as the plain version
// (ops/traverse_kernels.py::intersect_tris_pair_plain) does, so t, the
// winner and the counters are bit-equal to it.
//
// What bounds it on the H100: neither bytes nor FLOPs (both bounds are a
// few percent of its time) but the chain of dependent 64-byte row loads
// (7.3 visits a live camera ray on the bunny, 12.4 a shadow ray), the
// divergence of the rays of a warp, and the tail that the costliest rays
// leave. What the design does, as quad_walk.cu does:
// - the grid is persistent (traverse_common.cuh's RayFetch): a warp takes
//   new rays for its idle lanes once kRefill of them are idle, kChunk
//   consecutive rays from each of 32 / kChunk places spread over the batch;
// - the next row's loads go out as soon as the visit has chosen it (the
//   near child or the popped entry), before the visit's leaves are tested:
//   the choice does not depend on them, and their work hides the loads'
//   latency. Only the chosen row is loaded (loading both candidates
//   measured slower on K6, PERF.md);
// - the slab test's NaN-propagating min / max are one instruction each
//   (traverse_common.cuh::slab_hit<true>);
// - the stack's top entry stays in a register, the entries below it (at
//   most bvh2_depth, checked against kStackCap by the wrapper) in local
//   memory;
// - the leaves run after the visit's box work, across the warp when at
//   most kCoop lanes have one (traverse_common.cuh::test_leaves).
// A row is read as the 15 words a visit uses, 4-byte loads: with the loads
// issued early, four 16-byte loads (as K4 and K6 read) measured slower.
// Numerics: -fmad=false and IEEE divides, the slab test and Moller-Trumbore
// of traverse_common.cuh.

#include "traverse_common.cuh"

namespace {

using tpu_rt::kFull;

constexpr int kThreads = 256;  // threads a block
constexpr int kChunk = 4;      // consecutive rays behind consecutive positions
constexpr int kRefill = 16;    // idle lanes a warp waits for before it fetches
constexpr int kDone = -1;

__device__ __forceinline__ float axis_dir(const tpu_rt::Ray& r, int axis) {
  return axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
}

// Words 0-14 of row m: boxes in a, b, c; metas and axis in d (d.w, the
// unused word 15, is not read).
struct Row {
  float4 a, b, c, d;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ rows,
                                        int m) {
  const float* f = rows + static_cast<size_t>(m) * 16;
  return Row{make_float4(f[0], f[1], f[2], f[3]),
             make_float4(f[4], f[5], f[6], f[7]),
             make_float4(f[8], f[9], f[10], f[11]),
             make_float4(f[12], f[13], f[14], 0.f)};
}

template <bool EARLY_EXIT>
__global__ void __launch_bounds__(kThreads, 2)
    pair_walk(const float* __restrict__ rows, const float4* __restrict__ tris,
              int* __restrict__ next_ray, const float* __restrict__ origin,
              const float* __restrict__ direction,
              const float* __restrict__ t_min_in,
              const float* __restrict__ t_max_in,
              const bool* __restrict__ active, float* __restrict__ t_out,
              int* __restrict__ best_out, int* __restrict__ counts, int n_rays,
              int root_meta, int n_tris) {
  const int lane = threadIdx.x & 31;
  tpu_rt::RayFetch<kChunk> fetch(n_rays);
  // this lane's ray (-1: idle) and its walk: the next node's meta (the root
  // may be a leaf) and its row, the stack's top entry and those below it
  int i = -1;
  tpu_rt::Ray ray{};
  float t_best = 0.f;
  int best = -1, visits = 0, tests = 0;
  int cur = kDone, top = 0, sp = 0;
  int stack[tpu_rt::kStackCap];
  Row row{};

  for (;;) {
    if (fetch.open) {
      const int r = fetch.next(next_ray, lane, i < 0, kRefill);
      if (r >= 0) {
        t_best = t_max_in[r];
        best = -1;
        visits = tests = 0;
        if (active[r] && root_meta >= 0) {
          i = r;
          ray = tpu_rt::load_ray(origin, direction, t_min_in, r);
          cur = root_meta;
          sp = 0;
          if ((cur & 7) == 0) row = load_row(rows, cur >> 3);
        } else {
          t_out[r] = t_best;
          best_out[r] = best;
          tpu_rt::store_counts(counts, r, 0, 0, 0);
        }
      }
    }
    if (__ballot_sync(kFull, i >= 0) == 0) {
      if (fetch.open) continue;
      break;
    }

    tpu_rt::Pending<2> leaves{};
    if (i >= 0 && (cur & 7)) {  // a single-leaf tree: the walk is that leaf
      tpu_rt::append(&leaves, cur);
      cur = kDone;
    } else if (i >= 0) {
      ++visits;
      const float box_l[6] = {row.a.x, row.a.y, row.a.z,
                              row.a.w, row.b.x, row.b.y};
      const float box_r[6] = {row.b.z, row.b.w, row.c.x,
                              row.c.y, row.c.z, row.c.w};
      float t0;
      const bool hit_l = tpu_rt::slab_hit<true>(ray, box_l, t_best, &t0);
      const bool hit_r = tpu_rt::slab_hit<true>(ray, box_r, t_best, &t0);
      const int meta_l = __float_as_int(row.d.x);
      const int meta_r = __float_as_int(row.d.y);
      const int axis = __float_as_int(row.d.z);
      const bool leaf_l = (meta_l & 7) != 0;
      const bool leaf_r = (meta_r & 7) != 0;
      if (hit_l && leaf_l) tpu_rt::append(&leaves, meta_l);
      if (hit_r && leaf_r) tpu_rt::append(&leaves, meta_r);
      // descend into the near internal hit and push the far one; or pop
      const bool go_l = hit_l && !leaf_l;
      const bool go_r = hit_r && !leaf_r;
      if (go_l && go_r) {
        const bool l_near = !(axis_dir(ray, axis) < 0.0f);
        if (sp > 0) stack[sp - 1] = top;
        top = l_near ? meta_r : meta_l;
        ++sp;
        cur = l_near ? meta_l : meta_r;
      } else if (go_l || go_r) {
        cur = go_l ? meta_l : meta_r;
      } else if (sp > 0) {
        cur = top;
        if (--sp > 0) top = stack[sp - 1];
      } else {
        cur = kDone;
      }
      // the next row goes out now, before the leaf test
      if (cur != kDone) row = load_row(rows, cur >> 3);
    }

    tpu_rt::test_leaves<false, 2>(ray, tris, leaves, n_tris, &t_best, &best,
                                  &tests);

    // a finished walk writes its answer and frees its lane
    if (i >= 0 && (cur == kDone || (EARLY_EXIT && best >= 0))) {
      t_out[i] = t_best;
      best_out[i] = best;
      tpu_rt::store_counts(counts, i, visits, 2 * visits, tests);
      i = -1;
    }
  }
}

struct Args {
  const float* rows;
  const float4* tris;
  int* next_ray;
  const float* origin;
  const float* direction;
  const float* t_min;
  const float* t_max;
  const bool* active;
  float* t_out;
  int* best_out;
  int* counts;
  int n_rays, root_meta, n_tris;
};

// The persistent launch of one instantiation.
template <bool EARLY_EXIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static tpu_rt::GridCache cache;
  return tpu_rt::persistent_launch(
      pair_walk<EARLY_EXIT>, kThreads, a.n_rays, &cache, a.next_ray, stream,
      a.rows, a.tris, a.next_ray, a.origin, a.direction, a.t_min, a.t_max,
      a.active, a.t_out, a.best_out, a.counts, a.n_rays, a.root_meta,
      a.n_tris);
}

}  // namespace

extern "C" int tpu_rt_pair_walk(const float* rows, const float* tris,
                                int* next_ray, const float* origin,
                                const float* direction, const float* t_min,
                                const float* t_max, const bool* active,
                                float* t_out, int* best_out, int* counts,
                                int n_rays, int root_meta, int n_tris,
                                int early_exit, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0) return (int)cudaErrorInvalidValue;
  const Args a{rows, reinterpret_cast<const float4*>(tris),
               next_ray, origin, direction, t_min, t_max, active, t_out,
               best_out, counts, n_rays, root_meta, n_tris};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(early_exit ? launch<true>(a, s) : launch<false>(a, s));
}
