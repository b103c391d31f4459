// BVH4 walk over quad records: closest-hit and any-hit, a lane per ray,
// persistent warps, for the `quad` and `quadrow` layouts (template ROWREC).
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
// near to far: of the hit internal children the nearest becomes the next
// node while the others are pushed far to near, and the hit leaves are
// tested in that order after the push or pop (the hit mask is taken before
// any of them is tested, so this is the order and the t_best updates of
// intersecting them inside the visit). Any-hit uses storage order and stops
// after the visit that found a hit.
//
// The TPU kernel walked a tile in lockstep with one scalar stack and ordered
// slots by a tile-majority vote of direction signs on the record's split
// axes. Here every lane keeps its own stack and orders by its own direction
// signs on the same axes, as the plain version
// (ops/traverse_kernels.py::intersect_tris_quad_plain) does, so t and the
// winner are bit-equal to it. The TPU_RT_KERNEL_PROBE cost copies and the
// TPU_RT_TILE_K tile width only measured the TPU and are left out.
//
// What bounds it on the H100: neither bytes nor FLOPs (both bounds are a
// few percent of its time) but the latency of the dependent 128-byte record
// loads, the divergence of the rays of a warp, and the tail that the
// costliest rays leave. What the design does:
// - the grid is persistent (traverse_common.cuh's RayFetch): a warp takes
//   new rays for its idle lanes once kRefill of them are idle, kChunk
//   consecutive rays from each of 32 / kChunk places spread over the batch;
// - a record is eight 16-byte __ldg loads (stride 128 B, or 512 B in
//   bvh4_rows), a leaf record three (tri_pack_pk or a tri_rows slot), and
//   the slab test's NaN-propagating min / max one instruction each
//   (traverse_common.cuh::slab_hit<true>);
// - the stack's top entry stays in a register, the entries below it (at
//   most the scene's bvh4_stack, checked against kStackCap by the wrapper)
//   in local memory;
// - the leaves run after the visit's box work, so a warp does not split
//   between boxes and triangles inside a visit, and when at most kCoop lanes
//   have leaves the warp tests them across its lanes
//   (traverse_common.cuh::test_leaves): the last costly rays of a launch,
//   alone in their warps, test a leaf in one record's time.
// Numerics: -fmad=false and IEEE divides, the slab test and Moller-Trumbore
// of traverse_common.cuh.

#include "traverse_common.cuh"

namespace {

using tpu_rt::kFull;

constexpr int kThreads = 256;  // threads a block
constexpr int kChunk = 4;      // consecutive rays behind consecutive positions
constexpr int kDone = -1;

__device__ __forceinline__ bool negative(const tpu_rt::Ray& r, int axis) {
  return (axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz)) < 0.0f;
}

// v[s] for a runtime s < 4, by selects: an indexed register array would go
// to local memory
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[4], int s) {
  return s == 0 ? v[0] : (s == 1 ? v[1] : (s == 2 ? v[2] : v[3]));
}

template <bool ROWREC, bool EARLY_EXIT>
__global__ void __launch_bounds__(kThreads, 2)
    quad_walk(const float4* __restrict__ recs, const float4* __restrict__ tris,
              int* __restrict__ next_ray, const float* __restrict__ origin,
              const float* __restrict__ direction,
              const float* __restrict__ t_min_in,
              const float* __restrict__ t_max_in,
              const bool* __restrict__ active, float* __restrict__ t_out,
              int* __restrict__ best_out, int* __restrict__ counts, int n_rays,
              int root_meta, int n_tris) {
  constexpr int kStride = ROWREC ? tpu_rt::kRow / 4 : 8;  // float4 a record
  // idle lanes a warp waits for before it fetches: any-hit measured
  // slower refilling at 16 (PERF.md)
  constexpr int kRefill = EARLY_EXIT ? 32 : 16;
  const int lane = threadIdx.x & 31;
  tpu_rt::RayFetch<kChunk> fetch(n_rays);
  // this lane's ray (-1: idle) and its walk: the next node's meta (the root
  // may be a leaf), the stack's top entry and the entries below it
  int i = -1;
  tpu_rt::Ray ray{};
  float t_best = 0.f;
  int best = -1, visits = 0, boxes = 0, tests = 0;
  int cur = kDone, top = 0, sp = 0;
  int stack[tpu_rt::kStackCap];

  for (;;) {
    if (fetch.open) {
      const int r = fetch.next(next_ray, lane, i < 0, kRefill);
      if (r >= 0) {
        t_best = t_max_in[r];
        best = -1;
        visits = boxes = tests = 0;
        if (active[r] && root_meta >= 0) {
          i = r;
          ray = tpu_rt::load_ray(origin, direction, t_min_in, r);
          cur = root_meta;
          sp = 0;
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

    tpu_rt::Pending<4> leaves{};
    if (i >= 0 && (cur & 7)) {  // a single-leaf tree: the walk is that leaf
      tpu_rt::append(&leaves, cur);
      cur = kDone;
    } else if (i >= 0) {
      const float4* rec = recs + static_cast<size_t>(cur >> 3) * kStride;
      float f[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = __ldg(rec + q);
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
      const int axes = __float_as_int(f[28]);
      const int nkids = (axes >> 6) & 7;
      const int nleft = (axes >> 9) & 3;
      int metas[4];
      bool hits[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        metas[j] = __float_as_int(f[24 + j]);
        float t0;
        hits[j] = j < nkids &&
                  tpu_rt::slab_hit<true>(ray, f + 6 * j, t_best, &t0);
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

      // near to far: hit leaves and hit internal children, each in order
      tpu_rt::Pending<4> go{};
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int s = order[o];
        if (s < 0 || !pick(hits, s)) continue;
        const int m = pick(metas, s);
        if (m == kDone) continue;
        if (m & 7) {
          tpu_rt::append(&leaves, m);
        } else {
          tpu_rt::append(&go, m);
        }
      }
      // descend into the nearest, push the others far to near; or pop
#pragma unroll
      for (int k = 3; k >= 1; --k) {
        if (k < go.n) {
          if (sp > 0) stack[sp - 1] = top;
          top = go.meta[k];
          ++sp;
        }
      }
      if (go.n > 0) {
        cur = go.meta[0];
      } else if (sp > 0) {
        cur = top;
        if (--sp > 0) top = stack[sp - 1];
      } else {
        cur = kDone;
      }
    }

    tpu_rt::test_leaves<ROWREC, 4>(ray, tris, leaves, n_tris, &t_best, &best,
                                   &tests);

    // a finished walk writes its answer and frees its lane
    if (i >= 0 && (cur == kDone || (EARLY_EXIT && best >= 0))) {
      t_out[i] = t_best;
      best_out[i] = best;
      tpu_rt::store_counts(counts, i, visits, boxes, tests);
      i = -1;
    }
  }
}

struct Args {
  const float4* recs;
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
template <bool ROWREC, bool EARLY_EXIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static tpu_rt::GridCache cache;
  return tpu_rt::persistent_launch(
      quad_walk<ROWREC, EARLY_EXIT>, kThreads, a.n_rays, &cache, a.next_ray,
      stream, a.recs, a.tris, a.next_ray, a.origin, a.direction, a.t_min,
      a.t_max, a.active, a.t_out, a.best_out, a.counts, a.n_rays,
      a.root_meta, a.n_tris);
}

template <bool ROWREC>
cudaError_t launch_mode(bool early_exit, const Args& a, cudaStream_t s) {
  return early_exit ? launch<ROWREC, true>(a, s) : launch<ROWREC, false>(a, s);
}

}  // namespace

extern "C" int tpu_rt_quad_walk(const float* recs, const float* tris,
                                int* next_ray, const float* origin,
                                const float* direction, const float* t_min,
                                const float* t_max, const bool* active,
                                float* t_out, int* best_out, int* counts,
                                int n_rays, int root_meta, int n_tris,
                                int rowrec, int early_exit, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0) return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const float4*>(recs),
               reinterpret_cast<const float4*>(tris),
               next_ray, origin, direction, t_min, t_max, active, t_out,
               best_out, counts, n_rays, root_meta, n_tris};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ee = early_exit != 0;
  return (int)(rowrec ? launch_mode<true>(ee, a, s)
                      : launch_mode<false>(ee, a, s));
}
