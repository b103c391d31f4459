// Stackless skip-link walk: closest-hit and any-hit, a lane per ray,
// persistent warps.
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
// every lane follows its own pointer, as the plain version
// (ops/traverse_kernels.py::intersect_tris_skiplink_plain) does, in the same
// preorder and with the same arithmetic, so t and the winner are bit-equal
// to it. Box containment makes the lane's hit set, and so its winner, the
// same as the TPU's.
//
// What bounds it on the H100: the chain of dependent node loads (16.8
// visits a live camera ray on the bunny, 26.7 a shadow ray, one after the
// other: no near-first order tightens t_best early), the load traffic of
// those visits, and the tail that the costliest rays leave; both bounds,
// bytes and FLOPs, are a few percent of its time. What the design does:
// - the next node's record is loaded as soon as the slab test has chosen
//   it, n + 1 or skip[n], before the current node's leaf is tested, so the
//   leaf's work hides that load's latency. Loading both candidates before
//   the slab test, to select one after it, measured slower on the H100
//   (twice the load traffic for one latency; PERF.md), and is not done;
// - a node is two 16-byte __ldg loads, a triangle record three, and the
//   slab test's NaN-propagating min / max one instruction each
//   (traverse_common.cuh::slab_hit<true>);
// - the grid is persistent (traverse_common.cuh's RayFetch): kChunk
//   consecutive rays from each of 32 / kChunk places spread over the batch
//   (4 measured faster than 32 consecutive rays a warp, PERF.md: a run of
//   costly neighbouring rays spreads over many warps), and a warp refills
//   its idle lanes once kRefill of them are idle;
// - a lane's hit leaf is tested after the visit, across the warp when at
//   most kCoop lanes have one (traverse_common.cuh::test_leaves).
// No stack: nothing in local memory. Numerics: -fmad=false and IEEE
// divides, the slab test and Moller-Trumbore of traverse_common.cuh.

#include "traverse_common.cuh"

namespace {

using tpu_rt::kFull;

constexpr int kThreads = 256;  // threads a block
constexpr int kChunk = 4;      // consecutive rays behind consecutive positions
constexpr int kRefill = 16;    // idle lanes a warp waits for before it fetches

template <bool EARLY_EXIT>
__global__ void __launch_bounds__(kThreads, 2)
    skip_walk(const float4* __restrict__ nodes,
              const float4* __restrict__ tris, int* __restrict__ next_ray,
              const float* __restrict__ origin,
              const float* __restrict__ direction,
              const float* __restrict__ t_min_in,
              const float* __restrict__ t_max_in,
              const bool* __restrict__ active, float* __restrict__ t_out,
              int* __restrict__ best_out, int* __restrict__ counts, int n_rays,
              int sentinel, int n_tris) {
  const int lane = threadIdx.x & 31;
  const int last = sentinel - 1;  // the load past the end reads this
  tpu_rt::RayFetch<kChunk> fetch(n_rays);
  // this lane's ray (-1: idle), its node and that node's record
  int i = -1;
  tpu_rt::Ray ray{};
  float t_best = 0.f;
  int best = -1, visits = 0, tests = 0, node = 0;
  float4 na = make_float4(0.f, 0.f, 0.f, 0.f), nb = na;

  for (;;) {
    if (fetch.open) {
      const int r = fetch.next(next_ray, lane, i < 0, kRefill);
      if (r >= 0) {
        t_best = t_max_in[r];
        best = -1;
        visits = tests = 0;
        if (active[r]) {
          i = r;
          ray = tpu_rt::load_ray(origin, direction, t_min_in, r);
          node = 0;
          na = __ldg(nodes);
          nb = __ldg(nodes + 1);
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

    tpu_rt::Pending<1> leaf{};
    if (i >= 0) {
      const int skip = __float_as_int(nb.w);
      const float4* down_rec = nodes + 2 * min(node + 1, last);
      const float4* skip_rec = nodes + 2 * min(skip, last);
      ++visits;
      const float box[6] = {na.x, na.y, na.z, na.w, nb.x, nb.y};
      float t0;
      const bool hit = tpu_rt::slab_hit<true>(ray, box, t_best, &t0);
      const int meta = __float_as_int(nb.z);
      if (hit && (meta & 7)) tpu_rt::append(&leaf, meta);
      // the chosen successor's record goes out now, before the leaf test
      const bool down = hit && (meta & 7) == 0;
      node = down ? node + 1 : skip;
      const float4* next = down ? down_rec : skip_rec;
      na = __ldg(next);
      nb = __ldg(next + 1);
    }

    tpu_rt::test_leaves<false, 1>(ray, tris, leaf, n_tris, &t_best, &best,
                                  &tests);

    // a finished walk writes its answer and frees its lane
    if (i >= 0 && (node >= sentinel || (EARLY_EXIT && best >= 0))) {
      t_out[i] = t_best;
      best_out[i] = best;
      tpu_rt::store_counts(counts, i, visits, visits, tests);
      i = -1;
    }
  }
}

struct Args {
  const float4* nodes;
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
  int n_rays, sentinel, n_tris;
};

// The persistent launch of one instantiation.
template <bool EARLY_EXIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static tpu_rt::GridCache cache;
  return tpu_rt::persistent_launch(
      skip_walk<EARLY_EXIT>, kThreads, a.n_rays, &cache, a.next_ray, stream,
      a.nodes, a.tris, a.next_ray, a.origin, a.direction, a.t_min, a.t_max,
      a.active, a.t_out, a.best_out, a.counts, a.n_rays, a.sentinel,
      a.n_tris);
}

}  // namespace

extern "C" int tpu_rt_skip_walk(const float* nodes, const float* tris,
                                int* next_ray, const float* origin,
                                const float* direction, const float* t_min,
                                const float* t_max, const bool* active,
                                float* t_out, int* best_out, int* counts,
                                int n_rays, int sentinel, int n_tris,
                                int early_exit, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0 || sentinel <= 0) return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const float4*>(nodes),
               reinterpret_cast<const float4*>(tris),
               next_ray, origin, direction, t_min, t_max, active, t_out,
               best_out, counts, n_rays, sentinel, n_tris};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(early_exit ? launch<true>(a, s) : launch<false>(a, s));
}
