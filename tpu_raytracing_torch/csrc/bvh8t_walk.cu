// bvh8t wide-node walk: closest-hit and any-hit ray queries, a lane per ray,
// persistent warps.
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_t8_kernel (launched by
// _t8_tiles). It answers the same query over the same tree: per ray (t, best),
// (t_max, -1) for misses and inactive lanes. It reads the card layout that
// device/scene_buffers.py::bvh8t_card_layout builds from the JAX tables
// (_bvh8t_layout), which keeps their slot numbering:
//
//   nodes[nid]     = (first child record, n_int, n_leaf, child_base)   int4
//   children[rec]  = (min3, max3, link, rows)                    two float4
//                    the real children of each node in slot order: internal
//                    slots 0..n_int-1 (link = child node child_base + s,
//                    rows = 0), then leaf slots W-n_leaf..W-1 (link = first
//                    triangle row of the group, rows = its row count)
//   tris[row]      = (p0, e1, e2, id bits, 0, 0)               three float4
//                    only rows that hold a triangle, each group contiguous
//
// Hit masks keep the slot meaning of the JAX tables, internal children pop
// in ffs order and hit leaf groups run in ascending slot, so the visit order,
// the in-group tie rule (the lowest id among equal t, whichever lane tests
// the row) and the t <= t_best update are the TPU kernel's, and every
// counter matches the walk over the JAX tables.
//
// What bounds it on the H100: neither bytes nor FLOPs (both bounds are a few
// percent of its time) but the latency of dependent loads and, above all,
// the divergence of the rays of a warp and the tail it leaves: a run of
// neighbouring costly rays (grazing the bunny, each testing many boxes and
// rows) holds its warp, and the launch, open after the others are done. The
// TPU layout cost latency besides: a visit read its child boxes as 96 scalar
// loads 512 bytes apart through L2, and a leaf group all LG rows, padding
// included. What the design does:
// - a node record is one 16-byte load, a child box two, a triangle row
//   three, all through L1 with __ldg, over the group's real rows only. The
//   bunny's node level (116 KB) stays in L1/L2; staging it in shared memory
//   with a bulk asynchronous copy measured no faster (PERF.md);
// - the grid is persistent: SMs x the blocks that fit on one. A warp whose
//   lanes are all idle takes the next 32 fetch positions from a global
//   counter (atomicAdd on a scratch int the launch zeroes), which stand for
//   kChunk consecutive rays from each of 32 / kChunk places spread over the
//   batch (traverse_common.cuh's RayFetch and ray_at, shared with K4 and
//   K6): a run of costly rays (neighbours on the screen) spreads over many
//   warps instead of holding one warp for all of it;
// - the warp walks in lockstep, one node visit a lane a step; when at most
//   kCoop lanes have leaf groups to test, the warp tests each group's rows
//   together, a row a lane, and takes the least (t, id) across the warp;
//   otherwise each lane tests its own groups a row at a time, with the next
//   row's loads issued before the current row's test. So the last costly
//   rays of a launch, alone in their warps, test a group in one row's time;
// - the traversal stack keeps its top entry in registers; the entries below
//   it (at most the scene's t8_stack, 6 on the bunny, checked against
//   kStackCap by the wrapper) stay in local memory, which a visit touches
//   only when it descends from a node with unvisited siblings.
// A BVH walk has no matrix product, so wgmma and the tensor cores have no
// role; nor do TMA tensor maps. chip_smoke.py prints ptxas's registers,
// spills and stack frame of every instantiation.
//
// Numerics: build without fast math and with -fmad=false, so every divide is
// IEEE and t is bit-equal to the plain PyTorch walk's. The slab test and
// Moller-Trumbore are traverse_common.cuh's.

#include "traverse_common.cuh"

namespace {

using tpu_rt::kFull;
using tpu_rt::kStackCap;

constexpr int kThreads = 512;  // threads a block
constexpr int kChunk = 4;  // consecutive rays behind consecutive fetch positions
constexpr int kRefill = 32;  // idle lanes a warp waits for before it fetches
constexpr int kCoop = 4;   // lanes with leaf groups at or below which the warp
                           // tests each group's rows together

template <int W, bool EARLY_EXIT>
__global__ void __launch_bounds__(kThreads, 1)
    bvh8t_walk(const int4* __restrict__ nodes,
               const float4* __restrict__ children,
               const float4* __restrict__ tris, int* __restrict__ next_ray,
               const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ t_min_in,
               const float* __restrict__ t_max_in,
               const bool* __restrict__ active, float* __restrict__ t_out,
               int* __restrict__ best_out, int* __restrict__ counts,
               int n_rays) {
  const int lane = threadIdx.x & 31;
  tpu_rt::RayFetch<kChunk> fetch(n_rays);
  // this lane's ray (-1: idle) and its walk: the stack's top entry (base
  // node, pending slots) in registers, the entries below it in local memory
  int i = -1;
  tpu_rt::Ray ray{};
  float t_best = 0.f;
  int best = -1, visits = 0, boxes = 0, tests = 0;
  uint64_t stack[kStackCap];
  int sp = 0, cur_base = 0;
  uint32_t cur_mask = 0;

  for (;;) {
    // a warp whose lanes are all idle takes the next 32 fetch positions
    if (fetch.open) {
      const int r = fetch.next(next_ray, lane, i < 0, kRefill);
      if (r >= 0) {
        t_best = t_max_in[r];
        best = -1;
        visits = boxes = tests = 0;
        if (active[r]) {
          i = r;
          ray = tpu_rt::load_ray(origin, direction, t_min_in, r);
          sp = 0;
          cur_base = 0;
          cur_mask = 1u;  // the root: node 0 = base 0 + slot 0
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

    // one node visit a live lane: its real children's boxes
    uint32_t lm = 0;
    int leaf_rec = 0;  // child record of leaf slot s: leaf_rec + s
    if (i >= 0) {
      if (cur_mask == 0) {
        const uint64_t e = stack[--sp];
        cur_base = static_cast<int>(e >> 32);
        cur_mask = static_cast<uint32_t>(e);
      }
      const int nid = cur_base + __ffs(cur_mask) - 1;
      cur_mask &= cur_mask - 1;
      const int4 nd = __ldg(nodes + nid);
      const int first = nd.x, n_int = nd.y, n_leaf = nd.z;
      const int n_child = n_int + n_leaf;
      ++visits;
      boxes += n_child;
      uint32_t hit = 0;
#pragma unroll 4
      for (int k = 0; k < n_child; ++k) {
        const float4 a = __ldg(children + 2 * (first + k));
        const float4 b = __ldg(children + 2 * (first + k) + 1);
        const float box[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
        const int s = k < n_int ? k : k + (W - n_child);
        float t0;
        if (tpu_rt::slab_hit(ray, box, t_best, &t0)) hit |= 1u << s;
      }
      const uint32_t int_mask =
          n_int >= 32 ? 0xffffffffu : ((1u << n_int) - 1u);
      const uint32_t imask = hit & int_mask;
      if (imask != 0) {
        if (cur_mask != 0) {
          stack[sp++] =
              (static_cast<uint64_t>(static_cast<uint32_t>(cur_base)) << 32) |
              cur_mask;
        }
        cur_base = nd.w;
        cur_mask = imask;
      }
      lm = hit & ~int_mask;
      leaf_rec = first + n_child - W;
    }

    // the hit leaf groups, in ascending slot
    const uint32_t leafy = __ballot_sync(kFull, lm != 0);
    if (__popc(leafy) <= kCoop) {
      // few lanes have groups to test: the warp tests each group's rows
      // together, a row a lane, and keeps the least (t, id)
      for (uint32_t q = leafy; q != 0; q &= q - 1) {
        const int src = __ffs(q) - 1;
        tpu_rt::Ray rs{};
        rs.ox = __shfl_sync(kFull, ray.ox, src);
        rs.oy = __shfl_sync(kFull, ray.oy, src);
        rs.oz = __shfl_sync(kFull, ray.oz, src);
        rs.dx = __shfl_sync(kFull, ray.dx, src);
        rs.dy = __shfl_sync(kFull, ray.dy, src);
        rs.dz = __shfl_sync(kFull, ray.dz, src);
        rs.t_min = __shfl_sync(kFull, ray.t_min, src);
        float tb = __shfl_sync(kFull, t_best, src);
        int bb = __shfl_sync(kFull, best, src);
        uint32_t m = __shfl_sync(kFull, lm, src);
        const int rec = __shfl_sync(kFull, leaf_rec, src);
        int nt = 0;
        bool stop = false;
        while (m != 0) {
          const int s = __ffs(m) - 1;
          m &= m - 1;
          const float4 lk = __ldg(children + 2 * (rec + s) + 1);
          const int row = __float_as_int(lk.z), nrows = __float_as_int(lk.w);
          nt += nrows;
          float t = INFINITY;
          int id = 0x7fffffff;
          if (lane < nrows) {
            const float4* p = tris + 3 * static_cast<size_t>(row + lane);
            const float4 c0 = __ldg(p), c1 = __ldg(p + 1), c2 = __ldg(p + 2);
            float th;
            if (tpu_rt::tri_hit(rs, c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z,
                                c1.w, c2.x, tb, &th)) {
              t = th;
              id = __float_as_int(c2.y);
            }
          }
          tpu_rt::warp_min(&t, &id);
          if (t < INFINITY) {
            tb = t;
            bb = id;
            if (EARLY_EXIT) {
              stop = true;
              break;
            }
          }
        }
        if (lane == src) {
          t_best = tb;
          best = bb;
          tests += nt;
          if (stop) {
            cur_mask = 0;
            sp = 0;
          }
        }
      }
    } else {
      // each lane its own groups, a row at a time, the next row's loads
      // issued before the current row's test
      while (lm != 0) {
        const int s = __ffs(lm) - 1;
        lm &= lm - 1;
        const float4 lk = __ldg(children + 2 * (leaf_rec + s) + 1);
        const int nrows = __float_as_int(lk.w);
        const float4* row =
            tris + 3 * static_cast<size_t>(__float_as_int(lk.z));
        float tg = INFINITY;
        int idg = 0x7fffffff;
        float4 c0 = make_float4(0.f, 0.f, 0.f, 0.f), c1 = c0, c2 = c0;
        if (nrows > 0) {
          c0 = __ldg(row);
          c1 = __ldg(row + 1);
          c2 = __ldg(row + 2);
        }
        for (int r = 0; r < nrows; ++r) {
          float4 n0 = c0, n1 = c1, n2 = c2;
          if (r + 1 < nrows) {
            n0 = __ldg(row + 3 * (r + 1));
            n1 = __ldg(row + 3 * (r + 1) + 1);
            n2 = __ldg(row + 3 * (r + 1) + 2);
          }
          float t;
          if (tpu_rt::tri_hit(ray, c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z,
                              c1.w, c2.x, t_best, &t)) {
            const int id = __float_as_int(c2.y);
            if (t < tg || (t == tg && id < idg)) {
              tg = t;
              idg = id;
            }
          }
          c0 = n0;
          c1 = n1;
          c2 = n2;
        }
        tests += nrows;
        if (tg < INFINITY) {
          t_best = tg;
          best = idg;
          if (EARLY_EXIT) {
            cur_mask = 0;
            sp = 0;
            break;
          }
        }
      }
    }

    // a finished walk writes its answer and frees its lane
    if (i >= 0 && cur_mask == 0 && sp == 0) {
      t_out[i] = t_best;
      best_out[i] = best;
      tpu_rt::store_counts(counts, i, visits, boxes, tests);
      i = -1;
    }
  }
}

struct Args {
  const int4* nodes;
  const float4* children;
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
  int n_rays;
};

// The persistent launch of one instantiation.
template <int W, bool EARLY_EXIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static tpu_rt::GridCache cache;
  return tpu_rt::persistent_launch(
      bvh8t_walk<W, EARLY_EXIT>, kThreads, a.n_rays, &cache, a.next_ray,
      stream, a.nodes, a.children, a.tris, a.next_ray, a.origin, a.direction,
      a.t_min, a.t_max, a.active, a.t_out, a.best_out, a.counts, a.n_rays);
}

template <int W>
cudaError_t launch_width(bool early_exit, const Args& a, cudaStream_t s) {
  return early_exit ? launch<W, true>(a, s) : launch<W, false>(a, s);
}

}  // namespace

extern "C" int tpu_rt_bvh8t_walk(const int* nodes, const float* children,
                                 const float* tris, int* next_ray,
                                 const float* origin, const float* direction,
                                 const float* t_min, const float* t_max,
                                 const bool* active, float* t_out,
                                 int* best_out, int* counts, int n_rays,
                                 int width, int early_exit, void* stream) {
  if (n_rays <= 0) return 0;
  const Args a{reinterpret_cast<const int4*>(nodes),
               reinterpret_cast<const float4*>(children),
               reinterpret_cast<const float4*>(tris),
               next_ray, origin, direction, t_min, t_max, active, t_out,
               best_out, counts, n_rays};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ee = early_exit != 0;
  switch (width) {
    case 8:
      return (int)launch_width<8>(ee, a, s);
    case 16:
      return (int)launch_width<16>(ee, a, s);
    case 32:
      return (int)launch_width<32>(ee, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
