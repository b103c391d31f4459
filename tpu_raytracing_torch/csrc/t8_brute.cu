// Treeless brute-force triangle query: every ray tests every bvh8t triangle.
//
// Replaces tpu_raytracing/ops/traverse_pallas.py::_t8_brute_kernel
// (launched by _t8_brute_tiles), which the JAX package selects for the
// bvh8t kind when the scene has at most TPU_RT_BRUTE_GROUPS triangle
// groups. The TPU kernel looped over every group of the bvh8t triangle
// blocks, padding rows included, for a tile of rays in the vector unit.
//
// It reads the bvh8t walk's card layout (DeviceScene.t8_card, built by
// device/scene_buffers.py from the same JAX tables):
//
//   tris[row]   = (p0, e1, e2, id bits, 0, 0)  48 B, only the rows that
//                 hold a triangle, group by group in group order
//   groups[row] = the row's bvh8t group; -1 pads it to a multiple of 4
//
// The zero rows that pad a group (30% of the bunny's 40,896, 95% of a
// Cornell scene's block) have den == 0 for every ray, so leaving them out
// changes no result.
//
// What bounds it on the H100: fp32 issue. Every ray tests every row
// (28,586 on the bunny), a test is 36 multiplies and adds before any
// divide, and with -fmad=false (t bit-equal to the plain version) none of
// them fuse. The design:
//
// - Several rays a thread. A block of 128 threads takes 128 s lanes,
//   strided over the batch (block b: lanes b, b + grid, b + 2 grid, ...,
//   so that every block holds about the batch's share of live lanes),
//   compacts its active ones with ballots and hands each thread up to s of
//   them, held in registers. s (1-4) is the one whose grid the SMs finish
//   first: 3 for a 250,000-ray batch. Every row read from shared memory
//   (three broadcast loads) is tested against all of a thread's rays: a
//   third of the loads a test, and three independent chains in flight.
//   Inactive lanes cost nothing past the compaction.
// - A ring of tiles. The rows stream through up to kStages = 3 tiles of
//   kTileRows = 128 rows (6.5 KB with their groups) in shared memory.
//   Thread 0 fills a tile with two cp.async.bulk copies (TMA) that
//   complete on the tile's mbarrier, and refills it after the barrier that
//   ends its use, so the next two tiles arrive while the block tests this
//   one. A table of one tile gets one stage of its own size (a Cornell
//   scene: 12 rows, 624 B).
// - An exact prefilter. tpu_rt::surely_misses() (traverse_common.cuh,
//   shared with the probes P3 and P1) rejects, from den and the
//   numerators of u and v alone (8 operations), every row whose triangle
//   the ray's line passes outside of by more than about 2^-16 of |den|.
//   Only the others, the few rows a ray's line pierces, take the three
//   IEEE divides of the full test, which is tri_hit itself.
//
// Ties are the TPU kernel's (traverse_pallas.py:1551-1568): inside a group
// the least t wins and equal t goes to the lowest id; every row of a group
// is tested against the t_best from before the group, and a later group
// wins an equal t. That rule picks, among the rows that pass the full test
// against t_max with t < inf, the least (t, -group, id): a group replaces
// the winner iff its least t is at most every earlier group's, so the
// last group that holds the least t keeps it, with its lowest id there. A
// thread therefore keeps (t, group, id) per ray and tests each row against
// its running t: the same winner and t bits in any row order. There is no
// early exit: any-hit calls get the closest hit, as in JAX.

#include "traverse_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;              // rays a thread, at most (s)
constexpr int kTileRows = 128;         // rows a ring stage holds
constexpr int kStages = 3;
constexpr int kRowWords = 12;          // p0 e1 e2, id, 0, 0
constexpr int kRowBytes = kRowWords * 4;
constexpr int kStageRowBytes = kRowBytes + 4;  // and the row's group

struct Args {
  const float* tris;
  const int* groups;
  const float* origin;
  const float* direction;
  const float* t_min;
  const float* t_max;
  float* t_out;
  int* best_out;
  int* counts;
  int n_records;
  int tile_rows;  // a multiple of 4, so each stage's groups stay aligned
  int n_tiles;
  int n_stages;   // min(kStages, n_tiles)
};

// A ray a thread holds, with its winner so far.
struct Lane {
  tpu_rt::Ray ray;
  float t;    // the least t so far (t_max at first)
  int id;     // its triangle, -1 while there is none
  int group;  // its group, -1 while there is none
};

// Thread 0: copy tile `tile` of the table (its rows and their groups) into
// the stage at `dst`; the copies complete on `bar`. Both sources and
// destinations are 16-byte aligned and every size is a multiple of 16.
__device__ __forceinline__ void fill(const Args& a, unsigned char* dst,
                                     int tile, uint64_t* bar) {
  const int first = tile * a.tile_rows;
  const int rows = min(a.tile_rows, a.n_records - first);
  const uint32_t row_bytes = rows * kRowBytes;
  const uint32_t group_bytes = ((rows + 3) & ~3) * 4;
  tpu_rt::expect_bytes(bar, row_bytes + group_bytes);
  tpu_rt::bulk_load(dst, a.tris + static_cast<size_t>(first) * kRowWords,
                    row_bytes, bar);
  tpu_rt::bulk_load(dst + a.tile_rows * kRowBytes, a.groups + first,
                    group_bytes, bar);
}

// The ray of lane i, or for i < 0 a slot with no ray: o = d = 0, so
// den == nu == 0 and every row surely misses it (rule R3 below).
__device__ __forceinline__ Lane load_lane(const Args& a, int i) {
  Lane l{};
  l.id = -1;
  l.group = -1;
  if (i >= 0) {
    l.ray = tpu_rt::load_ray(a.origin, a.direction, a.t_min, i);
    l.t = a.t_max[i];
  }
  return l;
}

// Row `row` (12 words in shared memory; `group` its group) against the
// thread's S rays.
template <int S>
__device__ __forceinline__ void test_row(Lane (&l)[S], const float* row,
                                         const int* group) {
  const float4 c0 = *reinterpret_cast<const float4*>(row);
  const float4 c1 = *reinterpret_cast<const float4*>(row + 4);
  const float p0x = c0.x, p0y = c0.y, p0z = c0.z;
  const float e1x = c0.w, e1y = c1.x, e1z = c1.y;
  const float e2x = c1.z, e2y = c1.w, e2z = row[8];
  bool may[S];  // ray r may hit the row
  bool any = false;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const tpu_rt::Ray& ray = l[r].ray;
    // tri_hit's den, u and v numerators: the same operations in the same
    // order (traverse_common.cuh:89-99), so the same bits
    const float pv0 = ray.dy * e2z - ray.dz * e2y;
    const float pv1 = ray.dz * e2x - ray.dx * e2z;
    const float pv2 = ray.dx * e2y - ray.dy * e2x;
    const float den = pv0 * e1x + pv1 * e1y + pv2 * e1z;
    const float tv0 = ray.ox - p0x, tv1 = ray.oy - p0y, tv2 = ray.oz - p0z;
    const float nu = pv0 * tv0 + pv1 * tv1 + pv2 * tv2;
    const float qv0 = tv1 * e1z - tv2 * e1y;
    const float qv1 = tv2 * e1x - tv0 * e1z;
    const float qv2 = tv0 * e1y - tv1 * e1x;
    const float nv = qv0 * ray.dx + qv1 * ray.dy + qv2 * ray.dz;
    may[r] = !tpu_rt::surely_misses(den, nu, nv);
    any |= may[r];
  }
  if (!any) return;  // every ray of the thread surely misses the row
  const int id = __float_as_int(row[9]);
  const int g = *group;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float t;
    // tri_hit tests t <= l.t, so equal t is the only tie: a later group,
    // or the same group's lower id, takes it
    if (may[r] &&
        tpu_rt::tri_hit(l[r].ray, p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z,
                        l[r].t, &t) &&
        t < INFINITY &&
        (t < l[r].t || g > l[r].group || (g == l[r].group && id < l[r].id))) {
      l[r].t = t;
      l[r].id = id;
      l[r].group = g;
    }
  }
}

// The block's live lanes (lanes[0 .. total), S = ceil(total / kThreads)
// slots a thread) against the whole table, streamed through the ring.
template <int S>
__device__ __forceinline__ void run(const Args& a, const int* lanes,
                                    int total, unsigned char* ring,
                                    uint64_t* full) {
  int idx[S];
  Lane l[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int k = r * kThreads + threadIdx.x;
    idx[r] = k < total ? lanes[k] : -1;
    l[r] = load_lane(a, idx[r]);
  }
  const int stage_bytes = a.tile_rows * kStageRowBytes;
  if (threadIdx.x == 0)
    for (int s = 0; s < a.n_stages; ++s)
      fill(a, ring + s * stage_bytes, s, &full[s]);
  int groups = 0, last_group = -1;  // the counters: groups with a row
  for (int it = 0; it < a.n_tiles; ++it) {
    const int s = it % a.n_stages;
    tpu_rt::bar_wait(&full[s], (it / a.n_stages) & 1);
    const unsigned char* stage = ring + s * stage_bytes;
    const float* rows = reinterpret_cast<const float*>(stage);
    const int* grp =
        reinterpret_cast<const int*>(stage + a.tile_rows * kRowBytes);
    const int n = min(a.tile_rows, a.n_records - it * a.tile_rows);
    if (a.counts != nullptr)
      for (int k = 0; k < n; ++k) {
        groups += grp[k] != last_group;
        last_group = grp[k];
      }
    // two rows an iteration: one row's loads issue under the other's tests
#pragma unroll 2
    for (int k = 0; k < n; ++k) test_row<S>(l, rows + k * kRowWords, grp + k);
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && it + a.n_stages < a.n_tiles) {
      // order the block's reads of the stage before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fill(a, ring + s * stage_bytes, it + a.n_stages, &full[s]);
    }
  }
#pragma unroll
  for (int r = 0; r < S; ++r) {
    if (idx[r] < 0) continue;
    a.t_out[idx[r]] = l[r].t;
    a.best_out[idx[r]] = l[r].id;
    tpu_rt::store_counts(a.counts, idx[r], groups, 0, a.n_records);
  }
}

__global__ void __launch_bounds__(kThreads)
    t8_brute(Args a, const bool* __restrict__ active, int n_rays,
             int block_lanes) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int warp_live[kSlots * kWarps];
  __shared__ int lanes[kSlots * kThreads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The block's active lanes, in lane order, into lanes[]; an inactive
  // lane gets (t_max, -1) and no counts here. Block b takes lanes b,
  // b + gridDim.x, b + 2 gridDim.x, ...: strided, so that every block
  // holds about the batch's share of live lanes, wherever they cluster.
  int pos[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int i = blockIdx.x + (r * kThreads + threadIdx.x) * gridDim.x;
    bool live = false;
    if (r * kThreads < block_lanes && i < n_rays) {
      live = active[i];
      if (!live) {
        a.t_out[i] = a.t_max[i];
        a.best_out[i] = -1;
        tpu_rt::store_counts(a.counts, i, 0, 0, 0);
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[r * kWarps + warp] = __popc(m);
    pos[r] = live ? __popc(m & ((1u << lane) - 1u)) : -1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.n_stages; ++s) tpu_rt::bar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int total = 0, off[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) off[r] = total;
      total += warp_live[r * kWarps + w];
    }
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (pos[r] >= 0)
      lanes[off[r] + pos[r]] =
          blockIdx.x + (r * kThreads + threadIdx.x) * gridDim.x;
  __syncthreads();
  switch ((total + kThreads - 1) / kThreads) {  // the same in every thread
    case 0:
      return;
    case 1:
      run<1>(a, lanes, total, ring, full);
      break;
    case 2:
      run<2>(a, lanes, total, ring, full);
      break;
    case 3:
      run<3>(a, lanes, total, ring, full);
      break;
    default:
      run<4>(a, lanes, total, ring, full);
  }
}

}  // namespace

extern "C" int tpu_rt_t8_brute(const float* tris, const int* groups,
                               const float* origin, const float* direction,
                               const float* t_min, const float* t_max,
                               const bool* active, float* t_out, int* best_out,
                               int* counts, int n_rays, int n_records,
                               void* stream) {
  if (n_rays <= 0) return 0;
  if (n_records < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Rays a thread: the s of 1-4 whose grid the SMs finish first. The
  // blocks run in about one wave, so the SM with the most of them sets the
  // time, and a block's pass over a row costs about 44 s + 8 issue slots a
  // thread (s tests, the loads and the loop); a larger s wins a tie. On an
  // H100 80GB HBM3 at 700 W, at the bunny frame's 250,000 camera rays and
  // their shadow rays, it takes 11% and 13% less time than s = 4 always
  // (scripts/torch_brute_ab.py).
  int block_lanes = kThreads * kSlots;
  long best = -1;
  for (int s = kSlots; s >= 1; --s) {
    const long blocks = (n_rays + kThreads * s - 1) / (kThreads * s);
    const long cost = (blocks + sms - 1) / sms * (44 * s + 8);
    if (best < 0 || cost < best) {
      best = cost;
      block_lanes = kThreads * s;
    }
  }
  Args a{tris, groups, origin, direction, t_min, t_max, t_out, best_out,
         counts, n_records};
  a.tile_rows = min(kTileRows, (n_records + 3) & ~3);
  a.n_tiles = n_records == 0 ? 0 : (n_records + a.tile_rows - 1) / a.tile_rows;
  a.n_stages = min(kStages, a.n_tiles);
  const size_t smem = (size_t)a.n_stages * a.tile_rows * kStageRowBytes;
  const dim3 grid((n_rays + block_lanes - 1) / block_lanes);
  t8_brute<<<grid, dim3(kThreads), smem, static_cast<cudaStream_t>(stream)>>>(
      a, active, n_rays, block_lanes);
  return (int)cudaGetLastError();
}
