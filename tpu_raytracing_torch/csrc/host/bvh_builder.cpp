// Native binned-SAH BVH builder producing the skip-link linear layout of
// tpu_raytracing_torch/accel/bvh.py (LinearBVH contract). The port's copy
// of the JAX package's csrc/bvh_builder.cpp, unchanged below this header.
//
// This is the framework's native acceleration-structure builder — the role
// Embree's rtcBuildBVH plays for the reference (crates/embree4/src/bvh.rs,
// raytracing/src/accel/bvh2.rs). The algorithm mirrors the Python builder
// EXACTLY (same f32 binning arithmetic, first-minimum argmin, stable
// partition, stable-sort median fallback) so both emit bit-identical
// layouts — the snapshot harness depends on deterministic BVHs.
//
// Build: g++ at first use (-O3 -fPIC -std=c++17 -fno-fast-math) into
// tpu_raytracing_torch/_build/; loaded via ctypes by
// tpu_raytracing_torch/native.py (TPU_RAYTRACING_NO_NATIVE selects the
// numpy builder instead).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int N_BINS = 16;
constexpr float INF = std::numeric_limits<float>::infinity();

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline float half_area2(const V3 &lo, const V3 &hi) {
  float ex = std::max(hi.x - lo.x, 0.0f);
  float ey = std::max(hi.y - lo.y, 0.0f);
  float ez = std::max(hi.z - lo.z, 0.0f);
  return 2.0f * (ex * ey + ey * ez + ex * ez);
}

struct Builder {
  const V3 *pmin;
  const V3 *pmax;
  std::vector<V3> centroid;
  std::vector<int32_t> order;
  int max_leaf;

  std::vector<V3> node_min, node_max;
  std::vector<int32_t> left_first, count, right_child;

  // Binned SAH split of order[lo:hi); partitions order stably in place.
  // Returns split position or -1 (leaf preferred / unsplittable).
  int sah_split(int lo, int hi) {
    V3 cmin = {INF, INF, INF}, cmax = {-INF, -INF, -INF};
    for (int i = lo; i < hi; i++) {
      const V3 &c = centroid[order[i]];
      cmin = vmin(cmin, c);
      cmax = vmax(cmax, c);
    }
    float extent[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    const float cmin_a[3] = {cmin.x, cmin.y, cmin.z};

    // numpy computes cost as f32 area * int64 count -> float64; match that
    bool have_best = false;
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1, best_bin = -1;

    for (int axis = 0; axis < 3; axis++) {
      if (!(extent[axis] > 0.0f)) continue;
      float scale = (float)N_BINS / extent[axis];

      int32_t counts[N_BINS] = {0};
      V3 bin_lo[N_BINS], bin_hi[N_BINS];
      for (int b = 0; b < N_BINS; b++) {
        bin_lo[b] = {INF, INF, INF};
        bin_hi[b] = {-INF, -INF, -INF};
      }
      for (int i = lo; i < hi; i++) {
        int32_t id = order[i];
        const V3 &c = centroid[id];
        float cc = (axis == 0 ? c.x : axis == 1 ? c.y : c.z);
        int b = (int)((cc - cmin_a[axis]) * scale);  // trunc, matches int32 cast
        if (b > N_BINS - 1) b = N_BINS - 1;
        counts[b]++;
        bin_lo[b] = vmin(bin_lo[b], pmin[id]);
        bin_hi[b] = vmax(bin_hi[b], pmax[id]);
      }

      // prefix/suffix sweeps over bin boundaries (N_BINS-1 candidate splits)
      int32_t lcnt[N_BINS - 1];
      V3 l_lo = bin_lo[0], l_hi = bin_hi[0];
      V3 pref_lo[N_BINS - 1], pref_hi[N_BINS - 1];
      int32_t acc = 0;
      for (int b = 0; b < N_BINS - 1; b++) {
        if (b > 0) {
          l_lo = vmin(l_lo, bin_lo[b]);
          l_hi = vmax(l_hi, bin_hi[b]);
        }
        acc += counts[b];
        lcnt[b] = acc;
        pref_lo[b] = l_lo;
        pref_hi[b] = l_hi;
      }
      V3 r_lo = bin_lo[N_BINS - 1], r_hi = bin_hi[N_BINS - 1];
      V3 suf_lo[N_BINS - 1], suf_hi[N_BINS - 1];
      for (int b = N_BINS - 2; b >= 0; b--) {
        if (b < N_BINS - 2) {
          r_lo = vmin(r_lo, bin_lo[b + 1]);
          r_hi = vmax(r_hi, bin_hi[b + 1]);
        }
        suf_lo[b] = r_lo;
        suf_hi[b] = r_hi;
      }

      int total = hi - lo;
      for (int b = 0; b < N_BINS - 1; b++) {
        int32_t lc = lcnt[b], rc = total - lcnt[b];
        double cost =
            (lc == 0 || rc == 0)
                ? std::numeric_limits<double>::infinity()
                : (double)half_area2(pref_lo[b], pref_hi[b]) * (double)lc +
                      (double)half_area2(suf_lo[b], suf_hi[b]) * (double)rc;
        // numpy argmin: first minimum per axis; axes compared with strict <
        if (std::isfinite(cost)) {
          if (!have_best || cost < best_cost) {
            // within an axis, keep the FIRST minimum (strict <)
            have_best = true;
            best_cost = cost;
            best_axis = axis;
            best_bin = b;
          }
        }
      }
    }

    if (!have_best) return -1;

    float scale = (float)N_BINS / extent[best_axis];
    const float cmin_b = cmin_a[best_axis];
    // stable partition: left-goers keep order, then right-goers keep order
    std::vector<int32_t> left, right;
    left.reserve(hi - lo);
    for (int i = lo; i < hi; i++) {
      int32_t id = order[i];
      const V3 &c = centroid[id];
      float cc = (best_axis == 0 ? c.x : best_axis == 1 ? c.y : c.z);
      int b = (int)((cc - cmin_b) * scale);
      if (b > N_BINS - 1) b = N_BINS - 1;
      if (b <= best_bin)
        left.push_back(id);
      else
        right.push_back(id);
    }
    if (left.empty() || right.empty()) return -1;
    std::copy(left.begin(), left.end(), order.begin() + lo);
    std::copy(right.begin(), right.end(), order.begin() + lo + left.size());
    return lo + (int)left.size();
  }

  // Preorder emission with an explicit stack (matches the recursive order of
  // the Python builder).
  void build(int n) {
    struct Task {
      int lo, hi;
      int parent;   // node to patch right_child on, or -1
      bool is_right;
    };
    std::vector<Task> stack;
    stack.push_back({0, n, -1, false});

    while (!stack.empty()) {
      Task t = stack.back();
      stack.pop_back();
      int idx = (int)node_min.size();
      if (t.parent >= 0 && t.is_right) right_child[t.parent] = idx;

      V3 bb_min = {INF, INF, INF}, bb_max = {-INF, -INF, -INF};
      for (int i = t.lo; i < t.hi; i++) {
        bb_min = vmin(bb_min, pmin[order[i]]);
        bb_max = vmax(bb_max, pmax[order[i]]);
      }
      node_min.push_back(bb_min);
      node_max.push_back(bb_max);
      right_child.push_back(-1);
      int node_count = t.hi - t.lo;

      int split = -1;
      if (node_count > max_leaf) split = sah_split(t.lo, t.hi);
      if (split < 0 && node_count > max_leaf) {
        // median fallback: stable sort on longest axis
        float ex = bb_max.x - bb_min.x, ey = bb_max.y - bb_min.y,
              ez = bb_max.z - bb_min.z;
        int axis = (ex >= ey && ex >= ez) ? 0 : (ey >= ez ? 1 : 2);
        std::stable_sort(
            order.begin() + t.lo, order.begin() + t.hi,
            [&](int32_t a, int32_t b) {
              const V3 &ca = centroid[a], &cb = centroid[b];
              float va = (axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z);
              float vb = (axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z);
              return va < vb;
            });
        split = t.lo + node_count / 2;
      }

      if (split < 0) {
        left_first.push_back(t.lo);
        count.push_back(node_count);
      } else {
        left_first.push_back(-1);  // patched when left child is emitted: idx+1
        count.push_back(0);
        // preorder: left next, so push right first
        stack.push_back({split, t.hi, idx, true});
        stack.push_back({t.lo, split, idx, false});
      }
    }

    // left child is always the next node in preorder
    for (size_t i = 0; i < left_first.size(); i++)
      if (count[i] == 0 && left_first[i] < 0) left_first[i] = (int)i + 1;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on capacity overflow.
// Output capacity must be >= 2*n (+1 for n==0).
int tpu_rt_build_bvh(const float *prim_min, const float *prim_max, int n,
                     int max_leaf_size, float *out_node_min,
                     float *out_node_max, int32_t *out_left_first,
                     int32_t *out_count, int32_t *out_skip,
                     int32_t *out_prim_order, int capacity) {
  if (n <= 0) {
    if (capacity < 1) return -1;
    out_node_min[0] = out_node_min[1] = out_node_min[2] = 0.0f;
    out_node_max[0] = out_node_max[1] = out_node_max[2] = -1.0f;
    out_left_first[0] = 0;
    out_count[0] = 0;
    out_skip[0] = 1;
    return 1;
  }

  Builder b;
  b.pmin = reinterpret_cast<const V3 *>(prim_min);
  b.pmax = reinterpret_cast<const V3 *>(prim_max);
  b.max_leaf = max_leaf_size;
  b.centroid.resize(n);
  b.order.resize(n);
  for (int i = 0; i < n; i++) {
    b.centroid[i] = {(b.pmin[i].x + b.pmax[i].x) * 0.5f,
                     (b.pmin[i].y + b.pmax[i].y) * 0.5f,
                     (b.pmin[i].z + b.pmax[i].z) * 0.5f};
    b.order[i] = i;
  }
  b.build(n);

  int n_nodes = (int)b.node_min.size();
  if (n_nodes > capacity) return -1;

  // skip links: skip[left] = right sibling, skip[right] = parent's skip
  std::vector<int32_t> skip(n_nodes, n_nodes);
  std::vector<std::pair<int32_t, int32_t>> st;
  st.push_back({0, n_nodes});
  while (!st.empty()) {
    auto [i, s] = st.back();
    st.pop_back();
    skip[i] = s;
    if (b.count[i] == 0) {
      int l = b.left_first[i], r = b.right_child[i];
      st.push_back({l, r});
      st.push_back({r, s});
    }
  }

  for (int i = 0; i < n_nodes; i++) {
    out_node_min[3 * i] = b.node_min[i].x;
    out_node_min[3 * i + 1] = b.node_min[i].y;
    out_node_min[3 * i + 2] = b.node_min[i].z;
    out_node_max[3 * i] = b.node_max[i].x;
    out_node_max[3 * i + 1] = b.node_max[i].y;
    out_node_max[3 * i + 2] = b.node_max[i].z;
    out_left_first[i] = b.left_first[i];
    out_count[i] = b.count[i];
    out_skip[i] = skip[i];
  }
  std::memcpy(out_prim_order, b.order.data(), sizeof(int32_t) * n);
  return n_nodes;
}

int tpu_rt_abi_version() { return 2; }

}  // extern "C"
