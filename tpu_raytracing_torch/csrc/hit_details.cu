// hit_details as one kernel a call: an encoded (t, prim) result expanded
// into its shading geometry, one thread a lane.
//
// Replaces no TPU kernel: the JAX package leaves hit_details to XLA
// (tpu_raytracing/ops/traverse.py). Its PyTorch twin,
// ops/traverse.py::hit_details_plain, is predicated: it gathers a
// tri_shade row for every lane, re-solves Moller-Trumbore, interpolates,
// computes the sphere branch and the instance branch over every lane and
// selects each lane's with torch.where, about 350 small launches a call
// and a sync for its default uv corners. Here a thread reads its lane's
// prim and computes its own kind alone:
// - a miss writes the twin's values (t = inf, zeros, material 0, light -1);
// - a triangle reads its 128-byte tri_shade row as 16-byte loads (the int
//   columns 24-27 by __float_as_int), re-solves u and v with
//   ray_triangle's arithmetic, and takes the geometric and shading
//   normals, the uv (default corners (0,0), (1,0), (0,1) as constants),
//   dpdu and dpdv (pbrt 4ed eq. 6.7 with the degenerate-det rule), the
//   material and the light;
// - an instanced triangle finds its instance in the ascending vtri bases
//   (DeviceScene.inst_bases), re-solves in object space and transforms
//   the normal (by the inverse transpose), dpdu and dpdv out;
// - a sphere reprojects the hit onto its surface in object space,
//   inflates it by (1 + 4e-7), takes intersect.py::sphere_hit_geom and
//   transforms the point, the normal and the derivatives out.
// Which branches exist comes from the scene's counts (triangles, spheres,
// instances), so one kernel serves every scene.
//
// Bit for bit with the plain twin on the card, by the rules at the head of
// bsdf_common.cuh: each operation is PyTorch's f32 CUDA operation in the
// twin's order; the sphere's torch.sum over xyz adds as PyTorch's CUDA
// reduction of a 3-wide row does, (x + z) + y; acosf and sinf as
// torch.acos and sin; a branch the twin selects away is not computed.
//
// What bounds it on the H100: bytes. A triangle lane reads its ray (32 B)
// and its row (112 B) and writes 69 B; a call of 250,000 lanes moves at
// most 53 MB, 16 us at 3.35 TB/s (chip_smoke.py::HIT_LANE_BYTES). What
// the kernel saves is the host's launches, not device time.

#include "bsdf_common.cuh"

namespace {

// f32 constants, each as PyTorch rounds the Python float at its use
constexpr float kInvTwoPi = 0x1.45f306p-3f;  // t / (2.0 * math.pi)
constexpr float kInflate = 0x1.000006p+0f;   // (1.0 + 4.0e-7) * t
constexpr float kDegenerateDet = 0x1.12e0bep-30f;  // abs(det) < 1e-9

struct UV {
  float u, v;
};

// what hit_details gives a lane that hits
struct Geom {
  UV uv;
  V3 point, normal, dpdu, dpdv;
  int material, light;
};

// linalg.py on a row-major 4x4
struct M4 {
  float m[16];
};

__device__ __forceinline__ M4 load_m4(const float* p) {
  M4 r;
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = __ldg(q + k);
    r.m[4 * k] = v.x;
    r.m[4 * k + 1] = v.y;
    r.m[4 * k + 2] = v.z;
    r.m[4 * k + 3] = v.w;
  }
  return r;
}

__device__ __forceinline__ float row3(const M4& a, int i, V3 v) {
  return a.m[4 * i] * v.x + a.m[4 * i + 1] * v.y + a.m[4 * i + 2] * v.z;
}

// linalg.py::apply_vector
__device__ __forceinline__ V3 apply_vector(const M4& a, V3 v) {
  return {row3(a, 0, v), row3(a, 1, v), row3(a, 2, v)};
}

// linalg.py::apply_vector_transposed
__device__ __forceinline__ V3 apply_vector_transposed(const M4& a, V3 v) {
  return {a.m[0] * v.x + a.m[4] * v.y + a.m[8] * v.z,
          a.m[1] * v.x + a.m[5] * v.y + a.m[9] * v.z,
          a.m[2] * v.x + a.m[6] * v.y + a.m[10] * v.z};
}

// linalg.py::apply_point
__device__ __forceinline__ V3 apply_point(const M4& a, V3 p) {
  const float w = row3(a, 3, p) + a.m[15];
  return {(row3(a, 0, p) + a.m[3]) / w, (row3(a, 1, p) + a.m[7]) / w,
          (row3(a, 2, p) + a.m[11]) / w};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

// torch.clamp(x, -1.0, 1.0): NaN passes
__device__ __forceinline__ float clamp_unit(float x) {
  return clamp_max(clamp_min(x, -1.0f), 1.0f);
}

// the scene tables the kernel reads (device/scene_buffers.py::DeviceScene)
struct Scene {
  const float* tri_shade;   // (n_rows, 32) p0 p1 p2 n0 n1 n2 uv0 uv1 uv2,
                            // bits of material, light, has_n, has_uv
  const float* sph_center;  // (n_sph_rows, 3)
  const float* sph_radius;  // (n_sph_rows,)
  const float* sph_o2w;     // (n_sph_rows, 16)
  const float* sph_w2o;     // (n_sph_rows, 16)
  const int* sph_mat;       // (n_sph_rows,)
  const int* sph_light;     // (n_sph_rows,)
  const float* inst_xf;     // (max(1, n_inst), 32) o2w | w2o
  const int* inst_bases;    // (2, n_inst) vtri bases (ascending), shade
                            // row offsets
  int n_tris, n_rows, n_spheres, n_sph_rows, n_inst, inst_vtri_base0;
};

// hit_details_plain's triangle part for tri_shade row `row` and the ray
// (o, d) in the row's space: everything but the point
__device__ Geom triangle(const Scene& s, int row, V3 o, V3 d) {
  const float4* r = reinterpret_cast<const float4*>(s.tri_shade) + 8 * row;
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2),
               e = __ldg(r + 3), f = __ldg(r + 4), g = __ldg(r + 5),
               h = __ldg(r + 6);
  const V3 p0 = {a.x, a.y, a.z}, p1 = {a.w, b.x, b.y}, p2 = {b.z, b.w, c.x};
  const V3 n0 = {c.y, c.z, c.w}, n1 = {e.x, e.y, e.z}, n2 = {e.w, f.x, f.y};
  const bool has_n = __float_as_int(h.z) != 0;
  const bool has_uv = __float_as_int(h.w) != 0;
  const UV uv0 = has_uv ? UV{f.z, f.w} : UV{0.0f, 0.0f};
  const UV uv1 = has_uv ? UV{g.x, g.y} : UV{1.0f, 0.0f};
  const UV uv2 = has_uv ? UV{g.z, g.w} : UV{0.0f, 1.0f};

  // intersect.py::ray_triangle_edges, u and v
  const V3 e1 = sub(p1, p0), e2 = sub(p2, p0);
  const V3 pvec = cross(d, e2);
  const float denom = dot(pvec, e1);
  const float safe_denom = denom == 0.0f ? 1.0f : denom;
  const V3 tvec = sub(o, p0);
  const float u = dot(pvec, tvec) / safe_denom;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(qvec, d) / safe_denom;
  const float w = 1.0f - u - v;

  Geom out;
  if (has_n) {
    out.normal = normalize(
        {w * n0.x + u * n1.x + v * n2.x, w * n0.y + u * n1.y + v * n2.y,
         w * n0.z + u * n1.z + v * n2.z});
  } else {
    out.normal = normalize(cross(e2, e1));
  }
  out.uv = {w * uv0.u + u * uv1.u + v * uv2.u,
            w * uv0.v + u * uv1.v + v * uv2.v};
  // pbrt 4ed eq. 6.7
  const UV duv02 = {uv0.u - uv2.u, uv0.v - uv2.v};
  const UV duv12 = {uv1.u - uv2.u, uv1.v - uv2.v};
  const V3 dp02 = sub(p0, p2), dp12 = sub(p1, p2);
  const float det = duv02.u * duv12.v - duv02.v * duv12.u;
  const bool degenerate = fabsf(det) < kDegenerateDet;
  const float inv_det = degenerate ? 0.0f : rdiv(1.0f, det);
  out.dpdu = scale(sub(scale(dp02, duv12.v), scale(dp12, duv02.v)), inv_det);
  out.dpdv = scale(sub(scale(dp12, duv02.u), scale(dp02, duv12.u)), inv_det);
  out.material = __float_as_int(h.x);
  out.light = __float_as_int(h.y);
  return out;
}

// the lane's instance: the last whose vtri base is <= prim
// (torch.searchsorted(vbase, prim, right=True) - 1)
__device__ int instance_of(const Scene& s, int prim) {
  int lo = 0, hi = s.n_inst;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(s.inst_bases + mid) <= prim) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// hit_details_plain's instance branch: the object-space re-solve and the
// transforms out
__device__ Geom instanced_triangle(const Scene& s, int prim, V3 o, V3 d) {
  const int xf = instance_of(s, prim);
  const int row = min(max(prim - __ldg(s.inst_bases + xf) +
                              __ldg(s.inst_bases + s.n_inst + xf),
                          0),
                      s.n_rows - 1);
  const M4 o2w = load_m4(s.inst_xf + 32 * xf);
  const M4 iw2o = load_m4(s.inst_xf + 32 * xf + 16);
  Geom g = triangle(s, row, apply_point(iw2o, o), apply_vector(iw2o, d));
  g.normal = normalize(apply_vector_transposed(iw2o, g.normal));
  g.dpdu = apply_vector(o2w, g.dpdu);
  g.dpdv = apply_vector(o2w, g.dpdv);
  return g;
}

// hit_details_plain's sphere branch (with intersect.py::sphere_hit_geom)
__device__ Geom sphere(const Scene& s, int prim, V3 o, V3 d, float t) {
  const int sid = min(prim - s.n_tris, s.n_sph_rows - 1);
  const M4 w2o = load_m4(s.sph_w2o + 16 * sid);
  const M4 o2w = load_m4(s.sph_o2w + 16 * sid);
  const V3 o_o = apply_point(w2o, o);
  const V3 d_o = apply_vector(w2o, d);
  V3 p_o = add(o_o, scale(d_o, t));
  // reproject onto the surface and inflate a few ULPs outward
  const V3 ctr = load3(s.sph_center, sid);
  const float rad = s.sph_radius[sid];
  const V3 rel = sub(p_o, ctr);
  const float rn = sqrtf(rel.x * rel.x + rel.z * rel.z + rel.y * rel.y);
  const float safe_rn = rn == 0.0f ? 1.0f : rn;
  p_o = add(ctr, scale(scale(rel, rad / safe_rn), kInflate));

  const V3 local = sub(p_o, ctr);
  const float cos_theta = clamp_unit(local.z / rad);
  const float theta = acosf(cos_theta);
  const float sin_theta = sinf(theta);
  const float safe_rst = sin_theta == 0.0f ? 1.0f : rad * sin_theta;
  const float cos_phi = clamp_unit(local.x / safe_rst);
  const float sin_phi = local.y / safe_rst;
  const float acos_cp = acosf(cos_phi);
  const float phi = local.y > 0.0f ? acos_cp : kTwoPi - acos_cp;
  const V3 dpdu_o = {-kTwoPi * local.y, kTwoPi * local.x, 0.0f};
  const V3 dpdv_o = {kPi * (local.z * cos_phi), kPi * (local.z * sin_phi),
                     kPi * (-rad * sin_theta)};
  const V3 n_o = {local.x / rad, local.y / rad, local.z / rad};

  Geom g;
  g.uv = {phi * kInvTwoPi, theta * kInvPi};
  g.point = apply_point(o2w, p_o);
  g.normal = normalize(apply_vector_transposed(w2o, n_o));
  g.dpdu = apply_vector(o2w, dpdu_o);
  g.dpdv = apply_vector(o2w, dpdv_o);
  g.material = s.sph_mat[sid];
  g.light = s.sph_light[sid];
  return g;
}

// hit_details_plain for a lane that hits, its ray (o, d), t and prim:
// the branch its prim selects
__device__ Geom hit_lane(const Scene& s, V3 o, V3 d, float t, int prim) {
  const V3 point = add(o, scale(d, t));
  if (s.n_inst > 0 && prim >= s.inst_vtri_base0) {
    Geom g = instanced_triangle(s, prim, o, d);
    g.point = point;
    return g;
  }
  if (prim < s.n_tris || s.n_spheres == 0) {
    // a prim past the triangles in a scene without spheres takes row 0,
    // as the twin's clamped gather does
    Geom g = triangle(s, prim < s.n_tris ? prim : 0, o, d);
    g.point = point;
    return g;
  }
  return sphere(s, prim, o, d, t);
}

__device__ __forceinline__ void store2(float* p, int i, UV v) {
  p[2 * i] = v.u;
  p[2 * i + 1] = v.v;
}

// ---------------------------------------------------------------- kernels

struct Out {
  bool* hit;
  float *t, *uv, *point, *normal, *dpdu, *dpdv;
  int *material, *light;
};

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    hit_details_kernel(Scene s, const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_in,
                       const int* __restrict__ prim_in, Out out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int prim = prim_in[i];
  const V3 zero = {0.0f, 0.0f, 0.0f};
  Geom g = {{0.0f, 0.0f}, zero, zero, zero, zero, 0, -1};
  float t = __int_as_float(0x7f800000);  // +inf
  if (prim >= 0) {
    t = t_in[i];
    g = hit_lane(s, load3(origin, i), load3(direction, i), t, prim);
  }
  out.hit[i] = prim >= 0;
  out.t[i] = t;
  store2(out.uv, i, g.uv);
  store3(out.point, i, g.point);
  store3(out.normal, i, g.normal);
  store3(out.dpdu, i, g.dpdu);
  store3(out.dpdv, i, g.dpdv);
  out.material[i] = g.material;
  out.light[i] = g.light;
}

unsigned grid_of(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int tpu_rt_hit_details(
    const float* tri_shade, const float* sph_center, const float* sph_radius,
    const float* sph_o2w, const float* sph_w2o, const int* sph_mat,
    const int* sph_light, const float* inst_xf, const int* inst_bases,
    const float* origin, const float* direction, const float* t,
    const int* prim, bool* hit_out, float* t_out, float* uv_out,
    float* point_out, float* normal_out, float* dpdu_out, float* dpdv_out,
    int* material_out, int* light_out, int n, int n_tris, int n_rows,
    int n_spheres, int n_sph_rows, int n_inst, int inst_vtri_base0,
    void* stream) {
  if (n <= 0) return 0;
  const Scene s{tri_shade, sph_center, sph_radius, sph_o2w,
                sph_w2o,   sph_mat,    sph_light,  inst_xf,
                inst_bases, n_tris,    n_rows,     n_spheres,
                n_sph_rows, n_inst,    inst_vtri_base0};
  const Out out{hit_out,    t_out,    uv_out,       point_out, normal_out,
                dpdu_out,   dpdv_out, material_out, light_out};
  hit_details_kernel<<<grid_of(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      s, origin, direction, t, prim, out, n);
  return (int)cudaGetLastError();
}
