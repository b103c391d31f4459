// The BSDF pieces that the coat's layered walk (layered_walk.cu) and the
// kernels of the other kinds (bsdf_kinds.cu) share: the diffuse sample,
// the dielectric Fresnel term and refraction, the Trowbridge-Reitz
// microfacet terms, and the smooth and rough dielectrics' samples and
// evaluations, each a one-lane copy of its ops/bsdf.py function.
//
// Bit for bit with the plain PyTorch code on the card: each operation is
// the f32 operation PyTorch's CUDA kernel makes, in the plain code's order:
// - built with -fmad=false and IEEE divides and square roots
//   (native_cuda.NVCC_FLAGS), so no multiply and add fuse;
// - sqrtf, sinf, cosf as torch.sqrt, sin, cos;
// - a Python scalar over a tensor is reciprocal(t) * scalar (`rdiv`);
//   a tensor over a Python scalar is t * (1 / scalar in f32) (kInvPi);
// - clamp, minimum and amax pass NaN through; fminf and fmaxf do not;
// - x ** 2 is x * x; every constant is the f32 PyTorch rounds the Python
//   float to (hex literals, held against bsdf.py by
//   tests/test_torch_layered_kernel.py and tests/test_torch_bsdf_kernel.py).
//
// Everything here has internal linkage (an unnamed namespace), as it had
// inside layered_walk.cu, so each source compiles it as its own code.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// material kinds (device/scene_buffers.py)
constexpr int MAT_DIFFUSE = 0;
constexpr int MAT_SMOOTH_DIELECTRIC = 1;
constexpr int MAT_SMOOTH_CONDUCTOR = 2;
constexpr int MAT_ROUGH_DIELECTRIC = 3;
constexpr int MAT_ROUGH_CONDUCTOR = 4;
constexpr int MAT_COATED_DIFFUSE = 5;

// component flags (ops/bsdf.py)
constexpr int NONSPECULAR_REFLECTION = 1;
constexpr int SPECULAR_REFLECTION = 2;
constexpr int NONSPECULAR_TRANSMISSION = 4;
constexpr int SPECULAR_TRANSMISSION = 8;
constexpr int REFLECTION = NONSPECULAR_REFLECTION | SPECULAR_REFLECTION;
constexpr int TRANSMISSION = NONSPECULAR_TRANSMISSION | SPECULAR_TRANSMISSION;
constexpr int SPECULAR = SPECULAR_REFLECTION | SPECULAR_TRANSMISSION;
constexpr int ALL_COMPONENTS = REFLECTION | TRANSMISSION;

// f32 constants, each as PyTorch rounds the Python float at its use
constexpr float kPi = 0x1.921fb6p+1f;       // bsdf.py::_PI * t
constexpr float kInvPi = 0x1.45f306p-2f;    // t / _PI: t * (1 / f32(pi))
constexpr float kTwoPi = 0x1.921fb6p+2f;    // (2.0 * math.pi) * t
constexpr float kWhPole = 0x1.fff2e4p-1f;   // 0.9999, tr_sample_wm
constexpr float kMinNz = 0x1.0c6f7ap-20f;   // 1.0e-6, tr_sample_wm
constexpr float kMinDot = 0x1.79ca10p-67f;  // 1e-20, _ts_pdf_from
constexpr float kLambdaGrazing = 0x1.7d784p+26f;  // 1e8, tr_lambda

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 divide(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 splat(float s) { return {s, s, s}; }

// linalg.py
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n = sqrtf(dot(a, a));
  return divide(a, n > 0.0f ? n : 1.0f);
}

// PyTorch's NaN rules and scalar forms
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float amax(V3 a) {
  if (isnan(a.x) || isnan(a.y) || isnan(a.z)) return a.x + a.y + a.z;  // NaN
  return fmaxf(fmaxf(a.x, a.y), a.z);
}
__device__ __forceinline__ float rdiv(float c, float t) {
  return (1.0f / t) * c;
}

struct Disk {
  float x, y;
};
__device__ __forceinline__ Disk sample_unit_disk(float u0, float u1) {
  const float r = sqrtf(u0);
  const float theta = u1 * kTwoPi;
  return {r * cosf(theta), r * sinf(theta)};
}

// a dielectric's sample (its f is the same in every channel) or a diffuse one
struct TopSample {
  V3 wi;
  float f, pdf;
  int component;
  bool valid;
};
struct BaseSample {
  V3 wi, f;
  float pdf;
  bool valid;
};
struct EvalPdf {
  float f, pdf;
};

// bsdf.py::fresnel_dielectric
__device__ float fresnel_dielectric(float cos_i, float eta) {
  if (cos_i < 0.0f) eta = rdiv(1.0f, eta);
  cos_i = fabsf(cos_i);
  const float sin2_i = 1.0f - cos_i * cos_i;
  const float sin2_t = sin2_i / (eta * eta);
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  const float r_parl = (eta * cos_i - cos_t) / (eta * cos_i + cos_t);
  const float r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t);
  const float r = (r_parl * r_parl + r_perp * r_perp) * 0.5f;
  return sin2_t >= 1.0f ? 1.0f : r;
}

// bsdf.py::refract; `tir` set on total internal reflection
__device__ V3 refract(float eta, V3 wo, V3 n, bool& tir) {
  float cos_i = dot(wo, n);
  if (cos_i < 0.0f) {
    eta = rdiv(1.0f, eta);
    n = neg(n);
  }
  cos_i = fabsf(cos_i);
  const float sin2_i = 1.0f - cos_i * cos_i;
  const float sin2_t = sin2_i / (eta * eta);
  tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  const float k = cos_i / eta - cos_t;
  return {-wo.x / eta + k * n.x, -wo.y / eta + k * n.y,
          -wo.z / eta + k * n.z};
}

// bsdf.py::reflect_z
__device__ __forceinline__ V3 reflect_z(V3 wo, V3 n) {
  const float d2 = dot(wo, n) * 2.0f;
  return {d2 * n.x - wo.x, d2 * n.y - wo.y, d2 * n.z - wo.z};
}

// bsdf.py::tr_distribution
__device__ float tr_distribution(V3 wm, float ax, float ay) {
  const float a = wm.x / ax, b = wm.y / ay;
  const float q = a * a + b * b + wm.z * wm.z;
  const float safe_q = q == 0.0f ? 1.0f : q;
  const float d = rdiv(1.0f, kPi * ax * ay * safe_q * safe_q);
  return q == 0.0f ? 0.0f : d;
}

// bsdf.py::tr_lambda
__device__ float tr_lambda(V3 w, float ax, float ay) {
  const float z2 = w.z * w.z;
  const float a = ax * w.x, b = ay * w.y;
  const float a2 = a * a + b * b;
  const float safe_z2 = z2 == 0.0f ? 1.0f : z2;
  const float lam = (sqrtf(a2 / safe_z2 + 1.0f) - 1.0f) * 0.5f;
  return z2 == 0.0f ? kLambdaGrazing : lam;
}

// bsdf.py::tr_sample_wm (visible normals)
__device__ V3 tr_sample_wm(V3 w, float ax, float ay, float u0, float u1) {
  V3 wh = normalize({ax * w.x, ay * w.y, w.z});
  if (wh.z < 0.0f) wh = neg(wh);
  const Disk p = sample_unit_disk(u0, u1);
  const V3 t1 = wh.z < kWhPole ? cross({0.0f, 0.0f, 1.0f}, wh)
                               : V3{1.0f, 0.0f, 0.0f};
  const V3 t2 = cross(wh, t1);
  const float h = sqrtf(clamp_min(1.0f - p.x * p.x, 0.0f));
  const float offset = h * 0.5f * (1.0f - wh.z);
  const float scl = (wh.z + 1.0f) * 0.5f;
  const float py = offset + scl * p.y;
  const float px = p.x;
  const float pz = sqrtf(clamp_min(1.0f - px * px - py * py, 0.0f));
  const V3 nh = {px * t1.x + py * t2.x + pz * wh.x,
                 px * t1.y + py * t2.y + pz * wh.y,
                 px * t1.z + py * t2.z + pz * wh.z};
  return normalize({ax * nh.x, ay * nh.y, clamp_min(nh.z, kMinNz)});
}

// bsdf.py::_ts_terms (with _ts_halfvector): what the rough dielectric's
// eval and pdf share for one (wo, wi)
struct TsTerms {
  V3 wm;
  float eta_wm, F, d, lam_o;
  bool reflect_case, invalid;
};

__device__ TsTerms ts_terms(V3 wo, V3 wi, float eta, float ax, float ay) {
  TsTerms t;
  t.reflect_case = wo.z * wi.z > 0.0f;
  t.eta_wm = t.reflect_case ? 1.0f : (wo.z > 0.0f ? eta : rdiv(1.0f, eta));
  const V3 h = {wi.x * t.eta_wm + wo.x, wi.y * t.eta_wm + wo.y,
                wi.z * t.eta_wm + wo.z};
  const bool degenerate = h.x == 0.0f && h.y == 0.0f && h.z == 0.0f;
  V3 wm = normalize(degenerate ? V3{1.0f, 1.0f, 1.0f} : h);
  if (wm.z < 0.0f) wm = neg(wm);
  t.wm = wm;
  const bool grazing = wi.z == 0.0f || wo.z == 0.0f || degenerate;
  const bool backfacing =
      dot(wm, wi) * wi.z < 0.0f || dot(wm, wo) * wo.z < 0.0f;
  t.invalid = grazing || backfacing;
  t.F = fresnel_dielectric(dot(wo, wm), eta);
  t.d = tr_distribution(wm, ax, ay);
  t.lam_o = tr_lambda(wo, ax, ay);
  return t;
}

// bsdf.py::_ts_pdf_from
template <int ALLOWED>
__device__ float ts_pdf_from(const TsTerms& t, V3 wo, V3 wi) {
  const float R = t.F;
  const float T = 1.0f - R;
  const float p_reflect = (ALLOWED & NONSPECULAR_REFLECTION) ? R : 0.0f;
  const float p_transmit = (ALLOWED & NONSPECULAR_TRANSMISSION) ? T : 0.0f;
  const float p_total = p_reflect + p_transmit;
  const float safe_total = p_total == 0.0f ? 1.0f : p_total;
  const float cos_o = fabsf(wo.z);
  const float safe_o = cos_o == 0.0f ? 1.0f : cos_o;
  const float dot_o = dot(wo, t.wm);
  const float vd = rdiv(1.0f, t.lam_o + 1.0f) / safe_o * t.d * fabsf(dot_o);
  const float safe_dot = clamp_min(fabsf(dot_o), kMinDot);
  const float pdf_r = p_reflect / safe_total * vd / (safe_dot * 4.0f);
  const float dot_i = dot(wi, t.wm);
  const float k = dot_i + dot_o / t.eta_wm;
  const float denom = k * k;
  const float safe_denom = denom == 0.0f ? 1.0f : denom;
  const float dwm_dwi = fabsf(dot_i) / safe_denom;
  const float pdf_t = p_transmit / safe_total * vd * dwm_dwi;
  const float pdf = t.reflect_case ? pdf_r : pdf_t;
  return (t.invalid || p_total == 0.0f || denom == 0.0f) ? 0.0f : pdf;
}

// bsdf.py::_ts_eval_from (one channel: the twin's three are equal)
__device__ float ts_eval_from(const TsTerms& t, V3 wo, V3 wi, float ax,
                              float ay) {
  const float g = rdiv(1.0f, t.lam_o + 1.0f + tr_lambda(wi, ax, ay));
  const float denom_r = fabsf(wo.z * 4.0f * wi.z);
  const float safe_r = denom_r == 0.0f ? 1.0f : denom_r;
  const float brdf = t.d * t.F * g / safe_r;
  const float dot_i = dot(wi, t.wm), dot_o = dot(wo, t.wm);
  const float k = dot_i + dot_o / t.eta_wm;
  const float denom_t = wi.z * wo.z * (k * k);
  const float safe_t = denom_t == 0.0f ? 1.0f : denom_t;
  const float btdf = t.d * (1.0f - t.F) * g *
                     fabsf(dot_i * dot_o / safe_t) / (t.eta_wm * t.eta_wm);
  const float f = t.reflect_case ? brdf : btdf;
  return (t.invalid || (denom_r == 0.0f && t.reflect_case)) ? 0.0f : f;
}

// bsdf.py::ts_eval_pdf
template <int ALLOWED>
__device__ EvalPdf ts_eval_pdf(V3 wo, V3 wi, float eta, float ax, float ay) {
  const TsTerms t = ts_terms(wo, wi, eta, ax, ay);
  return {ts_eval_from(t, wo, wi, ax, ay), ts_pdf_from<ALLOWED>(t, wo, wi)};
}

// bsdf.py::ts_sample
template <int ALLOWED>
__device__ TopSample ts_sample(V3 wo, float eta, float ax, float ay,
                               float u0, float u1, float u) {
  const V3 wm = tr_sample_wm(wo, ax, ay, u0, u1);
  const float R = fresnel_dielectric(dot(wo, wm), eta);
  const float T = 1.0f - R;
  const float p_reflect = (ALLOWED & REFLECTION) ? R : 0.0f;
  const float p_transmit = (ALLOWED & TRANSMISSION) ? T : 0.0f;
  const float p_total = p_reflect + p_transmit;
  const float safe_total = p_total == 0.0f ? 1.0f : p_total;
  const bool choose_reflect = u * safe_total < p_reflect;
  V3 wi;
  bool null;
  if (choose_reflect) {
    wi = reflect_z(wo, wm);
    null = wo.z * wi.z < 0.0f;
  } else {
    bool tir;
    wi = refract(eta, wo, wm, tir);
    null = wo.z * wi.z > 0.0f || wi.z == 0.0f || tir;
  }
  null = null || p_total == 0.0f;
  const EvalPdf e = ts_eval_pdf<ALLOWED>(wo, wi, eta, ax, ay);
  return {wi, e.f, e.pdf,
          choose_reflect ? NONSPECULAR_REFLECTION : NONSPECULAR_TRANSMISSION,
          !null && e.pdf > 0.0f};
}

// bsdf.py::smooth_dielectric_sample
template <int ALLOWED>
__device__ TopSample smooth_dielectric_sample(float eta, V3 wo, float u) {
  const float R = fresnel_dielectric(wo.z, eta);
  const float T = 1.0f - R;
  const float p_reflect = (ALLOWED & SPECULAR_REFLECTION) ? R : 0.0f;
  const float p_transmit = (ALLOWED & SPECULAR_TRANSMISSION) ? T : 0.0f;
  const float p_total = p_reflect + p_transmit;
  const float safe_total = p_total == 0.0f ? 1.0f : p_total;
  if (u * safe_total < p_reflect) {
    const float cos_r = fabsf(wo.z);
    const float pdf = R / safe_total;
    return {{-wo.x, -wo.y, wo.z}, R / (cos_r == 0.0f ? 1.0f : cos_r), pdf,
            SPECULAR_REFLECTION, p_total > 0.0f && pdf > 0.0f};
  }
  bool tir;
  const V3 wi = refract(eta, wo, {0.0f, 0.0f, 1.0f}, tir);
  const float eta_corr = wo.z < 0.0f ? rdiv(1.0f, eta) : eta;
  const float cos_t = fabsf(wi.z);
  const float f = T / (cos_t == 0.0f ? 1.0f : cos_t) / (eta_corr * eta_corr);
  const float pdf = T / safe_total;
  return {wi, f, pdf, SPECULAR_TRANSMISSION,
          p_total > 0.0f && pdf > 0.0f && !tir};
}

// bsdf.py::diffuse_sample (with rng.py::sample_cosine_hemisphere)
__device__ BaseSample diffuse_sample(V3 albedo, float u0, float u1) {
  const Disk d = sample_unit_disk(u0, u1);
  const float z = sqrtf(clamp_min(1.0f - d.x * d.x - d.y * d.y, 0.0f));
  const float pdf = z * kInvPi;
  return {{d.x, d.y, z}, scale(albedo, kInvPi), pdf, pdf > 0.0f};
}

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

}  // namespace
