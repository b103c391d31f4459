// The BSDF dispatch's kinds other than the coat (diffuse, smooth and rough
// dielectric, smooth and rough conductor) as one kernel a call: sampling
// and evaluation, one thread a lane.
//
// Replaces no TPU kernel: the JAX package leaves the dispatch to XLA
// (tpu_raytracing/ops/bsdf_dispatch.py). Its PyTorch twins,
// ops/bsdf_dispatch.py::bsdf_sample_plain and bsdf_eval_plain, are
// predicated: they compute every kind the scene can hold over every lane
// and select each lane's with torch.where, and copy a host bool to the card
// for each component flag they test, about 7,000 small launches and 63
// syncs a 1-spp rough_dielectric pass. Here a thread reads its lane's kind
// and computes that kind alone, with the whole BSDF in registers. It
// samples every component: the integrator's only `allowed` is
// ALL_COMPONENTS, and the dispatch refuses any other on the card, so no
// component flag is tested. Coated lanes, and lanes of a kind the
// caller's `kinds` leave out, get the null sample and zero f the twins
// start from; the dispatch then runs the coat's own kernel
// (layered_walk.cu) on the coated lanes.
//
// Bit for bit with the plain twins on the card, by the rules at the head
// of bsdf_common.cuh, which holds the pieces this kernel shares with the
// coat's walk. The conductors' complex Fresnel term is ops/complexmath.py
// in the same operations: its zero imaginary parts are real zeros (0 * x
// and 0 - x keep their signs and NaNs), and torch.maximum and minimum pass
// NaN through.
//
// What bounds it on the H100: bytes. A lane reads its kind, four f32
// triples (albedo, eta, kappa, wo), two roughnesses and wi (eval, 84 B with
// f written) or three draws (sample, 105 B with the sample written), and
// computes a few hundred operations at most; a call of 250,000 lanes moves
// at most 26 MB, 8 us at 3.35 TB/s (chip_smoke.py::SHADE_LANE_BYTES). What
// the kernel saves is the host's launches, not device time.

#include "bsdf_common.cuh"

namespace {

// complexmath.py: (re, im) pairs
struct C {
  float re, im;
};

__device__ __forceinline__ C c_mul(C a, C b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ C c_div(C a, C b) {
  float d = b.re * b.re + b.im * b.im;
  d = d == 0.0f ? 1.0f : d;
  return {(a.re * b.re + a.im * b.im) / d, (a.im * b.re - a.re * b.im) / d};
}
__device__ __forceinline__ C c_add(C a, C b) {
  return {a.re + b.re, a.im + b.im};
}
__device__ __forceinline__ C c_sub(C a, C b) {
  return {a.re - b.re, a.im - b.im};
}
__device__ __forceinline__ C c_scale(C a, float s) {
  return {a.re * s, a.im * s};
}
__device__ __forceinline__ float c_abs2(C a) {
  return a.re * a.re + a.im * a.im;
}

// torch.maximum and torch.minimum: NaN passes
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// complexmath.py::_hypot
__device__ float hypot_legs(float x, float y) {
  x = fabsf(x);
  y = fabsf(y);
  const bool inf = isinf(x) || isinf(y);
  const float hi = maximum(x, y), lo = minimum(x, y);
  const bool zero = hi == 0.0f;
  const float q = lo / (zero ? 1.0f : hi);
  float h = hi * sqrtf(q * q + 1.0f);
  h = zero ? hi : h;
  return inf ? __int_as_float(0x7f800000) : h;  // +inf
}

// complexmath.py::c_sqrt
__device__ C c_sqrt(C a) {
  const float mag = hypot_legs(a.re, a.im);
  const float sr = sqrtf(clamp_min((mag + a.re) * 0.5f, 0.0f));
  const float si_mag = sqrtf(clamp_min((mag - a.re) * 0.5f, 0.0f));
  return {sr, a.im < 0.0f ? -si_mag : si_mag};
}

// complexmath.py::fresnel_complex
__device__ float fresnel_complex(float cos_i, float eta_re, float eta_im) {
  const C eta = {eta_re, eta_im};
  const float sin2_i = 1.0f - cos_i * cos_i;
  const C eta2 = c_mul(eta, eta);
  const C sin2_t = c_div({sin2_i, 0.0f}, eta2);
  const C cos2_t = c_sub({1.0f, 0.0f}, sin2_t);
  const C cos_t = c_sqrt(cos2_t);
  const C eta_cos_i = c_scale(eta, cos_i);
  const C cos_i_c = {cos_i, 0.0f};
  const C r_parl = c_div(c_sub(eta_cos_i, cos_t), c_add(eta_cos_i, cos_t));
  const C eta_cos_t = c_mul(eta, cos_t);
  const C r_perp =
      c_div(c_sub(cos_i_c, eta_cos_t), c_add(cos_i_c, eta_cos_t));
  return (c_abs2(r_parl) + c_abs2(r_perp)) * 0.5f;
}

// bsdf.py::fresnel_complex_rgb
__device__ V3 fresnel_complex_rgb(float cos_i, V3 eta, V3 kappa) {
  return {fresnel_complex(cos_i, eta.x, kappa.x),
          fresnel_complex(cos_i, eta.y, kappa.y),
          fresnel_complex(cos_i, eta.z, kappa.z)};
}

// a lane's material, as the dispatch hands it over
struct Lane {
  int kind;
  V3 albedo, eta, kappa;  // eta.x is a dielectric's index
  float ax, ay;
};

struct Sample {
  V3 wi, f;
  float pdf;
  int component;
  bool valid;
};

__device__ __forceinline__ Sample null_sample() {
  return {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, 0, false};
}
__device__ __forceinline__ Sample from_top(const TopSample& s) {
  return {s.wi, splat(s.f), s.pdf, s.component, s.valid};
}

// bsdf.py::_ts_refl_halfvector: wm, and whether wo + wi is zero
struct Half {
  V3 wm;
  bool degenerate;
};
__device__ Half refl_halfvector(V3 wo, V3 wi) {
  const V3 h = add(wo, wi);
  const bool degenerate = h.x == 0.0f && h.y == 0.0f && h.z == 0.0f;
  return {normalize(degenerate ? V3{1.0f, 1.0f, 1.0f} : h), degenerate};
}

// bsdf.py::ts_refl_pdf (with tr_visible_distribution and tr_g1)
__device__ float ts_refl_pdf(V3 wo, V3 wi, float ax, float ay) {
  const Half h = refl_halfvector(wo, wi);
  const V3 wm = h.wm.z < 0.0f ? neg(h.wm) : h.wm;
  const float safe_dot = clamp_min(fabsf(dot(wo, wm)), kMinDot);
  const float cos_o = fabsf(wo.z);
  const float safe_o = cos_o == 0.0f ? 1.0f : cos_o;
  const float g1 = rdiv(1.0f, tr_lambda(wo, ax, ay) + 1.0f);
  const float vd = g1 / safe_o * tr_distribution(wm, ax, ay) *
                   fabsf(dot(wo, wm));
  const float pdf = vd / (safe_dot * 4.0f);
  return h.degenerate ? 0.0f : pdf;
}

// bsdf.py::ts_refl_eval (with tr_g)
__device__ V3 ts_refl_eval(V3 wo, V3 wi, V3 eta, V3 kappa, float ax,
                           float ay) {
  const Half h = refl_halfvector(wo, wi);
  const V3 fres = fresnel_complex_rgb(fabsf(dot(h.wm, wi)), eta, kappa);
  const float denom = wo.z * 4.0f * wi.z;
  const float safe_denom = denom == 0.0f ? 1.0f : denom;
  const float g =
      rdiv(1.0f, tr_lambda(wo, ax, ay) + 1.0f + tr_lambda(wi, ax, ay));
  const float s = tr_distribution(h.wm, ax, ay) * g / safe_denom;
  if (h.degenerate || denom <= 0.0f) return {0.0f, 0.0f, 0.0f};
  return scale(fres, s);
}

// bsdf.py::ts_refl_sample
__device__ Sample ts_refl_sample(V3 wo, V3 eta, V3 kappa, float ax, float ay,
                                 float u0, float u1) {
  const V3 wm = tr_sample_wm(wo, ax, ay, u0, u1);
  const V3 wi = reflect_z(wo, wm);
  const bool below = wo.z * wi.z < 0.0f;
  const float pdf = ts_refl_pdf(wo, wi, ax, ay);
  return {wi, ts_refl_eval(wo, wi, eta, kappa, ax, ay), pdf,
          NONSPECULAR_REFLECTION, !below && pdf > 0.0f};
}

// bsdf.py::smooth_conductor_sample
__device__ Sample smooth_conductor_sample(V3 eta, V3 kappa, V3 wo) {
  const float cos_o = wo.z;
  const float safe_cos = cos_o == 0.0f ? 1.0f : cos_o;
  return {{-wo.x, -wo.y, wo.z},
          divide(fresnel_complex_rgb(cos_o, eta, kappa), safe_cos), 1.0f,
          SPECULAR_REFLECTION, cos_o > 0.0f};
}

__device__ __forceinline__ bool in_kinds(int kinds, int kind) {
  return kind >= 0 && kind < 31 && ((kinds >> kind) & 1);
}

// bsdf_dispatch.py::bsdf_sample_plain, with allowed = ALL_COMPONENTS (the
// one value the integrator passes), for one lane of another kind than the
// coat's; u = (u2[0], u2[1], u1)
__device__ Sample sample_lane(const Lane& m, V3 wo, float u0, float u1,
                              float u, int kinds) {
  if (!in_kinds(kinds, m.kind)) return null_sample();
  switch (m.kind) {
    case MAT_DIFFUSE: {
      const BaseSample b = diffuse_sample(m.albedo, u0, u1);
      return {b.wi, b.f, b.pdf, NONSPECULAR_REFLECTION, b.valid};
    }
    case MAT_SMOOTH_DIELECTRIC:
      return from_top(smooth_dielectric_sample<SPECULAR>(m.eta.x, wo, u));
    case MAT_SMOOTH_CONDUCTOR:
      return smooth_conductor_sample(m.eta, m.kappa, wo);
    case MAT_ROUGH_CONDUCTOR:
      return ts_refl_sample(wo, m.eta, m.kappa, m.ax, m.ay, u0, u1);
    case MAT_ROUGH_DIELECTRIC:
      return from_top(ts_sample<ALL_COMPONENTS>(wo, m.eta.x, m.ax, m.ay, u0,
                                                u1, u));
  }
  return null_sample();  // the coat's lanes: its own kernel writes them
}

// bsdf_dispatch.py::bsdf_eval_plain for one lane of another kind than the
// coat's; the smooth (delta) kinds evaluate to zero
__device__ V3 eval_lane(const Lane& m, V3 wo, V3 wi, int kinds) {
  if (!in_kinds(kinds, m.kind)) return {0.0f, 0.0f, 0.0f};
  switch (m.kind) {
    case MAT_DIFFUSE:
      return wo.z * wi.z >= 0.0f ? scale(m.albedo, kInvPi)
                                 : V3{0.0f, 0.0f, 0.0f};
    case MAT_ROUGH_CONDUCTOR:
      return ts_refl_eval(wo, wi, m.eta, m.kappa, m.ax, m.ay);
    case MAT_ROUGH_DIELECTRIC:
      return splat(ts_eval_from(ts_terms(wo, wi, m.eta.x, m.ax, m.ay), wo,
                                wi, m.ax, m.ay));
  }
  return {0.0f, 0.0f, 0.0f};
}

// ---------------------------------------------------------------- kernels

struct Lanes {
  const int* kind;        // (n,)
  const float* albedo;    // (n, 3)
  const float* eta;       // (n, 3)
  const float* kappa;     // (n, 3)
  const float* alpha_x;   // (n,)
  const float* alpha_y;   // (n,)
  const float* wo;        // (n, 3)
  int kinds;              // bit k set: kind k can occur
  int n;
};

__device__ __forceinline__ Lane load_lane(const Lanes& a, int i) {
  return {a.kind[i], load3(a.albedo, i), load3(a.eta, i), load3(a.kappa, i),
          a.alpha_x[i], a.alpha_y[i]};
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bsdf_eval_kernel(Lanes a, const float* __restrict__ wi,
                     float* __restrict__ f_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  store3(f_out, i, eval_lane(load_lane(a, i), load3(a.wo, i), load3(wi, i),
                             a.kinds));
}

__global__ void __launch_bounds__(kThreads)
    bsdf_sample_kernel(Lanes a, const float* __restrict__ u2,
                       const float* __restrict__ u1,
                       float* __restrict__ wi_out, float* __restrict__ f_out,
                       float* __restrict__ pdf_out,
                       int* __restrict__ comp_out,
                       bool* __restrict__ valid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const Sample s = sample_lane(load_lane(a, i), load3(a.wo, i), u2[2 * i],
                               u2[2 * i + 1], u1[i], a.kinds);
  store3(wi_out, i, s.wi);
  store3(f_out, i, s.f);
  pdf_out[i] = s.pdf;
  comp_out[i] = s.component;
  valid_out[i] = s.valid;
}

unsigned grid_of(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int tpu_rt_bsdf_eval(const int* kind, const float* albedo,
                                const float* eta, const float* kappa,
                                const float* alpha_x, const float* alpha_y,
                                const float* wo, const float* wi,
                                float* f_out, int kinds, int n,
                                void* stream) {
  if (n <= 0) return 0;
  const Lanes a{kind, albedo, eta, kappa, alpha_x, alpha_y, wo, kinds, n};
  bsdf_eval_kernel<<<grid_of(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, wi, f_out);
  return (int)cudaGetLastError();
}

extern "C" int tpu_rt_bsdf_sample(const int* kind, const float* albedo,
                                  const float* eta, const float* kappa,
                                  const float* alpha_x, const float* alpha_y,
                                  const float* wo, const float* u2,
                                  const float* u1, float* wi_out,
                                  float* f_out, float* pdf_out, int* comp_out,
                                  bool* valid_out, int kinds, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  const Lanes a{kind, albedo, eta, kappa, alpha_x, alpha_y, wo, kinds, n};
  bsdf_sample_kernel<<<grid_of(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, u2, u1, wi_out, f_out, pdf_out, comp_out, valid_out);
  return (int)cudaGetLastError();
}
