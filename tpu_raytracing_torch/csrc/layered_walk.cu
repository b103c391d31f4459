// The coat's layered walk (CoatedDiffuse: a dielectric coat over a diffuse
// base, an optional homogeneous medium between) as one kernel a call.
//
// Replaces no TPU kernel: the JAX package leaves this walk to XLA
// (tpu_raytracing/ops/layered.py, fori_loops over 8 samples and 8 depths).
// Its PyTorch twins, ops/layered.py::layered_eval_plain and
// layered_sample_plain, run the same loops over masked tensors: a few
// hundred small launches a depth and a host read a depth to end the loop,
// 921,072 launches and 8,440 syncs a 1-spp bunny pass. Here one thread
// takes one gathered coated lane and keeps the whole walk in registers:
// eval 8 samples of up to 8 depths, sample up to 8 depths. Every draw is
// a stateless hash of (stream, [sample,] dimension), so a lane computes
// only the case it takes (smooth or rough coat; scatter, top or bottom;
// Russian roulette) where the plain twins compute every case and select,
// and leaves its loop when it stops walking.
//
// Bit for bit with the plain twins on the card. The eval stream is seeded
// from the bits of (wo, wi), so one ulp in a sampled direction draws the
// next bounce's whole coat estimate anew. So each operation here and in
// the BSDF pieces it shares with bsdf_kinds.cu (bsdf_common.cuh, whose
// head lists PyTorch's f32 forms) is the operation PyTorch's CUDA kernel
// makes, in the plain twins' order; besides those, expf and log1pf are
// torch.exp and log1p.
// The plain twins add a masked 0.0 to f for every case a lane does not
// take, and go on adding while any lane walks. f is never -0 (it starts at
// 8 * ts_eval >= +0 and adds products of factors >= +0) and a NaN stays
// NaN, so adding +0.0 changes no bit, and those adds have no counterpart
// here.
//
// What bounds it on the H100: neither bytes (about 100 B a lane) nor f32
// issue at the card's rate (a few thousand operations a lane, under 0.1 ms
// for the bunny's largest call at 67 TFLOP/s) but latency: each thread's
// walk is one long dependent chain of divides, square roots and
// transcendentals, and lanes of a warp diverge on their cases and depths.
// The design keeps the work a lane takes to the one case it draws, keeps
// its state in registers, and has enough lanes in flight (128 a block, a
// call's 10^4-10^5 lanes) to hide the chain's latency.

#include "bsdf_common.cuh"

namespace {

constexpr int N_SAMPLES = 8;   // layered.py::N_SAMPLES
constexpr int MAX_DEPTH = 8;   // layered.py::MAX_DEPTH
// a depth's draws: DIM_BASE + depth * DIM_STRIDE + one of the D_* offsets
constexpr int DIM_BASE = 8;
constexpr int DIM_STRIDE = 8;
constexpr int D_RR = 0;        // Russian roulette
constexpr int D_DZ = 1;        // the medium's free flight
constexpr int D_PHASE = 2;     // the phase sample's u2 (2, 3)
constexpr int D_IFACE = 4;     // the interface sample's u2 (4, 5) and u1 (6)
// eval: a sample's draws before its walk, the coat's u2 at DIM + 0, 1 and
// its u1 at DIM + 2, entering along wo and leaving along wi
constexpr int DIM_ENTER = 0;
constexpr int DIM_EXIT = 3;
// sample: the coat's draws entering along wo
constexpr int DIM_SAMPLE_ENTER = 0;
constexpr int RR_FROM_DEPTH = 4;  // roulette from depth 4 on (depth > 3)

// f32 constants, each as PyTorch rounds the Python float at its use
constexpr float kInv2Pi = 0x1.45f306p-3f;   // 1.0 / (2.0 * _PI)
constexpr float kHgNorm = 0x1.45f306p-4f;   // (0.25 / math.pi) * (1 - g g)
constexpr float kTwoG = 0.0f;               // 2.0 * G_HG (layered.G_HG = 0)
constexpr float kUMax = 0x1.fffffp-1f;      // 0.9999995, the flight's u cap
constexpr float kNearPole = 0x1.99999ap-1f; // 0.8, make_orthonormal_basis
constexpr float kRR = 0.25f;                // roulette's threshold
constexpr uint32_t kHashBasis = 0x811C9DC5u;

// rng.py: hash_u32, one word at a time, and uniform_from_bits
__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * 0x01000193u;
  return h ^ (h >> 15);
}
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// a lane's draws: u(d) = uniform_from_bits(hash_u32(*prefix words, d))
struct Stream {
  uint32_t prefix;  // the hash state after the words before d
  __device__ __forceinline__ float u(int d) const {
    const uint32_t bits = fmix32(hash_step(prefix, (uint32_t)d));
    return (float)(bits >> 8) * 0x1p-24f;
  }
};

// rng.py
__device__ __forceinline__ float sample_exponential(float u, float a) {
  return -log1pf(-u) / a;
}
__device__ __forceinline__ float power_heuristic(float pa, float pb) {
  const float wa = pa * pa, wb = pb * pb;
  return wa / (wa + wb);
}
// ------------------------------------------------------------- the coat

struct Coat {
  V3 albedo;     // the diffuse base
  V3 medium;     // the medium's albedo (coat_albedo)
  float eta, ax, ay, thickness;
  bool smooth;      // top_kind == MAT_SMOOTH_DIELECTRIC
  bool has_medium;  // any(coat_albedo != 0)
};

// layered.py::_top_sample: the coat's sample, drawing u2 at dim, dim + 1
// and u1 at dim + 2 (the smooth coat reads NONSPECULAR flags as their
// specular twins and draws only u1)
template <int ALLOWED>
__device__ TopSample top_sample(const Coat& c, V3 w, const Stream& st,
                                int dim) {
  if (c.smooth) {
    constexpr int S = ((ALLOWED & REFLECTION) ? SPECULAR_REFLECTION : 0) |
                      ((ALLOWED & TRANSMISSION) ? SPECULAR_TRANSMISSION : 0);
    return smooth_dielectric_sample<S>(c.eta, w, st.u(dim + 2));
  }
  return ts_sample<ALLOWED>(w, c.eta, c.ax, c.ay, st.u(dim), st.u(dim + 1),
                            st.u(dim + 2));
}

// layered.py::hg_p_cos with g = G_HG = 0
__device__ __forceinline__ float hg_p_cos(float cos_theta) {
  const float denom = kTwoG * cos_theta + 1.0f;
  return rdiv(kHgNorm, denom * sqrtf(denom));
}

struct Phase {
  V3 wi;
  float p;  // the phase function's value, also its pdf
};

// layered.py::hg_sample, its |g| < 1e-3 branch
__device__ Phase hg_sample(V3 wo, float u0, float u1) {
  const float cos_theta = 1.0f - u0 * 2.0f;
  const float phi = u1 * kTwoPi;
  const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta,
                                          0.0f));
  // linalg.py::make_orthonormal_basis
  const bool near_pole = fabsf(wo.z) < kNearPole;
  const V3 a = {0.0f, near_pole ? 0.0f : 1.0f, near_pole ? 1.0f : 0.0f};
  const V3 x = normalize(cross(a, wo));
  const V3 y = cross(wo, x);
  const float cx = cosf(phi) * sin_theta, cy = sinf(phi) * sin_theta;
  return {{cx * x.x + cy * y.x + cos_theta * wo.x,
           cx * x.y + cy * y.y + cos_theta * wo.y,
           cx * x.z + cy * y.z + cos_theta * wo.z},
          hg_p_cos(cos_theta)};
}

// layered.py::_tr_layer
__device__ __forceinline__ float tr_layer(float dz, V3 w) {
  const float wz = w.z == 0.0f ? 1.0f : w.z;
  return expf(-fabsf(dz / wz));
}

__device__ __forceinline__ uint32_t f32_bits(float x) {
  return __float_as_uint(x);
}

// ------------------------------------------------------------ evaluation

// layered.py::layered_eval_plain for one lane; `steps` counts the depths
// the lane's walks begin
__device__ V3 eval_lane(const Coat& c, V3 wo, V3 wi, int& steps) {
  if (wo.z < 0.0f) {
    wo = neg(wo);
    wi = neg(wi);
  }
  if (!(wi.z > 0.0f)) return {0.0f, 0.0f, 0.0f};  // the opaque base

  const float top = c.smooth ? 0.0f
                             : ts_eval_from(ts_terms(wo, wi, c.eta, c.ax,
                                                     c.ay),
                                            wo, wi, c.ax, c.ay);
  V3 f = splat(top * (float)N_SAMPLES);
  uint32_t h = kHashBasis;
  h = hash_step(h, f32_bits(wo.x));
  h = hash_step(h, f32_bits(wo.y));
  h = hash_step(h, f32_bits(wo.z));
  h = hash_step(h, f32_bits(wi.x));
  h = hash_step(h, f32_bits(wi.y));
  h = hash_step(h, f32_bits(wi.z));
  const uint32_t after_base = hash_step(kHashBasis, fmix32(h));

  for (int s = 0; s < N_SAMPLES; ++s) {
    const Stream st{hash_step(after_base, (uint32_t)s)};
    const TopSample enter = top_sample<TRANSMISSION>(c, wo, st, DIM_ENTER);
    if (!enter.valid) continue;
    const TopSample ex = top_sample<TRANSMISSION>(c, wi, st, DIM_EXIT);
    if (!ex.valid) continue;
    const float safe_exit_pdf = ex.pdf <= 0.0f ? 1.0f : ex.pdf;
    V3 beta = splat(ex.f * fabsf(ex.wi.z) / safe_exit_pdf);
    V3 w = enter.wi;
    float z = c.thickness;

    for (int depth = 0; depth < MAX_DEPTH; ++depth) {
      const int d0 = DIM_BASE + depth * DIM_STRIDE;
      ++steps;
      if (depth >= RR_FROM_DEPTH) {
        const float beta_max = amax(beta);
        if (beta_max < kRR) {
          const float q = clamp_min(beta_max, 0.0f);
          if (st.u(d0 + D_RR) < q) break;
          const float keep = 1.0f - q;
          beta = {beta.x / keep, beta.y / keep, beta.z / keep};
        }
      }

      // medium transit
      const float wz = w.z == 0.0f ? 1.0f : fabsf(w.z);
      const float dz = sample_exponential(clamp_max(st.u(d0 + D_DZ), kUMax),
                                          rdiv(1.0f, wz));
      const float zp = w.z > 0.0f ? z + dz : z - dz;

      if (c.has_medium && zp > 0.0f && zp < c.thickness) {
        // scattering: NEE toward the exit, then the phase sample
        const float hgv = hg_p_cos(dot(neg(w), neg(ex.wi)));
        const float wt = c.smooth ? 1.0f : power_heuristic(ex.pdf, hgv);
        const float tr1 = tr_layer(zp - c.thickness, ex.wi);
        const V3 c1 = divide(
            scale(scale(scale(scale(mul(beta, c.medium), hgv), wt), tr1),
                  ex.f),
            safe_exit_pdf);
        f = add(f, c1);

        const Phase ph = hg_sample(neg(w), st.u(d0 + D_PHASE),
                                   st.u(d0 + D_PHASE + 1));
        const float safe_ph_pdf = ph.p == 0.0f ? 1.0f : ph.p;
        const V3 beta_sc = scale(mul(beta, c.medium), ph.p / safe_ph_pdf);
        V3 c2 = splat(0.0f);
        if (!c.smooth && zp < c.thickness && ph.wi.z > 0.0f) {
          const EvalPdf e = ts_eval_pdf<TRANSMISSION>(neg(ph.wi), wi, c.eta,
                                                      c.ax, c.ay);
          if (e.f != 0.0f) {
            const float wt2 = power_heuristic(ph.p, e.pdf);
            const float tr2 = tr_layer(zp - c.thickness, ph.wi);
            c2 = scale(scale(scale(beta_sc, tr2), e.f), wt2);
          }
        }
        f = add(f, c2);
        w = ph.wi;
        beta = beta_sc;
        z = zp;
        continue;
      }

      // no scattering: advance to an interface
      const float z_transit =
          c.has_medium ? minimum(clamp_min(zp, 0.0f), c.thickness)
                       : (z == c.thickness ? 0.0f : c.thickness);
      const V3 beta_transit =
          c.has_medium ? beta : scale(beta, tr_layer(c.thickness, w));

      if (z_transit == c.thickness) {
        // the top: reflect back down
        const TopSample t = top_sample<REFLECTION>(c, neg(w), st,
                                                   d0 + D_IFACE);
        const float safe_top_pdf = t.pdf <= 0.0f ? 1.0f : t.pdf;
        if (!t.valid) break;
        beta = divide(scale(scale(beta_transit, t.f), fabsf(t.wi.z)),
                      safe_top_pdf);
        w = t.wi;
        z = z_transit;
        continue;
      }

      // the diffuse bottom: NEE toward the exit, then a cosine sample up
      const V3 nw = neg(w), nexit = neg(ex.wi);
      const V3 bot_f1 = nw.z * nexit.z >= 0.0f ? scale(c.albedo, kInvPi)
                                               : splat(0.0f);
      const float bot_pdf1 = nw.z * nexit.z > 0.0f ? kInv2Pi : 0.0f;
      const float wt3 = power_heuristic(ex.pdf, bot_pdf1);
      const float tr3 = tr_layer(c.thickness, ex.wi);
      const V3 c3 = divide(
          scale(scale(scale(scale(mul(beta_transit, bot_f1),
                                  fabsf(ex.wi.z)),
                            wt3),
                      tr3),
                ex.f),
          safe_exit_pdf);
      f = add(f, c3);

      const BaseSample b = diffuse_sample(c.albedo, st.u(d0 + D_IFACE),
                                          st.u(d0 + D_IFACE + 1));
      const float safe_bot_pdf = b.pdf <= 0.0f ? 1.0f : b.pdf;
      const V3 beta_bot = divide(scale(mul(beta_transit, b.f),
                                       fabsf(b.wi.z)),
                                 safe_bot_pdf);
      V3 c4 = splat(0.0f);
      if (b.valid && !c.smooth) {
        const EvalPdf e = ts_eval_pdf<ALL_COMPONENTS>(neg(b.wi), wi, c.eta,
                                                      c.ax, c.ay);
        if (e.f != 0.0f) {
          const float wt4 = power_heuristic(b.pdf, e.pdf);
          const float tr4 = tr_layer(c.thickness, b.wi);
          c4 = scale(scale(scale(beta_bot, tr4), e.f), wt4);
        }
      }
      f = add(f, c4);
      if (!b.valid) break;
      w = b.wi;
      beta = beta_bot;
      z = z_transit;
    }
  }
  return scale(f, 1.0f / (float)N_SAMPLES);
}

// -------------------------------------------------------------- sampling

struct Out {
  V3 wi, f;
  float pdf;
  int component;
  bool valid;
};

// layered.py::layered_sample_plain for one lane
__device__ Out sample_lane(const Coat& c, V3 wo, uint32_t draw_base,
                           int& steps) {
  const bool flip = wo.z < 0.0f;
  const V3 wo_f = flip ? neg(wo) : wo;
  const Stream st{hash_step(kHashBasis, draw_base)};
  const TopSample enter = top_sample<ALL_COMPONENTS>(c, wo_f, st,
                                                     DIM_SAMPLE_ENTER);
  if (enter.component & REFLECTION) {  // the coat's reflection
    return {flip ? neg(enter.wi) : enter.wi, splat(enter.f), enter.pdf,
            enter.component, enter.valid};
  }
  const Out null_sample = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, 0,
                           false};
  if (!enter.valid) return null_sample;

  V3 w = enter.wi;
  V3 f = splat(enter.f * fabsf(enter.wi.z));
  float pdf = enter.pdf;
  float z = c.thickness;
  bool specular_path = (enter.component & SPECULAR) != 0;

  for (int depth = 0; depth < MAX_DEPTH; ++depth) {
    const int d0 = DIM_BASE + depth * DIM_STRIDE;
    ++steps;
    if (depth >= RR_FROM_DEPTH) {
      const float safe_pdf = pdf == 0.0f ? 1.0f : pdf;
      const float rr_beta = amax(f) / safe_pdf;
      if (rr_beta < kRR) {
        const float q = clamp_min(1.0f - rr_beta, 0.0f);
        if (st.u(d0 + D_RR) < q) break;
        pdf = pdf * (1.0f - q);
      }
    }
    if (w.z == 0.0f) break;

    // a medium event?
    const float wz = w.z == 0.0f ? 1.0f : fabsf(w.z);
    const float dz = sample_exponential(clamp_max(st.u(d0 + D_DZ), kUMax),
                                        rdiv(1.0f, wz));
    const float zp = w.z > 0.0f ? z + dz : z - dz;
    if (c.has_medium && zp > 0.0f && zp < c.thickness) {
      const Phase ph = hg_sample(neg(w), st.u(d0 + D_PHASE),
                                 st.u(d0 + D_PHASE + 1));
      f = scale(mul(f, c.medium), ph.p);
      pdf = pdf * ph.p;
      w = ph.wi;
      specular_path = false;
      z = zp;
      continue;
    }

    // an interface: the top dielectric or the bottom diffuse
    const float z_transit =
        c.has_medium ? minimum(clamp_min(zp, 0.0f), c.thickness)
                     : (z == c.thickness ? 0.0f : c.thickness);
    const V3 f_transit =
        c.has_medium ? f : scale(f, tr_layer(c.thickness, w));
    TopSample i;
    if (z_transit == 0.0f) {
      const BaseSample b = diffuse_sample(c.albedo, st.u(d0 + D_IFACE),
                                          st.u(d0 + D_IFACE + 1));
      i = {b.wi, 0.0f, b.pdf, NONSPECULAR_REFLECTION, b.valid};
      f = mul(f_transit, b.f);
    } else {
      i = top_sample<ALL_COMPONENTS>(c, neg(w), st, d0 + D_IFACE);
      f = scale(f_transit, i.f);
    }
    const float pdf_if = pdf * i.pdf;
    const bool spec_if = specular_path && (i.component & SPECULAR) != 0;
    if (i.valid && (i.component & TRANSMISSION)) {  // the walk escapes
      const bool same_dir = wo_f.z * i.wi.z > 0.0f;
      const int comp =
          same_dir ? (spec_if ? SPECULAR_REFLECTION : NONSPECULAR_REFLECTION)
                   : (spec_if ? SPECULAR_TRANSMISSION
                              : NONSPECULAR_TRANSMISSION);
      return {flip ? neg(i.wi) : i.wi, f, pdf_if, comp, true};
    }
    if (!i.valid) break;
    f = scale(f, fabsf(i.wi.z));
    pdf = pdf_if;
    w = i.wi;
    specular_path = spec_if;
    z = z_transit;
  }
  return null_sample;
}

// ---------------------------------------------------------------- kernels

struct Lanes {
  const float* albedo;       // (n, 3)
  const float* eta;          // (n, 3), [..., 0] read
  const float* alpha_x;      // (n,)
  const float* alpha_y;      // (n,)
  const int* top_kind;       // (n,)
  const float* thickness;    // (n,)
  const float* coat_albedo;  // (n, 3)
  const float* wo;           // (n, 3)
  int* steps;                // (n,) depths begun, or nullptr
  int n;
};

__device__ Coat load_coat(const Lanes& a, int i) {
  Coat c;
  c.albedo = load3(a.albedo, i);
  c.medium = load3(a.coat_albedo, i);
  c.eta = a.eta[3 * i];
  c.ax = a.alpha_x[i];
  c.ay = a.alpha_y[i];
  c.thickness = a.thickness[i];
  c.smooth = a.top_kind[i] == MAT_SMOOTH_DIELECTRIC;
  c.has_medium =
      c.medium.x != 0.0f || c.medium.y != 0.0f || c.medium.z != 0.0f;
  return c;
}

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    layered_eval_kernel(Lanes a, const float* __restrict__ wi,
                        float* __restrict__ f_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  int steps = 0;
  const V3 f = eval_lane(load_coat(a, i), load3(a.wo, i), load3(wi, i),
                         steps);
  store3(f_out, i, f);
  if (a.steps) a.steps[i] = steps;
}

__global__ void __launch_bounds__(kThreads)
    layered_sample_kernel(Lanes a, const long long* __restrict__ draw_base,
                          float* __restrict__ wi_out,
                          float* __restrict__ f_out,
                          float* __restrict__ pdf_out,
                          int* __restrict__ comp_out,
                          bool* __restrict__ valid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  int steps = 0;
  const Out o = sample_lane(load_coat(a, i), load3(a.wo, i),
                            (uint32_t)draw_base[i], steps);
  store3(wi_out, i, o.wi);
  store3(f_out, i, o.f);
  pdf_out[i] = o.pdf;
  comp_out[i] = o.component;
  valid_out[i] = o.valid;
  if (a.steps) a.steps[i] = steps;
}

unsigned grid_of(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int tpu_rt_layered_eval(const float* albedo, const float* eta,
                                   const float* alpha_x,
                                   const float* alpha_y, const int* top_kind,
                                   const float* thickness,
                                   const float* coat_albedo, const float* wo,
                                   const float* wi, float* f_out, int* steps,
                                   int n, void* stream) {
  if (n <= 0) return 0;
  const Lanes a{albedo, eta, alpha_x, alpha_y, top_kind, thickness,
                coat_albedo, wo, steps, n};
  layered_eval_kernel<<<grid_of(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, wi, f_out);
  return (int)cudaGetLastError();
}

extern "C" int tpu_rt_layered_sample(
    const float* albedo, const float* eta, const float* alpha_x,
    const float* alpha_y, const int* top_kind, const float* thickness,
    const float* coat_albedo, const float* wo, const long long* draw_base,
    float* wi_out, float* f_out, float* pdf_out, int* comp_out,
    bool* valid_out, int* steps, int n, void* stream) {
  if (n <= 0) return 0;
  const Lanes a{albedo, eta, alpha_x, alpha_y, top_kind, thickness,
                coat_albedo, wo, steps, n};
  layered_sample_kernel<<<grid_of(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, draw_base, wi_out, f_out, pdf_out, comp_out, valid_out);
  return (int)cudaGetLastError();
}
