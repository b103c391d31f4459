// P4: does elementwise bf16 run at twice the float32 rate?
//
// Replaces the Pallas probe scripts/probe_bf16_vpu.py:56 (the kernel that
// make(dtype) builds). ITERS iterations of a synthetic 3-axis slab update on
// a (16, 128) block:
//
//   box = box + t0 * 1e-7
//   3 times: a = (box - o) * 0.5;  b = (box + o) * 0.5
//            t0 = max(t0, min(a, b));  t1 = min(t1, max(a, b))
//   t0 = t0 * 0.999
//
// from t0 = -1e3, t1 = 1e3; out = float(t0) + float(t1). That is 27
// operations an element an iteration as written and 11 that the function
// needs: the second and third axis passes repeat the first one's a and b,
// and max(max(t0, m), m) = max(t0, m). One kernel, instantiated for float2
// (float32) and __nv_bfloat162 (bf16): the bf16 version computes in packed
// bf16x2 ops (__hadd2, __hsub2, __hmul2, __hmin2, __hmax2), the form in
// which Hopper runs bf16 elementwise work at twice the fp32 instruction
// rate; that rate is the probe's question. Constants are rounded to the
// working type first (in bf16, 0.999 rounds to 1.0), every op rounds to it,
// and the last add is in float32 after converting both, as the JAX
// package's interpret mode does it.
//
// What bounds it on the H100: it runs on one SM by design, as the TPU probe
// runs one block on one core, and each chain's iterations are dependent, so
// the time per iteration is the chain's latency or the SM's issue rate,
// whichever is longer. With 32 warps it is the issue rate: so the loop
// issues the 11 needed operations an element an iteration and little else.
// The body writes them once: the second and third axis passes recompute
// the first pass's a and b, and max(max(t0, m), m) = max(t0, m), min
// likewise, bit for bit (tests/test_torch_probes.py::
// test_bf16_vpu_needs_one_axis_pass), which nvcc found in the three-pass
// form as well. Each is its own operation (no FMA under -fmad=false; no
// rewrite such as min(a, b) = 0.5 min(box - o, box + o), which would make
// the probe price fewer operations than its bound counts). The loop runs
// kUnroll iterations a trip, in order, with a remainder loop, so its
// counter, compare and branch come once in kUnroll iterations. (The first
// port's loop, as written, issued 25 instructions an iteration in float32,
// 22 needed and 3 of loop, and 16 in bf16: 3 of loop and 13 arithmetic,
// the 11 needed and two more min / max that the repeated passes left.)
// In bf16, ptxas joins two iterations' t1 = min(t1, .) into one
// three-input min (VHMNMX.BF16_V2) in 4 of the loop's 8 iterations, so the
// loop issues 84 arithmetic instructions for its 88 operations; float32 has
// no such instruction on sm_90a. kChains<V> chains a thread at 1,024 /
// kChains<V> threads: a float32 chain carries two elements (a float2), a
// bf16 chain one pair. It measures one SM, not the card; the loop's SASS is
// read by probes/bf16_vpu.py::loop_instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;  // iterations a loop trip
// independent chains a thread, by type: float32 issues nearer the SM's
// rate with two (512 threads), bf16 with one (1,024 threads)
template <typename V> constexpr int kChains = 1;
template <> constexpr int kChains<float2> = 2;
template <typename V> constexpr int kThreads = 1024 / kChains<V>;

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}
__device__ __forceinline__ float2 vmin(float2 a, float2 b) {
  return make_float2(fminf(a.x, b.x), fminf(a.y, b.y));
}
__device__ __forceinline__ float2 vmax(float2 a, float2 b) {
  return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
}
__device__ __forceinline__ float2 splat(float2, float x) {
  return make_float2(x, x);
}
__device__ __forceinline__ float2 to_float2(float2 a) { return a; }

__device__ __forceinline__ __nv_bfloat162 add(__nv_bfloat162 a,
                                              __nv_bfloat162 b) {
  return __hadd2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 sub(__nv_bfloat162 a,
                                              __nv_bfloat162 b) {
  return __hsub2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 mul(__nv_bfloat162 a,
                                              __nv_bfloat162 b) {
  return __hmul2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 vmin(__nv_bfloat162 a,
                                               __nv_bfloat162 b) {
  return __hmin2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 vmax(__nv_bfloat162 a,
                                               __nv_bfloat162 b) {
  return __hmax2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 splat(__nv_bfloat162, float x) {
  return __float2bfloat162_rn(x);
}
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 a) {
  return __bfloat1622float2(a);
}

// One iteration of one chain: the 11 needed operations an element.
template <typename V>
__device__ __forceinline__ void step(V& box, const V& o, V& t0, V& t1,
                                     const V& eps, const V& half,
                                     const V& decay) {
  box = add(box, mul(t0, eps));
  const V a = mul(sub(box, o), half);
  const V b = mul(add(box, o), half);
  t0 = vmax(t0, vmin(a, b));
  t1 = vmin(t1, vmax(a, b));
  t0 = mul(t0, decay);
}

template <typename V>
__global__ void __launch_bounds__(kThreads<V>)
    probe_bf16_vpu(const V* __restrict__ box_in, const V* __restrict__ ray_in,
                   float2* __restrict__ out, int iters) {
  const V eps = splat(V{}, 1e-7f), half = splat(V{}, 0.5f),
          decay = splat(V{}, 0.999f);
  constexpr int C = kChains<V>;
  V box[C], o[C], t0[C], t1[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = c * kThreads<V> + threadIdx.x;
    box[c] = box_in[i];
    o[c] = ray_in[i];
    t0[c] = splat(V{}, -1e3f);
    t1[c] = splat(V{}, 1e3f);
  }
  int it = 0;
#pragma unroll 1
  for (; iters - it >= kUnroll; it += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < C; ++c)
        step(box[c], o[c], t0[c], t1[c], eps, half, decay);
  }
#pragma unroll 1
  for (; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      step(box[c], o[c], t0[c], t1[c], eps, half, decay);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float2 f0 = to_float2(t0[c]), f1 = to_float2(t1[c]);
    out[c * kThreads<V> + threadIdx.x] = make_float2(f0.x + f1.x, f0.y + f1.y);
  }
}

}  // namespace

// box, ray: 2,048 elements of float32 (bf16 = 0) or bf16 (bf16 = 1);
// out: 2,048 float32.
extern "C" int tpu_rt_probe_bf16_vpu(const void* box, const void* ray,
                                     float* out, int bf16, int iters,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (iters < 0) return (int)cudaErrorInvalidValue;
  float2* out2 = reinterpret_cast<float2*>(out);
  if (bf16)
    probe_bf16_vpu<__nv_bfloat162><<<1, kThreads<__nv_bfloat162>, 0, stream>>>(
        static_cast<const __nv_bfloat162*>(box),
        static_cast<const __nv_bfloat162*>(ray), out2, iters);
  else
    probe_bf16_vpu<float2><<<1, kThreads<float2>, 0, stream>>>(
        static_cast<const float2*>(box), static_cast<const float2*>(ray),
        out2, iters);
  return (int)cudaGetLastError();
}
