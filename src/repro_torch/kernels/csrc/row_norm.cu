// Row-wise norms with one block per row:
//   LayerNorm (RMS = false): out[T, D] = ((x - mean) * rsqrt(var + eps) *
//     scale + bias).to(T), mean and population variance over each row in
//     float32 — the eager `layer_norm` of the LayerNorm configs
//     (models/layers.py), with the raw `scale` (not 1 + scale);
//   RMSNorm (RMS = true): out[T, D] = (x * rsqrt(mean(x^2) + eps) *
//     (1 + scale)).to(T) in float32 — the eager `rms_norm`, for the
//     RMSNorm that a plan does not fold into a kernel (the MoE family's
//     ln2 in front of the router and the experts).
//
// Not the port of a TPU kernel: the reference leaves these norms to XLA.
// It exists so that a row's bits do not depend on how many rows share the
// call (row invariance): a speculative verify dispatch of slots x W rows
// must give each row exactly what a decode step of slots rows gives it, and
// PyTorch's own norms pick their reductions by shape.  One block per row
// reduces in a fixed order (each thread sums a fixed strided subset, warps
// by xor shuffles, then warp 0's partials in warp order), so the result is
// row-invariant by construction; LayerNorm takes two passes (mean, then the
// squared deviations), as the eager `var`.
// What bounds it: the bytes of x and out (memory bound); rows are short (D
// = 1024 for gpt2, 1536 for granite-3b) and read from L2 on the later
// passes.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;

// Sum over the block in a fixed order; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();                 // red free from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NWARP; ++i) total += red[i];
  return total;
}

template <typename T, bool RMS>
__global__ void __launch_bounds__(NT)
row_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ bias, T* __restrict__ out, int d,
                float eps) {
  __shared__ float red[NWARP];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  if constexpr (RMS) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < d; k += NT) {
      const float v = to_f(xr[k]);
      ss += v * v;
    }
    const float rstd = rsqrtf(block_sum(ss, red) / (float)d + eps);
    for (int k = threadIdx.x; k < d; k += NT)
      orow[k] = from_f<T>(to_f(xr[k]) * rstd * (1.f + to_f(scale[k])));
    return;
  }
  float s = 0.f;
  for (int k = threadIdx.x; k < d; k += NT) s += to_f(xr[k]);
  const float mean = block_sum(s, red) / (float)d;
  float ss = 0.f;
  for (int k = threadIdx.x; k < d; k += NT) {
    const float dv = to_f(xr[k]) - mean;
    ss += dv * dv;
  }
  const float var = block_sum(ss, red) / (float)d;
  const float rstd = rsqrtf(var + eps);
  for (int k = threadIdx.x; k < d; k += NT) {
    const float y = (to_f(xr[k]) - mean) * rstd;
    orow[k] = from_f<T>(y * to_f(scale[k]) + to_f(bias[k]));
  }
}

template <typename T, bool RMS>
int launch(const void* x, const void* scale, const void* bias, void* out,
           int t, int d, float eps, void* stream) {
  if (t < 1 || d < 1) return (int)cudaErrorInvalidValue;
  row_norm_kernel<T, RMS><<<t, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(out), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_layer_norm_rows_f32(const void* x, const void* scale,
                                         const void* bias, void* out, int t,
                                         int d, float eps, void* stream) {
  return launch<float, false>(x, scale, bias, out, t, d, eps, stream);
}

extern "C" int repro_layer_norm_rows_bf16(const void* x, const void* scale,
                                          const void* bias, void* out, int t,
                                          int d, float eps, void* stream) {
  return launch<__nv_bfloat16, false>(x, scale, bias, out, t, d, eps, stream);
}

// RMSNorm: `bias` is unused (pass the scale).
extern "C" int repro_rms_norm_rows_f32(const void* x, const void* scale,
                                       void* out, int t, int d, float eps,
                                       void* stream) {
  return launch<float, true>(x, scale, scale, out, t, d, eps, stream);
}

extern "C" int repro_rms_norm_rows_bf16(const void* x, const void* scale,
                                        void* out, int t, int d, float eps,
                                        void* stream) {
  return launch<__nv_bfloat16, true>(x, scale, scale, out, t, d, eps,
                                     stream);
}
