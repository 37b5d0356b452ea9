// Helpers shared by the repro_torch CUDA kernels (float / bfloat16 loads,
// int8 / fp8-e4m3 code loads, rounding to the storage type, warp
// reductions, the fixed-order split reduction).  Each kernel source is
// compiled on its own with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a library whose extern "C" entry points return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;   // the reference kernels' mask fill

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// Quantized codes (int8 weights and KV pages, fp8-e4m3 KV pages): every
// code is exactly representable in float32, as the reference's
// `codes.astype(f32)`.
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// Round a float32 value to T and back: the reference's `.astype(x.dtype)`
// on an intermediate that stays on chip.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum `splits` float32 partials [splits, count] in split order, multiply by
// the column's scale when `colscale` is given (count = rows * ncols: the
// int8 weight's per-output-channel scale, applied after the K reduction)
// and round to T.  A fixed order and no atomics: the result is the same
// from run to run.
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    T* __restrict__ out, int splits,
                                    size_t count,
                                    const float* __restrict__ colscale,
                                    int ncols) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * count + i];
  if (colscale != nullptr) s *= colscale[i % ncols];
  out[i] = from_f<T>(s);
}

template <typename T>
inline void split_reduce(const float* part, T* out, int splits, size_t count,
                         cudaStream_t stream,
                         const float* colscale = nullptr, int ncols = 1) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  split_reduce_kernel<T><<<blocks, threads, 0, stream>>>(
      part, out, splits, count, colscale, ncols);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace repro
