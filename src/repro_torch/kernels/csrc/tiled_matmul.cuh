// Split-K tiled matmul shared by rmsnorm_matmul (K3, NORM = true) and
// block_matmul (K5, NORM = false):
//   out[T, N] = xn @ W[D, N], xn = (rms_norm(x) * (1 + scale)).to(T) under
//   NORM, else x itself; products summed in float32, out in x's dtype.
// Each block
//   1. (NORM only) computes every row's rsqrt(mean(x^2) + eps) in a first
//      pass over the row (x is small and read from L2),
//   2. streams 32-deep K tiles of x and W through shared memory (x
//      normalised and rounded to T on load under NORM), accumulating a
//      BT x BN output tile in float32 registers on the CUDA cores.
// Few output tiles (T = 4, or N = 1024) would leave most of the 132 SMs
// idle, so K is split across blocks (gridDim.z) into float32 partials that
// a second pass sums in a fixed order: no atomics, so results repeat run to
// run.  The Python wrappers size the split (common.py::split_plan).
// Each output sums its K products in order inside its split, then the
// splits in order, whatever the tile shape; up to 64 rows split_plan sizes
// the split from the weight shape alone, so a row's bits do not depend on
// how many rows share the call (a speculative verify dispatch gives each
// row what a decode step gives it).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMatmulBK = 32;

template <typename T, bool NORM, int BT, int BN, int TM, int TN>
__global__ void __launch_bounds__((BT / TM) * (BN / TN))
tiled_matmul_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ w, T* __restrict__ out,
                    float* __restrict__ part, int t, int d, int n,
                    int k_per_split, float eps) {
  constexpr int BK = kMatmulBK;
  constexpr int NT = (BT / TM) * (BN / TN);
  constexpr int NW = NT / 32;
  __shared__ float rstd_s[BT];
  __shared__ float xs[BK][BT + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * BT, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(d, k_begin + k_per_split);

  if constexpr (NORM) {
    // Pass 1: per-row inverse RMS over the whole row.
    for (int r = warp; r < BT; r += NW) {
      const int gr = row0 + r;
      float ss = 0.f;
      if (gr < t) {
        const T* xr = x + (size_t)gr * d;
        for (int k = lane; k < d; k += 32) {
          const float v = to_f(xr[k]);
          ss += v * v;
        }
      }
      ss = warp_sum(ss);
      if (lane == 0) rstd_s[r] = rsqrtf(ss / (float)d + eps);
    }
    __syncthreads();
  }

  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Pass 2: stream K tiles (x normalised on load under NORM).
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BT * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < t && gk < k_end) {
        v = to_f(x[(size_t)gr * d + gk]);
        if constexpr (NORM)
          v = round_to<T>(v * rstd_s[r] * (1.f + to_f(scale[gk])));
      }
      xs[kk][r] = v;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < k_end && gc < n) ? to_f(w[(size_t)gk * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tc * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr * TM + i;
    if (gr >= t) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc * TN + j;
      if (gc >= n) continue;
      if (part != nullptr)
        part[((size_t)blockIdx.z * t + gr) * n + gc] = acc[i][j];
      else
        out[(size_t)gr * n + gc] = from_f<T>(acc[i][j]);
    }
  }
}

// Tile shapes; the Python wrappers mirror them to size the split.
//   small (T <= 16): 8 x 128 tile, 1 x 4 outputs per thread
//   large          : 64 x 64 tile, 4 x 4 outputs per thread
template <typename T, bool NORM>
int tiled_matmul(const void* x, const void* scale, const void* w, void* out,
                 void* part, int t, int d, int n, int small, int k_per_split,
                 int splits, float eps, cudaStream_t stream) {
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (small) {
    dim3 grid(cdiv(n, 128), cdiv(t, 8), splits);
    tiled_matmul_kernel<T, NORM, 8, 128, 1, 4><<<grid, 256, 0, stream>>>(
        xt, st, wt, ot, p, t, d, n, k_per_split, eps);
  } else {
    dim3 grid(cdiv(n, 64), cdiv(t, 64), splits);
    tiled_matmul_kernel<T, NORM, 64, 64, 4, 4><<<grid, 256, 0, stream>>>(
        xt, st, wt, ot, p, t, d, n, k_per_split, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p != nullptr) split_reduce<T>(p, ot, splits, (size_t)t * n, stream);
  return (int)cudaGetLastError();
}

}  // namespace repro
