// moe_experts (K12): the dense-gather MoE expert FFN
//   out[T, D] = sum over e = 0..E-1, in order, of
//               g[:, e] * ((silu(x @ Wg_e) * (x @ Wu_e)).to(T) @ Wd_e),
// products summed in float32, the gated sum accumulated in float32 in
// expert order, out rounded to x's dtype T.  Experts whose gate is zero
// are computed too: that is the dense-gather formulation the reference
// computes.  Only SiLU is built (the granite configs); the wrapper refuses
// other activations on the card.
//
// Replaces the TPU kernel src/repro/kernels/moe_experts.py::_moe_kernel
// (moe_experts_pallas, pallas_call at :68).  That kernel walks the experts
// as the sequential inner grid dimension and carries a [bt, D] float32
// accumulator in VMEM across it.  Hopper blocks run in no order and a
// block cannot hold that accumulator for large tiles, so the work is cut
// in two launches instead, with no F-split workspace (K4's [F/BF, T, D]
// partials would be [E*F/BF, T, D] here, gigabytes at a training step):
//   phase 1: block (F tile, T tile, expert e) computes its tile of
//            h_e = (silu(x @ Wg_e) * (x @ Wu_e)).to(T) — gate and up summed
//            in float32 over D from one shared x tile — and writes it to
//            H [E, T, F] in x's dtype (the reference's own rounding of h);
//   phase 2: block (D tile, T tile, expert e) sums H_e[t, :] @ Wd_e[:, d]
//            in float32 over F, scales it by g[t, e] and writes it to
//            float32 partials [E, T, D] (0.54 GB at granite-1b's training
//            step); a last pass adds them up in expert order from 0, the
//            reference's `acc += y * g`.  Partials, not a register
//            accumulator looping over the experts in each (D, T) block:
//            that loop gives the same bits but is slower at every path
//            shape (few blocks, each E * F / 16 latency-bound steps).
// No atomics: results repeat from run to run.  Every output element is one
// thread's fmaf chain over K in order (no split of D or F), so a row's
// bits do not depend on the tile shape or on how many rows share the call
// (row invariance, which exact speculative acceptance needs).
// What bounds it: the function needs only what the gates keep — the
// weights of the experts some token routes to (3 * D * F values each; at
// granite-3b all 40, 189 MB in bf16, from about 20 tokens on) and 6 * D * F
// operations per kept (token, expert) pair — so bytes up to a whole prompt
// and operations at a training step.  This kernel does the dense-gather
// work instead (6 * T * D * F * E operations, E / top-k = 5x what the gates
// keep), on the CUDA cores (float FMA), not the tensor cores.  The design
// keeps h out of registers only for one write and one read of H, and
// reads each weight tile once per token tile.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int NT = 256;
constexpr int BK = 16;

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// Phase 1: H[e, row0:row0+BT, f0:f0+BF] for expert e = blockIdx.z.
template <typename T, int BT, int BF, int TM, int TN>
__global__ void __launch_bounds__(NT)
moe_h_kernel(const T* __restrict__ x, const T* __restrict__ wg,
             const T* __restrict__ wu, T* __restrict__ h, int t, int d,
             int f) {
  static_assert((BT / TM) * (BF / TN) == NT, "phase-1 thread layout");
  __shared__ float xs[BK][BT + 1];
  __shared__ float gs[BK][BF];
  __shared__ float us[BK][BF];
  const int e = blockIdx.z;
  const int f0 = blockIdx.x * BF, row0 = blockIdx.y * BT;
  const T* wge = wg + (size_t)e * d * f;
  const T* wue = wu + (size_t)e * d * f;
  const int tid = threadIdx.x;
  const int tr = tid / (BF / TN), tc = tid % (BF / TN);
  float g[TM][TN], u[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) g[i][j] = u[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BT * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < t && gk < d) ? to_f(x[(size_t)gr * d + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BF; i += NT) {
      const int kk = i / BF, c = i % BF;
      const int gk = k0 + kk, gc = f0 + c;
      const bool ok = gk < d && gc < f;
      const size_t off = (size_t)gk * f + gc;
      gs[kk][c] = ok ? to_f(wge[off]) : 0.f;
      us[kk][c] = ok ? to_f(wue[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bg[TN], bu[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bg[j] = gs[kk][tc * TN + j];
        bu[j] = us[kk][tc * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          g[i][j] = fmaf(a[i], bg[j], g[i][j]);
          u[i][j] = fmaf(a[i], bu[j], u[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr * TM + i;
    if (gr >= t) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = f0 + tc * TN + j;
      if (gc < f)
        h[((size_t)e * t + gr) * f + gc] = from_f<T>(silu(g[i][j]) * u[i][j]);
    }
  }
}

// Phase 2: part[e, tile] = g[:, e] * (H_e @ Wd_e) for the BT x BN tile at
// (row0, col0) and expert e = blockIdx.z; split_reduce sums over e.
template <typename T, int BT, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT)
moe_out_kernel(const T* __restrict__ h, const T* __restrict__ gates,
               const T* __restrict__ wd, float* __restrict__ part, int t,
               int d, int f, int n_e) {
  static_assert((BT / TM) * (BN / TN) == NT, "phase-2 thread layout");
  __shared__ float hs[BK][BT + 1];
  __shared__ float ws[BK][BN];
  const int e = blockIdx.z;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const T* he = h + (size_t)e * t * f;
  const T* wde = wd + (size_t)e * f * d;
  float y[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) y[i][j] = 0.f;
  for (int k0 = 0; k0 < f; k0 += BK) {
    for (int i = tid; i < BT * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      hs[kk][r] = (gr < t && gk < f) ? to_f(he[(size_t)gr * f + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < f && gc < d) ? to_f(wde[(size_t)gk * d + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = hs[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tc * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) y[i][j] = fmaf(a[i], b[j], y[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr * TM + i;
    if (gr >= t) continue;
    const float gv = to_f(gates[(size_t)gr * n_e + e]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc * TN + j;
      // y * g rounded on its own, as the reference's product before `+=`.
      if (gc < d) part[((size_t)e * t + gr) * d + gc] = __fmul_rn(y[i][j], gv);
    }
  }
}

// Tile shapes; the Python wrapper picks the class.
//   small (T <= 16): phase 1 8 x 128 (1 x 4 per thread), phase 2 8 x 64
//   large          : phase 1 64 x 64 (4 x 4),           phase 2 64 x 64
template <typename T>
int launch(const void* x, const void* gates, const void* wg, const void* wu,
           const void* wd, void* h, void* part, void* out, int t, int d,
           int f, int n_e, int small, void* stream) {
  if (t < 1 || d < 1 || f < 1 || n_e < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gates);
  T* ht = static_cast<T*>(h);
  T* ot = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  if (small) {
    moe_h_kernel<T, 8, 128, 1, 4>
        <<<dim3(cdiv(f, 128), cdiv(t, 8), n_e), NT, 0, s>>>(
            xt, static_cast<const T*>(wg), static_cast<const T*>(wu), ht, t,
            d, f);
  } else {
    moe_h_kernel<T, 64, 64, 4, 4>
        <<<dim3(cdiv(f, 64), cdiv(t, 64), n_e), NT, 0, s>>>(
            xt, static_cast<const T*>(wg), static_cast<const T*>(wu), ht, t,
            d, f);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (small) {
    moe_out_kernel<T, 8, 64, 1, 2>
        <<<dim3(cdiv(d, 64), cdiv(t, 8), n_e), NT, 0, s>>>(
            ht, gt, static_cast<const T*>(wd), p, t, d, f, n_e);
  } else {
    moe_out_kernel<T, 64, 64, 4, 4>
        <<<dim3(cdiv(d, 64), cdiv(t, 64), n_e), NT, 0, s>>>(
            ht, gt, static_cast<const T*>(wd), p, t, d, f, n_e);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_reduce<T>(p, ot, n_e, (size_t)t * d, s);
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_MOE_ENTRY(SUFFIX, T)                                          \
  extern "C" int repro_moe_experts_##SUFFIX(                                \
      const void* x, const void* gates, const void* wg, const void* wu,     \
      const void* wd, void* h, void* part, void* out, int t, int d, int f,  \
      int n_e, int small, void* stream) {                                   \
    return launch<T>(x, gates, wg, wu, wd, h, part, out, t, d, f, n_e,      \
                     small, stream);                                        \
  }

REPRO_MOE_ENTRY(f32, float)
REPRO_MOE_ENTRY(bf16, __nv_bfloat16)
