// streamed_ffn (K4) and streamed_mlp (K6), one kernel template:
//   GLU  = true : out[T, D] = (silu(xn @ Wg) * (xn @ Wu)).to(T) @ Wd, with
//                 the pre-FFN RMSNorm folded in (xn = rms_norm(x) * (1 + s),
//                 rounded to the x dtype) — the llama3 main path;
//   GLU  = false: out[T, D] = gelu_tanh(x @ Wu).to(T) @ Wd, no folded norm —
//                 the gpt2 main path (its LayerNorm stays outside).
// Only those two cases are built; the wrappers refuse other activations and
// norm settings on the card.  Each also has a weight-only int8 twin (K10b
// streamed_ffn, K10c streamed_mlp; W = int8_t): the weights are int8 codes
// loaded one byte each with float32 per-output-channel scales; the gate and
// up scales multiply their sums before the activation, h stays float32
// (not rounded to the x dtype), and the down scale multiplies each F
// step's partial before the partials are summed — the reference's
// `_ffn_kernel_w8` / `_mlp_kernel_w8`.
//
// Replaces the TPU kernels src/repro/kernels/streamed_ffn.py::_ffn_kernel
// (streamed_ffn, pallas_call at :168) and ::_mlp_kernel (streamed_mlp,
// pallas_call at :277), and their int8 bodies ::_ffn_kernel_w8 and
// ::_mlp_kernel_w8 (the same calls with the weight scales).  The TPU
// kernels walk F as a sequential grid dimension and carry a [bt, D]
// float32 accumulator in VMEM across it;
// that is 2 MB at bt = 128, D = 4096 and cannot live in one Hopper block,
// and Hopper blocks run in no order.  So F is split across blocks instead:
//   phase 1: block (f, t) computes its [BT, BF] tile of h in shared memory
//            (up — and gate — products summed in float32, h rounded to the
//            x dtype, as the reference's `.astype(x.dtype)`) — h never
//            reaches HBM;
//   phase 2: it multiplies that tile by Wd[BF, D] into a float32 partial
//            [BT, D], written to a workspace [F / BF, T, D];
//   pass 2 : a second kernel sums the partials in f-tile order (no float
//            atomics: results repeat run to run).
// Workspace: F/BF * T * D * 4 bytes (235 MB for llama3 at T = 128, BF =
// 128; 16 MB for gpt2).
// What bounds it: at T = 4 the weight matrices (memory bound; int8 codes
// halve their bytes against bf16); at T = 128 the arithmetic, done here on
// the CUDA cores (float FMA).
#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int BK = 8;
constexpr int NT = 256;

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// The tanh form, in float32: jax.nn.gelu(approximate=True) and
// F.gelu(approximate="tanh").
__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
}

// Weight scales of the int8 twins (null for weights of T): gate and up
// [F], down [D].
struct WScales {
  const float *g, *u, *d;
};

template <typename T, typename W, bool GLU, int BT, int BF, int TM1, int TN1,
          int BN2, int TM2, int TN2>
__global__ void __launch_bounds__(NT)
streamed_ffn_kernel(const T* __restrict__ x, const T* __restrict__ nscale,
                    const W* __restrict__ wg, const W* __restrict__ wu,
                    const W* __restrict__ wd, WScales ws,
                    float* __restrict__ part, int t, int d, int f,
                    float eps) {
  constexpr bool W8 = std::is_same<W, int8_t>::value;
  static_assert((BT / TM1) * (BF / TN1) == NT, "phase-1 thread layout");
  static_assert((BT / TM2) * (BN2 / TN2) == NT, "phase-2 thread layout");
  constexpr int P1 = BK * (BT + 1) + 2 * BK * BF;
  constexpr int P2 = BK * BN2;
  constexpr int BUF = P1 > P2 ? P1 : P2;
  __shared__ float rstd_s[BT];
  __shared__ float h_s[BF * BT];          // h tile, [BF][BT]
  __shared__ float buf[BUF];              // phase-1 x/g/u tiles, then Wd
  float* xs = buf;                        // [BK][BT + 1]
  float* gs = buf + BK * (BT + 1);        // [BK][BF]
  float* us = gs + BK * BF;               // [BK][BF]
  float* ds = buf;                        // [BK][BN2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * BF, row0 = blockIdx.y * BT;

  if constexpr (GLU) {
    for (int r = warp; r < BT; r += NT / 32) {
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

  // Phase 1: (gate and) up tiles [BT, BF], reduced over D.
  {
    const int tr = tid / (BF / TN1), tc = tid % (BF / TN1);
    float g[TM1][TN1], u[TM1][TN1];
#pragma unroll
    for (int i = 0; i < TM1; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) g[i][j] = u[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int i = tid; i < BT * BK; i += NT) {
        const int r = i / BK, kk = i % BK;
        const int gr = row0 + r, gk = k0 + kk;
        float v = 0.f;
        if (gr < t && gk < d) {
          v = to_f(x[(size_t)gr * d + gk]);
          if constexpr (GLU)
            v = round_to<T>(v * rstd_s[r] * (1.f + to_f(nscale[gk])));
        }
        xs[kk * (BT + 1) + r] = v;
      }
      for (int i = tid; i < BK * BF; i += NT) {
        const int kk = i / BF, c = i % BF;
        const int gk = k0 + kk, gc = f0 + c;
        const bool ok = gk < d && gc < f;
        const size_t off = (size_t)gk * f + gc;
        if constexpr (GLU) gs[kk * BF + c] = ok ? to_f(wg[off]) : 0.f;
        us[kk * BF + c] = ok ? to_f(wu[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM1], bg[TN1], bu[TN1];
#pragma unroll
        for (int i = 0; i < TM1; ++i) a[i] = xs[kk * (BT + 1) + tr * TM1 + i];
#pragma unroll
        for (int j = 0; j < TN1; ++j) {
          if constexpr (GLU) bg[j] = gs[kk * BF + tc * TN1 + j];
          bu[j] = us[kk * BF + tc * TN1 + j];
        }
#pragma unroll
        for (int i = 0; i < TM1; ++i)
#pragma unroll
          for (int j = 0; j < TN1; ++j) {
            if constexpr (GLU) g[i][j] = fmaf(a[i], bg[j], g[i][j]);
            u[i][j] = fmaf(a[i], bu[j], u[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM1; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) {
        const int r = tr * TM1 + i, c = tc * TN1 + j;
        const bool ok = row0 + r < t && f0 + c < f;
        float gv = g[i][j], uv = u[i][j];
        if constexpr (W8) {
          if (ok) {
            if constexpr (GLU) gv *= ws.g[f0 + c];
            uv *= ws.u[f0 + c];
          }
        }
        float hv;
        if constexpr (GLU)
          hv = silu(gv) * uv;
        else
          hv = gelu_tanh(uv);
        if constexpr (!W8) hv = round_to<T>(hv);
        h_s[c * BT + r] = ok ? hv : 0.f;
      }
  }
  __syncthreads();

  // Phase 2: partial[BT, D] = h[BT, BF] @ Wd[f0:f0+BF, :].
  const int tr = tid / (BN2 / TN2), tc = tid % (BN2 / TN2);
  for (int c0 = 0; c0 < d; c0 += BN2) {
    float acc[TM2][TN2];
#pragma unroll
    for (int i = 0; i < TM2; ++i)
#pragma unroll
      for (int j = 0; j < TN2; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < BF; k0 += BK) {
      for (int i = tid; i < BK * BN2; i += NT) {
        const int kk = i / BN2, c = i % BN2;
        const int gf = f0 + k0 + kk, gc = c0 + c;
        ds[kk * BN2 + c] =
            (gf < f && gc < d) ? to_f(wd[(size_t)gf * d + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM2], b[TN2];
#pragma unroll
        for (int i = 0; i < TM2; ++i) a[i] = h_s[(k0 + kk) * BT + tr * TM2 + i];
#pragma unroll
        for (int j = 0; j < TN2; ++j) b[j] = ds[kk * BN2 + tc * TN2 + j];
#pragma unroll
        for (int i = 0; i < TM2; ++i)
#pragma unroll
          for (int j = 0; j < TN2; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM2; ++i) {
      const int gr = row0 + tr * TM2 + i;
      if (gr >= t) continue;
#pragma unroll
      for (int j = 0; j < TN2; ++j) {
        const int gc = c0 + tc * TN2 + j;
        if (gc >= d) continue;
        float pv = acc[i][j];
        if constexpr (W8) pv *= ws.d[gc];
        part[((size_t)blockIdx.x * t + gr) * d + gc] = pv;
      }
    }
  }
}

// Tile classes; the Python wrappers mirror them (streamed_ffn.py::_TILES)
// to size the workspace.
//   0 (T <= 16): BT 8,  BF 64  (phase 1: 1 x 2, phase 2: 1 x 4 / thread)
//   1 (T <= 64): BT 32, BF 64  (phase 1: 2 x 4, phase 2: 2 x 8 / thread)
//   2 (larger) : BT 64, BF 128 (phase 1: 4 x 8, phase 2: 4 x 8 / thread)
// Each output sums its BF-deep products in order, then the F / BF partials
// in order, whatever BT: classes 0 and 1 share BF = 64, so a row's bits do
// not depend on T up to 64 rows (a speculative verify dispatch of slots x
// W rows gives each row what a decode step of slots rows gives it).
template <typename T, typename W, bool GLU>
int launch(const void* x, const void* nscale, const void* wg, const void* wu,
           const void* wd, WScales ws, void* out, void* part, int t, int d,
           int f, int tile, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* nt = static_cast<const T*>(nscale);
  const W* gt = static_cast<const W*>(wg);
  const W* ut = static_cast<const W*>(wu);
  const W* dt = static_cast<const W*>(wd);
  float* p = static_cast<float*>(part);
  int n_f;
  if (tile == 0) {
    n_f = cdiv(f, 64);
    dim3 grid(n_f, cdiv(t, 8));
    streamed_ffn_kernel<T, W, GLU, 8, 64, 1, 2, 128, 1, 4>
        <<<grid, NT, 0, st>>>(xt, nt, gt, ut, dt, ws, p, t, d, f, eps);
  } else if (tile == 1) {
    n_f = cdiv(f, 64);
    dim3 grid(n_f, cdiv(t, 32));
    streamed_ffn_kernel<T, W, GLU, 32, 64, 2, 4, 128, 2, 8>
        <<<grid, NT, 0, st>>>(xt, nt, gt, ut, dt, ws, p, t, d, f, eps);
  } else if (tile == 2) {
    n_f = cdiv(f, 128);
    dim3 grid(n_f, cdiv(t, 64));
    streamed_ffn_kernel<T, W, GLU, 64, 128, 4, 8, 128, 4, 8>
        <<<grid, NT, 0, st>>>(xt, nt, gt, ut, dt, ws, p, t, d, f, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_reduce<T>(p, static_cast<T*>(out), n_f, (size_t)t * d, st);
  return (int)cudaGetLastError();
}

const WScales kNoScales{nullptr, nullptr, nullptr};

WScales scales(const void* g, const void* u, const void* d) {
  return WScales{static_cast<const float*>(g), static_cast<const float*>(u),
                 static_cast<const float*>(d)};
}

}  // namespace

extern "C" int repro_streamed_ffn_f32(const void* x, const void* nscale,
                                      const void* wg, const void* wu,
                                      const void* wd, void* out, void* part,
                                      int t, int d, int f, int tile,
                                      float eps, void* stream) {
  return launch<float, float, true>(x, nscale, wg, wu, wd, kNoScales, out,
                                    part, t, d, f, tile, eps, stream);
}

extern "C" int repro_streamed_ffn_bf16(const void* x, const void* nscale,
                                       const void* wg, const void* wu,
                                       const void* wd, void* out, void* part,
                                       int t, int d, int f, int tile,
                                       float eps, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, true>(
      x, nscale, wg, wu, wd, kNoScales, out, part, t, d, f, tile, eps,
      stream);
}

extern "C" int repro_streamed_mlp_f32(const void* x, const void* wu,
                                      const void* wd, void* out, void* part,
                                      int t, int d, int f, int tile,
                                      void* stream) {
  return launch<float, float, false>(x, nullptr, nullptr, wu, wd, kNoScales,
                                     out, part, t, d, f, tile, 0.f, stream);
}

extern "C" int repro_streamed_mlp_bf16(const void* x, const void* wu,
                                       const void* wd, void* out, void* part,
                                       int t, int d, int f, int tile,
                                       void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, false>(
      x, nullptr, nullptr, wu, wd, kNoScales, out, part, t, d, f, tile, 0.f,
      stream);
}

// The int8 twins: wg/wu/wd int8 codes; gs/us float32 [F], ds float32 [D].
#define REPRO_STREAMED_FFN_W8(NAME, T)                                       \
  extern "C" int NAME(const void* x, const void* nscale, const void* wg,    \
                      const void* gs, const void* wu, const void* us,        \
                      const void* wd, const void* ds, void* out, void* part, \
                      int t, int d, int f, int tile, float eps,              \
                      void* stream) {                                        \
    return launch<T, int8_t, true>(x, nscale, wg, wu, wd,                    \
                                   scales(gs, us, ds), out, part, t, d, f,   \
                                   tile, eps, stream);                       \
  }
REPRO_STREAMED_FFN_W8(repro_streamed_ffn_w8_f32, float)
REPRO_STREAMED_FFN_W8(repro_streamed_ffn_w8_bf16, __nv_bfloat16)

#define REPRO_STREAMED_MLP_W8(NAME, T)                                       \
  extern "C" int NAME(const void* x, const void* wu, const void* us,        \
                      const void* wd, const void* ds, void* out, void* part, \
                      int t, int d, int f, int tile, void* stream) {         \
    return launch<T, int8_t, false>(x, nullptr, nullptr, wu, wd,             \
                                    scales(nullptr, us, ds), out, part, t,   \
                                    d, f, tile, 0.f, stream);                \
  }
REPRO_STREAMED_MLP_W8(repro_streamed_mlp_w8_f32, float)
REPRO_STREAMED_MLP_W8(repro_streamed_mlp_w8_bf16, __nv_bfloat16)
