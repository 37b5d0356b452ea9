// streamed_ffn (K4) and streamed_mlp (K6), and their weight-only int8
// twins (K10b, K10c):
//   GLU        : out[T, D] = (act(xn @ Wg) * (xn @ Wu)).to(T) @ Wd, either
//                SiLU with the pre-FFN RMSNorm folded in (xn =
//                rms_norm(x) * (1 + s), rounded to the x dtype) — the
//                llama3 main path — tanh-GELU with the norm folded in —
//                gemma3's — or tanh-GELU without a folded norm (xn = x) —
//                zamba2's shared block, whose ln2 stays outside;
//   ungated MLP: out[T, D] = gelu_tanh(x @ Wu).to(T) @ Wd, no folded norm —
//                the gpt2 main path (its LayerNorm stays outside).
// Only those four cases are built, each also as an int8 twin: the
// full-precision ones by streamed_ffn.cu, the int8 twins by
// streamed_ffn_w8.cu (two libraries that compile side by side); the
// wrappers refuse other activations and norm settings on the card.  In the
// int8 twins W holds int8 codes with float32 per-output-channel scales: the gate and up scales multiply their
// sums before the activation, h stays float32 (not rounded to the x
// dtype), and the down scale multiplies each F range's partial before the
// partials are summed — the reference's `_ffn_kernel_w8` / `_mlp_kernel_w8`.
//
// Replaces the TPU kernels src/repro/kernels/streamed_ffn.py::_ffn_kernel
// (streamed_ffn, pallas_call at :168) and ::_mlp_kernel (streamed_mlp,
// pallas_call at :277), and their int8 bodies ::_ffn_kernel_w8 (:81) and
// ::_mlp_kernel_w8 (:205) (the same calls with the weight scales).  The TPU
// kernels walk F as a sequential grid dimension and carry a [bt, D]
// float32 accumulator in VMEM across it; that is 2 MB at bt = 128, D =
// 4096 and cannot live in one Hopper block, and Hopper blocks run in no
// order.  So F is split across blocks.
//
// bfloat16 (ffn_mma_kernel, on the tensor cores; its body is ffn_mma.cuh's,
// shared with the MoE experts K12).  What bounds it on the
// H100: up to 64 rows (decode, verify, short chunks) the weight bytes at
// 3.35 TB/s (int8 codes halve them); from a 128-row chunk on the products,
// 6 T D F flops (4 T D F ungated) at 989 TFLOP/s.  Design:
//   - products on mma.sync.m16n8k16 (bf16 -> f32): A (x, or h) by
//     ldmatrix from shared memory, W [D, F] / Wd [F, D] row-major by
//     ldmatrix.trans; every tile comes through one ring of cp.async
//     16-byte copies (4-5 stages of 37-44 KB), so several tiles are in
//     flight while one is multiplied; the int8 twins copy codes (half the
//     bytes) and convert each landed tile to bf16 (exact: |code| <= 127)
//     before ldmatrix; with the folded norm each landed x tile is
//     normalised in place and rounded to bf16, as `_rms_tile` does, from
//     per-row rstd taken first (their sums in a fixed order per row);
//   - h is rounded to bf16 (`.astype(x.dtype)`); the twins keep h float32
//     as the reference does, carried as two bf16 planes hi = bf16(h), lo =
//     bf16(h - hi) whose two MMAs sum into one float32 accumulator (about
//     16 bits of h, where one bf16 plane gives 8);
//   - up to 64 rows, one launch (FUSED): the F columns are cut into
//     128-column ranges sized from (D, F, SM count) alone
//     (common.py::ffn_plan), about one block of 8 warps per SM; a block
//     computes its h slice [16 or 64 rows, 128 columns] into shared memory
//     (phase 1: all its Wg / Wu columns per 64-deep D tile, so the blocks
//     together read whole weight rows), then h @ Wd over strips of D
//     (phase 2: 32 x 512 Wd tiles at up to 16 rows, 64 x 256 above: 1 KB /
//     512 B of each Wd row at once), the ring running on from phase 1's
//     last tiles into phase 2's first.  With 64-column h tiles read one
//     after the other and 64 x 128 Wd tiles, the weights came in 128- and
//     256-byte pieces and HBM ran at 0.94 TB/s (llama3, 4 rows: 0.376 ms
//     against 0.239 now).  Each strip's float32 partial goes to a
//     persistent workspace, and the last block to arrive on a strip (an
//     int32 arrival counter per strip, reset by that block) sums the
//     partials in F order, 16 loads in flight per thread — no value
//     atomics, no second launch, results repeat run to run.  Blocks start
//     their strips at different places, so the sums spread over them.
//     Every row runs the same MMA sequence at any row count from 1 to 64
//     (each output element depends on its own row of A only), so a
//     speculative verify dispatch gives each row a decode step's bits;
//   - above 64 rows, h [T, F] goes through HBM once (TWO-PASS): a block
//     of 4 warps computes a [64, 64] tile of h (UP; the folded norm is
//     applied by a row pass first, rms_rows_kernel), then h @ Wd runs as a
//     split-F GEMM over [64, 128] output tiles (DOWN), splitting F only to
//     fill the card and never past partials of 2 D F bytes (the last block
//     on a tile sums them in split order, as above).  h is 3.7 MB at
//     llama3's 128-row chunk and 117 MB at a 4096-token training step.
//     The fused launch run above 64 rows (its F split bounded only by its
//     h slice's shared memory) lost to two passes on the H100 at llama3's
//     widths: 0.59-0.88 against 0.39 ms at 128 rows, 4.1-4.9 against
//     2.1-2.2 at 1000, 14.7-19.2 against 8.6-9.0 at 4096, its partials
//     0.23-15 GB (PERF.md); the previous kernel's partials
//     were 235 MB at 128 rows and 7.5 GB at 4096;
//   - rows of x, W, Wd that are not 16-byte aligned (D or F not a
//     multiple of 16, or an unaligned pointer) load element by element
//     through the same ring (`aligned` = 0).
// float32 (streamed_ffn_kernel, on the CUDA cores: TF32 would break the
// float32 checks against the reference) keeps three tile classes of
// float FMAs: block (f, t) computes its [BT, BF] tile of h in shared memory
// and multiplies it by Wd[BF, D] into a float32 partial [F / BF, T, D]; a
// second kernel sums the partials in f-tile order.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "ffn_mma.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int BK = 8;
constexpr int NT = 256;

// Weight scales of the int8 twins (null for weights of T): gate and up
// [F], down [D].
struct WScales {
  const float *g, *u, *d;
};

// NORM: the RMSNorm folded in; SILU: SiLU, else tanh-GELU.
template <typename T, typename W, bool GLU, bool NORM, bool SILU, int BT,
          int BF, int TM1, int TN1, int BN2, int TM2, int TN2>
__global__ void __launch_bounds__(NT)
streamed_ffn_kernel(const T* __restrict__ x, const T* __restrict__ nscale,
                    const W* __restrict__ wg, const W* __restrict__ wu,
                    const W* __restrict__ wd, WScales ws,
                    float* __restrict__ part, int t, int d, int f,
                    float eps) {
  constexpr bool W8 = std::is_same<W, int8_t>::value;
  static_assert(GLU || (!NORM && !SILU), "the MLP runs GELU, no norm");
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

  if constexpr (NORM) {
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
          if constexpr (NORM)
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
          hv = (SILU ? silu(gv) : gelu_tanh(gv)) * uv;
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
template <typename T, typename W, bool GLU, bool NORM, bool SILU>
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
    streamed_ffn_kernel<T, W, GLU, NORM, SILU, 8, 64, 1, 2, 128, 1, 4>
        <<<grid, NT, 0, st>>>(xt, nt, gt, ut, dt, ws, p, t, d, f, eps);
  } else if (tile == 1) {
    n_f = cdiv(f, 64);
    dim3 grid(n_f, cdiv(t, 32));
    streamed_ffn_kernel<T, W, GLU, NORM, SILU, 32, 64, 2, 4, 128, 2, 8>
        <<<grid, NT, 0, st>>>(xt, nt, gt, ut, dt, ws, p, t, d, f, eps);
  } else if (tile == 2) {
    n_f = cdiv(f, 128);
    dim3 grid(n_f, cdiv(t, 64));
    streamed_ffn_kernel<T, W, GLU, NORM, SILU, 64, 128, 4, 8, 128, 4, 8>
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


// --------------------------------------------------------------------- //
// bfloat16 on the tensor cores
// --------------------------------------------------------------------- //

// The norm as a row pass for the two-pass path: xn = rms_norm(x), one warp
// per row.
__global__ void __launch_bounds__(128)
rms_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
                bf16* __restrict__ xn, int t, int d, float eps, int aligned) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= t) return;
  const bf16* xr = x + (size_t)row * d;
  const float rstd = row_rstd(xr, d, eps, lane, aligned);
  bf16* o = xn + (size_t)row * d;
  for (int c = lane; c < d; c += 32)
    o[c] = __float2bfloat16(norm_elem(__bfloat162float(xr[c]), rstd,
                                      __bfloat162float(nscale[c])));
}

// The tensor-core body (ffn_mma.cuh) as the streamed FFN's kernel.
template <class C, bool W8, int MODE, bool GLU, bool NORM, bool SILU>
__global__ void __launch_bounds__(C::NT) ffn_mma_kernel(const FfnArgs a) {
  ffn_mma_body<C, W8, MODE, GLU, NORM, SILU, false>(a);
}

template <class C, bool W8, int MODE, bool GLU, bool NORM, bool SILU>
int launch_mma(const FfnArgs& a, dim3 grid, cudaStream_t stream) {
  static size_t smem_set = 0;
  return launch_ffn_mma<C, W8, MODE, GLU>(
      ffn_mma_kernel<C, W8, MODE, GLU, NORM, SILU>, &smem_set, a, grid,
      stream);
}

// mode 0 (FUSED; the plan takes it up to 64 rows): `splits` blocks of
// `f_per_split` F columns per row tile; mode 1 (TWO-PASS): the norm's row
// pass (into `xn`), UP over h's 64-column tiles, DOWN over `splits` F
// ranges of `f_per_split` rows.
template <bool W8, bool GLU, bool NORM, bool SILU>
int run_mma(FfnArgs a, bf16* xn, int mode, int splits, cudaStream_t st) {
  if (a.t == 0 || a.d == 0) return (int)cudaGetLastError();
  if (mode == 0) {
    if (a.t <= DecodeRows::BT)
      return launch_mma<DecodeRows, W8, FUSED, GLU, NORM, SILU>(
          a, dim3(splits), st);
    return launch_mma<VerifyRows, W8, FUSED, GLU, NORM, SILU>(
        a, dim3(splits, cdiv(a.t, VerifyRows::BT)), st);
  }
  const int row_tiles = cdiv(a.t, PassRows::BT);
  FfnArgs up = a;
  if constexpr (NORM) {
    rms_rows_kernel<<<cdiv(a.t, 4), 128, 0, st>>>(a.x, a.nscale, xn, a.t,
                                                  a.d, a.eps, a.aligned);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    up.x = xn;
  }
  up.f_per_split = PassRows::BF1;
  const int status = launch_mma<PassRows, W8, UP, GLU, false, SILU>(
      up, dim3(a.fp / PassRows::BF1, row_tiles), st);
  if (status != 0) return status;
  return launch_mma<PassRows, W8, DOWN, false, false, false>(
      a, dim3(cdiv(a.d, PassRows::BN2), row_tiles, splits), st);
}

}  // namespace

// bf16 on the tensor cores; one signature for the eight instances (unused
// pointers null).  `part` [splits, T, D] float32 and `counters` (all 0; one
// per 64-row tile and 128-column strip) are needed only when splits > 1;
// `h` [planes, T, round_up(F, 64)] (planes 2 for the int8 twins) and, with
// the norm, `xn` [T, D] only in mode 1.  `aligned`: D and F multiples of
// 16, every operand 16-byte aligned.  The plan is common.py::ffn_plan.
#define REPRO_STREAMED_FFN_MMA(NAME, W8, GLU, NORM, SILU)                     \
  extern "C" int NAME(const void* x, const void* nscale, const void* wg,     \
                      const void* gs, const void* wu, const void* us,         \
                      const void* wd, const void* ds, void* out, void* part,  \
                      void* counters, void* h, void* xn, int t, int d, int f, \
                      int mode, int f_per_split, int splits, int aligned,     \
                      float eps, void* stream) {                              \
    FfnArgs a{};                                                              \
    a.x = static_cast<const bf16*>(x);                                        \
    a.nscale = static_cast<const bf16*>(nscale);                              \
    a.wg = wg;                                                                \
    a.wu = wu;                                                                \
    a.wd = wd;                                                                \
    a.gs = static_cast<const float*>(gs);                                     \
    a.us = static_cast<const float*>(us);                                     \
    a.ds = static_cast<const float*>(ds);                                     \
    a.out = static_cast<bf16*>(out);                                          \
    a.part = static_cast<float*>(part);                                       \
    a.counters = static_cast<int*>(counters);                                 \
    a.h = static_cast<bf16*>(h);                                              \
    a.t = t;                                                                  \
    a.d = d;                                                                  \
    a.f = f;                                                                  \
    a.fp = cdiv(f, 64) * 64;                                                  \
    a.f_per_split = f_per_split;                                              \
    a.aligned = aligned;                                                      \
    a.eps = eps;                                                              \
    return run_mma<W8, GLU, NORM, SILU>(a, static_cast<bf16*>(xn), mode,      \
                                        splits,                               \
                                        static_cast<cudaStream_t>(stream));   \
  }
