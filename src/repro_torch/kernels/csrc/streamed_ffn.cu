// streamed_ffn (K4) and streamed_mlp (K6), and their weight-only int8
// twins (K10b, K10c):
//   GLU        : out[T, D] = (act(xn @ Wg) * (xn @ Wu)).to(T) @ Wd, either
//                SiLU with the pre-FFN RMSNorm folded in (xn =
//                rms_norm(x) * (1 + s), rounded to the x dtype) — the
//                llama3 main path — or tanh-GELU without a folded norm
//                (xn = x) — zamba2's shared block, whose ln2 stays outside;
//   ungated MLP: out[T, D] = gelu_tanh(x @ Wu).to(T) @ Wd, no folded norm —
//                the gpt2 main path (its LayerNorm stays outside).
// Only those three cases are built; the wrappers refuse other activations
// and norm settings on the card.  In the int8 twins W holds int8 codes with
// float32 per-output-channel scales: the gate and up scales multiply their
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
// bfloat16 (ffn_mma_kernel, on the tensor cores).  What bounds it on the
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
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

constexpr int kBK = 64;     // phase-1 k-tile depth (along D)
constexpr int kLDK = kBK + 8;   // row stride of an x tile (bf16)

enum Mode { FUSED = 0, UP = 1, DOWN = 2 };

// A tile class: BT rows per tile, NW warps, ST ring stages; phase 1 makes
// h tiles of BF1 = 16 NW columns (16 per warp, all BT rows), phase 2
// output strips of BN2 columns over BK2-deep F tiles (BN2 / NW per warp).
// Each stage moves whole rows of 256 B or more (bf16) of the weights; the
// fused classes' blocks cover a weight row's F columns side by side.
template <int BT_, int NW_, int BN2_, int BK2_, int ST_>
struct TileCfg {
  static constexpr int BT = BT_, NW = NW_, BN2 = BN2_, BK2 = BK2_, ST = ST_;
  static constexpr int NT = NW * 32, MT = BT / 16, BF1 = 16 * NW;
  static constexpr int N2 = BN2 / NW / 8;   // a warp's n8 tiles in phase 2
};
using DecodeRows = TileCfg<16, 8, 512, 32, 5>;   // FUSED, T <= 16
using VerifyRows = TileCfg<64, 8, 256, 64, 4>;   // FUSED, T <= 64
using PassRows = TileCfg<64, 4, 128, 64, 4>;     // UP and DOWN

struct FfnArgs {
  const bf16* x;         // [T, D] (UP with the norm: the normalised rows)
  const bf16* nscale;    // [D], the folded norm's scale (FUSED only)
  const void* wg;        // [D, F] bf16 or int8 codes (GLU only)
  const void* wu;        // [D, F]
  const void* wd;        // [F, D]
  const float* gs;       // int8 scales: gate, up [F], down [D]
  const float* us;
  const float* ds;
  bf16* out;             // [T, D]
  float* part;           // split partials [splits, T, D]
  int* counters;         // one arrival counter per output tile, all 0
  bf16* h;               // two-pass h planes [planes, T, fp]
  int t, d, f, fp;       // fp: h's row stride, F rounded up to 64
  int f_per_split;       // FUSED: a block's F columns; DOWN: a split's rows
  int aligned;
  float eps;
};

template <typename E> __device__ __forceinline__ E zero_of();
template <> __device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ int8_t zero_of<int8_t>() { return 0; }

// Rows [r0, r0 + R) x columns [c0, c0 + CC) of a row-major matrix of E
// with row stride `ld` into a shared tile of row stride LDS, by NT
// threads; elements at or past (r_end, c_end) are zero.  Aligned: 16-byte
// cp.async copies (c_end a multiple of 16 elements); else element by
// element.
template <typename E, int R, int CC, int LDS, int NT>
__device__ __forceinline__ void load_tile(E* s, const E* __restrict__ g,
                                          size_t ld, int r0, int r_end,
                                          int c0, int c_end, bool aligned) {
  constexpr int EPC = 16 / (int)sizeof(E);
  constexpr int CPR = CC / EPC;
  if (aligned) {
    for (int i = threadIdx.x; i < R * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      cp_async16(s + r * LDS + c, ok ? g + (size_t)(r0 + r) * ld + c0 + c : g,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * CC; i += NT) {
      const int r = i / CC, c = i % CC;
      s[r * LDS + c] = (r0 + r < r_end && c0 + c < c_end)
                           ? g[(size_t)(r0 + r) * ld + c0 + c]
                           : zero_of<E>();
    }
  }
}

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

// Shared-memory layout of one instance: a ring of ST stages (phase 1: the x
// tile, then the Wg and Wu tiles; phase 2: DOWN's h tiles, then the Wd
// tile), the int8 twins' bf16 conversion buffer, FUSED's h slice.
template <class C, bool W8, int MODE, bool GLU>
struct Layout {
  static constexpr int PL = W8 ? 2 : 1;                // h planes
  static constexpr int ESZ = W8 ? 1 : 2;               // bytes per W element
  static constexpr int LDF = C::BF1 + 8;               // bf16 Wg / Wu stride
  static constexpr int LDN = C::BN2 + 8;               // bf16 Wd stride
  static constexpr int LDA = C::BK2 + 8;               // DOWN's h tile stride
  static constexpr int WLDF = W8 ? C::BF1 : LDF;       // ring strides
  static constexpr int WLDN = W8 ? C::BN2 : LDN;
  static constexpr size_t XA = MODE != DOWN ? (size_t)C::BT * kLDK * 2 : 0;
  static constexpr size_t WT1 = (size_t)kBK * WLDF * ESZ;
  static constexpr size_t P1 = MODE != DOWN ? XA + (GLU ? 2 : 1) * WT1 : 0;
  static constexpr size_t AD =
      MODE == DOWN ? (size_t)PL * C::BT * LDA * 2 : 0;
  static constexpr size_t P2 =
      MODE != UP ? AD + (size_t)C::BK2 * WLDN * ESZ : 0;
  static constexpr size_t STAGE = ((P1 > P2 ? P1 : P2) + 127) / 128 * 128;
  static constexpr size_t CONV1 =
      MODE != DOWN ? (size_t)(GLU ? 2 : 1) * kBK * LDF * 2 : 0;
  static constexpr size_t CONV2 =
      MODE != UP ? (size_t)C::BK2 * LDN * 2 : 0;
  static constexpr size_t CONV = W8 ? (CONV1 > CONV2 ? CONV1 : CONV2) : 0;
  static constexpr size_t RING = (size_t)C::ST * STAGE;
  static size_t bytes(int f_per_split) {
    return RING + CONV +
           (MODE == FUSED ? (size_t)PL * C::BT * (f_per_split + 8) * 2 : 0);
  }
};

__device__ __forceinline__ float act_silu_or_gelu(bool silu_, float v) {
  return silu_ ? silu(v) : gelu_tanh(v);
}

// The sum of `splits` float32 partials [splits, t, d] in split order over
// rows [row0, row0 + rows) and columns [col0, col0 + W), rounded to bf16,
// by NT threads.  Each thread sums 4 columns (aligned) or 1, with ZB of
// the splits' loads in flight before they are added in order.
template <int W, int NT>
__device__ __forceinline__ void reduce_strip(const float* __restrict__ part,
                                             bf16* __restrict__ out, int t,
                                             int d, int row0, int rows,
                                             int col0, int splits,
                                             bool aligned) {
  constexpr int ZB = 16;
  const size_t stride = (size_t)t * d;
  if (aligned) {
    for (int i = threadIdx.x * 4; i < rows * W; i += NT * 4) {
      const int r = row0 + i / W, c = col0 + i % W;
      if (c >= d) continue;
      const float* p = part + (size_t)r * d + c;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int z0 = 0; z0 < splits; z0 += ZB) {
        float4 v[ZB];
#pragma unroll
        for (int z = 0; z < ZB; ++z)
          if (z0 + z < splits)
            v[z] = __ldcg(reinterpret_cast<const float4*>(
                p + (size_t)(z0 + z) * stride));
#pragma unroll
        for (int z = 0; z < ZB; ++z)
          if (z0 + z < splits) {
            s.x += v[z].x;
            s.y += v[z].y;
            s.z += v[z].z;
            s.w += v[z].w;
          }
      }
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * d + c);
      o[0] = __floats2bfloat162_rn(s.x, s.y);
      o[1] = __floats2bfloat162_rn(s.z, s.w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += NT) {
      const int r = row0 + i / W, c = col0 + i % W;
      if (c >= d) continue;
      const float* p = part + (size_t)r * d + c;
      float s = 0.f;
      for (int z0 = 0; z0 < splits; z0 += ZB) {
        float v[ZB];
#pragma unroll
        for (int z = 0; z < ZB; ++z)
          if (z0 + z < splits) v[z] = __ldcg(p + (size_t)(z0 + z) * stride);
#pragma unroll
        for (int z = 0; z < ZB; ++z)
          if (z0 + z < splits) s += v[z];
      }
      out[(size_t)r * d + c] = __float2bfloat16(s);
    }
  }
}

// One kernel in three modes (FUSED: phases 1 and 2; UP: phase 1 into h;
// DOWN: phase 2 from h).  Phase 1: h[BT, BF1] tiles = act(xn @ Wg) * (xn @
// Wu) (ungated: act(xn @ Wu)); each warp owns 16 h columns of all BT rows.
// Phase 2: out[BT, BN2] strips = h @ Wd; each warp owns BN2 / NW columns.
// W8: int8 codes; NORM (FUSED only): the folded RMSNorm; SILU: else GELU.
template <class C, bool W8, int MODE, bool GLU, bool NORM, bool SILU>
__global__ void __launch_bounds__(C::NT)
ffn_mma_kernel(const FfnArgs a) {
  using W = typename std::conditional<W8, int8_t, bf16>::type;
  using L = Layout<C, W8, MODE, GLU>;
  constexpr int BT = C::BT, ST = C::ST, MT = C::MT, PL = L::PL;
  constexpr int NT = C::NT, BF1 = C::BF1, BN2 = C::BN2, BK2 = C::BK2;
  constexpr int N2 = C::N2;
  static_assert(!NORM || MODE == FUSED, "UP takes normalised rows");
  static_assert(GLU || !SILU, "the MLP runs GELU");
  static_assert(N2 % 2 == 0, "phase-2 B fragments come in pairs");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* conv = reinterpret_cast<bf16*>(smem + L::RING);
  bf16* h_s = reinterpret_cast<bf16*>(smem + L::RING + L::CONV);
  __shared__ float rstd_s[NORM ? BT : 1];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t = a.t, d = a.d, f = a.f;
  const bool aligned = a.aligned != 0;
  const W* wg = static_cast<const W*>(a.wg);
  const W* wu = static_cast<const W*>(a.wu);
  const W* wd = static_cast<const W*>(a.wd);

  // This block's work, in row tile blockIdx.y.  FUSED: F columns
  // [f_begin, f_end), every strip (the plan runs it on one row tile); UP:
  // one BF1-column tile of h; DOWN: one strip over F rows [f_begin, f_end).
  const int row0 = blockIdx.y * BT;
  int f_begin, f_end, n_strips = 1, split, splits;
  if constexpr (MODE == FUSED) {
    split = blockIdx.x;
    splits = gridDim.x;
    f_begin = split * a.f_per_split;
    f_end = min(f, f_begin + a.f_per_split);
    n_strips = (d + BN2 - 1) / BN2;
  } else if constexpr (MODE == UP) {
    f_begin = blockIdx.x * BF1;
    f_end = min(f, f_begin + BF1);
    split = 0;
    splits = 1;
  } else {
    split = blockIdx.z;
    splits = gridDim.z;
    f_begin = split * a.f_per_split;
    f_end = min(f, f_begin + a.f_per_split);
  }
  const int n_ft = (f_end - f_begin + BF1 - 1) / BF1;   // phase-1 h tiles
  const int n_k2 = (f_end - f_begin + BK2 - 1) / BK2;   // phase-2 F tiles
  const int n_kt = (d + kBK - 1) / kBK;
  const int n1 = MODE != DOWN ? n_ft * n_kt : 0;
  const int n2 = MODE != UP ? n_strips * n_k2 : 0;
  const int steps = n1 + n2;
  const int hld = a.f_per_split + 8;   // FUSED's h row stride

  // Strip of phase-2 step i: blocks start at different strips, so the
  // split sums spread over them.
  auto strip_of = [&](int i) {
    return MODE == DOWN ? (int)blockIdx.x : (i / n_k2 + split) % n_strips;
  };
  // Load step `step` of the sequence into ring stage `stage`.
  auto load_step = [&](int step, int stage) {
    unsigned char* base = smem + (size_t)stage * L::STAGE;
    if (step < n1) {
      if constexpr (MODE != DOWN) {
        const int ft = step / n_kt, k0 = (step % n_kt) * kBK;
        const int fc0 = f_begin + ft * BF1;
        load_tile<bf16, BT, kBK, kLDK, NT>(reinterpret_cast<bf16*>(base),
                                           a.x, d, row0, t, k0, d, aligned);
        W* gt = reinterpret_cast<W*>(base + L::XA);
        W* ut = reinterpret_cast<W*>(base + L::XA + (GLU ? L::WT1 : 0));
        if constexpr (GLU)
          load_tile<W, kBK, BF1, L::WLDF, NT>(gt, wg, f, k0, d, fc0, f_end,
                                              aligned);
        load_tile<W, kBK, BF1, L::WLDF, NT>(ut, wu, f, k0, d, fc0, f_end,
                                            aligned);
      }
    } else if constexpr (MODE != UP) {
      const int i = step - n1;
      const int kr0 = f_begin + (i % n_k2) * BK2;
      if constexpr (MODE == DOWN) {
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          load_tile<bf16, BT, BK2, L::LDA, NT>(
              reinterpret_cast<bf16*>(base) + pl * BT * L::LDA,
              a.h + (size_t)pl * t * a.fp, a.fp, row0, t, kr0, f_end,
              aligned);
      }
      load_tile<W, BK2, BN2, L::WLDN, NT>(reinterpret_cast<W*>(base + L::AD),
                                          wd, d, kr0, f_end,
                                          strip_of(i) * BN2, d, aligned);
    }
  };

  // The prologue's loads fly while the row statistics are taken.
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  if constexpr (NORM) {
    for (int r = warp; r < BT; r += C::NW) {
      const float rs = row0 + r < t ? row_rstd(a.x + (size_t)(row0 + r) * d,
                                               d, a.eps, lane, aligned)
                                    : 0.f;
      if (lane == 0) rstd_s[r] = rs;
    }
  }

  // One step of the ring: wait for step's tiles, start step + ST - 1's;
  // the stage holding step's tiles.
  auto advance = [&](int step) {
    cp_async_wait<ST - 2>();   // step's tiles have landed
    __syncthreads();           // ... for all, and step - 1 is done
    if (step + ST - 1 < steps) load_step(step + ST - 1, (step + ST - 1) % ST);
    cp_async_commit();
    return smem + (size_t)(step % ST) * L::STAGE;
  };

  if constexpr (MODE != DOWN) {
    float acc1[2][MT][2][4];   // gate (0) and up (1)
    for (int step = 0; step < n1; ++step) {
      unsigned char* base = advance(step);
      const int ft = step / n_kt, kt = step % n_kt, k0 = kt * kBK;
      bf16* xa = reinterpret_cast<bf16*>(base);
      const bf16* gt =
          W8 ? conv : reinterpret_cast<const bf16*>(base + L::XA);
      const bf16* ut =
          W8 ? conv + (GLU ? kBK * L::LDF : 0)
             : reinterpret_cast<const bf16*>(base + L::XA +
                                             (GLU ? L::WT1 : 0));
      if constexpr (W8 || NORM) {
        if constexpr (W8) {
          const int8_t* cb = reinterpret_cast<const int8_t*>(base + L::XA);
          if constexpr (GLU)
            codes_to_bf16<kBK, BF1, L::LDF, NT>(conv, cb);
          codes_to_bf16<kBK, BF1, L::LDF, NT>(
              conv + (GLU ? kBK * L::LDF : 0), cb + (GLU ? L::WT1 : 0));
        }
        if constexpr (NORM) {
          for (int i = tid; i < BT * kBK / 2; i += NT) {
            const int r = i / (kBK / 2), c = (i % (kBK / 2)) * 2;
            __nv_bfloat162* p =
                reinterpret_cast<__nv_bfloat162*>(xa + r * kLDK + c);
            const float2 v = __bfloat1622float2(*p);
            const float rs = rstd_s[r];
            const int k = k0 + c;
            const float s0 = k < d ? __bfloat162float(a.nscale[k]) : 0.f;
            const float s1 =
                k + 1 < d ? __bfloat162float(a.nscale[k + 1]) : 0.f;
            *p = __floats2bfloat162_rn(norm_elem(v.x, rs, s0),
                                       norm_elem(v.y, rs, s1));
          }
        }
        __syncthreads();
      }
      if (kt == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc1[q][i][j][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(af[i], xa + (i * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * kLDK +
                             ks * 16 + (lane >> 4) * 8);
        const int boff =
            (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LDF +
            warp * 16 + ((lane >> 4) & 1) * 8;
        uint32_t b[4];
        if constexpr (GLU) {
          ldsm_x4_trans(b, gt + boff);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc1[0][i][0], af[i], b[0], b[1]);
            mma_bf16(acc1[0][i][1], af[i], b[2], b[3]);
          }
        }
        ldsm_x4_trans(b, ut + boff);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc1[1][i][0], af[i], b[0], b[1]);
          mma_bf16(acc1[1][i][1], af[i], b[2], b[3]);
        }
      }
      if (kt == n_kt - 1) {
        // h = act(gate) * up (ungated: act(up)), 0 past F; rounded to
        // bf16, or (W8) split into hi and lo planes.  FUSED keeps it in
        // shared memory (visible after the next step's barrier), UP
        // writes it out.
        const int fc0 = f_begin + ft * BF1;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = i * 16 + g + hr * 8;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = warp * 16 + j * 8 + 2 * t4;
              float hv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int fc = fc0 + c + e;
                float gv = acc1[0][i][j][2 * hr + e];
                float uv = acc1[1][i][j][2 * hr + e];
                float v = 0.f;
                if (fc < f_end) {
                  if constexpr (W8) {
                    if constexpr (GLU) gv *= a.gs[fc];
                    uv *= a.us[fc];
                  }
                  v = GLU ? act_silu_or_gelu(SILU, gv) * uv
                          : gelu_tanh(uv);
                }
                hv[e] = v;
              }
              const __nv_bfloat162 hi = __floats2bfloat162_rn(hv[0], hv[1]);
              __nv_bfloat162 lo = hi;
              if constexpr (W8) {
                const float2 hf = __bfloat1622float2(hi);
                lo = __floats2bfloat162_rn(hv[0] - hf.x, hv[1] - hf.y);
              }
              if constexpr (MODE == FUSED) {
                const int off = r * hld + ft * BF1 + c;
                *reinterpret_cast<__nv_bfloat162*>(h_s + off) = hi;
                if constexpr (W8)
                  *reinterpret_cast<__nv_bfloat162*>(h_s + BT * hld +
                                                     off) = lo;
              } else if (row0 + r < t) {
                const size_t off = (size_t)(row0 + r) * a.fp + fc0 + c;
                *reinterpret_cast<__nv_bfloat162*>(a.h + off) = hi;
                if constexpr (W8)
                  *reinterpret_cast<__nv_bfloat162*>(
                      a.h + (size_t)t * a.fp + off) = lo;
              }
            }
          }
      }
    }
  }
  if constexpr (MODE != UP) {
    float acc2[MT][N2][4];
    for (int step = n1; step < steps; ++step) {
      unsigned char* base = advance(step);
      const int i2 = step - n1, kk = i2 % n_k2, strip = strip_of(i2);
      const bf16* wt = W8 ? conv
                          : reinterpret_cast<const bf16*>(base + L::AD);
      if constexpr (W8) {
        codes_to_bf16<BK2, BN2, L::LDN, NT>(
            conv, reinterpret_cast<const int8_t*>(base + L::AD));
        __syncthreads();
      }
      // A: FUSED's h slice, or DOWN's landed h tile (per plane).
      const bf16* ab = MODE == FUSED ? h_s + kk * BK2
                                     : reinterpret_cast<const bf16*>(base);
      const int lda = MODE == FUSED ? hld : L::LDA;
      const int plane = BT * lda;
      if (kk == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < N2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < BK2 / 16; ++ks) {
        uint32_t af[PL][MT][4];
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            ldsm_x4(af[pl][i],
                    ab + pl * plane +
                        (i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lda +
                        ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < N2 / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, wt + (ks * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * L::LDN +
                               warp * (BN2 / C::NW) + np * 16 +
                               ((lane >> 4) & 1) * 8);
#pragma unroll
          for (int pl = 0; pl < PL; ++pl)
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_bf16(acc2[i][2 * np], af[pl][i], b[0], b[1]);
              mma_bf16(acc2[i][2 * np + 1], af[pl][i], b[2], b[3]);
            }
        }
      }
      if (kk == n_k2 - 1) {
        // The strip is done: out (one split) or this split's partial (the
        // int8 down scale on each), then the arrival.
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = row0 + i * 16 + g + hr * 8;
            if (r >= t) continue;
#pragma unroll
            for (int j = 0; j < N2; ++j) {
              const int c =
                  strip * BN2 + warp * (BN2 / C::NW) + j * 8 + 2 * t4;
              float v0 = acc2[i][j][2 * hr], v1 = acc2[i][j][2 * hr + 1];
              if constexpr (W8) {
                if (c < d) v0 *= a.ds[c];
                if (c + 1 < d) v1 *= a.ds[c + 1];
              }
              if (splits > 1) {
                float* p = a.part + ((size_t)split * t + r) * d + c;
                if (aligned) {
                  if (c < d)
                    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
                } else {
                  if (c < d) p[0] = v0;
                  if (c + 1 < d) p[1] = v1;
                }
              } else {
                bf16* o = a.out + (size_t)r * d + c;
                if (aligned) {
                  if (c < d)
                    *reinterpret_cast<__nv_bfloat162*>(o) =
                        __floats2bfloat162_rn(v0, v1);
                } else {
                  if (c < d) o[0] = __float2bfloat16(v0);
                  if (c + 1 < d) o[1] = __float2bfloat16(v1);
                }
              }
            }
          }
        if (splits > 1) {
          __threadfence();
          __syncthreads();
          if (tid == 0) {
            int* ctr = a.counters +
                       blockIdx.y * (MODE == DOWN ? gridDim.x : n_strips) +
                       strip;
            is_last = atomicAdd(ctr, 1) == splits - 1;
            if (is_last) *ctr = 0;   // ready for the next launch
          }
          __syncthreads();
          if (is_last) {
            __threadfence();
            reduce_strip<BN2, NT>(a.part, a.out, t, d, row0,
                                  min(BT, t - row0), strip * BN2, splits,
                                  aligned);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <class C, bool W8, int MODE, bool GLU, bool NORM, bool SILU>
int launch_mma(const FfnArgs& a, dim3 grid, cudaStream_t stream) {
  const auto kern = ffn_mma_kernel<C, W8, MODE, GLU, NORM, SILU>;
  // The dynamic shared-memory limit, raised per instance as FUSED's h
  // slice grows (at most 210 KB).
  static size_t smem_set = 0;
  const size_t smem = Layout<C, W8, MODE, GLU>::bytes(a.f_per_split);
  const cudaError_t err = raise_smem(kern, smem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, C::NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
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

// bf16 on the tensor cores; one signature for the six instances (unused
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
    FfnArgs a;                                                                \
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
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_mma_bf16, false, true, true, true)
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_gelu_mma_bf16, false, true, false,
                       false)
REPRO_STREAMED_FFN_MMA(repro_streamed_mlp_mma_bf16, false, false, false, false)
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_w8_mma_bf16, true, true, true, true)
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_gelu_w8_mma_bf16, true, true, false,
                       false)
REPRO_STREAMED_FFN_MMA(repro_streamed_mlp_w8_mma_bf16, true, false, false,
                       false)

extern "C" int repro_streamed_ffn_f32(const void* x, const void* nscale,
                                      const void* wg, const void* wu,
                                      const void* wd, void* out, void* part,
                                      int t, int d, int f, int tile,
                                      float eps, void* stream) {
  return launch<float, float, true, true, true>(
      x, nscale, wg, wu, wd, kNoScales, out, part, t, d, f, tile, eps,
      stream);
}

extern "C" int repro_streamed_mlp_f32(const void* x, const void* wu,
                                      const void* wd, void* out, void* part,
                                      int t, int d, int f, int tile,
                                      void* stream) {
  return launch<float, float, false, false, false>(
      x, nullptr, nullptr, wu, wd, kNoScales, out, part, t, d, f, tile, 0.f,
      stream);
}

// The int8 twins: wg/wu/wd int8 codes; gs/us float32 [F], ds float32 [D].
extern "C" int repro_streamed_ffn_w8_f32(const void* x, const void* nscale,
                                         const void* wg, const void* gs,
                                         const void* wu, const void* us,
                                         const void* wd, const void* ds,
                                         void* out, void* part, int t, int d,
                                         int f, int tile, float eps,
                                         void* stream) {
  return launch<float, int8_t, true, true, true>(
      x, nscale, wg, wu, wd, scales(gs, us, ds), out, part, t, d, f, tile,
      eps, stream);
}

extern "C" int repro_streamed_mlp_w8_f32(const void* x, const void* wu,
                                         const void* us, const void* wd,
                                         const void* ds, void* out,
                                         void* part, int t, int d, int f,
                                         int tile, void* stream) {
  return launch<float, int8_t, false, false, false>(
      x, nullptr, nullptr, wu, wd, scales(nullptr, us, ds), out, part, t, d,
      f, tile, 0.f, stream);
}

// The GELU GLU without a folded norm (zamba2's shared block): no nscale.
extern "C" int repro_streamed_ffn_gelu_f32(const void* x, const void* wg,
                                           const void* wu, const void* wd,
                                           void* out, void* part, int t,
                                           int d, int f, int tile,
                                           void* stream) {
  return launch<float, float, true, false, false>(
      x, nullptr, wg, wu, wd, kNoScales, out, part, t, d, f, tile, 0.f,
      stream);
}

extern "C" int repro_streamed_ffn_gelu_w8_f32(const void* x, const void* wg,
                                              const void* gs, const void* wu,
                                              const void* us, const void* wd,
                                              const void* ds, void* out,
                                              void* part, int t, int d, int f,
                                              int tile, void* stream) {
  return launch<float, int8_t, true, false, false>(
      x, nullptr, wg, wu, wd, scales(gs, us, ds), out, part, t, d, f, tile,
      0.f, stream);
}
