// moe_experts (K12): the MoE expert FFN
//   out[T, D] = sum over e = 0..E-1, in order, of
//               fl32(((silu(x @ Wg_e) * (x @ Wu_e)).to(T) @ Wd_e) * g[:, e]),
// products summed in float32, each gated product rounded on its own, the
// sum accumulated in float32 from +0 in expert order, out rounded to x's
// dtype T.  Only SiLU is built (the granite configs); the wrapper refuses
// other activations on the card.
//
// Replaces the TPU kernel src/repro/kernels/moe_experts.py::_moe_kernel
// (moe_experts_pallas, pallas_call at :68).  That kernel computes every
// expert for every token (the dense gather: E / top-k = 4-5x the work the
// gates keep), walking the experts as the sequential inner grid dimension
// with a [bt, D] float32 accumulator in VMEM.  Here only the kept (token,
// expert) pairs are computed.  That is exact: a dropped pair adds y * 0 =
// +-0 to the reference's float32 sum, which leaves it unchanged, except
//   - where y is not finite on a dropped pair: the reference gets NaN there,
//     this kernel does not; and
//   - the sign of an all-zero sum (-0 + +0 is +0).
// What bounds it on the H100: the weights of the experts some token keeps
// (3 D F values each: at granite-3b 24 of 40 at a 4-token decode step, all
// 40 from about 20 tokens on, 189 MB in bf16) up to a whole prompt, the 6 D
// F operations per kept pair at a training step.  Every grid is sized from
// (T, D, F, E) alone and nothing is read back to the host; a block whose
// rows start at or past its expert's count returns at once.
// bfloat16, on the tensor cores through ffn_mma.cuh's body (K4's cp.async
// ring and mma.sync m16n8k16), x rows gathered per expert, the expert on
// blockIdx.z:
//   - up to 64 rows (decode, verify: bytes-bound) one FUSED launch over
//     (F range, row tile, expert): each block lists its expert's kept
//     tokens from the gate column (g != 0, ascending; not "top-k": the
//     router keeps every tie at the threshold), computes its h slice in
//     shared memory and its rows' partial of every output column;
//     moe_combine_kernel then sums each token's kept experts (folding that
//     sum into the last block to arrive on a token made the launch's tail
//     longer).  The F ranges are 128 columns (common.py::moe_plan: from F
//     alone), and both tile classes take the same 16-deep MMA steps over D
//     and over the range, so a (token, expert) pair runs the same sequence
//     at every T from 1 to 64, whatever its expert's count or its place in
//     the list (an MMA output row depends on its own A row only): exact
//     speculative acceptance.  The class follows T: one block of 8 warps
//     on an SM while the touched experts' blocks fit one wave (T <= 8),
//     else two blocks of smaller stages over 16-row tiles of each list
//     (faster at granite-3b's 16-64 rows than one block an SM or 64-row
//     tiles; PERF.md section 6, K12);
//   - above, two passes: moe_route_kernel writes each expert's kept tokens
//     (idx [E, T], counts [E]), UP writes h rows [E, T, F] by list
//     position, DOWN multiplies 64-row tiles of each list by Wd_e, and the
//     combine.
// Rows copied one bulk copy each (cp.async.bulk on an mbarrier) ran slower
// than the cp.async ring on the H100, so the ring stays.
// float32 on the CUDA cores (TF32 would break the float32 checks): the
// route, then moe_h_kernel and moe_out_kernel over each list's rows (every
// output element one thread's fmaf chain over D, then over F, in order: the
// dense kernel's chains, so its outputs stay bit-equal), then the combine.
// The sums: y (float32, ungated) per (F split, expert, token); per token,
// e = 0..E-1 in order over the kept experts only, y summed over the splits
// in split order, s += fl32(y * g) (no fused multiply-add), out = s
// rounded to T.  No value atomics: results repeat from run to run.
#include "common.cuh"
#include "ffn_mma.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int NT = 256;
constexpr int BK = 16;
constexpr int kRouteThreads = 256;

// Expert e = blockIdx.x: idx[e, 0:count) = the tokens whose gate for e is
// not zero, ascending; counts[e] = count.
template <typename T>
__global__ void __launch_bounds__(kRouteThreads)
moe_route_kernel(const T* __restrict__ gates, int* __restrict__ idx,
                 int* __restrict__ counts, int t, int n_e) {
  constexpr int NWARP = kRouteThreads / 32;
  __shared__ int warp_n[NWARP];
  const int e = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int t0 = 0; t0 < t; t0 += kRouteThreads) {
    const int tok = t0 + threadIdx.x;
    const bool keep =
        tok < t && to_f(gates[(size_t)tok * n_e + e]) != 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int off = base, all = base;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      off += w < warp ? warp_n[w] : 0;
      all += warp_n[w];
    }
    if (keep)
      idx[(size_t)e * t + off + __popc(m & ((1u << lane) - 1u))] = tok;
    base = all;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[e] = base;
}

// float32, phase 1: H[e, row0:row0+BT, f0:f0+BF] for expert e = blockIdx.z
// over rows row0.. of its list (H's rows are list positions).
template <int BT, int BF, int TM, int TN>
__global__ void __launch_bounds__(NT)
moe_h_kernel(const float* __restrict__ x, const float* __restrict__ wg,
             const float* __restrict__ wu, const int* __restrict__ idx,
             const int* __restrict__ counts, float* __restrict__ h, int t,
             int d, int f) {
  static_assert((BT / TM) * (BF / TN) == NT, "phase-1 thread layout");
  __shared__ float xs[BK][BT + 1];
  __shared__ float gs[BK][BF];
  __shared__ float us[BK][BF];
  __shared__ int rows_s[BT];
  const int e = blockIdx.z, n = counts[e];
  const int f0 = blockIdx.x * BF, row0 = blockIdx.y * BT;
  if (row0 >= n) return;
  const float* wge = wg + (size_t)e * d * f;
  const float* wue = wu + (size_t)e * d * f;
  const int tid = threadIdx.x;
  for (int i = tid; i < BT; i += NT)
    rows_s[i] = row0 + i < n ? idx[(size_t)e * t + row0 + i] : 0;
  __syncthreads();
  const int tr = tid / (BF / TN), tc = tid % (BF / TN);
  float g[TM][TN], u[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) g[i][j] = u[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BT * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gk = k0 + kk;
      xs[kk][r] = (row0 + r < n && gk < d)
                      ? x[(size_t)rows_s[r] * d + gk]
                      : 0.f;
    }
    for (int i = tid; i < BK * BF; i += NT) {
      const int kk = i / BF, c = i % BF;
      const int gk = k0 + kk, gc = f0 + c;
      const bool ok = gk < d && gc < f;
      const size_t off = (size_t)gk * f + gc;
      gs[kk][c] = ok ? wge[off] : 0.f;
      us[kk][c] = ok ? wue[off] : 0.f;
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
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = f0 + tc * TN + j;
      if (gc < f) h[((size_t)e * t + gr) * f + gc] = silu(g[i][j]) * u[i][j];
    }
  }
}

// float32, phase 2: y = H_e[rows] @ Wd_e for the BT x BN tile at (row0,
// col0) of expert e = blockIdx.z's list, to part[e, token, :].
template <int BT, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT)
moe_out_kernel(const float* __restrict__ h, const float* __restrict__ wd,
               const int* __restrict__ idx, const int* __restrict__ counts,
               float* __restrict__ part, int t, int d, int f) {
  static_assert((BT / TM) * (BN / TN) == NT, "phase-2 thread layout");
  __shared__ float hs[BK][BT + 1];
  __shared__ float ws[BK][BN];
  __shared__ int rows_s[BT];
  const int e = blockIdx.z, n = counts[e];
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BT;
  if (row0 >= n) return;
  const int tid = threadIdx.x;
  for (int i = tid; i < BT; i += NT)
    rows_s[i] = row0 + i < n ? idx[(size_t)e * t + row0 + i] : 0;
  __syncthreads();
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const float* he = h + (size_t)e * t * f;
  const float* wde = wd + (size_t)e * f * d;
  float y[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) y[i][j] = 0.f;
  for (int k0 = 0; k0 < f; k0 += BK) {
    for (int i = tid; i < BT * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      hs[kk][r] = (gr < n && gk < f) ? he[(size_t)gr * f + gk] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < f && gc < d) ? wde[(size_t)gk * d + gc] : 0.f;
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
    const int r = tr * TM + i;
    if (row0 + r >= n) continue;
    float* p = part + ((size_t)e * t + rows_s[r]) * d;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc * TN + j;
      if (gc < d) p[gc] = y[i][j];
    }
  }
}

// The experts token `tok` keeps (g != 0), ascending, and their gates,
// into kept_e / kept_g by one warp; returns their count (on every lane).
template <typename T>
__device__ __forceinline__ int moe_kept(const T* __restrict__ gates, int tok,
                                        int n_e, int* kept_e, float* kept_g,
                                        int lane) {
  int n = 0;
  for (int e0 = 0; e0 < n_e; e0 += 32) {
    const int e = e0 + lane;
    const float g = e < n_e ? to_f(gates[(size_t)tok * n_e + e]) : 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, g != 0.f);
    if (g != 0.f) {
      const int k = n + __popc(m & ((1u << lane) - 1u));
      kept_e[k] = e;
      kept_g[k] = g;
    }
    n += __popc(m);
  }
  return n;
}

// out[tok, :] = sum over the n kept experts k, in order from +0, of
// fl32(y * kept_g[k]), y the `splits` float32 partials [splits, E, T, D]
// at (kept_e[k], tok) summed in split order; by NT threads, VEC columns
// each.  The loads of UNROLL experts times ZC splits are issued before any
// is added (a split loop that adds as it loads waits on each load in turn).
template <typename T, int VEC, int NT>
__device__ __forceinline__ void moe_sum_row(const float* __restrict__ part,
                                            T* __restrict__ out, int t,
                                            int d, int n_e, int splits,
                                            int tok, const int* kept_e,
                                            const float* kept_g, int n,
                                            int c0, int c_end) {
  constexpr int UNROLL = 4, ZC = 4;
  const size_t zstride = (size_t)n_e * t * d;
  for (int c = c0 + threadIdx.x * VEC; c < c_end; c += NT * VEC) {
    float s[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) s[v] = 0.f;
    for (int k0 = 0; k0 < n; k0 += UNROLL) {
      float y[UNROLL][VEC];
      for (int z0 = 0; z0 < splits; z0 += ZC) {
        float q[UNROLL][ZC][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int z = 0; z < ZC; ++z) {
            if (k0 + u >= n || z0 + z >= splits) continue;
            const float* p = part + (size_t)(z0 + z) * zstride +
                             ((size_t)kept_e[k0 + u] * t + tok) * d + c;
            if constexpr (VEC == 4) {
              const float4 w = __ldcg(reinterpret_cast<const float4*>(p));
              q[u][z][0] = w.x;
              q[u][z][1] = w.y;
              q[u][z][2] = w.z;
              q[u][z][3] = w.w;
            } else {
              q[u][z][0] = __ldcg(p);
            }
          }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int z = 0; z < ZC; ++z) {
            if (k0 + u >= n || z0 + z >= splits) continue;
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              y[u][v] = z0 + z == 0 ? q[u][z][v] : y[u][v] + q[u][z][v];
          }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k0 + u >= n) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          s[v] = __fadd_rn(s[v], __fmul_rn(y[u][v], kept_g[k0 + u]));
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      out[(size_t)tok * d + c + v] = from_f<T>(s[v]);
  }
}

// out[tok, :] = sum over the kept experts e, in order from +0, of fl32(y *
// g[tok, e]), y the F splits' partials summed in split order.  Block
// (column chunk, token): one warp lists the token's kept experts and their
// gates in shared memory first, so the partials' loads wait on no gate
// load.
constexpr int kCombineThreads = 128;
constexpr int kMaxExperts = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kCombineThreads)
moe_combine_kernel(const float* __restrict__ part, const T* __restrict__ gates,
                   T* __restrict__ out, int t, int d, int n_e, int splits) {
  __shared__ int kept_e[kMaxExperts];
  __shared__ float kept_g[kMaxExperts];
  __shared__ int n_kept;
  const int tok = blockIdx.y;
  if (threadIdx.x < 32) {
    const int n = moe_kept(gates, tok, n_e, kept_e, kept_g, threadIdx.x);
    if (threadIdx.x == 0) n_kept = n;
  }
  __syncthreads();
  const int c0 = blockIdx.x * kCombineThreads * VEC;
  moe_sum_row<T, VEC, kCombineThreads>(part, out, t, d, n_e, splits, tok,
                                       kept_e, kept_g, n_kept, c0,
                                       min(d, c0 + kCombineThreads * VEC));
}

template <typename T>
cudaError_t route(const void* gates, int* idx, int* counts, int t, int n_e,
                  cudaStream_t s) {
  moe_route_kernel<T><<<n_e, kRouteThreads, 0, s>>>(
      static_cast<const T*>(gates), idx, counts, t, n_e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t combine(const float* part, const void* gates, void* out, int t,
                    int d, int n_e, int splits, cudaStream_t s) {
  const T* g = static_cast<const T*>(gates);
  T* o = static_cast<T*>(out);
  if (d % 4 == 0)
    moe_combine_kernel<T, 4>
        <<<dim3(cdiv(d, 4 * kCombineThreads), t), kCombineThreads, 0, s>>>(
            part, g, o, t, d, n_e, splits);
  else
    moe_combine_kernel<T, 1>
        <<<dim3(cdiv(d, kCombineThreads), t), kCombineThreads, 0, s>>>(
            part, g, o, t, d, n_e, splits);
  return cudaGetLastError();
}

// The tensor-core body (ffn_mma.cuh) over each expert's kept rows.
template <class C, int MODE>
__global__ void __launch_bounds__(C::NT) moe_mma_kernel(const FfnArgs a) {
  ffn_mma_body<C, false, MODE, true, false, true, true>(a);
}

template <class C, int MODE>
int launch_mma(const FfnArgs& a, dim3 grid, cudaStream_t stream) {
  static size_t smem_set = 0;
  return launch_ffn_mma<C, false, MODE, true>(moe_mma_kernel<C, MODE>,
                                              &smem_set, a, grid, stream);
}

// The fused tile classes.  Each takes phase 2 in 32-deep F tiles over the
// plan's 128-column F range, so a row runs the same MMA sequence in both
// and the launcher may pick by row count: up to 8 rows 8 warps and 5
// stages of 64-deep D tiles, one block on an SM (DecodeRows: fastest while
// the touched experts' blocks fit one wave); above, 16-row tiles of each
// list (blocks past its count return), 8 warps and 5 stages of 32-deep D
// tiles, two blocks on an SM.
using MoeRows16 = TileCfg<16, 8, 256, 32, 5, 32>;

// bf16: mode 0 (FUSED; the plan takes it up to 64 rows) `splits` blocks of
// `f_per_split` F columns per row tile and expert, each listing its
// expert's tokens;
// mode 1 (two passes, one split) the route, UP over 64-column tiles of h,
// DOWN over 128-column strips.  Then the combine.
int run_bf16(FfnArgs a, int mode, int splits, cudaStream_t st) {
  int status;
  if (mode == 0) {
    const dim3 grid(splits, cdiv(a.t, 16), a.n_e);
    status = a.t <= 8 ? launch_mma<DecodeRows, FUSED>(a, grid, st)
                      : launch_mma<MoeRows16, FUSED>(a, grid, st);
  } else {
    using C = PassRows;
    splits = 1;
    const cudaError_t err = route<bf16>(a.gates, const_cast<int*>(a.idx),
                                        const_cast<int*>(a.counts), a.t,
                                        a.n_e, st);
    if (err != cudaSuccess) return (int)err;
    const int row_tiles = cdiv(a.t, C::BT);
    status = launch_mma<C, UP>(a, dim3(a.fp / C::BF1, row_tiles, a.n_e), st);
    if (status == 0)
      status = launch_mma<C, DOWN>(
          a, dim3(cdiv(a.d, C::BN2), row_tiles, a.n_e), st);
  }
  if (status != 0) return status;
  return (int)combine<bf16>(a.part, a.gates, a.out, a.t, a.d, a.n_e, splits,
                            st);
}

// float32: 8-row tiles up to 16 rows, else 64-row tiles (either gives the
// same bits: each output element is one thread's chain).
int run_f32(const float* x, const void* gates, const float* wg,
            const float* wu, const float* wd, int* idx, int* counts,
            float* h, float* part, void* out, int t, int d, int f, int n_e,
            cudaStream_t s) {
  cudaError_t err = route<float>(gates, idx, counts, t, n_e, s);
  if (err != cudaSuccess) return (int)err;
  if (t <= 16) {
    moe_h_kernel<8, 128, 1, 4><<<dim3(cdiv(f, 128), cdiv(t, 8), n_e), NT, 0,
                                 s>>>(x, wg, wu, idx, counts, h, t, d, f);
  } else {
    moe_h_kernel<64, 64, 4, 4><<<dim3(cdiv(f, 64), cdiv(t, 64), n_e), NT, 0,
                                 s>>>(x, wg, wu, idx, counts, h, t, d, f);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (t <= 16) {
    moe_out_kernel<8, 64, 1, 2><<<dim3(cdiv(d, 64), cdiv(t, 8), n_e), NT, 0,
                                  s>>>(h, wd, idx, counts, part, t, d, f);
  } else {
    moe_out_kernel<64, 64, 4, 4><<<dim3(cdiv(d, 64), cdiv(t, 64), n_e), NT,
                                   0, s>>>(h, wd, idx, counts, part, t, d, f);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)combine<float>(part, gates, out, t, d, n_e, 1, s);
}

}  // namespace

// Workspaces (the wrapper allocates them; none needs zeroing): idx [E, T]
// and counts [E] int32 (bf16: mode 1 only); bf16: h [E, T, round_up(F,
// 64)] bf16 (mode 1 only), part [splits, E, T, D] float32; float32: h [E,
// T, F], part [E, T, D] float32.  `aligned`: D and F multiples of 16, every
// operand 16-byte aligned.  The bf16 plan is common.py::moe_plan.
extern "C" int repro_moe_experts_bf16(const void* x, const void* gates,
                                      const void* wg, const void* wu,
                                      const void* wd, void* idx, void* counts,
                                      void* h, void* part, void* out, int t,
                                      int d, int f, int n_e, int mode,
                                      int f_per_split, int splits,
                                      int aligned, void* stream) {
  if (t < 1 || t > 65535 || d < 1 || f < 1 || n_e < 1 || n_e > kMaxExperts ||
      (mode == 0 && t > 64))
    return (int)cudaErrorInvalidValue;
  FfnArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.gates = static_cast<const bf16*>(gates);
  a.wg = wg;
  a.wu = wu;
  a.wd = wd;
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.h = static_cast<bf16*>(h);
  a.idx = static_cast<const int*>(idx);
  a.counts = static_cast<const int*>(counts);
  a.t = t;
  a.d = d;
  a.f = f;
  a.fp = cdiv(f, 64) * 64;
  a.f_per_split = f_per_split;
  a.aligned = aligned;
  a.n_e = n_e;
  return run_bf16(a, mode, splits, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_moe_experts_f32(const void* x, const void* gates,
                                     const void* wg, const void* wu,
                                     const void* wd, void* idx, void* counts,
                                     void* h, void* part, void* out, int t,
                                     int d, int f, int n_e, void* stream) {
  if (t < 1 || t > 65535 || d < 1 || f < 1 || n_e < 1 || n_e > kMaxExperts)
    return (int)cudaErrorInvalidValue;
  return run_f32(static_cast<const float*>(x), gates,
                 static_cast<const float*>(wg), static_cast<const float*>(wu),
                 static_cast<const float*>(wd), static_cast<int*>(idx),
                 static_cast<int*>(counts), static_cast<float*>(h),
                 static_cast<float*>(part), out, t, d, f, n_e,
                 static_cast<cudaStream_t>(stream));
}
