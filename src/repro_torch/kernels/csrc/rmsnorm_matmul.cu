// rmsnorm_matmul: out[T, N] = (rms_norm(x) * (1 + scale)).to(T) @ W[D, N].
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm_matmul.py::_kernel
// (pallas_call at :81).  The TPU kernel keeps the full D row of x resident
// in VMEM; on Hopper a 64-row tile at D = 4096 is already 512 KB against
// 227 KB of shared memory per block, so the rows' inverse RMS is taken
// first, over the full row, and x streams through in K tiles, normalised on
// the way to the product.  The weight-only int8 twin (K10a) replaces
// ::_kernel_w8 (the same pallas_call with w_scale): W holds int8 codes, the
// normalised x stays float32, and the column scale multiplies each output
// after the whole K reduction.  The full-precision kernel also runs the
// final norm and LM head of the RMSNorm configs over the padded vocabulary
// (never int8), so that call is row-invariant too.
//
// bfloat16 (K3 and K10a) runs rmsnorm_mma_kernel, on the tensor cores:
// mma_gemm.cuh's GEMM with its NORM (K3) or NORM_W8 (K10a) hook — each
// landed x tile normalised in place and rounded to bf16 (K10a: hi and lo
// bf16 planes of the float32 row, int8 codes converted to bf16 in shared
// memory).  What bounds it on the H100: at decode and verify (T <= 20) and
// at the LM heads the weight bytes, 3.35 TB/s (int8 codes halve them); at
// a prefill chunk and a training step the products, 2 T D N at 989 TFLOP/s.
//   - Up to 64 rows (Decode and Verify classes), one launch: each block
//     first takes its rows' rstd (mma_gemm.cuh::block_rstd, one fixed
//     order per row) while its first tiles fly, and common.py::mma_plan
//     sizes the K split from (D, N, SMs) alone, so a verify row equals its
//     decode row bit for bit (q/k/v and the LM head);
//   - above 64 rows a row pass (rmsnorm_rstd_kernel) writes every row's
//     rstd first and the Large class reads it: 128 x 128 blocks would
//     otherwise each re-read their rows' whole D.
// float32 keeps the CUDA-core kernel of tiled_matmul.cuh (NORM = true):
// TF32 would break the float32 checks against the reference.
#include "mma_gemm.cuh"
#include "tiled_matmul.cuh"

using namespace repro;

namespace {

template <class C, int OP>
__global__ void __launch_bounds__(C::NT, 2)
rmsnorm_mma_kernel(const GemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_block<C, OP>(a, smem_raw);
}

// rstd[r] = 1 / sqrt(mean(x[r]^2) + eps), one warp per row.
__global__ void __launch_bounds__(128)
rmsnorm_rstd_kernel(const bf16* __restrict__ x, float* __restrict__ rstd,
                    int t, int d, float eps, int aligned) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= t) return;
  const float rs = row_rstd(x + (size_t)row * d, d, eps, threadIdx.x & 31,
                            aligned != 0);
  if ((threadIdx.x & 31) == 0) rstd[row] = rs;
}

// The tile class follows from T, as common.py::mma_plan assumes; above 64
// rows the row pass first fills `rstd` [T].
template <int OP>
int run_mma(GemmArgs a, float* rstd, int splits, cudaStream_t stream) {
  if (a.m == 0 || a.n == 0) return (int)cudaGetLastError();
  if (a.m <= 16)
    return launch_gemm<Decode, OP>(rmsnorm_mma_kernel<Decode, OP>, a, splits,
                                   stream);
  if (a.m <= 64)
    return launch_gemm<Verify, OP>(rmsnorm_mma_kernel<Verify, OP>, a, splits,
                                   stream);
  rmsnorm_rstd_kernel<<<cdiv(a.m, 4), 128, 0, stream>>>(a.x, rstd, a.m, a.k,
                                                        a.eps, a.aligned);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  a.rstd = rstd;
  return launch_gemm<Large, OP>(rmsnorm_mma_kernel<Large, OP>, a, splits,
                                stream);
}

}  // namespace

extern "C" int repro_rmsnorm_matmul_f32(const void* x, const void* scale,
                                        const void* w, void* out, void* part,
                                        int t, int d, int n, int small,
                                        int k_per_split, int splits,
                                        float eps, void* stream) {
  return tiled_matmul<float, float, true>(
      x, scale, w, nullptr, out, part, t, d, n, small, k_per_split, splits,
      eps, static_cast<cudaStream_t>(stream));
}

// w: int8 codes [D, N]; w_scale: float32 [N].
extern "C" int repro_rmsnorm_matmul_w8_f32(const void* x, const void* scale,
                                           const void* w, const void* w_scale,
                                           void* out, void* part, int t,
                                           int d, int n, int small,
                                           int k_per_split, int splits,
                                           float eps, void* stream) {
  return tiled_matmul<float, int8_t, true>(
      x, scale, w, w_scale, out, part, t, d, n, small, k_per_split, splits,
      eps, static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores; one signature for K3 and K10a (`w_scale` null
// for K3).  `part` [splits, T, N] float32 and `counters` (one int32 per
// output tile, all 0) are needed only when splits > 1, `rstd` float32 [T]
// only above 64 rows; `aligned`: D a multiple of 8, N of 8 (bf16 W) or 16
// (int8 codes), x, scale and W 16-byte aligned.  The plan is
// common.py::mma_plan.
#define REPRO_RMSNORM_MATMUL_MMA(NAME, OP)                                    \
  extern "C" int NAME(const void* x, const void* scale, const void* w,       \
                      const void* w_scale, void* out, void* part,             \
                      void* counters, void* rstd, int t, int d, int n,        \
                      int k_per_split, int splits, int aligned, float eps,    \
                      void* stream) {                                         \
    GemmArgs a{};                                                             \
    a.x = static_cast<const bf16*>(x);                                        \
    a.w = w;                                                                  \
    a.scale = static_cast<const bf16*>(scale);                                \
    a.wscale = static_cast<const float*>(w_scale);                            \
    a.out = static_cast<bf16*>(out);                                          \
    a.part = static_cast<float*>(part);                                       \
    a.counters = static_cast<int*>(counters);                                 \
    a.m = t;                                                                  \
    a.k = d;                                                                  \
    a.n = n;                                                                  \
    a.k_per_split = k_per_split;                                              \
    a.aligned = aligned;                                                      \
    a.eps = eps;                                                              \
    return run_mma<OP>(a, static_cast<float*>(rstd), splits,                  \
                       static_cast<cudaStream_t>(stream));                    \
  }
REPRO_RMSNORM_MATMUL_MMA(repro_rmsnorm_matmul_mma_bf16, GEMM_NORM)
REPRO_RMSNORM_MATMUL_MMA(repro_rmsnorm_matmul_w8_mma_bf16, GEMM_NORM_W8)
