// rmsnorm_matmul: out[T, N] = (rms_norm(x) * (1 + scale)).to(T) @ W[D, N].
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm_matmul.py::_kernel
// (pallas_call at :81).  The TPU kernel keeps the full D row of x resident
// in VMEM; on Hopper a 64-row tile at D = 4096 is already 512 KB against
// 227 KB of shared memory per block, so each block first computes its
// rows' inverse RMS over the full row, then streams K tiles of x and W,
// normalising x on load and rounding it to the x dtype before the product
// (the reference's `normed.astype(x.dtype)`), accumulating in float32 —
// the NORM = true case of tiled_matmul.cuh, which also holds the split-K.
// The weight-only int8 twin (K10a) replaces ::_kernel_w8 (the same
// pallas_call with w_scale): W holds int8 codes, loaded one byte each, the
// normalised x stays float32, and the column scale multiplies each output
// after the whole K reduction.  The full-precision kernel also runs the
// final norm and LM head of the RMSNorm configs over the padded vocabulary
// (never int8), so that call is row-invariant too.
// What bounds it: at the decode shape (T = 4) the weight bytes (memory
// bound; int8 codes halve them against bf16); at the prefill-chunk shape
// (T = 128) the arithmetic, which this first version does on the CUDA
// cores (float FMA), not the tensor cores.
#include "tiled_matmul.cuh"

using namespace repro;

extern "C" int repro_rmsnorm_matmul_f32(const void* x, const void* scale,
                                        const void* w, void* out, void* part,
                                        int t, int d, int n, int small,
                                        int k_per_split, int splits,
                                        float eps, void* stream) {
  return tiled_matmul<float, float, true>(
      x, scale, w, nullptr, out, part, t, d, n, small, k_per_split, splits,
      eps, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_rmsnorm_matmul_bf16(const void* x, const void* scale,
                                         const void* w, void* out, void* part,
                                         int t, int d, int n, int small,
                                         int k_per_split, int splits,
                                         float eps, void* stream) {
  return tiled_matmul<__nv_bfloat16, __nv_bfloat16, true>(
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

extern "C" int repro_rmsnorm_matmul_w8_bf16(const void* x, const void* scale,
                                            const void* w,
                                            const void* w_scale, void* out,
                                            void* part, int t, int d, int n,
                                            int small, int k_per_split,
                                            int splits, float eps,
                                            void* stream) {
  return tiled_matmul<__nv_bfloat16, int8_t, true>(
      x, scale, w, w_scale, out, part, t, d, n, small, k_per_split, splits,
      eps, static_cast<cudaStream_t>(stream));
}
