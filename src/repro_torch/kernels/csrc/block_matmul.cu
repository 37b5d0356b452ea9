// block_matmul: out[M, N] = x[M, K] @ W[K, N], products summed in float32,
// out in x's dtype.  The qkv stage of the LayerNorm configs (gpt2), the
// o-projection, gpt2's and rwkv6's LM heads and granite's router product.
//
// Replaces the TPU kernel src/repro/kernels/block_matmul.py::_matmul_kernel
// (pallas_call at :57).  The TPU kernel walks K as the sequential grid
// dimension and carries a [bm, bn] float32 accumulator in VMEM across it;
// here each block walks its K range in a loop.
//
// bfloat16 runs block_mma_kernel, on the tensor cores: mma_gemm.cuh's
// GEMM with no hook (its design: the cp.async ring, mma.sync, the three
// tile classes, the in-launch split sum).  What bounds it on the H100: at
// decode (M <= 20 rows) and at the LM heads the weight bytes, 3.35 TB/s; at
// a prefill chunk, a whole prompt and a training step (M = 128 .. 8192)
// the products, 989 TFLOP/s of bf16.  Row invariance up to 64 rows (a
// speculative verify dispatch must give each row a decode step's bits):
// the Decode and Verify classes run the same per-row sequence, and the
// Python plan (common.py::mma_plan) sizes their K split from (K, N) alone.
// float32 keeps tiled_matmul.cuh's CUDA-core route (NORM = false), whose
// split sums run as a second launch (split_reduce).
#include "mma_gemm.cuh"
#include "tiled_matmul.cuh"

using namespace repro;

namespace {

template <class C>
__global__ void __launch_bounds__(C::NT, 2)
block_mma_kernel(const GemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_block<C, GEMM_PLAIN>(a, smem_raw);
}

}  // namespace

extern "C" int repro_block_matmul_f32(const void* x, const void* w,
                                      void* out, void* part, int m, int k,
                                      int n, int small, int k_per_split,
                                      int splits, void* stream) {
  return tiled_matmul<float, float, false>(
      x, nullptr, w, nullptr, out, part, m, k, n, small, k_per_split, splits,
      0.f, static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores.  `part` [splits, M, N] float32 and `counters`
// (one int32 per output tile, all 0) are needed only when splits > 1;
// `aligned`: K and N multiples of 8 and x, W 16-byte aligned.  The tile
// class follows from M, as common.py::mma_plan assumes.
extern "C" int repro_block_matmul_mma_bf16(const void* x, const void* w,
                                           void* out, void* part,
                                           void* counters, int m, int k,
                                           int n, int k_per_split,
                                           int splits, int aligned,
                                           void* stream) {
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  GemmArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w = w;
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.m = m;
  a.k = k;
  a.n = n;
  a.k_per_split = k_per_split;
  a.aligned = aligned;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16)
    return launch_gemm<Decode, GEMM_PLAIN>(block_mma_kernel<Decode>, a,
                                           splits, st);
  if (m <= 64)
    return launch_gemm<Verify, GEMM_PLAIN>(block_mma_kernel<Verify>, a,
                                           splits, st);
  return launch_gemm<Large, GEMM_PLAIN>(block_mma_kernel<Large>, a, splits,
                                        st);
}
