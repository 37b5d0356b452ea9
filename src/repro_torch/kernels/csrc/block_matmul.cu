// block_matmul: out[M, N] = x[M, K] @ W[K, N], products summed in float32,
// out in x's dtype.  The qkv stage of the LayerNorm configs (gpt2), whose
// norm stays outside the kernel: three launches per layer per dispatch.
//
// Replaces the TPU kernel src/repro/kernels/block_matmul.py::_matmul_kernel
// (pallas_call at :57).  The TPU kernel walks K as the sequential grid
// dimension and carries a [bm, bn] float32 accumulator in VMEM across it;
// here each block walks its K range in a loop (32-deep tiles through shared
// memory, a float32 register accumulator) — the NORM = false case of
// tiled_matmul.cuh.  gpt2's decode calls have M <= 4 rows against N = 1024
// columns, 8 output tiles, so K is split across blocks into float32
// partials summed in a fixed order by a second pass (no atomics: results
// repeat run to run).
// What bounds it: at M = 4 the weight bytes (memory bound); at M = 128
// (prefill chunk) and M = S (whole prompt) the arithmetic, done here on
// the CUDA cores (float FMA), not the tensor cores.
#include "tiled_matmul.cuh"

using namespace repro;

extern "C" int repro_block_matmul_f32(const void* x, const void* w,
                                      void* out, void* part, int m, int k,
                                      int n, int small, int k_per_split,
                                      int splits, void* stream) {
  return tiled_matmul<float, float, false>(
      x, nullptr, w, nullptr, out, part, m, k, n, small, k_per_split, splits,
      0.f, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_block_matmul_bf16(const void* x, const void* w,
                                       void* out, void* part, int m, int k,
                                       int n, int small, int k_per_split,
                                       int splits, void* stream) {
  return tiled_matmul<__nv_bfloat16, __nv_bfloat16, false>(
      x, nullptr, w, nullptr, out, part, m, k, n, small, k_per_split, splits,
      0.f, static_cast<cudaStream_t>(stream));
}
