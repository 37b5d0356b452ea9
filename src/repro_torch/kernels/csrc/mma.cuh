// Tensor-core building blocks shared by the bf16 kernels that run on
// Hopper's tensor cores through warp-level MMA (block_matmul.cu's
// block_mma_kernel, K5; flash_mma.cu's flash_mma_kernel, K7 and K2;
// streamed_ffn.cu's ffn_mma_kernel, K4, K6, K10b and K10c; the cp.async
// copies also feed paged_attention.cu's CUDA-core K1, K8, K9a and K9b):
//   cp.async 16-byte copies from global to shared memory (zero-filled when
//     the source is out of range), committed and waited on in groups;
//   ldmatrix (.trans) loads of four 8x8 bf16 tiles into the fragments of
//     mma.sync.m16n8k16 (bf16 inputs, float32 accumulators).
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A [16 x 16]: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B [16 x 8]:  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C [16 x 8]:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same).
// So two neighbouring C tiles (n8 tiles j and j+1 of one 16-row tile)
// rounded to bf16 are the A fragment of a 16-deep product over their 16
// columns.  Each output element is its own row of A against its own column
// of B: rows do not interact.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` to shared `dst`, or 16 zero bytes when !ok (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 tiles; lanes 8i..8i+7 give the row addresses of tile i,
// r[i] receives tile i (row lane / 4, elements 2 (lane % 4), +1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each tile transposed (r[i]: rows 2 (lane % 4), +1 of column
// lane / 4): the B fragment of a matrix stored k-major.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += A B on the tensor cores: bf16 products summed in float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bf16 (nearest even, as torch's .to()),
// `lo` in the low half: one register of an A or B fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace repro
