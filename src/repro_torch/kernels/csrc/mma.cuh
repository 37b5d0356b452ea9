// Tensor-core building blocks shared by the bf16 kernels that run on
// Hopper's tensor cores through warp-level MMA (mma_gemm.cuh's GEMM: K5,
// K3, K10a and K11; flash_mma.cu's kernels, K7, K2 and K9c;
// streamed_ffn.cu's ffn_mma_kernel, K4, K6, K10b and K10c; mamba2_scan.cu's
// segment kernels, K13; the cp.async copies also feed paged_attention.cu's
// CUDA-core K1, K8, K9a and K9b):
//   cp.async 16-byte copies from global to shared memory (zero-filled when
//     the source is out of range), committed and waited on in groups;
//   ldmatrix (.trans) loads of four 8x8 bf16 tiles into the fragments of
//     mma.sync.m16n8k16 (bf16 inputs, float32 accumulators);
//   the int8 / fp8 code-to-bf16 conversion (the int8 weight twins, K9c's
//   K/V codes), the hi + lo split of a float32 operand, the folded norm
//   and a row's inverse RMS.
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

#include <type_traits>

#include "common.cuh"

namespace repro {

using bf16 = __nv_bfloat16;

// Raise `kern`'s dynamic shared-memory limit to `bytes` where it is below:
// `*set` holds the limit already raised for this kernel instance (a static
// of the launcher, 0 at first).
template <class Kernel>
inline cudaError_t raise_smem(Kernel kern, size_t bytes, size_t* set) {
  if (bytes <= *set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *set = bytes;
  return err;
}

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

// 4 bytes from `src` to shared `dst`, or 4 zero bytes when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
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

// The float32 pair (a, b) as hi + lo bf16 planes: hi = bf16(x), lo =
// bf16(x - hi), so hi + lo holds x to about 2^-16 of its size.  Two MMAs,
// one per plane, against an exact bf16 operand give a float32 operand's
// product to that precision.
__device__ __forceinline__ void pack_bf16_split(float a, float b,
                                                uint32_t& hi,
                                                uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Four int8 codes (one word) as float32, exactly, without the
// quarter-rate I2F: byte i + 128 placed under the exponent of 2^23
// (0x4B000000 | u8 is 2^23 + u8), then 2^23 + 128 taken off.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
}

// Codes [R][CC] (row stride CC) -> bf16 [R][LDS], by NT threads; C is
// int8 (|code| <= 127) or fp8-e4m3 (every e4m3 value is a bf16 value):
// exact either way.
template <int R, int CC, int LDS, int NT, typename C = int8_t>
__device__ __forceinline__ void codes_to_bf16(bf16* dst, const C* src) {
  static_assert(sizeof(C) == 1, "one-byte codes");
  constexpr int CPR = CC / 16;
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const int4 v = *reinterpret_cast<const int4*>(src + r * CC + c);
    uint32_t o[8];
    if constexpr (std::is_same<C, int8_t>::value) {
      const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                             (uint32_t)v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        int8x4_to_f32(w[j], f);
        o[2 * j] = pack_bf16(f[0], f[1]);
        o[2 * j + 1] = pack_bf16(f[2], f[3]);
      }
    } else {
      const C* b = reinterpret_cast<const C*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = pack_bf16(to_f(b[2 * j]), to_f(b[2 * j + 1]));
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * LDS + c);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// The folded RMSNorm of one element, (x * rstd) * (1 + scale), rounded to
// bf16 by the caller, as the reference's `_rms_tile` and `_kernel`.
__device__ __forceinline__ float norm_elem(float v, float rstd, float sc) {
  return (v * rstd) * (1.f + sc);
}

// 1 / sqrt(mean(x^2) + eps) of one row, its squares summed in a fixed
// order (the row's bits do not depend on the row count).
__device__ __forceinline__ float row_rstd(const bf16* __restrict__ xr, int d,
                                          float eps, int lane,
                                          bool aligned) {
  float ss = 0.f;
  if (aligned) {
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float f = __bfloat162float(e[i]);
        ss += f * f;
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = __bfloat162float(xr[c]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  return rsqrtf(ss / (float)d + eps);
}

}  // namespace repro
