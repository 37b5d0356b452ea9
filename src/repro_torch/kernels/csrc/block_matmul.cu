// block_matmul: out[M, N] = x[M, K] @ W[K, N], products summed in float32,
// out in x's dtype.  The qkv stage of the LayerNorm configs (gpt2), the
// o-projection, gpt2's and rwkv6's LM heads and granite's router product.
//
// Replaces the TPU kernel src/repro/kernels/block_matmul.py::_matmul_kernel
// (pallas_call at :57).  The TPU kernel walks K as the sequential grid
// dimension and carries a [bm, bn] float32 accumulator in VMEM across it;
// here each block walks its K range in a loop.
//
// bfloat16 runs block_mma_kernel, on the tensor cores.  What bounds it on
// the H100: at decode (M <= 20 rows) and at the LM heads the weight bytes,
// 3.35 TB/s; at a prefill chunk, a whole prompt and a training step (M =
// 128 .. 8192) the products, 989 TFLOP/s of bf16.  Design:
//   - x and W tiles stay bf16 in shared memory (row stride + 8 elements:
//     ldmatrix without bank conflicts), brought by a ring of cp.async
//     16-byte copies, so two or three K tiles are in flight while one is
//     multiplied (48 KB per block at M <= 64, two blocks per SM: weight
//     streaming needs >= 24 KB in flight per SM);
//   - products on mma.sync.m16n8k16 (bf16 -> f32), x fragments by
//     ldmatrix, W [K, N] row-major by ldmatrix.trans;
//   - three tile classes, BN = 128, 64-deep K tiles: M <= 16 (16-row
//     tiles, 4 stages), M <= 64 (64-row tiles, 4 stages), larger M
//     (128 x 128 tiles, 8 warps of 64 x 32, 3 stages).
//     Row invariance up to 64 rows (a speculative verify dispatch must give
//     each row a decode step's bits): the first two classes run the same
//     per-row sequence, the same MMA over the same 64-deep K tiles in
//     order, and the Python plan (common.py::mma_plan) sizes their K split
//     from (K, N) alone;
//   - few output tiles (decode, N = 1024) would leave most SMs idle, so K
//     is split across blocks (gridDim.z) into float32 partials; the last
//     block to arrive on an output tile (an arrival counter per tile in a
//     persistent int32 workspace, reset to 0 by that block) sums them in
//     split order in the same launch.  The atomics count arrivals only and
//     never sum values: results repeat run to run;
//   - rows of x or W that are not 16-byte aligned (K or N not a multiple
//     of 8, or an unaligned pointer) load element by element through the
//     same ring (`aligned` = 0).
// float32 keeps tiled_matmul.cuh's CUDA-core route (NORM = false), whose
// split sums run as a second launch (split_reduce).
#include "mma.cuh"
#include "tiled_matmul.cuh"

using namespace repro;

namespace {

constexpr int kBN = 128;

// A tile class: BM x 128 output tiles, BK-deep K tiles, WM x WN warps,
// ST ring stages; two blocks per SM.
template <int BM_, int BK_, int WM_, int WN_, int ST_>
struct MmaCfg {
  static constexpr int BM = BM_, BK = BK_, WM = WM_, WN = WN_, ST = ST_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = kBN / WN;   // warp tile
  static constexpr int MT = WTM / 16, NT8 = WTN / 8;
  static constexpr int LDA = BK + 8, LDB = kBN + 8;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr size_t SMEM = (size_t)ST * (A_ELEMS + B_ELEMS) *
                                 sizeof(bf16);
};
using Decode = MmaCfg<16, 64, 1, 4, 4>;    // M <= 16
using Verify = MmaCfg<64, 64, 2, 2, 4>;    // M <= 64
using Large = MmaCfg<128, 64, 2, 4, 3>;    // M > 64

// One K tile (k0 .. k0 + BK) of x rows [row0, row0 + BM) and W columns
// [col0, col0 + 128) into one ring stage; out of range loads as zeros.
template <class C>
__device__ __forceinline__ void load_tile(bf16* as, bf16* bs,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ w, int m,
                                          int k, int n, int row0, int col0,
                                          int k0, int k_end, bool aligned) {
  const int tid = threadIdx.x;
  if (aligned) {
    constexpr int ACH = C::BK / 8, BCH = kBN / 8;
    for (int i = tid; i < C::BM * ACH; i += C::NT) {
      const int r = i / ACH, c = (i % ACH) * 8;
      const bool ok = row0 + r < m && k0 + c < k_end;
      cp_async16(as + r * C::LDA + c,
                 ok ? x + (size_t)(row0 + r) * k + k0 + c : x, ok);
    }
    for (int i = tid; i < C::BK * BCH; i += C::NT) {
      const int r = i / BCH, c = (i % BCH) * 8;
      const bool ok = k0 + r < k_end && col0 + c < n;
      cp_async16(bs + r * C::LDB + c,
                 ok ? w + (size_t)(k0 + r) * n + col0 + c : w, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < C::BM * C::BK; i += C::NT) {
      const int r = i / C::BK, c = i % C::BK;
      as[r * C::LDA + c] = (row0 + r < m && k0 + c < k_end)
                               ? x[(size_t)(row0 + r) * k + k0 + c]
                               : zero;
    }
    for (int i = tid; i < C::BK * kBN; i += C::NT) {
      const int r = i / kBN, c = i % kBN;
      bs[r * C::LDB + c] = (k0 + r < k_end && col0 + c < n)
                               ? w[(size_t)(k0 + r) * n + col0 + c]
                               : zero;
    }
  }
}

// The last block on an output tile: out = sum of the `splits` float32
// partials [splits, m, n] in split order, rows [row0, row0 + rows).
template <class C>
__device__ __forceinline__ void reduce_splits(const float* __restrict__ part,
                                              bf16* __restrict__ out, int m,
                                              int n, int row0, int col0,
                                              int splits, bool aligned) {
  const int tid = threadIdx.x, rows = min(C::BM, m - row0);
  const size_t stride = (size_t)m * n;
  if (aligned) {
    // 4 columns per thread (n is a multiple of 8), U of them per pass:
    // U x `splits` independent 16-byte loads in flight, each element's
    // partials summed in split order.
    constexpr int U = 4, STEP = C::NT * 4;
    for (int base = tid * 4; base < rows * kBN; base += U * STEP) {
      float4 s[U];
      const float* p[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * STEP;
        const int r = row0 + i / kBN, c = col0 + i % kBN;
        ok[u] = i < rows * kBN && c < n;
        p[u] = part + (ok[u] ? (size_t)r * n + c : 0);
        s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 4
      for (int z = 0; z < splits; ++z)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u]) {
            const float4 v =
                __ldcg(reinterpret_cast<const float4*>(p[u] + z * stride));
            s[u].x += v.x;
            s[u].y += v.y;
            s[u].z += v.z;
            s[u].w += v.w;
          }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) {
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              out + (p[u] - part));
          o[0] = __floats2bfloat162_rn(s[u].x, s[u].y);
          o[1] = __floats2bfloat162_rn(s[u].z, s[u].w);
        }
    }
  } else {
    for (int i = tid; i < rows * kBN; i += C::NT) {
      const int r = row0 + i / kBN, c = col0 + i % kBN;
      if (c >= n) continue;
      const size_t off = (size_t)r * n + c;
      float s = 0.f;
      for (int z = 0; z < splits; ++z) s += __ldcg(part + z * stride + off);
      out[off] = __float2bfloat16(s);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::NT, 2)
block_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 bf16* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ counters, int m, int k, int n,
                 int k_per_split, int aligned) {
  constexpr int ST = C::ST, MT = C::MT, NT8 = C::NT8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);   // [ST][BM][LDA]
  bf16* b_s = a_s + ST * C::A_ELEMS;               // [ST][BK][LDB]
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.y * C::BM, col0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK
                                   : 0;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_kt)
      load_tile<C>(a_s + s * C::A_ELEMS, b_s + s * C::B_ELEMS, x, w, m, k, n,
                   row0, col0, k_begin + s * C::BK, k_end, aligned);
    cp_async_commit();
  }

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<ST - 2>();   // tile kt has landed
    __syncthreads();           // ... for all, and tile kt - 1 is done
    const int nk = kt + ST - 1;
    if (nk < n_kt)
      load_tile<C>(a_s + (nk % ST) * C::A_ELEMS, b_s + (nk % ST) * C::B_ELEMS,
                   x, w, m, k, n, row0, col0, k_begin + nk * C::BK, k_end,
                   aligned);
    cp_async_commit();
    const bf16* as = a_s + (kt % ST) * C::A_ELEMS;
    const bf16* bs = b_s + (kt % ST) * C::B_ELEMS;
#pragma unroll
    for (int ks = 0; ks < C::BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], as + (wm * C::WTM + i * 16 + (lane & 7) +
                             ((lane >> 3) & 1) * 8) * C::LDA +
                           ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, bs + (ks * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * C::LDB +
                             wn * C::WTN + np * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * np], af[i], b[0], b[1]);
          mma_bf16(acc[i][2 * np + 1], af[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  // This lane's outputs: rows r, r + 8 of each 16-row tile, columns c, c + 1
  // of each n8 tile.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + wm * C::WTM + i * 16 + g + hr * 8;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int c = col0 + wn * C::WTN + j * 8 + 2 * t4;
        const float v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
        if (split) {
          float* p = part + ((size_t)blockIdx.z * m + r) * n + c;
          if (aligned) {
            if (c < n) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (c < n) p[0] = v0;
            if (c + 1 < n) p[1] = v1;
          }
        } else {
          bf16* o = out + (size_t)r * n + c;
          if (aligned) {
            if (c < n)
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < n) o[0] = __float2bfloat16(v0);
            if (c + 1 < n) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
  if (!split) return;

  // Split K: the last block to arrive on this output tile sums the
  // partials in split order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + blockIdx.y * gridDim.x + blockIdx.x;
    is_last = atomicAdd(ctr, 1) == (int)gridDim.z - 1;
    if (is_last) *ctr = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  reduce_splits<C>(part, out, m, n, row0, col0, gridDim.z, aligned);
}

template <class C>
int launch_mma(const bf16* x, const bf16* w, bf16* out, float* part,
               int* counters, int m, int k, int n, int k_per_split,
               int splits, int aligned, cudaStream_t stream) {
  static bool smem_set = false;   // raised once per tile class
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid(cdiv(n, kBN), cdiv(m, C::BM), splits);
  block_mma_kernel<C><<<grid, C::NT, C::SMEM, stream>>>(
      x, w, out, part, counters, m, k, n, k_per_split, aligned);
  return (int)cudaGetLastError();
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
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  float* pf = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16)
    return launch_mma<Decode>(xb, wb, ob, pf, ct, m, k, n, k_per_split,
                              splits, aligned, st);
  if (m <= 64)
    return launch_mma<Verify>(xb, wb, ob, pf, ct, m, k, n, k_per_split,
                              splits, aligned, st);
  return launch_mma<Large>(xb, wb, ob, pf, ct, m, k, n, k_per_split, splits,
                           aligned, st);
}
