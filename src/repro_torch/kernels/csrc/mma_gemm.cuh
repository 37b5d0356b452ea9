// The tensor-core GEMM shared by K5 (block_matmul.cu), K3 and its int8
// twin K10a (rmsnorm_matmul.cu) and the logits tiles of K11
// (streamed_xent.cu), in bf16:
//   out[M, N] = A[M, K] @ W[K, N], products on mma.sync.m16n8k16 (bf16 ->
//   float32), x fragments by ldmatrix, W [K, N] row-major by
//   ldmatrix.trans, out in bf16.
// Design (K5's kernel, with two hooks for K3 and K10a):
//   - x and W tiles come through a ring of cp.async 16-byte copies (row
//     stride + 8 elements: ldmatrix without bank conflicts), two or three
//     K tiles in flight while one is multiplied;
//   - three tile classes, BN = 128, 64-deep K tiles: M <= 16 (Decode,
//     16-row tiles, 4 stages), M <= 64 (Verify, 64-row tiles, 4 stages),
//     larger M (Large, 128 x 128 tiles, 8 warps of 64 x 32, 3 stages).
//     Each output element sums its own row of A against its own column of
//     W, 16 products per MMA, over the same 64-deep K tiles in order in
//     every class: so up to 64 rows a row's bits do not depend on the row
//     count when the split does not (common.py::mma_plan sizes it from
//     (K, N, SMs) alone there);
//   - few output tiles (decode, N = 1024) would leave most SMs idle, so K
//     is split across blocks (gridDim.z) into float32 partials; the last
//     block to arrive on an output tile (an int32 arrival counter per
//     tile, reset to 0 by that block) sums them in split order in the same
//     launch.  The atomics count arrivals, never values: results repeat
//     run to run;
//   - rows that are not whole 16-byte vectors (or unaligned pointers) load
//     element by element through the same ring (`aligned` = 0).
// The hooks (GemmOp):
//   - NORM (K3): A is x, and each landed x tile is normalised in place,
//     x * rstd * (1 + scale) rounded to bf16 (the reference's
//     `normed.astype(x.dtype)`), before ldmatrix; the scale's K tile comes
//     through the ring with the x tile.  rstd comes from the block's own
//     pass over its rows (Decode and Verify: one launch; `block_rstd`) or,
//     for the Large class, from a row pass launched before it;
//   - NORM_W8 (K10a): as NORM, but the normalised x stays float32 as the
//     reference's `_kernel_w8` keeps it: it is carried as two bf16 planes
//     hi = bf16(xn) and lo = bf16(xn - hi), two MMAs into one accumulator
//     (about 16 bits of xn); W arrives as int8 codes (half the bytes),
//     converted to bf16 in shared memory (exact), and each column's float32
//     scale multiplies its sum after the whole K reduction.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace repro {

constexpr int kMmaBN = 128;

// A tile class: BM x 128 output tiles, BK-deep K tiles, WM x WN warps,
// ST ring stages; two blocks per SM.
template <int BM_, int BK_, int WM_, int WN_, int ST_>
struct MmaCfg {
  static constexpr int BM = BM_, BK = BK_, WM = WM_, WN = WN_, ST = ST_;
  static constexpr int NT = WM * WN * 32, NW = WM * WN;
  static constexpr int WTM = BM / WM, WTN = kMmaBN / WN;   // warp tile
  static constexpr int MT = WTM / 16, NT8 = WTN / 8;
  static constexpr int LDA = BK + 8, LDB = kMmaBN + 8;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
};
using Decode = MmaCfg<16, 64, 1, 4, 4>;    // M <= 16
using Verify = MmaCfg<64, 64, 2, 2, 4>;    // M <= 64
using Large = MmaCfg<128, 64, 2, 4, 3>;    // M > 64

enum GemmOp { GEMM_PLAIN = 0, GEMM_NORM = 1, GEMM_NORM_W8 = 2 };

// Shared memory of one instance: the ring's A stages, its B stages (bf16
// tiles, or int8 codes with a row stride of 128) and, under the norm, its
// stages of the norm's scale (the K tile's BK values); then for the int8
// twin the bf16 conversion of the current B tile and the lo plane of the
// current A tile.
template <class C, int OP>
struct GemmLayout {
  static constexpr bool W8 = OP == GEMM_NORM_W8, NORM = OP != GEMM_PLAIN;
  static constexpr size_t A_BYTES = (size_t)C::A_ELEMS * 2;
  static constexpr size_t B_BYTES =
      W8 ? (size_t)C::BK * kMmaBN : (size_t)C::B_ELEMS * 2;
  static constexpr size_t S_BYTES = NORM ? (size_t)C::BK * 2 : 0;
  static constexpr size_t RING =
      (size_t)C::ST * (A_BYTES + B_BYTES + S_BYTES);
  static constexpr size_t CONV = W8 ? (size_t)C::B_ELEMS * 2 : 0;
  static constexpr size_t LO = W8 ? A_BYTES : 0;
  static constexpr size_t BYTES = RING + CONV + LO;
};

struct GemmArgs {
  const bf16* x;          // [M, K]
  const void* w;          // [K, N] bf16, or int8 codes (NORM_W8)
  const bf16* scale;      // [K] the folded norm's scale (NORM, NORM_W8)
  const float* wscale;    // [N] the codes' column scales (NORM_W8)
  const float* rstd;      // [M] rows' 1 / RMS from a row pass (Large)
  bf16* out;              // [M, N]
  float* part;            // split partials [splits, M, N]
  int* counters;          // one arrival counter per output tile, all 0
  int m, k, n, k_per_split, aligned;
  float eps;
};

// One K tile (k0 .. k0 + BK) of A rows [row0, row0 + BM) and W columns
// [col0, col0 + 128) into ring stage (as, bs), and with a `scale` its K
// tile's values into `ss`; out of range loads as zeros.
template <class C, bool W8>
__device__ __forceinline__ void load_tile(bf16* as, void* bs, bf16* ss,
                                          const bf16* __restrict__ x,
                                          const void* __restrict__ wv,
                                          const bf16* __restrict__ scale,
                                          int m, int k, int n, int row0,
                                          int col0, int k0, int k_end,
                                          bool aligned) {
  using W = typename std::conditional<W8, int8_t, bf16>::type;
  constexpr int LDW = W8 ? kMmaBN : C::LDB;      // B stage row stride
  constexpr int EPC = 16 / (int)sizeof(W);       // elements per copy
  const W* w = static_cast<const W*>(wv);
  W* b = static_cast<W*>(bs);
  const int tid = threadIdx.x;
  if (aligned) {
    constexpr int ACH = C::BK / 8, BCH = kMmaBN / EPC;
    for (int i = tid; i < C::BM * ACH; i += C::NT) {
      const int r = i / ACH, c = (i % ACH) * 8;
      const bool ok = row0 + r < m && k0 + c < k_end;
      cp_async16(as + r * C::LDA + c,
                 ok ? x + (size_t)(row0 + r) * k + k0 + c : x, ok);
    }
    for (int i = tid; i < C::BK * BCH; i += C::NT) {
      const int r = i / BCH, c = (i % BCH) * EPC;
      const bool ok = k0 + r < k_end && col0 + c < n;
      cp_async16(b + r * LDW + c,
                 ok ? w + (size_t)(k0 + r) * n + col0 + c : w, ok);
    }
    if (scale != nullptr && tid < C::BK / 8) {
      const bool ok = k0 + tid * 8 < k_end;
      cp_async16(ss + tid * 8, ok ? scale + k0 + tid * 8 : scale, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < C::BM * C::BK; i += C::NT) {
      const int r = i / C::BK, c = i % C::BK;
      as[r * C::LDA + c] = (row0 + r < m && k0 + c < k_end)
                               ? x[(size_t)(row0 + r) * k + k0 + c]
                               : zero;
    }
    for (int i = tid; i < C::BK * kMmaBN; i += C::NT) {
      const int r = i / kMmaBN, c = i % kMmaBN;
      const bool ok = k0 + r < k_end && col0 + c < n;
      if constexpr (W8)
        b[r * LDW + c] = ok ? w[(size_t)(k0 + r) * n + col0 + c] : 0;
      else
        b[r * LDW + c] = ok ? w[(size_t)(k0 + r) * n + col0 + c] : zero;
    }
    if (scale != nullptr && tid < C::BK)
      ss[tid] = k0 + tid < k_end ? scale[k0 + tid] : zero;
  }
}

// acc += A tile @ B tile for this warp's WTM x WTN outputs: `as` [BM][LDA]
// (and, PL = 2, the lo plane `lo` of the same layout, its MMA right after
// the hi plane's), `bs` [BK][LDB] bf16.  SKIP: 16-row tiles at or past
// `rows` (the tile's rows that exist) are skipped, as each output row
// depends on its own row of A alone (a runtime branch: only where the
// registers allow it).
template <class C, int PL, bool SKIP = false>
__device__ __forceinline__ void mma_tile(float (&acc)[C::MT][C::NT8][4],
                                         const bf16* as, const bf16* lo,
                                         const bf16* bs, int lane, int wm,
                                         int wn, int rows = C::BM) {
#pragma unroll
  for (int ks = 0; ks < C::BK / 16; ++ks) {
    uint32_t af[PL][C::MT][4];
#pragma unroll
    for (int pl = 0; pl < PL; ++pl)
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
        if (!SKIP || wm * C::WTM + i * 16 < rows)
          ldsm_x4(af[pl][i], (pl ? lo : as) +
                                 (wm * C::WTM + i * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * C::LDA +
                                 ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < C::NT8 / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, bs + (ks * 16 + (lane & 7) +
                             ((lane >> 3) & 1) * 8) * C::LDB +
                           wn * C::WTN + np * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        if (SKIP && wm * C::WTM + i * 16 >= rows) continue;
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          mma_bf16(acc[i][2 * np], af[pl][i], b[0], b[1]);
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          mma_bf16(acc[i][2 * np + 1], af[pl][i], b[2], b[3]);
      }
    }
  }
}

// 1 / sqrt(mean(x^2) + eps) of rows [row0, row0 + BM) into `rstd_s`, 0
// for rows at or past m, by the whole block: thread i sums the squares of
// its columns (8 at a time from 8 i, NT * 8 apart) in column order, then
// the warp's butterfly, then the warps' sums in warp order (`red_s`
// [NW][BM]).  One fixed order per row for every class of NT threads,
// whatever the row count; each row's loads are all in flight at once.
template <class C>
__device__ __forceinline__ void block_rstd(const bf16* __restrict__ x, int m,
                                           int d, float eps, bool aligned,
                                           int row0, float* rstd_s,
                                           float (*red_s)[C::BM]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(C::BM, m - row0);
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const bf16* xr = x + (size_t)(row0 + r) * d;
    float ss = 0.f;
    if (aligned) {
      for (int c = tid * 8; c < d; c += C::NT * 8) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + c));
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float f = __bfloat162float(e[i]);
          ss += f * f;
        }
      }
    } else {
      for (int c = tid; c < d; c += C::NT) {
        const float f = __bfloat162float(xr[c]);
        ss += f * f;
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) red_s[warp][r] = ss;
  }
  __syncthreads();
  for (int r = tid; r < C::BM; r += C::NT) {
    float ss = 0.f;
#pragma unroll
    for (int w = 0; w < C::NW; ++w) ss += red_s[w][r];
    rstd_s[r] = r < rows ? rsqrtf(ss / (float)d + eps) : 0.f;
  }
}

// The landed x tile's first `rows` rows normalised in place (rows' rstd
// in `rstd_s`, the K tile's scale values in `ss`), rounded to bf16; W8: the
// remainder's bf16 into `lo`.  The rows past them stay zero.
template <class C, bool W8>
__device__ __forceinline__ void norm_tile(bf16* as, bf16* lo,
                                          const float* rstd_s,
                                          const bf16* ss, int rows) {
  for (int i = threadIdx.x; i < rows * C::BK / 2; i += C::NT) {
    const int r = i / (C::BK / 2), c = (i % (C::BK / 2)) * 2;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(as + r * C::LDA + c);
    const float2 v = __bfloat1622float2(*p);
    const float2 sc = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(ss + c));
    const float rs = rstd_s[r];
    const float y0 = norm_elem(v.x, rs, sc.x), y1 = norm_elem(v.y, rs, sc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y0, y1);
    *p = hi;
    if constexpr (W8) {
      const float2 h = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(lo + r * C::LDA + c) =
          __floats2bfloat162_rn(y0 - h.x, y1 - h.y);
    }
  }
}

// The last block on an output tile: out = sum of the `splits` float32
// partials [splits, m, n] in split order (times the column's scale when
// `colscale` is given), rows [row0, row0 + BM).
template <class C>
__device__ __forceinline__ void reduce_splits(const float* __restrict__ part,
                                              bf16* __restrict__ out, int m,
                                              int n, int row0, int col0,
                                              int splits, bool aligned,
                                              const float* colscale) {
  const int tid = threadIdx.x, rows = min(C::BM, m - row0);
  const size_t stride = (size_t)m * n;
  if (aligned) {
    // 4 columns per thread (n is a multiple of 8), U of them per pass:
    // U x `splits` independent 16-byte loads in flight, each element's
    // partials summed in split order.
    constexpr int U = 4, STEP = C::NT * 4;
    for (int base = tid * 4; base < rows * kMmaBN; base += U * STEP) {
      float4 s[U];
      const float* p[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * STEP;
        const int r = row0 + i / kMmaBN, c = col0 + i % kMmaBN;
        ok[u] = i < rows * kMmaBN && c < n;
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
          if (colscale != nullptr) {
            const int c = (int)((p[u] - part) % n);
            s[u].x *= colscale[c];
            s[u].y *= colscale[c + 1];
            s[u].z *= colscale[c + 2];
            s[u].w *= colscale[c + 3];
          }
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              out + (p[u] - part));
          o[0] = __floats2bfloat162_rn(s[u].x, s[u].y);
          o[1] = __floats2bfloat162_rn(s[u].z, s[u].w);
        }
    }
  } else {
    for (int i = tid; i < rows * kMmaBN; i += C::NT) {
      const int r = row0 + i / kMmaBN, c = col0 + i % kMmaBN;
      if (c >= n) continue;
      const size_t off = (size_t)r * n + c;
      float s = 0.f;
      for (int z = 0; z < splits; ++z) s += __ldcg(part + z * stride + off);
      if (colscale != nullptr) s *= colscale[c];
      out[off] = __float2bfloat16(s);
    }
  }
}

// The body of one GEMM block: output tile (blockIdx.y, blockIdx.x), K
// split blockIdx.z.  `smem`: the instance's dynamic shared memory
// (GemmLayout<C, OP>::BYTES).
template <class C, int OP>
__device__ __forceinline__ void gemm_block(const GemmArgs& a,
                                           unsigned char* smem) {
  constexpr bool NORM = OP != GEMM_PLAIN, W8 = OP == GEMM_NORM_W8;
  // The 16- and 64-row classes take their rows' rstd themselves, the
  // Large class from a row pass.
  constexpr bool OWN_RSTD = NORM && C::BM <= 64;
  constexpr int ST = C::ST, MT = C::MT, NT8 = C::NT8, PL = W8 ? 2 : 1;
  using L = GemmLayout<C, OP>;
  bf16* a_s = reinterpret_cast<bf16*>(smem);                    // [ST][A]
  unsigned char* b_s = smem + ST * L::A_BYTES;                  // [ST][B]
  bf16* s_s = reinterpret_cast<bf16*>(b_s + ST * L::B_BYTES);   // [ST][BK]
  bf16* conv = reinterpret_cast<bf16*>(smem + L::RING);         // W8
  bf16* lo = reinterpret_cast<bf16*>(smem + L::RING + L::CONV); // W8
  __shared__ float rstd_s[NORM ? C::BM : 1];
  __shared__ float red_s[OWN_RSTD ? C::NW : 1][OWN_RSTD ? C::BM : 1];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int m = a.m, k = a.k, n = a.n;
  const bool aligned = a.aligned != 0;
  const int row0 = blockIdx.y * C::BM, col0 = blockIdx.x * kMmaBN;
  const int k_begin = blockIdx.z * a.k_per_split;
  const int k_end = min(k, k_begin + a.k_per_split);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK
                                   : 0;
  // The norm's 16- and 64-row classes skip the rows past m in place and
  // in their MMAs (K5 keeps its one sequence; the Large class, at its
  // register cap, every row).
  const int rows = OWN_RSTD ? min(C::BM, m - row0) : C::BM;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_kt)
      load_tile<C, W8>(a_s + s * C::A_ELEMS, b_s + s * L::B_BYTES,
                       s_s + s * C::BK, a.x, a.w, NORM ? a.scale : nullptr,
                       m, k, n, row0, col0, k_begin + s * C::BK, k_end,
                       aligned);
    cp_async_commit();
  }
  // The rows' rstd while the prologue's tiles fly (visible after the
  // first step's barrier).
  if constexpr (NORM && !OWN_RSTD) {
    for (int r = tid; r < C::BM; r += C::NT)
      rstd_s[r] = row0 + r < m ? a.rstd[row0 + r] : 0.f;
  } else if constexpr (OWN_RSTD) {
    static_assert(C::NT == 128, "one row order for every in-block class");
    block_rstd<C>(a.x, m, k, a.eps, aligned, row0, rstd_s, red_s);
  }
  if constexpr (W8 && OWN_RSTD) {
    // The lo plane's rows past m, never written, read as zeros.
    for (int i = tid; i < C::A_ELEMS; i += C::NT)
      lo[i] = __float2bfloat16(0.f);
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
      load_tile<C, W8>(a_s + (nk % ST) * C::A_ELEMS,
                       b_s + (nk % ST) * L::B_BYTES, s_s + (nk % ST) * C::BK,
                       a.x, a.w, NORM ? a.scale : nullptr, m, k, n, row0,
                       col0, k_begin + nk * C::BK, k_end, aligned);
    cp_async_commit();
    bf16* as = a_s + (kt % ST) * C::A_ELEMS;
    const bf16* bs =
        reinterpret_cast<const bf16*>(b_s + (kt % ST) * L::B_BYTES);
    if constexpr (NORM) {
      norm_tile<C, W8>(as, lo, rstd_s, s_s + (kt % ST) * C::BK, rows);
      if constexpr (W8) {
        codes_to_bf16<C::BK, kMmaBN, C::LDB, C::NT>(
            conv, reinterpret_cast<const int8_t*>(bs));
        bs = conv;
      }
      __syncthreads();
    }
    mma_tile<C, PL, OWN_RSTD>(acc, as, lo, bs, lane, wm, wn, rows);
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
        float v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
        if (split) {
          float* p = a.part + ((size_t)blockIdx.z * m + r) * n + c;
          if (aligned) {
            if (c < n) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (c < n) p[0] = v0;
            if (c + 1 < n) p[1] = v1;
          }
        } else {
          if constexpr (W8) {
            if (c < n) v0 *= a.wscale[c];
            if (c + 1 < n) v1 *= a.wscale[c + 1];
          }
          bf16* o = a.out + (size_t)r * n + c;
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
    int* ctr = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    is_last = atomicAdd(ctr, 1) == (int)gridDim.z - 1;
    if (is_last) *ctr = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  reduce_splits<C>(a.part, a.out, m, n, row0, col0, gridDim.z, aligned,
                   W8 ? a.wscale : nullptr);
}

// Launch `kern` (a kernel that runs gemm_block<C, OP>) over the
// output tiles and `splits` K ranges; the dynamic shared-memory limit is
// raised once per instance.
template <class C, int OP>
int launch_gemm(void (*kern)(GemmArgs), const GemmArgs& a, int splits,
                cudaStream_t stream) {
  constexpr size_t SMEM = GemmLayout<C, OP>::BYTES;
  static size_t smem_set = 0;
  const cudaError_t err = raise_smem(kern, SMEM, &smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(a.n, kMmaBN), cdiv(a.m, C::BM), splits);
  kern<<<grid, C::NT, SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro
