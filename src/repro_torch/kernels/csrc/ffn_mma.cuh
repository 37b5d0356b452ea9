// The tensor-core GLU / MLP body shared by the streamed FFN (streamed_ffn.cu:
// ffn_mma_kernel, K4, K6, K10b, K10c) and the MoE experts (moe_experts.cu:
// moe_mma_kernel, K12), one device function in three modes:
//   FUSED: phase 1 (h slice in shared memory) then phase 2 (h @ Wd);
//   UP:    phase 1 into an h [T, F] workspace;
//   DOWN:  phase 2 from that workspace.
// Phase 1: h[BT, BF1] tiles = act(xn @ Wg) * (xn @ Wu) (ungated: act(xn @
// Wu)), rounded to bf16 (the int8 twins: hi + lo bf16 planes); each warp
// owns 16 h columns of all BT rows.  Phase 2: out[BT, BN2] strips = h @ Wd;
// each warp owns BN2 / NW columns.  Products on mma.sync.m16n8k16 (bf16 ->
// f32), A by ldmatrix, W [D, F] / Wd [F, D] row-major by ldmatrix.trans,
// every tile through one ring of cp.async 16-byte copies (streamed_ffn.cu's
// header has the design and its measurements).
// MOE (K12): block (., ., e = blockIdx.z) runs expert e's weights over the
// rows of its kept-token list (ascending; FUSED, at most 64 tokens, makes
// it from the gate column, UP and DOWN read idx[e, :counts[e]]): x rows are
// gathered through the ring, h rows are the list's positions (H [E, T, F]),
// and each output row goes, unscaled and float32, to its token's slot of
// the partials [splits, E, T, D]; blocks whose row tile starts at or past
// the count return before any load, and 16-row MMA tiles wholly past it
// are skipped.  moe_experts.cu's combine applies the gates.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace repro {

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// The tanh form, in float32: jax.nn.gelu(approximate=True) and
// F.gelu(approximate="tanh").
__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
}


enum Mode { FUSED = 0, UP = 1, DOWN = 2 };

// A tile class: BT rows per tile, NW warps, ST ring stages; phase 1 makes
// h tiles of BF1 = 16 NW columns (16 per warp, all BT rows) over BK1-deep
// D tiles, phase 2 output strips of BN2 columns over BK2-deep F tiles (BN2
// / NW per warp).  Each stage moves whole rows of 256 B or more (bf16) of
// the weights; the fused classes' blocks cover a weight row's F columns
// side by side.  The depths change no sum: each output takes its 16-deep
// MMA steps in order over all of D (phase 1) or its F range (phase 2).
template <int BT_, int NW_, int BN2_, int BK2_, int ST_, int BK1_ = 64>
struct TileCfg {
  static constexpr int BT = BT_, NW = NW_, BN2 = BN2_, BK2 = BK2_, ST = ST_;
  static constexpr int BK1 = BK1_, LDK = BK1 + 8;   // x tile depth, stride
  static constexpr int NT = NW * 32, MT = BT / 16, BF1 = 16 * NW;
  static constexpr int N2 = BN2 / NW / 8;   // a warp's n8 tiles in phase 2
};
using DecodeRows = TileCfg<16, 8, 512, 32, 5>;   // FUSED, T <= 16
using VerifyRows = TileCfg<64, 8, 256, 64, 4>;   // FUSED, T <= 64
using PassRows = TileCfg<64, 4, 128, 64, 4>;     // UP and DOWN

struct FfnArgs {
  const bf16* x;         // [T, D] (UP with the norm: the normalised rows)
  const bf16* nscale;    // [D], the folded norm's scale (FUSED only)
  const void* wg;        // [D, F] bf16 or int8 codes (GLU only); MoE [E, D, F]
  const void* wu;        // [D, F]; MoE [E, D, F]
  const void* wd;        // [F, D]; MoE [E, F, D]
  const float* gs;       // int8 scales: gate, up [F], down [D]
  const float* us;
  const float* ds;
  bf16* out;             // [T, D]
  float* part;           // split partials [splits, T, D]; MoE [splits, E, T, D]
  int* counters;         // one arrival counter per output tile, all 0
  bf16* h;               // two-pass h planes [planes, T, fp]; MoE [E, T, fp]
  const bf16* gates;     // MoE: [T, E] (FUSED lists each expert's tokens)
  const int* idx;        // MoE UP/DOWN: each expert's kept tokens [E, T]
  const int* counts;     // MoE UP/DOWN: their counts [E]
  int t, d, f, fp;       // fp: h's row stride, F rounded up to 64
  int f_per_split;       // FUSED: a block's F columns; DOWN: a split's rows
  int aligned;
  int n_e;               // MoE: experts
  float eps;
};

template <typename E> __device__ __forceinline__ E zero_of();
template <> __device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ int8_t zero_of<int8_t>() { return 0; }

// Rows [r0, r0 + R) x columns [c0, c0 + CC) of a row-major matrix of E
// with row stride `ld` into a shared tile of row stride LDS, by NT
// threads; elements at or past (r_end, c_end) are zero.  GATHER: tile row
// r is matrix row rows[r] (shared), for r0 + r < r_end.  Aligned: 16-byte
// cp.async copies (c_end a multiple of 16 elements); else element by
// element.
template <typename E, int R, int CC, int LDS, int NT, bool GATHER = false>
__device__ __forceinline__ void load_tile(E* s, const E* __restrict__ g,
                                          size_t ld, int r0, int r_end,
                                          int c0, int c_end, bool aligned,
                                          const int* rows = nullptr) {
  constexpr int EPC = 16 / (int)sizeof(E);
  constexpr int CPR = CC / EPC;
  auto row = [&](int r) -> size_t {
    if constexpr (GATHER) return (size_t)rows[r];
    return (size_t)(r0 + r);
  };
  if (aligned) {
    for (int i = threadIdx.x; i < R * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      cp_async16(s + r * LDS + c, ok ? g + row(r) * ld + c0 + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * CC; i += NT) {
      const int r = i / CC, c = i % CC;
      s[r * LDS + c] = (r0 + r < r_end && c0 + c < c_end)
                           ? g[row(r) * ld + c0 + c]
                           : zero_of<E>();
    }
  }
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
  static constexpr size_t XA = MODE != DOWN ? (size_t)C::BT * C::LDK * 2 : 0;
  static constexpr size_t WT1 = (size_t)C::BK1 * WLDF * ESZ;
  static constexpr size_t P1 = MODE != DOWN ? XA + (GLU ? 2 : 1) * WT1 : 0;
  static constexpr size_t AD =
      MODE == DOWN ? (size_t)PL * C::BT * LDA * 2 : 0;
  static constexpr size_t P2 =
      MODE != UP ? AD + (size_t)C::BK2 * WLDN * ESZ : 0;
  static constexpr size_t STAGE = ((P1 > P2 ? P1 : P2) + 127) / 128 * 128;
  static constexpr size_t CONV1 =
      MODE != DOWN ? (size_t)(GLU ? 2 : 1) * C::BK1 * LDF * 2 : 0;
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

// The body of ffn_mma_kernel (MOE false) and moe_mma_kernel (MOE true), run
// by C::NT threads.  W8: int8 codes; NORM (FUSED only): the folded RMSNorm;
// SILU: else GELU.
template <class C, bool W8, int MODE, bool GLU, bool NORM, bool SILU,
          bool MOE>
__device__ __forceinline__ void ffn_mma_body(const FfnArgs a) {
  using W = typename std::conditional<W8, int8_t, bf16>::type;
  using L = Layout<C, W8, MODE, GLU>;
  constexpr int BT = C::BT, ST = C::ST, MT = C::MT, PL = L::PL;
  constexpr int NT = C::NT, BF1 = C::BF1, BN2 = C::BN2, BK2 = C::BK2;
  constexpr int N2 = C::N2, kBK = C::BK1, kLDK = C::LDK;
  static_assert(!NORM || MODE == FUSED, "UP takes normalised rows");
  static_assert(GLU || !SILU, "the MLP runs GELU");
  static_assert(N2 % 2 == 0, "phase-2 B fragments come in pairs");
  static_assert(!MOE || (!W8 && !NORM && GLU), "MoE: bf16 GLU, no norm");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* conv = reinterpret_cast<bf16*>(smem + L::RING);
  bf16* h_s = reinterpret_cast<bf16*>(smem + L::RING + L::CONV);
  __shared__ float rstd_s[NORM ? BT : 1];
  __shared__ int is_last;
  __shared__ int rows_s[MOE ? BT : 1];   // MoE: the tile's tokens

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t = a.t, d = a.d, f = a.f;
  const bool aligned = a.aligned != 0;
  const W* wg = static_cast<const W*>(a.wg);
  const W* wu = static_cast<const W*>(a.wu);
  const W* wd = static_cast<const W*>(a.wd);
  bf16* hb = a.h;   // MoE: expert ex's rows of H

  // This block's work, in row tile blockIdx.y.  FUSED: F columns
  // [f_begin, f_end), every strip (the plan runs it on one row tile); UP:
  // one BF1-column tile of h; DOWN: one strip over F rows [f_begin, f_end).
  // MoE: rows of expert ex = blockIdx.z's list, `n_rows` of them.
  const int row0 = blockIdx.y * BT;
  int n_rows = t, ex = 0, mt_live = MT;
  if constexpr (MOE) {
    ex = blockIdx.z;
    if constexpr (MODE == FUSED) {
      // T <= 64: the block lists its expert's kept tokens (g != 0),
      // ascending, from the gate column, a warp ballot per 32 tokens, and
      // keeps list rows [row0, row0 + BT).
      static_assert(C::NW >= 2, "two warps list the tokens");
      __shared__ int kept_s[2];
      unsigned m = 0;
      if (warp < 2) {
        const int tok = warp * 32 + lane;
        m = __ballot_sync(0xffffffffu,
                          tok < t && __bfloat162float(
                                         a.gates[(size_t)tok * a.n_e + ex]) !=
                                         0.f);
        if (lane == 0) kept_s[warp] = __popc(m);
      }
      __syncthreads();
      n_rows = kept_s[0] + kept_s[1];
      if (row0 >= n_rows) return;
      if (warp < 2 && (m >> lane & 1u)) {
        const int off = __popc(m & ((1u << lane) - 1u)) +
                        (warp ? kept_s[0] : 0) - row0;
        if (off >= 0 && off < BT) rows_s[off] = warp * 32 + lane;
      }
    } else {
      n_rows = a.counts[ex];
      if (row0 >= n_rows) return;
      for (int i = tid; i < BT; i += NT)
        rows_s[i] = row0 + i < n_rows ? a.idx[(size_t)ex * t + row0 + i] : 0;
    }
    mt_live = min(MT, (n_rows - row0 + 15) / 16);
    wg += (size_t)ex * d * f;
    wu += (size_t)ex * d * f;
    wd += (size_t)ex * f * d;
    hb += (size_t)ex * t * a.fp;
    __syncthreads();
  }
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
  } else if constexpr (MOE) {
    split = 0;
    splits = 1;
    f_begin = 0;
    f_end = f;
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
        load_tile<bf16, BT, kBK, kLDK, NT, MOE>(
            reinterpret_cast<bf16*>(base), a.x, d, row0, n_rows, k0, d,
            aligned, rows_s);
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
              hb + (size_t)pl * t * a.fp, a.fp, row0, n_rows, kr0, f_end,
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
          if (!MOE || i < mt_live)
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
            if (MOE && i >= mt_live) continue;
            mma_bf16(acc1[0][i][0], af[i], b[0], b[1]);
            mma_bf16(acc1[0][i][1], af[i], b[2], b[3]);
          }
        }
        ldsm_x4_trans(b, ut + boff);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (MOE && i >= mt_live) continue;
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
              } else if (row0 + r < n_rows) {
                const size_t off = (size_t)(row0 + r) * a.fp + fc0 + c;
                *reinterpret_cast<__nv_bfloat162*>(hb + off) = hi;
                if constexpr (W8)
                  *reinterpret_cast<__nv_bfloat162*>(
                      hb + (size_t)t * a.fp + off) = lo;
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
            if (!MOE || i < mt_live)
              ldsm_x4(af[pl][i],
                      ab + pl * plane +
                          (i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              lda +
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
              if (MOE && i >= mt_live) continue;
              mma_bf16(acc2[i][2 * np], af[pl][i], b[0], b[1]);
              mma_bf16(acc2[i][2 * np + 1], af[pl][i], b[2], b[3]);
            }
        }
      }
      if (kk == n_k2 - 1) {
        if constexpr (MOE) {
          // Each list row's output, float32 and unscaled, to its token's
          // slot of this split's partials; the combine applies the gates.
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = i * 16 + g + hr * 8;
              if (row0 + r >= n_rows) continue;
              float* p = a.part +
                         (((size_t)split * a.n_e + ex) * t + rows_s[r]) * d;
#pragma unroll
              for (int j = 0; j < N2; ++j) {
                const int c =
                    strip * BN2 + warp * (BN2 / C::NW) + j * 8 + 2 * t4;
                const float v0 = acc2[i][j][2 * hr], v1 = acc2[i][j][2 * hr + 1];
                if (aligned) {
                  if (c < d)
                    *reinterpret_cast<float2*>(p + c) = make_float2(v0, v1);
                } else {
                  if (c < d) p[c] = v0;
                  if (c + 1 < d) p[c + 1] = v1;
                }
              }
            }
          continue;
        }
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

// Launch `kern` (a kernel whose body is ffn_mma_body) with
// its dynamic shared memory: `*smem_set` is the limit already raised for
// this instance (a static of the caller, 0 at first), raised as FUSED's h
// slice grows (at most 210 KB).
template <class C, bool W8, int MODE, bool GLU, class Kernel>
int launch_ffn_mma(Kernel kern, size_t* smem_set, const FfnArgs& a,
                   dim3 grid, cudaStream_t stream) {
  const size_t smem = Layout<C, W8, MODE, GLU>::bytes(a.f_per_split);
  const cudaError_t err = raise_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, C::NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro
