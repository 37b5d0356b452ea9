// Paged attention over a window of W query rows per slot, read through the
// slot's page-table row: the single-token decode kernel (K1) is the window
// at W = 1, the speculative verify kernel (K8) the window at W > 1.  One
// device function serves both, so every verify row is computed exactly as
// the decode kernel computes that row at its own length.  The same function,
// templated on the pool's code type C, reads quantized pools (K9a decode,
// K9b verify): int8 or fp8-e4m3 codes with one float32 scale per (page, KV
// head).
//   q [B, W, Hq, D]; pools [P, ps, Hkv, D] (C: T, int8 or fp8-e4m3);
//   scales [P, Hkv] float32 (quantized pools only); table [B, maxp] int32
//   (always valid page ids: unallocated entries point at the NULL page 0);
//   base [B] -> out [B, W, Hq, D].
// Window row w of slot b attends to the slot's first
//   len(b, w) = base[b] + w + extra
// cached positions: decode passes lengths with extra = 0 (W = 1); verify
// passes q_off with extra = 1 (row w attends through q_off + w).
// Only what the main paths run is built here: no sliding window, D in
// {64, 128} (gpt2, llama3), W * G up to 64 rows; the wrapper refuses the
// rest on the card.
//
// Replaces the TPU kernels
// src/repro/kernels/paged_attention.py::_paged_decode_kernel (pallas_call
// in paged_decode_attention at :441), ::_paged_verify_kernel (pallas_call
// in paged_verify_attention at :364), and their quantized bodies
// ::_paged_decode_kernel_q and ::_paged_verify_kernel_q (the same calls
// with k_scale / v_scale).  There the page table, lengths and scale pools
// are scalar-prefetch operands feeding the BlockSpec index maps; here each
// block (slot b, KV head h) loads its own table row and offsets, and walks
// positions 32 at a time (crossing page boundaries) up to the window's
// deepest row, so pages past it are never read.  Per 32-position step the
// block first resolves each position's physical page (and, for codes, that
// page's scales for head h) into shared memory, then loads the K/V rows.
// The W x G query rows sharing KV head h live in the same block, RPW rows
// per warp, so each K/V row is loaded into shared memory once for all of
// them.  Numerics follow the reference: q * scale in float32 first, K/V in
// float32 (codes dequantized on load, `float(code) * page_scale`, before
// the dot, as the reference's `k.astype(f32) * ks[phys, h]`), float32 PV,
// online softmax with masked scores at -1e30 and the normaliser clamped at
// 1e-30; a row of length 0 writes zeros.
// Exactness: a row skips every step that starts at or past its own length
// (the warp-uniform exact no-op of the reference's p = 0, corr = 1), masks
// the positions of its last step past its length (p = 0), and positions
// past the window's deepest row load zeros, never stale pool contents.  The
// row's sequence of float32 operations is then the one the W = 1 launch
// performs at that length, so every verify row is bit-identical to the
// decode kernel there: what lets speculative acceptance keep exactly the
// tokens plain greedy decode produces, with or without quantized pools.
// What bounds it: the K/V bytes of the live pages (memory bound; a code
// pool moves a quarter (f32) or half (bf16) of the bytes).  With B * Hkv
// blocks (32 at 4 slots) most SMs stay idle; splitting a slot's pages
// across blocks (flash-decoding) is left to a later change.
#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int CH = 32;      // positions per step: one per lane
constexpr int NWARP = 4;
constexpr int MAX_ROWS = 64;  // W * G rows one block holds (RPW <= 16)

template <int D>
constexpr size_t smem_bytes(int rows) {
  // q_s [rows][D], k_s [CH][D + 1], v_s [CH][D], all float32.
  return sizeof(float) * ((size_t)rows * D + CH * (D + 1) + CH * D);
}

template <typename T, typename C, int D, int RPW>
__global__ void __launch_bounds__(NWARP * 32)
paged_window_kernel(const T* __restrict__ q, const C* __restrict__ kpool,
                    const C* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ base, T* __restrict__ out,
                    int hkv, int g, int w, int extra, int ps, int maxp,
                    float scale) {
  constexpr bool QUANT = !std::is_same<T, C>::value;
  constexpr int DPL = D / 32;
  constexpr int ROWS = NWARP * RPW;
  extern __shared__ float smem[];
  __shared__ int page_s[CH];               // physical page of each position
  __shared__ float ks_s[CH], vs_s[CH];     // its K/V scales (codes only)
  float* q_s = smem;                       // [ROWS][D]
  float* k_s = q_s + ROWS * D;             // [CH][D + 1]
  float* v_s = k_s + CH * (D + 1);         // [CH][D]

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;
  const int rows = w * g;
  const int extent = maxp * ps;
  const int b0 = base[b] + extra;
  const int deepest = min(max(b0 + w - 1, 0), extent);
  const int* row = table + (size_t)b * maxp;

  // Block row r = wi * G + gi: window slot wi, query head h * G + gi.
  for (int i = tid; i < rows * D; i += NWARP * 32) {
    const int r = i / D, c = i % D;
    const int wi = r / g, gi = r % g;
    q_s[r * D + c] =
        to_f(q[(((size_t)b * w + wi) * hq + h * g + gi) * D + c]) * scale;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
  int len[RPW];
#pragma unroll
  for (int hh = 0; hh < RPW; ++hh) {
    const int r = warp + NWARP * hh;
    len[hh] = r < rows ? min(max(b0 + r / g, 0), extent) : 0;
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[hh][i] = 0.f;
  }

  for (int c0 = 0; c0 < deepest; c0 += CH) {
    __syncthreads();   // q_s written / previous step consumed
    if (tid < CH) {
      const int pos = c0 + tid;
      const int page = pos < deepest ? row[pos / ps] : 0;
      page_s[tid] = page;
      if constexpr (QUANT) {
        const size_t si = (size_t)page * hkv + h;
        ks_s[tid] = pos < deepest ? kscale[si] : 0.f;
        vs_s[tid] = pos < deepest ? vscale[si] : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < CH * D; i += NWARP * 32) {
      const int r = i / D, c = i % D, pos = c0 + r;
      float kv = 0.f, vv = 0.f;
      if (pos < deepest) {
        const size_t page = (size_t)page_s[r];
        const size_t off = ((page * ps + pos % ps) * hkv + h) * D + c;
        kv = to_f(kpool[off]);
        vv = to_f(vpool[off]);
        if constexpr (QUANT) {
          kv *= ks_s[r];
          vv *= vs_s[r];
        }
      }
      k_s[r * (D + 1) + c] = kv;
      v_s[r * D + c] = vv;
    }
    __syncthreads();
    const int pos = c0 + lane;
#pragma unroll
    for (int hh = 0; hh < RPW; ++hh) {
      if (c0 >= len[hh]) continue;     // warp-uniform: nothing left to see
      const float* qr = q_s + (warp + NWARP * hh) * D;
      const bool valid = pos < len[hh];
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], k_s[lane * (D + 1) + c], s);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[hh], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[hh] - m_new);
      l[hh] = fmaf(l[hh], corr, warp_sum(p));
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[hh][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < CH; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[hh][i] = fmaf(pj, v_s[j * D + lane + 32 * i], acc[hh][i]);
      }
      m[hh] = m_new;
    }
  }

#pragma unroll
  for (int hh = 0; hh < RPW; ++hh) {
    const int r = warp + NWARP * hh;
    if (r >= rows) break;            // warp-uniform
    const int wi = r / g, gi = r % g;
    const float denom = fmaxf(l[hh], 1e-30f);
    T* o = out + (((size_t)b * w + wi) * hq + h * g + gi) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      o[lane + 32 * i] = from_f<T>(acc[hh][i] / denom);
  }
}

// The pointer operands of one launch; ks / vs are null for pools of T.
struct Operands {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const void *table, *base;
  void* out;
};

template <typename T, typename C, int D, int RPW>
int launch_rpw(const Operands& o, int b, int hkv, int g, int w, int extra,
               int ps, int maxp, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(NWARP * RPW);
  auto kernel = paged_window_kernel<T, C, D, RPW>;
  // Above 48 KB a block's shared memory must be opted into per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, hkv);
  kernel<<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const T*>(o.q), static_cast<const C*>(o.kp),
      static_cast<const C*>(o.vp), o.ks, o.vs,
      static_cast<const int*>(o.table), static_cast<const int*>(o.base),
      static_cast<T*>(o.out), hkv, g, w, extra, ps, maxp, scale);
  return (int)cudaGetLastError();
}

// Rows per warp: the fewest that hold the block's W * G rows.  The row's
// arithmetic does not depend on it.
template <typename T, typename C, int D>
int launch_d(const Operands& o, int b, int hkv, int g, int w, int extra,
             int ps, int maxp, float scale, cudaStream_t stream) {
  const int rows = w * g;
  if (rows <= NWARP)
    return launch_rpw<T, C, D, 1>(o, b, hkv, g, w, extra, ps, maxp, scale,
                                  stream);
  if (rows <= 2 * NWARP)
    return launch_rpw<T, C, D, 2>(o, b, hkv, g, w, extra, ps, maxp, scale,
                                  stream);
  if (rows <= 4 * NWARP)
    return launch_rpw<T, C, D, 4>(o, b, hkv, g, w, extra, ps, maxp, scale,
                                  stream);
  if (rows <= 8 * NWARP)
    return launch_rpw<T, C, D, 8>(o, b, hkv, g, w, extra, ps, maxp, scale,
                                  stream);
  return launch_rpw<T, C, D, 16>(o, b, hkv, g, w, extra, ps, maxp, scale,
                                 stream);
}

template <typename T, typename C>
int launch(const Operands& o, int b, int hkv, int g, int w, int extra, int d,
           int ps, int maxp, float scale, void* stream) {
  if (g < 1 || w < 1 || w * g > MAX_ROWS) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_d<T, C, 64>(o, b, hkv, g, w, extra, ps, maxp, scale, st);
  if (d == 128)
    return launch_d<T, C, 128>(o, b, hkv, g, w, extra, ps, maxp, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// base: lengths (decode, extra = 0, w = 1) or q_off (verify, extra = 1).
#define REPRO_PAGED_WINDOW(NAME, T)                                          \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,        \
                      const void* table, const void* base, void* out, int b, \
                      int hkv, int g, int w, int extra, int d, int ps,       \
                      int maxp, float scale, void* stream) {                 \
    const Operands o{q, kp, vp, nullptr, nullptr, table, base, out};        \
    return launch<T, T>(o, b, hkv, g, w, extra, d, ps, maxp, scale, stream); \
  }
REPRO_PAGED_WINDOW(repro_paged_window_f32, float)
REPRO_PAGED_WINDOW(repro_paged_window_bf16, __nv_bfloat16)

// The quantized twins: pools of codes C, scales [P, Hkv] float32.
#define REPRO_PAGED_WINDOW_Q(NAME, T, C)                                     \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,        \
                      const void* ks, const void* vs, const void* table,     \
                      const void* base, void* out, int b, int hkv, int g,    \
                      int w, int extra, int d, int ps, int maxp,             \
                      float scale, void* stream) {                           \
    const Operands o{q, kp, vp, static_cast<const float*>(ks),              \
                     static_cast<const float*>(vs), table, base, out};      \
    return launch<T, C>(o, b, hkv, g, w, extra, d, ps, maxp, scale, stream); \
  }
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_f32_i8, float, int8_t)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_bf16_i8, __nv_bfloat16, int8_t)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_f32_fp8, float, __nv_fp8_e4m3)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_bf16_fp8, __nv_bfloat16,
                     __nv_fp8_e4m3)
