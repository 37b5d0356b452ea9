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
// passes q_off with extra = 1 (row w attends through q_off + w).  With a
// sliding window (window > 0, gemma3's local layers; a runtime integer,
// over full-precision and code pools alike) it attends to the last
// `window` of them, positions [len - window, len) (the reference's
// `kv_pos >= length - window`).
// Only what the main paths run is built (one library per head dim:
// paged_attention.cu at 128, paged_attention_64.cu, paged_attention_80.cu,
// and at 320 paged_attention_320.cu over full-precision pools and
// paged_attention_q320.cu over codes): D in {64, 128} (gpt2, llama3), 320
// (gemma3) and, for decode only, 80 (zamba2's shared block); W * G up to
// 64 rows, 32 at D = 320; the wrapper refuses the rest on the card.
//
// Replaces the TPU kernels
// src/repro/kernels/paged_attention.py::_paged_decode_kernel (pallas_call
// in paged_decode_attention at :441), ::_paged_verify_kernel (pallas_call
// in paged_verify_attention at :364), and their quantized bodies
// ::_paged_decode_kernel_q and ::_paged_verify_kernel_q (the same calls
// with k_scale / v_scale).  There the page table, lengths and scale pools
// are scalar-prefetch operands feeding the BlockSpec index maps, and the
// grid walks a slot's pages in order; here a block resolves its own page
// ids and the keys of a slot are split across blocks (flash-decoding).
//
// What bounds it on the H100: the K/V bytes of the live pages (memory
// bound; a code pool moves a quarter (f32) or half (bf16) of the bytes).
// Decode does 4 flops per K/V element and query row, a few flops per byte
// at the paths' 1-20 rows: far below the 295 flop/byte at which bf16
// tensor cores would matter, so the arithmetic stays the reference's
// float32 on the CUDA cores, and the design is about parallelism and bytes
// in flight.
//   - Partitions fixed by position: block (b, h, p) owns positions
//     [p P, (p + 1) P) of slot b's page-table extent maxp * ps, P a
//     constant (common.py's PAGED_PART, a multiple of the 32-position
//     tile); the grid is (B, Hkv, cdiv(extent, P)), and a block whose
//     partition starts at or past its window's deepest row, or ends at or
//     below its shallowest row's sliding window, exits at once; a block
//     walks its tiles from the first one its shallowest row can see.
//   - The block first resolves each of its positions' pool rows (and, for
//     codes, that page's K/V scales for head h), then keeps its 32-position
//     K and V tiles in flight in a ring of NSTAGE shared-memory stages with
//     cp.async 16-byte copies (8 bf16, 4 float32 or 16 codes per copy; a
//     pool row is D * sizeof(C) bytes, a whole number of 16-byte vectors at
//     D 64/80/128/320), so every tile of a 128-position partition is
//     loading while the first is scored (at D = 320 in float32 the ring
//     holds 2 stages: 4 would take 324 KB; over one-byte codes a 32-position
//     tile at D = 320 is 10.5 KB and the ring keeps 4).  Positions past the
//     deepest row
//     are zero-filled (src-size 0) and never read from the pool.
//   - The W x G query rows sharing KV head h live in the block, RPW per
//     warp (q * scale in float32 in shared memory).  Lane j scores
//     position j: each K element it reads serves every row the warp
//     carries; in PV a lane owns chunks lane + 32 c of 2 or 4 adjacent
//     output dims of every such row (one chunk up to D = 128; at D = 320
//     lanes 0..15 own three, the others two), and each V element it reads
//     serves them all.
//   - Numerics follow the reference: K/V in float32 (codes dequantized on
//     load, `float(code) * page_scale`, before the dot, as the reference's
//     `k.astype(f32) * ks[phys, h]`), each score a sequential float32 dot
//     over D, masked scores at -1e30, an online softmax over the
//     partition's tiles, float32 PV.
//   - Each live (row, partition) writes its float32 partial (m, l, acc[D])
//     to a buffer the wrapper allocates per call; paged_combine_kernel then
//     folds a row's live partitions in order (the partitions' max first,
//     then l and acc scaled by exp(m_p - max)), divides by max(l, 1e-30)
//     and writes zeros for a row of length 0.  No atomics.
// Exactness: a row skips every tile that starts at or past its own length
// or ends at or below its window (the warp-uniform exact no-op of the
// reference's p = 0, corr = 1), masks the positions of its edge tiles
// outside [len - window, len) (p = 0, against finite or zero-filled V), and
// the fold takes exactly the partitions that hold a position of that range
// (one that ends at or below it is never read, so it needs no partial).
// P does not depend on the lengths, W, B or the card, so a
// row's sequence of float32 operations depends on its length alone: every
// verify row is bit-identical to the decode kernel at that length, and a
// slot's bits do not depend on the other slots or on where its pages lie.
// That is what lets speculative acceptance keep exactly the tokens plain
// greedy decode produces, with or without quantized pools.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int CH = 32;        // positions per tile: one per lane
constexpr int NWARP = 4;
constexpr int MAX_ROWS = 64;  // W * G rows one block holds (RPW <= 16)
constexpr int COMBINE_WARPS = 4;
constexpr size_t kSmemMax = 232448;   // a block's shared memory on the H100

// Shared-memory geometry of a 32-position K or V tile of C at head dim D.
template <typename C, int D>
struct Tile {
  static_assert(D * sizeof(C) % 16 == 0, "pool rows must be 16-byte vectors");
  static constexpr int VE = 16 / sizeof(C);    // elements per 16-byte copy
  static constexpr int RV = D / VE;            // copies per pool row
  // Row stride in 16-byte units, odd: lane j's 16-byte reads of row j hit
  // distinct banks in every quarter warp.
  static constexpr int STRIDE = (RV | 1) * 16;
  static constexpr int BYTES = CH * STRIDE;
  static constexpr int DV = D == 64 ? 2 : 4;   // adjacent dims of a chunk
  static constexpr int NCH = D / DV;           // chunks of an output row
  static constexpr int CPL = (NCH + 31) / 32;  // chunks lane + 32 c a lane owns
  // Tiles in flight per block: 4, or 2 where 4 stages of K and V would
  // take more than 168 KB (float32 at D = 320).
  static constexpr int NSTAGE = 8 * BYTES <= 168 * 1024 ? 4 : 2;
};

template <typename C, int D>
constexpr size_t smem_bytes(int rows, int part) {
  // K/V ring, q_s [rows][D], p_s [rows][CH], off_s [part] (int64),
  // ks_s / vs_s [part].
  return (size_t)Tile<C, D>::NSTAGE * 2 * Tile<C, D>::BYTES +
         sizeof(float) * rows * D + sizeof(float) * rows * CH +
         sizeof(long long) * part + 2 * sizeof(float) * part;
}

template <typename C, int N>
struct alignas(sizeof(C) * N) Vec {
  C v[N];
};

template <typename T, typename C, int D, int RPW>
__global__ void __launch_bounds__(NWARP * 32)
paged_window_kernel(const T* __restrict__ q, const C* __restrict__ kpool,
                    const C* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ base,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int hkv, int g, int w, int extra, int ps, int maxp,
                    int part, int window, float scale) {
  using TL = Tile<C, D>;
  constexpr bool QUANT = !std::is_same<T, C>::value;
  constexpr int ROWS = NWARP * RPW;
  constexpr int DV = TL::DV;
  constexpr int CPL = TL::CPL;
  constexpr int NSTAGE = TL::NSTAGE;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                // [NSTAGE][K, V]
  float* q_s = reinterpret_cast<float*>(ring + NSTAGE * 2 * TL::BYTES);
  float* p_s = q_s + ROWS * D;                               // [ROWS][CH]
  long long* off_s = reinterpret_cast<long long*>(p_s + ROWS * CH);
  float* ks_s = reinterpret_cast<float*>(off_s + part);
  float* vs_s = ks_s + part;

  const int b = blockIdx.x, h = blockIdx.y, pidx = blockIdx.z;
  const int parts = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;
  const int rows = w * g;
  const int extent = maxp * ps;
  const int b0 = base[b] + extra;
  const int deepest = min(max(b0 + w - 1, 0), extent);
  // The first position the shallowest row (window slot 0) sees.
  const int lo_min =
      window > 0 ? max(min(max(b0, 0), extent) - window, 0) : 0;
  const int p0 = pidx * part;
  // Block-uniform: no row sees this partition.
  if (p0 >= deepest || p0 + part <= lo_min) return;
  const int span = min(deepest - p0, part);   // positions this block reads
  const int ntiles = (span + CH - 1) / CH;
  const int tfirst = max(lo_min - p0, 0) / CH;  // the first tile it needs
  const int* trow = table + (size_t)b * maxp;

  // Each position's pool row (element offset; -1 past the deepest row) and,
  // for codes, its page's scales for head h, resolved ahead of the copies.
  for (int i = tid; i < part; i += NWARP * 32) {
    long long off = -1;
    float ksv = 0.f, vsv = 0.f;
    if (i < span) {
      const int pos = p0 + i;
      const long long page = trow[pos / ps];
      off = ((page * ps + pos % ps) * hkv + h) * D;
      if constexpr (QUANT) {
        ksv = kscale[page * hkv + h];
        vsv = vscale[page * hkv + h];
      }
    }
    off_s[i] = off;
    ks_s[i] = ksv;
    vs_s[i] = vsv;
  }
  // Block row r = wi * G + gi: window slot wi, query head h * G + gi;
  // q * scale in float32, rows past W * G zero.
  for (int i = tid; i < ROWS * D; i += NWARP * 32) {
    const int r = i / D, c = i % D;
    float v = 0.f;
    if (r < rows) {
      const int wi = r / g, gi = r % g;
      v = to_f(q[(((size_t)b * w + wi) * hq + h * g + gi) * D + c]) * scale;
    }
    q_s[i] = v;
  }
  __syncthreads();

  // Tile t (positions p0 + 32 t ...) into stage t % NSTAGE: K rows, then V.
  auto issue = [&](int t) {
    if (t < ntiles) {
      unsigned char* st = ring + (t % NSTAGE) * 2 * TL::BYTES;
      for (int i = tid; i < 2 * CH * TL::RV; i += NWARP * 32) {
        const int kv = i / (CH * TL::RV);
        const int r = (i / TL::RV) % CH;
        const int v = i % TL::RV;
        const long long off = off_s[t * CH + r];
        const C* pool = kv ? vpool : kpool;
        cp_async16(st + kv * TL::BYTES + r * TL::STRIDE + v * 16,
                   off >= 0 ? pool + off + v * TL::VE : pool, off >= 0);
      }
    }
    cp_async_commit();
  };

  // A row sees positions [lo, len): lo = len - window under a window.
  float m[RPW], l[RPW], acc[RPW][CPL][DV];
  int len[RPW], lo[RPW];
#pragma unroll
  for (int hh = 0; hh < RPW; ++hh) {
    const int r = warp + NWARP * hh;
    len[hh] = r < rows ? min(max(b0 + r / g, 0), extent) : 0;
    lo[hh] = window > 0 ? max(len[hh] - window, 0) : 0;
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[hh][c][e] = 0.f;
  }
  float* my_p = p_s + warp * RPW * CH;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue(tfirst + s);
  for (int t = tfirst; t < ntiles; ++t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();          // tile t landed; tile t - 1's stage is free
    issue(t + NSTAGE - 1);
    const unsigned char* k_t = ring + (t % NSTAGE) * 2 * TL::BYTES;
    const unsigned char* v_t = k_t + TL::BYTES;
    const int c0 = p0 + t * CH;
    const int pos = c0 + lane;

    // Scores: lane j's position against every row the warp carries, each
    // a sequential float32 dot over D.
    float s[RPW];
#pragma unroll
    for (int hh = 0; hh < RPW; ++hh) s[hh] = 0.f;
    const unsigned char* krow = k_t + lane * TL::STRIDE;
    const float ksc = QUANT ? ks_s[t * CH + lane] : 1.f;
#pragma unroll 2
    for (int v = 0; v < TL::RV; ++v) {
      const Vec<C, TL::VE> raw =
          *reinterpret_cast<const Vec<C, TL::VE>*>(krow + v * 16);
      float kf[TL::VE];
#pragma unroll
      for (int x = 0; x < TL::VE; ++x) {
        kf[x] = to_f(raw.v[x]);
        if constexpr (QUANT) kf[x] *= ksc;
      }
#pragma unroll
      for (int x = 0; x < TL::VE; x += 4) {
#pragma unroll
        for (int hh = 0; hh < RPW; ++hh) {
          const float4 qv = *reinterpret_cast<const float4*>(
              q_s + (warp + NWARP * hh) * D + v * TL::VE + x);
          s[hh] = fmaf(qv.x, kf[x], s[hh]);
          s[hh] = fmaf(qv.y, kf[x + 1], s[hh]);
          s[hh] = fmaf(qv.z, kf[x + 2], s[hh]);
          s[hh] = fmaf(qv.w, kf[x + 3], s[hh]);
        }
      }
    }

    // Online softmax per live row (warp-uniform: a row whose positions
    // [lo, len) miss the tile skips it).
    bool live[RPW];
#pragma unroll
    for (int hh = 0; hh < RPW; ++hh) {
      live[hh] = c0 < len[hh] && c0 + CH > lo[hh];
      float p = 0.f;
      if (live[hh]) {
        const bool valid = pos < len[hh] && pos >= lo[hh];
        const float sv = valid ? s[hh] : kNegInf;
        const float m_new = fmaxf(m[hh], warp_max(sv));
        p = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[hh] - m_new);
        l[hh] = fmaf(l[hh], corr, warp_sum(p));
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[hh][c][e] *= corr;
        m[hh] = m_new;
      }
      my_p[hh * CH + lane] = p;
    }
    __syncwarp();

    // PV: position by position, each V element this lane reads serves
    // every row the warp carries.
#pragma unroll 2
    for (int j = 0; j < CH; j += 4) {
      float4 pj[RPW];
#pragma unroll
      for (int hh = 0; hh < RPW; ++hh)
        pj[hh] = *reinterpret_cast<const float4*>(my_p + hh * CH + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = lane + 32 * c;   // this lane's chunk
          float vv[DV];
          if (ch < TL::NCH) {
            const Vec<C, DV> raw = *reinterpret_cast<const Vec<C, DV>*>(
                v_t + (j + jj) * TL::STRIDE + ch * DV * sizeof(C));
#pragma unroll
            for (int e = 0; e < DV; ++e) {
              vv[e] = to_f(raw.v[e]);
              if constexpr (QUANT) vv[e] *= vs_s[t * CH + j + jj];
            }
          } else {
#pragma unroll
            for (int e = 0; e < DV; ++e) vv[e] = 0.f;
          }
#pragma unroll
          for (int hh = 0; hh < RPW; ++hh) {
            const float p = jj == 0 ? pj[hh].x : jj == 1 ? pj[hh].y
                          : jj == 2 ? pj[hh].z : pj[hh].w;
            if (live[hh]) {
#pragma unroll
              for (int e = 0; e < DV; ++e)
                acc[hh][c][e] = fmaf(p, vv[e], acc[hh][c][e]);
            }
          }
        }
      }
    }
    __syncwarp();            // my_p is rewritten by the next tile
  }

  // The partial of every row that saw this partition (the ones the fold
  // reads).
#pragma unroll
  for (int hh = 0; hh < RPW; ++hh) {
    const int r = warp + NWARP * hh;
    if (r >= rows || p0 >= len[hh] || p0 + part <= lo[hh])
      continue;                                   // warp-uniform
    const int wi = r / g, gi = r % g;
    const size_t slot =
        ((((size_t)b * w + wi) * hq + h * g + gi) * parts + pidx);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = lane + 32 * c;
      if (ch >= TL::NCH) continue;
      float* dst = part_acc + slot * D + ch * DV;
      if constexpr (DV == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[hh][c][0], acc[hh][c][1], acc[hh][c][2], acc[hh][c][3]);
      else
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[hh][c][0], acc[hh][c][1]);
    }
    if (lane == 0) {
      part_ml[2 * slot] = m[hh];
      part_ml[2 * slot + 1] = l[hh];
    }
  }
}

// One warp per output row (b, w, query head): fold the partitions that
// hold a position of the row's [lo, len) in order, divide by the clamped
// normaliser and round to T; a row of length 0 writes zeros.
template <typename T, int D>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
paged_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int* __restrict__ base, T* __restrict__ out,
                     int nrows, int w, int hq, int extra, int extent,
                     int part, int parts, int window) {
  constexpr int DPL = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const int b = row / (w * hq), wi = (row / hq) % w;
  const int len = min(max(base[b] + extra + wi, 0), extent);
  const int live = (len + part - 1) / part;
  const int first = window > 0 ? max(len - window, 0) / part : 0;
  const float* ml = part_ml + (size_t)row * parts * 2;
  const float* pa = part_acc + (size_t)row * parts * D;
  float mx = kNegInf;
  for (int p = first; p < live; ++p) mx = fmaxf(mx, ml[2 * p]);
  float sum = 0.f, a[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) a[i] = 0.f;
  for (int p = first; p < live; ++p) {
    const float e = expf(ml[2 * p] - mx);
    sum = fmaf(ml[2 * p + 1], e, sum);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (lane + 32 * i < D)
        a[i] = fmaf(pa[(size_t)p * D + lane + 32 * i], e, a[i]);
  }
  const float denom = fmaxf(sum, 1e-30f);
  T* o = out + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < D) o[lane + 32 * i] = from_f<T>(a[i] / denom);
}

// The pointer operands of one launch; ks / vs are null for pools of T.
struct Operands {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const void *table, *base;
  float* part;      // [B * W * Hq * parts * (D + 2)] float32
  void* out;
};

struct Shape {
  int b, hkv, g, w, extra, ps, maxp, part, window;
  float scale;
};

template <typename T, typename C, int D, int RPW>
int launch_rpw(const Operands& o, const Shape& s, cudaStream_t stream) {
  const int extent = s.maxp * s.ps;
  const int parts = cdiv(extent, s.part);
  const int nrows = s.b * s.w * s.hkv * s.g;
  float* part_acc = o.part;
  float* part_ml = o.part + (size_t)nrows * parts * D;
  const size_t smem = smem_bytes<C, D>(NWARP * RPW, s.part);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = paged_window_kernel<T, C, D, RPW>;
  // Above 48 KB a block's shared memory must be opted into per kernel;
  // raised once per instance, not on every launch (a decode step makes one
  // launch per layer).
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  kernel<<<dim3(s.b, s.hkv, parts), NWARP * 32, smem, stream>>>(
      static_cast<const T*>(o.q), static_cast<const C*>(o.kp),
      static_cast<const C*>(o.vp), o.ks, o.vs,
      static_cast<const int*>(o.table), static_cast<const int*>(o.base),
      part_acc, part_ml, s.hkv, s.g, s.w, s.extra, s.ps, s.maxp, s.part,
      s.window, s.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T, D>
      <<<cdiv(nrows, COMBINE_WARPS), COMBINE_WARPS * 32, 0, stream>>>(
          part_acc, part_ml, static_cast<const int*>(o.base),
          static_cast<T*>(o.out), nrows, s.w, s.hkv * s.g, s.extra, extent,
          s.part, parts, s.window);
  return (int)cudaGetLastError();
}

// Rows per warp: the fewest that hold the block's W * G rows.  A row's
// arithmetic does not depend on it.  At D = 320 a block holds 32 rows at
// most, over codes too (64 would take 81 KB of q_s beside the ring and 192
// accumulator registers a thread).
template <typename T, typename C, int D>
int launch_d(const Operands& o, const Shape& s, cudaStream_t stream) {
  const int rows = s.w * s.g;
  if (rows <= NWARP) return launch_rpw<T, C, D, 1>(o, s, stream);
  if (rows <= 2 * NWARP) return launch_rpw<T, C, D, 2>(o, s, stream);
  if (rows <= 4 * NWARP) return launch_rpw<T, C, D, 4>(o, s, stream);
  if (rows <= 8 * NWARP) return launch_rpw<T, C, D, 8>(o, s, stream);
  if constexpr (D <= 128) return launch_rpw<T, C, D, 16>(o, s, stream);
  return (int)cudaErrorInvalidValue;
}

// Launch at head dim d, one of Ds: the instances a translation unit
// builds, one head dim each (paged_attention.cu: 128;
// paged_attention_64.cu, paged_attention_80.cu: 64 and 80;
// paged_attention_320.cu and paged_attention_q320.cu: gemma3's 320 over
// full-precision and code pools), each in a library of its own that
// compiles beside the others.
template <typename T, typename C, int... Ds>
int launch(const Operands& o, const Shape& s, int d, void* stream) {
  // Partitions are whole 32-position tiles.
  if (s.g < 1 || s.w < 1 || s.w * s.g > MAX_ROWS || s.part < CH ||
      s.part % CH || s.window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = (int)cudaErrorInvalidValue;
  (void)((d == Ds && ((status = launch_d<T, C, Ds>(o, s, st)), true)) ||
         ...);
  return status;
}

}  // namespace

// base: lengths (decode, extra = 0, w = 1) or q_off (verify, extra = 1);
// part: the float32 partials, B * W * Hq * cdiv(maxp * ps, part_size) *
// (D + 2) floats; part_size: the partition P; window: the sliding window,
// 0 for none.
#define REPRO_PAGED_WINDOW(NAME, T, ...)                                     \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,        \
                      const void* table, const void* base, void* part,       \
                      void* out, int b, int hkv, int g, int w, int extra,    \
                      int d, int ps, int maxp, int part_size, int window,    \
                      float scale, void* stream) {                           \
    const Operands o{q, kp, vp, nullptr, nullptr, table, base,              \
                     static_cast<float*>(part), out};                        \
    const Shape s{b, hkv, g, w, extra, ps, maxp, part_size, window, scale};  \
    return launch<T, T, __VA_ARGS__>(o, s, d, stream);                       \
  }

// The quantized twins: pools of codes C, scales [P, Hkv] float32; window
// as above.
#define REPRO_PAGED_WINDOW_Q(NAME, T, C, ...)                                \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,        \
                      const void* ks, const void* vs, const void* table,     \
                      const void* base, void* part, void* out, int b,        \
                      int hkv, int g, int w, int extra, int d, int ps,       \
                      int maxp, int part_size, int window, float scale,      \
                      void* stream) {                                        \
    const Operands o{q, kp, vp, static_cast<const float*>(ks),              \
                     static_cast<const float*>(vs), table, base,             \
                     static_cast<float*>(part), out};                        \
    const Shape s{b, hkv, g, w, extra, ps, maxp, part_size, window, scale};  \
    return launch<T, C, __VA_ARGS__>(o, s, d, stream);                       \
  }
