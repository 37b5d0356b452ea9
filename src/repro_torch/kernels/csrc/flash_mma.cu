// Flash attention on the tensor cores, bf16 q: both full-precision
// branches of flash_attention_2d and its offset branch over int8 / fp8
// K/V codes, one device function.
//   q [Hq_, Sq, D] bf16, k/v [Hkv_, Skv, D] (bf16, or codes C with
//   float32 per-position scales [Hkv_, Skv]), query head h reads KV head
//   h / kv_group; query row i sits at position q_offset + i and attends
//   causally to the keys below kv_len and, with a sliding window (window
//   > 0, gemma3's local layers), above its position - window -> out
//   [Hq_, Sq, D] bf16.
//   static (whole-prompt prefill, the training forward, the encoder):
//     q_offset = 0, D in {64, 80, 128, 320}; also non-causal without a
//     window (hubert's encoder; `causal` 0 at the entry point): every
//     key below kv_len, launched as the causal walk with every query at
//     position skv, past the last key, so that no warp skips a tile and
//     only the tile crossing kv_len is masked (the masks and skips below
//     are unchanged, and so is the causal case's code);
//   offset (chunked prefill over the gathered cache): any q_offset, D in
//     {64, 128, 320};
//   offset over codes (chunked prefill from quantized pools): as offset
//     without a window, C int8 or fp8-e4m3, D in {64, 128}.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// _flash_kernel (K7, the static branch, pallas_call at :309),
// ::_flash_kernel_offset (K2, the offset branch, pallas_call at :300) and
// ::_flash_kernel_offset_q (K9c, the offset branch with k_scale /
// v_scale, pallas_call at :300) for bf16 q; float32 keeps
// flash_attention.cu's CUDA-core device function.  The reference's
// numerics: QK products of bf16 summed in float32, then multiplied by
// `scale`; masked scores drop out (p = 0) and a row's running max starts
// at the reference's -1e30 fill; the online softmax's p rounded to bf16
// before PV (`p.astype(v.dtype)`), its float32 value summed into the
// normaliser; the normaliser clamped at 1e-30.  exp(s * scale - m) is
// taken as 2^(s * scale log2 e - m log2 e), one FFMA and one ex2.approx
// per score (within float32 rounding of the reference's exp): with `expf`
// and per-score masking the softmax took more instruction slots than a
// tile's MMAs and ran at half speed.  Any scale: a row's max of the scaled
// scores is max(s) * scale for scale >= 0 and min(s) * scale below 0.
// Over codes the reference dequantizes K and V to float32 (code * scale
// of the position) and keeps p in float32 (`_flash_kernel_offset_q`,
// ref.py:219).  Here the codes are converted to bf16 exactly and
//   - a score is the MMA's float32 sum over bf16 q and the K codes, times
//     ks[j] * scale: the reference's float32 dot over code * ks up to where
//     ks multiplies; the row max is taken after that multiply (a per-key
//     scale breaks the max(s) * scale shortcut);
//   - PV folds vs[j] into p's column, p' = p * vs[j], and splits p' into hi
//     + lo bf16 planes: two MMAs against the exact bf16 V codes give the
//     float32 p' V to about 2^-16; the normaliser sums the float32 p.
// What bounds it on the H100: the QK and PV products, 4 D flops per live
// (query, key) pair (6 D over codes: PV twice), against 989 TFLOP/s of
// bf16 tensor cores (the bytes, q, k, v and out once, are 10-40x smaller
// at the path's shapes).  The CUDA-core kernels did them as float FMAs,
// in blocks of 16 rows that re-read K/V from L2 four times as often.
// Design:
//   - one block of 4 warps per 64 query rows of one head, each warp owning
//     16 rows; blocks are numbered so that the q heads of one KV head are
//     adjacent (K/V stay in L2) and the longest (last) q tiles go first;
//     keys are never split across blocks (a 128-row chunk of llama3-8b is
//     2 q tiles x 32 heads = 64 blocks on 132 SMs);
//   - QK^T and PV on mma.sync.m16n8k16 (bf16 -> f32): the warp's Q
//     fragments are loaded once with ldmatrix, 64-key K tiles with
//     ldmatrix, V with ldmatrix.trans; the rounded p (over codes: p' hi
//     and lo) is the A operand of PV straight from the score accumulators
//     (mma.cuh);
//   - online softmax on the accumulator fragments: a row lives on the 4
//     lanes of a quad, its max and sum are taken by two quad shuffles;
//   - K/V tiles are bf16 in shared memory (row stride D + 8: ldmatrix
//     without bank conflicts, also at D = 80's 160-byte rows), brought by
//     cp.async 16-byte copies into a double-buffered ring: the next tile
//     loads while this one is multiplied (87 KB at D = 128: the dynamic
//     shared-memory limit is raised before the first launch).  Over codes
//     the ring holds the codes (a 64 x 128 int8 tile is 8 KB, half of
//     bf16's) and their k and v scales, and each landed tile is converted
//     into a bf16 K and V tile (int8 without the quarter-rate I2F);
//   - over codes a block has two groups of 4 warps, each warp owning 16
//     rows in each group: one group walks the even key tiles, the other
//     the odd ones, both converted in one step, and the odd group's (m,
//     l, o) is folded into the even group's at the end, in that order.
//     The serial walk of a block is half as long: the paths' chunks run
//     32-64 blocks on 132 SMs, so a block's walk is the kernel's time
//     (151 KB of shared memory at D = 128, one block per SM);
//   - causal work: tiles past a block's last position are never loaded,
//     tiles past a warp's last position are skipped by that warp, and only
//     tiles that cross the diagonal or kv_len are masked; under a window a
//     block starts at the first tile its first row can see (tiles still
//     counted from position 0), a warp skips the tiles wholly below its
//     first row's window, and a tile that crosses a row's window edge is
//     masked per key (`k_pos > q_pos - window`, the reference's);
//   - D = 320 (gemma3): the warp's Q fragments would take 80 of its
//     registers beside the 160 of its output rows, so they are read from
//     shared memory at each k-step of Q K^T instead of once; the bf16
//     ring then takes 205 KB, one block per SM;
//   - fixed 64 x 64 tiles counted from position 0 at every S and offset: a
//     fully masked tile leaves a row's max, sum and accumulator exactly as
//     they were (p = 0, corr = 1), so a row's result depends on its prefix
//     alone, bit for bit, whatever the prompt's length, padding or chunk:
//     the offset branch's rows equal the static branch's rows at the same
//     positions of the whole prompt, and over codes a chunk's rows equal
//     the rows of one chunk from offset 0; no atomics, so results repeat
//     run to run.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;     // query rows per block (16 per warp row group)
constexpr int BKV = 64;    // keys per tile
constexpr int NWARP = 4;   // warps per key group
constexpr int NT = NWARP * 32;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx: 2 ulp); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K/V over codes (K9c) rather than bf16.
template <typename C> constexpr bool kCodes = !std::is_same<C, bf16>::value;
// Key groups: over codes two groups of 4 warps walk the even and the odd
// key tiles of the block's rows; bf16 walks them all with one group.
template <typename C> constexpr int kGroups = kCodes<C> ? 2 : 1;

// Shared-memory row stride.
template <int D> __host__ __device__ constexpr int ld() { return D + 8; }
// bf16 K/V: Q, then two stages of K, then two of V.  Codes: Q, the two
// key groups' bf16 K tiles and V tiles, two stages of both groups' K and
// V codes and of their k and v scales (the codes' ring holds the second
// group's results at the end).
template <int D, typename C> __host__ __device__ constexpr size_t
smem_bytes() {
  return kCodes<C>
             ? (size_t)(BQ + 4 * BKV) * ld<D>() * sizeof(bf16) +
                   8 * BKV * D + 8 * BKV * sizeof(float)
             : (size_t)(BQ + 4 * BKV) * ld<D>() * sizeof(bf16);
}

// Rows [r0, r0 + R) of a [n, D] bf16 matrix into a shared tile of row
// stride D + 8, by NTH threads; rows at or past n are zero-filled.
template <int D, int R = 64, int NTH = NT>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int r0,
                                          int n, int tid) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  for (int i = tid; i < R * CPR; i += NTH) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < n;
    cp_async16(s + r * ld<D>() + c, g + (size_t)(ok ? r0 + r : 0) * D + c,
               ok);
  }
}

// Rows [r0, r0 + R) of a [n, D] matrix of one-byte codes into a shared
// tile of row stride D, by NTH threads; rows at or past n are zero-filled.
template <int D, int R, int NTH, typename C>
__device__ __forceinline__ void load_codes(C* s, const C* g, int r0, int n,
                                           int tid) {
  constexpr int CPR = D / 16;
  for (int i = tid; i < R * CPR; i += NTH) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const bool ok = r0 + r < n;
    cp_async16(s + r * D + c, g + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// Step `st`'s K/V into ring stage st & 1: bf16 tile st, or the codes of
// tiles 2 st and 2 st + 1 (one per key group) with their scales from ksh /
// vsh, the head's rows; positions at or past skv are zero-filled.
// kh / vh / ksh / vsh start at the block's first tile (position t0 BKV), and
// skv counts from there.
template <int D, typename C>
__device__ __forceinline__ void load_step(void* k_ring, void* v_ring,
                                          float* sc_ring, const C* kh,
                                          const C* vh, const float* ksh,
                                          const float* vsh, int st, int skv,
                                          int tid) {
  if constexpr (kCodes<C>) {
    constexpr int R = 2 * BKV, NTH = 2 * NT;
    const int off = (st & 1) * R * D;
    load_codes<D, R, NTH>(static_cast<C*>(k_ring) + off, kh, st * R, skv,
                          tid);
    load_codes<D, R, NTH>(static_cast<C*>(v_ring) + off, vh, st * R, skv,
                          tid);
    // Thread t brings the k (bit 6 clear) or v scale of position t % 64
    // of tile 2 st + t / 128: the ring holds [stage][group][k, v][BKV].
    const int kp = st * R + (tid >> 7) * BKV + (tid & (BKV - 1));
    const bool ok = kp < skv;
    cp_async4(sc_ring + (st & 1) * 4 * BKV + tid,
              ((tid >> 6) & 1 ? vsh : ksh) + (ok ? kp : 0), ok);
  } else {
    const int off = (st & 1) * BKV * ld<D>();
    load_rows<D>(static_cast<bf16*>(k_ring) + off, kh, st * BKV, skv, tid);
    load_rows<D>(static_cast<bf16*>(v_ring) + off, vh, st * BKV, skv, tid);
  }
}

// The device function of every entry point: C = bf16 (K7, K2) or int8 /
// fp8-e4m3 codes with per-position scales ks / vs (K9c).
template <int D, typename C>
__device__ __forceinline__ void flash_body(
    const bf16* __restrict__ q, const C* __restrict__ k,
    const C* __restrict__ v, const float* __restrict__ kscale,
    const float* __restrict__ vscale, bf16* __restrict__ out, int hq,
    int sq, int skv, int kv_group, int q_offset, int kv_len, int window,
    float scale) {
  constexpr bool CODES = kCodes<C>;
  constexpr int KG = kGroups<C>;
  constexpr int NTH = KG * NT;
  constexpr int LD = ld<D>();
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr bool Q_SMEM = D > 128;   // Q fragments read at each k-step
  constexpr int DN = D / 8;      // n8 tiles of the output rows
  constexpr int SN = BKV / 8;    // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  // bf16: [stage][BKV][LD]; codes: [group][BKV][LD], converted.
  bf16* k_s = q_s + BQ * LD;
  bf16* v_s = k_s + 2 * BKV * LD;
  // Codes only: the ring [stage][group][BKV][D] of K and of V codes, then
  // the ring [stage][group][k, v][BKV] of their scales.
  C* kc_s = reinterpret_cast<C*>(v_s + 2 * BKV * LD);
  C* vc_s = kc_s + 4 * BKV * D;
  float* sc_s = reinterpret_cast<float*>(vc_s + 4 * BKV * D);
  void* k_ring = CODES ? static_cast<void*>(kc_s) : static_cast<void*>(k_s);
  void* v_ring = CODES ? static_cast<void*>(vc_s) : static_cast<void*>(v_s);

  const int nqt = (sq + BQ - 1) / BQ;
  const int h = blockIdx.x % hq;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / hq)) * BQ;
  const int hk = h / kv_group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp & (NWARP - 1);   // the warp's 16 rows
  const int kg = warp / NWARP;         // ... and its key group
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qh = q + (size_t)h * sq * D;
  const C* kh = k + (size_t)hk * skv * D;
  const C* vh = v + (size_t)hk * skv * D;
  const float* ksh = CODES ? kscale + (size_t)hk * skv : nullptr;
  const float* vsh = CODES ? vscale + (size_t)hk * skv : nullptr;

  // Keys at or past kv_lim are masked; the block needs keys up to its last
  // row's position only and, under a window, from the first key its first
  // row sees: tiles t0 .. n_tiles - 1, counted from position 0.
  const int kv_lim = min(kv_len, skv);
  const int kv_end = min(kv_lim, q_offset + min(q0 + BQ, sq));
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  const int t0 = window > 0 ? max(q_offset + q0 - window + 1, 0) / BKV : 0;
  const int n_steps = n_tiles > t0 ? (n_tiles - t0 + KG - 1) / KG : 0;
  const int kbase = t0 * BKV;   // the ring's tiles start here
  kh += (size_t)kbase * D;
  vh += (size_t)kbase * D;
  if constexpr (CODES) {
    ksh += kbase;
    vsh += kbase;
  }
  const int skv_t = skv - kbase;

  load_rows<D, BQ, NTH>(q_s, qh, q0, sq, tid);
  if (n_steps > 0)
    load_step<D>(k_ring, v_ring, sc_s, kh, vh, ksh, vsh, 0, skv_t, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int w0 = q0 + rw * 16;          // the warp's first row
  const int row0 = w0 + g;              // this lane's rows: row0, row0 + 8
  const int wp0 = q_offset + w0;        // ... and their positions
  const int pos0 = q_offset + row0;
  // The A fragment of k-step ks of the warp's 16 Q rows: held for every
  // k-step, or (Q_SMEM) read from q_s when it is used.
  const bf16* q_frag = q_s + (rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD + (lane >> 4) * 8;
  uint32_t qf[Q_SMEM ? 1 : KS][4];
  if constexpr (!Q_SMEM) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], q_frag + ks * 16);
  }

  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  // Over codes the scores carry the softmax scale already (see below).
  const float sc = CODES ? 1.f : scale;
  const float scale_log2 = sc * kLog2e;
  // max(s * sc) is max(s) * sc for sc >= 0 and min(s) * sc below 0
  // (rounding is monotone); a masked score takes the value that drops out
  // of that reduction.
  const bool neg = sc < 0.f;
  const float fill = neg ? INFINITY : -INFINITY;

  for (int st = 0; st < n_steps; ++st) {
    if (st > 0) {
      cp_async_wait<0>();   // step st has landed
      __syncthreads();      // ... for every warp, and step st - 1 is done
    }
    if (st + 1 < n_steps)
      load_step<D>(k_ring, v_ring, sc_s, kh, vh, ksh, vsh, st + 1, skv_t,
                   tid);
    cp_async_commit();
    if constexpr (CODES) {
      // Both groups' codes into their bf16 tiles (exact).
      codes_to_bf16<2 * BKV, D, LD, NTH>(k_s, kc_s + (st & 1) * 2 * BKV * D);
      codes_to_bf16<2 * BKV, D, LD, NTH>(v_s, vc_s + (st & 1) * 2 * BKV * D);
      __syncthreads();
    }
    const int kt = t0 + st * KG + kg;   // this warp's tile
    const int k0 = kt * BKV;
    // Past the block's tiles, every key past every row of the warp, or
    // every key below every row's window.
    if (kt >= n_tiles || k0 > wp0 + 15 ||
        (window > 0 && k0 + BKV - 1 <= wp0 - window))
      continue;
    const int buf = CODES ? kg : (st & 1);
    const bf16* ks_t = k_s + buf * BKV * LD;
    const bf16* vs_t = v_s + buf * BKV * LD;
    // Codes: the tile's k and v scales.
    const float* ks_s = sc_s + ((st & 1) * 2 + kg) * 2 * BKV;
    const float* vs_s = ks_s + BKV;

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (Q_SMEM) {
        ldsm_x4(qa, q_frag + ks * 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      }
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks_t + (np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                              LD + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
      }
    }
    if constexpr (CODES) {
      // s = acc * (ks[j] * scale), column j = 8 n + 2 t4 + (e & 1).
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const float2 c = *reinterpret_cast<const float2*>(ks_s + j * 8 +
                                                          2 * t4);
        const float c0 = c.x * scale, c1 = c.y * scale;
        s[j][0] *= c0;
        s[j][1] *= c1;
        s[j][2] *= c0;
        s[j][3] *= c1;
      }
    }

    // Row max of the scaled scores (see `fill`); masked scores (only in a
    // tile crossing the diagonal, kv_lim or a row's window edge) drop out,
    // so a row with no live key keeps -1e30.
    const bool masked = k0 + BKV - 1 > wp0 || k0 + BKV > kv_lim ||
                        (window > 0 && k0 <= wp0 + 15 - window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qp = pos0 + (e >> 1) * 8;
          if (kp > qp || kp >= kv_lim || (window > 0 && kp <= qp - window))
            s[j][e] = fill;
        }
    }
    float mx[2] = {fill, fill};
    if (neg) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fminf(mx[e >> 1], s[j][e]);
    } else {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float corr[2], ls[2] = {0.f, 0.f}, mlog[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float o1 = __shfl_xor_sync(0xffffffffu, mx[r], 1);
      mx[r] = neg ? fminf(mx[r], o1) : fmaxf(mx[r], o1);
      const float o2 = __shfl_xor_sync(0xffffffffu, mx[r], 2);
      mx[r] = neg ? fminf(mx[r], o2) : fmaxf(mx[r], o2);
      mx[r] = fmaxf(m_r[r], mx[r] * sc);
      corr[r] = ex2((m_r[r] - mx[r]) * kLog2e);
      mlog[r] = mx[r] * kLog2e;
    }
    // p = exp(s * sc - m) as 2^(s * sc log2 e - m log2 e): one FFMA and
    // one ex2 per score; a masked score gives 0 (set outright in a masked
    // tile: at scale 0 its fill times 0 is not a number).
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], scale_log2, -mlog[e >> 1]));
        if (masked && s[j][e] == fill) p = 0.f;
        ls[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      l_r[r] = l_r[r] * corr[r] + ls[r];
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += round_bf16(P) V (over codes: (p' hi + p' lo) V, p' = p vs[j]),
    // 16 keys per k-step.
#pragma unroll
    for (int kb = 0; kb < BKV / 16; ++kb) {
      uint32_t a[4], alo[4];
      if constexpr (CODES) {
        const float2 va = *reinterpret_cast<const float2*>(vs_s + kb * 16 +
                                                           2 * t4);
        const float2 vb = *reinterpret_cast<const float2*>(vs_s + kb * 16 +
                                                           8 + 2 * t4);
        pack_bf16_split(s[2 * kb][0] * va.x, s[2 * kb][1] * va.y, a[0],
                        alo[0]);
        pack_bf16_split(s[2 * kb][2] * va.x, s[2 * kb][3] * va.y, a[1],
                        alo[1]);
        pack_bf16_split(s[2 * kb + 1][0] * vb.x, s[2 * kb + 1][1] * vb.y,
                        a[2], alo[2]);
        pack_bf16_split(s[2 * kb + 1][2] * vb.x, s[2 * kb + 1][3] * vb.y,
                        a[3], alo[3]);
      } else {
        a[0] = pack_bf16(s[2 * kb][0], s[2 * kb][1]);
        a[1] = pack_bf16(s[2 * kb][2], s[2 * kb][3]);
        a[2] = pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]);
        a[3] = pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs_t + (kb * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                             dp * 16 + ((lane >> 4) & 1) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        if constexpr (CODES) {
          mma_bf16(o[2 * dp], alo, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], alo, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (KG == 2) {
    // The odd-tile group hands its rows' (m, l, o) over through the
    // codes' ring; the even-tile group folds them in, in that order.
    __syncthreads();                            // the ring is free
    float* ob = reinterpret_cast<float*>(kc_s);  // [BQ][D]
    float* mb = ob + BQ * D;                    // [BQ]
    float* lb = mb + BQ;                        // [BQ]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rw * 16 + g + r * 8;
      if (kg == 1) {
        if (t4 == 0) {
          mb[row] = m_r[r];
          lb[row] = l_r[r];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j)
          *reinterpret_cast<float2*>(ob + row * D + j * 8 + 2 * t4) =
              make_float2(o[j][2 * r], o[j][2 * r + 1]);
      }
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rw * 16 + g + r * 8;
      const float m1 = mb[row], mm = fmaxf(m_r[r], m1);
      const float c0 = ex2((m_r[r] - mm) * kLog2e);
      const float c1 = ex2((m1 - mm) * kLog2e);
      l_r[r] = l_r[r] * c0 + lb[row] * c1;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float2 o1 =
            *reinterpret_cast<const float2*>(ob + row * D + j * 8 + 2 * t4);
        o[j][2 * r] = o[j][2 * r] * c0 + o1.x * c1;
        o[j][2 * r + 1] = o[j][2 * r + 1] * c0 + o1.y * c1;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= sq) continue;
    const float denom = fmaxf(l_r[r], 1e-30f);
    bf16* orow = out + ((size_t)h * sq + row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

// K7 and K2.
template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int hq,
                 int sq, int skv, int kv_group, int q_offset, int kv_len,
                 int window, float scale) {
  flash_body<D, bf16>(q, k, v, nullptr, nullptr, out, hq, sq, skv, kv_group,
                      q_offset, kv_len, window, scale);
}

// K9c: a name of its own, so that a profile tells it from K2 and K7.
template <int D, typename C>
__global__ void __launch_bounds__(2 * NT, 1)
flash_mma_q_kernel(const bf16* __restrict__ q, const C* __restrict__ k,
                   const C* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, bf16* __restrict__ out,
                   int hq, int sq, int skv, int kv_group, int q_offset,
                   int kv_len, float scale) {
  flash_body<D, C>(q, k, v, ks, vs, out, hq, sq, skv, kv_group, q_offset,
                   kv_len, 0, scale);
}

template <int D, typename C>
int launch_d(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, void* out, int hq, int sq, int skv,
             int kv_group, int q_offset, int kv_len, int window, float scale,
             cudaStream_t stream) {
  static size_t smem_set = 0;   // raised once per instance
  constexpr size_t smem = smem_bytes<D, C>();
  const long blocks = (long)cdiv(sq, BQ) * hq;
  if constexpr (kCodes<C>) {
    const cudaError_t err =
        raise_smem(flash_mma_q_kernel<D, C>, smem, &smem_set);
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) return (int)cudaGetLastError();
    flash_mma_q_kernel<D, C><<<(unsigned)blocks, kGroups<C> * NT, smem,
                               stream>>>(
        static_cast<const bf16*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), ks, vs, static_cast<bf16*>(out), hq, sq,
        skv, kv_group, q_offset, kv_len, scale);
  } else {
    const cudaError_t err = raise_smem(flash_mma_kernel<D>, smem, &smem_set);
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) return (int)cudaGetLastError();
    flash_mma_kernel<D><<<(unsigned)blocks, NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, sq, skv,
        kv_group, q_offset, kv_len, window, scale);
  }
  return (int)cudaGetLastError();
}

template <typename C = bf16>
int launch(const void* q, const void* k, const void* v, void* out, int hq,
           int sq, int skv, int d, int kv_group, int q_offset, int kv_len,
           int window, float scale, void* stream, const void* ks = nullptr,
           const void* vs = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(ks);
  const float* vf = static_cast<const float*>(vs);
  if (window < 0 || (kCodes<C> && window)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_d<64, C>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                           q_offset, kv_len, window, scale, st);
  if constexpr (!kCodes<C>) {
    if (d == 80)   // the static branch (zamba2)
      return launch_d<80, C>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                             q_offset, kv_len, window, scale, st);
    if (d == 320)  // gemma3
      return launch_d<320, C>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                              q_offset, kv_len, window, scale, st);
  }
  if (d == 128)
    return launch_d<128, C>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                            q_offset, kv_len, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v and out 16-byte aligned (the wrapper sees to it); window 0 for
// none; causal 0: non-causal, without a window (every query at position
// skv sees every key below kv_len).
extern "C" int repro_flash_static_mma_bf16(const void* q, const void* k,
                                           const void* v, void* out, int hq,
                                           int sq, int skv, int d,
                                           int kv_group, int kv_len,
                                           int window, int causal,
                                           float scale, void* stream) {
  if (!causal && window) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, out, hq, sq, skv, d, kv_group, causal ? 0 : skv,
                kv_len, window, scale, stream);
}

// The offset branch (K2): query row i at position q_offset + i.
extern "C" int repro_flash_offset_mma_bf16(const void* q, const void* k,
                                           const void* v, void* out, int hq,
                                           int sq, int skv, int d,
                                           int kv_group, int q_offset,
                                           int kv_len, int window,
                                           float scale, void* stream) {
  return launch(q, k, v, out, hq, sq, skv, d, kv_group, q_offset, kv_len,
                window, scale, stream);
}

// The offset branch over codes C (K9c) with float32 per-position scales
// ks / vs [Hkv_, Skv] (any alignment); q, the codes and out 16-byte
// aligned.
#define REPRO_FLASH_OFFSET_Q_MMA(NAME, C)                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* ks, const void* vs, void* out, int hq,     \
                      int sq, int skv, int d, int kv_group, int q_offset,    \
                      int kv_len, float scale, void* stream) {               \
    return launch<C>(q, k, v, out, hq, sq, skv, d, kv_group, q_offset,       \
                     kv_len, 0, scale, stream, ks, vs);                      \
  }
REPRO_FLASH_OFFSET_Q_MMA(repro_flash_offset_q_mma_bf16_i8, int8_t)
REPRO_FLASH_OFFSET_Q_MMA(repro_flash_offset_q_mma_bf16_fp8, __nv_fp8_e4m3)
