// Flash attention on the tensor cores, bf16: both full-precision branches
// of flash_attention_2d, one device function.
//   q [Hq_, Sq, D], k/v [Hkv_, Skv, D] bf16, query head h reads KV head
//   h / kv_group; query row i sits at position q_offset + i and attends
//   causally to the keys below kv_len -> out [Hq_, Sq, D] bf16.
//   static (whole-prompt prefill, the training forward): q_offset = 0,
//     D in {64, 80, 128};
//   offset (chunked prefill over the gathered cache): any q_offset, D in
//     {64, 128}.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// _flash_kernel (K7, the static branch, pallas_call at :309) and
// ::_flash_kernel_offset (K2, the offset branch, pallas_call at :300) for
// bf16; float32 keeps flash_attention.cu's CUDA-core device function, as
// does the offset branch over int8 / fp8 codes (K9c).  The reference's
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
// What bounds it on the H100: the QK and PV products, 4 D flops per live
// (query, key) pair, against 989 TFLOP/s of bf16 tensor cores (the bytes,
// q, k, v and out once, are 10-40x smaller at the path's shapes).  The
// CUDA-core kernels did them as float FMAs, in blocks of 16 rows that
// re-read K/V from L2 four times as often.  Design:
//   - one block of 4 warps per 64 query rows of one head, each warp owning
//     16 rows; blocks are numbered so that the q heads of one KV head are
//     adjacent (K/V stay in L2) and the longest (last) q tiles go first;
//     keys are never split across blocks (a 128-row chunk of llama3-8b is
//     2 q tiles x 32 heads = 64 blocks on 132 SMs);
//   - QK^T and PV on mma.sync.m16n8k16 (bf16 -> f32): the warp's Q
//     fragments are loaded once with ldmatrix, 64-key K tiles with
//     ldmatrix, V with ldmatrix.trans; the rounded p is the A operand of
//     PV straight from the score accumulators (mma.cuh);
//   - online softmax on the accumulator fragments: a row lives on the 4
//     lanes of a quad, its max and sum are taken by two quad shuffles;
//   - K/V tiles stay bf16 in shared memory (row stride D + 8: ldmatrix
//     without bank conflicts, also at D = 80's 160-byte rows), brought by
//     cp.async 16-byte copies into a double-buffered ring: the next tile
//     loads while this one is multiplied (87 KB at D = 128: the dynamic
//     shared-memory limit is raised before the first launch);
//   - causal work: tiles past a block's last position are never loaded,
//     tiles past a warp's last position are skipped by that warp, and only
//     tiles that cross the diagonal or kv_len are masked;
//   - fixed 64 x 64 tiles counted from position 0 at every S and offset: a
//     fully masked tile leaves a row's max, sum and accumulator exactly as
//     they were (p = 0, corr = 1), so a row's result depends on its prefix
//     alone, bit for bit, whatever the prompt's length, padding or chunk:
//     the offset branch's rows equal the static branch's rows at the same
//     positions of the whole prompt; no atomics, so results repeat run to
//     run.
#include "common.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;     // query rows per block (16 per warp)
constexpr int BKV = 64;    // keys per tile
constexpr int NWARP = 4;
constexpr int NT = NWARP * 32;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx: 2 ulp); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory row stride.
template <int D> __host__ __device__ constexpr int ld() { return D + 8; }
// Q, then two stages of K, then two of V.
template <int D> __host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BKV) * ld<D>() * sizeof(bf16);
}

// Rows [r0, r0 + 64) of a [n, D] bf16 matrix into a shared tile of row
// stride D + 8; rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int r0,
                                          int n, int tid) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  for (int i = tid; i < 64 * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < n;
    cp_async16(s + r * ld<D>() + c, g + (size_t)(ok ? r0 + r : 0) * D + c,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int hq,
                 int sq, int skv, int kv_group, int q_offset, int kv_len,
                 float scale) {
  constexpr int LD = ld<D>();
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int DN = D / 8;      // n8 tiles of the output rows
  constexpr int SN = BKV / 8;    // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * LD;           // [2][BKV][LD]
  bf16* v_s = k_s + 2 * BKV * LD;      // [2][BKV][LD]

  const int nqt = (sq + BQ - 1) / BQ;
  const int h = blockIdx.x % hq;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / hq)) * BQ;
  const int hk = h / kv_group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qh = q + (size_t)h * sq * D;
  const bf16* kh = k + (size_t)hk * skv * D;
  const bf16* vh = v + (size_t)hk * skv * D;

  // Keys at or past kv_lim are masked; the block needs keys up to its last
  // row's position only.
  const int kv_lim = min(kv_len, skv);
  const int kv_end = min(kv_lim, q_offset + min(q0 + BQ, sq));
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  load_rows<D>(q_s, qh, q0, sq, tid);
  if (n_tiles > 0) {
    load_rows<D>(k_s, kh, 0, skv, tid);
    load_rows<D>(v_s, vh, 0, skv, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int w0 = q0 + warp * 16;        // the warp's first row
  const int row0 = w0 + g;              // this lane's rows: row0, row0 + 8
  const int wp0 = q_offset + w0;        // ... and their positions
  const int pos0 = q_offset + row0;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LD + ks * 16 + (lane >> 4) * 8);

  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;
  // max(s * scale) is max(s) * scale for scale >= 0 and min(s) * scale
  // below 0 (rounding is monotone); a masked score takes the value that
  // drops out of that reduction.
  const bool neg = scale < 0.f;
  const float fill = neg ? INFINITY : -INFINITY;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt > 0) {
      cp_async_wait<0>();   // tile kt has landed
      __syncthreads();      // ... for every warp, and tile kt - 1 is done
    }
    if (kt + 1 < n_tiles) {
      const int nb = (kt + 1) & 1;
      load_rows<D>(k_s + nb * BKV * LD, kh, (kt + 1) * BKV, skv, tid);
      load_rows<D>(v_s + nb * BKV * LD, vh, (kt + 1) * BKV, skv, tid);
    }
    cp_async_commit();
    const int k0 = kt * BKV;
    if (k0 > wp0 + 15) continue;   // every key past every row of the warp
    const bf16* ks_t = k_s + (kt & 1) * BKV * LD;
    const bf16* vs_t = v_s + (kt & 1) * BKV * LD;

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks_t + (np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                              LD + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }

    // Row max of the scaled scores (see `fill`); masked scores (only in a
    // tile crossing the diagonal or kv_lim) drop out, so a row with no
    // live key keeps -1e30.
    const bool masked = k0 + BKV - 1 > wp0 || k0 + BKV > kv_lim;
    if (masked) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          if (kp > pos0 + (e >> 1) * 8 || kp >= kv_lim) s[j][e] = fill;
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
      mx[r] = fmaxf(m_r[r], mx[r] * scale);
      corr[r] = ex2((m_r[r] - mx[r]) * kLog2e);
      mlog[r] = mx[r] * kLog2e;
    }
    // p = exp(s * scale - m) as 2^(s * scale log2 e - m log2 e): one FFMA
    // and one ex2 per score; a masked score gives 0 (set outright in a
    // masked tile: at scale 0 its fill times 0 is not a number).
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

    // O += round_bf16(P) V, 16 keys per k-step.
#pragma unroll
    for (int kb = 0; kb < BKV / 16; ++kb) {
      const uint32_t a[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                             pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                             pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                             pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs_t + (kb * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                             dp * 16 + ((lane >> 4) & 1) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

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

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int hq,
             int sq, int skv, int kv_group, int q_offset, int kv_len,
             float scale, cudaStream_t stream) {
  static bool smem_set = false;   // raised once per head dim
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<D>());
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const long blocks = (long)cdiv(sq, BQ) * hq;
  if (blocks == 0) return (int)cudaGetLastError();
  flash_mma_kernel<D><<<(unsigned)blocks, NT, smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, sq, skv,
      kv_group, q_offset, kv_len, scale);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* out, int hq,
           int sq, int skv, int d, int kv_group, int q_offset, int kv_len,
           float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_d<64>(q, k, v, out, hq, sq, skv, kv_group, q_offset,
                        kv_len, scale, st);
  if (d == 80)
    return launch_d<80>(q, k, v, out, hq, sq, skv, kv_group, q_offset,
                        kv_len, scale, st);
  if (d == 128)
    return launch_d<128>(q, k, v, out, hq, sq, skv, kv_group, q_offset,
                         kv_len, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v and out 16-byte aligned (the wrapper sees to it).
extern "C" int repro_flash_static_mma_bf16(const void* q, const void* k,
                                           const void* v, void* out, int hq,
                                           int sq, int skv, int d,
                                           int kv_group, int kv_len,
                                           float scale, void* stream) {
  return launch(q, k, v, out, hq, sq, skv, d, kv_group, 0, kv_len, scale,
                stream);
}

// The offset branch (K2): query row i at position q_offset + i.
extern "C" int repro_flash_offset_mma_bf16(const void* q, const void* k,
                                           const void* v, void* out, int hq,
                                           int sq, int skv, int d,
                                           int kv_group, int q_offset,
                                           int kv_len, float scale,
                                           void* stream) {
  return launch(q, k, v, out, hq, sq, skv, d, kv_group, q_offset, kv_len,
                scale, stream);
}
