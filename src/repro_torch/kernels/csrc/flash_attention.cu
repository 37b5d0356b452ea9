// Flash attention on the CUDA cores, one kernel behind these entry points:
//   offset in float32 (chunked prefill): query row i of a chunk sits at
//     absolute position q_offset + i and attends causally to the first
//     kv_len cached positions;
//   static in float32 (whole-prompt prefill, the training forward, the
//     encoder): query row i sits at position i, kv_len is fixed by the
//     caller (the prompt length); non-causal without a window (hubert's
//     encoder; `causal` 0 at the entry point): every key below kv_len,
//     launched with every query at position skv, past the last key;
//   offset over codes in float32 (chunked prefill from quantized pools,
//     K9c): K/V are int8 or fp8-e4m3 codes with one float32 scale per
//     position [Hkv_, Skv] (each position carries its page's scale).
// Every branch in bfloat16 runs on the tensor cores (flash_mma.cu).
//   q [Hq_, Sq, D], k/v [Hkv_, Skv, D], query head h reads KV head
//   h / kv_group -> out [Hq_, Sq, D].
// Only what the main paths run is built here: causal (the static branch
// also non-causal, as above), with or without a sliding window (window >
// 0: a key is live above the query's position - window, gemma3's local
// layers; none over codes or non-causal), D in {64, 128, 320}
// and, for the static branch only, 80 (zamba2's shared block); the wrapper
// refuses the rest on the card.  Each lane holds output dims lane + 32 i;
// at D = 80 the last of its three is live on lanes 0..15 only.  The tiles
// live in dynamic shared memory (100 KB at D = 320, over the 48 KB a
// static array may take).
//
// Replaces the TPU kernels in src/repro/kernels/flash_attention.py:
// _flash_kernel_offset (K2, the offset branch of flash_attention_2d,
// pallas_call at :300) and _flash_kernel (K7, its static branch,
// pallas_call at :309) and _flash_kernel_offset_q (K9c, the offset branch
// with k_scale / v_scale, pallas_call at :300) in float32.  The static
// kernel's arithmetic is the offset kernel's at q_offset = 0, so every
// entry point here launches the same device function, templated on the
// K/V code type C.  float32 stays on the CUDA
// cores: TF32 tensor-core products would break the float32 checks against
// the reference.
// There q_offset and kv_len ride in as scalar-prefetch operands; here they
// are plain kernel arguments, and no S is assumed to divide a tile.  Each
// block holds 16 query rows of one head (4 per warp) and walks only the
// KV tiles that can be live: below kv_len, at or before the block's last
// query position and, under a window, from the tile of the first key its
// first row sees (tiles counted from position 0, so a wholly masked tile
// left out changes nothing).  Per 32-key tile it runs the reference's online
// softmax: QK products of the input dtype summed in float32, then scaled;
// masked scores at -1e30; p rounded to the v dtype before PV; the
// normaliser clamped at 1e-30.  Over codes, K/V are dequantized on load
// (`float(code) * scale[pos]`, before the dot) and p stays float32, as in
// the reference's quantized body.  The caller gathers the live pages into
// dense K/V first (models/model.py), as the reference does.
// What bounds it: the QK and PV arithmetic (O(Sq * kv_len * D) per head),
// here float FMAs on the CUDA cores (67 TFLOP/s in float32); K/V are
// re-read from L2 by each 16-row q block.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int BQ = 16;    // query rows per block
constexpr int BKV = 32;   // keys per tile: one per lane
constexpr int NWARP = 4;
constexpr int RPW = BQ / NWARP;

template <typename T, typename C, int D>
__global__ void __launch_bounds__(NWARP * 32)
flash_offset_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, T* __restrict__ out,
                    int sq, int skv, int kv_group, int q_offset, int kv_len,
                    int window, float scale) {
  constexpr bool QUANT = !std::is_same<T, C>::value;
  constexpr int DPL = (D + 31) / 32;   // output dims per lane
  constexpr bool FULL = D % 32 == 0;   // every lane's every dim is live
  extern __shared__ __align__(16) float smem_f[];
  float(*q_s)[D] = reinterpret_cast<float(*)[D]>(smem_f);        // [BQ][D]
  float(*k_s)[D + 1] =
      reinterpret_cast<float(*)[D + 1]>(smem_f + BQ * D);    // [BKV][D + 1]
  float(*v_s)[D] = reinterpret_cast<float(*)[D]>(smem_f + BQ * D +
                                                 BKV * (D + 1));  // [BKV][D]

  const int h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / kv_group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qh = q + (size_t)h * sq * D;
  const C* kh = k + (size_t)hk * skv * D;
  const C* vh = v + (size_t)hk * skv * D;

  for (int i = tid; i < BQ * D; i += NWARP * 32) {
    const int r = i / D, c = i % D;
    q_s[r][c] = (q0 + r < sq) ? to_f(qh[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  // Live KV range of this block (tiles outside it are wholly masked).
  const int q_last = q_offset + min(q0 + BQ, sq) - 1;
  const int kv_end = min(min(kv_len, skv), q_last + 1);
  const int k_first =
      window > 0 ? max(q_offset + q0 - window + 1, 0) / BKV * BKV : 0;

  for (int k0 = k_first; k0 < kv_end; k0 += BKV) {
    __syncthreads();   // q_s written / previous tile consumed
    for (int i = tid; i < BKV * D; i += NWARP * 32) {
      const int r = i / D, c = i % D, kp = k0 + r;
      const bool ok = kp < skv;
      float kv = ok ? to_f(kh[(size_t)kp * D + c]) : 0.f;
      float vv = ok ? to_f(vh[(size_t)kp * D + c]) : 0.f;
      if constexpr (QUANT) {
        if (ok) {
          kv *= kscale[(size_t)hk * skv + kp];
          vv *= vscale[(size_t)hk * skv + kp];
        }
      }
      k_s[r][c] = kv;
      v_s[r][c] = vv;
    }
    __syncthreads();
    const int kp = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int qpos = q_offset + q0 + r;
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(q_s[r][c], k_s[lane][c], s);
      s *= scale;
      const bool valid = kp < kv_len && kp < skv && q0 + r < sq &&
                         kp <= qpos && (window <= 0 || kp > qpos - window);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
      const float pr = QUANT ? p : round_to<T>(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (FULL || lane + 32 * i < D)
            acc[rr][i] = fmaf(pj, v_s[j][lane + 32 * i], acc[rr][i]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    if (q0 + r >= sq) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* o = out + ((size_t)h * sq + q0 + r) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (FULL || lane + 32 * i < D)
        o[lane + 32 * i] = from_f<T>(acc[rr][i] / denom);
  }
}

template <typename T, typename C, int D>
int launch_d(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, void* out, int hq, int sq, int skv,
             int kv_group, int q_offset, int kv_len, int window, float scale,
             cudaStream_t stream) {
  static size_t smem_set = 0;   // raised once per instance
  constexpr size_t smem = sizeof(float) * (BQ * D + BKV * (D + 1) + BKV * D);
  const cudaError_t err =
      raise_smem(flash_offset_kernel<T, C, D>, smem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(sq, BQ), hq);
  flash_offset_kernel<T, C, D><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), ks, vs, static_cast<T*>(out), sq, skv,
      kv_group, q_offset, kv_len, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename C = T>
int launch(const void* q, const void* k, const void* v, void* out, int hq,
           int sq, int skv, int d, int kv_group, int q_offset, int kv_len,
           int window, float scale, void* stream, const void* ks = nullptr,
           const void* vs = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(ks);
  const float* vf = static_cast<const float*>(vs);
  if (window < 0) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_d<T, C, 64>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                              q_offset, kv_len, window, scale, st);
  if (d == 80)
    return launch_d<T, C, 80>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                              q_offset, kv_len, window, scale, st);
  if (d == 128)
    return launch_d<T, C, 128>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                               q_offset, kv_len, window, scale, st);
  if constexpr (std::is_same<T, C>::value) {   // gemma3, full precision
    if (d == 320)
      return launch_d<T, C, 320>(q, k, v, kf, vf, out, hq, sq, skv,
                                 kv_group, q_offset, kv_len, window, scale,
                                 st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// window 0 for none.
extern "C" int repro_flash_offset_f32(const void* q, const void* k,
                                      const void* v, void* out, int hq,
                                      int sq, int skv, int d, int kv_group,
                                      int q_offset, int kv_len, int window,
                                      float scale, void* stream) {
  return launch<float>(q, k, v, out, hq, sq, skv, d, kv_group, q_offset,
                       kv_len, window, scale, stream);
}

// causal 0: non-causal, without a window (every query at position skv
// sees every key below kv_len).
extern "C" int repro_flash_static_f32(const void* q, const void* k,
                                      const void* v, void* out, int hq,
                                      int sq, int skv, int d, int kv_group,
                                      int kv_len, int window, int causal,
                                      float scale, void* stream) {
  if (!causal && window) return (int)cudaErrorInvalidValue;
  return launch<float>(q, k, v, out, hq, sq, skv, d, kv_group,
                       causal ? 0 : skv, kv_len, window, scale, stream);
}

// The offset branch over codes C with per-position scales [Hkv_, Skv].
#define REPRO_FLASH_OFFSET_Q(NAME, T, C)                                     \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* ks, const void* vs, void* out, int hq,     \
                      int sq, int skv, int d, int kv_group, int q_offset,    \
                      int kv_len, float scale, void* stream) {               \
    return launch<T, C>(q, k, v, out, hq, sq, skv, d, kv_group, q_offset,    \
                        kv_len, 0, scale, stream, ks, vs);                   \
  }
REPRO_FLASH_OFFSET_Q(repro_flash_offset_q_f32_i8, float, int8_t)
REPRO_FLASH_OFFSET_Q(repro_flash_offset_q_f32_fp8, float, __nv_fp8_e4m3)
