// Flash attention, two entry points over one kernel:
//   offset (chunked prefill): query row i of a chunk sits at absolute
//     position q_offset + i and attends causally to the first kv_len cached
//     positions;
//   static (whole-prompt prefill): query row i sits at position i, kv_len
//     is fixed by the caller (the prompt length);
//   offset over codes (chunked prefill from quantized pools, K9c): K/V
//     are int8 or fp8-e4m3 codes with one float32 scale per position
//     [Hkv_, Skv] (each position carries its page's scale).
//   q [Hq_, Sq, D], k/v [Hkv_, Skv, D], query head h reads KV head
//   h / kv_group -> out [Hq_, Sq, D].
// Only what the main paths run is built here: causal, no sliding window,
// D in {64, 128} and, for the static branch only, 80 (zamba2's shared
// block); the wrapper refuses the rest on the card.  Each lane holds
// output dims lane + 32 i; at D = 80 the last of its three is live on
// lanes 0..15 only.
//
// Replaces the TPU kernels in src/repro/kernels/flash_attention.py:
// _flash_kernel_offset (the offset branch of flash_attention_2d,
// pallas_call at :300) and _flash_kernel (its static branch, pallas_call
// at :309), and _flash_kernel_offset_q (the offset branch with k_scale /
// v_scale, pallas_call at :300).  The static kernel's arithmetic is the
// offset kernel's at q_offset = 0, so all entry points launch the same
// device function, templated on the K/V code type C.
// There q_offset and kv_len ride in as scalar-prefetch operands; here they
// are plain kernel arguments, and no S is assumed to divide a tile.  Each block holds 16 query rows of one head (4 per warp) and
// walks only the KV tiles that can be live: below kv_len and at or before
// the block's last query position.  Per 32-key tile it
// runs the reference's online softmax: QK products of the input dtype
// summed in float32, then scaled; masked scores at -1e30; p rounded to the
// v dtype before PV; the normaliser clamped at 1e-30.  Over codes, K/V are
// dequantized on load (`float(code) * scale[pos]`, before the dot) and p
// stays float32, as in the reference's quantized body.  The caller gathers
// the live pages into dense K/V first (models/model.py), as the reference
// does.
// What bounds it: the QK and PV arithmetic (O(Sq * kv_len * D) per head),
// done here on the CUDA cores; K/V are re-read from L2 by each q block.
#include <type_traits>

#include "common.cuh"

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
                    float scale) {
  constexpr bool QUANT = !std::is_same<T, C>::value;
  constexpr int DPL = (D + 31) / 32;   // output dims per lane
  constexpr bool FULL = D % 32 == 0;   // every lane's every dim is live
  __shared__ float q_s[BQ][D];
  __shared__ float k_s[BKV][D + 1];
  __shared__ float v_s[BKV][D];

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

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
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
      const bool valid = kp < kv_len && kp < skv && q0 + r < sq && kp <= qpos;
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
void launch_d(const void* q, const void* k, const void* v, const float* ks,
              const float* vs, void* out, int hq, int sq, int skv,
              int kv_group, int q_offset, int kv_len, float scale,
              cudaStream_t stream) {
  dim3 grid(cdiv(sq, BQ), hq);
  flash_offset_kernel<T, C, D><<<grid, NWARP * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), ks, vs, static_cast<T*>(out), sq, skv,
      kv_group, q_offset, kv_len, scale);
}

template <typename T, typename C = T>
int launch(const void* q, const void* k, const void* v, void* out, int hq,
           int sq, int skv, int d, int kv_group, int q_offset, int kv_len,
           float scale, void* stream, const void* ks = nullptr,
           const void* vs = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(ks);
  const float* vf = static_cast<const float*>(vs);
  if (d == 64)
    launch_d<T, C, 64>(q, k, v, kf, vf, out, hq, sq, skv, kv_group, q_offset,
                       kv_len, scale, st);
  else if (d == 80)
    launch_d<T, C, 80>(q, k, v, kf, vf, out, hq, sq, skv, kv_group, q_offset,
                       kv_len, scale, st);
  else if (d == 128)
    launch_d<T, C, 128>(q, k, v, kf, vf, out, hq, sq, skv, kv_group,
                        q_offset, kv_len, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_offset_f32(const void* q, const void* k,
                                      const void* v, void* out, int hq,
                                      int sq, int skv, int d, int kv_group,
                                      int q_offset, int kv_len, float scale,
                                      void* stream) {
  return launch<float>(q, k, v, out, hq, sq, skv, d, kv_group, q_offset,
                       kv_len, scale, stream);
}

extern "C" int repro_flash_offset_bf16(const void* q, const void* k,
                                       const void* v, void* out, int hq,
                                       int sq, int skv, int d, int kv_group,
                                       int q_offset, int kv_len, float scale,
                                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, hq, sq, skv, d, kv_group,
                               q_offset, kv_len, scale, stream);
}

extern "C" int repro_flash_static_f32(const void* q, const void* k,
                                      const void* v, void* out, int hq,
                                      int sq, int skv, int d, int kv_group,
                                      int kv_len, float scale, void* stream) {
  return launch<float>(q, k, v, out, hq, sq, skv, d, kv_group, 0, kv_len,
                       scale, stream);
}

extern "C" int repro_flash_static_bf16(const void* q, const void* k,
                                       const void* v, void* out, int hq,
                                       int sq, int skv, int d, int kv_group,
                                       int kv_len, float scale,
                                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, hq, sq, skv, d, kv_group, 0,
                               kv_len, scale, stream);
}

// The offset branch over codes C with per-position scales [Hkv_, Skv].
#define REPRO_FLASH_OFFSET_Q(NAME, T, C)                                     \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* ks, const void* vs, void* out, int hq,     \
                      int sq, int skv, int d, int kv_group, int q_offset,    \
                      int kv_len, float scale, void* stream) {               \
    return launch<T, C>(q, k, v, out, hq, sq, skv, d, kv_group, q_offset,    \
                        kv_len, scale, stream, ks, vs);                      \
  }
REPRO_FLASH_OFFSET_Q(repro_flash_offset_q_f32_i8, float, int8_t)
REPRO_FLASH_OFFSET_Q(repro_flash_offset_q_bf16_i8, __nv_bfloat16, int8_t)
REPRO_FLASH_OFFSET_Q(repro_flash_offset_q_f32_fp8, float, __nv_fp8_e4m3)
REPRO_FLASH_OFFSET_Q(repro_flash_offset_q_bf16_fp8, __nv_bfloat16,
                     __nv_fp8_e4m3)
