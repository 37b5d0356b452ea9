// Paged decode attention: one query token per slot attends to the slot's
// first `length` cached positions, read through its page-table row.
//   q [B, Hq, D]; pools [P, ps, Hkv, D]; table [B, maxp] int32 (always valid
//   page ids: unallocated entries point at the NULL page 0); lengths [B]
//   -> out [B, Hq, D].
// Only what the main paths run is built here: no sliding window, D in
// {64, 128} (gpt2, llama3); the wrapper refuses the rest on the card.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py::_paged_decode_kernel (pallas_call
// in paged_decode_attention at :441).  There the page table and lengths
// are scalar-prefetch operands feeding the BlockSpec index maps; here each
// block (slot b, KV head h) loads its own table row and length, and loops
// only over live positions (32 at a time, crossing page boundaries), so
// pages past the length are never read.  The G query heads sharing KV head
// h live in the same block (one warp each), so each K/V row is loaded into
// shared memory once for all of them (gpt2 has G = 1: one busy warp).  Numerics follow the reference:
// q * scale in float32 first, K/V in float32, float32 PV, online softmax
// with masked scores at -1e30 and the normaliser clamped at 1e-30; a slot
// of length 0 writes zeros.
// What bounds it: the K/V bytes of the live pages (memory bound).  With
// B * Hkv blocks (32 at 4 slots) most SMs stay idle; splitting a slot's
// pages across blocks (flash-decoding) is left to a later change.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int CH = 32;      // positions per step: one per lane
constexpr int NWARP = 4;
constexpr int MAXG = 8;     // query heads per KV head held in the block
constexpr int HPW = MAXG / NWARP;

template <typename T, int D>
__global__ void __launch_bounds__(NWARP * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hkv, int g, int ps, int maxp, float scale) {
  constexpr int DPL = D / 32;
  __shared__ float q_s[MAXG][D];
  __shared__ float k_s[CH][D + 1];
  __shared__ float v_s[CH][D];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;
  const int length = min(lengths[b], maxp * ps);
  const int* row = table + (size_t)b * maxp;

  for (int i = tid; i < g * D; i += NWARP * 32) {
    const int gi = i / D, c = i % D;
    q_s[gi][c] = to_f(q[((size_t)b * hq + h * g + gi) * D + c]) * scale;
  }

  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[hh][i] = 0.f;
  }

  for (int c0 = 0; c0 < length; c0 += CH) {
    __syncthreads();   // q_s written / previous step consumed
    for (int i = tid; i < CH * D; i += NWARP * 32) {
      const int r = i / D, c = i % D, pos = c0 + r;
      float kv = 0.f, vv = 0.f;
      if (pos < length) {
        const size_t page = (size_t)row[pos / ps];
        const size_t off = ((page * ps + pos % ps) * hkv + h) * D + c;
        kv = to_f(kpool[off]);
        vv = to_f(vpool[off]);
      }
      k_s[r][c] = kv;
      v_s[r][c] = vv;
    }
    __syncthreads();
    const int pos = c0 + lane;
    const bool valid = pos < length;
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int gi = warp + NWARP * hh;
      if (gi >= g) break;            // warp-uniform
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(q_s[gi][c], k_s[lane][c], s);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[hh], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[hh] - m_new);
      l[hh] = l[hh] * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[hh][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < CH; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[hh][i] = fmaf(pj, v_s[j][lane + 32 * i], acc[hh][i]);
      }
      m[hh] = m_new;
    }
  }

#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int gi = warp + NWARP * hh;
    if (gi >= g) break;
    const float denom = fmaxf(l[hh], 1e-30f);
    T* o = out + ((size_t)b * hq + h * g + gi) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = from_f<T>(acc[hh][i] / denom);
  }
}

template <typename T, int D>
void launch_d(const void* q, const void* kp, const void* vp,
              const void* table, const void* lengths, void* out, int b,
              int hkv, int g, int ps, int maxp, float scale,
              cudaStream_t stream) {
  dim3 grid(b, hkv);
  paged_decode_kernel<T, D><<<grid, NWARP * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), hkv, g, ps,
      maxp, scale);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lengths, void* out, int b, int hkv, int g, int d,
           int ps, int maxp, float scale, cudaStream_t stream) {
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  if (d == 64)
    launch_d<T, 64>(q, kp, vp, table, lengths, out, b, hkv, g, ps, maxp,
                    scale, stream);
  else if (d == 128)
    launch_d<T, 128>(q, kp, vp, table, lengths, out, b, hkv, g, ps, maxp,
                     scale, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_paged_decode_f32(const void* q, const void* kp,
                                      const void* vp, const void* table,
                                      const void* lengths, void* out, int b,
                                      int hkv, int g, int d, int ps,
                                      int maxp, float scale, void* stream) {
  return launch<float>(q, kp, vp, table, lengths, out, b, hkv, g, d, ps, maxp,
                       scale, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_paged_decode_bf16(const void* q, const void* kp,
                                       const void* vp, const void* table,
                                       const void* lengths, void* out, int b,
                                       int hkv, int g, int d, int ps,
                                       int maxp, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, table, lengths, out, b, hkv, g, d,
                               ps, maxp, scale,
                               static_cast<cudaStream_t>(stream));
}
