// rwkv6_wkv (K14): the RWKV6 (Finch) wkv recurrence.
//   r, k, v [B, S, H, N] in T; w [B, S, H, N] float32, the per-step decay;
//   u [H, N] float32, the bonus -> y [B, S, H, N] in T, the final state
//   [B, H, N, N] float32 (keys x values), the state starting at zero.
// Per (batch, head), token after token, with kv = k_t^T v_t:
//   y_t = r_t (S + u^T o kv),   S <- S o w_t^T + kv.
// y is rounded to T once.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py::_wkv_kernel
// (wkv6_pallas, pallas_call at :78).  There the grid is (batch x heads,
// S / chunk), the chunk axis sequential, and each head's [N, N] state
// rides in VMEM scratch from one grid step to the next.  Hopper blocks run
// in no order, so nothing is carried between blocks.  The reference's
// `chunk` only cuts its grid: neither kernel here takes it.  The
// reference rejects the factored chunk form because it divides by
// cumulative decays (rwkv6_wkv.py:9-13); nothing here divides: every
// decay factor is a product of w's, each <= 1, taken one factor at a time.
//
// float32 (wkv6_kernel): column j of the state (value index j) depends
// only on v_t[j] and the vectors r_t, k_t, w_t, u, so a block owns CB = 16
// columns of one head's state and walks every token in order; KS = 4
// neighbouring threads share a column, each holding N / KS of its rows in
// registers, and y_t[j] is their sum over two warp shuffles.  The block
// stages TT tokens of r, k, w and v in shared memory at a time.  It is
// latency-bound on the per-token chain (0.43 us a token at N = 64 against
// 7 N^2 float32 operations per token and head); the CPU parity and the
// float32 token equalities need its full float32 products.
//
// bf16 (the wkv_seg_* kernels): a sequence-split scan on the tensor cores.
// The one-token-at-a-time walk took 0.44 ms at S = 1000, batch 1, 64 heads
// of 64, against a 0.027 ms float32-operations bound: 256 blocks of 2
// warps stepping through the sequence.  Here the sequence is cut into
// segments of SEG = 64 tokens counted from position 0 at every S
// (kernels/common.py::wkv_plan), each walked in sub-blocks of SUB = 16
// tokens; the last segment masks tokens at or past S (no load, no store,
// r = k = v = 0 and w = 1), so no input is padded.  With P(a, c) = w_a
// ... w_c (1 when empty) and b a sub-block's first token, one walk does
//   S <- P(b, b+15) o S + (k_tau o P(tau+1, b+15))^T v_tau
// per sub-block, and the output walk also
//   y_t = (r_t o P(b, t-1)) S + sum_{b<=tau<t} A[t, tau] v_tau +
//         (sum_k r_t u k_t) v_t,   A[t, tau] = sum_k r_t k_tau P(tau+1, t-1).
// Three launches:
//   1. wkv_seg_state_kernel, per (segment, head, batch) for every segment
//      but the last: the walk from zero, the state update alone, into a
//      float32 workspace [B, H, nseg, N, N] (values x keys) with the
//      segment's decay D [B, H, nseg, N];
//   2. wkv_seg_carry_kernel, per (batch, head), in segment order and one
//      state element a thread (16 segments' loads in flight at once):
//      S_in(g+1) = D_g o S_in(g) + S_loc(g), S_in(0) = 0, S_in(1) =
//      S_loc(0), over S_loc (skipped with two segments);
//   3. wkv_seg_out_kernel, per (segment, head, batch): the output walk
//      from S_in(g); the last segment's block writes the final state.
//      When S fits in one segment this launch alone is the call.
// Both walks stage sub-block q + 2 with cp.async while q runs (a ring of
// three slots: 42 KB of shared memory at N = 64).
// Which product runs where: the decays (one thread per key walks the 16
// tokens, its values loaded first) and the 16 x 16 in-block scores A
// (exact running products: nothing to factor without dividing; past a
// warp's first tau every token runs in every lane, the lane's condition a
// select, so that the loads run ahead) in float32 on the CUDA cores; the
// three matrix products on mma.sync.m16n8k16, a float32 operand split
// into hi + lo bf16 planes (within about 2^-16 of the float32 product):
// the state update with v exact and k o P split (two MMAs); A v with v
// exact and A split (two); (r o P) S with both split (hi hi + hi lo + lo
// hi, three).  Each warp owns 16 value columns j of the state, kept
// transposed (S^T [j, k]) in its accumulators, which are the A operand of
// (r o P) S^T's product as they stand; y leaves the accumulators straight
// for global memory.  A fixed order and no atomics: a row's bits depend on
// the tokens before it alone, not on S, the chunk or the batch.
// What bounds it: bytes in principle (r, k, v and w read about twice, the
// workspace written, read and written again: about 140 MB at S = 1000,
// batch 1, 64 heads of 64, against the function's own 50 MB, 0.015 ms at
// 3.35 TB/s); in practice the output walk's issue rate: at S = 1000 the
// three launches took 22, 7 and 53 us of device time on an NVIDIA H100
// 80GB HBM3 at 700 W, the in-block scores about half of each sub-block.
#include "common.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int KS = 4;            // threads sharing one state column
constexpr int CB = 16;           // state columns per block
constexpr int NT = KS * CB;      // threads per block
constexpr int STAGE = 2048;      // floats staged per vector: TT * N

template <typename T, int N>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ sout, int s, int h) {
  constexpr int KP = N / KS;     // state rows per thread
  constexpr int TT = STAGE / N;  // tokens per staging pass
  __shared__ float rs[TT][N];
  __shared__ float ks[TT][N];
  __shared__ float ws[TT][N];
  __shared__ float vs[TT][CB];

  const int tid = threadIdx.x;
  const int kq = tid % KS, jl = tid / KS;
  const int col0 = blockIdx.x * CB, head = blockIdx.y, bi = blockIdx.z;
  const size_t row = (size_t)h * N;                 // elements per token
  const size_t base = (size_t)bi * s * row + (size_t)head * N;

  float st[KP], uu[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    st[i] = 0.f;
    uu[i] = u[head * N + kq + KS * i];
  }

  for (int t0 = 0; t0 < s; t0 += TT) {
    const int nt = min(TT, s - t0);
    __syncthreads();                  // the previous tokens are consumed
    for (int i = tid; i < nt * N; i += NT) {
      const int tt = i / N, c = i % N;
      const size_t off = base + (size_t)(t0 + tt) * row + c;
      rs[tt][c] = to_f(r[off]);
      ks[tt][c] = to_f(k[off]);
      ws[tt][c] = w[off];
    }
    for (int i = tid; i < nt * CB; i += NT) {
      const int tt = i / CB, c = i % CB;
      vs[tt][c] = to_f(v[base + (size_t)(t0 + tt) * row + col0 + c]);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][jl];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const int kk = kq + KS * i;
        const float kv = ks[tt][kk] * vj;
        acc = fmaf(rs[tt][kk], fmaf(uu[i], kv, st[i]), acc);
        st[i] = fmaf(st[i], ws[tt][kk], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (kq == 0)
        y[base + (size_t)(t0 + tt) * row + col0 + jl] = from_f<T>(acc);
    }
  }
  float* so = sout + ((size_t)bi * h + head) * N * N;
#pragma unroll
  for (int i = 0; i < KP; ++i) so[(kq + KS * i) * N + col0 + jl] = st[i];
}

template <typename T, int N>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, void* sout, int bsz, int s, int h,
             void* stream) {
  wkv6_kernel<T, N><<<dim3(N / CB, h, bsz), NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(sout), s, h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* sout, int bsz, int s, int h, int n,
           void* stream) {
  if (bsz < 1 || s < 1 || h < 1) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 16: return launch_n<T, 16>(r, k, v, w, u, y, sout, bsz, s, h, stream);
    case 32: return launch_n<T, 32>(r, k, v, w, u, y, sout, bsz, s, h, stream);
    case 64: return launch_n<T, 64>(r, k, v, w, u, y, sout, bsz, s, h, stream);
    case 128:
      return launch_n<T, 128>(r, k, v, w, u, y, sout, bsz, s, h, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------
// bf16: the sequence-split scan on the tensor cores (wkv_seg_*).
// ---------------------------------------------------------------------

constexpr int SEG = 64;   // tokens per segment (kernels/common.py WKV_SEG)
constexpr int SUB = 16;   // tokens per sub-block (WKV_SUB)
constexpr int NSUB = SEG / SUB;
constexpr int RING = 3;   // sub-block slots of the cp.async ring
constexpr int LA = SUB + 8;   // row of the score planes

template <int N> __host__ __device__ constexpr int ldv() { return N + 8; }

// x as hi + lo bf16 planes, one element each.
__device__ __forceinline__ void split_store(bf16* hi, bf16* lo, float x) {
  const bf16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}

// One slot of the ring (byte offsets): SUB tokens of r (the output walk
// only), k, v (rows of ldv elements, for ldmatrix) and w.
template <int N, bool OUT> struct Slot {
  static constexpr size_t R = 0;
  static constexpr size_t K = OUT ? (size_t)SUB * N * 2 : 0;
  static constexpr size_t V = K + (size_t)SUB * N * 2;
  static constexpr size_t W = V + (size_t)SUB * ldv<N>() * 2;
  static constexpr size_t BYTES = W + (size_t)SUB * N * 4;
};

// A walk's shared memory (bytes): the ring; the hi + lo planes of k o P
// and, for the outputs, of r o P and of the scores; u and the sub-block's
// decay.
template <int N, bool OUT> constexpr size_t walk_smem() {
  return RING * Slot<N, OUT>::BYTES +
         (OUT ? 4 : 2) * (size_t)SUB * ldv<N>() * 2 +
         (OUT ? 2 * (size_t)SUB * LA * 2 : 0) + 2 * (size_t)N * 4;
}

// Rows [r0, r0 + SUB) of a segment's tile of W elements per row, `stride`
// elements apart in global memory, into shared rows 0..SUB-1 of LDS
// elements; rows at or past `rows` zero-filled (not read).
template <int W, int LDS, int NT, typename E>
__device__ __forceinline__ void stage_rows(E* sm, const E* g, size_t stride,
                                           int r0, int rows, int tid) {
  constexpr int EPC = 16 / (int)sizeof(E);   // elements per 16 bytes
  constexpr int CPR = W / EPC;               // 16-byte chunks per row
  for (int i = tid; i < SUB * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    const bool ok = r0 + r < rows;
    cp_async16(sm + r * LDS + c, g + (size_t)(ok ? r0 + r : 0) * stride + c,
               ok);
  }
}

// Sub-block q of the segment into its ring slot, as one cp.async group
// (an empty one past the segment).
template <int N, bool OUT>
__device__ __forceinline__ void stage(unsigned char* ring, const bf16* r,
                                      const bf16* k, const bf16* v,
                                      const float* w, size_t stride, int q,
                                      int rows, int tid) {
  using L = Slot<N, OUT>;
  constexpr int NT = 2 * N;
  if (q < NSUB) {
    unsigned char* sl = ring + (q % RING) * L::BYTES;
    if constexpr (OUT)
      stage_rows<N, N, NT>(reinterpret_cast<bf16*>(sl + L::R), r, stride,
                           q * SUB, rows, tid);
    stage_rows<N, N, NT>(reinterpret_cast<bf16*>(sl + L::K), k, stride,
                         q * SUB, rows, tid);
    stage_rows<N, ldv<N>(), NT>(reinterpret_cast<bf16*>(sl + L::V), v,
                                stride, q * SUB, rows, tid);
    stage_rows<N, N, NT>(reinterpret_cast<float*>(sl + L::W), w, stride,
                         q * SUB, rows, tid);
  }
  cp_async_commit();
}

// The walk over one segment in sub-blocks of SUB tokens from b, the state
// S^T [value j][key] of the warp's 16 value rows in the accumulators of
// m16n8 tiles over the keys:
//   OUT:  from S_in(seg) (zero for the first segment), y_t = (r_t o
//         P(b, t-1)) S + sum_{b<=tau<t} A[t, tau] v_tau + (r_t u k_t)
//         v_t, then S <- P(b, b+15) o S + (k o P(tau+1, b+15))^T v; the
//         last segment's block writes the final state;
//   !OUT: from zero, the state update alone: the segment's own end state
//         S_loc and its decay D into the workspace.
// Sub-block q + 2 is loaded while q runs (a ring of RING slots).
template <int N, bool OUT>
__device__ __forceinline__ void seg_walk(
    const bf16* __restrict__ r, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ w,
    const void* __restrict__ u, int u_bf16, bf16* __restrict__ y,
    float* __restrict__ sout, float* __restrict__ ws,
    float* __restrict__ dec, int s, int h, int nseg) {
  constexpr int NT = 2 * N, LV = ldv<N>();
  constexpr int KG = N / 8;   // lanes sharing one tau in the scores
  using L = Slot<N, OUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  bf16* planes = reinterpret_cast<bf16*>(smem + RING * L::BYTES);
  bf16* kqh = planes;                  // k o P(tau+1, b+15) hi, lo
  bf16* kql = kqh + SUB * LV;
  bf16* rph = kql + SUB * LV;          // r o P(b, t-1) hi, lo (OUT)
  bf16* rpl = rph + SUB * LV;
  bf16* ah = planes + (OUT ? 4 : 2) * SUB * LV;   // A [t][tau] (OUT)
  bf16* al = ah + SUB * LA;
  float* uu = reinterpret_cast<float*>(ah + (OUT ? 2 * SUB * LA : 0));
  float* ptot = uu + N;                // the sub-block's decay, per key
  const int seg = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = min(SEG, s - seg * SEG);
  const size_t base = (((size_t)bi * s + (size_t)seg * SEG) * h + head) * N;
  const size_t stride = (size_t)h * N;
  const size_t bhs = (size_t)bi * h + head;
  const bf16* rg = OUT ? r + base : nullptr;
  stage<N, OUT>(ring, rg, k + base, v + base, w + base, stride, 0, rows, tid);
  stage<N, OUT>(ring, rg, k + base, v + base, w + base, stride, 1, rows, tid);
  if (OUT && tid < N)
    uu[tid] = u_bf16 ? __bfloat162float(
                           static_cast<const bf16*>(u)[head * N + tid])
                     : static_cast<const float*>(u)[head * N + tid];
  float st[N / 8][4];
  if (!OUT || seg == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
  } else {
    const float* sin = ws + (bhs * nseg + seg) * N * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 x = *reinterpret_cast<const float2*>(
            sin + (wp * 16 + g + rr * 8) * N + j * 8 + 2 * t4);
        st[j][2 * rr] = x.x;
        st[j][2 * rr + 1] = x.y;
      }
  }
  float dk = 1.f;   // !OUT: the segment's decay of key tid - N
#pragma unroll 1
  for (int q = 0; q < NSUB; ++q) {
    const int b0 = q * SUB;
    if (b0 >= rows) break;
    cp_async_wait<1>();   // sub-block q landed (q + 1 may be in flight)
    __syncthreads();      // ... for every thread; q - 1 is consumed
    stage<N, OUT>(ring, rg, k + base, v + base, w + base, stride, q + 2,
                  rows, tid);
    const unsigned char* sl = ring + (q % RING) * L::BYTES;
    const bf16* rs = reinterpret_cast<const bf16*>(sl + L::R);
    const bf16* ks = reinterpret_cast<const bf16*>(sl + L::K);
    const bf16* vs = reinterpret_cast<const bf16*>(sl + L::V);
    const float* wsm = reinterpret_cast<const float*>(sl + L::W);
    // Decays, the sub-block's values loaded first: thread N + c the suffix
    // P(t+1, b+15) of key c (into k o P; its end, in the state pass, the
    // sub-block's decay), thread c < N the prefix P(b, t-1) (into r o P
    // and the sub-block's decay).  Tokens at or past S decay by 1.
    if (tid >= N) {
      const int c = tid - N;
      float xv[SUB], wv[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        xv[t] = __bfloat162float(ks[t * N + c]);
        wv[t] = b0 + t < rows ? wsm[t * N + c] : 1.f;
      }
      float qd = 1.f;
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {
        split_store(kqh + t * LV + c, kql + t * LV + c, xv[t] * qd);
        qd *= wv[t];
      }
      if constexpr (!OUT) {
        ptot[c] = qd;
        dk *= qd;
      }
    } else if constexpr (OUT) {
      float xv[SUB], wv[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        xv[t] = __bfloat162float(rs[t * N + tid]);
        wv[t] = b0 + t < rows ? wsm[t * N + tid] : 1.f;
      }
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        split_store(rph + t * LV + tid, rpl + t * LV + tid, xv[t] * p);
        p *= wv[t];
      }
      ptot[tid] = p;
    }
    if constexpr (OUT) {
      // The in-block scores A[t, tau] (t > tau) and the bonus A[t, t]:
      // KG lanes per tau, 8 neighbouring keys each (one 16-byte load of r,
      // two of w per token).  Each key's running value k_tau P(tau+1, t-1)
      // starts at k_tau and takes w_t once t passes tau.  A warp skips the
      // tokens at or before its first tau (tau_w); past it every token runs
      // in every lane, the lane's condition a select and not a branch, so
      // that the loads of later tokens need not wait.  The lanes' sums are
      // added in a fixed tree.
      const int tau = tid / KG, kg = tid % KG;
      const int tau_w = wp * 32 / KG;
      const int c0 = kg * 8;
      float qk[8];
      float diag = 0.f;
      {
        const uint4 kr = *reinterpret_cast<const uint4*>(ks + tau * N + c0);
        const uint4 rr = *reinterpret_cast<const uint4*>(rs + tau * N + c0);
        const bf16* ke = reinterpret_cast<const bf16*>(&kr);
        const bf16* re = reinterpret_cast<const bf16*>(&rr);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          qk[i] = __bfloat162float(ke[i]);
          diag = fmaf(__bfloat162float(re[i]) * uu[c0 + i], qk[i], diag);
        }
      }
      float acc[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) acc[t] = 0.f;
#pragma unroll
      for (int t = 1; t < SUB; ++t) {
        if (t <= tau_w) continue;   // every lane's score is 0 here
        const uint4 rv = *reinterpret_cast<const uint4*>(rs + t * N + c0);
        const float4 w0 =
            *reinterpret_cast<const float4*>(wsm + t * N + c0);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wsm + t * N + c0 + 4);
        const bf16* re = reinterpret_cast<const bf16*>(&rv);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                             w1.x, w1.y, w1.z, w1.w};
        const bool on = t > tau;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a = fmaf(__bfloat162float(re[i]), qk[i], a);
          qk[i] = on ? qk[i] * wv[i] : qk[i];
        }
        acc[t] = on ? a : 0.f;
      }
#pragma unroll
      for (int o = KG / 2; o > 0; o >>= 1) {
        diag += __shfl_xor_sync(0xffffffffu, diag, o);
#pragma unroll
        for (int t = 1; t < SUB; ++t)
          acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
      }
      if (kg == 0) {
#pragma unroll
        for (int t = 0; t < SUB; ++t)
          split_store(ah + t * LA + tau, al + t * LA + tau,
                      t > tau ? acc[t] : (t == tau ? diag : 0.f));
      }
    }
    __syncthreads();
    uint32_t vf[4];   // v^T of the sub-block: K = its tokens
    ldsm_x4_trans(vf, vs + ((lane & 7) + ((lane >> 4) & 1) * 8) * LV +
                          wp * 16 + ((lane >> 3) & 1) * 8);
    if constexpr (OUT) {
      // y^T [j][t] = S^T (r o P)^T + v^T A^T, stored as it stands.
      float ya[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[nt][e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < N / 16; ++kb) {
        uint32_t sh[4], sl2[4];   // S^T's accumulators as hi + lo A planes
        pack_bf16_split(st[2 * kb][0], st[2 * kb][1], sh[0], sl2[0]);
        pack_bf16_split(st[2 * kb][2], st[2 * kb][3], sh[1], sl2[1]);
        pack_bf16_split(st[2 * kb + 1][0], st[2 * kb + 1][1], sh[2], sl2[2]);
        pack_bf16_split(st[2 * kb + 1][2], st[2 * kb + 1][3], sh[3], sl2[3]);
        const int off = ((lane & 7) + ((lane >> 4) & 1) * 8) * LV + kb * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, rph + off);
        ldsm_x4(bl, rpl + off);
        mma_bf16(ya[0], sh, bh[0], bh[1]);
        mma_bf16(ya[1], sh, bh[2], bh[3]);
        mma_bf16(ya[0], sh, bl[0], bl[1]);
        mma_bf16(ya[1], sh, bl[2], bl[3]);
        mma_bf16(ya[0], sl2, bh[0], bh[1]);
        mma_bf16(ya[1], sl2, bh[2], bh[3]);
      }
      {
        const int off = ((lane & 7) + ((lane >> 4) & 1) * 8) * LA +
                        ((lane >> 3) & 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, ah + off);
        ldsm_x4(bl, al + off);
        mma_bf16(ya[0], vf, bh[0], bh[1]);
        mma_bf16(ya[1], vf, bh[2], bh[3]);
        mma_bf16(ya[0], vf, bl[0], bl[1]);
        mma_bf16(ya[1], vf, bl[2], bl[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = nt * 8 + 2 * t4 + (e & 1);
          if (b0 + t < rows)
            y[base + (size_t)(b0 + t) * stride + wp * 16 + g +
              (e >> 1) * 8] = __float2bfloat16(ya[nt][e]);
        }
    }
    // S^T <- S^T o P(b, b+15) + v^T (k o P(tau+1, b+15)).
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 pd =
          *reinterpret_cast<const float2*>(ptot + j * 8 + 2 * t4);
      st[j][0] *= pd.x;
      st[j][1] *= pd.y;
      st[j][2] *= pd.x;
      st[j][3] *= pd.y;
    }
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      const int off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LV + np * 16 +
                      ((lane >> 4) & 1) * 8;
      uint32_t bh[4], bl[4];
      ldsm_x4_trans(bh, kqh + off);
      ldsm_x4_trans(bl, kql + off);
      mma_bf16(st[2 * np], vf, bh[0], bh[1]);
      mma_bf16(st[2 * np + 1], vf, bh[2], bh[3]);
      mma_bf16(st[2 * np], vf, bl[0], bl[1]);
      mma_bf16(st[2 * np + 1], vf, bl[2], bl[3]);
    }
  }
  cp_async_wait<0>();
  if constexpr (OUT) {
    if (seg == nseg - 1) {
      float* so = sout + bhs * N * N;   // [key][value]
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          so[(j * 8 + 2 * t4 + (e & 1)) * N + wp * 16 + g + (e >> 1) * 8] =
              st[j][e];
    }
  } else {
    const size_t slot = bhs * nseg + seg;
    float* out = ws + (slot + 1) * N * N;   // S_loc(seg) in slot seg + 1
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(out + (wp * 16 + g + rr * 8) * N +
                                   j * 8 + 2 * t4) =
            make_float2(st[j][2 * rr], st[j][2 * rr + 1]);
    if (tid >= N) dec[slot * N + tid - N] = dk;
  }
}

// 1. Every segment but the last: its own end state S_loc^T [N values, N
//    keys] from zero and its decay D, into the workspace.
template <int N>
__global__ void __launch_bounds__(2 * N)
wkv_seg_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const float* __restrict__ w, float* __restrict__ ws,
                     float* __restrict__ dec, int s, int h, int nseg) {
  seg_walk<N, false>(nullptr, k, v, w, nullptr, 0, nullptr, nullptr, ws,
                     dec, s, h, nseg);
}

// 2. Per (batch, head), in segment order, over the workspace where the
//    state pass left S_loc(g) in slot g + 1: S_in(1) = S_loc(0) as it
//    stands, then S_in(g + 1) = D_g o S_in(g) + S_loc(g) written over slot
//    g + 1 (slot 0 is never written: the first segment starts from zero;
//    with two segments this launch is skipped).  One element a thread, so
//    that every thread has CB segments' loads in flight.
template <int N>
__global__ void __launch_bounds__(256)
wkv_seg_carry_kernel(float* __restrict__ ws, const float* __restrict__ dec,
                     int nseg) {
  constexpr int NN = N * N, CB = 16;
  const size_t bh = blockIdx.y;
  const int e = blockIdx.x * 256 + threadIdx.x;   // j * N + key
  float* st = ws + bh * nseg * NN + e;
  const float* d = dec + bh * nseg * N + e % N;
  float hc = st[NN];
  for (int g0 = 1; g0 < nseg - 1; g0 += CB) {
    float sl[CB], dd[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u)
      if (g0 + u < nseg - 1) {
        sl[u] = st[(size_t)(g0 + u + 1) * NN];
        dd[u] = d[(size_t)(g0 + u) * N];
      }
#pragma unroll
    for (int u = 0; u < CB; ++u)
      if (g0 + u < nseg - 1) {
        hc = fmaf(hc, dd[u], sl[u]);
        st[(size_t)(g0 + u + 1) * NN] = hc;
      }
  }
}

// 3. Each segment's outputs from S_in; the last writes the final state.
template <int N>
__global__ void __launch_bounds__(2 * N)
wkv_seg_out_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ w,
                   const void* __restrict__ u, int u_bf16,
                   bf16* __restrict__ y, float* __restrict__ sout,
                   float* __restrict__ ws, int s, int h, int nseg) {
  seg_walk<N, true>(r, k, v, w, u, u_bf16, y, sout, ws, nullptr, s, h,
                    nseg);
}

template <int N>
int launch_seg(const void* r, const void* k, const void* v, const void* w,
               const void* u, int u_bf16, void* y, void* sout, void* ws,
               int bsz, int s, int h, int nseg, cudaStream_t st) {
  static size_t set_state = 0, set_out = 0;
  const bf16* rb = static_cast<const bf16*>(r);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const float* wf = static_cast<const float*>(w);
  float* wsf = static_cast<float*>(ws);
  float* dec = wsf + (size_t)bsz * h * nseg * N * N;
  constexpr size_t smem_state = walk_smem<N, false>();
  constexpr size_t smem_out = walk_smem<N, true>();
  cudaError_t err;
  if (nseg > 1) {
    err = raise_smem(wkv_seg_state_kernel<N>, smem_state, &set_state);
    if (err != cudaSuccess) return (int)err;
    wkv_seg_state_kernel<N><<<dim3(nseg - 1, h, bsz), 2 * N, smem_state,
                              st>>>(kb, vb, wf, wsf, dec, s, h, nseg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (nseg > 2) {
      wkv_seg_carry_kernel<N><<<dim3(N * N / 256, bsz * h), 256, 0, st>>>(
          wsf, dec, nseg);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  err = raise_smem(wkv_seg_out_kernel<N>, smem_out, &set_out);
  if (err != cudaSuccess) return (int)err;
  wkv_seg_out_kernel<N><<<dim3(nseg, h, bsz), 2 * N, smem_out, st>>>(
      rb, kb, vb, wf, u, u_bf16, static_cast<bf16*>(y),
      static_cast<float*>(sout), wsf, s, h, nseg);
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_WKV6_ENTRY(SUFFIX, T)                                          \
  extern "C" int repro_wkv6_##SUFFIX(                                        \
      const void* r, const void* k, const void* v, const void* w,            \
      const void* u, void* y, void* sout, int bsz, int s, int h, int n,      \
      void* stream) {                                                        \
    return launch<T>(r, k, v, w, u, y, sout, bsz, s, h, n, stream);          \
  }

REPRO_WKV6_ENTRY(f32, float)

// bf16, the sequence-split scan: head sizes 16, 32, 64 and 128, segments
// of `seg` = SEG tokens, nseg = cdiv(s, seg) (kernels/common.py::
// wkv_plan); u [H, N] bf16 (u_bf16 = 1) or float32; `ws` the float32
// workspace, B H nseg (N N + N) values; r, k, v and w 16-byte aligned.
extern "C" int repro_wkv6_seg_bf16(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, int u_bf16, void* y,
                                   void* sout, void* ws, int bsz, int s,
                                   int h, int n, int seg, int nseg,
                                   void* stream) {
  if (bsz < 1 || s < 1 || h < 1 || seg != SEG || nseg != cdiv(s, SEG))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch_seg<16>(r, k, v, w, u, u_bf16, y, sout, ws, bsz, s, h,
                            nseg, st);
    case 32:
      return launch_seg<32>(r, k, v, w, u, u_bf16, y, sout, ws, bsz, s, h,
                            nseg, st);
    case 64:
      return launch_seg<64>(r, k, v, w, u, u_bf16, y, sout, ws, bsz, s, h,
                            nseg, st);
    case 128:
      return launch_seg<128>(r, k, v, w, u, u_bf16, y, sout, ws, bsz, s, h,
                             nseg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
