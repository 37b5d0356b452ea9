// mamba2_scan (K13): the Mamba2 chunked state-space-dual (SSD) scan.
//   x [B, S, H, P], dt [B, S, H], b / c [B, S, N] (one group, shared by
//   every head) in T; a [H] = -exp(a_log) and d [H] (the skip) float32
//   -> y [B, S, H, P] in T, the final state [B, H, P, N] float32.
// Per (batch, head), over blocks of rows in order, with the state h
// [P, N] starting at zero, cum the running sum of dt * a over the block
// and cum_L its last entry:
//   y  = ((C B^T) o L) (x dt) + exp(cum) o (C h^T) + x d,
//        L[i, j] = exp(cum_i - cum_j) for j <= i, 0 above the diagonal;
//   h <- h exp(cum_L) + ((x dt) exp(cum_L - cum))^T B.
// y is rounded to T once, at the end.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan.py::_ssd_kernel
// (mamba2_ssd_pallas, pallas_call at :104).  There the chunk axis is the
// sequential inner grid dimension and the state rides in VMEM scratch
// from one grid step to the next.  The reference's chunk is a blocking
// knob (its autotuner searches 64, 128 and 256, `TUNE_SPACE`): chunkings
// differ only by float rounding.  The reference wrapper repeats B and C
// for every head (`jnp.repeat`, :97-100); these kernels read them in
// place.  The exponent of L is taken only where j <= i: above the
// diagonal cum_i - cum_j is positive and could overflow (the reference
// masks after the exp).
//
// float32 (mamba2_ssd_kernel): one block per (batch, head) walks the
// caller's chunks of Q rows in order (any Q that divides S, 1 included)
// and keeps the state in shared memory the whole way, every product a
// float FMA out of shared memory (182 KB at Q = 128, P = N = 64, opted in
// above 48 KB with cudaFuncSetAttribute).  The CPU parity and the float32
// token equalities need its full float32 products.
//
// bf16 (the ssd_seg_* kernels): a sequence-split scan on the tensor
// cores.  The one-block walk took the latency of 80 blocks stepping
// through the sequence, not work: 6.19 ms at S = 999 (the model's chunk
// of 1 row for an odd length) against a 6.6 us bytes bound, 52 of the
// 132 SMs idle at batch 1.  Here the sequence is cut into segments of
// SEG = 64 rows counted from position 0 at every S and caller Q
// (kernels/common.py::ssd_plan); the last segment masks rows at or past S
// (no load, no store, dt taken as 0), so no input is padded.  Three
// launches:
//   1. ssd_seg_state_kernel, per (segment, head, batch): the segment's
//      cumsum of dt a by a warp scan (a row's value depends on the rows at
//      and before it alone), its own end state S_k = ((x dt) o
//      exp(cum_L - cum))^T B [P, N] and its decay exp(cum_L), into a
//      float32 workspace [B, H, nseg, P, N] and [B, H, nseg];
//   2. ssd_seg_carry_kernel, per (batch, head), in segment order and
//      parallel over the P N elements: h_k = h_{k-1} exp(cum_L,k-1) +
//      S_{k-1}, h_0 = 0, written over S_k (the state entering segment
//      k); the last is the final state;
//   3. ssd_seg_out_kernel, per (segment, head, batch): y = ((C B^T) o L)
//      (x dt) + exp(cum) o (C h_k^T) + x d, written once.
// Every product runs on mma.sync.m16n8k16 with one exact bf16 operand;
// the other, a float32 value, is split into hi + lo bf16 planes (two
// MMAs, within about 2^-16 of the float32 product): C B^T (both exact);
// ((C B^T) o L)(x dt) as G' x with G' = (C B^T) o L o dt_j split and x
// exact; C h^T with h split; (x dt dte)^T B as x^T (B o dt_j dte_j) with
// B' split.  A fixed order and no atomics on values: a row's bits depend
// on its segment's rows up to it and the segments before, not on S, Q or
// the batch.
// What bounds it: bytes at serving shapes (x twice and B, C in, y out,
// the workspace written, read and written again: about 110 MB at S =
// 1000, batch 1, with the workspace; the function's own bytes, 22 MB);
// the products (4.5 GFLOP at S = 1000 with both planes) are far below the
// tensor cores' rate.
#include "common.cuh"
#include "mma.cuh"

using namespace repro;

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
mamba2_ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ c, const float* __restrict__ dskip,
                  T* __restrict__ y, float* __restrict__ hout, int s, int h,
                  int p, int n, int q) {
  extern __shared__ float sm[];
  const int nb = n + 1;                 // padded row of B, C and the state
  float* xs = sm;                       // [q][p]  raw x
  float* bs = xs + q * p;               // [q][nb]
  float* cs = bs + q * nb;              // [q][nb]
  float* g = cs + q * nb;               // [q][q]  (C B^T) o L
  float* hs = g + q * q;                // [p][nb] the state
  float* dts = hs + p * nb;             // [q]     dt
  float* cum = dts + q;                 // [q]     running sum of dt * a
  float* dte = cum + q;                 // [q]     exp(cum_Q - cum)

  const int head = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const float ah = a[head], dh = dskip[head];
  const size_t row_x = (size_t)h * p;   // x / y elements per position
  for (int i = tid; i < p * nb; i += NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < s; c0 += q) {
    __syncthreads();                    // the previous chunk is consumed
    const size_t pos0 = (size_t)bi * s + c0;
    for (int i = tid; i < q; i += NT)
      dts[i] = to_f(dt[(pos0 + i) * h + head]);
    for (int i = tid; i < q * p; i += NT) {
      const int r = i / p, cc = i % p;
      xs[i] = to_f(x[(pos0 + r) * row_x + (size_t)head * p + cc]);
    }
    for (int i = tid; i < q * n; i += NT) {
      const int r = i / n, k = i % n;
      const size_t off = (pos0 + r) * n + k;
      bs[r * nb + k] = to_f(b[off]);
      cs[r * nb + k] = to_f(c[off]);
    }
    __syncthreads();
    if (tid == 0) {                     // cumsum of da, in row order
      float acc = 0.f;
      for (int i = 0; i < q; ++i) {
        acc += dts[i] * ah;
        cum[i] = acc;
      }
    }
    __syncthreads();
    const float total = cum[q - 1];
    for (int i = tid; i < q; i += NT) dte[i] = expf(total - cum[i]);
    // (C B^T) o L, the exponent only on and below the diagonal.
    for (int i = tid; i < q * q; i += NT) {
      const int r = i / q, j = i % q;
      float v = 0.f;
      if (j <= r) {
        float dot = 0.f;
        for (int k = 0; k < n; ++k)
          dot = fmaf(cs[r * nb + k], bs[j * nb + k], dot);
        v = dot * expf(cum[r] - cum[j]);
      }
      g[i] = v;
    }
    __syncthreads();
    // y = g (x dt) + exp(cum) (C h^T) + x d.
    for (int i = tid; i < q * p; i += NT) {
      const int r = i / p, cc = i % p;
      float acc = 0.f;
      for (int j = 0; j <= r; ++j)
        acc = fmaf(g[r * q + j], xs[j * p + cc] * dts[j], acc);
      float st = 0.f;
      for (int k = 0; k < n; ++k)
        st = fmaf(cs[r * nb + k], hs[cc * nb + k], st);
      acc += expf(cum[r]) * st;
      y[(pos0 + r) * row_x + (size_t)head * p + cc] =
          from_f<T>(acc + xs[i] * dh);
    }
    __syncthreads();                    // every reader of h is done
    // h = h exp(cum_Q) + ((x dt) exp(cum_Q - cum))^T B.
    const float et = expf(total);
    for (int i = tid; i < p * n; i += NT) {
      const int pp = i / n, k = i % n;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(xs[j * p + pp] * dts[j] * dte[j], bs[j * nb + k], acc);
      hs[pp * nb + k] = hs[pp * nb + k] * et + acc;
    }
  }
  __syncthreads();
  float* ho = hout + ((size_t)bi * h + head) * p * n;
  for (int i = tid; i < p * n; i += NT) ho[i] = hs[(i / n) * nb + i % n];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* d, void* y, void* hout, int bsz,
           int s, int h, int p, int n, int q, void* stream) {
  if (bsz < 1 || s < 1 || h < 1 || p < 1 || n < 1 || q < 1 || s % q)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)q * p + 2 * (size_t)q * (n + 1) +
                       (size_t)q * q + (size_t)p * (n + 1) + 3 * (size_t)q);
  auto kernel = mamba2_ssd_kernel<T>;
  // Above 48 KB a block's shared memory must be opted into per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(h, bsz), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<T*>(y), static_cast<float*>(hout), s, h, p, n, q);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------
// bf16: the sequence-split scan on the tensor cores (ssd_seg_*).
// ---------------------------------------------------------------------

constexpr int SEG = 64;    // rows per segment (kernels/common.py SSD_SEG)
constexpr int SNT = 128;   // 4 warps: 16 segment rows (or state rows) each

template <int W> __host__ __device__ constexpr int lds() { return W + 8; }

// The segment's rows [0, SEG) of a matrix of W bf16 per row, `stride`
// elements apart, into a shared tile of row stride W + 8 (ldmatrix
// without bank conflicts); rows at or past `rows` are zero-filled.
template <int W>
__device__ __forceinline__ void seg_rows(bf16* sm, const bf16* g,
                                         size_t stride, int rows, int tid) {
  constexpr int CPR = W / 8;   // 16-byte chunks per row
  for (int i = tid; i < SEG * CPR; i += SNT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < rows;
    cp_async16(sm + r * lds<W>() + c, g + (ok ? r : 0) * stride + c, ok);
  }
}

// a_log[h] or d_skip[h], float32 or bf16 (`bf16` set).
__device__ __forceinline__ float head_param(const void* p, int h, int bf16p) {
  return bf16p ? to_f(static_cast<const bf16*>(p)[h])
               : static_cast<const float*>(p)[h];
}

// Warp 0: the segment's dt (0 at or past `rows`, `stride` apart) into dts
// and the cumsum of dt a into cum.  Lane l holds rows 2l and 2l + 1; the
// pair sums are scanned across the lanes, so a row's value sums the rows
// at and before it alone, in an order fixed by its index.
__device__ __forceinline__ void seg_cumsum(const bf16* dt, size_t stride,
                                           int rows, float ah, float* dts,
                                           float* cum, int lane) {
  const int r = 2 * lane;
  const float d0 = r < rows ? to_f(dt[r * stride]) : 0.f;
  const float d1 = r + 1 < rows ? to_f(dt[(r + 1) * stride]) : 0.f;
  const float a0 = d0 * ah;
  float inc = a0 + d1 * ah;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  float ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.f;
  dts[r] = d0;
  dts[r + 1] = d1;
  cum[r] = ex + a0;
  cum[r + 1] = inc;
}

// 1. The segment's own end state S = x^T B' [P, N], B' = B o dt_j
//    exp(cum_L - cum_j), and its decay exp(cum_L).
template <int P, int N>
__global__ void __launch_bounds__(SNT)
ssd_seg_state_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                     const void* __restrict__ a_log, int ad_bf16,
                     const bf16* __restrict__ bm, float* __restrict__ ws,
                     float* __restrict__ dec, int s, int h, int nseg) {
  static_assert(P == 16 * (SNT / 32), "a warp per 16 state rows");
  constexpr int LX = lds<P>(), LB = lds<N>();
  __shared__ __align__(16) bf16 xs[SEG * LX];
  __shared__ __align__(16) bf16 bh[SEG * LB];   // B, then B' hi
  __shared__ __align__(16) bf16 bl[SEG * LB];   // B' lo
  __shared__ float dts[SEG], cum[SEG], wrow[SEG];
  const int seg = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = seg * SEG, rows = min(SEG, s - r0);
  const size_t pos0 = (size_t)bi * s + r0;
  seg_rows<P>(xs, x + (pos0 * h + head) * P, (size_t)h * P, rows, tid);
  seg_rows<N>(bh, bm + pos0 * N, N, rows, tid);
  cp_async_commit();
  if (warp == 0) {
    // a = -exp(a_log), as the reference wrapper prepares it.
    const float ah = -expf(head_param(a_log, head, ad_bf16));
    seg_cumsum(dt + pos0 * h + head, h, rows, ah, dts, cum, lane);
    __syncwarp();
    const float last = cum[SEG - 1];
    for (int r = lane; r < SEG; r += 32)
      wrow[r] = dts[r] * expf(last - cum[r]);
  }
  cp_async_wait<0>();
  __syncthreads();
  // B' as hi + lo planes, hi over B in place.
  for (int i = tid; i < SEG * N / 2; i += SNT) {
    const int r = i / (N / 2), c = (i % (N / 2)) * 2;
    uint32_t* hp = reinterpret_cast<uint32_t*>(bh + r * LB + c);
    const float2 bv =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hp));
    const float w = wrow[r];
    uint32_t hi, lo;
    pack_bf16_split(bv.x * w, bv.y * w, hi, lo);
    *hp = hi;
    *reinterpret_cast<uint32_t*>(bl + r * LB + c) = lo;
  }
  __syncthreads();
  // x^T B' on the tensor cores: the warp's 16 state rows p, K = the rows.
  float acc[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < SEG / 16; ++ks) {
    uint32_t af[4];   // x^T: x is stored row (K) major, hence .trans
    ldsm_x4_trans(af, xs + (ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                               LX + warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      const int off = (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LB +
                      np * 16 + ((lane >> 4) & 1) * 8;
      uint32_t b[4], c[4];
      ldsm_x4_trans(b, bh + off);
      ldsm_x4_trans(c, bl + off);
      mma_bf16(acc[2 * np], af, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      mma_bf16(acc[2 * np], af, c[0], c[1]);
      mma_bf16(acc[2 * np + 1], af, c[2], c[3]);
    }
  }
  const size_t slot = ((size_t)bi * h + head) * nseg + seg;
  float* out = ws + slot * P * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + r * 8) * N + j * 8 +
                                 2 * t4) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  if (tid == 0) dec[slot] = expf(cum[SEG - 1]);
}

// 2. Per (batch, head), in segment order: h_k = h_{k-1} exp(cum_L,k-1) +
//    S_{k-1} (h_0 = 0) written over S_k; the last h is the final state.
//    Four elements a thread, 1024 a block; CB segments' loads in flight
//    at once (the walk is latency-bound, not bytes-bound).
template <int PN>
__global__ void __launch_bounds__(256)
ssd_seg_carry_kernel(float* __restrict__ ws, const float* __restrict__ dec,
                     float* __restrict__ hout, int nseg) {
  constexpr int V = PN / 4;   // float4 per state
  constexpr int CB = 8;
  const size_t bh = blockIdx.y;
  const int e4 = blockIdx.x * 256 + threadIdx.x;
  float4* w = reinterpret_cast<float4*>(ws + bh * nseg * PN) + e4;
  const float* dk = dec + bh * nseg;
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nseg; k0 += CB) {
    float4 sk[CB];
    float e[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u)
      if (k0 + u < nseg) {
        sk[u] = w[(size_t)(k0 + u) * V];
        e[u] = dk[k0 + u];
      }
#pragma unroll
    for (int u = 0; u < CB; ++u)
      if (k0 + u < nseg) {
        w[(size_t)(k0 + u) * V] = hc;
        hc.x = hc.x * e[u] + sk[u].x;
        hc.y = hc.y * e[u] + sk[u].y;
        hc.z = hc.z * e[u] + sk[u].z;
        hc.w = hc.w * e[u] + sk[u].w;
      }
  }
  reinterpret_cast<float4*>(hout + bh * PN)[e4] = hc;
}

// 3. y = ((C B^T) o L)(x dt) + exp(cum) o (C h_k^T) + x d for the
//    segment's live rows, each warp 16 of them.
template <int P, int N>
__global__ void __launch_bounds__(SNT)
ssd_seg_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                   const void* __restrict__ a_log,
                   const void* __restrict__ dskip, int ad_bf16,
                   const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                   const float* __restrict__ ws, bf16* __restrict__ y, int s,
                   int h, int nseg) {
  static_assert(SEG == 16 * (SNT / 32), "a warp per 16 segment rows");
  constexpr int LX = lds<P>(), LB = lds<N>();
  __shared__ __align__(16) bf16 xs[SEG * LX];
  __shared__ __align__(16) bf16 bs[SEG * LB];
  __shared__ __align__(16) bf16 cs[SEG * LB];
  __shared__ __align__(16) bf16 hh[P * LB];   // h_k hi [P][N]
  __shared__ __align__(16) bf16 hl[P * LB];   // h_k lo
  __shared__ float dts[SEG], cum[SEG];
  const int seg = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = seg * SEG, rows = min(SEG, s - r0);
  const size_t pos0 = (size_t)bi * s + r0;
  seg_rows<P>(xs, x + (pos0 * h + head) * P, (size_t)h * P, rows, tid);
  seg_rows<N>(bs, bm + pos0 * N, N, rows, tid);
  seg_rows<N>(cs, cm + pos0 * N, N, rows, tid);
  cp_async_commit();
  if (warp == 0)
    seg_cumsum(dt + pos0 * h + head, h, rows,
               -expf(head_param(a_log, head, ad_bf16)), dts, cum, lane);
  const float4* hk = reinterpret_cast<const float4*>(
      ws + (((size_t)bi * h + head) * nseg + seg) * P * N);
  for (int i = tid; i < P * N / 4; i += SNT) {
    const int p = i / (N / 4), n = (i % (N / 4)) * 4;
    const float4 v = hk[i];
    uint32_t h0, l0, h1, l1;
    pack_bf16_split(v.x, v.y, h0, l0);
    pack_bf16_split(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(hh + p * LB + n) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(hl + p * LB + n) = make_uint2(l0, l1);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int i0 = warp * 16 + g;   // this lane's rows: i0, i0 + 8
  uint32_t cf[N / 16][4];         // C of the warp's rows, A of both products
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
    ldsm_x4(cf[ks], cs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             LB + ks * 16 + (lane >> 4) * 8);
  // G = C B^T over the segment's columns j (both operands exact).
  float ga[SEG / 8][4];
#pragma unroll
  for (int j = 0; j < SEG / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ga[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
    for (int np = 0; np < SEG / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bs + (np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LB +
                     ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(ga[2 * np], cf[ks], b[0], b[1]);
      mma_bf16(ga[2 * np + 1], cf[ks], b[2], b[3]);
    }
  // G' = G o L o dt_j, the exponent of L only on and below the diagonal.
  const float ci[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
  for (int j = 0; j < SEG / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >> 1) * 8, jj = j * 8 + 2 * t4 + (e & 1);
      ga[j][e] = jj <= i
                     ? ga[j][e] * expf(ci[e >> 1] - cum[jj]) * dts[jj]
                     : 0.f;
    }
  // Y = G' x: G' as hi + lo planes straight from the accumulators.
  float ya[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ya[j][e] = 0.f;
#pragma unroll
  for (int kb = 0; kb < SEG / 16; ++kb) {
    uint32_t ah[4], al[4];
    pack_bf16_split(ga[2 * kb][0], ga[2 * kb][1], ah[0], al[0]);
    pack_bf16_split(ga[2 * kb][2], ga[2 * kb][3], ah[1], al[1]);
    pack_bf16_split(ga[2 * kb + 1][0], ga[2 * kb + 1][1], ah[2], al[2]);
    pack_bf16_split(ga[2 * kb + 1][2], ga[2 * kb + 1][3], ah[3], al[3]);
#pragma unroll
    for (int dp = 0; dp < P / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LX + dp * 16 + ((lane >> 4) & 1) * 8);
      mma_bf16(ya[2 * dp], ah, b[0], b[1]);
      mma_bf16(ya[2 * dp + 1], ah, b[2], b[3]);
      mma_bf16(ya[2 * dp], al, b[0], b[1]);
      mma_bf16(ya[2 * dp + 1], al, b[2], b[3]);
    }
  }
  // C h_k^T, h_k as hi + lo planes.
  float ha[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ha[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
    for (int np = 0; np < P / 16; ++np) {
      const int off = (np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LB +
                      ks * 16 + ((lane >> 3) & 1) * 8;
      uint32_t b[4], c[4];
      ldsm_x4(b, hh + off);
      ldsm_x4(c, hl + off);
      mma_bf16(ha[2 * np], cf[ks], b[0], b[1]);
      mma_bf16(ha[2 * np + 1], cf[ks], b[2], b[3]);
      mma_bf16(ha[2 * np], cf[ks], c[0], c[1]);
      mma_bf16(ha[2 * np + 1], cf[ks], c[2], c[3]);
    }
  const float dh = head_param(dskip, head, ad_bf16);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r * 8;
    if (i >= rows) continue;
    const float ec = expf(ci[r]);
    bf16* yr = y + ((pos0 + i) * h + head) * P;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int p = j * 8 + 2 * t4;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + i * LX + p));
      *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
          ya[j][2 * r] + ec * ha[j][2 * r] + xv.x * dh,
          ya[j][2 * r + 1] + ec * ha[j][2 * r + 1] + xv.y * dh);
    }
  }
}

template <int P, int N>
int launch_seg(const void* x, const void* dt, const void* a_log,
               const void* b, const void* c, const void* d_skip, int ad_bf16,
               void* y, void* hout, void* ws, int bsz, int s, int h,
               int nseg, cudaStream_t st) {
  const dim3 grid(nseg, h, bsz);
  float* wsf = static_cast<float*>(ws);
  float* dec = wsf + (size_t)bsz * h * nseg * P * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dtb = static_cast<const bf16*>(dt);
  const bf16* bb = static_cast<const bf16*>(b);
  ssd_seg_state_kernel<P, N><<<grid, SNT, 0, st>>>(xb, dtb, a_log, ad_bf16,
                                                   bb, wsf, dec, s, h, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_seg_carry_kernel<P * N><<<dim3(P * N / 1024, bsz * h), 256, 0, st>>>(
      wsf, dec, static_cast<float*>(hout), nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_seg_out_kernel<P, N><<<grid, SNT, 0, st>>>(
      xb, dtb, a_log, d_skip, ad_bf16, bb, static_cast<const bf16*>(c), wsf,
      static_cast<bf16*>(y), s, h, nseg);
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_MAMBA2_ENTRY(SUFFIX, T)                                        \
  extern "C" int repro_mamba2_ssd_##SUFFIX(                                  \
      const void* x, const void* dt, const void* a, const void* b,           \
      const void* c, const void* d, void* y, void* hout, int bsz, int s,     \
      int h, int p, int n, int q, void* stream) {                            \
    return launch<T>(x, dt, a, b, c, d, y, hout, bsz, s, h, p, n, q,         \
                     stream);                                                \
  }

REPRO_MAMBA2_ENTRY(f32, float)

// bf16, the sequence-split scan: P = N = 64 (zamba2), segments of `seg` =
// SEG rows, nseg = cdiv(s, seg) (kernels/common.py::ssd_plan); a_log and
// d_skip [H] as they are, bf16 (ad_bf16 = 1) or float32; `ws` the float32
// workspace, B H nseg (P N + 1) values; x, b and c 16-byte aligned.
extern "C" int repro_mamba2_ssd_seg_bf16(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* d_skip, int ad_bf16, void* y, void* hout,
    void* ws, int bsz, int s, int h, int p, int n, int seg, int nseg,
    void* stream) {
  if (bsz < 1 || s < 1 || h < 1 || p != 64 || n != 64 || seg != SEG ||
      nseg != cdiv(s, SEG))
    return (int)cudaErrorInvalidValue;
  return launch_seg<64, 64>(x, dt, a_log, b, c, d_skip, ad_bf16, y, hout, ws,
                            bsz, s, h, nseg,
                            static_cast<cudaStream_t>(stream));
}
