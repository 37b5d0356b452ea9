// mamba2_scan (K13): the Mamba2 chunked state-space-dual (SSD) scan.
//   x [B, S, H, P], dt [B, S, H], b / c [B, S, N] (one group, shared by
//   every head) in T; a [H] = -exp(a_log) and d [H] (the skip) float32
//   -> y [B, S, H, P] in T, the final state [B, H, P, N] float32.
// Per (batch, head), over chunks of Q rows in order, with the state h
// [P, N] starting at zero, cum the running sum of dt * a over the chunk
// and cum_Q its last entry:
//   y  = ((C B^T) o L) (x dt) + exp(cum) o (C h^T) + x d,
//        L[i, j] = exp(cum_i - cum_j) for j <= i, 0 above the diagonal;
//   h <- h exp(cum_Q) + ((x dt) exp(cum_Q - cum))^T B.
// Everything is float32; y is rounded to T once, at the end.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan.py::_ssd_kernel
// (mamba2_ssd_pallas, pallas_call at :104).  There the chunk axis is the
// sequential inner grid dimension and the state rides in VMEM scratch
// from one grid step to the next; Hopper blocks run in no order, so here
// one block per (batch, head) walks the chunks itself and keeps the state
// in shared memory the whole way.  The reference wrapper repeats B and C
// for every head (`jnp.repeat`, :97-100); this kernel reads them in place.
// The exponent of L is taken only where j <= i: above the diagonal
// cum_i - cum_j is positive and could overflow (the reference masks after
// the exp).  Any Q that divides S works, 1 included (an odd prompt scans
// in chunks of one row); shared memory holds the chunk's x, B, C, the
// [Q, Q] matrix and the state, 182 KB at Q = 128, P = N = 64, opted in
// above 48 KB with cudaFuncSetAttribute.
// What bounds it: bytes at serving shapes (x in, y out, the state out:
// 22 MB at S = 1000, batch 1, bf16); at a training step (2 x 2048, Q =
// 128) about 21 GFLOP against 84 MB, still bytes on the tensor cores.
// This first version does the products on the CUDA cores (float FMA) out
// of shared memory, with one block per (batch, head): 80 blocks at batch
// 1 leave 52 of the 132 SMs idle.  No wgmma, no TMA yet.
#include "common.cuh"

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
REPRO_MAMBA2_ENTRY(bf16, __nv_bfloat16)
