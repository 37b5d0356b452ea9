// rwkv6_wkv (K14): the RWKV6 (Finch) wkv recurrence.
//   r, k, v [B, S, H, N] in T; w [B, S, H, N] float32, the per-step decay;
//   u [H, N] float32, the bonus -> y [B, S, H, N] in T, the final state
//   [B, H, N, N] float32 (keys x values), the state starting at zero.
// Per (batch, head), token after token, with kv = k_t^T v_t:
//   y_t = r_t (S + u^T o kv),   S <- S o w_t^T + kv.
// Everything is float32; y is rounded to T once per token.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py::_wkv_kernel
// (wkv6_pallas, pallas_call at :78).  There the grid is (batch x heads,
// S / chunk), the chunk axis sequential, and each head's [N, N] state
// rides in VMEM scratch from one grid step to the next.  Hopper blocks run
// in no order, so nothing is carried between blocks; instead the
// recurrence is split where it has no coupling.  Column j of the state
// (value index j) depends only on v_t[j] and the vectors r_t, k_t, w_t, u:
//   y_t[j] = sum_k r_t[k] (S[k, j] + u[k] k_t[k] v_t[j]),
//   S[k, j] <- S[k, j] w_t[k] + k_t[k] v_t[j].
// So a block owns CB = 16 columns of one head's state and walks every
// token in order; KS = 4 neighbouring threads share a column, each holding
// N / KS of its rows (k = kq, kq + 4, ...) in registers, and y_t[j] is
// their sum over two warp shuffles.  No state ever leaves the registers
// until the last token.  The block stages TT tokens of r, k, w (the whole
// head row) and v (its CB columns) in shared memory at a time, so the
// token loop reads only shared memory; TT * N is 2048 floats per vector
// whatever N is.  The grid is (N / CB, H, B): 256 blocks of 64 threads at
// batch 1 with H = N = 64, against 64 blocks for one block per head.
// The reference's `chunk` only cuts its grid: this kernel takes no chunk,
// so its result and speed do not depend on it (an odd prompt, whose
// largest chunk dividing S is 1, costs nothing extra).
// What bounds it: operations, about 7 N^2 float32 operations per token and
// head on the CUDA cores (no product here is big enough for the tensor
// cores: an outer product and a vector-matrix product per token), 1.8
// GFLOP at S = 1000, batch 1, against 50 MB of bytes.  This first version
// is latency-bound on the per-token chain instead: each thread does N / KS
// dependent-free FMA triples per token, with a shuffle reduction and a
// store, and a block waits on its staging loads (no double buffering, no
// chunked matrix form yet).
#include "common.cuh"

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

}  // namespace

#define REPRO_WKV6_ENTRY(SUFFIX, T)                                          \
  extern "C" int repro_wkv6_##SUFFIX(                                        \
      const void* r, const void* k, const void* v, const void* w,            \
      const void* u, void* y, void* sout, int bsz, int s, int h, int n,      \
      void* stream) {                                                        \
    return launch<T>(r, k, v, w, u, y, sout, bsz, s, h, n, stream);          \
  }

REPRO_WKV6_ENTRY(f32, float)
REPRO_WKV6_ENTRY(bf16, __nv_bfloat16)
