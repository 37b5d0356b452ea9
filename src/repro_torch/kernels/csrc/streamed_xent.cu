// streamed_xent (K11): the cross-entropy parts of an LM head without the
// [T, Vp] logits in device memory:
//   lse[t]  = logsumexp_v logits[t, v],  gold[t] = logits[t, labels[t]],
//   logits  = hidden[T, D] @ head[D, Vp] in float32 (bf16 or f32 operands,
//             float32 sums), columns v >= vocab_size masked to -1e30.
//
// Replaces the TPU kernel src/repro/kernels/streamed_xent.py::_xent_kernel
// (pallas_call at :85, wrapper streamed_xent_parts :73).  The TPU kernel
// walks the vocab as the sequential grid dimension and carries the running
// (m, s, gold) of each token tile in VMEM scratch across it.  On Hopper the
// blocks run in parallel and in no order, so each block owns one 64-token
// tile and one contiguous range of 64-column vocab tiles and walks that
// range in a loop:
//   1. the logits tile comes from the tiled matmul's tile product
//      (tiled_matmul.cuh::tile_accumulate, the K5 path: 32-deep K tiles
//      through shared memory, float32 FMA on the CUDA cores) and stays in
//      registers;
//   2. each thread folds its 4 x 4 logits into a running (m, s) per row,
//      the online logsumexp, and keeps the label's logit where the label's
//      column is one of its own;
//   3. after the range, the 16 threads that share a row merge their
//      (m, s, gold) with warp shuffles.
// Few token tiles (64 at llama3's 4096 training tokens) would leave most
// of the 132 SMs idle, so the vocab is split across blocks (gridDim.y);
// each split writes float32 partials (m, s, gold) [splits, T] that a
// second pass merges per row in split order: no atomics, so the result
// repeats run to run.  The Python wrapper sizes the split.
// What bounds it: the 2 T D Vp operations (at T = 8192, D = 1024, Vp =
// 50432: 0.85 TFLOP), far above the bytes (hidden, head and labels read
// once), done here on the CUDA cores, not the tensor cores (wgmma is later
// work).  The head is re-read once per token tile, from L2 where it fits.
#include "tiled_matmul.cuh"

using namespace repro;

namespace {

constexpr int kBT = 64, kBN = 64, kTM = 4, kTN = 4;
constexpr int kThreads = (kBT / kTM) * (kBN / kTN);        // 256
constexpr int kRowLanes = kBN / kTN;                        // 16 per row

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_parts_kernel(const T* __restrict__ h, const T* __restrict__ head,
                  const int* __restrict__ labels, float* __restrict__ pm,
                  float* __restrict__ ps, float* __restrict__ pg, int t,
                  int d, int vp, int vocab, int tiles_per_split) {
  __shared__ float xs[kMatmulBK][kBT + 1];
  __shared__ float ws[kMatmulBK][kBN];
  const int tid = threadIdx.x;
  const int tr = tid / kRowLanes, tc = tid % kRowLanes;
  const int row0 = blockIdx.x * kBT;
  const int n_tiles = (vp + kBN - 1) / kBN;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);

  int label[kTM];
  float m[kTM], s[kTM], g[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + tr * kTM + i;
    label[i] = gr < t ? labels[gr] : -1;
    m[i] = kNegInf;
    s[i] = 0.f;
    g[i] = kNegInf;
  }

  float acc[kTM][kTN];
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * kBN;
    tile_accumulate<T, T, false, kBT, kBN, kTM, kTN>(
        h, nullptr, head, nullptr, xs, ws, t, d, vp, row0, col0, 0, d, acc);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float lg[kTN];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int v = col0 + tc * kTN + j;
        lg[j] = (v < vocab && v < vp) ? acc[i][j] : kNegInf;
        tmax = fmaxf(tmax, lg[j]);
        // A label past the vocabulary finds its masked logit, as in the
        // reference (its hit reads the masked tile).
        if (v == label[i]) g[i] = lg[j];
      }
      const float m_new = fmaxf(m[i], tmax);
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int v = col0 + tc * kTN + j;
        if (v < vocab && v < vp) p += expf(lg[j] - m_new);
      }
      s[i] = s[i] * expf(m[i] - m_new) + p;
      m[i] = m_new;
    }
  }

  // The 16 threads of a row group are 16 neighbouring lanes (tc is the low
  // four bits of the lane): merge them by shuffles within the group.
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float mi = m[i], si = s[i], gi = g[i];
#pragma unroll
    for (int o = kRowLanes / 2; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mi, o);
      const float so = __shfl_xor_sync(0xffffffffu, si, o);
      gi = fmaxf(gi, __shfl_xor_sync(0xffffffffu, gi, o));
      const float mn = fmaxf(mi, mo);
      si = si * expf(mi - mn) + so * expf(mo - mn);
      mi = mn;
    }
    const int gr = row0 + tr * kTM + i;
    if (tc == 0 && gr < t) {
      const size_t idx = (size_t)blockIdx.y * t + gr;
      pm[idx] = mi;
      ps[idx] = si;
      pg[idx] = gi;
    }
  }
}

// Merge the splits' partials of each row in split order; lse = m +
// log(max(s, 1e-30)) as the reference's final step.
__global__ void xent_merge_kernel(const float* __restrict__ pm,
                                  const float* __restrict__ ps,
                                  const float* __restrict__ pg,
                                  float* __restrict__ lse,
                                  float* __restrict__ gold, int t,
                                  int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= t) return;
  float m = kNegInf, g = kNegInf;
  for (int z = 0; z < splits; ++z) m = fmaxf(m, pm[(size_t)z * t + r]);
  float s = 0.f;
  for (int z = 0; z < splits; ++z) {
    const size_t i = (size_t)z * t + r;
    s += ps[i] * expf(pm[i] - m);
    g = fmaxf(g, pg[i]);
  }
  lse[r] = m + logf(fmaxf(s, 1e-30f));
  gold[r] = g;
}

// part: float32 scratch [3, splits, t] (m, s, gold partials).
template <typename T>
int xent_parts(const void* h, const void* head, const void* labels,
               void* lse, void* gold, void* part, int t, int d, int vp,
               int vocab, int tiles_per_split, int splits,
               cudaStream_t stream) {
  float* pm = static_cast<float*>(part);
  float* ps = pm + (size_t)splits * t;
  float* pg = ps + (size_t)splits * t;
  dim3 grid(cdiv(t, kBT), splits);
  xent_parts_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(head),
      static_cast<const int*>(labels), pm, ps, pg, t, d, vp, vocab,
      tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_merge_kernel<<<cdiv(t, 256), 256, 0, stream>>>(
      pm, ps, pg, static_cast<float*>(lse), static_cast<float*>(gold), t,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_streamed_xent_f32(const void* h, const void* head,
                                       const void* labels, void* lse,
                                       void* gold, void* part, int t, int d,
                                       int vp, int vocab, int tiles_per_split,
                                       int splits, void* stream) {
  return xent_parts<float>(h, head, labels, lse, gold, part, t, d, vp, vocab,
                           tiles_per_split, splits,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int repro_streamed_xent_bf16(const void* h, const void* head,
                                        const void* labels, void* lse,
                                        void* gold, void* part, int t, int d,
                                        int vp, int vocab,
                                        int tiles_per_split, int splits,
                                        void* stream) {
  return xent_parts<__nv_bfloat16>(h, head, labels, lse, gold, part, t, d,
                                   vp, vocab, tiles_per_split, splits,
                                   static_cast<cudaStream_t>(stream));
}
