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
// blocks run in parallel and in no order, so each block owns one token
// tile and one contiguous range of vocab tiles and walks that range in a
// loop, folding each logits tile into a running (m, s) per row (the online
// logsumexp) and keeping the label's logit where the label's column is one
// of its own.  Few token tiles (32 at llama3's 4096 training tokens) would
// leave most of the 132 SMs idle, so the vocab is split across blocks
// (gridDim.y); each split writes float32 partials (m, s, gold) [splits, T]
// that a second launch merges per row in split order: no atomics, so the
// result repeats run to run (a resumed trainer replays bit for bit).  The
// Python wrapper sizes the split.
// What bounds it: the 2 T D Vp operations (llama3's step: 4.3 TFLOP), far
// above the bytes (hidden, head and labels read once).
//
// bfloat16 (xent_mma_kernel, on the tensor cores): 128-token tiles; each
// 128-column vocab tile is mma_gemm.cuh's Large main loop over D (the
// cp.async ring running on from one vocab tile's last K tiles into the
// next one's first), and its float32 C fragments are folded straight from
// registers: the row max over a quad's 32 columns by two shuffles, then
// each thread's exponentials, summed over the quad the same way, into the
// running (m, s) of each (row, warp column) in shared memory; the four
// warp columns of a row merge in order at the end of the range.  Token
// tiles are the grid's fastest dimension, so the blocks that read one head
// tile run together and the head comes from HBM about once (llama3's is
// 1.05 GB: 0.31 ms at 3.35 TB/s; re-read per token tile it would be 10 ms).
// float32 (xent_parts_kernel, on the CUDA cores: TF32 would break the
// float32 checks) keeps 64 x 64 tiles of tiled_matmul.cuh's tile product,
// 4 x 4 logits per thread, the 16 threads of a row merged by shuffles.
#include "mma_gemm.cuh"
#include "tiled_matmul.cuh"

using namespace repro;

namespace {

constexpr int kBT = 64, kBN = 64, kTM = 4, kTN = 4;
constexpr int kThreads = (kBT / kTM) * (kBN / kTN);        // 256
constexpr int kRowLanes = kBN / kTN;                        // 16 per row

__global__ void __launch_bounds__(kThreads)
xent_parts_kernel(const float* __restrict__ h, const float* __restrict__ head,
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
    tile_accumulate<float, float, false, kBT, kBN, kTM, kTN>(
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

// The bf16 kernel: block (token tile blockIdx.x, vocab split blockIdx.y).
__global__ void __launch_bounds__(Large::NT, 2)
xent_mma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ head,
                const int* __restrict__ labels, float* __restrict__ pm,
                float* __restrict__ ps, float* __restrict__ pg, int t, int d,
                int vp, int vocab, int tiles_per_split, int aligned_) {
  using C = Large;
  using L = GemmLayout<C, GEMM_PLAIN>;
  constexpr int ST = C::ST, MT = C::MT, NT8 = C::NT8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);                 // [ST][A]
  unsigned char* b_s = smem_raw + ST * L::A_BYTES;               // [ST][B]
  // Running (m, s) of each row and warp column (after the quad's merge),
  // the label's logit, the labels.
  __shared__ float m_s[C::BM][C::WN], s_s[C::BM][C::WN], gold_s[C::BM];
  __shared__ int lab_s[C::BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, t4 = lane & 3;
  const bool aligned = aligned_ != 0;
  const int row0 = blockIdx.x * C::BM;
  const int n_v = (vp + kMmaBN - 1) / kMmaBN;
  const int v_begin = blockIdx.y * tiles_per_split;
  const int v_end = min(n_v, v_begin + tiles_per_split);
  const int n_kt = (d + C::BK - 1) / C::BK;
  const int steps = max(0, v_end - v_begin) * n_kt;
  const int lim = min(vocab, vp);   // columns past it are masked

  // Step i: K tile i % n_kt of vocab tile v_begin + i / n_kt.
  auto load_step = [&](int i, int stage) {
    load_tile<C, false>(a_s + stage * C::A_ELEMS, b_s + stage * L::B_BYTES,
                        nullptr, h, head, nullptr, t, d, vp, row0,
                        (v_begin + i / n_kt) * kMmaBN, (i % n_kt) * C::BK, d,
                        aligned);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  for (int r = tid; r < C::BM; r += C::NT) {
    lab_s[r] = row0 + r < t ? labels[row0 + r] : -1;
    gold_s[r] = kNegInf;
#pragma unroll
    for (int w = 0; w < C::WN; ++w) {
      m_s[r][w] = kNegInf;
      s_s[r][w] = 0.f;
    }
  }

  float acc[MT][NT8][4];
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<ST - 2>();   // step's tiles have landed
    __syncthreads();           // ... for all, and step - 1 is done
    if (step + ST - 1 < steps) load_step(step + ST - 1, (step + ST - 1) % ST);
    cp_async_commit();
    const int kt = step % n_kt;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    mma_tile<C, 1>(acc, a_s + (step % ST) * C::A_ELEMS, nullptr,
                   reinterpret_cast<const bf16*>(b_s + (step % ST) *
                                                          L::B_BYTES),
                   lane, wm, wn);
    if (kt < n_kt - 1) continue;
    // The logits tile is done: fold this lane's rows (r, r + 8 of each
    // 16-row tile) over its columns (c, c + 1 of each n8 tile).
    const int col0 = (v_begin + step / n_kt) * kMmaBN + wn * C::WTN + 2 * t4;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wm * C::WTM + i * 16 + g + hr * 8;
        const int lab = lab_s[r];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NT8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = col0 + j * 8 + e;
            const float lg = v < lim ? acc[i][j][2 * hr + e] : kNegInf;
            mx = fmaxf(mx, lg);
            // A label past the vocabulary finds its masked logit, as in
            // the reference (its hit reads the masked tile).
            if (v == lab) gold_s[r] = lg;
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_old = m_s[r][wn], s_old = s_s[r][wn];
        const float m_new = fmaxf(m_old, mx);
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < NT8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + j * 8 + e < lim)
              p += expf(acc[i][j][2 * hr + e] - m_new);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        __syncwarp();   // the quad has read the old state
        if (t4 == 0) {
          m_s[r][wn] = m_new;
          s_s[r][wn] = s_old * expf(m_old - m_new) + p;
        }
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  // The four warp columns of each row, merged in order.
  for (int r = tid; r < C::BM; r += C::NT) {
    const int gr = row0 + r;
    if (gr >= t) continue;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < C::WN; ++w) m = fmaxf(m, m_s[r][w]);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < C::WN; ++w) s += s_s[r][w] * expf(m_s[r][w] - m);
    const size_t idx = (size_t)blockIdx.y * t + gr;
    pm[idx] = m;
    ps[idx] = s;
    pg[idx] = gold_s[r];
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

// The merge of the (m, s, gold) partials [3, splits, t] into lse, gold.
int merge(const float* pm, const float* ps, const float* pg, void* lse,
          void* gold, int t, int splits, cudaStream_t stream) {
  xent_merge_kernel<<<cdiv(t, 256), 256, 0, stream>>>(
      pm, ps, pg, static_cast<float*>(lse), static_cast<float*>(gold), t,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 on the CUDA cores; part: float32 scratch [3, splits, t] (m, s,
// gold partials); 64-column vocab tiles (streamed_xent.py::vocab_split).
extern "C" int repro_streamed_xent_f32(const void* h, const void* head,
                                       const void* labels, void* lse,
                                       void* gold, void* part, int t, int d,
                                       int vp, int vocab, int tiles_per_split,
                                       int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part);
  float* ps = pm + (size_t)splits * t;
  float* pg = ps + (size_t)splits * t;
  xent_parts_kernel<<<dim3(cdiv(t, kBT), splits), kThreads, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(head),
      static_cast<const int*>(labels), pm, ps, pg, t, d, vp, vocab,
      tiles_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge(pm, ps, pg, lse, gold, t, splits, st);
}

// bf16 on the tensor cores: 128-token tiles, `tiles_per_split` 128-column
// vocab tiles per split (streamed_xent.py::xent_mma_plan); `aligned`: D
// and Vp multiples of 8, hidden and head 16-byte aligned.
extern "C" int repro_streamed_xent_mma_bf16(
    const void* h, const void* head, const void* labels, void* lse,
    void* gold, void* part, int t, int d, int vp, int vocab,
    int tiles_per_split, int splits, int aligned, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t == 0) return (int)cudaGetLastError();
  constexpr size_t SMEM = GemmLayout<Large, GEMM_PLAIN>::BYTES;
  static size_t smem_set = 0;
  cudaError_t err = raise_smem(xent_mma_kernel, SMEM, &smem_set);
  if (err != cudaSuccess) return (int)err;
  float* pm = static_cast<float*>(part);
  float* ps = pm + (size_t)splits * t;
  float* pg = ps + (size_t)splits * t;
  xent_mma_kernel<<<dim3(cdiv(t, Large::BM), splits), Large::NT, SMEM, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(head),
      static_cast<const int*>(labels), pm, ps, pg, t, d, vp, vocab,
      tiles_per_split, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge(pm, ps, pg, lse, gold, t, splits, st);
}
