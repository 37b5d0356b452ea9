// The stream layout converter (K15): re-tiles a 2-D tensor data [H, W]
// from the producer's itensor layout to the consumer's,
//   out[t] = data[oh(t) : oh(t) + eh, ow(t) : ow(t) + ew],  t < n_tokens,
// the consumer's tile stream [n_tokens, eh, ew], reuse loops repeating
// their tiles.  Token t is decoded as a mixed radix over the consumer's
// trip counts, the innermost loop last; oh = sum_k idx[k] * ch[k] and
// ow = sum_k idx[k] * cw[k], where ch / cw hold the step of the loop that
// feeds the row / column dim and 0 elsewhere (reuse loops feed neither).
//
// Replaces `convert_layout` (src/repro/kernels/stream_converter.py:34),
// both of its Pallas bodies: `_copy_kernel` (:30, matching types) and the
// window `kernel` (:79, the Algorithm-1 window, one grid step per
// consumer token).  The two emit the same stream, so one kernel serves
// both.
//
// What bounds it: bytes, the data read once and the stream written once;
// on the large streams (a reuse loop repeating every tile of a row block
// hundreds of times: 7.34 GB out of 29 MB of data for llama3-8b's MLP at
// 1000 tokens) the writes are the bound, and the rereads of the data come
// from the 50 MB L2: those streams take 2.26 ms against a 2.19 ms bound
// (3.26 TB/s of writes on an NVIDIA H100 80GB HBM3 at 700 W).  The
// one-warp-per-tile kernel this replaces wrote 1.08 TB/s: a 10 x 16 bf16
// tile is 20 vectors, so 12 of 32 lanes idled on every store, each load fed
// its own store (few bytes in flight), 64-bit radix arithmetic per token,
// and 2-byte copies wherever a row was not 16 bytes.
//
// Design: the output is one contiguous array, cut into ranges of `run`
// bytes (a multiple of 16), one block each.  A block decodes the tokens
// its range touches once, one token a thread, into shared memory (each
// token's data offset oh * W + ow), then its 256 threads walk the range in
// 16-byte output vectors, U = 4 in flight per thread: every lane loads
// (through the read-only path) and stores (streaming stores: nothing
// rereads the stream) whole vectors, whatever the tile's width.  Inside a
// range everything is 32-bit: each thread decodes its first vector's
// (token, row, column) once and then steps it by the block's stride with
// adds and compares, no division.
//   VEC (every tile row, the row stride, each column offset and the data
//   pointer on 16-byte boundaries): an output vector is one 16-byte load.
//   Otherwise a warp loads 32 vectors' worth of elements one element a
//   lane at a time (neighbouring lanes on neighbouring elements, across
//   tile rows and tokens as they fall), turns them into 16-byte vectors
//   through shared memory and stores those; a range's ragged tail (the
//   stream's last bytes when its length is not a multiple of 16) is stored
//   element by element.
// The data is read through L2 rather than staged in shared memory: the
// Algorithm-1 window of the large streams ([10, 14336] bf16, 287 KB) does
// not fit in an SM's 227 KB, and for those that fit the rereads are L2
// hits whose rate is above the write bound.
// Templated on the element size: 1, 2 and 4 bytes (the copy moves bits).
#include "common.cuh"

using namespace repro;

constexpr int MAX_LOOPS = 8;

// Passed by value; mirrors `_Desc` in kernels/stream_converter.py.
struct Desc {
  int64_t total;          // stream bytes: n_tokens * eh * ew * esz
  int64_t n_tokens;       // < 2^31
  int32_t row;            // W, the data's row stride in elements
  int32_t nloops, eh, ew, vec;
  int32_t run;            // bytes per block, a multiple of 16
  int32_t trip[MAX_LOOPS];
  int32_t ch[MAX_LOOPS];  // row offset per iteration of loop k
  int32_t cw[MAX_LOOPS];  // column offset per iteration of loop k
};

namespace {

constexpr int NT = 256;
constexpr int U = 4;          // output vectors in flight per thread
constexpr int MAXT = 2048;    // tokens one range may touch (the wrapper's
                              // MAX_TOKENS)

// Token t's data offset oh * W + ow (data offsets fit in 31 bits).
__device__ __forceinline__ int32_t token_offset(const Desc& d, uint32_t t) {
  int32_t oh = 0, ow = 0;
#pragma unroll
  for (int k = MAX_LOOPS - 1; k >= 0; --k)
    if (k < d.nloops) {
      const uint32_t tc = (uint32_t)d.trip[k];
      const int32_t i = (int32_t)(t % tc);
      t /= tc;
      oh += i * d.ch[k];
      ow += i * d.cw[k];
    }
  return oh * d.row + ow;
}

// A unit's place (token from the range's first, row, column) stepped by
// `dt` tokens, `dr` rows and `dc` columns (dr < rows, dc < cols).
__device__ __forceinline__ void step(int32_t& tok, int32_t& r, int32_t& c,
                                     int32_t dt, int32_t dr, int32_t dc,
                                     int32_t rows, int32_t cols) {
  c += dc;
  r += dr;
  if (c >= cols) {
    c -= cols;
    ++r;
  }
  if (r >= rows) {
    r -= rows;
    ++tok;
  }
  tok += dt;
}

// E: an unsigned integer of the element's size.
template <typename E, bool VEC>
__global__ void __launch_bounds__(NT)
convert_kernel(const E* __restrict__ data, E* __restrict__ out, Desc d) {
  constexpr int V = 16 / (int)sizeof(E);   // elements per 16-byte vector
  __shared__ int32_t toff[MAXT];
  const int tid = threadIdx.x;
  const int64_t b0 = (int64_t)blockIdx.x * d.run;
  const int32_t bytes = (int32_t)min((int64_t)d.run, d.total - b0);
  const int32_t tile = d.eh * d.ew;
  const int64_t e0 = b0 / (int64_t)sizeof(E);
  const int64_t t0 = e0 / tile;
  const int32_t rel0 = (int32_t)(e0 - t0 * tile);  // in token t0
  const int32_t elems = bytes / (int32_t)sizeof(E);
  const int32_t ntok = (rel0 + elems - 1) / tile + 1;
  for (int i = tid; i < ntok; i += NT)
    toff[i] = token_offset(d, (uint32_t)(t0 + i));
  __syncthreads();
  uint4* o = reinterpret_cast<uint4*>(out + e0);
  const int32_t nvec = bytes / 16;   // whole output vectors
  if constexpr (VEC) {
    // Units: 16-byte vectors, vpr per tile row.
    const int32_t vpr = d.ew / V, vpt = d.eh * vpr;
    const int32_t q = rel0 / V + tid;
    int32_t tok = q / vpt, r = (q - tok * vpt) / vpr;
    int32_t c = q - tok * vpt - r * vpr;
    const int32_t dt = NT / vpt, dp = NT - dt * vpt;
    const int32_t dr = dp / vpr, dc = dp - dr * vpr;
    for (int32_t v0 = tid; v0 < nvec; v0 += NT * U) {
      uint4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (v0 + u * NT < nvec)
          x[u] = __ldg(reinterpret_cast<const uint4*>(
              data + toff[tok] + r * d.row + c * V));
        step(tok, r, c, dt, dr, dc, d.eh, vpr);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + u * NT < nvec) __stcs(o + v0 + u * NT, x[u]);
    }
  } else {
    // Units: elements, 32 V to a warp's chunk: lane l loads the chunk's
    // elements l, l + 32, ... (neighbouring lanes on neighbouring
    // elements, so neighbouring source columns), and the chunk is turned
    // into 32 16-byte vectors through shared memory.
    __shared__ __align__(16) E xs[NT * V];
    const int lane = tid & 31, wid = tid >> 5;
    E* xw = xs + wid * 32 * V;
    const int32_t dt = 32 / tile, dp = 32 - dt * tile;
    const int32_t dr = dp / d.ew, dc = dp - dr * d.ew;
    const int32_t nch = (elems + 32 * V - 1) / (32 * V);   // ragged tail too
    for (int32_t ch = wid; ch < nch; ch += NT / 32) {
      const int32_t e = ch * 32 * V + lane;
      const int32_t q = rel0 + e;
      int32_t tok = q / tile, r = (q - tok * tile) / d.ew;
      int32_t c = q - tok * tile - r * d.ew;
      E x[V] = {};
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (e + 32 * j < elems)
          x[j] = __ldg(data + toff[tok] + r * d.row + c);
        step(tok, r, c, dt, dr, dc, d.eh, d.ew);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) xw[lane + 32 * j] = x[j];
      __syncwarp();
      const int32_t v = ch * 32 + lane;   // the lane's output vector
      if (v < nvec) {
        __stcs(o + v, reinterpret_cast<const uint4*>(xw)[lane]);
      } else if (v * V < elems) {
        for (int i = 0; v * V + i < elems; ++i)
          out[e0 + (int64_t)v * V + i] = xw[lane * V + i];
      }
      __syncwarp();
    }
  }
}

template <typename E>
int launch(const void* data, void* out, const Desc& d, int blocks,
           cudaStream_t stream) {
  if (d.vec)
    convert_kernel<E, true><<<blocks, NT, 0, stream>>>(
        static_cast<const E*>(data), static_cast<E*>(out), d);
  else
    convert_kernel<E, false><<<blocks, NT, 0, stream>>>(
        static_cast<const E*>(data), static_cast<E*>(out), d);
  return (int)cudaGetLastError();
}

}  // namespace

// `esz`: the element size in bytes (1, 2 or 4); `blocks` = cdiv(total,
// run) blocks of 256 threads, each touching at most MAXT tokens.
extern "C" int repro_convert_layout(const void* data, void* out, Desc d,
                                    int esz, int blocks, void* stream) {
  if (d.n_tokens < 1 || d.nloops < 1 || d.nloops > MAX_LOOPS || d.eh < 1 ||
      d.ew < 1 || d.run < 16 || d.run % 16 || blocks < 1 ||
      (int64_t)blocks * d.run < d.total ||
      (int64_t)(blocks - 1) * d.run >= d.total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (esz) {
    case 1: return launch<uint8_t>(data, out, d, blocks, s);
    case 2: return launch<uint16_t>(data, out, d, blocks, s);
    case 4: return launch<uint32_t>(data, out, d, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
