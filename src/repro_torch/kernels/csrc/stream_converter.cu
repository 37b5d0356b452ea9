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
// both.  What bounds it: bytes, the data read once and the stream written
// once; a reuse loop rereads its tiles (from L2 where they stay).  This
// kernel reads each tile from global memory at every emission and does
// not stage the Algorithm-1 window in shared memory: a window of the
// whole tensor (no shared loop prefix) outgrows an SM's 227 KB.
//
// Design: one warp per tile.  Each warp owns a run of consecutive tokens,
// decodes the first one (64-bit: a stream may hold more than 2^32
// elements) and then counts the radix up one token at a time, so the
// divisions happen once per warp.  Lanes walk the tile's elements, so a
// warp's writes are contiguous across its consecutive tokens; with 16-byte
// aligned rows (row bytes, row stride, column step and both pointers) they
// move 16-byte vectors, else single elements (a bf16 16 x 10 tile has
// 20-byte rows).  Templated on the element size: 1, 2 and 4 bytes.
#include "common.cuh"

using namespace repro;

constexpr int MAX_LOOPS = 8;

// Passed by value; mirrors `_Desc` in kernels/stream_converter.py.
struct Desc {
  int64_t n_tokens;
  int64_t row;            // W, the data's row stride in elements
  int32_t nloops, eh, ew, vec;
  int32_t trip[MAX_LOOPS];
  int64_t ch[MAX_LOOPS];  // row offset per iteration of loop k
  int64_t cw[MAX_LOOPS];  // column offset per iteration of loop k
};

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;

// E: an unsigned integer of the element's size (the copy moves bits).
template <typename E, bool VEC>
__global__ void __launch_bounds__(NT)
convert_kernel(const E* __restrict__ data, E* __restrict__ out, Desc d,
               int64_t per_warp) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  int64_t t = warp * per_warp;
  const int64_t t_end =
      t + per_warp < d.n_tokens ? t + per_warp : d.n_tokens;
  if (t >= t_end) return;

  int32_t idx[MAX_LOOPS];
  int64_t rem = t;
#pragma unroll
  for (int k = MAX_LOOPS - 1; k >= 0; --k) {
    idx[k] = 0;
    if (k < d.nloops) {
      idx[k] = (int32_t)(rem % d.trip[k]);
      rem /= d.trip[k];
    }
  }
  const int tile = d.eh * d.ew;
  constexpr int V = 16 / (int)sizeof(E);   // elements per 16-byte vector
  const int vpr = d.ew / V;                // vectors per tile row
  for (; t < t_end; ++t) {
    int64_t oh = 0, ow = 0;
#pragma unroll
    for (int k = 0; k < MAX_LOOPS; ++k) {
      oh += idx[k] * d.ch[k];
      ow += idx[k] * d.cw[k];
    }
    const E* src = data + oh * d.row + ow;
    E* dst = out + t * tile;
    if constexpr (VEC) {
      for (int v = lane; v < d.eh * vpr; v += 32) {
        const int r = v / vpr, c = v - r * vpr;
        reinterpret_cast<uint4*>(dst)[v] =
            *reinterpret_cast<const uint4*>(src + r * d.row + c * V);
      }
    } else {
      for (int e = lane; e < tile; e += 32) {
        const int r = e / d.ew, c = e - r * d.ew;
        dst[e] = src[r * d.row + c];
      }
    }
    // The next token: count the radix up, the innermost loop first.
    bool carry = true;
#pragma unroll
    for (int k = MAX_LOOPS - 1; k >= 0; --k) {
      if (carry && k < d.nloops) {
        if (++idx[k] == d.trip[k]) idx[k] = 0;
        else carry = false;
      }
    }
  }
}

template <typename E>
int launch(const void* data, void* out, const Desc& d, int64_t per_warp,
           int blocks, cudaStream_t stream) {
  if (d.vec)
    convert_kernel<E, true><<<blocks, NT, 0, stream>>>(
        static_cast<const E*>(data), static_cast<E*>(out), d, per_warp);
  else
    convert_kernel<E, false><<<blocks, NT, 0, stream>>>(
        static_cast<const E*>(data), static_cast<E*>(out), d, per_warp);
  return (int)cudaGetLastError();
}

}  // namespace

// `esz`: the element size in bytes (1, 2 or 4).  Each warp copies
// `per_warp` consecutive tokens; `blocks` blocks of 8 warps cover them.
extern "C" int repro_convert_layout(const void* data, void* out, Desc d,
                                    int esz, int64_t per_warp, int blocks,
                                    void* stream) {
  if (d.n_tokens < 1 || d.nloops < 1 || d.nloops > MAX_LOOPS || d.eh < 1 ||
      d.ew < 1 || per_warp < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (esz) {
    case 1: return launch<uint8_t>(data, out, d, per_warp, blocks, s);
    case 2: return launch<uint16_t>(data, out, d, per_warp, blocks, s);
    case 4: return launch<uint32_t>(data, out, d, per_warp, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
