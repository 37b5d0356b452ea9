// streamed_ffn (K4) and streamed_mlp (K6) at full precision: the entry
// points of streamed_ffn.cuh's kernels (which documents them); their int8
// twins (K10b, K10c) are streamed_ffn_w8.cu's.
#include "streamed_ffn.cuh"

REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_mma_bf16, false, true, true, true)
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_gelu_mma_bf16, false, true, false,
                       false)
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_gelu_norm_mma_bf16, false, true,
                       true, false)
REPRO_STREAMED_FFN_MMA(repro_streamed_mlp_mma_bf16, false, false, false, false)

extern "C" int repro_streamed_ffn_f32(const void* x, const void* nscale,
                                      const void* wg, const void* wu,
                                      const void* wd, void* out, void* part,
                                      int t, int d, int f, int tile,
                                      float eps, void* stream) {
  return launch<float, float, true, true, true>(
      x, nscale, wg, wu, wd, kNoScales, out, part, t, d, f, tile, eps,
      stream);
}

// The GELU GLU with the norm folded in (gemma3).
extern "C" int repro_streamed_ffn_gelu_norm_f32(const void* x,
                                                const void* nscale,
                                                const void* wg, const void* wu,
                                                const void* wd, void* out,
                                                void* part, int t, int d,
                                                int f, int tile, float eps,
                                                void* stream) {
  return launch<float, float, true, true, false>(
      x, nscale, wg, wu, wd, kNoScales, out, part, t, d, f, tile, eps,
      stream);
}

extern "C" int repro_streamed_mlp_f32(const void* x, const void* wu,
                                      const void* wd, void* out, void* part,
                                      int t, int d, int f, int tile,
                                      void* stream) {
  return launch<float, float, false, false, false>(
      x, nullptr, nullptr, wu, wd, kNoScales, out, part, t, d, f, tile, 0.f,
      stream);
}

// The GELU GLU without a folded norm (zamba2's shared block): no nscale.
extern "C" int repro_streamed_ffn_gelu_f32(const void* x, const void* wg,
                                           const void* wu, const void* wd,
                                           void* out, void* part, int t,
                                           int d, int f, int tile,
                                           void* stream) {
  return launch<float, float, true, false, false>(
      x, nullptr, wg, wu, wd, kNoScales, out, part, t, d, f, tile, 0.f,
      stream);
}
