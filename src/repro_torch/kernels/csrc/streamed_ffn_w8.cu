// The weight-only int8 twins of streamed_ffn and streamed_mlp (K10b,
// K10c): the entry points of streamed_ffn.cuh's kernels over int8 codes,
// in a library of their own so that they compile beside streamed_ffn.cu's
// full-precision instances.
#include "streamed_ffn.cuh"

REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_w8_mma_bf16, true, true, true, true)
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_gelu_w8_mma_bf16, true, true, false,
                       false)
REPRO_STREAMED_FFN_MMA(repro_streamed_mlp_w8_mma_bf16, true, false, false,
                       false)
REPRO_STREAMED_FFN_MMA(repro_streamed_ffn_gelu_norm_w8_mma_bf16, true, true,
                       true, false)

// The int8 twins: wg/wu/wd int8 codes; gs/us float32 [F], ds float32 [D].
extern "C" int repro_streamed_ffn_w8_f32(const void* x, const void* nscale,
                                         const void* wg, const void* gs,
                                         const void* wu, const void* us,
                                         const void* wd, const void* ds,
                                         void* out, void* part, int t, int d,
                                         int f, int tile, float eps,
                                         void* stream) {
  return launch<float, int8_t, true, true, true>(
      x, nscale, wg, wu, wd, scales(gs, us, ds), out, part, t, d, f, tile,
      eps, stream);
}

extern "C" int repro_streamed_mlp_w8_f32(const void* x, const void* wu,
                                         const void* us, const void* wd,
                                         const void* ds, void* out,
                                         void* part, int t, int d, int f,
                                         int tile, void* stream) {
  return launch<float, int8_t, false, false, false>(
      x, nullptr, nullptr, wu, wd, scales(nullptr, us, ds), out, part, t, d,
      f, tile, 0.f, stream);
}

extern "C" int repro_streamed_ffn_gelu_w8_f32(const void* x, const void* wg,
                                              const void* gs, const void* wu,
                                              const void* us, const void* wd,
                                              const void* ds, void* out,
                                              void* part, int t, int d, int f,
                                              int tile, void* stream) {
  return launch<float, int8_t, true, false, false>(
      x, nullptr, wg, wu, wd, scales(gs, us, ds), out, part, t, d, f, tile,
      0.f, stream);
}

// The GELU GLU with the norm folded in (gemma3).
extern "C" int repro_streamed_ffn_gelu_norm_w8_f32(
    const void* x, const void* nscale, const void* wg, const void* gs,
    const void* wu, const void* us, const void* wd, const void* ds,
    void* out, void* part, int t, int d, int f, int tile, float eps,
    void* stream) {
  return launch<float, int8_t, true, true, false>(
      x, nscale, wg, wu, wd, scales(gs, us, ds), out, part, t, d, f, tile,
      eps, stream);
}
