// Paged attention (K1 decode, K8 verify, and K9a / K9b over int8 / fp8
// code pools) at head dim 128 (llama3, the Qwen decoders at 128): the entry
// points of paged_attention.cuh's kernel (which documents it).  Each other
// head dim builds in a library of its own, so that the sources compile side
// by side: 64 in paged_attention_64.cu, 80 in paged_attention_80.cu, and
// gemma3's 320 in paged_attention_320.cu (full-precision pools) and
// paged_attention_q320.cu (codes).
#include "paged_attention.cuh"

REPRO_PAGED_WINDOW(repro_paged_window_f32, float, 128)
REPRO_PAGED_WINDOW(repro_paged_window_bf16, __nv_bfloat16, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_f32_i8, float, int8_t, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_bf16_i8, __nv_bfloat16, int8_t, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_f32_fp8, float, __nv_fp8_e4m3, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_bf16_fp8, __nv_bfloat16,
                     __nv_fp8_e4m3, 128)
