// Paged attention (K1 decode, K8 verify, and K9a / K9b over int8 / fp8
// code pools) at head dims 64, 80 and 128: the entry points of
// paged_attention.cuh's kernel (which documents it).  Head dim 320
// (gemma3) is built apart, in paged_attention_320.cu (full-precision
// pools) and paged_attention_q320.cu (codes).
#include "paged_attention.cuh"

REPRO_PAGED_WINDOW(repro_paged_window_f32, float, 64, 80, 128)
REPRO_PAGED_WINDOW(repro_paged_window_bf16, __nv_bfloat16, 64, 80, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_f32_i8, float, int8_t, 64, 80, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_bf16_i8, __nv_bfloat16, int8_t, 64,
                     80, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_f32_fp8, float, __nv_fp8_e4m3, 64,
                     80, 128)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_bf16_fp8, __nv_bfloat16,
                     __nv_fp8_e4m3, 64, 80, 128)
