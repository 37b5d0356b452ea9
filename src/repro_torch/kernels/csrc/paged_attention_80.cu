// Paged attention (K1 decode, K8 verify, and K9a / K9b over int8 / fp8
// code pools) at head dim 80 (zamba2's shared block): the entry points of
// paged_attention.cuh's kernel at that head dim, in a library of their own
// so that they compile beside the other head dims' (128 in
// paged_attention.cu, 64 in paged_attention_64.cu, 320 in
// paged_attention_320.cu and paged_attention_q320.cu).
#include "paged_attention.cuh"

REPRO_PAGED_WINDOW(repro_paged_window_d80_f32, float, 80)
REPRO_PAGED_WINDOW(repro_paged_window_d80_bf16, __nv_bfloat16, 80)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d80_f32_i8, float, int8_t, 80)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d80_bf16_i8, __nv_bfloat16, int8_t,
                     80)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d80_f32_fp8, float, __nv_fp8_e4m3,
                     80)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d80_bf16_fp8, __nv_bfloat16,
                     __nv_fp8_e4m3, 80)
