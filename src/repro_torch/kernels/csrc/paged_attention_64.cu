// Paged attention (K1 decode, K8 verify, and K9a / K9b over int8 / fp8
// code pools) at head dim 64 (gpt2, granite-moe, qwen3, qwen1.5): the
// entry points of paged_attention.cuh's kernel at that head dim, in a
// library of their own so that they compile beside the other head dims'
// (128 in paged_attention.cu, 80 in paged_attention_80.cu, 320 in
// paged_attention_320.cu and paged_attention_q320.cu).
#include "paged_attention.cuh"

REPRO_PAGED_WINDOW(repro_paged_window_d64_f32, float, 64)
REPRO_PAGED_WINDOW(repro_paged_window_d64_bf16, __nv_bfloat16, 64)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d64_f32_i8, float, int8_t, 64)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d64_bf16_i8, __nv_bfloat16, int8_t,
                     64)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d64_f32_fp8, float, __nv_fp8_e4m3,
                     64)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d64_bf16_fp8, __nv_bfloat16,
                     __nv_fp8_e4m3, 64)
