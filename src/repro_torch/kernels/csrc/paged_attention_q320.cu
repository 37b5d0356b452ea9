// Paged attention over int8 / fp8-e4m3 code pools (K9a decode, K9b verify)
// at gemma3's head dim 320, with or without its sliding window: the entry
// points of paged_attention.cuh's kernel at D = 320 over codes, in a
// library of their own so that they compile beside paged_attention.cu's
// and paged_attention_320.cu's instances.
#include "paged_attention.cuh"

REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d320_f32_i8, float, int8_t, 320)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d320_bf16_i8, __nv_bfloat16, int8_t,
                     320)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d320_f32_fp8, float, __nv_fp8_e4m3,
                     320)
REPRO_PAGED_WINDOW_Q(repro_paged_window_q_d320_bf16_fp8, __nv_bfloat16,
                     __nv_fp8_e4m3, 320)
