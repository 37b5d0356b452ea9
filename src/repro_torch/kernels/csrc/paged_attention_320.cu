// Paged attention (K1 decode, K8 verify) at gemma3's head dim 320, over
// full-precision pools, with or without its sliding window: the entry
// points of paged_attention.cuh's kernel at D = 320, in a library of their
// own so that they compile beside paged_attention.cu's instances (its code
// twins are paged_attention_q320.cu's).
#include "paged_attention.cuh"

REPRO_PAGED_WINDOW(repro_paged_window_d320_f32, float, 320)
REPRO_PAGED_WINDOW(repro_paged_window_d320_bf16, __nv_bfloat16, 320)
