// decode_attention's kernels at head dim 16, f32 and bf16 (decode_attn.cuh).
#include "decode_attn.cuh"

DECODE_ATTN_HEAD_DIM(16)
