// decode_attention's e4m3 instance at head dim 64: bf16 q over a
// float8_e4m3fn cache (decode_attn.cuh).
#include "decode_attn.cuh"

DECODE_ATTN_E4M3_HEAD_DIM(64)
