// decode_attention's C entry point: checks the plan and calls the
// instances of the head dim (decode_attn_dh*.cu). The kernels and their
// design are in decode_attn.cuh.
#include "decode_attn.cuh"

template <typename T>
int step_of(int dh) {
  switch (dh) {
    case 16: return block_step<T, 16>();
    case 32: return block_step<T, 32>();
    case 64: return block_step<T, 64>();
    case 80: return block_step<T, 80>();
    case 128: return block_step<T, 128>();
    case 256: return block_step<T, 256>();
    default: return 0;
  }
}

// The span unit of the split plan: positions a split block walks per
// step at head dim dh in dtype (the cache's), 0 where no instance exists.
// The host cuts a row's positions into spans of whole steps
// (decode_attn.py split_plan); this is the one place the lane geometry
// is known.
extern "C" int decode_attention_step(int dh, int dtype) {
  switch (dtype) {
    case kF32: return step_of<float>(dh);
    case kBF16: return step_of<__nv_bfloat16>(dh);
    case kE4M3:
      return dh == 64    ? block_step<__nv_fp8_e4m3, 64>()
             : dh == 128 ? block_step<__nv_fp8_e4m3, 128>()
                         : 0;
    default: return 0;
  }
}

// q (B, T, H, dh), k / v (B, C, Hkv, dh), 16-byte aligned, in one dtype
// (kF32, kBF16) or, for kE4M3, q in bf16 and k / v in float8_e4m3fn; the
// output in q's dtype;
// cur_len (B,) int32, query t of row b at position cur_len[b] + shift + t;
// window 0 for a full cache, else 1 <= window <= C positions seen per
// query; the T * H / Hkv queries of a KV head in n_qt tiles of nq <= 8;
// part an f32 scratch of n_split * B * T * H * (dh + 2); n_split spans of
// `span` positions, a whole number of decode_attention_step's, cover the
// C slots (window: the window + T - 1 positions) a row's queries see.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cur_len, void* part, void* out,
                                int B, int C, int T, int H, int Hkv, int dh,
                                int window, int shift, int nq, int n_qt,
                                int n_split, int span, float scale,
                                int dtype, void* stream) {
  const long long seen = window > 0 ? (long long)window + T - 1 : C;
  const int step = decode_attention_step(dh, dtype);
  if (B < 1 || T < 1 || T > C || Hkv < 1 || H % Hkv || window < 0 ||
      window > C || nq < 1 || nq > 8 || n_qt < 1 ||
      (long long)nq * n_qt < (long long)T * (H / Hkv) || n_split < 1 ||
      span < 1 || step < 1 || span % step ||
      (long long)n_split * span < seen)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, cur_len, part, out, B, C, T, H, Hkv, window,
                     shift, nq, n_qt, n_split, span, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kE4M3)
    return dh == 64 ? decode_attn_e4m3_dh64(a, s)
                    : decode_attn_e4m3_dh128(a, s);  // step_of refused others
  switch (dh) {
    case 16: return decode_attn_dh16(a, dtype, s);
    case 32: return decode_attn_dh32(a, dtype, s);
    case 64: return decode_attn_dh64(a, dtype, s);
    case 80: return decode_attn_dh80(a, dtype, s);
    case 128: return decode_attn_dh128(a, dtype, s);
    case 256: return decode_attn_dh256(a, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
