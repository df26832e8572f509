// decode_attention — flash-decode GQA: one query per row against its KV
// cache, masked to lengths[b], with an online softmax.
//
// Replaces the Pallas kernel `decode_attention` (body `_kernel`) of
// src/repro/kernels/decode_attn.py:
//     out[b, h] = softmax(q[b, h] . k[b, :len] / sqrt(dh)) v[b, :len]
// with q (B, H, dh), k and v (B, S, Hkv, dh), query head h reading KV
// head h / (H / Hkv). A row with lengths == 0 gives zeros, not NaN (the
// Pallas kernel's 1e-30 floor on the normalizer).
//
// What bounds it on the H100: each cached key and value is used by only
// the H / Hkv query heads of its group, about 2 operations per byte, so
// it is bound by the bytes of the live KV cache.
//
// Design: one block per (KV head g, row b), four warps. Each warp walks
// its share of the positions 0 .. lengths[b] - 1 only — never the
// padded S — four positions at a time so several loads are in flight,
// each lane holding dh / 32 contiguous elements of a key/value row
// (one coalesced row per warp). A warp keeps, for the group's query
// heads, the running max, normalizer and accumulator in f32 registers;
// the four warps' states are merged in shared memory in warp order at
// the end, so the result does not depend on scheduling.
#include "common.cuh"

namespace {

constexpr int NW = 4;  // warps per block
constexpr int U = 4;   // positions per warp per step
constexpr float kNeg = -1e30f;

template <typename T, int DPL, int MAXREP>
__global__ void __launch_bounds__(NW * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int S, int H, int Hkv, int rep,
                   float scale) {
  constexpr int DH = DPL * 32;
  const int g = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int len = max(0, min(lengths[b], S));

  float qv[MAXREP][DPL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      qv[r][i] = r < rep ? to_f32(q[((size_t)b * H + g * rep + r) * DH +
                                    lane * DPL + i]) * scale
                         : 0.f;

  float m[MAXREP], l[MAXREP], acc[MAXREP][DPL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const size_t stride = (size_t)Hkv * DH;  // between positions
  const size_t base = (size_t)b * S * stride + (size_t)g * DH + lane * DPL;
  for (int p0 = w * U; p0 < len; p0 += NW * U) {
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = p0 + u < len;
      const size_t at = base + (size_t)(p0 + u) * stride;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[u][i] = ok ? to_f32(k[at + i]) : 0.f;
        vr[u][i] = ok ? to_f32(v[at + i]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r >= rep) continue;
      float s[U];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qv[r][i] * kr[u][i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = __shfl_sync(0xffffffffu, part, 0);  // one value per warp
        if (p0 + u < len) mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p0 + u >= len) continue;
        const float p = expf(s[u] - mx);
        l[r] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += p * vr[u][i];
      }
      m[r] = mx;
    }
  }

  __shared__ float sm_m[NW][MAXREP], sm_l[NW][MAXREP];
  __shared__ float sm_acc[NW][MAXREP][DH];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (lane == 0) {
      sm_m[w][r] = m[r];
      sm_l[w][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[w][r][lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * DH; idx += NW * 32) {
    const int r = idx / DH, j = idx % DH;
    float M = kNeg;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float sc = expf(sm_m[ww][r] - M);
      L += sm_l[ww][r] * sc;
      O += sm_acc[ww][r][j] * sc;
    }
    out[((size_t)b * H + g * rep + r) * DH + j] =
        from_f32<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int DPL>
int launch_dpl(const void* q, const void* k, const void* v,
               const void* lengths, void* out, int B, int S, int H, int Hkv,
               float scale, cudaStream_t s) {
  const int rep = H / Hkv;
  const dim3 grid(Hkv, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lengths);
  T* ot = static_cast<T*>(out);
  if (rep <= 2)
    decode_attn_kernel<T, DPL, 2><<<grid, NW * 32, 0, s>>>(
        qt, kt, vt, lt, ot, S, H, Hkv, rep, scale);
  else if (rep <= 8)
    decode_attn_kernel<T, DPL, 8><<<grid, NW * 32, 0, s>>>(
        qt, kt, vt, lt, ot, S, H, Hkv, rep, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int H, int Hkv, int dh, float scale,
           cudaStream_t s) {
  switch (dh) {
    case 32: return launch_dpl<T, 1>(q, k, v, lengths, out, B, S, H, Hkv, scale, s);
    case 64: return launch_dpl<T, 2>(q, k, v, lengths, out, B, S, H, Hkv, scale, s);
    case 128: return launch_dpl<T, 4>(q, k, v, lengths, out, B, S, H, Hkv, scale, s);
    case 256: return launch_dpl<T, 8>(q, k, v, lengths, out, B, S, H, Hkv, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int S,
                                int H, int Hkv, int dh, float scale,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, lengths, out, B, S, H, Hkv, dh, scale, s);
  return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, H, Hkv, dh,
                               scale, s);
}
