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
// it is bound by the bytes of the live KV cache (2.4 MB at granite-moe's
// served decode: 8 rows of ~145 positions, 8 KV heads of 64; 34 MB at
// zamba2-1.2b's: ~516 positions, 32 KV heads): the design's aim is bytes
// in flight.
//
// Design: two launches, no atomics, the same bits call after call.
//   1. split: a block per (span of positions, KV head g, row b). The
//      host cuts S into n_split spans from S, B and Hkv alone (no look
//      at lengths, which would need a host sync), so the grid holds a
//      few blocks per SM. A block whose span starts at or past
//      lengths[b] writes an empty partial (m = -1e30, l = 0) and exits.
//      Four warps walk the span in steps; each lane loads 16 bytes of a
//      key row and of a value row per position (dh / 8 lanes cover a
//      bf16 row, so a warp load covers 32 / (dh / 8) positions), U
//      positions per lane per step, all loads of a step issued before
//      any is used. The dot product over dh takes log2(lanes per row)
//      shuffles. Each lane keeps, for the group's query heads, the
//      running max, normalizer and accumulator of its own positions in
//      f32 registers; lanes are merged by xor shuffles, warps in shared
//      memory in warp order, and the block's (acc, m, l) go to an f32
//      scratch (n_split, B, H, dh + 2).
//   2. merge: a block per (query head, row) sums the partials in split
//      order (skipping empty ones) and normalizes. Launched with
//      programmatic dependent launch, it waits on the split pass only
//      before reading the scratch.
// Products are IEEE f32 (q, k, v converted exactly from their dtype).
#include "common.cuh"

namespace {

constexpr int NW = 4;  // warps per split block
constexpr int U = 4;   // positions per lane per step
constexpr float kNeg = -1e30f;

template <typename T, int DH>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16 B
  static constexpr int CPR = DH / VEC;             // 16-byte chunks per row
  static constexpr int LPR = CPR < 32 ? CPR : 32;  // lanes per row
  static constexpr int NCH = CPR / LPR;            // chunks per lane
  static constexpr int EPL = NCH * VEC;            // elements per lane
  static constexpr int PPW = 32 / LPR;             // positions per warp load
};

// element e of a lane's NCH 16-byte chunks, exactly in f32
template <typename T, int NCH>
__device__ __forceinline__ float elem(const uint4 (&r)[NCH], int e) {
  if constexpr (sizeof(T) == 4) {
    const uint4 v = r[e / 4];
    const uint32_t w = (e & 3) == 0 ? v.x : (e & 3) == 1 ? v.y
                       : (e & 3) == 2 ? v.z : v.w;
    return __uint_as_float(w);
  } else {
    const uint4 v = r[e / 8];
    const int i = (e & 7) >> 1;
    const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T, int DH, int MAXREP>
__global__ void __launch_bounds__(NW * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part, int S, int H, int Hkv, int rep,
                    int span, float scale) {
  using G = Geo<T, DH>;
  constexpr int EPL = G::EPL, NCH = G::NCH, VEC = G::VEC;
  pdl_launch_dependents();  // the merge may launch and wait for us
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sub = lane / G::LPR, c = lane % G::LPR;
  // q's loads are issued before lengths[b] is known, so the two DRAM
  // round trips overlap
  uint4 qraw[MAXREP][NCH];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    const T* qr = q + ((size_t)b * H + g * rep + min(r, rep - 1)) * DH +
                  c * EPL;
#pragma unroll
    for (int n = 0; n < NCH; ++n)
      qraw[r][n] = *reinterpret_cast<const uint4*>(qr + n * VEC);
  }
  const int len = max(0, min(lengths[b], S));
  const int p_begin = split * span, p_end = min(p_begin + span, len);
  float* out = part + ((size_t)(split * gridDim.z + b) * H + g * rep) *
                          (DH + 2);
  if (p_begin >= len) {  // an empty partial: the merge skips it
    if (threadIdx.x < rep) {
      out[threadIdx.x * (DH + 2) + DH] = kNeg;
      out[threadIdx.x * (DH + 2) + DH + 1] = 0.f;
    }
    return;
  }

  float qv[MAXREP][EPL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[r][e] = elem<T, NCH>(qraw[r], e) * scale;
  float m[MAXREP], l[MAXREP], acc[MAXREP][EPL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const size_t stride = (size_t)Hkv * DH;  // between positions
  const size_t base = (size_t)b * S * stride + (size_t)g * DH + c * EPL;
  constexpr int WSTEP = U * G::PPW;        // positions per warp per step
  for (int p0 = p_begin + w * WSTEP; p0 < p_end; p0 += NW * WSTEP) {
    uint4 kr[U][NCH], vr[U][NCH];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * G::PPW + sub;
      ok[u] = p < p_end;
      const size_t at = base + (size_t)p * stride;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        kr[u][n] = ok[u] ? *reinterpret_cast<const uint4*>(k + at + n * VEC)
                         : make_uint4(0u, 0u, 0u, 0u);
        vr[u][n] = ok[u] ? *reinterpret_cast<const uint4*>(v + at + n * VEC)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r >= rep) break;
      float s[U], mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          d = fmaf(qv[r][e], elem<T, NCH>(kr[u], e), d);
#pragma unroll
        for (int off = G::LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = d;
        if (ok[u]) mx = fmaxf(mx, d);
      }
      const float alpha = expf(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u] - mx);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[r][e] = fmaf(p, elem<T, NCH>(vr[u], e), acc[r][e]);
      }
      m[r] = mx;
    }
  }

  // merge the warp's PPW position lanes (xor butterfly: both partners
  // form the same sum, so every lane ends with the same bits)
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
#pragma unroll
    for (int off = G::LPR; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float M = fmaxf(m[r], mo);
      const float a = expf(m[r] - M), bb = expf(mo - M);
      l[r] = l[r] * a + lo * bb;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * a + ao * bb;
      }
      m[r] = M;
    }
  }
  __shared__ float sm_m[NW][MAXREP], sm_l[NW][MAXREP];
  __shared__ float sm_acc[NW][MAXREP][DH];
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (c == 0) {
        sm_m[w][r] = m[r];
        sm_l[w][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[w][r][c * EPL + e] = acc[r][e];
    }
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
    out[r * (DH + 2) + j] = O;
    if (j == 0) {
      out[r * (DH + 2) + DH] = M;
      out[r * (DH + 2) + DH + 1] = L;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                    int H, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t rs = (size_t)gridDim.y * H * (DH + 2);  // between splits
  const float* p = part + ((size_t)b * H + h) * (DH + 2);
  pdl_wait();  // the split pass has finished and its partials are visible
  float M = kNeg;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, p[s * rs + DH]);
  float L = 0.f, O = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float ls = p[s * rs + DH + 1];
    if (ls > 0.f) {  // an empty span's acc was never written
      const float sc = expf(p[s * rs + DH] - M);
      L += ls * sc;
      O += p[s * rs + j] * sc;
    }
  }
  out[((size_t)b * H + h) * DH + j] = from_f32<T>(O / fmaxf(L, 1e-30f));
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v,
              const void* lengths, void* part, void* out, int B, int S,
              int H, int Hkv, int n_split, int span, float scale,
              cudaStream_t s) {
  const int rep = H / Hkv;
  const dim3 grid(n_split, Hkv, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  if (rep <= 2)
    decode_split_kernel<T, DH, 2><<<grid, NW * 32, 0, s>>>(
        qt, kt, vt, lt, pt, S, H, Hkv, rep, span, scale);
  else if (rep <= 8)
    decode_split_kernel<T, DH, 8><<<grid, NW * 32, 0, s>>>(
        qt, kt, vt, lt, pt, S, H, Hkv, rep, span, scale);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_pdl(&decode_merge_kernel<T, DH>, dim3(H, B), dim3(DH), 0, s,
                   static_cast<const float*>(pt), static_cast<T*>(out), H,
                   n_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* part, void* out, int B, int S, int H, int Hkv, int dh,
           int n_split, int span, float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_dh<T, 32>(q, k, v, lengths, part, out, B, S, H, Hkv, n_split, span, scale, s);
    case 64: return launch_dh<T, 64>(q, k, v, lengths, part, out, B, S, H, Hkv, n_split, span, scale, s);
    case 128: return launch_dh<T, 128>(q, k, v, lengths, part, out, B, S, H, Hkv, n_split, span, scale, s);
    case 256: return launch_dh<T, 256>(q, k, v, lengths, part, out, B, S, H, Hkv, n_split, span, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, dh), k / v (B, S, Hkv, dh) in one dtype, 16-byte aligned;
// lengths (B,) int32; part an f32 scratch of n_split * B * H * (dh + 2);
// n_split spans of `span` positions cover S.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* part, void* out,
                                int B, int S, int H, int Hkv, int dh,
                                int n_split, int span, float scale,
                                int dtype, void* stream) {
  if (B < 1 || n_split < 1 || span < 1 || (long long)n_split * span < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, lengths, part, out, B, S, H, Hkv, dh,
                         n_split, span, scale, s);
  return launch<__nv_bfloat16>(q, k, v, lengths, part, out, B, S, H, Hkv,
                               dh, n_split, span, scale, s);
}
