// decode_attention — flash-decode GQA: the T new queries of each row
// against its KV cache, with an online softmax.
//
// Replaces the Pallas kernel `decode_attention` (body `_kernel`) of
// src/repro/kernels/decode_attn.py, and takes the contract of the JAX
// package's `cached_attention` (src/repro/models/attention.py:276):
//     out[b, t, h] = softmax(q[b, t, h] . k[b, live] / sqrt(dh)) v[b, live]
// with q (B, T, H, dh), k and v (B, C, Hkv, dh), query head h reading KV
// head h / (H / Hkv). Query t of row b sits at position
// cur_len[b] + shift + t. In a full cache (window 0) it sees slots
// [0, min(cur + t + 1, C)), so a verify block is causal and the T = 1
// case is the Pallas kernel's lengths = cur + 1 (shift = -1 takes
// lengths directly). Under a rolling window (1 <= window <= C) it sees
// the positions of the last `window` up to its own, none below 0,
// position p in slot p mod C: the set the JAX mask keeps (slot c holds
// the latest position p <= cur + t with p = c mod C, live iff p >= 0 and
// p > cur + t - window). A query that sees nothing gives zeros, not NaN
// (the Pallas kernel's 1e-30 floor).
//
// What bounds it on the H100: each cached key and value is used by only
// the T * H / Hkv queries of its group, about 2 T operations per byte, so
// it is bound by the bytes of the live KV cache (2.4 MB at granite-moe's
// served decode: 8 rows of ~145 positions, 8 KV heads of 64; 34 MB at
// zamba2-1.2b's: ~516 positions, 32 KV heads; 42 MB at h2o-danube-1.8b's:
// 4 rows of a 4096-position window, 8 KV heads of 80): the design's aim
// is bytes in flight, each live position read once per (row, KV head,
// query tile).
//
// Design: two launches, no atomics, the same bits call after call.
//   1. split: a block per (span of positions, KV head g x query tile,
//      row b). A query tile is up to 8 of the group's T * H / Hkv
//      queries, (t, r) in t-major order, held in registers; T = 1 with
//      H / Hkv <= 8 is one tile. The host cuts the C slots (a rolling
//      window: the window + T - 1 positions) a row's queries can see
//      into n_split spans from C, T, B, Hkv and the window alone (no look
//      at cur_len, which would need a host sync), so the grid holds a
//      few blocks per SM. Spans walk positions from the row's first live
//      one, so a rolling cache's block touches only the window. A block
//      whose span holds no position live for any of its queries writes
//      empty partials (m = -1e30, l = 0) and exits.
//      Four warps walk the span in steps; each lane loads 16 bytes of a
//      key row and of a value row per position (a bf16 row's dh / 8
//      chunks, rounded up to a power of two of lanes: head dim 80 puts
//      10 chunks on 16 lanes, 6 of them dead; a warp load covers 32 /
//      lanes positions), U = 4 positions per lane per step (2 where 4
//      would not fit in the registers beside the tile's queries: f32 at
//      head dim 256 with 8 of them), all loads of a step issued before
//      any is used. The dot product over dh takes
//      log2(lanes per row) shuffles. Each lane keeps, for the tile's queries, the running
//      max, normalizer and accumulator of its own live positions in f32
//      registers; lanes are merged by xor shuffles, warps in shared
//      memory in warp order, and the block's (acc, m, l) go to an f32
//      scratch (n_split, B, T * H, dh + 2).
//   2. merge: a block per (query, row) sums the partials in a fixed
//      order (skipping empty ones), four groups of threads over the
//      spans, and normalizes. Launched with programmatic dependent
//      launch, it waits on the split pass only before reading the
//      scratch.
// Products are IEEE f32 (q, k, v converted exactly from their dtype).
//
// The e4m3 instance (head dims 64 and 128, the float8 caches the JAX
// package's planning experiments ask for: musicgen-large and
// qwen3-moe-235b-a22b at decode_32k) reads a cache of
// torch.float8_e4m3fn with q and the output in bf16: what
// decode_attention_cached_plain computes by dequantizing the cache to
// bf16 first, which is exact (every e4m3 value is a bf16 value, and an
// f32 one). The cache is never copied: each lane loads 8 bytes of a key
// or value row (8 elements) and widens them in registers, a pair at a
// time, with cvt.rn.f16x2.e4m3x2 (NaN stays NaN) and an exact f16 -> f32
// conversion. The scores, softmax and merge are the bf16 instance's.
// Loads are 8 bytes and not 16 because a lane holding 16 elements would
// hold 16 q and 16 accumulator floats per query, 256 registers at a tile
// of 8 queries (qwen3-moe-235b's 16 queries per KV head), past the 255 a
// thread has. So a lane covers as many elements as in bf16, the lane
// geometry and block_step are bf16's at the same head dim (64: 8 lanes a
// row, 64 positions a block step; 128: 16 lanes, 32 positions), and
// split_plan gives the same spans; the bytes a position costs halve.
#pragma once
#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

// one call's operands and plan (see the entry point below); window 0 is
// a full cache
struct DecodeArgs {
  const void *q, *k, *v, *cur_len;
  void *part, *out;
  int B, C, nt, H, Hkv, window, shift, nq, n_qt, n_split, span;
  float scale;
};

namespace {

constexpr int NW = 4;  // warps per split block
constexpr int U = 4;   // positions per lane per step
constexpr float kNeg = -1e30f;

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// A row of DH elements is CPR 16-byte chunks, read by a group of LPR
// lanes, a power of two so that the xor shuffles stay inside the group.
// When CPR is not a power of two (head dim 80: 10 chunks in bf16, 20 in
// f32) the group is padded to the next one and its last LPR - CPR lanes
// are dead: they load nothing, add 0 to the dot products and store no
// accumulator (PAD).
// A lane's load (a chunk) is 16 bytes of f32 or bf16, 8 bytes of e4m3.
template <typename T, int DH>
struct Geo {
  using Chunk =
      typename std::conditional<sizeof(T) == 1, uint2, uint4>::type;
  static constexpr int CB = (int)sizeof(Chunk);    // bytes per chunk
  static constexpr int VEC = CB / (int)sizeof(T);  // elements per chunk
  static constexpr int CPR = DH / VEC;             // chunks per row
  static constexpr int LPR = CPR < 32 ? pow2_at_least(CPR) : 32;  // lanes
  static constexpr int NCH = CPR / LPR > 0 ? CPR / LPR : 1;  // chunks/lane
  static constexpr int EPL = NCH * VEC;            // elements per lane
  static constexpr int PPW = 32 / LPR;             // positions per warp load
  static constexpr bool PAD = LPR * NCH != CPR;    // dead lanes in a group
  static_assert(DH % VEC == 0, "a row is whole chunks");
  static_assert(!PAD || NCH == 1, "padded groups hold one chunk a lane");
};

// Positions a lane loads per step: U, or U / 2 where the tile's q and
// accumulators (2 MAXQ EPL floats) and U steps of key and value chunks
// (2 U NCH CB / 4 registers) would pass 160 of the 255 registers, the rest
// going to addresses and the softmax: at f32, head dim 256, 8 queries
// (128 + 64) ptxas spilled; bf16 there (128 + 32) does not. The span
// unit (block_step) stays at U, a multiple of U / 2.
template <typename T, int DH, int MAXQ>
__host__ __device__ constexpr int lane_positions() {
  using G = Geo<T, DH>;
  return 2 * MAXQ * G::EPL + 2 * U * G::NCH * (G::CB / 4) > 160 ? U / 2 : U;
}

// element e of a lane's NCH chunks of T, exactly in f32 (an e4m3 pair is
// widened by one cvt, which the compiler shares between its two elements)
template <typename T, int NCH, typename C>
__device__ __forceinline__ float elem(const C (&r)[NCH], int e) {
  if constexpr (sizeof(T) == 4) {
    const uint4 v = r[e / 4];
    const uint32_t w = (e & 3) == 0 ? v.x : (e & 3) == 1 ? v.y
                       : (e & 3) == 2 ? v.z : v.w;
    return __uint_as_float(w);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 v = r[e / 8];
    const int i = (e & 7) >> 1;
    const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    const uint2 v = r[e / 8];
    const uint32_t w = (e & 4) ? v.y : v.x;
    const __nv_fp8x2_storage_t pair =
        (__nv_fp8x2_storage_t)((e & 2) ? (w >> 16) : (w & 0xffffu));
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
    return (e & 1) ? f.y : f.x;
  }
}

template <typename C>
__device__ __forceinline__ C zero_chunk() {
  return C{};
}

// Query t of a row at position cur + t sees positions [lo, hi]: under a
// rolling window [cur + t - window + 1, cur + t], none below 0; in a full
// cache [0, min(cur + t, C - 1)].
template <bool WIN>
__device__ __forceinline__ int live_lo(int cur, int t, int window) {
  return WIN ? max(0, cur + t - window + 1) : 0;
}
template <bool WIN>
__device__ __forceinline__ int live_hi(int cur, int t, int C) {
  return WIN ? cur + t : min(cur + t, C - 1);
}

// TQ is the type of q and of the output, T the cache's (TQ = T, or bf16
// over an e4m3 cache).
// WIN: a rolling window (positions wrap, slot = position mod C); else a
// full cache, where query t sees slots [0, min(cur + t, C - 1)] and a
// position is its slot. ONE_T: every query of a tile has the same t
// (T = 1, or tiles that divide H / Hkv), so the span, already cut to the
// tile's live range, is live for all of them and no per-query check is
// compiled in. Two-query tiles (every decode step of granite-moe and
// zamba2) fit in 128 registers; asking for 4 blocks per SM keeps ptxas
// from spilling the f32 instances at 72-80 registers.
template <typename TQ, typename T, int DH, int MAXQ, bool WIN, bool ONE_T>
__global__ void __launch_bounds__(NW * 32, MAXQ <= 2 ? 4 : 1)
decode_split_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cur_len,
                    float* __restrict__ part, int C, int nt, int H, int Hkv,
                    int rep, int nq, int n_qt, int window, int shift,
                    int span, float scale) {
  using G = Geo<T, DH>;
  using Chunk = typename G::Chunk;
  constexpr int EPL = G::EPL, NCH = G::NCH, VEC = G::VEC;
  // q's EPL elements of a lane: QCH 16-byte chunks of TQ
  constexpr int QVEC = 16 / (int)sizeof(TQ), QCH = EPL / QVEC;
  static_assert(EPL % QVEC == 0, "a lane's q is whole 16-byte chunks");
  pdl_launch_dependents();  // the merge may launch and wait for us
  const int split = blockIdx.x, b = blockIdx.z;
  // one tile per KV head (every T = 1 call with H / Hkv <= 8) skips the
  // divisions, which would sit on each block's path to its first loads
  const int g = n_qt == 1 ? blockIdx.y : blockIdx.y / n_qt;
  const int i0 = n_qt == 1 ? 0 : (blockIdx.y - g * n_qt) * nq;
  const int nqi = min(nq, nt * rep - i0);  // queries of this tile
  const int TH = nt * H;                   // query rows per batch row
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sub = lane / G::LPR, c = lane % G::LPR;
  const bool lane_live = !G::PAD || c < G::CPR;  // holds part of a row
  const int t_lo = i0 == 0 ? 0 : i0 / rep;
  const int t_hi = ONE_T ? t_lo : (i0 + nqi - 1) / rep;
  // query i = t * rep + r of KV head g is row t * H + g * rep + r of the
  // T * H; q's loads are issued before cur_len[b] is known, so the two
  // DRAM round trips overlap
  uint4 qraw[MAXQ][QCH];
  int tq[MAXQ];  // each query's offset t in the verify block
#pragma unroll
  for (int j = 0; j < MAXQ; ++j) {
    const int i = i0 + min(j, nqi - 1);
    tq[j] = ONE_T ? t_lo : i / rep;
    const int row = tq[j] * H + g * rep + (i - tq[j] * rep);
    const TQ* qr = q + ((size_t)b * TH + row) * DH + c * EPL;
#pragma unroll
    for (int n = 0; n < QCH; ++n)
      qraw[j][n] = lane_live ? *reinterpret_cast<const uint4*>(qr + n * QVEC)
                             : make_uint4(0u, 0u, 0u, 0u);
  }
  const int cur = cur_len[b] + shift;
  // spans start at the row's first live position
  const int first = live_lo<WIN>(cur, 0, window);
  const int p_begin = max(first + split * span,
                          live_lo<WIN>(cur, t_lo, window));
  const int p_end = min(first + (split + 1) * span,
                        live_hi<WIN>(cur, t_hi, C) + 1);
  float* out = part + ((size_t)split * gridDim.z + b) * TH * (DH + 2);
  if (p_begin >= p_end) {  // empty partials: the merge skips them
    if (threadIdx.x < nqi) {
      const int i = i0 + threadIdx.x, t = ONE_T ? t_lo : i / rep;
      float* o = out + (t * H + g * rep + (i - t * rep)) * (DH + 2);
      o[DH] = kNeg;
      o[DH + 1] = 0.f;
    }
    return;
  }

  float qv[MAXQ][EPL];
#pragma unroll
  for (int j = 0; j < MAXQ; ++j)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[j][e] = elem<TQ, QCH>(qraw[j], e) * scale;
  float m[MAXQ], l[MAXQ], acc[MAXQ][EPL];
#pragma unroll
  for (int j = 0; j < MAXQ; ++j) {
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }

  const size_t stride = (size_t)Hkv * DH;  // between slots
  const size_t base = (size_t)b * C * stride + (size_t)g * DH + c * EPL;
  // under a window position p lives in slot p mod C; a span holds at
  // most window + T - 1 <= C + T - 1 positions and T <= C, so two
  // subtractions wrap any slot of it
  const int slot_begin = !WIN || p_begin < C ? p_begin : p_begin % C;
  constexpr int UL = lane_positions<T, DH, MAXQ>();
  constexpr int WSTEP = UL * G::PPW;  // positions per warp per step
  for (int p0 = p_begin + w * WSTEP; p0 < p_end; p0 += NW * WSTEP) {
    Chunk kr[UL][NCH], vr[UL][NCH];
    int pos[UL];
    bool ok[UL];
#pragma unroll
    for (int u = 0; u < UL; ++u) {
      pos[u] = p0 + u * G::PPW + sub;
      ok[u] = pos[u] < p_end;
      int slot = pos[u];
      if constexpr (WIN) {
        slot = slot_begin + (pos[u] - p_begin);
        slot -= slot >= C ? C : 0;
        slot -= slot >= C ? C : 0;
      }
      const size_t at = base + (size_t)slot * stride;
      const bool ld = ok[u] && lane_live;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        kr[u][n] = ld ? *reinterpret_cast<const Chunk*>(k + at + n * VEC)
                      : zero_chunk<Chunk>();
        vr[u][n] = ld ? *reinterpret_cast<const Chunk*>(v + at + n * VEC)
                      : zero_chunk<Chunk>();
      }
    }
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) {
      if (j >= nqi) break;
      const int lo = live_lo<WIN>(cur, tq[j], window);
      const int hi = live_hi<WIN>(cur, tq[j], C);
      float s[UL], mx = m[j];
      bool live[UL];
#pragma unroll
      for (int u = 0; u < UL; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          d = fmaf(qv[j][e], elem<T, NCH>(kr[u], e), d);
#pragma unroll
        for (int off = G::LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = d;
        live[u] = ONE_T ? ok[u] : ok[u] && pos[u] >= lo && pos[u] <= hi;
        if (live[u]) mx = fmaxf(mx, d);
      }
      const float alpha = expf(m[j] - mx);
      l[j] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= alpha;
#pragma unroll
      for (int u = 0; u < UL; ++u) {
        if (!live[u]) continue;
        const float p = expf(s[u] - mx);
        l[j] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[j][e] = fmaf(p, elem<T, NCH>(vr[u], e), acc[j][e]);
      }
      m[j] = mx;
    }
  }

  // merge the warp's PPW position lanes (xor butterfly: both partners
  // form the same sum, so every lane ends with the same bits)
#pragma unroll
  for (int j = 0; j < MAXQ; ++j) {
#pragma unroll
    for (int off = G::LPR; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float M = fmaxf(m[j], mo);
      const float a = expf(m[j] - M), bb = expf(mo - M);
      l[j] = l[j] * a + lo * bb;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
        acc[j][e] = acc[j][e] * a + ao * bb;
      }
      m[j] = M;
    }
  }
  __shared__ float sm_m[NW][MAXQ], sm_l[NW][MAXQ];
  __shared__ float sm_acc[NW][MAXQ][DH];
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) {
      if (c == 0) {
        sm_m[w][j] = m[j];
        sm_l[w][j] = l[j];
      }
      if (lane_live) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[w][j][c * EPL + e] = acc[j][e];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nqi * DH; idx += NW * 32) {
    const int j = idx / DH, x = idx % DH;
    float M = kNeg;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][j]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float sc = expf(sm_m[ww][j] - M);
      L += sm_l[ww][j] * sc;
      O += sm_acc[ww][j][x] * sc;
    }
    const int i = i0 + j, t = ONE_T ? t_lo : i / rep;
    float* o = out + (t * H + g * rep + (i - t * rep)) * (DH + 2);
    o[x] = O;
    if (x == 0) {
      o[DH] = M;
      o[DH + 1] = L;
    }
  }
}

// The merge: a block per (query, row) of DH x kMergeGroups threads. The
// spans' (m, l) go to shared memory in one parallel pass; then group g
// sums the partials of spans g, g + kMergeGroups, ... in order, with all
// its loads independent (an empty span's acc, never written, is loaded
// and then dropped by a select), and the groups are added in group
// order: a fixed order, so the same bits every call.
constexpr int kMergeGroups = 4;

template <typename T, int DH>
__global__ void __launch_bounds__(DH * kMergeGroups)
decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                    int TH, int n_split) {
  extern __shared__ float sm[];  // m[n_split], l[n_split], o[G][DH], L[G]
  float* sm_m = sm;
  float* sm_l = sm + n_split;
  float* sm_o = sm + 2 * n_split;
  float* sm_L = sm_o + kMergeGroups * DH;
  const int h = blockIdx.x, b = blockIdx.y;
  const int j = threadIdx.x % DH, grp = threadIdx.x / DH;
  const size_t rs = (size_t)gridDim.y * TH * (DH + 2);  // between splits
  const float* p = part + ((size_t)b * TH + h) * (DH + 2);
  pdl_wait();  // the split pass has finished and its partials are visible
  for (int s = threadIdx.x; s < n_split; s += DH * kMergeGroups) {
    sm_m[s] = p[s * rs + DH];
    sm_l[s] = p[s * rs + DH + 1];
  }
  __syncthreads();
  float M = kNeg;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, sm_m[s]);
  float L = 0.f, O = 0.f;
#pragma unroll 8
  for (int s = grp; s < n_split; s += kMergeGroups) {
    const float ls = sm_l[s];
    const float v = p[s * rs + j];
    const float sc = ls > 0.f ? expf(sm_m[s] - M) : 0.f;
    L = fmaf(ls, sc, L);
    O = fmaf(sc, ls > 0.f ? v : 0.f, O);
  }
  sm_o[grp * DH + j] = O;
  if (j == 0) sm_L[grp] = L;
  __syncthreads();
  if (grp == 0) {
    O = sm_o[j];
    L = sm_L[0];
#pragma unroll
    for (int g = 1; g < kMergeGroups; ++g) {
      O += sm_o[g * DH + j];
      L += sm_L[g];
    }
    out[((size_t)b * TH + h) * DH + j] = from_f32<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename TQ, typename T, int DH, int MAXQ, bool WIN, bool ONE_T>
void launch_split(const DecodeArgs& a, cudaStream_t s) {
  const dim3 grid(a.n_split, a.Hkv * a.n_qt, a.B);
  decode_split_kernel<TQ, T, DH, MAXQ, WIN, ONE_T><<<grid, NW * 32, 0, s>>>(
      static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.cur_len),
      static_cast<float*>(a.part), a.C, a.nt, a.H, a.Hkv, a.H / a.Hkv, a.nq,
      a.n_qt, a.window, a.shift, a.span, a.scale);
}

template <typename TQ, typename T, int DH, int MAXQ>
void launch_tiles(const DecodeArgs& a, cudaStream_t s) {
  // tiles of nq queries, cut at multiples of nq, each lie within one t
  // when T = 1 or nq divides H / Hkv; a rolling window (decode steps of
  // sliding-window models) takes the general kernel
  if (a.window > 0)
    launch_split<TQ, T, DH, MAXQ, true, false>(a, s);
  else if (a.nt == 1 || (a.H / a.Hkv) % a.nq == 0)
    launch_split<TQ, T, DH, MAXQ, false, true>(a, s);
  else
    launch_split<TQ, T, DH, MAXQ, false, false>(a, s);
}

template <typename TQ, typename T, int DH>
int launch_dh(const DecodeArgs& a, cudaStream_t s) {
  if (a.nq <= 2)
    launch_tiles<TQ, T, DH, 2>(a, s);
  else if (a.nq <= 4)
    launch_tiles<TQ, T, DH, 4>(a, s);
  else if (a.nq <= 8)
    launch_tiles<TQ, T, DH, 8>(a, s);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem =
      (2 * a.n_split + kMergeGroups * (DH + 1)) * (int)sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  err = launch_pdl(&decode_merge_kernel<TQ, DH>, dim3(a.nt * a.H, a.B),
                   dim3(DH * kMergeGroups), smem, s,
                   static_cast<const float*>(a.part), static_cast<TQ*>(a.out),
                   a.nt * a.H, a.n_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One translation unit per head dim (decode_attn_dh*.cu) instantiates the
// kernels for f32 and bf16, so nvcc builds the head dims in parallel: as
// one unit they took 51 s to compile, 40 s longer than any other source.
#define DECODE_ATTN_HEAD_DIM(DH)                                          \
  int decode_attn_dh##DH(const DecodeArgs& a, int dtype, cudaStream_t s) { \
    return dtype == kF32                                                  \
               ? launch_dh<float, float, DH>(a, s)                        \
               : launch_dh<__nv_bfloat16, __nv_bfloat16, DH>(a, s);       \
  }

// The e4m3 instances (bf16 q and output over a float8_e4m3fn cache), one
// unit per head dim too (decode_attn_e4m3_dh*.cu).
#define DECODE_ATTN_E4M3_HEAD_DIM(DH)                                   \
  int decode_attn_e4m3_dh##DH(const DecodeArgs& a, cudaStream_t s) {    \
    return launch_dh<__nv_bfloat16, __nv_fp8_e4m3, DH>(a, s);           \
  }

// Positions one split block walks per step (NW warps, U positions a
// lane, 32 / LPR positions a warp load) at head dim DH: the unit of a
// span, which the host reads through decode_attention_step.
template <typename T, int DH>
constexpr int block_step() {
  return NW * U * Geo<T, DH>::PPW;
}

int decode_attn_dh16(const DecodeArgs& a, int dtype, cudaStream_t s);
int decode_attn_dh32(const DecodeArgs& a, int dtype, cudaStream_t s);
int decode_attn_dh64(const DecodeArgs& a, int dtype, cudaStream_t s);
int decode_attn_dh80(const DecodeArgs& a, int dtype, cudaStream_t s);
int decode_attn_dh128(const DecodeArgs& a, int dtype, cudaStream_t s);
int decode_attn_dh256(const DecodeArgs& a, int dtype, cudaStream_t s);
int decode_attn_e4m3_dh64(const DecodeArgs& a, cudaStream_t s);
int decode_attn_e4m3_dh128(const DecodeArgs& a, cudaStream_t s);
