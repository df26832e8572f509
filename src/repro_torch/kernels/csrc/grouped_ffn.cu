// grouped_ffn — SwiGLU FFN over expert-sorted, tile-padded rows.
//
// Replaces the Pallas kernel `grouped_ffn` (body `_grouped_kernel`) of
// src/repro/kernels/moe_ffn.py: ys[i] = FFN_{tile_eid[tile(i)]}(xs[i]),
// rows of tiles with tile_valid == 0 give zeros. Rows arrive sorted by
// expert (models/dispatch.py), each expert's segment padded to block_t.
//
// What bounds it on the H100: at the main-path prefill (8 x 128 prompt
// tokens, top-8 of 32 experts, d 1024, f 512, bf16) it reads about
// 100 MB of expert weights and 25 MB of rows against 26 GFLOP of real
// rows: 0.044 ms of bytes, 0.026 ms of bf16 tensor-core work, so it sits
// near the card's ridge and both have to be kept busy.
//
// Design: two launches of one tiled grouped GEMM, each block owning a
// BM-row x BN-column output tile of one plan tile, whose expert it reads
// from tile_eid (the block loads its own indices; no host sync):
//   1. up:   H = silu(xs W1[e]) * (xs W3[e]) into a (P, f) scratch
//   2. down: ys = H W2[e], zeros for invalid tiles
// The Pallas grid carried the d_ff sum across sequential grid steps;
// CUDA blocks run in no order, so each block loops over the whole
// reduction axis itself and the d_ff sum is the second launch's K loop.
// Each block reads only its tile's expert weights, so weight traffic
// scales with occupied tiles, never with E.
// bf16 (the main path): both products on the tensor cores, mma.sync
// m16n8k16 with f32 accumulation, fragments by ldmatrix from shared
// memory (rows padded by 16 bytes, so no bank is hit twice). Rows and
// weights stream through a 3-stage ring of 16-byte cp.async copies (64
// deep, 110 KB: two blocks per SM). The up block computes the same 64
// columns of xs W1 and xs W3, so silu(h) g is formed in registers and H
// is written once, rounded to bf16 as moe_ffn's H is (a relative 2^-9
// per element). The down pass is launched with programmatic dependent
// launch: its blocks start their W2 stream while the up pass ends and
// wait for it only to read H.
// f32 (not on the main path): 64 x 64 output tiles on the CUDA cores in
// IEEE f32 FMAs, staged through shared memory 16 deep, with an f32 H.
#include "common.cuh"

namespace {

// ---- bf16: tensor cores --------------------------------------------------

constexpr int TC_THREADS = 256;  // 8 warps
constexpr int BK = 64;           // reduction depth per stage
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int AP = BK + 8;       // A tile pitch (elements): 144 B rows

// One block's tile: BM rows (128, or 64 for block_t <= 64) of the NM
// products against BNW columns each (up: NM 2 x 64, down: NM 1 x 128).
// Warps: BM / 32 along the rows, the rest along the columns; each warp
// holds 32 rows x WC columns of every product.
template <int BM, int NM, int BNW>
struct Tile {
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WC = BNW / WARPS_N;    // columns per warp
  static constexpr int NT = WC / 8;           // mma n-tiles per warp
  static constexpr int BP = BNW + 8;          // B tile pitch (elements)
  static constexpr int SA = BM * AP;          // A elements per stage
  static constexpr int SB = NM * BK * BP;     // B elements per stage
  static constexpr int SMEM = STAGES * (SA + SB) * 2;
  static_assert(NT % 2 == 0, "B fragments load two n-tiles at once");
};

// rows [0, rows) x columns [k0, k0 + BK) of A (row pitch K) into dst;
// the rest zero-filled
template <int BM>
__device__ __forceinline__ void load_a(__nv_bfloat16* dst,
                                       const __nv_bfloat16* A, int K,
                                       int rows, int k0) {
  constexpr int CH = BM * (BK / 8);
  static_assert(CH % TC_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < CH / TC_THREADS; ++it) {
    const int ch = threadIdx.x + it * TC_THREADS;
    const int r = ch / (BK / 8), kk = (ch % (BK / 8)) * 8;
    const bool ok = r < rows && k0 + kk < K;
    cp_async16(dst + r * AP + kk, ok ? A + (size_t)r * K + k0 + kk : A, ok);
  }
}

// rows [k0, k0 + BK) x columns [n0, n0 + BNW) of each W[m] (K x N)
template <int BM, int NM, int BNW>
__device__ __forceinline__ void load_b(__nv_bfloat16* dst,
                                       const __nv_bfloat16* const* W, int K,
                                       int N, int k0, int n0) {
  using L = Tile<BM, NM, BNW>;
  constexpr int CPR = BNW / 8;  // 16-byte chunks per tile row
  constexpr int CH = BK * CPR;
  static_assert(CH % TC_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int it = 0; it < CH / TC_THREADS; ++it) {
      const int ch = threadIdx.x + it * TC_THREADS;
      const int r = ch / CPR, nn = (ch % CPR) * 8;
      const bool ok = k0 + r < K && n0 + nn < N;
      cp_async16(dst + (m * BK + r) * L::BP + nn,
                 ok ? W[m] + (size_t)(k0 + r) * N + n0 + nn : W[m], ok);
    }
}

// acc[m][i][j] += A rows (warp's 32, as 2 m16 tiles) x W[m] columns
// (warp's WC, as NT n8 tiles) over one BK stage
template <int BM, int NM, int BNW>
__device__ __forceinline__ void mma_stage(
    const __nv_bfloat16* As, const __nv_bfloat16* Bs,
    float (&acc)[NM][2][Tile<BM, NM, BNW>::NT][4]) {
  using L = Tile<BM, NM, BNW>;
  const int w = threadIdx.x >> 5;
  const int r0 = (w % L::WARPS_M) * 32, c0 = (w / L::WARPS_M) * L::WC;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(a[i], x4_addr<true>(As, AP, r0 + i * 16, ks));
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int j = 0; j < L::NT; j += 2) {
        uint32_t b[4];  // n-tiles j and j + 1, stored k-major: .trans
        ldmatrix_x4_trans(b, x4_addr<true>(Bs + m * BK * L::BP, L::BP, ks,
                                           c0 + j * 8));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[m][i][j], a[i], b[0], b[1]);
          mma_bf16(acc[m][i][j + 1], a[i], b[2], b[3]);
        }
      }
  }
}

// fn(i, j, f, row, column) for each of the thread's accumulator pairs:
// acc[.][i][j][f], acc[.][i][j][f + 1] hold (row, column) and
// (row, column + 1) of the block's tile; f = 0 is row g of the m-tile,
// f = 2 row g + 8
template <int BM, int NM, int BNW, typename Fn>
__device__ __forceinline__ void for_each_pair(Fn fn) {
  using L = Tile<BM, NM, BNW>;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (w % L::WARPS_M) * 32, c0 = (w / L::WARPS_M) * L::WC;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(i, j, h * 2, r0 + i * 16 + g + h * 8, c0 + j * 8 + 2 * q);
}

// One tile's block: rows [row0, row0 + rows) of tile `tile`; UP computes
// H (P x N, N = f, K = d) from xs, else ys (P x N, N = d, K = f) from H.
template <int BM, bool UP>
__global__ void __launch_bounds__(TC_THREADS, 2)
grouped_tc_kernel(const __nv_bfloat16* __restrict__ A,
                  const __nv_bfloat16* __restrict__ B1,
                  const __nv_bfloat16* __restrict__ B3,
                  const int* __restrict__ tile_eid,
                  const int* __restrict__ tile_valid,
                  __nv_bfloat16* __restrict__ out, int K, int N,
                  int block_t, int sub_per_tile) {
  constexpr int NM = UP ? 2 : 1, BNW = UP ? 64 : 128;
  using L = Tile<BM, NM, BNW>;
  if constexpr (UP) pdl_launch_dependents();  // down may start its W2
  const int tile = blockIdx.y / sub_per_tile;
  const int sub = blockIdx.y % sub_per_tile;
  const int row0 = tile * block_t + sub * BM;
  const int rows = min(BM, block_t - sub * BM);
  const int n0 = blockIdx.x * BNW;

  if (!tile_valid[tile]) {
    // up: the scratch rows of an invalid tile are never read
    if constexpr (!UP) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int ch = threadIdx.x; ch < rows * (BNW / 8); ch += TC_THREADS) {
        const int r = ch / (BNW / 8), n = n0 + (ch % (BNW / 8)) * 8;
        if (n < N)
          *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + n) = z;
      }
      pdl_wait();  // end no earlier than the up pass
    }
    return;
  }
  const size_t woff = (size_t)tile_eid[tile] * K * N;
  const __nv_bfloat16* W[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) W[m] = (m == 0 ? B1 : B3) + woff;
  const __nv_bfloat16* Ab = A + (size_t)row0 * K;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + STAGES * L::SA;

  float acc[NM][2][L::NT][4] = {};
  const int nk = (K + BK - 1) / BK;
  // the weight stages first: down's A (H) exists only after the up pass
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < nk) load_b<BM, NM, BNW>(sB + i * L::SB, W, K, N, i * BK, n0);
  if constexpr (!UP) pdl_wait();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load_a<BM>(sA + i * L::SA, Ab, K, rows, i * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1's buffer is free
    const int nx = kt + STAGES - 1;
    if (nx < nk) {
      load_a<BM>(sA + (nx % STAGES) * L::SA, Ab, K, rows, nx * BK);
      load_b<BM, NM, BNW>(sB + (nx % STAGES) * L::SB, W, K, N, nx * BK, n0);
    }
    cp_async_commit();
    mma_stage<BM, NM, BNW>(sA + (kt % STAGES) * L::SA,
                           sB + (kt % STAGES) * L::SB, acc);
  }
  cp_async_wait<0>();

  for_each_pair<BM, NM, BNW>([&](int i, int j, int f, int r, int c) {
    const int n = n0 + c;  // N % 8 == 0: n < N implies n + 1 < N
    if (r >= rows || n >= N) return;
    float v0, v1;
    if constexpr (UP) {
      v0 = silu_f32(acc[0][i][j][f]) * acc[1][i][j][f];
      v1 = silu_f32(acc[0][i][j][f + 1]) * acc[1][i][j][f + 1];
    } else {
      v0 = acc[0][i][j][f];
      v1 = acc[0][i][j][f + 1];
    }
    *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + r) * N + n) =
        pack_bf16(v0, v1);
  });
}

template <int BM>
int launch_tc(const void* xs, const void* w1, const void* w3,
              const void* w2, const int* eid, const int* val, void* h,
              void* ys, int P, int d, int f, int block_t, cudaStream_t s) {
  auto up = &grouped_tc_kernel<BM, true>;
  auto dn = &grouped_tc_kernel<BM, false>;
  constexpr int smem_up = Tile<BM, 2, 64>::SMEM;
  constexpr int smem_dn = Tile<BM, 1, 128>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_up);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dn);
  if (err != cudaSuccess) return (int)err;
  const int spt = (block_t + BM - 1) / BM, tiles = P / block_t;
  using bf = __nv_bfloat16;
  up<<<dim3((f + 63) / 64, tiles * spt), TC_THREADS, smem_up, s>>>(
      static_cast<const bf*>(xs), static_cast<const bf*>(w1),
      static_cast<const bf*>(w3), eid, val, static_cast<bf*>(h), d, f,
      block_t, spt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_pdl(dn, dim3((d + 127) / 128, tiles * spt), dim3(TC_THREADS),
                   smem_dn, s, static_cast<const bf*>(h),
                   static_cast<const bf*>(w2), static_cast<const bf*>(nullptr),
                   eid, val, static_cast<bf*>(ys), f, d, block_t, spt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- f32: CUDA cores -----------------------------------------------------

constexpr int BM32 = 64;   // rows per block
constexpr int BN32 = 64;   // output columns per block
constexpr int BK32 = 16;   // reduction depth per shared-memory stage
constexpr int NT32 = 256;  // threads: 16 x 16, each owns 4 x 4 outputs

// One 64 x 64 output tile of A (rows x K) times B[e] (K x N).
// UP: two products against B1 = W1[e], B3 = W3[e]; writes
//     silu(A B1) * (A B3). Otherwise one product against B1 = W2[e].
template <bool UP>
__global__ void __launch_bounds__(NT32)
grouped_f32_kernel(const float* __restrict__ A, const float* __restrict__ B1,
                   const float* __restrict__ B3,
                   const int* __restrict__ tile_eid,
                   const int* __restrict__ tile_valid,
                   float* __restrict__ out, int K, int N, int block_t,
                   int sub_per_tile) {
  const int tile = blockIdx.y / sub_per_tile;
  const int sub = blockIdx.y % sub_per_tile;
  const int row0 = tile * block_t + sub * BM32;
  const int rows = min(BM32, block_t - sub * BM32);
  const int col0 = blockIdx.x * BN32;
  const int tid = threadIdx.x;

  if (!tile_valid[tile]) {
    // up: the scratch rows of an invalid tile are never read
    if constexpr (!UP) {
      for (int i = tid; i < rows * BN32; i += NT32) {
        const int r = i / BN32, c = col0 + i % BN32;
        if (c < N) out[(size_t)(row0 + r) * N + c] = 0.f;
      }
    }
    return;
  }
  const size_t woff = (size_t)tile_eid[tile] * K * N;
  const float* W1 = B1 + woff;
  const float* W3 = UP ? B3 + woff : nullptr;

  __shared__ __align__(16) float As[BK32][BM32];
  __shared__ __align__(16) float Bs1[BK32][BN32];
  __shared__ __align__(16) float Bs3[UP ? BK32 : 1][UP ? BN32 : 4];

  const int tx = tid % 16, ty = tid / 16;
  float acc1[4][4] = {}, acc3[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK32) {
#pragma unroll
    for (int j = 0; j < (BM32 * BK32) / NT32; ++j) {
      const int i = tid + j * NT32;
      const int m = i / BK32, kk = i % BK32;
      As[kk][m] = (m < rows && k0 + kk < K)
                      ? A[(size_t)(row0 + m) * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < (BK32 * BN32) / NT32; ++j) {
      const int i = tid + j * NT32;
      const int kk = i / BN32, n = i % BN32;
      const bool in = (k0 + kk < K) && (col0 + n < N);
      const size_t at = (size_t)(k0 + kk) * N + col0 + n;
      Bs1[kk][n] = in ? W1[at] : 0.f;
      if constexpr (UP) Bs3[kk][n] = in ? W3[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs1[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc1[r][c] += av[r] * bv[c];
      if constexpr (UP) {
        const float4 g = *reinterpret_cast<const float4*>(&Bs3[kk][tx * 4]);
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc3[r][c] += av[r] * gv[c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = ty * 4 + r;
    if (m >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = col0 + tx * 4 + c;
      if (n >= N) continue;
      const size_t at = (size_t)(row0 + m) * N + n;
      out[at] = UP ? silu_f32(acc1[r][c]) * acc3[r][c] : acc1[r][c];
    }
  }
}

int launch_f32(const float* xs, const float* w1, const float* w3,
               const float* w2, const int* eid, const int* val, float* h,
               float* ys, int P, int d, int f, int block_t, cudaStream_t s) {
  const int spt = (block_t + BM32 - 1) / BM32, tiles = P / block_t;
  grouped_f32_kernel<true><<<dim3((f + BN32 - 1) / BN32, tiles * spt), NT32,
                             0, s>>>(xs, w1, w3, eid, val, h, d, f, block_t,
                                     spt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grouped_f32_kernel<false><<<dim3((d + BN32 - 1) / BN32, tiles * spt), NT32,
                              0, s>>>(h, w2, nullptr, eid, val, ys, f, d,
                                      block_t, spt);
  return (int)cudaGetLastError();
}

}  // namespace

// xs (P, d), w1 / w3 (E, d, f), w2 (E, f, d) in one dtype, 16-byte
// aligned, d and f multiples of 8; tile_eid / tile_valid (P / block_t,)
// int32; h a (P, f) scratch in the dtype; ys (P, d) the output.
extern "C" int grouped_ffn(const void* xs, const void* w1, const void* w3,
                           const void* w2, const void* tile_eid,
                           const void* tile_valid, void* h, void* ys, int P,
                           int d, int f, int block_t, int dtype,
                           void* stream) {
  if (d % 8 || f % 8 || block_t < 1 || P % block_t)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  const int* val = static_cast<const int*>(tile_valid);
  if (dtype == kF32)
    return launch_f32(static_cast<const float*>(xs),
                      static_cast<const float*>(w1),
                      static_cast<const float*>(w3),
                      static_cast<const float*>(w2), eid, val,
                      static_cast<float*>(h), static_cast<float*>(ys), P, d,
                      f, block_t, s);
  return block_t > 64
             ? launch_tc<128>(xs, w1, w3, w2, eid, val, h, ys, P, d, f,
                              block_t, s)
             : launch_tc<64>(xs, w1, w3, w2, eid, val, h, ys, P, d, f,
                             block_t, s);
}
