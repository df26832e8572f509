// grouped_ffn — SwiGLU FFN over expert-sorted, tile-padded rows.
//
// Replaces the Pallas kernel `grouped_ffn` (body `_grouped_kernel`) of
// src/repro/kernels/moe_ffn.py: ys[i] = FFN_{tile_eid[tile(i)]}(xs[i]),
// rows of tiles with tile_valid == 0 give zeros. Rows arrive sorted by
// expert (models/dispatch.py), each expert's segment padded to block_t.
//
// What bounds it on the H100: at the main-path prefill (8 x 128 prompt
// tokens, top-8 of 32 experts, d 1024, f 512, bf16) it reads about
// 100 MB of expert weights per layer against about 26 GFLOP, which
// sits near the memory/compute ridge of the card. This first version
// runs on the CUDA cores in f32 (no wgmma, no TMA yet), so it is bound
// by f32 FMA throughput, far below the tensor-core bound.
//
// Design: two launches of one tiled grouped GEMM, each block owning a
// 64 x 64 output tile of one plan tile, whose expert it reads from
// tile_eid[blockIdx] (the block loads its own indices; no host sync).
//   1. up:   H = silu(xs W1[e]) * (xs W3[e])   into an f32 (P, f) scratch
//   2. down: ys = H W2[e]                       in the input dtype
// The Pallas grid carried the d_ff sum across sequential grid steps;
// CUDA blocks run in no order, so here each block loops over the whole
// reduction axis itself and the d_ff sum is the second launch's K loop.
// Each block reads only its tile's expert weights, so weight traffic
// scales with occupied tiles, never with E.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // reduction depth per shared-memory stage
constexpr int NT = 256;  // threads: 16 x 16, each owns a 4 x 4 outputs

// One 64 x 64 output tile of A (rows x K) times B[e] (K x N).
// UP: two products against B1 = W1[e], B3 = W3[e]; writes
//     silu(A B1) * (A B3) as f32. Otherwise one product against
//     B1 = W2[e], written in TB.
template <typename TA, typename TB, bool UP>
__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B1,
                    const TB* __restrict__ B3,
                    const int* __restrict__ tile_eid,
                    const int* __restrict__ tile_valid,
                    void* __restrict__ out, int K, int N, int block_t,
                    int sub_per_tile) {
  const int tile = blockIdx.y / sub_per_tile;
  const int sub = blockIdx.y % sub_per_tile;
  const int row0 = tile * block_t + sub * BM;
  const int rows = min(BM, block_t - sub * BM);
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  if (!tile_valid[tile]) {
    // up: the scratch rows of an invalid tile are never read
    if constexpr (!UP) {
      TB* ys = static_cast<TB*>(out);
      for (int i = tid; i < rows * BN; i += NT) {
        const int r = i / BN, c = col0 + i % BN;
        if (c < N) ys[(size_t)(row0 + r) * N + c] = from_f32<TB>(0.f);
      }
    }
    return;
  }
  const size_t woff = (size_t)tile_eid[tile] * K * N;
  const TB* W1 = B1 + woff;
  const TB* W3 = UP ? B3 + woff : nullptr;

  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs1[BK][BN];
  __shared__ __align__(16) float Bs3[UP ? BK : 1][UP ? BN : 4];

  const int tx = tid % 16, ty = tid / 16;
  float acc1[4][4] = {}, acc3[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < (BM * BK) / NT; ++j) {
      const int i = tid + j * NT;
      const int m = i / BK, kk = i % BK;
      float v = 0.f;
      if (m < rows && k0 + kk < K)
        v = to_f32(A[(size_t)(row0 + m) * K + k0 + kk]);
      As[kk][m] = v;
    }
#pragma unroll
    for (int j = 0; j < (BK * BN) / NT; ++j) {
      const int i = tid + j * NT;
      const int kk = i / BN, n = i % BN;
      const bool in = (k0 + kk < K) && (col0 + n < N);
      const size_t at = (size_t)(k0 + kk) * N + col0 + n;
      Bs1[kk][n] = in ? to_f32(W1[at]) : 0.f;
      if constexpr (UP) Bs3[kk][n] = in ? to_f32(W3[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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
      if constexpr (UP)
        static_cast<float*>(out)[at] = silu_f32(acc1[r][c]) * acc3[r][c];
      else
        static_cast<TB*>(out)[at] = from_f32<TB>(acc1[r][c]);
    }
  }
}

dim3 grid_for(int P, int N, int block_t, int* sub_per_tile) {
  *sub_per_tile = (block_t + BM - 1) / BM;
  return dim3((N + BN - 1) / BN, (P / block_t) * (*sub_per_tile));
}

}  // namespace

// H (P, f) f32 = silu(xs W1[e]) * (xs W3[e]) for every valid tile.
extern "C" int grouped_ffn_up(const void* xs, const void* w1, const void* w3,
                              const void* tile_eid, const void* tile_valid,
                              void* h, int P, int d, int f, int block_t,
                              int dtype, void* stream) {
  int spt;
  const dim3 grid = grid_for(P, f, block_t, &spt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  const int* val = static_cast<const int*>(tile_valid);
  if (dtype == kF32)
    grouped_gemm_kernel<float, float, true><<<grid, NT, 0, s>>>(
        static_cast<const float*>(xs), static_cast<const float*>(w1),
        static_cast<const float*>(w3), eid, val, h, d, f, block_t, spt);
  else
    grouped_gemm_kernel<__nv_bfloat16, __nv_bfloat16, true><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xs),
        static_cast<const __nv_bfloat16*>(w1),
        static_cast<const __nv_bfloat16*>(w3), eid, val, h, d, f, block_t,
        spt);
  return (int)cudaGetLastError();
}

// ys (P, d) = H W2[e] for valid tiles, zeros for invalid ones.
extern "C" int grouped_ffn_down(const void* h, const void* w2,
                                const void* tile_eid, const void* tile_valid,
                                void* ys, int P, int d, int f, int block_t,
                                int dtype, void* stream) {
  int spt;
  const dim3 grid = grid_for(P, d, block_t, &spt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  const int* val = static_cast<const int*>(tile_valid);
  const float* hf = static_cast<const float*>(h);
  if (dtype == kF32)
    grouped_gemm_kernel<float, float, false><<<grid, NT, 0, s>>>(
        hf, static_cast<const float*>(w2), nullptr, eid, val, ys, f, d,
        block_t, spt);
  else
    grouped_gemm_kernel<float, __nv_bfloat16, false><<<grid, NT, 0, s>>>(
        hf, static_cast<const __nv_bfloat16*>(w2), nullptr, eid, val, ys, f,
        d, block_t, spt);
  return (int)cudaGetLastError();
}
