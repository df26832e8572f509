// grouped_ffn_bwd — the gradient of grouped_ffn (grouped_ffn.cu).
//
// The Pallas kernel `grouped_ffn` of src/repro/kernels/moe_ffn.py has no
// backward of its own: the JAX package differentiates its jnp twin
// (models/dispatch.py grouped_ffn_jnp). This is the gradient of the
// function the forward kernel computes, ys[i] = (silu(A) * B)[i] W2[e]
// with A = xs W1[e], B = xs W3[e] and e = tile_eid[i / block_t], zero on
// tiles with tile_valid == 0. Given dys it returns
//   dxs = dA W1[e]^T + dB W3[e]^T,
//   dW1[e] = sum xs^T dA, dW3[e] = sum xs^T dB, dW2[e] = sum H^T dys,
// with G = dys W2[e]^T, dA = G * B * s * (1 + A (1 - s)), s = sigmoid(A),
// dB = G * silu(A), H = silu(A) * B; the sums run over expert e's valid
// tiles, and every gradient of an invalid tile's rows is zero.
//
// What bounds it on the H100 (published peaks of the SXM part at 700 W:
// 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s): at granite-moe's
// training shape (8 x 128 tokens, top-8 of 32 experts, d 1024, f 512,
// f32, 12 288 padded rows) it does 16 * rows * d * f ~ 70 GFLOP on real
// rows against ~0.5 GB of rows, weights, gradients and f32 scratch:
// ~1 ms of operations, 0.15 ms of bytes. Operations bound it.
//
// Design: three launches on the stream, each a 64 x 64 output tile per
// block, 256 threads of 4 x 4 register tiles fed by float4 reads of
// shared memory staged 16 deep, IEEE f32 FMAs on the CUDA cores (never
// TF32; bf16 inputs are widened on load):
//   1. per (plan row block, f block): recompute A and B (the forward
//      keeps nothing), G = dys W2[e]^T, and write dA, dB and H into f32
//      (P, f) scratches; zeros for an invalid tile;
//   2. per (plan row block, d block): dxs = dA W1[e]^T + dB W3[e]^T;
//   3. per (expert, d block, f block): dW1, dW3 and dW2 of that block,
//      the rows of expert e's valid tiles walked in tile index order.
// No atomics anywhere: each output element is one block's, summed in a
// fixed order, so two calls give the same bits. Each block of pass 3
// finds its expert's tiles by reading the tile vectors itself (no host
// sync); an expert with no valid tile writes exact zeros. A row block
// lies inside one plan tile (min(64, block_t) rows), so block_t = 8 (a
// verify pass) and 128 (prefill, training) take the same code.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads: 16 x 16, each a 4 x 4 output tile
constexpr int BM = 64;   // output tile rows
constexpr int BN = 64;   // output tile columns
constexpr int BK = 16;   // reduction depth staged per step
constexpr int TP = 68;   // pitch of a tile stored transposed (bank spread)

template <typename T>
__device__ __forceinline__ float ld(const T* p) {
  return to_f32<T>(*p);
}

__device__ __forceinline__ void f4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// s[kk][m] = src[(row0 + m) * ld_src + k0 + kk] for m < rows, k0 + kk < K,
// else 0: BM rows of a row-major matrix, stored k-major.
template <typename T>
__device__ __forceinline__ void load_rows_t(float (*s)[TP], const T* src,
                                            int row0, int rows, int k0,
                                            int K, int ld_src) {
#pragma unroll
  for (int j = 0; j < BM * BK / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int m = i / BK, kk = i % BK;
    s[kk][m] = (m < rows && k0 + kk < K)
                   ? ld(src + (size_t)(row0 + m) * ld_src + k0 + kk) : 0.f;
  }
}

// s[kk][n] = W[(k0 + kk) * N + col0 + n]: a (K, N) row-major weight.
template <typename T, int P>
__device__ __forceinline__ void load_w(float (*s)[P], const T* W, int k0,
                                       int K, int col0, int N) {
#pragma unroll
  for (int j = 0; j < BK * BN / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int kk = i / BN, n = i % BN;
    s[kk][n] = (k0 + kk < K && col0 + n < N)
                   ? ld(W + (size_t)(k0 + kk) * N + col0 + n) : 0.f;
  }
}

// s[kk][n] = W[(col0 + n) * K + k0 + kk]: the transpose of an (N, K)
// row-major weight.
template <typename T>
__device__ __forceinline__ void load_w_t(float (*s)[TP], const T* W, int k0,
                                         int K, int col0, int N) {
#pragma unroll
  for (int j = 0; j < BK * BN / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int kk = i % BK, n = i / BK;
    s[kk][n] = (k0 + kk < K && col0 + n < N)
                   ? ld(W + (size_t)(col0 + n) * K + k0 + kk) : 0.f;
  }
}

// The row block of grid row y: plan tile, first row, live rows.
struct RowBlock {
  int tile, row0, rows;
  __device__ RowBlock(int y, int block_t, int spt) {
    tile = y / spt;
    const int sub = y % spt;
    row0 = tile * block_t + sub * BM;
    rows = min(BM, block_t - sub * BM);
  }
};

// ---- pass 1: dA, dB, H per (row block, f block) ------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_act_kernel(const T* __restrict__ xs, const T* __restrict__ w1,
                   const T* __restrict__ w3, const T* __restrict__ w2,
                   const T* __restrict__ dys, const int* __restrict__ eid,
                   const int* __restrict__ valid, float* __restrict__ da,
                   float* __restrict__ db, float* __restrict__ h, int d,
                   int f, int block_t, int spt) {
  const RowBlock rb(blockIdx.y, block_t, spt);
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (!valid[rb.tile]) {
    for (int i = threadIdx.x; i < rb.rows * BN; i += NT) {
      const int c = col0 + i % BN;
      if (c >= f) continue;
      const size_t at = (size_t)(rb.row0 + i / BN) * f + c;
      da[at] = 0.f;
      db[at] = 0.f;
      h[at] = 0.f;
    }
    return;
  }
  const size_t woff = (size_t)eid[rb.tile] * d * f;
  const T* W1 = w1 + woff;
  const T* W3 = w3 + woff;
  const T* W2 = w2 + woff;

  __shared__ __align__(16) float Xs[BK][TP];
  __shared__ __align__(16) float Ds[BK][TP];
  __shared__ __align__(16) float W1s[BK][BN];
  __shared__ __align__(16) float W3s[BK][BN];
  __shared__ __align__(16) float W2s[BK][TP];
  float accA[4][4] = {}, accB[4][4] = {}, accG[4][4] = {};

  for (int k0 = 0; k0 < d; k0 += BK) {
    load_rows_t(Xs, xs, rb.row0, rb.rows, k0, d, d);
    load_rows_t(Ds, dys, rb.row0, rb.rows, k0, d, d);
    load_w(W1s, W1, k0, d, col0, f);
    load_w(W3s, W3, k0, d, col0, f);
    load_w_t(W2s, W2, k0, d, col0, f);   // W2[e] is (f, d)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float x[4], g[4], b1[4], b3[4], b2[4];
      f4(x, &Xs[kk][ty * 4]);
      f4(g, &Ds[kk][ty * 4]);
      f4(b1, &W1s[kk][tx * 4]);
      f4(b3, &W3s[kk][tx * 4]);
      f4(b2, &W2s[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          accA[r][c] = fmaf(x[r], b1[c], accA[r][c]);
          accB[r][c] = fmaf(x[r], b3[c], accB[r][c]);
          accG[r][c] = fmaf(g[r], b2[c], accG[r][c]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = ty * 4 + r;
    if (m >= rb.rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = col0 + tx * 4 + c;
      if (n >= f) continue;
      const float a = accA[r][c], b = accB[r][c], g = accG[r][c];
      const float s = 1.0f / (1.0f + expf(-a));
      const float sa = a * s;
      const size_t at = (size_t)(rb.row0 + m) * f + n;
      da[at] = g * b * s * (1.0f + a * (1.0f - s));
      db[at] = g * sa;
      h[at] = sa * b;
    }
  }
}

// ---- pass 2: dxs per (row block, d block) -------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_dx_kernel(const float* __restrict__ da, const float* __restrict__ db,
                  const T* __restrict__ w1, const T* __restrict__ w3,
                  const int* __restrict__ eid, const int* __restrict__ valid,
                  T* __restrict__ dxs, int d, int f, int block_t, int spt) {
  const RowBlock rb(blockIdx.y, block_t, spt);
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (!valid[rb.tile]) {
    for (int i = threadIdx.x; i < rb.rows * BN; i += NT) {
      const int c = col0 + i % BN;
      if (c < d) dxs[(size_t)(rb.row0 + i / BN) * d + c] = from_f32<T>(0.f);
    }
    return;
  }
  const size_t woff = (size_t)eid[rb.tile] * d * f;
  const T* W1 = w1 + woff;
  const T* W3 = w3 + woff;

  __shared__ __align__(16) float As[BK][TP];
  __shared__ __align__(16) float Bs[BK][TP];
  __shared__ __align__(16) float W1s[BK][TP];
  __shared__ __align__(16) float W3s[BK][TP];
  float acc[4][4] = {};

  for (int k0 = 0; k0 < f; k0 += BK) {
    load_rows_t(As, da, rb.row0, rb.rows, k0, f, f);
    load_rows_t(Bs, db, rb.row0, rb.rows, k0, f, f);
    load_w_t(W1s, W1, k0, f, col0, d);   // W1[e] is (d, f)
    load_w_t(W3s, W3, k0, f, col0, d);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4], u[4], v[4];
      f4(a, &As[kk][ty * 4]);
      f4(b, &Bs[kk][ty * 4]);
      f4(u, &W1s[kk][tx * 4]);
      f4(v, &W3s[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(b[r], v[c], fmaf(a[r], u[c], acc[r][c]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = ty * 4 + r;
    if (m >= rb.rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = col0 + tx * 4 + c;
      if (n < d) dxs[(size_t)(rb.row0 + m) * d + n] = from_f32<T>(acc[r][c]);
    }
  }
}

// ---- pass 3: dW1, dW3, dW2 per (expert, d block, f block) ---------------
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_dw_kernel(const T* __restrict__ xs, const T* __restrict__ dys,
                  const float* __restrict__ da, const float* __restrict__ db,
                  const float* __restrict__ h, const int* __restrict__ eid,
                  const int* __restrict__ valid, T* __restrict__ dw1,
                  T* __restrict__ dw3, T* __restrict__ dw2, int d, int f,
                  int block_t, int n_tiles) {
  const int e = blockIdx.z;
  const int j0 = blockIdx.x * BN;   // f columns
  const int c0 = blockIdx.y * BM;   // d columns
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  __shared__ __align__(16) float Xs[BK][BM];
  __shared__ __align__(16) float Ds[BK][BM];
  __shared__ __align__(16) float As[BK][BN];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ __align__(16) float Hs[BK][BN];
  float acc1[4][4] = {}, acc3[4][4] = {}, acc2[4][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    if (!valid[t] || eid[t] != e) continue;   // uniform over the block
    for (int r0 = t * block_t; r0 < (t + 1) * block_t; r0 += BK) {
      const int rows = min(BK, (t + 1) * block_t - r0);
#pragma unroll
      for (int j = 0; j < BK * BM / NT; ++j) {
        const int i = threadIdx.x + j * NT;
        const int rr = i / BM, c = i % BM;
        const bool in = rr < rows;
        const size_t xr = (size_t)(r0 + rr) * d + c0 + c;
        const size_t fr = (size_t)(r0 + rr) * f + j0 + c;
        const bool cin = in && c0 + c < d, jin = in && j0 + c < f;
        Xs[rr][c] = cin ? ld(xs + xr) : 0.f;
        Ds[rr][c] = cin ? ld(dys + xr) : 0.f;
        As[rr][c] = jin ? da[fr] : 0.f;
        Bs[rr][c] = jin ? db[fr] : 0.f;
        Hs[rr][c] = jin ? h[fr] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < BK; ++rr) {
        float x[4], g[4], a[4], b[4], hh[4];
        f4(x, &Xs[rr][ty * 4]);
        f4(g, &Ds[rr][ty * 4]);
        f4(a, &As[rr][tx * 4]);
        f4(b, &Bs[rr][tx * 4]);
        f4(hh, &Hs[rr][tx * 4]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc1[r][c] = fmaf(x[r], a[c], acc1[r][c]);
            acc3[r][c] = fmaf(x[r], b[c], acc3[r][c]);
            acc2[r][c] = fmaf(hh[c], g[r], acc2[r][c]);
          }
      }
      __syncthreads();
    }
  }
  const size_t woff = (size_t)e * d * f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = c0 + ty * 4 + r;
    if (c >= d) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j >= f) continue;
      dw1[woff + (size_t)c * f + j] = from_f32<T>(acc1[r][q]);
      dw3[woff + (size_t)c * f + j] = from_f32<T>(acc3[r][q]);
      dw2[woff + (size_t)j * d + c] = from_f32<T>(acc2[r][q]);
    }
  }
}

template <typename T>
int launch_bwd(const void* xs, const void* w1, const void* w3,
               const void* w2, const int* eid, const int* val,
               const void* dys, float* da, float* db, float* h, void* dxs,
               void* dw1, void* dw3, void* dw2, int P, int d, int f, int E,
               int block_t, cudaStream_t s) {
  const int spt = (block_t + BM - 1) / BM, tiles = P / block_t;
  const T* x = static_cast<const T*>(xs);
  const T* u = static_cast<const T*>(w1);
  const T* v = static_cast<const T*>(w3);
  const T* w = static_cast<const T*>(w2);
  const T* dy = static_cast<const T*>(dys);
  bwd_act_kernel<T><<<dim3((f + BN - 1) / BN, tiles * spt), NT, 0, s>>>(
      x, u, v, w, dy, eid, val, da, db, h, d, f, block_t, spt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dx_kernel<T><<<dim3((d + BN - 1) / BN, tiles * spt), NT, 0, s>>>(
      da, db, u, v, eid, val, static_cast<T*>(dxs), d, f, block_t, spt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dw_kernel<T><<<dim3((f + BN - 1) / BN, (d + BM - 1) / BM, E), NT, 0,
                     s>>>(x, dy, da, db, h, eid, val, static_cast<T*>(dw1),
                          static_cast<T*>(dw3), static_cast<T*>(dw2), d, f,
                          block_t, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// xs, dys (P, d), w1 / w3 (E, d, f), w2 (E, f, d) in one dtype; tile_eid /
// tile_valid (P / block_t,) int32; da, db, h (P, f) f32 scratches; dxs
// (P, d), dw1 / dw3 (E, d, f), dw2 (E, f, d) the outputs, every element
// written. Three kernels on `stream`; returns cudaGetLastError().
extern "C" int grouped_ffn_bwd(const void* xs, const void* w1, const void* w3,
                               const void* w2, const void* tile_eid,
                               const void* tile_valid, const void* dys,
                               void* da, void* db, void* h, void* dxs,
                               void* dw1, void* dw3, void* dw2, int P, int d,
                               int f, int E, int block_t, int dtype,
                               void* stream) {
  if (P < 1 || d < 1 || f < 1 || E < 1 || block_t < 1 || P % block_t ||
      E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  const int* val = static_cast<const int*>(tile_valid);
  float* a = static_cast<float*>(da);
  float* b = static_cast<float*>(db);
  float* hh = static_cast<float*>(h);
  if (dtype == kF32)
    return launch_bwd<float>(xs, w1, w3, w2, eid, val, dys, a, b, hh, dxs,
                             dw1, dw3, dw2, P, d, f, E, block_t, s);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(xs, w1, w3, w2, eid, val, dys, a, b, hh,
                                     dxs, dw1, dw3, dw2, P, d, f, E, block_t,
                                     s);
  return (int)cudaErrorInvalidValue;
}
