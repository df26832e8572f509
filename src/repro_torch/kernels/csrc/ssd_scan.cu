// ssd_scan — the Mamba2 chunked SSD scan (state-space duality).
//
// Replaces the Pallas kernel `ssd_scan` (body `_kernel`) of
// src/repro/kernels/ssd_scan.py:66, with the contract of the function the
// model calls, src/repro/models/ssm.py `ssd_chunked`:
//     x (B, S, nh, hd), dt (B, S, nh) f32, A (nh,) f32,
//     Bm, Cm (B, S, g, ds) per group (head h reads group h / (nh / g)),
//     init_state (B, nh, hd, ds) f32 or null (zeros)
//  -> y (B, S, nh, hd) in x's dtype, final state (B, nh, hd, ds) f32.
// Per chunk of l positions, with cum the in-chunk cumulative sum of dt·A:
//     y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i · entering_state
//     state' = state · exp(cum_last) + Σ_j B_j exp(cum_last - cum_j) dt_j x_j
//
// What bounds it on the H100. At the main path's shapes (B 8, S 500, one
// group) the function moves about 45 MB in bf16 for mamba2-370m (x and y
// 16.4 MB each, Bm and Cm 2 MB, dt 0.5 MB, final state 8.4 MB) and about
// 77 MB for zamba2-1.2b, and does about 10 GFLOP (mamba2) / 8.6 GFLOP
// (zamba2) counting the causal half of the l x l products: 13 / 23 us by
// bytes at 3.35 TB/s, and 10 / 9 us by bf16 tensor-core operations. So
// in bf16 it is bound by bytes. In f32 the same operations at the 67
// TFLOP/s of the CUDA cores take 150 us: bound by operations.
//
// What this design does about it: it is the simple, right first version.
// It runs in f32 on the CUDA cores (register-tiled 4 x 4 outer products
// out of shared memory), so in bf16 it stays far above the byte bound;
// tensor cores (wgmma) and TMA come later. It is Mamba2's own
// decomposition in three launches, chosen over one block per (b, head)
// walking its chunks because that gives B·nh blocks (256 for mamba2 at
// B = 8) for 132 SMs, each serial over the chunks; here the heavy third
// pass has B·nc·nh·(l / 64) blocks (2048 for mamba2), and only the cheap
// elementwise state pass is serial over chunks. The price is one f32
// round trip of the chunk states (B·nc·nh·hd·ds, 17 MB for mamba2).
//   1. chunk_state: per (chunk, head, b): cum (kept in a scratch for the
//      other passes, summed in position order by one thread) and the
//      chunk's own state Σ_j x_j (exp(cum_last - cum_j) dt_j) B_jᵀ.
//   2. state_pass: per (element, head, b), in chunk order: the state
//      entering each chunk (written over the chunk's own state) and the
//      final state. This is the Pallas grid's sequential chunk axis.
//   3. chunk_scan: per (64-row tile of a chunk, head, b): the entering
//      state's term, then the causal intra-chunk term over 64-column
//      tiles j <= i, never holding the whole l x l block.
// Every sum runs in a fixed order and no float atomics are used, so the
// result repeats bit for bit. exp is taken only where j <= i: above the
// diagonal cum_i - cum_j is positive (up to ~+180 over 256 positions)
// and exp would overflow to inf, and inf · 0 is NaN. Positions >= S
// (the ragged last chunk) are read as dt = x = B = C = 0, which is what
// the JAX package's zero padding gives, and are never written.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block, all passes
constexpr int TI = 64;   // chunk_scan: rows (positions i) per block
constexpr int TJ = 64;   // chunk_scan: columns (positions j) per step
constexpr int TK = 32;   // chunk_state: positions per step

// An R x C f32 product held in registers: 4 x 4 outputs per tile, the
// tiles dealt to the block's threads round robin.
template <int R, int C>
struct Tiles {
  static constexpr int CT = C / 4;
  static constexpr int N = (R / 4) * CT;
  static constexpr int PER = (N + NT - 1) / NT;
  float v[PER][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < PER; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[t][i][j] = 0.f;
  }

  // this thread's tile t: its first row and column; false if none
  static __device__ __forceinline__ bool at(int t, int& r0, int& c0) {
    const int tile = threadIdx.x + t * NT;
    r0 = (tile / CT) * 4;
    c0 = (tile % CT) * 4;
    return tile < N;
  }

  // v[r][c] += Σ_{k<K} a[k][r] b[k][c]; a is K x R and b is K x C, both
  // k-major in shared memory, 16-byte aligned rows. k runs in order.
  __device__ __forceinline__ void mac(const float* a, const float* b,
                                     int K) {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      int r0, c0;
      if (!at(t, r0, c0)) continue;
      for (int k = 0; k < K; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(a + k * R + r0);
        const float4 bv = *reinterpret_cast<const float4*>(b + k * C + c0);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[t][i][j] = fmaf(ar[i], br[j], v[t][i][j]);
      }
    }
  }
};

// ------------------------------------------------------ 1. chunk state ---

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(NT)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ cum, float* __restrict__ states,
                   int S, int nh, int g, int l, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // TK x HD: x_j exp(cum_last - cum_j) dt_j
  float* bs = xs + TK * HD;    // TK x DS: B_j
  float* dts = bs + TK * DS;   // l: dt of the chunk
  float* cs = dts + l;         // l: cum of the chunk
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (nh / g);
  const int t0 = c * l;
  const size_t k = ((size_t)b * nc + c) * nh + h;

  for (int j = threadIdx.x; j < l; j += NT) {
    const int pos = t0 + j;
    dts[j] = pos < S ? dt[((size_t)b * S + pos) * nh + h] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // in position order, as a sequential cumsum
    const float a = A[h];
    float run = 0.f;
    for (int j = 0; j < l; ++j) {
      run += dts[j] * a;
      cs[j] = run;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < l; j += NT) cum[k * l + j] = cs[j];
  const float last = cs[l - 1];

  Tiles<HD, DS> acc;
  acc.zero();
  for (int j0 = 0; j0 < l; j0 += TK) {
    for (int e = threadIdx.x; e < TK * HD; e += NT) {
      const int jj = e / HD, p = e % HD, j = j0 + jj, pos = t0 + j;
      float v = 0.f;
      if (j < l && pos < S)
        v = to_f32(x[(((size_t)b * S + pos) * nh + h) * HD + p]) *
            (expf(last - cs[j]) * dts[j]);
      xs[e] = v;
    }
    for (int e = threadIdx.x; e < TK * DS; e += NT) {
      const int jj = e / DS, n = e % DS, j = j0 + jj, pos = t0 + j;
      bs[e] = (j < l && pos < S)
                  ? to_f32(Bm[(((size_t)b * S + pos) * g + grp) * DS + n])
                  : 0.f;
    }
    __syncthreads();
    acc.mac(xs, bs, TK);
    __syncthreads();
  }
  float* out = states + k * (HD * DS);
#pragma unroll
  for (int t = 0; t < Tiles<HD, DS>::PER; ++t) {
    int r0, c0;
    if (!Tiles<HD, DS>::at(t, r0, c0)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(r0 + i) * DS + c0 + j] = acc.v[t][i][j];
  }
}

// ------------------------------------------------------- 2. state pass ---

__global__ void __launch_bounds__(NT)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                  const float* __restrict__ init,
                  float* __restrict__ final_state, int nh, int l, int nc,
                  int n_el) {
  const int e = blockIdx.x * NT + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= n_el) return;
  const size_t bh = (size_t)b * nh + h;
  float prev = init != nullptr ? init[bh * n_el + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t k = ((size_t)b * nc + c) * nh + h;
    const float own = states[k * n_el + e];
    states[k * n_el + e] = prev;  // the state entering chunk c
    prev = prev * expf(cum[k * l + l - 1]) + own;
  }
  final_state[bh * n_el + e] = prev;
}

// -------------------------------------------------------- 3. chunk scan ---

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(NT)
chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ cum,
                  const float* __restrict__ entering, T* __restrict__ y,
                  int S, int nh, int g, int l, int nc) {
  constexpr int WB = TJ > HD ? TJ : HD;
  extern __shared__ __align__(16) float smem[];
  float* cT = smem;            // DS x TI: C of the rows, k-major
  float* bT = cT + DS * TI;    // DS x TJ: B of the columns, k-major
                               // (first DS x HD: the entering state)
  float* xs = bT + DS * WB;    // TJ x HD: x of the columns
  float* mT = xs + TJ * HD;    // TJ x TI: decay-masked scores, k-major
  float* ci = mT + TJ * TI;    // TI: cum of the rows
  float* cj = ci + TI;         // TJ: cum of the columns
  float* dj = cj + TJ;         // TJ: dt of the columns
  const int n_it = (l + TI - 1) / TI;
  const int c = blockIdx.x / n_it, i0 = (blockIdx.x % n_it) * TI;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (nh / g);
  const int t0 = c * l;
  const size_t k = ((size_t)b * nc + c) * nh + h;
  const float* cumk = cum + k * l;

  for (int e = threadIdx.x; e < TI * DS; e += NT) {
    const int r = e / DS, n = e % DS, i = i0 + r, pos = t0 + i;
    cT[n * TI + r] =
        (i < l && pos < S)
            ? to_f32(Cm[(((size_t)b * S + pos) * g + grp) * DS + n])
            : 0.f;
  }
  for (int r = threadIdx.x; r < TI; r += NT)
    ci[r] = i0 + r < l ? cumk[i0 + r] : 0.f;
  const float* ent = entering + k * (HD * DS);
  for (int e = threadIdx.x; e < HD * DS; e += NT) {
    const int p = e / DS, n = e % DS;
    bT[n * HD + p] = ent[e];
  }
  __syncthreads();

  // the entering state's term: exp(cum_i) C_i · state
  Tiles<TI, HD> acc;
  acc.zero();
  acc.mac(cT, bT, DS);
#pragma unroll
  for (int t = 0; t < Tiles<TI, HD>::PER; ++t) {
    int r0, c0;
    if (!Tiles<TI, HD>::at(t, r0, c0)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float decay = expf(ci[r0 + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[t][i][j] *= decay;
    }
  }
  __syncthreads();

  // the intra-chunk term, column tiles j0 <= the last row of this tile
  const int j_end = min(i0 + TI, l);
  for (int j0 = 0; j0 < j_end; j0 += TJ) {
    for (int e = threadIdx.x; e < TJ * DS; e += NT) {
      const int jj = e / DS, n = e % DS, j = j0 + jj, pos = t0 + j;
      bT[n * TJ + jj] =
          (j < l && pos < S)
              ? to_f32(Bm[(((size_t)b * S + pos) * g + grp) * DS + n])
              : 0.f;
    }
    for (int e = threadIdx.x; e < TJ * HD; e += NT) {
      const int jj = e / HD, p = e % HD, j = j0 + jj, pos = t0 + j;
      xs[e] = (j < l && pos < S)
                  ? to_f32(x[(((size_t)b * S + pos) * nh + h) * HD + p])
                  : 0.f;
    }
    for (int jj = threadIdx.x; jj < TJ; jj += NT) {
      const int j = j0 + jj, pos = t0 + j;
      cj[jj] = j < l ? cumk[j] : 0.f;
      dj[jj] = (j < l && pos < S) ? dt[((size_t)b * S + pos) * nh + h] : 0.f;
    }
    __syncthreads();
    Tiles<TI, TJ> sc;
    sc.zero();
    sc.mac(cT, bT, DS);  // C_i · B_j
#pragma unroll
    for (int t = 0; t < Tiles<TI, TJ>::PER; ++t) {
      int r0, c0;
      if (!Tiles<TI, TJ>::at(t, r0, c0)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + i, q = c0 + j;
          float m = 0.f;
          if (j0 + q <= i0 + r)  // mask before exp
            m = sc.v[t][i][j] * expf(ci[r] - cj[q]) * dj[q];
          mT[q * TI + r] = m;
        }
    }
    __syncthreads();
    acc.mac(mT, xs, TJ);
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < Tiles<TI, HD>::PER; ++t) {
    int r0, c0;
    if (!Tiles<TI, HD>::at(t, r0, c0)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = t0 + i0 + r0 + i;
      if (i0 + r0 + i >= l || pos >= S) continue;
      T* out = y + (((size_t)b * S + pos) * nh + h) * HD + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = from_f32<T>(acc.v[t][i][j]);
    }
  }
}

template <typename T, int HD, int DS>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* final_state,
           void* cum, void* states, int B, int S, int nh, int g, int l,
           cudaStream_t s) {
  constexpr int WB = TJ > HD ? TJ : HD;
  const int nc = (S + l - 1) / l;
  const int n_it = (l + TI - 1) / TI;
  const int smem1 = (TK * HD + TK * DS + 2 * l) * (int)sizeof(float);
  const int smem3 = (DS * TI + DS * WB + TJ * HD + TJ * TI + TI + 2 * TJ) *
                    (int)sizeof(float);
  auto k1 = &chunk_state_kernel<T, HD, DS>;
  auto k3 = &chunk_scan_kernel<T, HD, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return (int)err;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* dtt = static_cast<const float*>(dt);
  float* cumt = static_cast<float*>(cum);
  float* st = static_cast<float*>(states);
  k1<<<dim3(nc, nh, B), NT, smem1, s>>>(
      xt, dtt, static_cast<const float*>(A), bt, cumt, st, S, nh, g, l, nc);
  state_pass_kernel<<<dim3((HD * DS + NT - 1) / NT, nh, B), NT, 0, s>>>(
      st, cumt, static_cast<const float*>(init),
      static_cast<float*>(final_state), nh, l, nc, HD * DS);
  k3<<<dim3(n_it * nc, nh, B), NT, smem3, s>>>(
      xt, dtt, bt, ct, cumt, st, static_cast<T*>(y), S, nh, g, l, nc);
  return (int)cudaGetLastError();
}

// Only the (head dim, state width) pairs the configurations use are
// instantiated (ssd_scan.py _SHAPES keeps the list the wrapper accepts).
template <typename T>
int launch_shape(int hd, int ds, const void* x, const void* dt,
                 const void* A, const void* Bm, const void* Cm,
                 const void* init, void* y, void* final_state, void* cum,
                 void* states, int B, int S, int nh, int g, int l,
                 cudaStream_t s) {
  if (hd == 64 && ds == 128)  // mamba2-370m
    return launch<T, 64, 128>(x, dt, A, Bm, Cm, init, y, final_state, cum,
                              states, B, S, nh, g, l, s);
  if (hd == 64 && ds == 64)   // zamba2-1.2b
    return launch<T, 64, 64>(x, dt, A, Bm, Cm, init, y, final_state, cum,
                             states, B, S, nh, g, l, s);
  if (hd == 32 && ds == 16)   // both, reduced to d_model 128
    return launch<T, 32, 16>(x, dt, A, Bm, Cm, init, y, final_state, cum,
                             states, B, S, nh, g, l, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// init_state may be null (zeros). cum (B, nc, nh, l) and states
// (B, nc, nh, hd, ds) are f32 scratch the caller allocates.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm,
                        const void* init_state, void* y, void* final_state,
                        void* cum, void* states, int B, int S, int nh,
                        int hd, int g, int ds, int l, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || l < 1 || g < 1 || nh % g != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_shape<float>(hd, ds, x, dt, A, Bm, Cm, init_state, y,
                               final_state, cum, states, B, S, nh, g, l, s);
  return launch_shape<__nv_bfloat16>(hd, ds, x, dt, A, Bm, Cm, init_state,
                                     y, final_state, cum, states, B, S, nh,
                                     g, l, s);
}
