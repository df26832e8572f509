// ssd_scan_bwd — the gradient of ssd_scan (ssd_scan.cu).
//
// The Pallas kernel `ssd_scan` of src/repro/kernels/ssd_scan.py:66 has no
// backward of its own: the JAX package differentiates the function the
// model calls, src/repro/models/ssm.py `ssd_chunked` (:87). This is the
// gradient of that function for the cotangents dy (B, S, nh, hd) and
// d_final (B, nh, hd, ds) or null (zeros: no loss reads the final state
// on the train path). Per (b, head h, chunk c), with cum the in-chunk
// cumulative sum of dt·A, L_ij = exp(cum_i - cum_j) where j <= i,
// s_ij = C_i·B_j, q_ij = dy_i·x_j, H_c the state entering chunk c and
// D_c = dH_{c+1} (dH_nc = d_final):
//   G_c   = Σ_i exp(cum_i) dy_i C_iᵀ                         (hd x ds)
//   dH_c  = exp(cum_last) D_c + G_c,   d_init_state = dH_0
//   v_j   = Σ_{i>=j} s_ij L_ij dy_i + exp(cum_last - cum_j) D_c B_j
//   dx_j  = dt_j v_j,   ddt_j = x_j·v_j + A da_j
//   dC_i  = Σ_{j<=i} q_ij L_ij dt_j B_j + exp(cum_i) H_cᵀ dy_i
//   dB_j  = Σ_{i>=j} q_ij L_ij dt_j C_i + exp(cum_last - cum_j) dt_j D_cᵀ x_j
//   dcum_i = Σ_{j<i} w_ij - Σ_{k>i} w_ki + C_i·(exp(cum_i) H_cᵀ dy_i) - r_i,
//            w_ij = q_ij s_ij L_ij dt_j,
//            r_j = exp(cum_last - cum_j) dt_j x_j·(D_c B_j),
//   and cum_last's cotangent also gets exp(cum_last) <D_c, H_c> + Σ_j r_j;
//   da = the reverse in-chunk cumulative sum of dcum, dA = Σ dt da,
//   dB and dC summed over each group's heads.
// (kernels/ssd_scan.py ssd_scan_bwd_plain is the same, step by step.)
//
// What bounds it on the H100 (published peaks of the SXM part at 700 W:
// 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s). At mamba2-370m's
// training shape (B 8, S 512, nh 32, hd 64, ds 128, chunk 256, one
// group, no states given) the function does ~23.7 GFLOP
// (chip_smoke.py ssd_bwd_work): the causal halves of the l x l products
// (s, q, v, dC, dB: l^2 (3 ds + 2 hd) a chunk) and the hd x ds products
// a position that the data needs (S_c, G_c, the two D_c terms, H_cᵀ
// dy): 0.35 ms at the f32 rate, against 0.035 ms for its 118 MB in f32
// (x, dy, dx 34 MB each; 8 MB for d_init_state). zamba2-1.2b (nh 64,
// ds 64, chunk 128): ~19.5 GFLOP and 216 MB, 0.29 ms. Bound by
// operations in f32 (the training path's dtype). With bf16 inputs the
// same work at the tensor cores' 989 TFLOP/s would be bound by bytes;
// this kernel widens them and stays on the f32 CUDA cores.
//
// Design: simple and right, f32 FMAs on the CUDA cores in 4 x 4
// register tiles out of shared memory (bf16 inputs widened on load),
// five launches, Mamba2's own backward split:
//   1. chunk_state, per (chunk, head, b): cum (one thread, position
//      order), the chunk's own state S_c and G_c, both hd x ds.
//   2. state_pass, per (head, b), serial over the chunks: forward, the
//      entering states H_c (written over S_c); reverse, D_c (written over
//      G_c), d_init_state and exp(cum_last) <D_c, H_c> (a block sum in a
//      fixed tree).
//   3. chunk, per (64-position tile, chunk, head, b), two roles in one
//      grid: a column tile J walks the row tiles I >= J for v, so dx and
//      ddt's x·v, the per-head dB and the column half of dcum; a row
//      tile I walks J <= I for the per-head dC and the row half of dcum.
//      Each recomputes the two tiles' s and q (about 20 % more
//      operations than sharing them, in exchange for no cross-block
//      sum); the l x l blocks never leave shared memory.
//   4. dcum, per (chunk, head, b): the two halves and cum_last's terms,
//      the reverse cumulative sum by one thread, ddt += A da, the
//      chunk's dA partial.
//   5. groups: dB and dC summed over a group's heads in head order, cast
//      to the input dtype; dA summed over (b, chunk) in order.
// Save or recompute: the forward keeps nothing for this (SsdScan saves
// only the inputs); cum and the entering states are recomputed in
// passes 1 and 2, ~10 % of the operations, and under the train step's
// per-layer remat the forward runs again before this anyway.
// Group sums: the per-head dB and dC partials are written to f32
// scratches (B, S, nh, ds) and summed by pass 5 in head order: ~65 MB
// each for mamba2 at 8 x 500, written once and read once, ~80 us of
// traffic for the two, rather than one block walking a group's 32 or 64
// heads, which would leave 64 blocks for 132 SMs.
// No float atomics: every sum runs in a fixed order, so two calls give
// the same bits. exp is taken only where j <= i: above the diagonal
// cum_i - cum_j > 0 (up to ~+280 over 256 positions) would overflow,
// and inf · 0 is NaN; every other exponent here is <= 0. Positions >= S
// (the ragged last chunk) are read as zeros, never written, and cum is
// flat over them, as the forward's zero padding gives.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TT = 64;   // positions per tile of pass 3 (rows and columns)
constexpr int TK = 32;   // pass 1: positions per step

using bf16 = __nv_bfloat16;

// four consecutive elements as f32 (16-byte / 8-byte loads)
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p);
template <>
__device__ __forceinline__ float4 ld4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 ld4<bf16>(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
  return make_float4(__bfloat162float(v[0]), __bfloat162float(v[1]),
                     __bfloat162float(v[2]), __bfloat162float(v[3]));
}

// An R x C f32 product held in registers: 4 x 4 outputs per tile, the
// tiles dealt to the block's threads round robin (ssd_scan.cu's).
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

  // row r scaled by f[r] (shared memory)
  __device__ __forceinline__ void scale_rows(const float* f) {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      int r0, c0;
      if (!at(t, r0, c0)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[t][i][j] *= f[r0 + i];
    }
  }

  // dst[r * ld + c] = v[r][c]
  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      int r0, c0;
      if (!at(t, r0, c0)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[(r0 + i) * ld + c0 + j] = v[t][i][j];
    }
  }

  // rows r < rows of v to dst + r * rs (a global f32 row, 16-byte
  // aligned), four columns a store
  __device__ __forceinline__ void store_rows(float* dst, size_t rs,
                                            int rows) const {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      int r0, c0;
      if (!at(t, r0, c0)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < rows)
          *reinterpret_cast<float4*>(dst + (r0 + i) * rs + c0) =
              make_float4(v[t][i][0], v[t][i][1], v[t][i][2], v[t][i][3]);
    }
  }
};

// Chunk rows r0 .. r0 + R - 1 of a W-wide operand into shared memory as
// f32, zero from row vl on: transposed, dst[w * R + r] (consecutive
// threads take consecutive rows, so the scalar stores hit no bank
// twice), or in the global layout, dst[r * W + w]. Row r of the chunk
// is at base + r * rs.
template <typename T, int W, int R>
__device__ __forceinline__ void stage_t(float* dst, const T* base, size_t rs,
                                        int r0, int vl) {
  for (int e = threadIdx.x; e < R * (W / 4); e += NT) {
    const int r = e % R, w4 = (e / R) * 4, row = r0 + r;
    const float4 v = row < vl ? ld4(base + row * rs + w4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(w4 + 0) * R + r] = v.x;
    dst[(w4 + 1) * R + r] = v.y;
    dst[(w4 + 2) * R + r] = v.z;
    dst[(w4 + 3) * R + r] = v.w;
  }
}
template <typename T, int W, int R>
__device__ __forceinline__ void stage_n(float* dst, const T* base, size_t rs,
                                        int r0, int vl) {
  for (int e = threadIdx.x; e < R * (W / 4); e += NT) {
    const int r = e / (W / 4), w4 = (e % (W / 4)) * 4, row = r0 + r;
    *reinterpret_cast<float4*>(dst + r * W + w4) =
        row < vl ? ld4(base + row * rs + w4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T>
struct Args {
  const T* x;
  const float* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  const float* init;    // (B, nh, hd, ds) or null
  const T* dy;
  const float* dfinal;  // (B, nh, hd, ds) or null
  T* dx;
  float* ddt;
  float* dA;
  T* dBm;
  T* dCm;
  float* dinit;
  float* cum;       // (B, nc, nh, l)
  float* hs;        // (B, nc, nh, hd, ds): S_c, then H_c
  float* gs;        // (B, nc, nh, hd, ds): G_c, then D_c
  float* dlast;     // (B, nc, nh)
  float* dcum_row;  // (B, nc, nh, l)
  float* dcum_col;  // (B, nc, nh, l)
  float* rpos;      // (B, nc, nh, l): r_j
  float* dA_part;   // (B, nc, nh)
  float* dBh;       // (B, S, nh, ds)
  float* dCh;       // (B, S, nh, ds)
  int B, S, nh, g, l, nc, nt;
};

// ------------------------------------------------------ 1. chunk state ---

// per (chunk, head, b): cum; S_c = Σ_j (x_j exp(cum_last - cum_j) dt_j)
// B_jᵀ and G_c = Σ_i (dy_i exp(cum_i)) C_iᵀ, k running over positions
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(NT)
ssd_bwd_chunk_state_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // TK x HD: scaled x
  float* bs = xs + TK * HD;    // TK x DS: B
  float* ys = bs + TK * DS;    // TK x HD: scaled dy
  float* cs = ys + TK * HD;    // TK x DS: C
  float* dts = cs + TK * DS;   // l: dt of the chunk
  float* cms = dts + a.l;      // l: cum of the chunk
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int l = a.l, S = a.S, nh = a.nh, g = a.g;
  const int grp = h / (nh / g);
  const int t0 = c * l, vl = min(l, S - t0);
  const size_t k = ((size_t)b * a.nc + c) * nh + h;
  const size_t pos0 = (size_t)b * S + t0;
  const T* xb = a.x + pos0 * nh * HD + (size_t)h * HD;
  const T* yb = a.dy + pos0 * nh * HD + (size_t)h * HD;
  const T* bb = a.Bm + pos0 * g * DS + (size_t)grp * DS;
  const T* cb = a.Cm + pos0 * g * DS + (size_t)grp * DS;

  for (int j = threadIdx.x; j < l; j += NT)
    dts[j] = j < vl ? a.dt[(pos0 + j) * nh + h] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {  // in position order, as a sequential cumsum
    const float av = a.A[h];
    float run = 0.f;
    for (int j = 0; j < l; ++j) {
      run += dts[j] * av;
      cms[j] = run;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < l; j += NT) a.cum[k * l + j] = cms[j];
  const float last = cms[l - 1];

  Tiles<HD, DS> accS, accG;
  accS.zero();
  accG.zero();
  for (int j0 = 0; j0 < l; j0 += TK) {
    for (int e = threadIdx.x; e < TK * (HD / 4); e += NT) {
      const int jj = e / (HD / 4), p4 = (e % (HD / 4)) * 4, j = j0 + jj;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
      if (j < vl) {
        const float sx = expf(last - cms[j]) * dts[j], sy = expf(cms[j]);
        xv = ld4(xb + (size_t)j * nh * HD + p4);
        yv = ld4(yb + (size_t)j * nh * HD + p4);
        xv = make_float4(xv.x * sx, xv.y * sx, xv.z * sx, xv.w * sx);
        yv = make_float4(yv.x * sy, yv.y * sy, yv.z * sy, yv.w * sy);
      }
      *reinterpret_cast<float4*>(xs + jj * HD + p4) = xv;
      *reinterpret_cast<float4*>(ys + jj * HD + p4) = yv;
    }
    stage_n<T, DS, TK>(bs, bb, (size_t)g * DS, j0, vl);
    stage_n<T, DS, TK>(cs, cb, (size_t)g * DS, j0, vl);
    __syncthreads();
    accS.mac(xs, bs, TK);
    accG.mac(ys, cs, TK);
    __syncthreads();
  }
  accS.store_rows(a.hs + k * (HD * DS), DS, HD);
  accG.store_rows(a.gs + k * (HD * DS), DS, HD);
}

// ------------------------------------------------------- 2. state pass ---

// per (head, b), serial over the chunks; thread t holds elements t,
// t + NT, ... of the hd x ds state (coalesced)
template <int HD, int DS>
__global__ void __launch_bounds__(NT)
ssd_bwd_state_pass_kernel(float* __restrict__ hs, float* __restrict__ gs,
                      const float* __restrict__ cum,
                      const float* __restrict__ init,
                      const float* __restrict__ dfinal,
                      float* __restrict__ dlast, float* __restrict__ dinit,
                      int nh, int l, int nc) {
  constexpr int N_EL = HD * DS, EPT = N_EL / NT;
  static_assert(N_EL % NT == 0, "state elements per thread");
  __shared__ float red[NT];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * nh + h;
  float st[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u)
    st[u] = init != nullptr ? init[bh * N_EL + threadIdx.x + u * NT] : 0.f;
  for (int c = 0; c < nc; ++c) {  // the entering states over S_c
    const size_t k = ((size_t)b * nc + c) * nh + h;
    const float decay = expf(cum[k * l + l - 1]);
    float* hk = hs + k * N_EL;
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = threadIdx.x + u * NT;
      const float own = hk[e];
      hk[e] = st[u];
      st[u] = st[u] * decay + own;
    }
  }
#pragma unroll
  for (int u = 0; u < EPT; ++u)
    st[u] = dfinal != nullptr ? dfinal[bh * N_EL + threadIdx.x + u * NT]
                              : 0.f;
  for (int c = nc - 1; c >= 0; --c) {  // D_c over G_c, reverse order
    const size_t k = ((size_t)b * nc + c) * nh + h;
    const float decay = expf(cum[k * l + l - 1]);
    const float* hk = hs + k * N_EL;
    float* gk = gs + k * N_EL;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = threadIdx.x + u * NT;
      part = fmaf(st[u], hk[e], part);
      const float gv = gk[e];
      gk[e] = st[u];
      st[u] = st[u] * decay + gv;
    }
    red[threadIdx.x] = part;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) dlast[k] = decay * red[0];
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < EPT; ++u)
    dinit[bh * N_EL + threadIdx.x + u * NT] = st[u];
}

// ------------------------------------------------------------ 3. chunk ---

// Shared-memory layout of pass 3 (floats), both roles; a role's first
// phase reuses the loop's buffers.
template <int HD, int DS>
struct Lay {
  static constexpr int BT = 0;                   // DS x TT: B cols, [n][j]
  static constexpr int XT = BT + DS * TT;        // HD x TT: x cols, [p][j]
  static constexpr int CT = XT + HD * TT;        // DS x TT: C rows, [n][i]
  static constexpr int DYT = CT + DS * TT;       // HD x TT: dy rows, [p][i]
  static constexpr int DYN = DYT + HD * TT;      // TT x HD: dy rows, [i][p]
  static constexpr int CN = DYN + TT * HD;       // TT x DS: C rows [i][n]
                                                 //   (rows role: B cols)
  static constexpr int MM = CN + TT * DS;        // TT x TT: s L
  static constexpr int PP = MM + TT * TT;        // TT x TT: q L dt
  static constexpr int WW = PP + TT * TT;        // TT x TT: w
  static constexpr int VEC = WW + TT * TT;       // 8 vectors of TT
  static constexpr int FLOATS = VEC + 8 * TT;
  // the columns role's D_c, [p][n] and [n][p], over CT .. DYN
  static_assert(2 * HD * DS <= DS * TT + 2 * HD * TT, "D_c staging");
  // the rows role's H_c over BT, and its u over CN .. WW
  static_assert(HD * DS <= DS * TT && HD <= TT, "H_c staging");
};

// The s and q products of row tile i0 and column tile j0 (shared memory
// cT, bT, dyT, xT), masked: for j <= i < l, L = exp(cum_i - cum_j),
// emit(r, q, s L, q L dt_j, w) with w = q s L dt_j where j < i.
template <int HD, int DS, typename F>
__device__ __forceinline__ void tile_pair(const float* cT, const float* bT,
                                          const float* dyT, const float* xT,
                                          const float* ci, const float* cj,
                                          const float* dj, int i0, int j0,
                                          int l, F emit) {
  Tiles<TT, TT> sc, qc;
  sc.zero();
  qc.zero();
  sc.mac(cT, bT, DS);
  qc.mac(dyT, xT, HD);
#pragma unroll
  for (int t = 0; t < Tiles<TT, TT>::PER; ++t) {
    int r0, c0;
    if (!Tiles<TT, TT>::at(t, r0, c0)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + i, q = c0 + j, ia = i0 + r, ja = j0 + q;
        float m = 0.f, p = 0.f, w = 0.f;
        if (ja <= ia && ia < l) {  // mask before exp
          const float L = expf(ci[r] - cj[q]);
          m = sc.v[t][i][j] * L;
          p = qc.v[t][i][j] * L * dj[q];
          if (ja < ia) w = p * sc.v[t][i][j];
        }
        emit(r, q, m, p, w);
      }
  }
}

// columns role: tile J = [j0, j0 + TT) of chunk c
template <typename T, int HD, int DS>
__device__ __forceinline__ void chunk_cols(const Args<T>& a, float* sm,
                                           int c, int jt, int h, int b) {
  using Ly = Lay<HD, DS>;
  float* bT = sm + Ly::BT;
  float* xT = sm + Ly::XT;
  float* cT = sm + Ly::CT;
  float* dyT = sm + Ly::DYT;
  float* dyN = sm + Ly::DYN;
  float* cN = sm + Ly::CN;
  float* M = sm + Ly::MM;
  float* P = sm + Ly::PP;
  float* W = sm + Ly::WW;
  float* cj = sm + Ly::VEC;
  float* dj = cj + TT;
  float* ej = dj + TT;       // exp(cum_last - cum_j)
  float* ejd = ej + TT;      // exp(cum_last - cum_j) dt_j
  float* ci = ejd + TT;
  float* colsum = ci + TT;   // Σ_i w_ij
  float* rj = colsum + TT;
  float* dpn = cT;           // first phase: D_c [p][n]
  float* dnp = cT + HD * DS; //              D_c [n][p]
  float* zb = M;             // TT x (HD + 1): z, later v
  const int nh = a.nh, g = a.g, l = a.l, S = a.S;
  const int grp = h / (nh / g);
  const int t0 = c * l, vl = min(l, S - t0), j0 = jt * TT;
  const size_t k = ((size_t)b * a.nc + c) * nh + h;
  const size_t pos0 = (size_t)b * S + t0;
  const size_t xrs = (size_t)nh * HD, brs = (size_t)g * DS;
  const T* xb = a.x + pos0 * xrs + (size_t)h * HD;
  const T* yb = a.dy + pos0 * xrs + (size_t)h * HD;
  const T* bb = a.Bm + pos0 * brs + (size_t)grp * DS;
  const T* cb = a.Cm + pos0 * brs + (size_t)grp * DS;
  const float* cumk = a.cum + k * l;
  const float last = cumk[l - 1];

  stage_t<T, DS, TT>(bT, bb, brs, j0, vl);
  stage_t<T, HD, TT>(xT, xb, xrs, j0, vl);
  for (int q = threadIdx.x; q < TT; q += NT) {
    const int j = j0 + q;
    cj[q] = j < l ? cumk[j] : 0.f;
    dj[q] = j < vl ? a.dt[(pos0 + j) * nh + h] : 0.f;
    ej[q] = j < l ? expf(last - cj[q]) : 0.f;
    ejd[q] = ej[q] * dj[q];
    colsum[q] = 0.f;
  }
  const float* Dk = a.gs + k * (HD * DS);
  for (int e = threadIdx.x; e < HD * DS / 4; e += NT) {
    const float4 v = *reinterpret_cast<const float4*>(Dk + 4 * e);
    const int p = (4 * e) / DS, n = (4 * e) % DS;
    *reinterpret_cast<float4*>(dpn + p * DS + n) = v;
    dnp[(n + 0) * HD + p] = v.x;
    dnp[(n + 1) * HD + p] = v.y;
    dnp[(n + 2) * HD + p] = v.z;
    dnp[(n + 3) * HD + p] = v.w;
  }
  __syncthreads();
  // the state terms: z_j = exp(cum_last - cum_j) D_c B_j starts v, and
  // exp(cum_last - cum_j) dt_j D_cᵀ x_j starts dB
  Tiles<TT, HD> vacc;
  Tiles<TT, DS> dbacc;
  vacc.zero();
  dbacc.zero();
  vacc.mac(bT, dnp, DS);
  dbacc.mac(xT, dpn, HD);
  vacc.scale_rows(ej);
  dbacc.scale_rows(ejd);
  vacc.store(zb, HD + 1);
  __syncthreads();
  for (int q = threadIdx.x; q < TT; q += NT) {  // r_j = dt_j x_j·z_j
    float acc = 0.f;
    for (int p = 0; p < HD; ++p)
      acc = fmaf(xT[p * TT + q], zb[q * (HD + 1) + p], acc);
    rj[q] = dj[q] * acc;
  }
  __syncthreads();

  for (int i0 = j0; i0 < l; i0 += TT) {
    stage_t<T, DS, TT>(cT, cb, brs, i0, vl);
    stage_t<T, HD, TT>(dyT, yb, xrs, i0, vl);
    stage_n<T, HD, TT>(dyN, yb, xrs, i0, vl);
    stage_n<T, DS, TT>(cN, cb, brs, i0, vl);
    for (int r = threadIdx.x; r < TT; r += NT)
      ci[r] = i0 + r < l ? cumk[i0 + r] : 0.f;
    __syncthreads();
    tile_pair<HD, DS>(cT, bT, dyT, xT, ci, cj, dj, i0, j0, l,
                      [&](int r, int q, float m, float p, float w) {
                        M[r * TT + q] = m;
                        P[r * TT + q] = p;
                        W[r * TT + q] = w;
                      });
    __syncthreads();
    vacc.mac(M, dyN, TT);   // v_j += Σ_i s_ij L_ij dy_i
    dbacc.mac(P, cN, TT);   // dB_j += Σ_i q_ij L_ij dt_j C_i
    for (int q = threadIdx.x; q < TT; q += NT) {
      float s = colsum[q];
      for (int r = 0; r < TT; ++r) s += W[r * TT + q];
      colsum[q] = s;
    }
    __syncthreads();
  }

  vacc.store(zb, HD + 1);
  __syncthreads();
  T* dxb = a.dx + pos0 * xrs + (size_t)h * HD;
  for (int e = threadIdx.x; e < TT * HD; e += NT) {
    const int q = e / HD, p = e % HD, j = j0 + q;
    if (j < vl)
      dxb[(size_t)j * xrs + p] = from_f32<T>(dj[q] * zb[q * (HD + 1) + p]);
  }
  for (int q = threadIdx.x; q < TT; q += NT) {
    const int j = j0 + q;
    if (j >= l) continue;
    if (j < vl) {   // ddt_j = x_j·v_j (pass 4 adds A da_j)
      float acc = 0.f;
      for (int p = 0; p < HD; ++p)
        acc = fmaf(xT[p * TT + q], zb[q * (HD + 1) + p], acc);
      a.ddt[(pos0 + j) * nh + h] = acc;
    }
    a.dcum_col[k * l + j] = -colsum[q] - rj[q];
    a.rpos[k * l + j] = rj[q];
  }
  dbacc.store_rows(a.dBh + ((pos0 + j0) * nh + h) * DS, (size_t)nh * DS,
                   vl - j0);
}

// rows role: tile I = [i0, i0 + TT) of chunk c
template <typename T, int HD, int DS>
__device__ __forceinline__ void chunk_rows(const Args<T>& a, float* sm,
                                           int c, int it, int h, int b) {
  using Ly = Lay<HD, DS>;
  float* bT = sm + Ly::BT;
  float* xT = sm + Ly::XT;
  float* cT = sm + Ly::CT;
  float* dyT = sm + Ly::DYT;
  float* bN = sm + Ly::CN;
  float* PT = sm + Ly::PP;   // [j][i]
  float* WT = sm + Ly::WW;   // [j][i]
  float* ci = sm + Ly::VEC;
  float* ei = ci + TT;       // exp(cum_i)
  float* cj = ei + TT;
  float* dj = cj + TT;
  float* rowsum = dj + TT;
  float* hn = bT;            // first phase: H_c [p][n]
  float* ub = bN;            // TT x (DS + 1): u
  const int nh = a.nh, g = a.g, l = a.l, S = a.S;
  const int grp = h / (nh / g);
  const int t0 = c * l, vl = min(l, S - t0), i0 = it * TT;
  const size_t k = ((size_t)b * a.nc + c) * nh + h;
  const size_t pos0 = (size_t)b * S + t0;
  const size_t xrs = (size_t)nh * HD, brs = (size_t)g * DS;
  const T* xb = a.x + pos0 * xrs + (size_t)h * HD;
  const T* yb = a.dy + pos0 * xrs + (size_t)h * HD;
  const T* bb = a.Bm + pos0 * brs + (size_t)grp * DS;
  const T* cb = a.Cm + pos0 * brs + (size_t)grp * DS;
  const float* cumk = a.cum + k * l;

  stage_t<T, DS, TT>(cT, cb, brs, i0, vl);
  stage_t<T, HD, TT>(dyT, yb, xrs, i0, vl);
  for (int r = threadIdx.x; r < TT; r += NT) {
    const int i = i0 + r;
    ci[r] = i < l ? cumk[i] : 0.f;
    ei[r] = i < l ? expf(ci[r]) : 0.f;
  }
  const float* Hk = a.hs + k * (HD * DS);
  for (int e = threadIdx.x; e < HD * DS / 4; e += NT)
    *reinterpret_cast<float4*>(hn + 4 * e) =
        *reinterpret_cast<const float4*>(Hk + 4 * e);
  __syncthreads();
  // the entering state's term u_i = exp(cum_i) H_cᵀ dy_i starts dC, and
  // C_i·u_i starts the row half of dcum
  Tiles<TT, DS> cacc;
  cacc.zero();
  cacc.mac(dyT, hn, HD);
  cacc.scale_rows(ei);
  cacc.store(ub, DS + 1);
  __syncthreads();
  for (int r = threadIdx.x; r < TT; r += NT) {
    float acc = 0.f;
    for (int n = 0; n < DS; ++n)
      acc = fmaf(cT[n * TT + r], ub[r * (DS + 1) + n], acc);
    rowsum[r] = acc;
  }
  __syncthreads();

  for (int j0 = 0; j0 <= i0; j0 += TT) {
    stage_t<T, DS, TT>(bT, bb, brs, j0, vl);
    stage_t<T, HD, TT>(xT, xb, xrs, j0, vl);
    stage_n<T, DS, TT>(bN, bb, brs, j0, vl);
    for (int q = threadIdx.x; q < TT; q += NT) {
      const int j = j0 + q;
      cj[q] = j < l ? cumk[j] : 0.f;
      dj[q] = j < vl ? a.dt[(pos0 + j) * nh + h] : 0.f;
    }
    __syncthreads();
    tile_pair<HD, DS>(cT, bT, dyT, xT, ci, cj, dj, i0, j0, l,
                      [&](int r, int q, float, float p, float w) {
                        PT[q * TT + r] = p;
                        WT[q * TT + r] = w;
                      });
    __syncthreads();
    cacc.mac(PT, bN, TT);   // dC_i += Σ_j q_ij L_ij dt_j B_j
    for (int r = threadIdx.x; r < TT; r += NT) {
      float s = rowsum[r];
      for (int q = 0; q < TT; ++q) s += WT[q * TT + r];
      rowsum[r] = s;
    }
    __syncthreads();
  }

  for (int r = threadIdx.x; r < TT; r += NT)
    if (i0 + r < l) a.dcum_row[k * l + i0 + r] = rowsum[r];
  cacc.store_rows(a.dCh + ((pos0 + i0) * nh + h) * DS, (size_t)nh * DS,
                  vl - i0);
}

// blockIdx.x < nt · nc: a column tile, else a row tile
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(NT) ssd_bwd_chunk_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = a.nt * a.nc;
  const bool cols = (int)blockIdx.x < n;
  const int idx = cols ? blockIdx.x : blockIdx.x - n;
  const int c = idx / a.nt, t = idx % a.nt;
  if (cols)
    chunk_cols<T, HD, DS>(a, smem, c, t, h, b);
  else
    chunk_rows<T, HD, DS>(a, smem, c, t, h, b);
}

// ------------------------------------------------------------- 4. dcum ---

// per (chunk, head, b): dcum = row + column halves, cum_last's terms (Σ_j
// r_j by warp 0: each lane in position order, then a fixed shuffle tree),
// the reverse cumulative sum da (one thread, position order), ddt += A da
// and the chunk's dA partial Σ dt da
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dcum_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* dc = smem;        // l
  float* dts = dc + a.l;   // l
  float* rs = dts + a.l;   // l: r_j
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int l = a.l, nh = a.nh;
  const int vl = min(l, a.S - c * l);
  const size_t k = ((size_t)b * a.nc + c) * nh + h;
  const size_t pos0 = (size_t)b * a.S + c * l;
  for (int j = threadIdx.x; j < l; j += NT) {
    dc[j] = a.dcum_row[k * l + j] + a.dcum_col[k * l + j];
    dts[j] = j < vl ? a.dt[(pos0 + j) * nh + h] : 0.f;
    rs[j] = a.rpos[k * l + j];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float r = 0.f;
    for (int j = threadIdx.x; j < l; j += 32) r += rs[j];
    for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
    if (threadIdx.x == 0) dc[l - 1] += a.dlast[k] + r;
  }
  if (threadIdx.x == 0) {
    float run = 0.f, dA = 0.f;
    for (int j = l - 1; j >= 0; --j) {
      run += dc[j];
      dc[j] = run;
      dA = fmaf(dts[j], run, dA);
    }
    a.dA_part[k] = dA;
  }
  __syncthreads();
  const float av = a.A[h];
  for (int j = threadIdx.x; j < vl; j += NT)
    a.ddt[(pos0 + j) * nh + h] += av * dc[j];
}

// ----------------------------------------------------------- 5. groups ---

// dBm, dCm (B, S, g, ds) = the per-head partials summed over the group's
// heads in head order; block 0 also sums dA over (b, chunk) in order
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_group_kernel(const Args<T> a,
                                                       int ds) {
  const int rep = a.nh / a.g;
  const size_t total = (size_t)a.B * a.S * a.g * ds;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < total;
       e += (size_t)gridDim.x * NT) {
    const size_t bs = e / ((size_t)a.g * ds);
    const int grp = (int)((e / ds) % a.g), n = (int)(e % ds);
    const size_t src = (bs * a.nh + (size_t)grp * rep) * ds + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += a.dBh[src + (size_t)r * ds];
      sc += a.dCh[src + (size_t)r * ds];
    }
    a.dBm[e] = from_f32<T>(sb);
    a.dCm[e] = from_f32<T>(sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < a.nh; h += NT) {
      float s = 0.f;
      for (int b = 0; b < a.B; ++b)
        for (int c = 0; c < a.nc; ++c)
          s += a.dA_part[((size_t)b * a.nc + c) * a.nh + h];
      a.dA[h] = s;
    }
}

template <typename T, int HD, int DS>
int launch(const Args<T>& a, cudaStream_t s) {
  const int smem1 = (2 * TK * HD + 2 * TK * DS + 2 * a.l) * (int)sizeof(float);
  const int smem3 = Lay<HD, DS>::FLOATS * (int)sizeof(float);
  const int smem4 = 3 * a.l * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_state_kernel<T, HD, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, HD, DS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_dcum_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem4);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_state_kernel<T, HD, DS>
      <<<dim3(a.nc, a.nh, a.B), NT, smem1, s>>>(a);
  ssd_bwd_state_pass_kernel<HD, DS><<<dim3(a.nh, a.B), NT, 0, s>>>(
      a.hs, a.gs, a.cum, a.init, a.dfinal, a.dlast, a.dinit, a.nh, a.l,
      a.nc);
  ssd_bwd_chunk_kernel<T, HD, DS>
      <<<dim3(2 * a.nt * a.nc, a.nh, a.B), NT, smem3, s>>>(a);
  ssd_bwd_dcum_kernel<T><<<dim3(a.nc, a.nh, a.B), NT, smem4, s>>>(a);
  const size_t total = (size_t)a.B * a.S * a.g * DS;
  const int blocks = (int)((total + NT - 1) / NT < 4096
                               ? (total + NT - 1) / NT : 4096);
  ssd_bwd_group_kernel<T><<<blocks, NT, 0, s>>>(a, DS);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(int hd, int ds, const Args<T>& a, cudaStream_t s) {
  if (hd == 64 && ds == 128) return launch<T, 64, 128>(a, s);  // mamba2
  if (hd == 64 && ds == 64) return launch<T, 64, 64>(a, s);    // zamba2
  if (hd == 32 && ds == 16) return launch<T, 32, 16>(a, s);    // reduced
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* x, const void* dt, const void* A, const void* Bm,
        const void* Cm, const void* init, const void* dy,
        const void* dfinal, void* dx, void* ddt, void* dA, void* dBm,
        void* dCm, void* dinit, void* cum, void* hs, void* gs, void* dlast,
        void* dcum_row, void* dcum_col, void* rpos, void* dA_part,
        void* dBh, void* dCh, int B, int S, int nh, int hd, int g, int ds,
        int l, cudaStream_t s) {
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const T*>(Bm);
  a.Cm = static_cast<const T*>(Cm);
  a.init = static_cast<const float*>(init);
  a.dy = static_cast<const T*>(dy);
  a.dfinal = static_cast<const float*>(dfinal);
  a.dx = static_cast<T*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dBm = static_cast<T*>(dBm);
  a.dCm = static_cast<T*>(dCm);
  a.dinit = static_cast<float*>(dinit);
  a.cum = static_cast<float*>(cum);
  a.hs = static_cast<float*>(hs);
  a.gs = static_cast<float*>(gs);
  a.dlast = static_cast<float*>(dlast);
  a.dcum_row = static_cast<float*>(dcum_row);
  a.dcum_col = static_cast<float*>(dcum_col);
  a.rpos = static_cast<float*>(rpos);
  a.dA_part = static_cast<float*>(dA_part);
  a.dBh = static_cast<float*>(dBh);
  a.dCh = static_cast<float*>(dCh);
  a.B = B;
  a.S = S;
  a.nh = nh;
  a.g = g;
  a.l = l;
  a.nc = (S + l - 1) / l;
  a.nt = (l + TT - 1) / TT;
  return launch_shape<T>(hd, ds, a, s);
}

}  // namespace

// init and dfinal may be null (zeros). The scratch tensors (shapes in
// Args) are f32 and allocated by the caller.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* init,
                            const void* dy, const void* dfinal, void* dx,
                            void* ddt, void* dA, void* dBm, void* dCm,
                            void* dinit, void* cum, void* hs, void* gs,
                            void* dlast, void* dcum_row, void* dcum_col,
                            void* rpos, void* dA_part, void* dBh, void* dCh,
                            int B, int S, int nh, int hd, int g, int ds,
                            int l, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || l < 1 || g < 1 || nh % g != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return run<float>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm,
                      dCm, dinit, cum, hs, gs, dlast, dcum_row, dcum_col,
                      rpos, dA_part, dBh, dCh, B, S, nh, hd, g, ds, l, s);
  return run<bf16>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm,
                   dCm, dinit, cum, hs, gs, dlast, dcum_row, dcum_col, rpos,
                   dA_part, dBh, dCh, B, S, nh, hd, g, ds, l, s);
}
