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
// What this design does about it. It is Mamba2's own decomposition in
// three launches, chosen over one block per (b, head) walking its chunks
// because that gives B·nh blocks (256 for mamba2 at B = 8) for 132 SMs,
// each serial over the chunks; here the heavy third pass has
// B·nc·nh·(l / 64) blocks (2048 for mamba2), and only the cheap
// elementwise state pass is serial over chunks. The price is one f32
// round trip of the chunk states (B·nc·nh·hd·ds, 17 MB for mamba2).
// In bf16 (the main path) the two heavy passes run their products on the
// tensor cores (`chunk_state_kernel_mma`, `chunk_scan_kernel_mma`):
// mma.sync m16n8k16, bf16 operands, f32 accumulation, one warp per 16
// output rows. C, B and x enter exactly. Operands are staged in bf16 by
// 16-byte cp.async copies into rows padded by 16 bytes, so the ldmatrix
// fragment loads hit no bank twice. The decay-masked scores M never
// leave registers: the S = C·Bᵀ accumulators are masked, scaled and
// rounded to bf16 in place and reused as the A fragments of M·x. The f32
// entering state (chunk_scan) and the decay-scaled x (chunk_state) are
// each split into a bf16 hi + lo pair, two products, so the carried
// state and its term keep f32-like accuracy. A warp skips the 16-column
// steps past its last row, so the masked upper half of a diagonal tile
// is mostly not computed.
// In f32 (not on the main path) the passes run on the CUDA cores, f32
// register-tiled 4 x 4 outer products out of shared memory.
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
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block: state pass, f32 passes
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

// Four consecutive elements per thread (16-byte loads and stores), and
// the loads of SP_U chunks issued before their serial chain, so each
// thread has several loads in flight instead of one per chunk.
constexpr int SP_U = 4;

__global__ void __launch_bounds__(NT)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                  const float* __restrict__ init,
                  float* __restrict__ final_state, int nh, int l, int nc,
                  int n_el) {
  const int e = (blockIdx.x * NT + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= n_el) return;
  const size_t bh = (size_t)b * nh + h;
  float4 prev = init != nullptr
                    ? *reinterpret_cast<const float4*>(init + bh * n_el + e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += SP_U) {
    float4 own[SP_U];
    float decay[SP_U];
#pragma unroll
    for (int u = 0; u < SP_U; ++u) {
      if (c0 + u >= nc) break;
      const size_t k = ((size_t)b * nc + c0 + u) * nh + h;
      own[u] = *reinterpret_cast<const float4*>(states + k * n_el + e);
      decay[u] = expf(cum[k * l + l - 1]);
    }
#pragma unroll
    for (int u = 0; u < SP_U; ++u) {
      if (c0 + u >= nc) break;
      const size_t k = ((size_t)b * nc + c0 + u) * nh + h;
      // the state entering chunk c, written over the chunk's own state
      *reinterpret_cast<float4*>(states + k * n_el + e) = prev;
      prev.x = prev.x * decay[u] + own[u].x;
      prev.y = prev.y * decay[u] + own[u].y;
      prev.z = prev.z * decay[u] + own[u].z;
      prev.w = prev.w * decay[u] + own[u].w;
    }
  }
  *reinterpret_cast<float4*>(final_state + bh * n_el + e) = prev;
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

// ------------------------------------- bf16: the passes on tensor cores ---
//
// Tiles are staged in bf16 with 16-byte copies, rows padded by 16 bytes
// so ldmatrix hits no bank twice; the products run as mma.sync m16n8k16
// (bf16 in, f32 accumulate); each warp owns 16 rows of the block's output.

using bf16 = __nv_bfloat16;
constexpr int NW = 128;  // threads per block of the mma passes (4 warps)
constexpr int TKS = 64;  // chunk_state_kernel_mma: positions per step

// f32 -> bf16 hi + bf16 lo, hi + lo = v to ~2^-17 relative
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// 1. chunk state: state[p][n] = Σ_j (x_j[p] s_j) B_j[n], s_j =
// exp(cum_last - cum_j) dt_j. A = (x s)ᵀ (M = p, K = j), staged [j][p]
// and loaded by ldmatrix.trans; the scaled x is split into bf16 hi + lo
// (two products), so the carried state keeps f32-like accuracy. B = B_j
// (K = j, N = n), staged [j][n], ldmatrix.trans. Warp w: rows p of the
// 16-row tile w.
template <int HD, int DS>
__global__ void __launch_bounds__(NW)
chunk_state_kernel_mma(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm, float* __restrict__ cum,
                       float* __restrict__ states, int S, int nh, int g,
                       int l, int nc) {
  constexpr int XP = HD + 8, BP = DS + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xh = reinterpret_cast<bf16*>(smem_raw);  // TKS x XP
  bf16* xl = xh + TKS * XP;                      // TKS x XP
  bf16* bs = xl + TKS * XP;                      // TKS x BP
  float* dts = reinterpret_cast<float*>(bs + TKS * BP);  // l
  float* cs = dts + l;                                   // l
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (nh / g);
  const int t0 = c * l;
  const size_t k = ((size_t)b * nc + c) * nh + h;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, q = lane & 3;

  for (int j = threadIdx.x; j < l; j += NW) {
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
  for (int j = threadIdx.x; j < l; j += NW) cum[k * l + j] = cs[j];
  const float last = cs[l - 1];

  float acc[DS / 8][4] = {};
  for (int j0 = 0; j0 < l; j0 += TKS) {
    for (int e = threadIdx.x; e < TKS * (DS / 8); e += NW) {
      const int jj = e / (DS / 8), n8 = (e % (DS / 8)) * 8;
      const int j = j0 + jj, pos = t0 + j;
      const bool ok = j < l && pos < S;
      cp_async16(bs + jj * BP + n8,
                 ok ? Bm + (((size_t)b * S + pos) * g + grp) * DS + n8 : Bm,
                 ok);
    }
    cp_async_commit();
    for (int e = threadIdx.x; e < TKS * (HD / 8); e += NW) {
      const int jj = e / (HD / 8), p8 = (e % (HD / 8)) * 8;
      const int j = j0 + jj, pos = t0 + j;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      float sc = 0.f;
      if (j < l && pos < S) {
        raw = *reinterpret_cast<const uint4*>(
            x + (((size_t)b * S + pos) * nh + h) * HD + p8);
        sc = expf(last - cs[j]) * dts[j];
      }
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      __align__(16) bf16 hi[8];
      __align__(16) bf16 lo[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        split_bf16(__bfloat162float(xv[u]) * sc, hi[u], lo[u]);
      *reinterpret_cast<uint4*>(xh + jj * XP + p8) =
          *reinterpret_cast<const uint4*>(hi);
      *reinterpret_cast<uint4*>(xl + jj * XP + p8) =
          *reinterpret_cast<const uint4*>(lo);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (m0 < HD) {
#pragma unroll
      for (int kt = 0; kt < TKS; kt += 16) {
        uint32_t ah[4], al[4];
        ldmatrix_x4_trans(ah, x4_addr<false>(xh, XP, kt, m0));
        ldmatrix_x4_trans(al, x4_addr<false>(xl, XP, kt, m0));
#pragma unroll
        for (int np = 0; np < DS / 16; ++np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, x4_addr<true>(bs, BP, kt, np * 16));
          mma_bf16(acc[2 * np], ah, bb[0], bb[1]);
          mma_bf16(acc[2 * np], al, bb[0], bb[1]);
          mma_bf16(acc[2 * np + 1], ah, bb[2], bb[3]);
          mma_bf16(acc[2 * np + 1], al, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  if (m0 < HD) {
    float* out = states + k * (HD * DS);
#pragma unroll
    for (int nt = 0; nt < DS / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (m0 + gq + 8 * r) * DS + nt * 8 +
                                   2 * q) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

// 3. chunk scan on tensor cores, per (64-row tile of a chunk, head, b):
// first the entering state's term exp(cum_i) C_i · state, A = C (M = i,
// K = n), B = the f32 state split into bf16 hi + lo, staged [p][n]; then
// per 64-column tile j0 <= the tile's last row, S = C_i · B_jᵀ (B = B_j
// staged [j][n]), masked and scaled in registers to M_ij = S
// exp(cum_i - cum_j) dt_j (0 where j > i), and M · x_j with M's
// accumulators reused as the A fragments (rounded to bf16) and x_j
// staged [j][p], loaded by ldmatrix.trans. A warp owns 16 rows i and
// skips the 16-column steps past its last row, so a diagonal tile costs
// about half a full one.
template <int HD, int DS>
__global__ void __launch_bounds__(NW)
chunk_scan_kernel_mma(const bf16* __restrict__ x,
                      const float* __restrict__ dt,
                      const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm,
                      const float* __restrict__ cum,
                      const float* __restrict__ entering,
                      bf16* __restrict__ y, int S, int nh, int g, int l,
                      int nc) {
  constexpr int CP = DS + 8, XP = HD + 8;
  constexpr int UNION = (2 * HD * CP > TJ * CP + TJ * XP)
                            ? 2 * HD * CP : TJ * CP + TJ * XP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // TI x CP: C of the rows
  bf16* un = cs + TI * CP;
  bf16* sh = un;            // HD x CP: entering state hi, [p][n]
  bf16* sl = un + HD * CP;  // HD x CP: entering state lo
  bf16* bs = un;            // TJ x CP: B of the columns, after the state
  bf16* xs = un + TJ * CP;  // TJ x XP: x of the columns
  float* ci = reinterpret_cast<float*>(un + UNION);  // TI
  float* cj = ci + TI;                               // TJ
  float* dj = cj + TJ;                               // TJ
  const int n_it = (l + TI - 1) / TI;
  const int c = blockIdx.x / n_it, i0 = (blockIdx.x % n_it) * TI;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (nh / g);
  const int t0 = c * l;
  const size_t k = ((size_t)b * nc + c) * nh + h;
  const float* cumk = cum + k * l;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, q = lane & 3;

  for (int e = threadIdx.x; e < TI * (DS / 8); e += NW) {
    const int r = e / (DS / 8), n8 = (e % (DS / 8)) * 8;
    const int i = i0 + r, pos = t0 + i;
    const bool ok = i < l && pos < S;
    cp_async16(cs + r * CP + n8,
               ok ? Cm + (((size_t)b * S + pos) * g + grp) * DS + n8 : Cm,
               ok);
  }
  cp_async_commit();
  for (int r = threadIdx.x; r < TI; r += NW)
    ci[r] = i0 + r < l ? cumk[i0 + r] : 0.f;
  const float4* ent =
      reinterpret_cast<const float4*>(entering + k * (HD * DS));
  for (int e = threadIdx.x; e < HD * DS / 4; e += NW) {
    const float4 v = ent[e];
    const int p = (e * 4) / DS, n = (e * 4) % DS;
    __align__(8) bf16 hi[4];
    __align__(8) bf16 lo[4];
    split_bf16(v.x, hi[0], lo[0]);
    split_bf16(v.y, hi[1], lo[1]);
    split_bf16(v.z, hi[2], lo[2]);
    split_bf16(v.w, hi[3], lo[3]);
    *reinterpret_cast<uint2*>(sh + p * CP + n) =
        *reinterpret_cast<const uint2*>(hi);
    *reinterpret_cast<uint2*>(sl + p * CP + n) =
        *reinterpret_cast<const uint2*>(lo);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the entering state's term
  float yacc[HD / 8][4] = {};
#pragma unroll
  for (int kt = 0; kt < DS; kt += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, x4_addr<true>(cs, CP, r0, kt));
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, x4_addr<false>(sh, CP, np * 16, kt));
      ldmatrix_x4(bl, x4_addr<false>(sl, CP, np * 16, kt));
      mma_bf16(yacc[2 * np], a, bh[0], bh[1]);
      mma_bf16(yacc[2 * np], a, bl[0], bl[1]);
      mma_bf16(yacc[2 * np + 1], a, bh[2], bh[3]);
      mma_bf16(yacc[2 * np + 1], a, bl[2], bl[3]);
    }
  }
  const int ia = i0 + r0 + gq, ib = ia + 8;  // this thread's two rows
  const float ca = ci[r0 + gq], cb = ci[r0 + gq + 8];
  {
    const float da = expf(ca), db = expf(cb);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      yacc[nt][0] *= da;
      yacc[nt][1] *= da;
      yacc[nt][2] *= db;
      yacc[nt][3] *= db;
    }
  }
  __syncthreads();  // the state's buffers become the column tiles'

  // the intra-chunk term, column tiles j0 <= the last row of this tile
  const int j_end = min(i0 + TI, l);
  const int last_row = min(i0 + r0 + 15, l - 1);  // this warp's
  for (int j0 = 0; j0 < j_end; j0 += TJ) {
    for (int e = threadIdx.x; e < TJ * (DS / 8); e += NW) {
      const int jj = e / (DS / 8), n8 = (e % (DS / 8)) * 8;
      const int j = j0 + jj, pos = t0 + j;
      const bool ok = j < l && pos < S;
      cp_async16(bs + jj * CP + n8,
                 ok ? Bm + (((size_t)b * S + pos) * g + grp) * DS + n8 : Bm,
                 ok);
    }
    for (int e = threadIdx.x; e < TJ * (HD / 8); e += NW) {
      const int jj = e / (HD / 8), p8 = (e % (HD / 8)) * 8;
      const int j = j0 + jj, pos = t0 + j;
      const bool ok = j < l && pos < S;
      cp_async16(xs + jj * XP + p8,
                 ok ? x + (((size_t)b * S + pos) * nh + h) * HD + p8 : x,
                 ok);
    }
    cp_async_commit();
    for (int jj = threadIdx.x; jj < TJ; jj += NW) {
      const int j = j0 + jj, pos = t0 + j;
      cj[jj] = j < l ? cumk[j] : 0.f;
      dj[jj] = (j < l && pos < S) ? dt[((size_t)b * S + pos) * nh + h] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    // the 16-column steps this warp needs: columns j0 .. its last row
    const int nk = (max(0, min(TJ, last_row - j0 + 1)) + 15) / 16;
    float sacc[TJ / 8][4] = {};
#pragma unroll
    for (int kt = 0; kt < DS; kt += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, x4_addr<true>(cs, CP, r0, kt));
#pragma unroll
      for (int np = 0; np < TJ / 16; ++np) {
        if (np < nk) {
          uint32_t bb[4];
          ldmatrix_x4(bb, x4_addr<false>(bs, CP, np * 16, kt));
          mma_bf16(sacc[2 * np], a, bb[0], bb[1]);
          mma_bf16(sacc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int np = 0; np < TJ / 16; ++np) {
      if (np < nk) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* s = sacc[2 * np + half];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int jj = np * 16 + half * 8 + 2 * q + (r & 1);
            const int i = r < 2 ? ia : ib;
            const float cr = r < 2 ? ca : cb;
            // mask before exp: above the diagonal the exponent is > 0
            s[r] = (j0 + jj <= i && i < l)
                       ? s[r] * expf(cr - cj[jj]) * dj[jj] : 0.f;
          }
          a[2 * half] = pack_bf16(s[0], s[1]);
          a[2 * half + 1] = pack_bf16(s[2], s[3]);
        }
#pragma unroll
        for (int pp = 0; pp < HD / 16; ++pp) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, x4_addr<true>(xs, XP, np * 16, pp * 16));
          mma_bf16(yacc[2 * pp], a, bb[0], bb[1]);
          mma_bf16(yacc[2 * pp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? ib : ia, pos = t0 + i;
    if (i >= l || pos >= S) continue;
    bf16* out = y + (((size_t)b * S + pos) * nh + h) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + nt * 8 + 2 * q) =
          pack_bf16(yacc[nt][2 * r], yacc[nt][2 * r + 1]);
  }
}

template <typename T, int HD, int DS>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* final_state,
           void* cum, void* states, int B, int S, int nh, int g, int l,
           cudaStream_t s) {
  constexpr bool MMA = std::is_same<T, bf16>::value;
  constexpr int WB = TJ > HD ? TJ : HD;
  const int nc = (S + l - 1) / l;
  const int n_it = (l + TI - 1) / TI;
  int smem1, smem3, nt;
  void (*k1)(const T*, const float*, const float*, const T*, float*, float*,
             int, int, int, int, int);
  void (*k3)(const T*, const float*, const T*, const T*, const float*,
             const float*, T*, int, int, int, int, int);
  if constexpr (MMA) {
    constexpr int CP = DS + 8, XP = HD + 8;
    constexpr int UNION = (2 * HD * CP > TJ * CP + TJ * XP)
                              ? 2 * HD * CP : TJ * CP + TJ * XP;
    smem1 = (2 * TKS * XP + TKS * CP) * 2 + 2 * l * (int)sizeof(float);
    smem3 = (TI * CP + UNION) * 2 + (TI + 2 * TJ) * (int)sizeof(float);
    k1 = &chunk_state_kernel_mma<HD, DS>;
    k3 = &chunk_scan_kernel_mma<HD, DS>;
    nt = NW;
  } else {
    smem1 = (TK * HD + TK * DS + 2 * l) * (int)sizeof(float);
    smem3 = (DS * TI + DS * WB + TJ * HD + TJ * TI + TI + 2 * TJ) *
            (int)sizeof(float);
    k1 = &chunk_state_kernel<T, HD, DS>;
    k3 = &chunk_scan_kernel<T, HD, DS>;
    nt = NT;
  }
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
  k1<<<dim3(nc, nh, B), nt, smem1, s>>>(
      xt, dtt, static_cast<const float*>(A), bt, cumt, st, S, nh, g, l, nc);
  state_pass_kernel<<<dim3((HD * DS / 4 + NT - 1) / NT, nh, B), NT, 0, s>>>(
      st, cumt, static_cast<const float*>(init),
      static_cast<float*>(final_state), nh, l, nc, HD * DS);
  k3<<<dim3(n_it * nc, nh, B), nt, smem3, s>>>(
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
