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
// 67 TFLOP/s f32 outside the tensor cores, 495 TFLOP/s TF32 on them,
// 3.35 TB/s). At mamba2-370m's training shape (B 8, S 512, nh 32, hd 64,
// ds 128, chunk 256, one group, no states given) the function does ~23.7
// GFLOP (chip_smoke.py ssd_bwd_work): the causal halves of the l x l
// products (s, q, v, dC, dB: l^2 (3 ds + 2 hd) a chunk) and the hd x ds
// products a position that the data needs (S_c, G_c, the two D_c terms,
// H_cᵀ dy), against 118 MB in f32 (x, dy, dx 34 MB each). On the CUDA
// cores that is 0.35 ms, bound by operations; zamba2-1.2b (nh 64, ds 64,
// chunk 128) ~19.5 GFLOP and 216 MB, 0.29 ms. On the tensor cores at f32
// accuracy each product is three TF32 products (common.cuh, 3xTF32):
// 3 x 23.7 GFLOP at 495 TFLOP/s is 0.144 ms (zamba2 0.118), still above
// the bytes' 0.035 / 0.065 ms. A single TF32 product would hold neither
// the f32 gradient checks (1e-4 of each gradient's largest; one TF32
// product misses it by 2-7x) nor the f32 training path, so it is never
// used on f32 data. bf16 inputs are exact in TF32, so products of two
// inputs (s, q) take one mma and products of an input and a derived
// operand two; the derived operands (s L, q L dt, D_c, H_c, the scaled x
// and dy of the chunk states) keep their lo.
// What holds this design back is not the mma rate but the instructions
// around it: each operand element is split where it is read (five
// integer and float instructions, tf32_rna in common.cuh), and a ring
// tile's elements are split again by each of the 4 warps and for both of
// its products, because a split copy of the tiles would not leave room
// for two blocks an SM; then the shared-memory fragment reads.
//
// Design: five launches, Mamba2's own backward split, every product on
// mma.sync m16n8k8 in 3xTF32, operands staged by 16-byte cp.async into
// row-major shared tiles whose pitch (4 mod 8 words) makes every fragment
// read conflict-free:
//   1. chunk_state, per (chunk, head, b) and role: cum (one thread,
//      position order) and the chunk's own state S_c (role 0, from x
//      scaled by exp(cum_last - cum_j) dt_j, and B) or G_c (role 1, dy
//      scaled by exp(cum_i), and C), hd x ds, the depth (positions)
//      streamed 32 at a time through a two-stage ring; 4 warps, each a
//      block of the state's mma tiles (mamba2: 64 rows x 32 columns).
//   2. state_pass, spread over the card: each warp owns a slice of 128
//      elements of one (head, b) state (4 a lane) and runs both
//      recursions on it, serial over the chunks: forward, the entering
//      states H_c (written over S_c); reverse, D_c (written over G_c),
//      d_init_state, and its slice's part of <D_c, H_c> (a fixed shuffle
//      tree) to a (B, nc, nh, slices) scratch. The recursion is
//      elementwise, so no block-wide sum or barrier is left in it.
//   3. chunk, per (64-position tile, chunk, head, b), two roles in one
//      grid, 4 warps a block, each warp owning 16 positions of the fixed
//      tile. A column tile J (B_J, x_J fixed) walks the row positions
//      i >= j0, 32 a step through a two-stage cp.async ring of C and dy:
//      sᵀ = B_J C_Iᵀ and qᵀ = x_J dy_Iᵀ, masked and scaled in registers
//      into (s L)ᵀ and (q L dt)ᵀ, which feed v_J += (s L)ᵀ dy_I and
//      dB_J += (q L dt)ᵀ C_I as the a operand straight from the
//      accumulators (k permuted in the b reads to match), so the l x l
//      blocks never leave the registers; v_J starts as the D_c term, so
//      dx, ddt's x·v, the per-head dB and the column half of dcum come
//      out. A row tile I (C_I, dy_I fixed) walks j <= i through a ring of
//      B and x for s and q, then dC_I += (q L dt) B_J, for the per-head
//      dC (started by the H_c term) and the row half of dcum. Each role
//      recomputes the pair's s and q (about a quarter more tensor work
//      than sharing them, in exchange for no cross-block sum: on the
//      tensor cores that is cheaper than the second pass a sum would
//      need). D_c and H_c are staged over the ring before the walk. ~102
//      KB of shared memory a block at mamba2's shape, so two blocks share
//      an SM and one's loads overlap the other's products.
//   4. dcum, per (chunk, head, b): the two halves and cum_last's terms
//      (<D_c, H_c>'s slice parts summed in slice order), the reverse
//      cumulative sum by one thread, ddt += A da, the chunk's dA partial.
//   5. groups: dB and dC summed over a group's heads in head order, cast
//      to the input dtype; dA summed over (b, chunk) in order.
// Save or recompute: the forward keeps nothing for this (SsdScan saves
// only the inputs); cum and the entering states are recomputed in
// passes 1 and 2, and under the train step's per-layer remat the forward
// runs again before this anyway.
// Group sums: the per-head dB and dC partials are written to f32
// scratches (B, S, nh, ds) and summed by pass 5 in head order, rather
// than one block walking a group's 32 or 64 heads.
// No float atomics: every sum runs in a fixed order (an mma's own order
// is fixed by the hardware), so two calls give the same bits. exp is
// taken only where j <= i: above the diagonal cum_i - cum_j > 0 (up to
// ~+280 over 256 positions) would overflow, and inf · 0 is NaN; every
// other exponent here is <= 0. Positions >= S (the ragged last chunk)
// are read as zeros (cp.async zero fill), never written, and cum is flat
// over them, as the forward's zero padding gives.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 4;          // warps of a chunk_state or chunk block
constexpr int NTB = 32 * NW;   // their threads
constexpr int TT = 64;         // positions of pass 3's fixed tile (16 a warp)
constexpr int TS = 32;         // positions a ring step (passes 1 and 3)
constexpr int NTS = 128;       // threads of a state_pass block
constexpr int SLICE = 128;     // state elements a state_pass warp owns

// an input whose lo is zero: bf16 widened to f32 is exact in TF32
template <typename T>
struct Exact {
  static constexpr bool value = false;
};
template <>
struct Exact<bf16> {
  static constexpr bool value = true;
};

// the pitch, in elements, of a shared row of W features: W plus 16 bytes,
// 4 mod 8 words for every W here (a multiple of 16)
template <typename T, int W>
struct Row {
  static constexpr int P = W + 16 / (int)sizeof(T);
};

// rows r0 .. r0 + R - 1 of a W-wide operand (row r at src + r * rs) into
// dst (pitch Row::P) by 16-byte cp.async, rows >= vl zero-filled
template <typename T, int W, int R>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t rs,
                                          int r0, int vl) {
  constexpr int E = 16 / (int)sizeof(T), CH = W / E, P = Row<T, W>::P;
  for (int e = threadIdx.x; e < R * CH; e += NTB) {
    const int r = e / CH, c = (e % CH) * E, row = r0 + r;
    const bool ok = row < vl;
    cp_async16(dst + r * P + c, ok ? src + (size_t)row * rs + c : src, ok);
  }
}

// the fragments held as f32 as TF32 pairs: split, or, for an exact
// operand, reinterpreted with a zero lo
template <bool X, int N>
__device__ __forceinline__ void to_tf32(const float (&v)[N],
                                        uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
  if (X) {
#pragma unroll
    for (int e = 0; e < N; ++e) hi[e] = __float_as_uint(v[e]), lo[e] = 0u;
  } else {
    split_tf32(v, hi, lo);
  }
}

// c[n] += a · b[n] for a row of N output tiles, b[n] read by ldb(n, v):
// a split once, b split 4 tiles at a time and the terms issued across
// those 4 (mma_3xtf32); AX / BX: a / b exact in TF32
template <bool AX, bool BX, int N, typename F>
__device__ __forceinline__ void mma3_tiles(float (&c)[N][4],
                                           const float (&a)[4], F ldb) {
  constexpr int G = N < 4 ? N : 4;
  static_assert(N % G == 0, "tile groups");
  uint32_t ah[4], al[4];
  to_tf32<AX>(a, ah, al);
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += G) {
    uint32_t bh[G][2], bl[G][2];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      float v[2];
      ldb(n0 + u, v);
      to_tf32<BX>(v, bh[u], bl[u]);
    }
    mma_3xtf32<AX, BX, G>(c, n0, ah, al, bh, bl);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// the sum over a quad (the 4 lanes that hold one accumulator row), the
// same bits in each lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// two consecutive elements of a global row
template <typename T>
__device__ __forceinline__ void st2(T* p, float a, float b);
template <>
__device__ __forceinline__ void st2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void st2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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
  float* dlast;     // (B, nc, nh, ns): <D_c, H_c> by state slice
  float* dcum_row;  // (B, nc, nh, l)
  float* dcum_col;  // (B, nc, nh, l)
  float* rpos;      // (B, nc, nh, l): r_j
  float* dA_part;   // (B, nc, nh)
  float* dBh;       // (B, S, nh, ds)
  float* dCh;       // (B, S, nh, ds)
  int B, S, nh, g, l, nc, nt, ns;
};

// ------------------------------------------------------ 1. chunk state ---

// per (chunk, head, b) and role (blockIdx.x = 2 c + role): role 0 S_c =
// Σ_j (x_j exp(cum_last - cum_j) dt_j) B_jᵀ, role 1 G_c = Σ_i (dy_i
// exp(cum_i)) C_iᵀ; k runs over positions. The hd x ds output is cut
// into WM x WN warp tiles of MT x NT mma tiles (mamba2: each warp all 64
// rows and 32 columns), so that each split a or b feeds several mmas.
template <int HD, int DS>
struct StateTiles {
  static constexpr int TM = HD / 16, TN = DS / 8;
  static constexpr int WM = (TM == 4 && TN == 16) ? 1 : 2, WN = NW / WM;
  static constexpr int MT = TM / WM, NT = TN / WN;
  static_assert(TM % WM == 0 && TN % WN == 0, "warp tiling");
};

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(NTB)
ssd_bwd_chunk_state_kernel(const Args<T> a) {
  constexpr int PX = Row<T, HD>::P, PB = Row<T, DS>::P;
  constexpr int STAGE = TS * (PX + PB);
  using W = StateTiles<HD, DS>;
  constexpr int MT = W::MT, NT = W::NT;
  constexpr bool E = Exact<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);                  // 2 x (x | B)
  float* cms = reinterpret_cast<float*>(smem + 2 * STAGE * sizeof(T));
  float* sc = cms + a.l;                                 // dt, then scale
  const int c = blockIdx.x >> 1, role = blockIdx.x & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int l = a.l, S = a.S, nh = a.nh, g = a.g;
  const int grp = h / (nh / g);
  const int t0 = c * l, vl = min(l, S - t0);
  const size_t k = ((size_t)b * a.nc + c) * nh + h;
  const size_t pos0 = (size_t)b * S + t0;
  const size_t xrs = (size_t)nh * HD, brs = (size_t)g * DS;
  const T* fb = (role ? a.dy : a.x) + pos0 * xrs + (size_t)h * HD;
  const T* bb = (role ? a.Cm : a.Bm) + pos0 * brs + (size_t)grp * DS;
  const int ns = (l + TS - 1) / TS;
  auto issue = [&](int s) {
    T* st = ring + (s & 1) * STAGE;
    load_rows<T, HD, TS>(st, fb, xrs, s * TS, vl);
    load_rows<T, DS, TS>(st + TS * PX, bb, brs, s * TS, vl);
    cp_async_commit();
  };
  issue(0);

  for (int j = threadIdx.x; j < l; j += NTB)
    sc[j] = j < vl ? a.dt[(pos0 + j) * nh + h] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {  // in position order, as a sequential cumsum
    const float av = a.A[h];
    float run = 0.f;
    for (int j = 0; j < l; ++j) {
      run += sc[j] * av;
      cms[j] = run;
    }
  }
  __syncthreads();
  const float last = cms[l - 1];
  for (int j = threadIdx.x; j < l; j += NTB) {
    sc[j] = role ? expf(cms[j]) : expf(last - cms[j]) * sc[j];
    if (role == 0) a.cum[k * l + j] = cms[j];
  }

  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * MT * (warp % W::WM), n0 = 8 * NT * (warp / W::WM);
  const int q = threadIdx.x & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) zero(acc[m]);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xs = ring + (s & 1) * STAGE;
    const T* bs = xs + TS * PX;
    const float* scs = sc + s * TS;
#pragma unroll 1
    for (int ks = 0; ks < TS / 8; ++ks) {
      if (s * TS + 8 * ks >= l) break;
      // positions 8 ks + 2q and + 1 (k permuted); beyond l the scale is
      // never read (sc has l entries) and the rows are zero
      const int p0 = s * TS + 8 * ks + 2 * q;
      const float f0 = p0 < l ? scs[8 * ks + 2 * q] : 0.f;
      const float f1 = p0 + 1 < l ? scs[8 * ks + 2 * q + 1] : 0.f;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float av[4];
        lda_tf32_kmajor(xs, PX, r0 + 16 * m, 8 * ks, av);
        av[0] *= f0, av[1] *= f0, av[2] *= f1, av[3] *= f1;
        split_tf32(av, ah[m], al[m]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float bv[2];
        uint32_t bh[2], bl[2];
        ldb_tf32_perm(bs, PB, 8 * ks, n0 + 8 * n, bv);
        to_tf32<E>(bv, bh, bl);
        // the terms across the MT tiles, in 3xTF32 order
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][n], al[m], bh);
        if (!E) {
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_tf32(acc[m][n], ah[m], bl);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][n], ah[m], bh);
      }
    }
    __syncthreads();
  }
  float* out = (role ? a.gs : a.hs) + k * (HD * DS);
  const int gq = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int row = r0 + 16 * m + gq, col = n0 + 8 * n + 2 * q;
      st2(out + row * DS + col, acc[m][n][0], acc[m][n][1]);
      st2(out + (row + 8) * DS + col, acc[m][n][2], acc[m][n][3]);
    }
}

// ------------------------------------------------------- 2. state pass ---

// warp (blockIdx.x, w) owns elements [SLICE s, SLICE (s + 1)) of the
// (head, b) = (blockIdx.y, blockIdx.z) state, 4 consecutive a lane
template <int HD, int DS>
__global__ void __launch_bounds__(NTS)
ssd_bwd_state_pass_kernel(float* __restrict__ hs, float* __restrict__ gs,
                          const float* __restrict__ cum,
                          const float* __restrict__ init,
                          const float* __restrict__ dfinal,
                          float* __restrict__ dlast,
                          float* __restrict__ dinit, int nh, int l, int nc) {
  constexpr int N_EL = HD * DS, NSL = N_EL / SLICE;
  static_assert(N_EL % (SLICE * (NTS / 32)) == 0, "state slices");
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.x * (NTS / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * nh + h;
  const int e = slice * SLICE + 4 * lane;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 st = init != nullptr
                  ? *reinterpret_cast<const float4*>(init + bh * N_EL + e)
                  : zero4;
  // chunk c's element block and its decay; each loop loads the next
  // chunk's operands before it stores, so two loads are in flight
  auto at = [&](float* base, int c) {
    return reinterpret_cast<float4*>(
        base + (((size_t)b * nc + c) * nh + h) * N_EL + e);
  };
  auto decay_of = [&](int c) {
    return expf(cum[(((size_t)b * nc + c) * nh + h) * l + l - 1]);
  };
  float4 own = *at(hs, 0);
  float dec = decay_of(0);
  for (int c = 0; c < nc; ++c) {  // the entering states over S_c
    const float4 cur = own;
    const float decay = dec;
    if (c + 1 < nc) {
      own = *at(hs, c + 1);
      dec = decay_of(c + 1);
    }
    *at(hs, c) = st;
    st = make_float4(fmaf(st.x, decay, cur.x), fmaf(st.y, decay, cur.y),
                     fmaf(st.z, decay, cur.z), fmaf(st.w, decay, cur.w));
  }
  st = dfinal != nullptr
           ? *reinterpret_cast<const float4*>(dfinal + bh * N_EL + e)
           : zero4;
  float4 hn = *at(hs, nc - 1), gn = *at(gs, nc - 1);
  dec = decay_of(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {  // D_c over G_c, reverse order
    const size_t k = ((size_t)b * nc + c) * nh + h;
    const float4 hv = hn, gv = gn;
    const float decay = dec;
    if (c > 0) {
      hn = *at(hs, c - 1);
      gn = *at(gs, c - 1);
      dec = decay_of(c - 1);
    }
    *at(gs, c) = st;
    float part = st.x * hv.x;
    part = fmaf(st.y, hv.y, part);
    part = fmaf(st.z, hv.z, part);
    part = fmaf(st.w, hv.w, part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) dlast[k * NSL + slice] = part;
    st = make_float4(fmaf(st.x, decay, gv.x), fmaf(st.y, decay, gv.y),
                     fmaf(st.z, decay, gv.z), fmaf(st.w, decay, gv.w));
  }
  *reinterpret_cast<float4*>(dinit + bh * N_EL + e) = st;
}

// ------------------------------------------------------------ 3. chunk ---

// Shared memory of pass 3, in bytes: the fixed tile (64 rows of the DS-
// and the HD-wide operand), the ring (two steps of 32 rows of each) with
// D_c or H_c (HD x DS f32, pitch DS + 4) over it before the walk, then
// the chunk's cum and dt (l floats each).
template <typename T, int HD, int DS>
struct Lay {
  static constexpr int PB = Row<T, DS>::P, PX = Row<T, HD>::P;
  static constexpr int PD = DS + 4;
  static constexpr int FX = TT * PB;                     // elements of T
  static constexpr int RING = FX + TT * PX;
  static constexpr int STAGE = TS * (PB + PX);
  static constexpr int RING_BYTES =
      2 * STAGE * (int)sizeof(T) > HD * PD * 4 ? 2 * STAGE * (int)sizeof(T)
                                               : HD * PD * 4;
  static constexpr int VEC = RING * (int)sizeof(T) + RING_BYTES;  // bytes
  static int bytes(int l) { return VEC + 2 * l * (int)sizeof(float); }
};

// the chunk's cum and dt into shared memory, and the pointers of a block
template <typename T, int HD, int DS>
struct Chunk {
  const T *xb, *yb, *bb, *cb;
  const float* cumk;
  size_t k, pos0, xrs, brs;
  int l, vl;
  float *cs, *ds;  // shared: cum, dt of the chunk

  __device__ __forceinline__ Chunk(const Args<T>& a, unsigned char* sm,
                                   int c, int h, int b) {
    const int nh = a.nh, g = a.g, S = a.S;
    const int grp = h / (nh / g);
    l = a.l;
    const int t0 = c * l;
    vl = min(l, S - t0);
    k = ((size_t)b * a.nc + c) * nh + h;
    pos0 = (size_t)b * S + t0;
    xrs = (size_t)nh * HD;
    brs = (size_t)g * DS;
    xb = a.x + pos0 * xrs + (size_t)h * HD;
    yb = a.dy + pos0 * xrs + (size_t)h * HD;
    bb = a.Bm + pos0 * brs + (size_t)grp * DS;
    cb = a.Cm + pos0 * brs + (size_t)grp * DS;
    cumk = a.cum + k * l;
    cs = reinterpret_cast<float*>(sm + Lay<T, HD, DS>::VEC);
    ds = cs + l;
    for (int j = threadIdx.x; j < l; j += NTB) {
      cs[j] = cumk[j];
      ds[j] = j < vl ? a.dt[(pos0 + j) * nh + h] : 0.f;
    }
  }
};

// HD rows of a contiguous hd x ds f32 state into dst (pitch DS + 4)
template <int HD, int DS>
__device__ __forceinline__ void load_state(float* dst, const float* src) {
  constexpr int CH = DS / 4;
  for (int e = threadIdx.x; e < HD * CH; e += NTB) {
    const int r = e / CH, c = (e % CH) * 4;
    cp_async16(dst + r * (DS + 4) + c, src + r * DS + c, true);
  }
}

// the 16 x 32 tile pair of a warp: acc_s += a_s · b_sᵀ (depth DS) and
// acc_q += a_q · b_qᵀ (depth HD), a_* the warp's 16 fixed rows from row
// r0 of fs / fx, b_* the 32 rows of the ring step bs / bx
template <typename T, int HD, int DS>
__device__ __forceinline__ void pair_products(const T* fs, const T* fx,
                                              const T* bs, const T* bx,
                                              int r0, float (&acc_s)[4][4],
                                              float (&acc_q)[4][4]) {
  constexpr int PB = Row<T, DS>::P, PX = Row<T, HD>::P;
  constexpr bool E = Exact<T>::value;
  zero(acc_s);
  zero(acc_q);
#pragma unroll 1
  for (int ks = 0; ks < DS / 8; ++ks) {
    float av[4];
    lda_tf32(fs, PB, r0, 8 * ks, av);
    mma3_tiles<E, E, 4>(acc_s, av, [&](int n, float (&v)[2]) {
      ldb_tf32(bs, PB, 8 * n, 8 * ks, v);
    });
  }
#pragma unroll 1
  for (int ks = 0; ks < HD / 8; ++ks) {
    float av[4];
    lda_tf32(fx, PX, r0, 8 * ks, av);
    mma3_tiles<E, E, 4>(acc_q, av, [&](int n, float (&v)[2]) {
      ldb_tf32(bx, PX, 8 * n, 8 * ks, v);
    });
  }
}

// acc[n] += p · t over the 32 positions of a ring step: p (16 x 32) in
// four accumulators, t the step's rows (pitch P), columns 8 n ..
template <typename T, int P, int N>
__device__ __forceinline__ void walk_product(float (&acc)[N][4],
                                             const float (&p)[4][4],
                                             const T* t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float av[4];
    acc_as_a(p[kk], av);
    mma3_tiles<false, Exact<T>::value, N>(
        acc, av, [&](int n, float (&v)[2]) {
          ldb_tf32_perm(t, P, 8 * kk, 8 * n, v);
        });
  }
}

// acc[n] += a · st over the HD state rows: a the warp's 16 fixed rows of
// f (pitch P, k permuted), st the staged hd x ds state, columns 8 n ..
template <typename T, int P, int HD, int DS>
__device__ __forceinline__ void state_rows_product(float (&acc)[DS / 8][4],
                                                   const T* f, int r0,
                                                   const float* st) {
#pragma unroll 1
  for (int ks = 0; ks < HD / 8; ++ks) {
    float av[4];
    lda_tf32_perm(f, P, r0, 8 * ks, av);
    mma3_tiles<Exact<T>::value, false, DS / 8>(
        acc, av, [&](int n, float (&v)[2]) {
          ldb_tf32_perm(st, DS + 4, 8 * ks, 8 * n, v);
        });
  }
}

// columns role: tile J = [j0, j0 + TT) of chunk c; warp w owns j0 + 16 w
// .. + 15 and walks i from j0 in steps of TS
template <typename T, int HD, int DS>
__device__ __forceinline__ void chunk_cols(const Args<T>& a,
                                           unsigned char* sm, int c, int jt,
                                           int h, int b) {
  using Ly = Lay<T, HD, DS>;
  constexpr int PB = Ly::PB, PX = Ly::PX, PD = Ly::PD;
  constexpr bool E = Exact<T>::value;
  T* bJ = reinterpret_cast<T*>(sm);
  T* xJ = bJ + Ly::FX;
  T* ring = bJ + Ly::RING;
  float* Ds = reinterpret_cast<float*>(ring);
  const Chunk<T, HD, DS> ck(a, sm, c, h, b);
  const int l = ck.l, vl = ck.vl, j0 = jt * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3, r0 = 16 * warp;
  const int wr = j0 + r0;  // the warp's first j

  load_rows<T, DS, TT>(bJ, ck.bb, ck.brs, j0, vl);
  load_rows<T, HD, TT>(xJ, ck.xb, ck.xrs, j0, vl);
  load_state<HD, DS>(Ds, a.gs + ck.k * (HD * DS));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this lane's rows j = wr + gq + 8 u (u = 0, 1)
  const float last = ck.cs[l - 1];
  float cj[2], dj[2], ej[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = wr + gq + 8 * u;
    cj[u] = j < l ? ck.cs[j] : 0.f;
    dj[u] = j < l ? ck.ds[j] : 0.f;
    ej[u] = j < l ? expf(last - cj[u]) : 0.f;
  }
  // the state terms: v starts as z_j = exp(cum_last - cum_j) D_c B_j (a
  // = B_J over ds, b = D_c's rows), dB as exp(cum_last - cum_j) dt_j
  // D_cᵀ x_j (a = x_J over hd, k permuted)
  float v[HD / 8][4], db[DS / 8][4];
  zero(v);
  zero(db);
#pragma unroll 1
  for (int ks = 0; ks < DS / 8; ++ks) {
    float av[4];
    lda_tf32(bJ, PB, r0, 8 * ks, av);
    mma3_tiles<E, false, HD / 8>(v, av, [&](int n, float (&w)[2]) {
      ldb_tf32(Ds, PD, 8 * n, 8 * ks, w);
    });
  }
  state_rows_product<T, PX, HD, DS>(db, xJ, r0, Ds);
  float rj[2] = {0.f, 0.f};  // r_j = dt_j x_j·z_j, then ddt's x_j·v_j
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = e >> 1;
      v[n][e] *= ej[u];
      rj[u] = fmaf(to_f32(xJ[(r0 + gq + 8 * u) * PX + 8 * n + 2 * q +
                             (e & 1)]),
                   v[n][e], rj[u]);
    }
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[n][e] *= ej[e >> 1] * dj[e >> 1];
#pragma unroll
  for (int u = 0; u < 2; ++u) rj[u] = dj[u] * quad_sum(rj[u]);

  const int nsteps = (l - j0 + TS - 1) / TS;
  auto issue = [&](int s) {
    T* st = ring + (s & 1) * Ly::STAGE;
    load_rows<T, DS, TS>(st, ck.cb, ck.brs, j0 + s * TS, vl);
    load_rows<T, HD, TS>(st + TS * PB, ck.yb, ck.xrs, j0 + s * TS, vl);
    cp_async_commit();
  };
  __syncthreads();  // D_c over the ring is read
  issue(0);
  float colsum[2] = {0.f, 0.f};  // Σ_i w_ij, this lane's columns
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cI = ring + (s & 1) * Ly::STAGE;
    const T* yI = cI + TS * PB;
    const int i0 = j0 + s * TS;
    if (wr < l && i0 + TS - 1 >= wr) {  // some j <= i among the warp's
      float sm4[4][4], qm4[4][4];
      pair_products<T, HD, DS>(bJ, xJ, cI, yI, r0, sm4, qm4);
      // (s L)ᵀ and (q L dt)ᵀ where j <= i < l, mask before exp
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, j = wr + gq + 8 * u;
          const int i = i0 + 8 * n + 2 * q + (e & 1);
          float m = 0.f, p = 0.f;
          if (j <= i && i < l) {
            const float L = expf(ck.cs[i] - cj[u]);
            m = sm4[n][e] * L;
            p = qm4[n][e] * L * dj[u];
            if (j < i) colsum[u] = fmaf(p, sm4[n][e], colsum[u]);
          }
          sm4[n][e] = m;
          qm4[n][e] = p;
        }
      walk_product<T, PX, HD / 8>(v, sm4, yI);   // v_J += (s L)ᵀ dy_I
      walk_product<T, PB, DS / 8>(db, qm4, cI);  // dB_J += (q L dt)ᵀ C_I
    }
    __syncthreads();
  }

  // dx = dt v, ddt = x·v (pass 4 adds A da), dB per head, dcum's column
  // half -Σ_i w_ij - r_j, and r_j for cum_last
  float xv[2] = {0.f, 0.f};
  T* dxb = a.dx + ck.pos0 * ck.xrs + (size_t)h * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = r0 + gq + 8 * u, col = 8 * n + 2 * q;
      xv[u] = fmaf(to_f32(xJ[jl * PX + col]), v[n][2 * u], xv[u]);
      xv[u] = fmaf(to_f32(xJ[jl * PX + col + 1]), v[n][2 * u + 1], xv[u]);
      if (j0 + jl < vl)
        st2(dxb + (size_t)(j0 + jl) * ck.xrs + col, dj[u] * v[n][2 * u],
            dj[u] * v[n][2 * u + 1]);
    }
  float* dbh = a.dBh + (ck.pos0 * a.nh + h) * DS;
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = wr + gq + 8 * u;
      if (j < vl)
        st2(dbh + (size_t)j * a.nh * DS + 8 * n + 2 * q, db[n][2 * u],
            db[n][2 * u + 1]);
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float xvs = quad_sum(xv[u]), cs = quad_sum(colsum[u]);
    const int j = wr + gq + 8 * u;
    if (q == 0 && j < l) {
      if (j < vl) a.ddt[(ck.pos0 + j) * a.nh + h] = xvs;
      a.dcum_col[ck.k * l + j] = -cs - rj[u];
      a.rpos[ck.k * l + j] = rj[u];
    }
  }
}

// rows role: tile I = [i0, i0 + TT) of chunk c; warp w owns i0 + 16 w ..
// + 15 and walks j from 0 in steps of TS up to the tile's end
template <typename T, int HD, int DS>
__device__ __forceinline__ void chunk_rows(const Args<T>& a,
                                           unsigned char* sm, int c, int it,
                                           int h, int b) {
  using Ly = Lay<T, HD, DS>;
  constexpr int PB = Ly::PB, PX = Ly::PX;
  T* cI = reinterpret_cast<T*>(sm);
  T* yI = cI + Ly::FX;
  T* ring = cI + Ly::RING;
  float* Hs = reinterpret_cast<float*>(ring);
  const Chunk<T, HD, DS> ck(a, sm, c, h, b);
  const int l = ck.l, vl = ck.vl, i0 = it * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3, r0 = 16 * warp;
  const int wi = i0 + r0;  // the warp's first i

  load_rows<T, DS, TT>(cI, ck.cb, ck.brs, i0, vl);
  load_rows<T, HD, TT>(yI, ck.yb, ck.xrs, i0, vl);
  load_state<HD, DS>(Hs, a.hs + ck.k * (HD * DS));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float ci[2], ei[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = wi + gq + 8 * u;
    ci[u] = i < l ? ck.cs[i] : 0.f;
    ei[u] = i < l ? expf(ci[u]) : 0.f;
  }
  // the entering state's term u_i = exp(cum_i) H_cᵀ dy_i starts dC (a =
  // dy_I over hd, k permuted), and C_i·u_i the row half of dcum
  float dc[DS / 8][4];
  zero(dc);
  state_rows_product<T, PX, HD, DS>(dc, yI, r0, Hs);
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = e >> 1;
      dc[n][e] *= ei[u];
      rowsum[u] = fmaf(to_f32(cI[(r0 + gq + 8 * u) * PB + 8 * n + 2 * q +
                                 (e & 1)]),
                       dc[n][e], rowsum[u]);
    }

  const int nsteps = (min(i0 + TT, l) + TS - 1) / TS;
  auto issue = [&](int s) {
    T* st = ring + (s & 1) * Ly::STAGE;
    load_rows<T, DS, TS>(st, ck.bb, ck.brs, s * TS, vl);
    load_rows<T, HD, TS>(st + TS * PB, ck.xb, ck.xrs, s * TS, vl);
    cp_async_commit();
  };
  __syncthreads();  // H_c over the ring is read
  issue(0);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* bJ = ring + (s & 1) * Ly::STAGE;
    const T* xJ = bJ + TS * PB;
    const int j0 = s * TS;
    if (wi < l && j0 <= wi + 15) {  // some j <= i among the warp's
      float sm4[4][4], qm4[4][4];
      pair_products<T, HD, DS>(cI, yI, bJ, xJ, r0, sm4, qm4);
      // q L dt where j <= i < l, mask before exp
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, i = wi + gq + 8 * u;
          const int j = j0 + 8 * n + 2 * q + (e & 1);
          float p = 0.f;
          if (j <= i && i < l) {
            p = qm4[n][e] * expf(ci[u] - ck.cs[j]) * ck.ds[j];
            if (j < i) rowsum[u] = fmaf(p, sm4[n][e], rowsum[u]);
          }
          qm4[n][e] = p;
        }
      walk_product<T, PB, DS / 8>(dc, qm4, bJ);  // dC_I += (q L dt) B_J
    }
    __syncthreads();
  }

  float* dch = a.dCh + (ck.pos0 * a.nh + h) * DS;
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = wi + gq + 8 * u;
      if (i < vl)
        st2(dch + (size_t)i * a.nh * DS + 8 * n + 2 * q, dc[n][2 * u],
            dc[n][2 * u + 1]);
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float rs = quad_sum(rowsum[u]);
    const int i = wi + gq + 8 * u;
    if (q == 0 && i < l) a.dcum_row[ck.k * l + i] = rs;
  }
}

// blockIdx.x < nt · nc: a column tile, else a row tile
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(NTB, 2)
ssd_bwd_chunk_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
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
// r_j by warp 0: each lane in position order, then a fixed shuffle tree;
// <D_c, H_c> as its slice parts summed in slice order), the reverse
// cumulative sum da (one thread, position order), ddt += A da and the
// chunk's dA partial Σ dt da
template <typename T>
__global__ void __launch_bounds__(NTB) ssd_bwd_dcum_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dc = reinterpret_cast<float*>(smem);   // l
  float* dts = dc + a.l;   // l
  float* rs = dts + a.l;   // l: r_j
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int l = a.l, nh = a.nh;
  const int vl = min(l, a.S - c * l);
  const size_t k = ((size_t)b * a.nc + c) * nh + h;
  const size_t pos0 = (size_t)b * a.S + c * l;
  for (int j = threadIdx.x; j < l; j += NTB) {
    dc[j] = a.dcum_row[k * l + j] + a.dcum_col[k * l + j];
    dts[j] = j < vl ? a.dt[(pos0 + j) * nh + h] : 0.f;
    rs[j] = a.rpos[k * l + j];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float r = 0.f;
    for (int j = threadIdx.x; j < l; j += 32) r += rs[j];
    for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
    if (threadIdx.x == 0) {
      float dh = 0.f;
      for (int s = 0; s < a.ns; ++s) dh += a.dlast[k * a.ns + s];
      dc[l - 1] += expf(a.cum[k * l + l - 1]) * dh + r;
    }
  }
  __syncthreads();
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
  for (int j = threadIdx.x; j < vl; j += NTB)
    a.ddt[(pos0 + j) * nh + h] += av * dc[j];
}

// ----------------------------------------------------------- 5. groups ---

// dBm, dCm (B, S, g, ds) = the per-head partials summed over the group's
// heads in head order; block 0 also sums dA over (b, chunk) in order
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_group_kernel(const Args<T> a,
                                                            int ds) {
  const int rep = a.nh / a.g;
  const size_t total = (size_t)a.B * a.S * a.g * ds;
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < total;
       e += (size_t)gridDim.x * 256) {
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
    for (int h = threadIdx.x; h < a.nh; h += 256) {
      float s = 0.f;
      for (int b = 0; b < a.B; ++b)
        for (int c = 0; c < a.nc; ++c)
          s += a.dA_part[((size_t)b * a.nc + c) * a.nh + h];
      a.dA[h] = s;
    }
}

template <typename T, int HD, int DS>
int launch(const Args<T>& a, cudaStream_t s) {
  constexpr int STAGE1 =
      TS * (Row<T, HD>::P + Row<T, DS>::P) * (int)sizeof(T);
  const int smem1 = 2 * STAGE1 + 2 * a.l * (int)sizeof(float);
  const int smem3 = Lay<T, HD, DS>::bytes(a.l);
  const int smem4 = 3 * a.l * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_state_kernel<T, HD, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, HD, DS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return (int)err;
  // two blocks an SM (their loads overlap each other's products) need
  // all of the SM's 228 KB as shared memory at mamba2's shape
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, HD, DS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_dcum_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem4);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_state_kernel<T, HD, DS>
      <<<dim3(2 * a.nc, a.nh, a.B), NTB, smem1, s>>>(a);
  ssd_bwd_state_pass_kernel<HD, DS>
      <<<dim3(HD * DS / (SLICE * (NTS / 32)), a.nh, a.B), NTS, 0, s>>>(
          a.hs, a.gs, a.cum, a.init, a.dfinal, a.dlast, a.dinit, a.nh, a.l,
          a.nc);
  ssd_bwd_chunk_kernel<T, HD, DS>
      <<<dim3(2 * a.nt * a.nc, a.nh, a.B), NTB, smem3, s>>>(a);
  ssd_bwd_dcum_kernel<T><<<dim3(a.nc, a.nh, a.B), NTB, smem4, s>>>(a);
  const size_t total = (size_t)a.B * a.S * a.g * DS;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  ssd_bwd_group_kernel<T><<<blocks, 256, 0, s>>>(a, DS);
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
  a.ns = hd * ds / SLICE;
  return launch_shape<T>(hd, ds, a, s);
}

}  // namespace

// init and dfinal may be null (zeros). The scratch tensors (shapes in
// Args; dlast has hd * ds / 128 slices) are f32 and allocated by the
// caller.
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
