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
// 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
// 3.35 TB/s): at granite-moe's training shape (8 x 128 tokens, top-8 of
// 32 experts, d 1024, f 512, 12 288 padded rows) it does 16 rows d f
// ~ 69 GFLOP on the 8192 real rows. In f32 that is ~1 ms of operations
// against ~0.15 ms of bytes; in bf16 0.07 ms of operations against 0.08
// ms of bytes. The kernel takes no per-tile row counts, so it also works
// the padding rows of valid tiles (10 880 rows in all there): at best
// ~75 % of a bound counted on real rows.
//
// Design: three launches on the stream, no atomics anywhere (each output
// element is one block's, summed in a fixed order, so two calls give the
// same bits), no host sync (each block reads the tile vectors itself):
//   1. per (plan row block, f block): recompute A and B (the forward
//      keeps nothing) and G, form dA, dB and H in registers and write
//      them once into (P, f) scratches in the input dtype; an invalid
//      tile's block returns (passes 2 and 3 never read its rows);
//   2. per (plan row block, d block): dxs = [dA | dB] [W1 | W3]^T, one
//      product of depth 2f; zeros for an invalid tile;
//   3. per (expert, d block, f block): dW1, dW3 and dW2 of that block,
//      the depth being the rows of expert e's valid tiles walked in tile
//      index order in stages of 32 rows inside one tile; an expert with
//      no valid tile writes exact zeros.
// A row block lies inside one plan tile, so any block_t works (8 for a
// verify pass, 128 for training, 256). Passes 2 and 3 stay two launches:
// one grid holding both (pass 3's blocks first, pass 2's filling the
// tail) was barely faster in f32 and no faster in bf16.
//
// bf16: every product on the tensor cores, mma.sync m16n8k16 with f32
// accumulation, fragments by ldmatrix (.trans where a tile is stored
// with the reduction axis as its row axis: W1 / W3 in pass 1, every
// operand of pass 3), operands streamed through a 3-stage ring of
// 16-byte cp.async copies (rows padded by 16 bytes: no bank is hit
// twice), 8 warps of 32 x 32 (pass 2: 32 x 64) outputs of each product,
// two blocks an SM. dA, dB and H are rounded to bf16 between the
// passes, as the forward rounds H, so passes 2 and 3 take bf16
// operands. (Blocks of 16 warps over tiles twice as wide, which read
// each byte from L2 fewer times, were slower.)
// f32: IEEE FMAs on the CUDA cores (never TF32), 128 x 64 (passes 1 and
// 3, three products each) or 128 x 128 (pass 2) output tiles, 256
// threads of 8 x 4 (8 x 8) register tiles, so one float4 read of shared
// memory feeds 3.4 (4) FMAs; operands streamed through a 3-stage
// cp.async ring, so copies overlap the FMAs; one block an SM in passes
// 1 and 3 (184 and 172 KB of shared memory, their k loops unrolled
// whole), two in pass 2 (its k loop rolled, so it fits 128 registers).
// Tiles keep their global layout; one stored with the reduction axis
// contiguous and read down its columns (W2 in pass 1, W1 / W3 in pass
// 2) has its 16-byte chunks XOR-swizzled by row so that a warp's reads
// spread over every bank. Pass 3 finds an expert's next tile 32 tiles
// at a time by a warp ballot.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;  // threads of every block: 8 warps

// The row block of grid row y: plan tile, first row, live rows.
template <int BM>
struct RowBlock {
  int tile, row0, rows;
  __device__ RowBlock(int y, int block_t, int spt) {
    tile = y / spt;
    const int sub = y % spt;
    row0 = tile * block_t + sub * BM;
    rows = min(BM, block_t - sub * BM);
  }
};

// Rows [0, R) x columns [c0, c0 + C) of a row-major matrix of pitch ld
// whose row 0 is src, as 16-byte cp.async chunks into dst (pitch DP
// elements); rows >= nr and columns >= nc are zero-filled (nc a multiple
// of the chunk). SWZ (C of 8 chunks, DP == C): chunk q of row r lands at
// chunk q ^ ((r / 4) % 8), so reads of rows 4 apart use every bank.
template <typename T, int R, int C, int DP, bool SWZ = false>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, int ld, int nr,
                                        int c0, int nc) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = C / V, CH = R * CPR;
  static_assert(CH % NT == 0, "whole chunks per thread");
  static_assert(!SWZ || (CPR == 8 && DP == C), "swizzle: 8 chunks a row");
#pragma unroll
  for (int it = 0; it < CH / NT; ++it) {
    const int ch = threadIdx.x + it * NT;
    const int r = ch / CPR, q = ch % CPR, c = q * V;
    const bool ok = r < nr && c0 + c < nc;
    const int at = SWZ ? r * DP + ((q ^ ((r >> 2) & 7)) * V) : r * DP + c;
    cp_async16(dst + at, ok ? src + (size_t)r * ld + c0 + c : src, ok);
  }
}

// Expert e's tiles for pass 3, in tile index order: the number of them
// (all threads, a block-wide count) and the next one after t.
__device__ __forceinline__ int count_tiles(const int* eid, const int* valid,
                                           int n_tiles, int e) {
  int n = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += NT) {
    const int t = t0 + threadIdx.x;
    n += __syncthreads_count(t < n_tiles && valid[t] && eid[t] == e);
  }
  return n;
}
__device__ __forceinline__ int next_tile(const int* eid, const int* valid,
                                         int n_tiles, int e, int t) {
  // 32 tiles a step, one a lane; every warp finds the same tile
  for (int t0 = t + 1; t0 < n_tiles; t0 += 32) {
    const int u = t0 + (threadIdx.x & 31);
    const unsigned hit =
        __ballot_sync(0xffffffffu, u < n_tiles && valid[u] && eid[u] == e);
    if (hit) return t0 + __ffs(hit) - 1;
  }
  return n_tiles;
}

// The stage cursor of pass 3: tile t of expert e, stage s (of BK rows)
// inside it; advanced in the order stages are loaded.
template <int BK>
struct StageCursor {
  const int *eid, *valid;
  int n_tiles, e, block_t, spt, t, s;
  __device__ StageCursor(const int* eid_, const int* valid_, int n_tiles_,
                         int e_, int block_t_)
      : eid(eid_), valid(valid_), n_tiles(n_tiles_), e(e_),
        block_t(block_t_), spt((block_t_ + BK - 1) / BK), s(0) {
    t = next_tile(eid, valid, n_tiles, e, -1);
  }
  __device__ int row0() const { return t * block_t + s * BK; }
  __device__ int rows() const { return min(BK, block_t - s * BK); }
  __device__ void advance() {
    if (++s == spt) {
      s = 0;
      t = next_tile(eid, valid, n_tiles, e, t);
    }
  }
};

// dA, dB and H of one element from A, B and G
__device__ __forceinline__ void act_grad(float a, float b, float g,
                                         float& da, float& db, float& h) {
  const float s = 1.0f / (1.0f + expf(-a));
  const float sa = a * s;
  da = g * b * s * (1.0f + a * (1.0f - s));
  db = g * sa;
  h = sa * b;
}

// ---- bf16: tensor cores --------------------------------------------------

constexpr int ST = 3;  // cp.async ring depth of every bf16 pass

// Warp geometry of a BM x BN output tile: BM / 32 warps along the rows,
// the rest along the columns, each 32 rows (2 m16 tiles) x WC columns
// (NB n8 tiles).
template <int BM, int BN>
struct Warps {
  static constexpr int WM = BM / 32, WN = 8 / WM, WC = BN / WN, NB = WC / 8;
  static_assert(NB % 2 == 0, "B fragments load two n-tiles at once");
  static __device__ int r0() { return (threadIdx.x / 32 % WM) * 32; }
  static __device__ int c0() { return (threadIdx.x / 32 / WM) * WC; }
};

// acc[i][j] += A (rows r0 + 16 i, stored [m][k], pitch ap) x B (NB
// n-tiles from column c0; KMAJ: stored [k][n], else [n][k]; pitch bp)
// over one k16 step at ks
template <int NB, bool KMAJ>
__device__ __forceinline__ void mma_k16(float (&acc)[2][NB][4],
                                        const uint32_t (&a)[2][4],
                                        const bf16* B, int bp, int ks,
                                        int c0) {
#pragma unroll
  for (int j = 0; j < NB; j += 2) {
    uint32_t b[4];
    if constexpr (KMAJ)
      ldmatrix_x4_trans(b, x4_addr<true>(B, bp, ks, c0 + j * 8));
    else
      ldmatrix_x4(b, x4_addr<false>(B, bp, c0 + j * 8, ks));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_bf16(acc[i][j], a[i], b[0], b[1]);
      mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
    }
  }
}

// A fragments of rows [r0, r0 + 32) at k step ks: stored [m][k]
// (!TRANS) or [k][m] (TRANS, loaded with .trans)
template <bool TRANS>
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* A,
                                       int ap, int r0, int ks) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (TRANS)
      ldmatrix_x4_trans(a[i], x4_addr<false>(A, ap, ks, r0 + i * 16));
    else
      ldmatrix_x4(a[i], x4_addr<true>(A, ap, r0 + i * 16, ks));
  }
}

// pass 1: A, B over xs and G over dys, BM x 64 per block, depth d
template <int BM>
struct Act16 {
  static constexpr int BN = 64, BK = 32;
  static constexpr int AP = BK + 8, BP = BN + 8;
  static constexpr int SX = BM * AP, SW = BK * BP, S2 = BN * AP;
  static constexpr int STAGE = 2 * SX + 2 * SW + S2;
  static constexpr int SMEM = ST * STAGE * 2;
};

template <int BM>
__global__ void __launch_bounds__(NT, 2)
    bwd_act_tc_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ w1,
                      const bf16* __restrict__ w3, const bf16* __restrict__ w2,
                      const bf16* __restrict__ dys,
                      const int* __restrict__ eid,
                      const int* __restrict__ valid, bf16* __restrict__ da,
                      bf16* __restrict__ db, bf16* __restrict__ h, int d,
                      int f, int block_t, int spt) {
  using L = Act16<BM>;
  using W = Warps<BM, L::BN>;
  const RowBlock<BM> rb(blockIdx.y, block_t, spt);
  if (!valid[rb.tile]) return;  // its scratch rows are never read
  const int n0 = blockIdx.x * L::BN;
  const size_t woff = (size_t)eid[rb.tile] * d * f;
  const bf16* X = xs + (size_t)rb.row0 * d;
  const bf16* D = dys + (size_t)rb.row0 * d;
  const bf16* W1 = w1 + woff;
  const bf16* W3 = w3 + woff;
  const bf16* W2 = w2 + woff + (size_t)n0 * d;  // rows n0.. of (f, d)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  auto load = [&](int slot, int kt) {
    bf16* s = smem + slot * L::STAGE;
    const int k0 = kt * L::BK;
    cp_tile<bf16, BM, L::BK, L::AP>(s, X, d, rb.rows, k0, d);
    cp_tile<bf16, BM, L::BK, L::AP>(s + L::SX, D, d, rb.rows, k0, d);
    cp_tile<bf16, L::BK, L::BN, L::BP>(s + 2 * L::SX, W1 + (size_t)k0 * f,
                                       f, d - k0, n0, f);
    cp_tile<bf16, L::BK, L::BN, L::BP>(s + 2 * L::SX + L::SW,
                                       W3 + (size_t)k0 * f, f, d - k0, n0, f);
    cp_tile<bf16, L::BN, L::BK, L::AP>(s + 2 * L::SX + 2 * L::SW, W2, d,
                                       f - n0, k0, d);
  };

  float accA[2][W::NB][4] = {}, accB[2][W::NB][4] = {},
        accG[2][W::NB][4] = {};
  const int r0 = W::r0(), c0 = W::c0();
  const int nk = (d + L::BK - 1) / L::BK;
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1's slot is free
    if (kt + ST - 1 < nk) load((kt + ST - 1) % ST, kt + ST - 1);
    cp_async_commit();
    const bf16* s = smem + (kt % ST) * L::STAGE;
#pragma unroll
    for (int ks = 0; ks < L::BK; ks += 16) {
      uint32_t a[2][4];
      load_a<false>(a, s, L::AP, r0, ks);
      mma_k16<W::NB, true>(accA, a, s + 2 * L::SX, L::BP, ks, c0);
      mma_k16<W::NB, true>(accB, a, s + 2 * L::SX + L::SW, L::BP, ks, c0);
      load_a<false>(a, s + L::SX, L::AP, r0, ks);
      mma_k16<W::NB, false>(accG, a, s + 2 * L::SX + 2 * L::SW, L::AP, ks,
                            c0);
    }
  }
  cp_async_wait<0>();

  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < W::NB; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + i * 16 + g + hh * 8;
        const int n = n0 + c0 + j * 8 + 2 * q;  // f % 8 == 0
        if (r >= rb.rows || n >= f) continue;
        float va[2], vb[2], vh[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          act_grad(accA[i][j][hh * 2 + u], accB[i][j][hh * 2 + u],
                   accG[i][j][hh * 2 + u], va[u], vb[u], vh[u]);
        const size_t at = (size_t)(rb.row0 + r) * f + n;
        *reinterpret_cast<uint32_t*>(da + at) = pack_bf16(va[0], va[1]);
        *reinterpret_cast<uint32_t*>(db + at) = pack_bf16(vb[0], vb[1]);
        *reinterpret_cast<uint32_t*>(h + at) = pack_bf16(vh[0], vh[1]);
      }
}

// pass 2: dxs = dA W1^T + dB W3^T, BM x 128 per block, depth 2f
template <int BM>
struct Dx16 {
  static constexpr int BN = 128, BK = 64, AP = BK + 8;
  static constexpr int SA = BM * AP, SB = BN * AP, STAGE = SA + SB;
  static constexpr int SMEM = ST * STAGE * 2;
};

template <int BM>
__global__ void __launch_bounds__(NT, 2)
    bwd_dx_tc_kernel(const bf16* __restrict__ da, const bf16* __restrict__ db,
                     const bf16* __restrict__ w1, const bf16* __restrict__ w3,
                     const int* __restrict__ eid,
                     const int* __restrict__ valid, bf16* __restrict__ dxs,
                     int d, int f, int block_t, int spt) {
  using L = Dx16<BM>;
  using W = Warps<BM, L::BN>;
  const RowBlock<BM> rb(blockIdx.y, block_t, spt);
  const int n0 = blockIdx.x * L::BN;
  if (!valid[rb.tile]) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int ch = threadIdx.x; ch < rb.rows * (L::BN / 8); ch += NT) {
      const int r = ch / (L::BN / 8), n = n0 + (ch % (L::BN / 8)) * 8;
      if (n < d)
        *reinterpret_cast<uint4*>(dxs + (size_t)(rb.row0 + r) * d + n) = z;
    }
    return;
  }
  const size_t woff = (size_t)eid[rb.tile] * d * f;
  const size_t roff = (size_t)rb.row0 * f;
  const size_t noff = (size_t)n0 * f;  // rows n0.. of W1 / W3 (d, f)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int nh = (f + L::BK - 1) / L::BK, nk = 2 * nh;
  auto load = [&](int slot, int kt) {
    bf16* s = smem + slot * L::STAGE;
    const bool second = kt >= nh;
    const int k0 = (kt - (second ? nh : 0)) * L::BK;
    cp_tile<bf16, BM, L::BK, L::AP>(s, (second ? db : da) + roff, f,
                                    rb.rows, k0, f);
    cp_tile<bf16, L::BN, L::BK, L::AP>(
        s + L::SA, (second ? w3 : w1) + woff + noff, f, d - n0, k0, f);
  };

  float acc[2][W::NB][4] = {};
  const int r0 = W::r0(), c0 = W::c0();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (kt + ST - 1 < nk) load((kt + ST - 1) % ST, kt + ST - 1);
    cp_async_commit();
    const bf16* s = smem + (kt % ST) * L::STAGE;
#pragma unroll
    for (int ks = 0; ks < L::BK; ks += 16) {
      uint32_t a[2][4];
      load_a<false>(a, s, L::AP, r0, ks);
      mma_k16<W::NB, false>(acc, a, s + L::SA, L::AP, ks, c0);
    }
  }
  cp_async_wait<0>();

  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < W::NB; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + i * 16 + g + hh * 8;
        const int n = n0 + c0 + j * 8 + 2 * q;
        if (r >= rb.rows || n >= d) continue;
        *reinterpret_cast<uint32_t*>(dxs + (size_t)(rb.row0 + r) * d + n) =
            pack_bf16(acc[i][j][hh * 2], acc[i][j][hh * 2 + 1]);
      }
}

// pass 3: per (expert, 128 d columns c, 64 f columns j): dW1 and dW3 as
// (c x j) tiles, dW2 as a (j x c) tile; depth the expert's rows
struct Dw16 {
  static constexpr int BC = 128, BJ = 64, BK = 32;
  static constexpr int XP = BC + 8, JP = BJ + 8;
  static constexpr int SX = BK * XP, SJ = BK * JP;
  static constexpr int STAGE = 2 * SX + 3 * SJ;
  static constexpr int SMEM = ST * STAGE * 2;
};

__global__ void __launch_bounds__(NT, 2)
    bwd_dw_tc_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ dys,
                     const bf16* __restrict__ da, const bf16* __restrict__ db,
                     const bf16* __restrict__ h, const int* __restrict__ eid,
                     const int* __restrict__ valid, bf16* __restrict__ dw1,
                     bf16* __restrict__ dw3, bf16* __restrict__ dw2, int d,
                     int f, int block_t, int n_tiles) {
  using L = Dw16;
  const int e = blockIdx.z;
  const int j0 = blockIdx.x * L::BJ, c0 = blockIdx.y * L::BC;
  const int w = threadIdx.x >> 5;
  const int cw = (w % 4) * 32, jw = (w / 4) * 32;  // the warp's c, j

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  StageCursor<L::BK> cur(eid, valid, n_tiles, e, block_t);
  const int nk = count_tiles(eid, valid, n_tiles, e) * cur.spt;
  auto load = [&](int slot) {
    bf16* s = smem + slot * L::STAGE;
    const int r0 = cur.row0(), nr = cur.rows();
    cp_tile<bf16, L::BK, L::BC, L::XP>(s, xs + (size_t)r0 * d, d, nr, c0, d);
    cp_tile<bf16, L::BK, L::BC, L::XP>(s + L::SX, dys + (size_t)r0 * d, d,
                                       nr, c0, d);
    bf16* sj = s + 2 * L::SX;
    cp_tile<bf16, L::BK, L::BJ, L::JP>(sj, da + (size_t)r0 * f, f, nr, j0, f);
    cp_tile<bf16, L::BK, L::BJ, L::JP>(sj + L::SJ, db + (size_t)r0 * f, f,
                                       nr, j0, f);
    cp_tile<bf16, L::BK, L::BJ, L::JP>(sj + 2 * L::SJ, h + (size_t)r0 * f, f,
                                       nr, j0, f);
    cur.advance();
  };

  float acc1[2][4][4] = {}, acc3[2][4][4] = {}, acc2[2][4][4] = {};
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (kt + ST - 1 < nk) load((kt + ST - 1) % ST);
    cp_async_commit();
    const bf16* s = smem + (kt % ST) * L::STAGE;
    const bf16* sj = s + 2 * L::SX;
#pragma unroll
    for (int ks = 0; ks < L::BK; ks += 16) {
      uint32_t a[2][4];
      load_a<true>(a, s, L::XP, cw, ks);  // xs^T: m = c, k = row
      mma_k16<4, true>(acc1, a, sj, L::JP, ks, jw);
      mma_k16<4, true>(acc3, a, sj + L::SJ, L::JP, ks, jw);
      load_a<true>(a, sj + 2 * L::SJ, L::JP, jw, ks);  // H^T: m = j
      mma_k16<4, true>(acc2, a, s + L::SX, L::XP, ks, cw);
    }
  }
  cp_async_wait<0>();

  const size_t woff = (size_t)e * d * f;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int u = hh * 2;
        const int c = c0 + cw + i * 16 + g + hh * 8;   // acc1 / acc3 row
        const int jj = j0 + jw + j * 8 + 2 * q;        // and column
        if (c < d && jj < f) {
          const size_t at = woff + (size_t)c * f + jj;
          *reinterpret_cast<uint32_t*>(dw1 + at) =
              pack_bf16(acc1[i][j][u], acc1[i][j][u + 1]);
          *reinterpret_cast<uint32_t*>(dw3 + at) =
              pack_bf16(acc3[i][j][u], acc3[i][j][u + 1]);
        }
        const int r2 = j0 + jw + i * 16 + g + hh * 8;  // acc2 row (f)
        const int c2 = c0 + cw + j * 8 + 2 * q;        // and column (d)
        if (r2 < f && c2 < d)
          *reinterpret_cast<uint32_t*>(dw2 + woff + (size_t)r2 * d + c2) =
              pack_bf16(acc2[i][j][u], acc2[i][j][u + 1]);
      }
}

template <int BM>
int launch_tc(const bf16* xs, const bf16* w1, const bf16* w3, const bf16* w2,
              const int* eid, const int* val, const bf16* dys, bf16* da,
              bf16* db, bf16* h, bf16* dxs, bf16* dw1, bf16* dw3, bf16* dw2,
              int P, int d, int f, int E, int block_t, cudaStream_t s) {
  auto act = &bwd_act_tc_kernel<BM>;
  auto dx = &bwd_dx_tc_kernel<BM>;
  auto dw = &bwd_dw_tc_kernel;
  constexpr int m1 = Act16<BM>::SMEM, m2 = Dx16<BM>::SMEM, m3 = Dw16::SMEM;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           act, cudaFuncAttributeMaxDynamicSharedMemorySize, m1)) ||
      (err = cudaFuncSetAttribute(
           dx, cudaFuncAttributeMaxDynamicSharedMemorySize, m2)) ||
      (err = cudaFuncSetAttribute(
           dw, cudaFuncAttributeMaxDynamicSharedMemorySize, m3)))
    return (int)err;
  const int spt = (block_t + BM - 1) / BM, tiles = P / block_t;
  const int nj = (f + 63) / 64, nc = (d + 127) / 128;
  act<<<dim3(nj, tiles * spt), NT, m1, s>>>(xs, w1, w3, w2, dys, eid, val,
                                            da, db, h, d, f, block_t, spt);
  if ((err = cudaGetLastError())) return (int)err;
  dx<<<dim3(nc, tiles * spt), NT, m2, s>>>(da, db, w1, w3, eid, val, dxs, d,
                                           f, block_t, spt);
  if ((err = cudaGetLastError())) return (int)err;
  dw<<<dim3(nj, nc, E), NT, m3, s>>>(xs, dys, da, db, h, eid, val, dw1, dw3,
                                     dw2, d, f, block_t, tiles);
  return (int)cudaGetLastError();
}

// ---- f32: CUDA cores -----------------------------------------------------
//
// Thread (tx, ty) = (tid % 16, tid / 16) of a block owns the rows
// {4 ty + i, 64 + 4 ty + i} (i < 4) of a 128-row tile and the columns
// {4 tx + c} (c < 4) of a 64-column one, or also {64 + 4 tx + c} of a
// 128-column one.

constexpr int FST = 3;  // cp.async ring depth of every f32 pass

__device__ __forceinline__ int row8(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

__device__ __forceinline__ void ld4(float* v, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

// a[i][kk] = S[row8(ty, i)][4 kq + kk] of a [128][XP] row-major tile
template <int XP>
__device__ __forceinline__ void rows_k4(float (*a)[4], const float* S,
                                        int ty, int kq) {
#pragma unroll
  for (int i = 0; i < 8; ++i) ld4(a[i], S + row8(ty, i) * XP + kq * 4);
}

// b[c][kk] = S[n][4 kq + kk], n = n0 + 4 tx + c, of a swizzled [rows][32]
// tile (cp_tile SWZ)
__device__ __forceinline__ void cols_k4_swz(float (*b)[4], const float* S,
                                            int n0, int tx, int kq) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + tx * 4 + c;
    ld4(b[c], S + n * 32 + ((kq ^ ((n >> 2) & 7)) * 4));
  }
}

// pass 1: 128 x 64 per block, A, B and G, depth d
struct Act32 {
  static constexpr int BM = 128, BN = 64, BK = 32, XP = BK + 4;
  static constexpr int SX = BM * XP, SW = BK * BN, S2 = BN * BK;
  static constexpr int STAGE = 2 * SX + 2 * SW + S2;
  static constexpr int SMEM = FST * STAGE * 4;
};

__global__ void __launch_bounds__(NT, 1)
    bwd_act_f32_kernel(const float* __restrict__ xs,
                       const float* __restrict__ w1,
                       const float* __restrict__ w3,
                       const float* __restrict__ w2,
                       const float* __restrict__ dys,
                       const int* __restrict__ eid,
                       const int* __restrict__ valid, float* __restrict__ da,
                       float* __restrict__ db, float* __restrict__ h, int d,
                       int f, int block_t, int spt) {
  using L = Act32;
  const RowBlock<L::BM> rb(blockIdx.y, block_t, spt);
  if (!valid[rb.tile]) return;  // its scratch rows are never read
  const int n0 = blockIdx.x * L::BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t woff = (size_t)eid[rb.tile] * d * f;
  const float* X = xs + (size_t)rb.row0 * d;
  const float* D = dys + (size_t)rb.row0 * d;
  const float* W1 = w1 + woff;
  const float* W3 = w3 + woff;
  const float* W2 = w2 + woff + (size_t)n0 * d;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  auto load = [&](int slot, int kt) {
    float* s = smem + slot * L::STAGE;
    const int k0 = kt * L::BK;
    cp_tile<float, L::BM, L::BK, L::XP>(s, X, d, rb.rows, k0, d);
    cp_tile<float, L::BM, L::BK, L::XP>(s + L::SX, D, d, rb.rows, k0, d);
    cp_tile<float, L::BK, L::BN, L::BN>(s + 2 * L::SX, W1 + (size_t)k0 * f,
                                        f, d - k0, n0, f);
    cp_tile<float, L::BK, L::BN, L::BN>(s + 2 * L::SX + L::SW,
                                        W3 + (size_t)k0 * f, f, d - k0, n0, f);
    cp_tile<float, L::BN, L::BK, L::BK, true>(s + 2 * L::SX + 2 * L::SW, W2,
                                              d, f - n0, k0, d);
  };

  float accA[8][4] = {}, accB[8][4] = {}, accG[8][4] = {};
  const int nk = (d + L::BK - 1) / L::BK;
#pragma unroll
  for (int i = 0; i < FST - 1; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FST - 2>();
    __syncthreads();
    if (kt + FST - 1 < nk) load((kt + FST - 1) % FST, kt + FST - 1);
    cp_async_commit();
    const float* s = smem + (kt % FST) * L::STAGE;
    const float* sw1 = s + 2 * L::SX;
    const float* sw3 = sw1 + L::SW;
#pragma unroll
    for (int kq = 0; kq < L::BK / 4; ++kq) {
      float a[8][4], b[4][4];
      rows_k4<L::XP>(a, s, ty, kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ld4(b[kk], sw1 + (kq * 4 + kk) * L::BN
                                                    + tx * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            accA[i][c] = fmaf(a[i][kk], b[kk][c], accA[i][c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ld4(b[kk], sw3 + (kq * 4 + kk) * L::BN
                                                    + tx * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            accB[i][c] = fmaf(a[i][kk], b[kk][c], accB[i][c]);
      rows_k4<L::XP>(a, s + L::SX, ty, kq);
      cols_k4_swz(b, sw3 + L::SW, 0, tx, kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            accG[i][c] = fmaf(a[i][kk], b[c][kk], accG[i][c]);
    }
  }
  cp_async_wait<0>();

  const int n = n0 + tx * 4;  // f % 4 == 0
  if (n >= f) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row8(ty, i);
    if (r >= rb.rows) continue;
    float va[4], vb[4], vh[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      act_grad(accA[i][c], accB[i][c], accG[i][c], va[c], vb[c], vh[c]);
    const size_t at = (size_t)(rb.row0 + r) * f + n;
    st4(da + at, va[0], va[1], va[2], va[3]);
    st4(db + at, vb[0], vb[1], vb[2], vb[3]);
    st4(h + at, vh[0], vh[1], vh[2], vh[3]);
  }
}

// pass 2: 128 x 128 per block, dxs = dA W1^T + dB W3^T, depth 2f
struct Dx32 {
  static constexpr int BM = 128, BN = 128, BK = 32, XP = BK + 4;
  static constexpr int SA = BM * XP, SB = BN * BK, STAGE = SA + SB;
  static constexpr int SMEM = FST * STAGE * 4;
};

__global__ void __launch_bounds__(NT, 2)
    bwd_dx_f32_kernel(const float* __restrict__ da,
                      const float* __restrict__ db,
                      const float* __restrict__ w1,
                      const float* __restrict__ w3,
                      const int* __restrict__ eid,
                      const int* __restrict__ valid, float* __restrict__ dxs,
                      int d, int f, int block_t, int spt) {
  using L = Dx32;
  const RowBlock<L::BM> rb(blockIdx.y, block_t, spt);
  const int n0 = blockIdx.x * L::BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (!valid[rb.tile]) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch = threadIdx.x; ch < rb.rows * (L::BN / 4); ch += NT) {
      const int r = ch / (L::BN / 4), n = n0 + (ch % (L::BN / 4)) * 4;
      if (n < d)
        *reinterpret_cast<float4*>(dxs + (size_t)(rb.row0 + r) * d + n) = z;
    }
    return;
  }
  const size_t woff = (size_t)eid[rb.tile] * d * f;
  const size_t roff = (size_t)rb.row0 * f;
  const size_t noff = (size_t)n0 * f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int nh = (f + L::BK - 1) / L::BK, nk = 2 * nh;
  auto load = [&](int slot, int kt) {
    float* s = smem + slot * L::STAGE;
    const bool second = kt >= nh;
    const int k0 = (kt - (second ? nh : 0)) * L::BK;
    cp_tile<float, L::BM, L::BK, L::XP>(s, (second ? db : da) + roff, f,
                                        rb.rows, k0, f);
    cp_tile<float, L::BN, L::BK, L::BK, true>(
        s + L::SA, (second ? w3 : w1) + woff + noff, f, d - n0, k0, f);
  };

  float acc[8][8] = {};
#pragma unroll
  for (int i = 0; i < FST - 1; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FST - 2>();
    __syncthreads();
    if (kt + FST - 1 < nk) load((kt + FST - 1) % FST, kt + FST - 1);
    cp_async_commit();
    const float* s = smem + (kt % FST) * L::STAGE;
#pragma unroll 1
    for (int kq = 0; kq < L::BK / 4; ++kq) {
      float a[8][4], b[4][4];
      rows_k4<L::XP>(a, s, ty, kq);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        cols_k4_swz(b, s + L::SA, half * 64, tx, kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][half * 4 + c] =
                  fmaf(a[i][kk], b[c][kk], acc[i][half * 4 + c]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row8(ty, i);
    if (r >= rb.rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n < d)
        st4(dxs + (size_t)(rb.row0 + r) * d + n, acc[i][half * 4],
            acc[i][half * 4 + 1], acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
    }
  }
}

// pass 3: per (expert, 128 d columns c, 64 f columns j): dW1, dW3 and
// dW2^T as (c x j) tiles, depth the expert's rows
struct Dw32 {
  static constexpr int BC = 128, BJ = 64, BK = 32;
  static constexpr int SX = BK * BC, SJ = BK * BJ;
  static constexpr int STAGE = 2 * SX + 3 * SJ;
  static constexpr int SMEM = FST * STAGE * 4;
};

__global__ void __launch_bounds__(NT, 1)
    bwd_dw_f32_kernel(const float* __restrict__ xs,
                      const float* __restrict__ dys,
                      const float* __restrict__ da,
                      const float* __restrict__ db,
                      const float* __restrict__ h,
                      const int* __restrict__ eid,
                      const int* __restrict__ valid, float* __restrict__ dw1,
                      float* __restrict__ dw3, float* __restrict__ dw2, int d,
                      int f, int block_t, int n_tiles) {
  using L = Dw32;
  const int e = blockIdx.z;
  const int j0 = blockIdx.x * L::BJ, c0 = blockIdx.y * L::BC;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  StageCursor<L::BK> cur(eid, valid, n_tiles, e, block_t);
  const int nk = count_tiles(eid, valid, n_tiles, e) * cur.spt;
  auto load = [&](int slot) {
    float* s = smem + slot * L::STAGE;
    const int r0 = cur.row0(), nr = cur.rows();
    cp_tile<float, L::BK, L::BC, L::BC>(s, xs + (size_t)r0 * d, d, nr, c0,
                                        d);
    cp_tile<float, L::BK, L::BC, L::BC>(s + L::SX, dys + (size_t)r0 * d, d,
                                        nr, c0, d);
    float* sj = s + 2 * L::SX;
    cp_tile<float, L::BK, L::BJ, L::BJ>(sj, da + (size_t)r0 * f, f, nr, j0,
                                        f);
    cp_tile<float, L::BK, L::BJ, L::BJ>(sj + L::SJ, db + (size_t)r0 * f, f,
                                        nr, j0, f);
    cp_tile<float, L::BK, L::BJ, L::BJ>(sj + 2 * L::SJ, h + (size_t)r0 * f,
                                        f, nr, j0, f);
    cur.advance();
  };

  float acc1[8][4] = {}, acc3[8][4] = {}, acc2[8][4] = {};
#pragma unroll
  for (int i = 0; i < FST - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FST - 2>();
    __syncthreads();
    if (kt + FST - 1 < nk) load((kt + FST - 1) % FST);
    cp_async_commit();
    const float* s = smem + (kt % FST) * L::STAGE;
    const float* sj = s + 2 * L::SX;
#pragma unroll
    for (int r = 0; r < L::BK; ++r) {
      float x[8], g[8], a[4], b[4], hh[4];
      ld4(x, s + r * L::BC + ty * 4);
      ld4(x + 4, s + r * L::BC + 64 + ty * 4);
      ld4(g, s + L::SX + r * L::BC + ty * 4);
      ld4(g + 4, s + L::SX + r * L::BC + 64 + ty * 4);
      ld4(a, sj + r * L::BJ + tx * 4);
      ld4(b, sj + L::SJ + r * L::BJ + tx * 4);
      ld4(hh, sj + 2 * L::SJ + r * L::BJ + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc1[i][c] = fmaf(x[i], a[c], acc1[i][c]);
          acc3[i][c] = fmaf(x[i], b[c], acc3[i][c]);
          acc2[i][c] = fmaf(g[i], hh[c], acc2[i][c]);
        }
    }
  }
  cp_async_wait<0>();

  const size_t woff = (size_t)e * d * f;
  const int j = j0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // dW1[c][j..j+3], dW3
    const int c = c0 + row8(ty, i);
    if (c >= d || j >= f) continue;
    const size_t at = woff + (size_t)c * f + j;
    st4(dw1 + at, acc1[i][0], acc1[i][1], acc1[i][2], acc1[i][3]);
    st4(dw3 + at, acc3[i][0], acc3[i][1], acc3[i][2], acc3[i][3]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // dW2[j + c][c0 + row8(ty, 0..7)]
    if (j + c >= f) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cc = c0 + half * 64 + ty * 4;
      if (cc < d)
        st4(dw2 + woff + (size_t)(j + c) * d + cc, acc2[half * 4][c],
            acc2[half * 4 + 1][c], acc2[half * 4 + 2][c],
            acc2[half * 4 + 3][c]);
    }
  }
}

int launch_f32(const float* xs, const float* w1, const float* w3,
               const float* w2, const int* eid, const int* val,
               const float* dys, float* da, float* db, float* h, float* dxs,
               float* dw1, float* dw3, float* dw2, int P, int d, int f, int E,
               int block_t, cudaStream_t s) {
  constexpr int m1 = Act32::SMEM, m2 = Dx32::SMEM, m3 = Dw32::SMEM;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_act_f32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  m1)) ||
      (err = cudaFuncSetAttribute(bwd_dx_f32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  m2)) ||
      (err = cudaFuncSetAttribute(bwd_dw_f32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  m3)))
    return (int)err;
  const int spt = (block_t + 127) / 128, tiles = P / block_t;
  const int nj = (f + 63) / 64, nc = (d + 127) / 128;
  bwd_act_f32_kernel<<<dim3(nj, tiles * spt), NT, m1, s>>>(
      xs, w1, w3, w2, dys, eid, val, da, db, h, d, f, block_t, spt);
  if ((err = cudaGetLastError())) return (int)err;
  bwd_dx_f32_kernel<<<dim3(nc, tiles * spt), NT, m2, s>>>(
      da, db, w1, w3, eid, val, dxs, d, f, block_t, spt);
  if ((err = cudaGetLastError())) return (int)err;
  bwd_dw_f32_kernel<<<dim3(nj, nc, E), NT, m3, s>>>(
      xs, dys, da, db, h, eid, val, dw1, dw3, dw2, d, f, block_t, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// xs, dys (P, d), w1 / w3 (E, d, f), w2 (E, f, d) in one dtype, 16-byte
// aligned, d and f multiples of 8; tile_eid / tile_valid (P / block_t,)
// int32; da, db, h (P, f) scratches in the dtype; dxs (P, d), dw1 / dw3
// (E, d, f), dw2 (E, f, d) the outputs, every element written. Three
// kernels on `stream`; returns cudaGetLastError().
extern "C" int grouped_ffn_bwd(const void* xs, const void* w1, const void* w3,
                               const void* w2, const void* tile_eid,
                               const void* tile_valid, const void* dys,
                               void* da, void* db, void* h, void* dxs,
                               void* dw1, void* dw3, void* dw2, int P, int d,
                               int f, int E, int block_t, int dtype,
                               void* stream) {
  if (P < 1 || d < 8 || f < 8 || d % 8 || f % 8 || E < 1 || block_t < 1 ||
      P % block_t || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  const int* val = static_cast<const int*>(tile_valid);
  if (dtype == kF32) {
    using F = const float*;
    return launch_f32(static_cast<F>(xs), static_cast<F>(w1),
                      static_cast<F>(w3), static_cast<F>(w2), eid, val,
                      static_cast<F>(dys), static_cast<float*>(da),
                      static_cast<float*>(db), static_cast<float*>(h),
                      static_cast<float*>(dxs), static_cast<float*>(dw1),
                      static_cast<float*>(dw3), static_cast<float*>(dw2), P, d,
                      f, E, block_t, s);
  }
  if (dtype == kBF16) {
    using B = const bf16*;
    auto run = block_t > 64 ? &launch_tc<128> : &launch_tc<64>;
    return run(static_cast<B>(xs), static_cast<B>(w1), static_cast<B>(w3),
               static_cast<B>(w2), eid, val, static_cast<B>(dys),
               static_cast<bf16*>(da), static_cast<bf16*>(db),
               static_cast<bf16*>(h), static_cast<bf16*>(dxs),
               static_cast<bf16*>(dw1), static_cast<bf16*>(dw3),
               static_cast<bf16*>(dw2), P, d, f, E, block_t, s);
  }
  return (int)cudaErrorInvalidValue;
}
