// moe_ffn_bwd — the gradient of the XShare masked expert FFN (moe_ffn.cu).
//
// The Pallas kernel `moe_ffn` (body `_kernel`) of
// src/repro/kernels/moe_ffn.py:77 has no backward of its own: the JAX
// package differentiates its dense jnp path (src/repro/models/moe.py
// expert_ffn, dispatch="dense"). This is the gradient of the function the
// forward kernel computes,
//     y = sum over the slots e of combine[:, e] * (silu(A) * B) W2[e],
// A = x W1[e], B = x W3[e], the slots being the first `slots` active
// experts in index order (the forward's slot_expert). Given dy, with
// c = combine[:, e], G = dy W2[e]^T (the ungated term), s = sigmoid(A)
// and H = silu(A) * B:
//     dA = c G B s (1 + A (1 - s)),   dB = c G silu(A),
//     dx = sum_e dA W1[e]^T + dB W3[e]^T,
//     dW1[e] = x^T dA,  dW3[e] = x^T dB,  dW2[e] = (c H)^T dy,
//     dcombine[t, e] = sum_f G H = <dy_t, H_e(t) W2[e]>   (the router's),
// and zero weight gradients and a zero dcombine column for every expert
// outside the slots.
//
// What bounds it on the H100 (published peaks of the SXM part at 700 W:
// 3.35 TB/s, 495 TFLOP/s TF32 and 989 bf16 on the tensor cores): T <= 32
// tokens use each weight element, so it is bound by bytes. It must read
// the selected experts' W1, W3 and W2 and write dW1, dW3 and dW2 for all
// E experts (the gradient has the weights' full shape): at granite-moe's
// decode shape (T 8, d 1024, f 512, 28 of 32 experts) 176 MB read and
// 201 MB written in f32, 0.113 ms; at the dense train step's T 32 (all
// 32 experts) 403 MB, 0.120 ms. Its eight products of 2 T d f operations
// an expert (8.6 GFLOP at T 32) take 0.128 ms as f32 FMAs, more than the
// bytes, and 0.052 ms as 3xTF32 on the tensor cores, which is why every
// product runs there.
//
// Design: two launches, no float atomics (every output element is one
// block's, every sum runs in a fixed order, so two calls give the same
// bits), no host sync (each block finds its experts from `active`):
//   1. strip: as many thread block clusters as the card holds at once
//      (the runtime's count; 30 at granite's shape), each taking an even,
//      contiguous share of the (slot, strip of 32 f columns) items in
//      slot-major order, so no cluster waits on a second wave. A
//      cluster's CL blocks (CL = min(8, ceil(d / 128))) split d, 128 rows
//      or fewer each. For an item a block holds its rows of the strip's
//      W1 and W3 columns, the strip's W2 rows and (once for all items)
//      its x and dy columns in shared memory, brought by cp.async (the
//      next item's W1 / W3 while this one is formed, its W2 after this
//      one's first products), forms its partial A, B and G (K = its
//      rows), and sends them by st.async to the block that owns their
//      token rows (ceil(T / CL) rows a block). The owner sums the CL
//      partials in rank order, forms dA, dB and c H and G H, writes
//      dcombine's part of the strip (G H summed over its columns) to Pc
//      (slots, NS, T), and sends dA, dB, c H to every block. Each send
//      counts its bytes on the receiver's mbarrier, and a block waits on
//      its own: no cluster barrier per item, whose release would also
//      wait for the block's gradient stores. From the rows it holds a
//      block then adds its part of dx, dA W1^T + dB W3^T, to register
//      tiles that stay there for all its items, and writes its dW1 and
//      dW3 rows (x^T dA, x^T dB) and dW2 columns ((c H)^T dy), half while
//      the next item's partials travel and half while its dA, dB, c H
//      do (f32 at 32 tokens: after dx, to keep two blocks an SM). So each
//      weight element is read once and each gradient element written
//      once; dx's parts go to Pdx (clusters, T, d), one a cluster. Every
//      block first writes its share of the zero tiles of the experts
//      outside the slots. For d > 1024 (a block over more than one chunk
//      of 128 rows) a block holds one chunk at a time: it reads its W1,
//      W3, x and dy chunks a second time for the weight gradients, and
//      adds each chunk's dx part to the cluster's in device memory.
//   2. reduce: dx = the clusters' parts summed in order (8 warps a block
//      of 32 elements, each summing an eighth of the parts, then the
//      eighths in order), and each slot column of dcombine the sum of its
//      Pc parts in strip order; the other columns of dcombine 0. Pass 1's
//      blocks let it launch by programmatic dependent launch once their
//      items are done, so it starts during pass 1's tail and waits for
//      pass 1 only to read.
// Products (tokens on the mma's 8-wide side where they are not the K):
//   A^T = W1^T x^T, B^T = W3^T x^T, G^T = W2 dy^T (K = a block's rows);
//   dW1 = x^T dA, dW3 = x^T dB, dW2 = (c H)^T dy (K = T, zero-padded);
//   dx^T = W1 dA^T + W3 dB^T (K = the strip's 32 columns).
// f32: every product on mma.sync m16n8k8 as 3xTF32 (common.cuh: a = hi +
// lo, lo·hi + hi·lo + hi·hi), never one TF32 product; fragments read
// from shared memory by the lda / ldb helpers of common.cuh. bf16: mma.sync
// m16n8k16 with f32 accumulation, fragments by ldmatrix (.trans where a
// tile is stored k-major); dA and dB are rounded to bf16 as the operands
// of the weight-gradient and dx products (a relative 2^-9 each, under the
// 2e-2 tolerance). In bf16, c H is rounded to bf16 before it multiplies
// dy, as the forward rounds c H before its down product; dcombine takes H
// in f32, since the rounding is of c H and its derivative in c is taken
// to be H, as the JAX package treats its own roundings.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 6;            // warps of a block: one per (product, f half)
constexpr int NTHR = 32 * NW;
constexpr int FS = 32;           // f columns of a strip
constexpr int RC = 128;          // rows of d of a chunk
constexpr int CLMAX = 8;         // blocks of a cluster (the portable most)
constexpr int NDX = RC / 16;     // dx row tiles of a chunk
// weight-gradient jobs of a chunk (16 x 32 each): dW1 and dW3 8 row tiles
// of the strip's 32 columns, dW2 2 row tiles x 4 groups of 32 columns;
// warp w takes jobs [JW w, JW (w + 1)). The dx row tiles w and w + NW are
// warp w's.
constexpr int NJOB = 24, JW = NJOB / NW;
static_assert(NJOB % NW == 0 && FS == 32 && RC == 128,
              "the jobs' tiles; a warp a token row of a strip");

// Shared memory of a cluster block, by byte offset: STG stages of W1 and
// W3 (RC x FS each, pitch WP), W2 (FS x RC, pitch XP), x and dy (MR x RC),
// ND copies of dA, dB, c H (3, MR, FS; pitch DP, in T) as the owners send
// them, bf16's staging tiles, two mbarriers, the item's combine values of
// the rows this block owns, and the inbox of partial sums
// (CL senders, 3, the rows this block owns, FS) in f32. Rows are padded
// by 16 bytes. OVL: the weight gradients of an item are formed while the
// next item's partials travel, so D has two copies; else (f32 at 32
// tokens, to keep two blocks an SM) one. STG 2: the next item's W1 and W3
// come in while this one is formed.
template <typename T, int MT>
struct Lay {
  static constexpr int SZ = sizeof(T), V = 16 / SZ;
  static constexpr int MR = SZ == 2 && MT < 16 ? 16 : MT;  // bf16: k of 16
  static constexpr int NT = MT / 8;                        // 8-token tiles
  static constexpr bool OVL = !(SZ == 4 && MT == 32);
  static constexpr int STG = SZ == 4 && MT >= 16 ? 1 : 2;
  static constexpr int ND = OVL ? 2 : 1;
  static constexpr int WP = FS + V, XP = RC + V, DP = FS + V;
  static constexpr int WS = RC * WP * SZ;         // one W1 or W3 tile
  static constexpr int OW2 = 2 * STG * WS;
  static constexpr int OX = OW2 + FS * XP * SZ, ODY = OX + MR * XP * SZ;
  static constexpr int OD = ODY + MR * XP * SZ;
  static constexpr int DB = 3 * MR * DP * SZ;     // one copy of D
  // bf16: each warp's 16 x 32 tile of a weight gradient, so its stores go
  // out 16 bytes a lane and whole 32-byte sectors
  static constexpr int SP = FS + V;
  static constexpr int OS = OD + ND * DB;
  static constexpr int OMB = OS + (SZ == 2 ? NW * 16 * SP * SZ : 0);
  static constexpr int OCM = OMB + 16;   // combine's column, owned rows
  static constexpr int OIN = OCM + 32 * 4;
  // token rows a block owns: ceil(MT / CL)
  __host__ __device__ static constexpr int rpo(int cl) {
    return (MT + cl - 1) / cl;
  }
  static constexpr int smem(int cl) {
    return OIN + cl * 3 * rpo(cl) * FS * 4;
  }
  // two blocks an SM when the cluster splits d in 8
  static_assert(OIN + 8 * 3 * (MT / 8) * FS * 4 <= 113 * 1024,
                "shared memory");
};

// ---- distributed shared memory: sends that complete an mbarrier --------
//
// A block's partial sums go straight to their owner's inbox, and the
// owners' dA, dB, c H to every block of the cluster, by st.async: each
// send counts its bytes on the receiver's mbarrier, and a receiver waits
// on its own mbarrier for the bytes it expects. No cluster barrier is
// taken per item: one would release this thread's global stores too, and
// so wait for the weight gradients' stores to land.

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// this block's arrival for the phase, expecting `bytes` from the senders
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the phase of the given parity to complete; a wait past ~4M
// polls traps rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1 << 22)) __trap();
  }
}
// p's address in the shared memory of cluster block `rank`
__device__ __forceinline__ uint32_t dsmem(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void send_b32(uint32_t addr, uint32_t v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void send_v2(uint32_t addr, uint32_t a,
                                        uint32_t b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "r"(a), "r"(b), "r"(bar)
      : "memory");
}

// Warp-wide (every lane returns the same): the number of active experts;
// the s-th active expert (the forward's slot s); the z-th expert outside
// the first nv active ones, in index order.
__device__ __forceinline__ int count_active(
    const unsigned char* __restrict__ active, int E) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int c0 = 0; c0 < E; c0 += 32)
    n += __popc(__ballot_sync(0xffffffffu,
                              c0 + lane < E && active[c0 + lane] != 0));
  return n;
}
template <bool SLOT>
__device__ __forceinline__ int nth_expert(
    const unsigned char* __restrict__ active, int E, int nv, int z) {
  const int lane = threadIdx.x & 31;
  int seen_act = 0, seen = 0;
  for (int c0 = 0; c0 < E; c0 += 32) {
    const int i = c0 + lane;
    const bool a = i < E && active[i] != 0;
    const unsigned ab = __ballot_sync(0xffffffffu, a);
    const int rank = seen_act + __popc(ab & ((1u << lane) - 1u));
    const bool in_slot = a && rank < nv;
    const unsigned bits =
        __ballot_sync(0xffffffffu, i < E && (SLOT ? in_slot : !in_slot));
    if (z < seen + __popc(bits)) {
      unsigned bb = bits;
      for (int k = z - seen; k > 0; --k) bb &= bb - 1;  // drop lower bits
      return c0 + __ffs(bb) - 1;
    }
    seen_act += __popc(ab);
    seen += __popc(bits);
  }
  return -1;
}

// b of a k-step (permuted k, as lda_tf32_kmajor reads a) from a tile
// stored [n][k]: column n is the tile's row n0 + n
template <typename T>
__device__ __forceinline__ void ldb_tf32_rowperm(const T* t, int p, int n0,
                                                 int k0, float (&v)[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const T* s = t + (n0 + g) * p + k0 + 2 * q;
  v[0] = to_f32(s[0]);
  v[1] = to_f32(s[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
}

// two neighbouring elements of a row, from f32
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// acc (a 16-column f half of A^T, B^T or G^T: warp w takes product w / 2
// and half w % 2) += its product over rows [0, nr) of the held chunk (zero
// past nr). At one n-tile (T <= 8) the k-steps alternate between acc and a
// second sum, added at the end, so two mma chains are in flight.
template <typename T, int MT>
__device__ __forceinline__ void act_products(float (&acc)[MT / 8][4],
                                             const T* sW1, const T* sW3,
                                             const T* sW2, const T* sX,
                                             const T* sDY, int nr) {
  using L = Lay<T, MT>;
  constexpr int NT = L::NT, WP = L::WP, XP = L::XP;
  const int warp = threadIdx.x >> 5, p = warp >> 1, m0 = (warp & 1) * 16;
  const T* Wt = p == 0 ? sW1 : sW3;   // W1 / W3 stored [k][f]: A k-major
  const T* Bt = p == 2 ? sDY : sX;    // x / dy stored [t][k]
  constexpr int KD = sizeof(T) == 4 ? 8 : 16;   // the mma's depth
  constexpr int KC = NT == 1 ? 2 : 1;           // chains
  float acc2[NT][4];
  zero(acc2);
  auto step = [&](float (&c)[NT][4], int kk) {
    if constexpr (sizeof(T) == 4) {
      float a[4];
      if (p < 2)
        lda_tf32_kmajor(Wt, WP, m0, kk, a);
      else
        lda_tf32_perm(sW2, XP, m0, kk, a);
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      split_tf32(a, ah, al);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float b[2];
        ldb_tf32_rowperm(Bt, XP, 8 * n, kk, b);
        split_tf32(b, bh[n], bl[n]);
      }
      mma_3xtf32<false, false, NT>(c, 0, ah, al, bh, bl);
    } else {
      uint32_t a[4];
      if (p < 2)
        ldmatrix_x4_trans(a, x4_addr<false>(Wt, WP, kk, m0));
      else
        ldmatrix_x4(a, x4_addr<true>(sW2, XP, m0, kk));
#pragma unroll
      for (int np = 0; np < L::MR / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, x4_addr<false>(Bt, XP, 16 * np, kk));
        mma_bf16(c[2 * np], a, b[0], b[1]);
        if (2 * np + 1 < NT) mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  };
#pragma unroll 4
  for (int kk = 0; kk < nr; kk += KC * KD) {
    step(acc, kk);
    if constexpr (KC == 2) step(acc2, kk + KD);   // rows past nr are zero
  }
  if constexpr (KC == 2)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][i] += acc2[0][i];
}

// c (16 x 32: four n-tiles) = A (16 rows from m0, stored [k][m], pitch
// ap) x B (32 columns from n0, stored [k][n], pitch bp) over k = the
// tokens
template <typename T, int MT>
__device__ __forceinline__ void tok_product(float (&c)[4][4], const T* A,
                                            int ap, int m0, const T* B,
                                            int bp, int n0) {
  zero(c);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int t0 = 0; t0 < MT; t0 += 8) {
      float a[4];
      lda_tf32_kmajor(A, ap, m0, t0, a);
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
      split_tf32(a, ah, al);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float b[2];
        ldb_tf32_perm(B, bp, t0, n0 + 8 * u, b);
        split_tf32(b, bh[u], bl[u]);
      }
      mma_3xtf32<false, false, 4>(c, 0, ah, al, bh, bl);
    }
  } else {
#pragma unroll
    for (int t0 = 0; t0 < Lay<T, MT>::MR; t0 += 16) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, x4_addr<false>(A, ap, t0, m0));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, x4_addr<true>(B, bp, t0, n0 + 16 * np));
        mma_bf16(c[2 * np], a, b[0], b[1]);
        mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// Store a 16 x 32 tile c (tok_product's) at rows r0 .., columns c0 .. of
// a row-major gradient (pitch ld; rows below r1 and columns below c1
// written). f32: two neighbouring elements a lane (whole sectors); bf16:
// through the warp's staging tile, 16 bytes a lane.
template <typename T>
__device__ __forceinline__ void store_tile(const float (&c)[4][4], T* out,
                                           size_t ld, int r0, int r1, int c0,
                                           int c1, T* stage) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h, col = c0 + 8 * u + 2 * q;
        if (r < r1 && col < c1)
          store2(out + (size_t)r * ld + col, c[u][2 * h], c[u][2 * h + 1]);
      }
  } else {
    constexpr int SP = FS + 16 / (int)sizeof(T);   // Lay's SP
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(stage + (g + 8 * h) * SP + 8 * u +
                                     2 * q) =
            pack_bf16(c[u][2 * h], c[u][2 * h + 1]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int rr = (lane >> 2) + 8 * k, cc = 8 * (lane & 3);
      const int r = r0 + rr, col = c0 + cc;
      if (r < r1 && col < c1)
        *reinterpret_cast<uint4*>(out + (size_t)r * ld + col) =
            *reinterpret_cast<const uint4*>(stage + rr * SP + cc);
    }
    __syncwarp();
  }
}

// c (16 rows of the chunk from m0, all MT tokens) += W (the chunk's rows
// of the strip, stored [d][f]) x Dg^T (Dg stored [t][f]) over the strip's
// 32 columns
template <typename T, int MT>
__device__ __forceinline__ void dx_product(float (&c)[MT / 8][4],
                                           const T* W, const T* Dg,
                                           int m0) {
  using L = Lay<T, MT>;
  constexpr int NT = L::NT;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int fk = 0; fk < FS; fk += 8) {
      float a[4];
      lda_tf32(W, L::WP, m0, fk, a);
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      split_tf32(a, ah, al);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float b[2];
        ldb_tf32(Dg, L::DP, 8 * n, fk, b);
        split_tf32(b, bh[n], bl[n]);
      }
      mma_3xtf32<false, false, NT>(c, 0, ah, al, bh, bl);
    }
  } else {
#pragma unroll
    for (int fk = 0; fk < FS; fk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, x4_addr<true>(W, L::WP, m0, fk));
#pragma unroll
      for (int np = 0; np < L::MR / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, x4_addr<false>(Dg, L::DP, 16 * np, fk));
        mma_bf16(c[2 * np], a, b[0], b[1]);
        if (2 * np + 1 < NT) mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// c += dA W1^T + dB W3^T for 16 rows of the chunk from m0; at one n-tile
// the W3 product goes to a second sum, added after, so two mma chains are
// in flight
template <typename T, int MT>
__device__ __forceinline__ void dx_products(float (&c)[MT / 8][4],
                                            const T* W1, const T* W3,
                                            const T* DA, const T* DB,
                                            int m0) {
  if constexpr (MT == 8) {
    float c3[1][4] = {};
    dx_product<T, MT>(c, W1, DA, m0);
    dx_product<T, MT>(c3, W3, DB, m0);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[0][i] += c3[0][i];
  } else {
    dx_product<T, MT>(c, W1, DA, m0);
    dx_product<T, MT>(c, W3, DB, m0);
  }
}

// ---- pass 1: persistent clusters over the (slot, strip) items ----------

template <typename T, int MT>
__global__ void __launch_bounds__(NTHR, 2)
moe_bwd_strip_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ w3, const T* __restrict__ w2,
                     const T* __restrict__ dy,
                     const float* __restrict__ combine, int ldc,
                     const unsigned char* __restrict__ active,
                     float* __restrict__ Pc, float* __restrict__ Pdx,
                     T* __restrict__ dw1, T* __restrict__ dw3,
                     T* __restrict__ dw2, int Tn, int d, int f, int E,
                     int slots, int RR, int nc, int NS) {
  using L = Lay<T, MT>;
  constexpr int V = L::V, MR = L::MR, NT = L::NT, WP = L::WP, XP = L::XP,
                DP = L::DP, STG = L::STG;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int C = gridDim.x / CL, cid = blockIdx.x / CL;
  const int kr0 = r * RR, kr1 = min(d, kr0 + RR);       // the block's rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool ovl = L::OVL && nc == 1;
  // the items (slot, strip), slot-major: this cluster's share [it0, it1)
  const int nv = min(slots, count_active(active, E));
  const int N = nv * NS;
  const int it0 = (int)((long long)cid * N / C);
  const int it1 = (int)((long long)(cid + 1) * N / C);
  // token rows [o0, o1) of every item are this block's to finish; block
  // rq owns rows from rq * rpo
  const int rpo = L::rpo(CL), o0 = min(MT, r * rpo), o1 = min(MT, o0 + rpo);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto sW1 = [&](int st) {
    return reinterpret_cast<T*>(smem_raw + 2 * st * L::WS);
  };
  auto sW3 = [&](int st) {
    return reinterpret_cast<T*>(smem_raw + (2 * st + 1) * L::WS);
  };
  T* sW2 = reinterpret_cast<T*>(smem_raw + L::OW2);
  T* sX = reinterpret_cast<T*>(smem_raw + L::OX);
  T* sDY = reinterpret_cast<T*>(smem_raw + L::ODY);
  auto sDv = [&](int b) {   // copy b of dA, dB, c H
    return reinterpret_cast<T*>(smem_raw + L::OD + b * L::DB);
  };
  uint64_t* mbIn = reinterpret_cast<uint64_t*>(smem_raw + L::OMB);
  uint64_t* mbD = mbIn + 1;
  float* sIn = reinterpret_cast<float*>(smem_raw + L::OIN);
  float* sCm = reinterpret_cast<float*>(smem_raw + L::OCM);
  // D's token rows past MT (bf16's k padding) are zero; no owner sends
  // them
  if constexpr (MR > MT) {
    constexpr int PR = (MR - MT) * DP, PADN = 3 * PR;
    for (int i = threadIdx.x; i < L::ND * PADN; i += NTHR)
      sDv(i / PADN)[(i % PADN / PR) * MR * DP + MT * DP + i % PR] =
          from_f32<T>(0.f);
  }
  if (threadIdx.x == 0) {
    mbar_init(mbIn);
    mbar_init(mbD);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // every block's mbarriers live before any send
  // copies of a chunk (rows [k0, kend) of d; zero past it, past f, past T)
  auto load_w13 = [&](int st, int e, int strip, int k0, int kend) {
    constexpr int CW = FS / V;
    const T* W1 = w1 + (size_t)e * d * f;
    const T* W3 = w3 + (size_t)e * d * f;
    T* b1 = sW1(st);
    T* b3 = sW3(st);
    const int n0 = strip * FS;
    for (int c = threadIdx.x; c < RC * CW; c += NTHR) {
      const int rr = c / CW, cq = c % CW, k = k0 + rr, n = n0 + cq * V;
      const bool ok = k < kend && n < f;
      const size_t off = ok ? (size_t)k * f + n : 0;
      cp_async16(b1 + rr * WP + cq * V, W1 + off, ok);
      cp_async16(b3 + rr * WP + cq * V, W3 + off, ok);
    }
  };
  auto load_w2 = [&](int e, int strip, int k0, int kend) {
    constexpr int CR = RC / V;
    const T* W2 = w2 + (size_t)e * f * d;
    const int n0 = strip * FS;
    for (int c = threadIdx.x; c < FS * CR; c += NTHR) {
      const int rr = c / CR, cq = c % CR, n = n0 + rr, k = k0 + cq * V;
      const bool ok = n < f && k < kend;
      cp_async16(sW2 + rr * XP + cq * V, W2 + (ok ? (size_t)n * d + k : 0),
                 ok);
    }
  };
  auto load_x = [&](int k0, int kend) {
    constexpr int CR = RC / V;
    for (int c = threadIdx.x; c < MR * CR; c += NTHR) {
      const int t = c / CR, cq = c % CR, k = k0 + cq * V;
      const bool ok = t < Tn && k < kend;
      const size_t off = ok ? (size_t)t * d + k : 0;
      cp_async16(sX + t * XP + cq * V, x + off, ok);
      cp_async16(sDY + t * XP + cq * V, dy + off, ok);
    }
  };
  // the weight-gradient jobs [jlo, jhi) of this warp for expert e, strip
  // columns from n0, chunk rows [k0, kend): 16 x 32 tiles from x, dy and
  // dA, dB, c H (Dv)
  auto dw_jobs = [&](int jlo, int jhi, int e, int n0, int k0, int kend,
                     const T* Dv) {
    const T* sDA = Dv;
    const T* sDB = Dv + MR * DP;
    const T* sCH = Dv + 2 * MR * DP;
    T* D1 = dw1 + (size_t)e * d * f;
    T* D3 = dw3 + (size_t)e * d * f;
    T* D2 = dw2 + (size_t)e * f * d;
    T* stage = reinterpret_cast<T*>(smem_raw + L::OS) + warp * 16 * L::SP;
    for (int jb = jlo; jb < jhi; ++jb) {
      float cv[4][4];
      if (jb < 16) {   // dW1 / dW3 rows k0 + 16 mi, the strip's columns
        const int mi = jb & 7, k = k0 + 16 * mi;
        if (k >= kend) continue;
        tok_product<T, MT>(cv, sX, XP, 16 * mi, jb < 8 ? sDA : sDB, DP, 0);
        store_tile(cv, jb < 8 ? D1 : D3, (size_t)f, k, kend, n0, f, stage);
      } else {         // dW2 rows n0 + 16 mi, columns k0 + 32 cg
        const int mi = (jb - 16) >> 2, cg = (jb - 16) & 3;
        if (k0 + 32 * cg >= kend) continue;
        tok_product<T, MT>(cv, sCH, DP, 16 * mi, sDY, XP, 32 * cg);
        store_tile(cv, D2, (size_t)d, n0 + 16 * mi, f, k0 + 32 * cg, kend,
                   stage);
      }
    }
  };
  if (nc == 1 && it0 < it1) {  // the first item's copies
    const int e0 = nth_expert<true>(active, E, nv, it0 / NS);
    load_x(kr0, kr1);
    load_w13(0, e0, it0 % NS, kr0, kr1);
    load_w2(e0, it0 % NS, kr0, kr1);
    cp_async_commit();
  }
  {
    // this warp's share of the zero tiles of the experts outside the
    // slots, a row of dW1 and dW3, or of dW2, at a time
    const int rows = d + f;
    const long long nz = (long long)(E - nv) * rows;
    const int nw = gridDim.x * NW;
    const uint4 zv = make_uint4(0u, 0u, 0u, 0u);
    int zc = -1, ze = -1;
    for (long long u = (long long)blockIdx.x * NW + warp; u < nz; u += nw) {
      const int zi = (int)(u / rows), row = (int)(u % rows);
      if (zi != zc) {
        ze = nth_expert<false>(active, E, nv, zi);
        zc = zi;
      }
      if (row < d) {
        T* p1 = dw1 + ((size_t)ze * d + row) * f;
        T* p3 = dw3 + ((size_t)ze * d + row) * f;
        for (int c = lane * V; c < f; c += 32 * V) {
          *reinterpret_cast<uint4*>(p1 + c) = zv;
          *reinterpret_cast<uint4*>(p3 + c) = zv;
        }
      } else {
        T* p2 = dw2 + ((size_t)ze * f + row - d) * d;
        for (int c = lane * V; c < d; c += 32 * V)
          *reinterpret_cast<uint4*>(p2 + c) = zv;
      }
    }
  }
  float dxa[2][NT][4];   // dx tiles: chunk rows 16 (warp + u NW), tokens
  zero(dxa[0]);
  zero(dxa[1]);
  // bytes this block's mbarriers expect an item: every block's partials
  // of the rows it owns; the other owners' dA, dB, c H
  const int in_bytes = CL * 3 * (o1 - o0) * FS * 4;
  const int d_bytes = 3 * (MT - (o1 - o0)) * FS * (int)sizeof(T);
  int e_prev = 0, n0_prev = 0;   // the item whose weight gradients wait
  int e = it0 < it1 ? nth_expert<true>(active, E, nv, it0 / NS) : 0;
  for (int it = it0; it < it1; ++it) {
    const int ii = it - it0, st = nc == 1 ? ii % STG : 0, par = ii & 1;
    const int s = it / NS, strip = it % NS, n0 = strip * FS;
    const bool more = it + 1 < it1;
    const int s_next = (it + 1) / NS, strip_next = (it + 1) % NS;
    const int e_next = !more ? 0 : s_next == s
                                   ? e
                                   : nth_expert<true>(active, E, nv, s_next);
    T* sD = sDv(L::ND == 2 ? par : 0);
    if (threadIdx.x == 0) {
      mbar_expect(mbIn, in_bytes);
      mbar_expect(mbD, d_bytes);
    }
    // combine's values of the owned rows: read now, kept after phase 1
    const float cm_own = threadIdx.x < o1 - o0 && o0 + (int)threadIdx.x < Tn
                             ? combine[(size_t)(o0 + threadIdx.x) * ldc + e]
                             : 0.f;
    // A, B, G: this block's rows
    float acc[NT][4];
    zero(acc);
    for (int c = 0; c < nc; ++c) {
      const int k0 = kr0 + c * RC, kend = min(kr1, k0 + RC);
      if (nc > 1) {
        load_x(k0, kend);
        load_w13(0, e, strip, k0, kend);
        load_w2(e, strip, k0, kend);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();  // the chunk landed; the other stage is free
      if (STG == 2 && nc == 1 && more) {
        load_w13(st ^ 1, e_next, strip_next, kr0, kr1);
        cp_async_commit();
      }
      act_products<T, MT>(acc, sW1(st), sW3(st), sW2, sX, sDY, kend - k0);
      if (nc > 1) __syncthreads();  // done with the chunk
    }
    {
      // the partials to their owners' inboxes: (sender r, product, row
      // of the owner's, column)
      const int p = warp >> 1, fc = (warp & 1) * 16 + g;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int t = 8 * n + 2 * q + (v & 1), col = fc + 8 * (v >> 1);
          const int ow = t / rpo;
          const uint32_t dst = dsmem(
              sIn + ((r * 3 + p) * rpo + t - ow * rpo) * FS + col, ow);
          send_b32(dst, __float_as_uint(acc[n][v]), dsmem(mbIn, ow));
        }
    }
    if (threadIdx.x < o1 - o0) sCm[threadIdx.x] = cm_own;
    __syncthreads();  // W2 read by every warp; sCm in place
    if (nc == 1 && more) {
      load_w2(e_next, strip_next, kr0, kr1);
      cp_async_commit();
    }
    // the last item's weight gradients, half while the partials travel,
    // half while dA, dB, c H do
    if (ovl && ii > 0)
      dw_jobs(JW * warp, JW * warp + JW / 2, e_prev, n0_prev, kr0, kr1,
              sDv(par ^ 1));
    mbar_wait(mbIn, par);
    // the rows this block owns, two columns a thread, a half warp a row:
    // the partials summed in rank order, then dA, dB, c H (into this
    // block's D) and G H (summed over the strip's columns into dcombine's
    // part)
    for (int j0 = threadIdx.x & ~31; j0 < (o1 - o0) * (FS / 2); j0 += NTHR) {
      const int j = j0 + lane, tl = j / (FS / 2), cc = 2 * (j % (FS / 2));
      const bool on = j < (o1 - o0) * (FS / 2);
      const int t = o0 + tl;
      float v[3][2] = {}, gh = 0.f;
      if (on) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + cc + h;
          float a = 0.f, b = 0.f, gg = 0.f;
#pragma unroll
          for (int rq = 0; rq < CLMAX; ++rq)
            if (rq < CL) {
              const float* in = sIn + (rq * 3 * rpo + tl) * FS + cc + h;
              a += in[0];
              b += in[rpo * FS];
              gg += in[2 * rpo * FS];
            }
          if (t < Tn && n < f) {
            const float cm = sCm[tl];
            const float sg = 1.f / (1.f + expf(-a));
            const float si = a * sg;
            const float hh = si * b;
            const float gc = cm * gg;
            v[0][h] = gc * b * sg * (1.f + a * (1.f - sg));
            v[1][h] = gc * si;
            // c H as the forward's down product takes it (bf16: rounded)
            v[2][h] = to_f32(from_f32<T>(cm * hh));
            gh += gg * hh;
          }
        }
#pragma unroll
        for (int pr = 0; pr < 3; ++pr) {
          T* dst = sD + (pr * MR + t) * DP + cc;
          if constexpr (sizeof(T) == 4)
            *reinterpret_cast<float2*>(dst) = make_float2(v[pr][0], v[pr][1]);
          else
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v[pr][0], v[pr][1]);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)   // a half warp: one token row
        gh += __shfl_xor_sync(0xffffffffu, gh, o);
      if (on && (j % (FS / 2)) == 0 && t < Tn)
        Pc[((size_t)s * NS + strip) * Tn + t] = gh;
    }
    __syncthreads();  // this block's rows of D in place
    // ... and to every other block of the cluster: a thread per
    // (receiver, row, column pair), three sends
    {
      const int np2 = (o1 - o0) * (FS / 2);
      for (int j = threadIdx.x; j < (CL - 1) * np2; j += NTHR) {
        const int rq = j / np2 + (j / np2 >= r), rem = j % np2;
        const int off = (o0 + rem / (FS / 2)) * DP + 2 * (rem % (FS / 2));
        const uint32_t bar = dsmem(mbD, rq);
#pragma unroll
        for (int pr = 0; pr < 3; ++pr) {
          const T* src = sD + pr * MR * DP + off;
          if constexpr (sizeof(T) == 4) {
            const uint2 w = *reinterpret_cast<const uint2*>(src);
            send_v2(dsmem(src, rq), w.x, w.y, bar);
          } else {
            send_b32(dsmem(src, rq), *reinterpret_cast<const uint32_t*>(src),
                     bar);
          }
        }
      }
    }
    if (ovl && ii > 0)
      dw_jobs(JW * warp + JW / 2, JW * (warp + 1), e_prev, n0_prev, kr0,
              kr1, sDv(par ^ 1));
    mbar_wait(mbD, par);  // dA, dB, c H of every owner in place
    const T* sDA = sD;
    const T* sDB = sD + MR * DP;
    for (int c = 0; c < nc; ++c) {
      const int k0 = kr0 + c * RC, kend = min(kr1, k0 + RC);
      if (nc > 1) {
        load_x(k0, kend);
        load_w13(0, e, strip, k0, kend);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        zero(dxa[0]);
        zero(dxa[1]);
      }
      // dx's part: dA W1^T + dB W3^T over the strip's columns
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int mi = warp + u * NW;
        if (mi < NDX && k0 + 16 * mi < kend)
          dx_products<T, MT>(dxa[u], sW1(st), sW3(st), sDA, sDB, 16 * mi);
      }
      if (nc > 1) {  // add the chunk's part to the cluster's, in order
        float* out = Pdx + (size_t)cid * Tn * d;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int mi = warp + u * NW;
          if (mi >= NDX) continue;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                const int k = k0 + 16 * mi + g + 8 * h, t = 8 * n + 2 * q + v;
                if (k < kend && t < Tn) {
                  float* o = out + (size_t)t * d + k;
                  *o = (ii > 0 ? *o : 0.f) + dxa[u][n][2 * h + v];
                }
              }
        }
      }
      if (STG == 1 && nc == 1 && more) {
        __syncthreads();  // W1 and W3 read: the next item's may come in
        load_w13(0, e_next, strip_next, kr0, kr1);
        cp_async_commit();
      }
      if (!ovl) dw_jobs(JW * warp, JW * (warp + 1), e, n0, k0, kend, sD);
      if (nc > 1) __syncthreads();  // x, dy read: the next chunk may come
    }
    e_prev = e;
    n0_prev = n0;
    e = e_next;
  }
  if (ovl && it1 > it0)
    dw_jobs(JW * warp, JW * (warp + 1), e_prev, n0_prev, kr0, kr1,
            sDv((it1 - it0 - 1) & 1));
  // the cluster's part of dx: its rows of the sum over its items
  float* out = Pdx + (size_t)cid * Tn * d;
  if (nc == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int mi = warp + u * NW;
      if (mi >= NDX) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int k = kr0 + 16 * mi + g + 8 * h, t = 8 * n + 2 * q + v;
            if (k < kr1 && t < Tn)
              out[(size_t)t * d + k] = dxa[u][n][2 * h + v];
          }
    }
  } else if (it0 == it1) {  // no item: a zero part
    for (int i = threadIdx.x; i < Tn * (kr1 - kr0); i += NTHR)
      out[(size_t)(i / (kr1 - kr0)) * d + kr0 + i % (kr1 - kr0)] = 0.f;
  }
  // the reduce may launch now: it overlaps this grid's tail, and waits
  // for it only to read
  pdl_launch_dependents();
  cluster.sync();  // no block leaves while a send to it may be in flight
}

// ---- pass 2: dx and dcombine -------------------------------------------

constexpr int RW = 8;   // warps of a reduce block

// dx: a block per 32 elements (one a lane); warp w sums the parts q in
// [w Q / RW, (w + 1) Q / RW) of the Q clusters' parts, and warp 0 the RW
// warp sums in order. dcombine: the blocks past those, a thread per
// (t, e).
template <typename T>
__global__ void __launch_bounds__(RW * 32)
moe_bwd_reduce_kernel(const float* __restrict__ Pdx,
                      const float* __restrict__ Pc,
                      const unsigned char* __restrict__ active,
                      T* __restrict__ dx, float* __restrict__ dcomb, int Tn,
                      int d, int E, int slots, int NS, int Q) {
  __shared__ float part[RW][32];
  const int nv = min(slots, count_active(active, E));
  pdl_wait();  // pass 1 has finished and its writes are visible
  const int n = Tn * d, nbx = (n + 31) / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if ((int)blockIdx.x < nbx) {  // block-uniform
    const int i = blockIdx.x * 32 + lane;
    float acc = 0.f;
    if (i < n)
      for (int q = w * Q / RW; q < (w + 1) * Q / RW; ++q)
        acc += Pdx[(size_t)q * n + i];
    part[w][lane] = acc;
    __syncthreads();
    if (w == 0 && i < n) {
      float sum = 0.f;
      for (int u = 0; u < RW; ++u) sum += part[u][lane];
      dx[i] = from_f32<T>(sum);
    }
    return;
  }
  const int j = (blockIdx.x - nbx) * blockDim.x + threadIdx.x;
  if (j < Tn * E) {
    const int t = j / E, e = j % E;
    int rank = 0;  // e's slot: the active experts before it
    for (int u = 0; u < e; ++u) rank += active[u] != 0;
    float acc = 0.f;
    if (active[e] != 0 && rank < nv)
      for (int q = 0; q < NS; ++q)
        acc += Pc[((size_t)rank * NS + q) * Tn + t];
    dcomb[(size_t)t * E + e] = acc;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// blocks of a cluster and rows of d a block: CL blocks of RR rows (a
// multiple of 16) cover d; a block holds its rows at once when RR <= RC
void split_d(int d, int& CL, int& RR) {
  CL = d < CLMAX * RC ? ceil_div(d, RC) : CLMAX;
  RR = ceil_div(ceil_div(d, CL), 16) * 16;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int cl, int smem,
                                  cudaStream_t s,
                                  cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NTHR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of pass 1: as many as the card holds at once (the runtime's
// count for this kernel, cluster size and shared memory, kept per
// instance), at most one an item; each is one part of dx. 0 on an error.
template <typename T, int MT>
int parts(int d, int f, int slots) {
  static int held[CLMAX + 1] = {};
  int CL, RR;
  split_d(d, CL, RR);
  if (!held[CL]) {
    auto strip = &moe_bwd_strip_kernel<T, MT>;
    const int smem = Lay<T, MT>::smem(CL);
    if (cudaFuncSetAttribute(strip,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(dim3(CL), CL, smem, 0, attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, strip, &cfg) != cudaSuccess ||
        n < 1)
      return 0;
    held[CL] = n;
  }
  return held[CL] < slots * ceil_div(f, FS) ? held[CL]
                                            : slots * ceil_div(f, FS);
}

template <typename T>
int parts_t(int Tn, int d, int f, int slots) {
  auto fn = Tn <= 8 ? &parts<T, 8> : Tn <= 16 ? &parts<T, 16>
                                              : &parts<T, 32>;
  return fn(d, f, slots);
}

template <typename T, int MT>
int launch(const T* x, const T* w1, const T* w3, const T* w2,
           const float* combine, int ldc, const unsigned char* active,
           const T* dy, float* Pc, float* Pdx, T* dx, T* dw1, T* dw3,
           T* dw2, float* dcomb, int Tn, int d, int f, int E, int slots,
           int NS, int Q, cudaStream_t s) {
  int CL, RR;
  split_d(d, CL, RR);
  const int nc = ceil_div(RR, RC);
  if (Q != parts<T, MT>(d, f, slots)) return (int)cudaErrorInvalidValue;
  auto strip = &moe_bwd_strip_kernel<T, MT>;
  const int smem = Lay<T, MT>::smem(CL);
  cudaError_t err = cudaFuncSetAttribute(
      strip, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(dim3(CL * Q), CL, smem, s, attr);
  err = cudaLaunchKernelEx(
      &cfg, strip, x, w1, w3, w2, dy, combine, ldc, active, Pc, Pdx, dw1,
      dw3, dw2, Tn, d, f, E, slots, RR, nc, NS);
  if (err != cudaSuccess) return (int)err;
  err = launch_pdl(&moe_bwd_reduce_kernel<T>,
                   dim3(ceil_div(Tn * d, 32) + ceil_div(Tn * E, RW * 32)),
                   dim3(RW * 32), 0, s, Pdx, Pc, active, dx, dcomb, Tn, d,
                   E, slots, NS, Q);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* w1, const void* w3, const void* w2,
             const void* combine, int ldc, const void* active,
             const void* dy, void* Pc, void* Pdx, void* dx, void* dw1,
             void* dw3, void* dw2, void* dcomb, int Tn, int d, int f, int E,
             int slots, int NS, int Q, cudaStream_t s) {
  // token-count bucket -> token rows held (T <= 32)
  auto fn = Tn <= 8 ? &launch<T, 8> : Tn <= 16 ? &launch<T, 16>
                                               : &launch<T, 32>;
  return fn(static_cast<const T*>(x), static_cast<const T*>(w1),
            static_cast<const T*>(w3), static_cast<const T*>(w2),
            static_cast<const float*>(combine), ldc,
            static_cast<const unsigned char*>(active),
            static_cast<const T*>(dy), static_cast<float*>(Pc),
            static_cast<float*>(Pdx), static_cast<T*>(dx),
            static_cast<T*>(dw1), static_cast<T*>(dw3), static_cast<T*>(dw2),
            static_cast<float*>(dcomb), Tn, d, f, E, slots, NS, Q, s);
}

}  // namespace

// The number of parts of dx (clusters of pass 1) a call at these sizes
// takes: the wrapper's scratch Pdx is (parts, T, d). 0 on bad sizes or an
// error of the runtime.
extern "C" int moe_ffn_bwd_parts(int Tn, int d, int f, int slots,
                                 int dtype) {
  if (Tn < 1 || Tn > 32 || d < 8 || f < 8 || slots < 1) return 0;
  if (dtype == kF32) return parts_t<float>(Tn, d, f, slots);
  if (dtype == kBF16) return parts_t<__nv_bfloat16>(Tn, d, f, slots);
  return 0;
}

// x, dy (T, d), w1 / w3 (E, d, f), w2 (E, f, d) in one dtype, 16-byte
// aligned, d and f multiples of 8; combine (T, E) f32 with row stride
// ldc; active (E,) bool; slots the forward's max_active (clamped to
// 1..E). ns = ceil(f / 32) strips, nparts = moe_ffn_bwd_parts(...).
// Scratch (f32): Pc (slots, ns, T), Pdx (nparts, T, d). Out: dx (T, d),
// dw1 / dw3 / dw2 as the weights, dcomb (T, E) f32.
extern "C" int moe_ffn_bwd(const void* x, const void* w1, const void* w3,
                           const void* w2, const void* combine, int ldc,
                           const void* active, const void* dy, void* Pc,
                           void* Pdx, void* dx, void* dw1, void* dw3,
                           void* dw2, void* dcomb, int Tn, int d, int f,
                           int E, int slots, int ns, int nparts, int dtype,
                           void* stream) {
  if (Tn < 1 || Tn > 32 || d < 8 || f < 8 || d % 8 || f % 8 || E < 1 ||
      E > 65535 || slots < 1 || slots > E || ns != ceil_div(f, FS) ||
      nparts < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_t<float>(x, w1, w3, w2, combine, ldc, active, dy, Pc, Pdx,
                           dx, dw1, dw3, dw2, dcomb, Tn, d, f, E, slots, ns,
                           nparts, s);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(x, w1, w3, w2, combine, ldc, active, dy,
                                   Pc, Pdx, dx, dw1, dw3, dw2, dcomb, Tn, d,
                                   f, E, slots, ns, nparts, s);
  return (int)cudaErrorInvalidValue;
}
