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
// 3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores): T <= 32 tokens
// use each weight element, so like the forward it is bound by bytes. It
// must read the selected experts' W1, W3 and W2 and write dW1, dW3 and
// dW2 for all E experts (the gradient has the weights' full shape): at
// granite-moe's decode shape (T 8, d 1024, f 512, 28 of 32 experts) 176
// MB read and 201 MB written in f32, 0.113 ms. Its eight products of
// 2 T d f operations an expert (~1.9 GFLOP there, 8.6 at T 32 with all
// 32 experts) are below the f32 FMA rate's 0.13 ms.
//
// Design: three launches, no float atomics (every output element is one
// block's, every sum runs in a fixed order, so two calls give the same
// bits), no host sync (each block finds its expert from `active`):
//   1. act:    a block per (32 f columns, slot) walks all of d, streaming
//              its W1 and W3 columns, its W2 rows and the x and dy slices
//              through a 4-stage cp.async ring, and recomputes A and B
//              and forms G in registers (3 products): a lane per column,
//              each warp a quarter of a stage's rows for every token, so
//              each weight element is read once, and the 4 warps' sums
//              added in order at the end. It writes dA, dB
//              and c H once to an f32 scratch S (slots, 3, T, f), and
//              the block's part of dcombine (a butterfly sum over its 32
//              columns) to Pc (slots, f / 32, T). Walking all of d in
//              one block keeps A, B and G whole, so no partial sums of
//              them go through device memory.
//   2. grad:   a block per (64 f columns, 128 rows of d, expert z in the
//              order "slots first, then the other experts"). A slot's
//              block writes its dW1 / dW3 tile (128 x 64) and dW2 tile
//              (64 x 128) from x, dy and S in registers (8 FMAs per
//              16-byte read of shared memory), then streams W1[e] and
//              W3[e] a second time for its rows to form its part of dx,
//              dA W1^T + dB W3^T over its 64 columns, into Pdx (slots,
//              f / 64, T, d). That second read of W1 and W3 (2 d f bytes
//              an expert, +67 % of the read bytes, +31 % of all bytes in
//              f32 at granite's shape) is the price of writing each
//              weight gradient once without holding an expert's columns.
//              Any other expert's block writes its zero tiles, so the
//              whole gradient is written by the kernel and nothing by a
//              separate fill.
//   3. reduce: dx = sum over slots, then f blocks, of Pdx (8 warps a
//              block of 32 elements, each summing an eighth of the parts,
//              then the eighths in order), and each slot column of
//              dcombine the sum of its Pc parts in f order; the other
//              columns of dcombine 0.
// Passes 2 and 3 start early by programmatic dependent launch: pass 2
// finds its expert, fills its weight ring and its x slice and
// writes zero tiles while pass 1 runs, and waits for it only to read S.
// All products are f32 FMAs on the CUDA cores (bf16 operands widened on
// read, exactly): at T <= 32 the bytes bound every dtype, and bf16's
// operations take 0.03 ms at granite's decode shape. In bf16, c H is
// rounded to bf16 before it multiplies dy, as the forward rounds c H
// before its down product; dcombine takes H in f32, since the rounding
// is of c H and its derivative in c is taken to be H, as the JAX package
// treats its own roundings.
#include "common.cuh"

namespace {

constexpr int NTHR = 128;   // 4 warps
constexpr int STAGES = 4;   // pass 1's cp.async ring depth
constexpr int GSTAGES = 3;  // pass 2's: three blocks an SM at T 32 in f32
constexpr int BN1 = 32;     // pass 1: f columns a block (one a lane)
constexpr int BN2 = 64;     // pass 2: f columns a block
constexpr int KR2 = 128;    // pass 2: rows of d a block (one a thread for dW2)
constexpr int R2 = 16;      // pass 2: W1 / W3 rows a ring stage
static_assert(KR2 == NTHR, "pass 2 gives each thread one dW2 column");

template <typename T>
struct Vec {
  static constexpr int N = 16 / (int)sizeof(T);   // elements in 16 bytes
};

// 16 bytes of T at p (16-byte aligned) widened to f32
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[Vec<T>::N]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// The z-th expert in the order "active experts in index order, then the
// others in index order" (.x, -1 past E) and the number of active
// experts (.y), found by warp 0 and handed to the whole block. For
// z < the active count this is the forward's slot z.
__device__ __forceinline__ int2 expert_in_order(
    const unsigned char* __restrict__ active, int E, int z) {
  __shared__ int2 res;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n_act = 0;
    for (int c0 = 0; c0 < E; c0 += 32) {
      const int i = c0 + lane;
      n_act += __popc(__ballot_sync(0xffffffffu, i < E && active[i] != 0));
    }
    const bool want = z < n_act;   // look among the active experts
    const int rank = want ? z : z - n_act;
    int seen = 0, e = -1;
    for (int c0 = 0; c0 < E; c0 += 32) {
      const int i = c0 + lane;
      const unsigned bits = __ballot_sync(
          0xffffffffu, i < E && (active[i] != 0) == want);
      const int n = __popc(bits);
      if (e < 0 && rank < seen + n) {
        unsigned b = bits;
        for (int r = rank - seen; r > 0; --r) b &= b - 1;  // drop lower bits
        e = c0 + __ffs(b) - 1;
      }
      seen += n;
    }
    if (lane == 0) res = make_int2(e, n_act);
  }
  __syncthreads();
  return res;
}

// ---- pass 1: A, B and G of one (32 f columns, slot) over all of d ------

template <typename T, int MT>
struct Act {
  static constexpr int V = Vec<T>::N;
  static constexpr int R = 4 * V;      // d rows a stage, 16 bytes a warp
                                       // (64 B of a W2 row)
  static constexpr int WP = BN1 + V;   // W1 / W3 tile (R x BN1) pitch
  static constexpr int XP = R + V;     // W2 tile (BN1 x R), x / dy (MT x R)
  static constexpr int SZ = 2 * R * WP + BN1 * XP + 2 * MT * XP;  // a stage
  static constexpr int RING = STAGES * SZ * (int)sizeof(T);
  // bf16: each warp's x / dy chunk of a stage widened to f32, (2, MT, V)
  static constexpr int XF = sizeof(T) == 4 ? 0 : 4 * 2 * MT * V * 4;
  static constexpr int RED = 4 * 3 * MT * 32 * 4;  // the warps' partial sums
  static constexpr int SMEM = RING + XF > RED ? RING + XF : RED;
};

template <typename T, int MT>
__global__ void __launch_bounds__(NTHR)
moe_bwd_act_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ w3, const T* __restrict__ w2,
                   const T* __restrict__ dy,
                   const float* __restrict__ combine, int ldc,
                   const unsigned char* __restrict__ active,
                   float* __restrict__ S, float* __restrict__ Pc, int Tn,
                   int d, int f, int E, int NT1) {
  using L = Act<T, MT>;
  constexpr int V = L::V, R = L::R, WP = L::WP, XP = L::XP;
  pdl_launch_dependents();  // pass 2 may start its weight stream
  const int ft = blockIdx.x, s = blockIdx.y, n0 = ft * BN1;
  const int2 se = expert_in_order(active, E, s);
  if (s >= se.y) return;  // an unused slot: no bytes read or written
  const int e = se.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const T* W1 = w1 + (size_t)e * d * f;
  const T* W3 = w3 + (size_t)e * d * f;
  const T* W2 = w2 + (size_t)e * f * d;
  // stage i: rows [kb, kb + R) of d of W1 and W3 (columns n0 .. n0 + 32),
  // of W2 (its rows n0 .. n0 + 32 are f), and of x and dy (rows t);
  // anything past d, f or T is zero-filled
  auto load = [&](int i) {
    T* b = ring + (i % STAGES) * L::SZ;
    const int kb = i * R;
    constexpr int CW = BN1 / V;   // chunks of a W1 / W3 tile row
    for (int c = threadIdx.x; c < R * CW; c += NTHR) {
      const int r = c / CW, q = c % CW, k = kb + r, n = n0 + q * V;
      const bool ok = k < d && n < f;
      const size_t off = ok ? (size_t)k * f + n : 0;
      cp_async16(b + r * WP + q * V, W1 + off, ok);
      cp_async16(b + (R + r) * WP + q * V, W3 + off, ok);
    }
    constexpr int CR = R / V;     // chunks of a W2 / x / dy tile row
    T* b2 = b + 2 * R * WP;
    for (int c = threadIdx.x; c < BN1 * CR; c += NTHR) {
      const int r = c / CR, q = c % CR, n = n0 + r, k = kb + q * V;
      const bool ok = n < f && k < d;
      cp_async16(b2 + r * XP + q * V, W2 + (ok ? (size_t)n * d + k : 0),
                 ok);
    }
    T* bx = b2 + BN1 * XP;
    for (int c = threadIdx.x; c < MT * CR; c += NTHR) {
      const int t = c / CR, q = c % CR, k = kb + q * V;
      const bool ok = t < Tn && k < d;
      const size_t off = ok ? (size_t)t * d + k : 0;
      cp_async16(bx + t * XP + q * V, x + off, ok);
      cp_async16(bx + (MT + t) * XP + q * V, dy + off, ok);
    }
  };
  // lane = the f column; warp w takes rows w V .. w V + V - 1 of each
  // stage for every token, so each weight element is read by one thread
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, kk = w * V;
  float acc_a[MT] = {}, acc_b[MT] = {}, acc_g[MT] = {};
  float* xf = reinterpret_cast<float*>(smem_raw + L::RING) + w * 2 * MT * V;
  const int nst = (d + R - 1) / R;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    if (i + STAGES - 1 < nst) load(i + STAGES - 1);
    cp_async_commit();
    const T* b1 = ring + (i % STAGES) * L::SZ;
    const T* b3 = b1 + R * WP;
    const T* b2 = b1 + 2 * R * WP;
    const T* bx = b2 + BN1 * XP;   // x rows, then dy rows
    float g2[V], a1[V], a3[V];
    load_vec(b2 + lane * XP + kk, g2);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a1[j] = to_f32(b1[(kk + j) * WP + lane]);
      a3[j] = to_f32(b3[(kk + j) * WP + lane]);
    }
    if constexpr (sizeof(T) == 2) {
      // widen the warp's x / dy chunk once (a row of V a lane), rather
      // than in every lane at every use
      for (int r = lane; r < 2 * MT; r += 32) {
        float v[V];
        load_vec(bx + r * XP + kk, v);
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(xf + r * V + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      float xv[V], dv[V];   // broadcasts
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 p = *reinterpret_cast<const float4*>(xf + t * V + j);
          const float4 q =
              *reinterpret_cast<const float4*>(xf + (MT + t) * V + j);
          xv[j] = p.x; xv[j + 1] = p.y; xv[j + 2] = p.z; xv[j + 3] = p.w;
          dv[j] = q.x; dv[j + 1] = q.y; dv[j + 2] = q.z; dv[j + 3] = q.w;
        }
      } else {
        load_vec(bx + t * XP + kk, xv);
        load_vec(bx + (MT + t) * XP + kk, dv);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc_a[t] = fmaf(xv[j], a1[j], acc_a[t]);
        acc_b[t] = fmaf(xv[j], a3[j], acc_b[t]);
        acc_g[t] = fmaf(dv[j], g2[j], acc_g[t]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' partial sums
  float* red = reinterpret_cast<float*>(smem_raw);  // (warp, 3, MT, lane)
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    red[((w * 3 + 0) * MT + t) * 32 + lane] = acc_a[t];
    red[((w * 3 + 1) * MT + t) * 32 + lane] = acc_b[t];
    red[((w * 3 + 2) * MT + t) * 32 + lane] = acc_g[t];
  }
  __syncthreads();
  // warp w finishes tokens w * TW .., summing the 4 warps' parts in order
  constexpr int TW = MT / 4;
  const int n = n0 + lane;
  float* Se = S + (size_t)s * 3 * Tn * f;
#pragma unroll
  for (int u = 0; u < TW; ++u) {
    const int t = w * TW + u;
    float gh = 0.f;
    if (t < Tn) {  // warp-uniform
      float a = 0.f, b = 0.f, g = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a += red[((q * 3 + 0) * MT + t) * 32 + lane];
        b += red[((q * 3 + 1) * MT + t) * 32 + lane];
        g += red[((q * 3 + 2) * MT + t) * 32 + lane];
      }
      const float cm = combine[(size_t)t * ldc + e];
      const float sg = 1.f / (1.f + expf(-a));
      const float si = a * sg;
      const float h = si * b;
      const float gc = cm * g;
      // c H as the forward's down product takes it (bf16: rounded)
      const float ch = to_f32(from_f32<T>(cm * h));
      if (n < f) {
        Se[(size_t)t * f + n] = gc * b * sg * (1.f + a * (1.f - sg));
        Se[(size_t)(Tn + t) * f + n] = gc * si;
        Se[(size_t)(2 * Tn + t) * f + n] = ch;
        gh = g * h;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      gh += __shfl_xor_sync(0xffffffffu, gh, o);
    if (lane == 0 && t < Tn) Pc[((size_t)s * NT1 + ft) * Tn + t] = gh;
  }
}

// ---- pass 2: the weight gradients' tiles and dx's parts ---------------

template <typename T, int MT>
struct Grad {
  static constexpr int V = Vec<T>::N;
  static constexpr int WP = BN2 + V;    // W1 / W3 stage (R2 x BN2) pitch
  static constexpr int RING = GSTAGES * 2 * R2 * WP * (int)sizeof(T);
  static constexpr int XP = KR2 + 4;    // f32 x slice (MT x KR2)
  static constexpr int AP = BN2 + 4;    // f32 dA / dB / c H (MT x BN2)
  static constexpr int SMEM = RING + (MT * XP + 3 * MT * AP) * 4;
};

template <typename T, int MT>
__global__ void __launch_bounds__(NTHR)
moe_bwd_grad_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ w3, const T* __restrict__ dy,
                    const unsigned char* __restrict__ active,
                    const float* __restrict__ S, float* __restrict__ Pdx,
                    T* __restrict__ dw1, T* __restrict__ dw3,
                    T* __restrict__ dw2, int Tn, int d, int f, int E,
                    int slots, int NT2) {
  using L = Grad<T, MT>;
  constexpr int V = L::V, WP = L::WP, XP = L::XP, AP = L::AP;
  pdl_launch_dependents();
  const int ft = blockIdx.x, z = blockIdx.z;
  const int n0 = ft * BN2, k0 = blockIdx.y * KR2, kend = min(k0 + KR2, d);
  const int2 oe = expert_in_order(active, E, z);
  const int e = oe.x;
  T* D1 = dw1 + (size_t)e * d * f;
  T* D3 = dw3 + (size_t)e * d * f;
  T* D2 = dw2 + (size_t)e * f * d;
  if (z >= min(oe.y, slots)) {
    // an expert outside the slots: its tiles of the gradient are zero
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    constexpr int C1 = BN2 / V, C2 = KR2 / V;
    for (int c = threadIdx.x; c < KR2 * C1; c += NTHR) {
      const int k = k0 + c / C1, n = n0 + (c % C1) * V;
      if (k < kend && n < f) {
        *reinterpret_cast<uint4*>(D1 + (size_t)k * f + n) = zero;
        *reinterpret_cast<uint4*>(D3 + (size_t)k * f + n) = zero;
      }
    }
    for (int c = threadIdx.x; c < BN2 * C2; c += NTHR) {
      const int n = n0 + c / C2, k = k0 + (c % C2) * V;
      if (n < f && k < kend)
        *reinterpret_cast<uint4*>(D2 + (size_t)n * d + k) = zero;
    }
    pdl_wait();  // this grid ends only after pass 1 has
    return;
  }
  const int s = z;  // slot z runs expert e
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + L::RING);
  float* da = xs + MT * XP;
  float* db = da + MT * AP;
  float* ch = db + MT * AP;
  const T* W1 = w1 + (size_t)e * d * f;
  const T* W3 = w3 + (size_t)e * d * f;
  // stage i: rows k0 + i R2 .. of W1 and W3, columns n0 .. n0 + 64
  auto load = [&](int i) {
    T* b = ring + (i % GSTAGES) * 2 * R2 * WP;
    constexpr int CW = BN2 / V;
    for (int c = threadIdx.x; c < R2 * CW; c += NTHR) {
      const int r = c / CW, q = c % CW, k = k0 + i * R2 + r, n = n0 + q * V;
      const bool ok = k < kend && n < f;
      const size_t off = ok ? (size_t)k * f + n : 0;
      cp_async16(b + r * WP + q * V, W1 + off, ok);
      cp_async16(b + (R2 + r) * WP + q * V, W3 + off, ok);
    }
  };
  const int nst = (kend - k0 + R2 - 1) / R2;
#pragma unroll
  for (int i = 0; i < GSTAGES - 1; ++i) {
    if (i < nst) load(i);
    cp_async_commit();
  }
  // x rows [k0, k0 + 128) in f32 (token-major); zero past T or d
  {
    constexpr int C = KR2 / V;
    for (int c = threadIdx.x; c < MT * C; c += NTHR) {
      const int t = c / C, kk = (c % C) * V, k = k0 + kk;
      float xv[V] = {};
      if (t < Tn && k < kend) load_vec(x + (size_t)t * d + k, xv);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        *reinterpret_cast<float4*>(xs + t * XP + kk + j) =
            make_float4(xv[j], xv[j + 1], xv[j + 2], xv[j + 3]);
      }
    }
  }
  pdl_wait();  // pass 1 has finished and S is visible
  {
    const float* Ss = S + (size_t)s * 3 * Tn * f;
    for (int c = threadIdx.x; c < MT * BN2; c += NTHR) {
      const int t = c / BN2, col = c % BN2, n = n0 + col;
      const bool ok = t < Tn && n < f;
      da[t * AP + col] = ok ? Ss[(size_t)t * f + n] : 0.f;
      db[t * AP + col] = ok ? Ss[(size_t)(Tn + t) * f + n] : 0.f;
      ch[t * AP + col] = ok ? Ss[(size_t)(2 * Tn + t) * f + n] : 0.f;
    }
  }
  __syncthreads();
  // dW1, dW3: column c of the tile, rows in quads k0 + 4 (rg + 2 j) ..
  {
    const int c = threadIdx.x % BN2, rg = threadIdx.x / BN2;  // warp-uniform
    float ra[MT], rb[MT];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      ra[t] = da[t * AP + c];
      rb[t] = db[t * AP + c];
    }
    const int n = n0 + c;
    for (int kk = 4 * rg; kk < kend - k0; kk += 8) {
      float a1[4] = {}, a3[4] = {};
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + t * XP + kk);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a1[r] = fmaf(xr[r], ra[t], a1[r]);
          a3[r] = fmaf(xr[r], rb[t], a3[r]);
        }
      }
      if (n < f) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const size_t off = (size_t)(k0 + kk + r) * f + n;
          D1[off] = from_f32<T>(a1[r]);
          D3[off] = from_f32<T>(a3[r]);
        }
      }
    }
  }
  // dW2: column k0 + threadIdx.x of the tile, rows n0 .. n0 + 64 in quads
  {
    const int kk = threadIdx.x, k = k0 + kk;
    if (k < kend) {
      float rd[MT];   // dy's column k, read once from device memory
#pragma unroll
      for (int t = 0; t < MT; ++t)
        rd[t] = t < Tn ? to_f32(dy[(size_t)t * d + k]) : 0.f;
      for (int nn = 0; nn < BN2; nn += 4) {
        float acc[4] = {};
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const float4 cv = *reinterpret_cast<const float4*>(ch + t * AP + nn);
          acc[0] = fmaf(cv.x, rd[t], acc[0]);
          acc[1] = fmaf(cv.y, rd[t], acc[1]);
          acc[2] = fmaf(cv.z, rd[t], acc[2]);
          acc[3] = fmaf(cv.w, rd[t], acc[3]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (n0 + nn + r < f)
            D2[(size_t)(n0 + nn + r) * d + k] = from_f32<T>(acc[r]);
      }
    }
  }
  // dx's part: row kb + kl of a stage for tokens tg, tg + 8, ..
  constexpr int TG = MT / 8;
  const int kl = threadIdx.x % R2, tg = threadIdx.x / R2;
  float* out = Pdx + (size_t)(s * NT2 + ft) * Tn * d;
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    if (i + GSTAGES - 1 < nst) load(i + GSTAGES - 1);
    cp_async_commit();
    const T* b1 = ring + (i % GSTAGES) * 2 * R2 * WP + kl * WP;
    const T* b3 = b1 + R2 * WP;
    float acc[TG] = {};
#pragma unroll 2
    for (int c = 0; c < BN2; c += V) {
      float v1[V], v3[V];
      load_vec(b1 + c, v1);
      load_vec(b3 + c, v3);
#pragma unroll
      for (int u = 0; u < TG; ++u) {
        const int t = tg + 8 * u;
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 pa = *reinterpret_cast<const float4*>(da + t * AP + c + j);
          const float4 pb = *reinterpret_cast<const float4*>(db + t * AP + c + j);
          acc[u] = fmaf(pa.x, v1[j], acc[u]);
          acc[u] = fmaf(pa.y, v1[j + 1], acc[u]);
          acc[u] = fmaf(pa.z, v1[j + 2], acc[u]);
          acc[u] = fmaf(pa.w, v1[j + 3], acc[u]);
          acc[u] = fmaf(pb.x, v3[j], acc[u]);
          acc[u] = fmaf(pb.y, v3[j + 1], acc[u]);
          acc[u] = fmaf(pb.z, v3[j + 2], acc[u]);
          acc[u] = fmaf(pb.w, v3[j + 3], acc[u]);
        }
      }
    }
    const int k = k0 + i * R2 + kl;
#pragma unroll
    for (int u = 0; u < TG; ++u) {
      const int t = tg + 8 * u;
      if (t < Tn && k < kend) out[(size_t)t * d + k] = acc[u];
    }
  }
  cp_async_wait<0>();
}

// ---- pass 3: dx and dcombine -------------------------------------------

constexpr int RW = 8;   // warps of a reduce block

// dx: a block per 32 elements (one a lane); warp w sums the parts q in
// [w Q / RW, (w + 1) Q / RW) of the Q = slots x f blocks, slot-major,
// and warp 0 the RW warp sums in order. dcombine: the blocks past those,
// a thread per (t, e).
template <typename T>
__global__ void __launch_bounds__(RW * 32)
moe_bwd_reduce_kernel(const float* __restrict__ Pdx,
                      const float* __restrict__ Pc,
                      const unsigned char* __restrict__ active,
                      T* __restrict__ dx, float* __restrict__ dcomb, int Tn,
                      int d, int E, int slots, int NT1, int NT2) {
  __shared__ float part[RW][32];
  const int nv = min(slots, expert_in_order(active, E, 0).y);
  pdl_wait();  // pass 2 (and so pass 1) has finished
  const int n = Tn * d, nbx = (n + 31) / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if ((int)blockIdx.x < nbx) {  // block-uniform
    const int i = blockIdx.x * 32 + lane, Q = nv * NT2;
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
      for (int q = 0; q < NT1; ++q)
        acc += Pc[((size_t)rank * NT1 + q) * Tn + t];
    dcomb[(size_t)t * E + e] = acc;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int MT>
int launch(const T* x, const T* w1, const T* w3, const T* w2,
           const float* combine, int ldc, const unsigned char* active,
           const T* dy, float* S, float* Pc, float* Pdx, T* dx, T* dw1,
           T* dw3, T* dw2, float* dcomb, int Tn, int d, int f, int E,
           int slots, cudaStream_t s) {
  const int NT1 = ceil_div(f, BN1), NT2 = ceil_div(f, BN2);
  auto act = &moe_bwd_act_kernel<T, MT>;
  auto grad = &moe_bwd_grad_kernel<T, MT>;
  constexpr int smem1 = Act<T, MT>::SMEM, smem2 = Grad<T, MT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      act, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      grad, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  act<<<dim3(NT1, slots), NTHR, smem1, s>>>(x, w1, w3, w2, dy, combine, ldc,
                                            active, S, Pc, Tn, d, f, E, NT1);
  err = launch_pdl(grad, dim3(NT2, ceil_div(d, KR2), E), dim3(NTHR), smem2,
                   s, x, w1, w3, dy, active, S, Pdx, dw1, dw3, dw2, Tn, d, f,
                   E, slots, NT2);
  if (err != cudaSuccess) return (int)err;
  err = launch_pdl(&moe_bwd_reduce_kernel<T>,
                   dim3(ceil_div(Tn * d, 32) + ceil_div(Tn * E, RW * 32)),
                   dim3(RW * 32), 0, s, Pdx, Pc, active, dx, dcomb, Tn, d,
                   E, slots, NT1, NT2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* w1, const void* w3, const void* w2,
             const void* combine, int ldc, const void* active,
             const void* dy, void* S, void* Pc, void* Pdx, void* dx,
             void* dw1, void* dw3, void* dw2, void* dcomb, int Tn, int d,
             int f, int E, int slots, cudaStream_t s) {
  // token-count bucket -> token rows held (T <= 32)
  auto fn = Tn <= 8 ? &launch<T, 8> : Tn <= 16 ? &launch<T, 16>
                                               : &launch<T, 32>;
  return fn(static_cast<const T*>(x), static_cast<const T*>(w1),
            static_cast<const T*>(w3), static_cast<const T*>(w2),
            static_cast<const float*>(combine), ldc,
            static_cast<const unsigned char*>(active),
            static_cast<const T*>(dy), static_cast<float*>(S),
            static_cast<float*>(Pc), static_cast<float*>(Pdx),
            static_cast<T*>(dx), static_cast<T*>(dw1), static_cast<T*>(dw3),
            static_cast<T*>(dw2), static_cast<float*>(dcomb), Tn, d, f, E,
            slots, s);
}

}  // namespace

// x, dy (T, d), w1 / w3 (E, d, f), w2 (E, f, d) in one dtype, 16-byte
// aligned, d and f multiples of 8; combine (T, E) f32 with row stride
// ldc; active (E,) bool; slots the forward's max_active (clamped to
// 1..E). Scratch (f32): S (slots, 3, T, f), Pc (slots, nt1, T), Pdx
// (slots, nt2, T, d) with nt1 = ceil(f / 32), nt2 = ceil(f / 64). Out:
// dx (T, d), dw1 / dw3 / dw2 as the weights, dcomb (T, E) f32.
extern "C" int moe_ffn_bwd(const void* x, const void* w1, const void* w3,
                           const void* w2, const void* combine, int ldc,
                           const void* active, const void* dy, void* S,
                           void* Pc, void* Pdx, void* dx, void* dw1,
                           void* dw3, void* dw2, void* dcomb, int Tn, int d,
                           int f, int E, int slots, int nt1, int nt2,
                           int dtype, void* stream) {
  if (Tn < 1 || Tn > 32 || d < 8 || f < 8 || d % 8 || f % 8 || E < 1 ||
      E > 65535 || slots < 1 || slots > E || nt1 != ceil_div(f, BN1) ||
      nt2 != ceil_div(f, BN2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_t<float>(x, w1, w3, w2, combine, ldc, active, dy, S, Pc,
                           Pdx, dx, dw1, dw3, dw2, dcomb, Tn, d, f, E, slots,
                           s);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(x, w1, w3, w2, combine, ldc, active, dy,
                                   S, Pc, Pdx, dx, dw1, dw3, dw2, dcomb, Tn,
                                   d, f, E, slots, s);
  return (int)cudaErrorInvalidValue;
}
