// moe_ffn — the XShare masked expert FFN of a decode step.
//
// Replaces the Pallas kernel `moe_ffn` (body `_kernel`) of
// src/repro/kernels/moe_ffn.py:77:
//     y = sum over e in active of combine[:, e] * FFN_e(x)
// for T <= 32 tokens, over the first max_active active experts in index
// order (the slots); only their weights are read.
//
// What bounds it on the H100: at decode sizes the products are
// (T x d) x (d x f) with T <= 32, so every weight element is used by T
// tokens only — about 16 operations per byte in bf16 at T = 8, far under
// the ~295 at which the tensor cores become the limit. It is bound by the
// bytes of the selected experts' weights, 3 * d * f * 2 B each (3 MB for
// granite-moe, d 1024, f 512), so its time should scale with the number
// of selected experts. That is XShare's whole saving.
//
// Design: three launches, no other device op, no float atomics.
//   1. up:     a block per (f tile of 64 columns, split of d, slot); the
//              split's partial sums of x W1 and x W3 go to an f32 scratch
//              P (slots, KS, 2, T, f).
//   2. down:   a block per (d tile of 64 columns, split of f, slot). It
//              first forms H = combine[:, e] * silu(Σ_splits x W1) *
//              (Σ_splits x W3) for its f rows from P (splits summed in
//              order), then its partial H W2 goes to Pd (slots, FS, T, d).
//   3. reduce: y = Σ over valid slots, then splits, of Pd, in that fixed
//              order, so the same inputs give the same bits run after run
//              and greedy tokens repeat.
// Each block finds its slot's expert itself: warp 0 ballots over `active`
// and takes the slot-th set bit; a slot at or past the active count
// returns at once, so unused slots cost one ballot and no weight bytes.
// Splitting d (up) and f (down) across blocks gives ~450–900 blocks at
// granite's shape, several resident per SM, where one block per
// (slot, tile) would walk all of d serially.
// Weights stream through a 4-stage cp.async ring in shared memory: 16-byte
// copies, neighbouring threads on neighbouring addresses of a W row,
// 3 stages (24 KB in bf16) in flight per block. Rows are padded by 16
// bytes so the fragment loads hit no bank twice.
// bf16: the products run on the tensor cores, mma.sync m16n8k16 with f32
// accumulation, the weight tile on the 16-row side (loaded k-major by
// ldmatrix.trans) and 8 tokens on the 8-wide side (T <= 32: <= 4 n
// tiles). x enters exactly; H is rounded to bf16 for the down product
// (a relative 2^-9 per element, far under the 2e-2 tolerance).
// f32 (not on the main path): the same streaming, the products as f32
// FMAs on the CUDA cores, each thread one column and half the tokens.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NTHR = 128;   // 4 warps; in bf16 each owns 16 of the columns
constexpr int BN = 64;      // output columns per block
// weight rows per pipeline stage: 8 KB of bf16 weights a stage for the
// up pass's two matrices and the down pass's one
template <int NM>
constexpr int KST = 64 / NM;
constexpr int STAGES = 4;   // cp.async ring depth

template <typename T>
struct Lay {
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16 B
  static constexpr int PAD = VEC;                  // row padding
  static constexpr int WP = BN + PAD;              // weight tile pitch
};

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

// Slot s's expert (the s-th set entry of active, or -1) and the number
// of active experts, found by warp 0 and handed to the whole block.
__device__ __forceinline__ int2 slot_expert(
    const unsigned char* __restrict__ active, int E, int s) {
  __shared__ int2 res;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int seen = 0, e = -1;
    for (int c0 = 0; c0 < E; c0 += 32) {
      const int i = c0 + lane;
      const unsigned bits =
          __ballot_sync(0xffffffffu, i < E && active[i] != 0);
      const int n = __popc(bits);
      if (e < 0 && s < seen + n) {
        unsigned b = bits;
        for (int r = s - seen; r > 0; --r) b &= b - 1;  // drop lower bits
        e = c0 + __ffs(b) - 1;
      }
      seen += n;
    }
    if (lane == 0) res = make_int2(e, seen);
  }
  __syncthreads();
  return res;
}

// One stage: rows [kb, kb + R), R = KST<NM>, of columns [n0, n0 + BN)
// of each of the NM matrices W[m] (K x N, row-major) into dst; rows >=
// kend and columns >= N are zero-filled.
template <typename T, int NM>
__device__ __forceinline__ void load_stage(T* dst, const T* const (&W)[NM],
                                           int N, int kb, int kend,
                                           int n0) {
  constexpr int R = KST<NM>;
  constexpr int CPR = BN / Lay<T>::VEC;  // 16-byte chunks per tile row
  constexpr int CH = R * CPR;  // per matrix
  static_assert(CH % NTHR == 0, "chunks per stage");
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int it = 0; it < CH / NTHR; ++it) {
      const int c = threadIdx.x + it * NTHR;
      const int r = c / CPR, q = c % CPR;
      const int k = kb + r, n = n0 + q * Lay<T>::VEC;
      const bool ok = k < kend && n < N;
      cp_async16(dst + (m * R + r) * Lay<T>::WP + q * Lay<T>::VEC,
                 ok ? W[m] + (size_t)k * N + n : W[m], ok);
    }
}

// acc[m] += operand (MT x KST<NM> slice at column kk0, pitch bp) ·
// stage m.
// bf16: acc[m][j * 4 + r] is mma fragment r of token tile j for this
// warp's 16 columns. f32: acc[m][i] is token g * MT / 2 + i of column
// threadIdx.x % BN, g = threadIdx.x / BN.
template <typename T, int MT, int NM>
__device__ __forceinline__ void compute_stage(const T* ws, const T* bop,
                                              int bp, int kk0,
                                              float (&acc)[NM][MT / 2]) {
  constexpr int R = KST<NM>;
  if constexpr (is_bf16<T>) {
    const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int ks = 0; ks < R; ks += 16) {
      uint32_t a[NM][4];
#pragma unroll
      for (int m = 0; m < NM; ++m)  // stored k-major: A = Wᵀ by .trans
        ldmatrix_x4_trans(a[m],
                          x4_addr<false>(ws + m * R * Lay<T>::WP,
                                         Lay<T>::WP, ks, m0));
#pragma unroll
      for (int j = 0; j < MT / 8; ++j) {
        const T* b = bop + (j * 8 + g) * bp + kk0 + ks + 2 * q;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 8);
#pragma unroll
        for (int m = 0; m < NM; ++m) mma_bf16(&acc[m][j * 4], a[m], b0, b1);
      }
    }
  } else {
    constexpr int H = MT / 2;
    const int c = threadIdx.x % BN, t0 = (threadIdx.x / BN) * H;
#pragma unroll 4
    for (int k = 0; k < R; ++k) {
      float w[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) w[m] = ws[(m * R + k) * Lay<T>::WP + c];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float xv = bop[(t0 + i) * bp + kk0 + k];
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[m][i] = fmaf(xv, w[m], acc[m][i]);
      }
    }
  }
}

// fn(m, token, column in tile, value) for each accumulator of the thread
template <typename T, int MT, int NM, typename Fn>
__device__ __forceinline__ void for_each_out(float (&acc)[NM][MT / 2],
                                             Fn fn) {
  if constexpr (is_bf16<T>) {
    const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int j = 0; j < MT / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          fn(m, j * 8 + 2 * q + (r & 1), m0 + g + (r >> 1) * 8,
             acc[m][j * 4 + r]);
  } else {
    constexpr int H = MT / 2;
    const int c = threadIdx.x % BN, t0 = (threadIdx.x / BN) * H;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int i = 0; i < H; ++i) fn(m, t0 + i, c, acc[m][i]);
  }
}

// Stream rows [k0, kend) of the NM matrices through the ring and multiply
// by the operand that fill() writes to shared memory meanwhile.
template <typename T, int MT, int NM, typename Fill>
__device__ __forceinline__ void stream_product(const T* const (&W)[NM],
                                               int N, int k0, int kend,
                                               int n0, T* ws, const T* bop,
                                               int bp, Fill fill,
                                               float (&acc)[NM][MT / 2]) {
  constexpr int R = KST<NM>;
  constexpr int SZ = NM * R * Lay<T>::WP;  // elements per stage
  const int nst = (kend - k0 + R - 1) / R;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) load_stage<T, NM>(ws + i * SZ, W, N, k0 + i * R, kend, n0);
    cp_async_commit();
  }
  fill();
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    const int nx = i + STAGES - 1;
    if (nx < nst)
      load_stage<T, NM>(ws + (nx % STAGES) * SZ, W, N, k0 + nx * R, kend,
                        n0);
    cp_async_commit();
    compute_stage<T, MT, NM>(ws + (i % STAGES) * SZ, bop, bp, i * R, acc);
  }
  cp_async_wait<0>();
}

template <typename T, int MT>
__global__ void __launch_bounds__(NTHR)
moe_up_kernel(const T* __restrict__ x, const T* __restrict__ w1,
              const T* __restrict__ w3,
              const unsigned char* __restrict__ active,
              float* __restrict__ P, int Tn, int d, int f, int E, int KS,
              int kr) {
  pdl_launch_dependents();  // the down pass may start its weight stream
  const int s = blockIdx.z, ks = blockIdx.y, n0 = blockIdx.x * BN;
  const int2 se = slot_expert(active, E, s);
  if (s >= se.y) return;  // an unused slot: no bytes read or written
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* xs = ws + STAGES * 2 * KST<2> * Lay<T>::WP;
  const int bp = kr + Lay<T>::PAD;
  const int k0 = ks * kr, kend = min(k0 + kr, d);
  const T* const W[2] = {w1 + (size_t)se.x * d * f,
                         w3 + (size_t)se.x * d * f};
  auto fill = [&]() {  // x[:, k0 : k0 + kr], rows >= Tn zero
    constexpr int V = Lay<T>::VEC;
    const int cpr = kr / V;
    for (int c = threadIdx.x; c < MT * cpr; c += NTHR) {
      const int t = c / cpr, kk = (c % cpr) * V, k = k0 + kk;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < Tn && k < d)
        v = *reinterpret_cast<const uint4*>(x + (size_t)t * d + k);
      *reinterpret_cast<uint4*>(xs + t * bp + kk) = v;
    }
  };
  float acc[2][MT / 2] = {};
  stream_product<T, MT, 2>(W, f, k0, kend, n0, ws, xs, bp, fill, acc);
  float* out = P + (size_t)(s * KS + ks) * 2 * Tn * f;
  for_each_out<T, MT, 2>(acc, [&](int m, int t, int col, float v) {
    const int n = n0 + col;
    if (t < Tn && n < f) out[((size_t)m * Tn + t) * f + n] = v;
  });
}

template <typename T, int MT>
__global__ void __launch_bounds__(NTHR)
moe_down_kernel(const float* __restrict__ P, const T* __restrict__ w2,
                const float* __restrict__ combine, int ldc,
                const unsigned char* __restrict__ active,
                float* __restrict__ Pd, int Tn, int d, int f, int E, int KS,
                int FS, int fr) {
  pdl_launch_dependents();
  const int s = blockIdx.z, fs = blockIdx.y, n0 = blockIdx.x * BN;
  const int2 se = slot_expert(active, E, s);
  if (s >= se.y) return;
  const int e = se.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* hs = ws + STAGES * KST<1> * Lay<T>::WP;
  const int bp = fr + Lay<T>::PAD;
  const int k0 = fs * fr, kend = min(k0 + fr, f);
  const T* const W[1] = {w2 + (size_t)e * f * d};
  auto fill = [&]() {  // H[:, k0 : k0 + fr] from the up pass's splits
    pdl_wait();  // the up pass has finished and P is visible
    const float* p = P + (size_t)s * KS * 2 * Tn * f;
    const int f4 = fr / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < MT * f4; i += NTHR) {
      const int t = i / f4, kk = (i % f4) * 4, k = k0 + kk;
      float h[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < Tn && k < f) {  // f % 8 == 0: all four columns are in
        float a1[4] = {0.f, 0.f, 0.f, 0.f}, a3[4] = {0.f, 0.f, 0.f, 0.f};
        for (int q = 0; q < KS; ++q) {
          const float4 u = *reinterpret_cast<const float4*>(
              p + ((size_t)(2 * q) * Tn + t) * f + k);
          const float4 v = *reinterpret_cast<const float4*>(
              p + ((size_t)(2 * q + 1) * Tn + t) * f + k);
          a1[0] += u.x; a1[1] += u.y; a1[2] += u.z; a1[3] += u.w;
          a3[0] += v.x; a3[1] += v.y; a3[2] += v.z; a3[3] += v.w;
        }
        const float cm = combine[(size_t)t * ldc + e];
#pragma unroll
        for (int u = 0; u < 4; ++u) h[u] = cm * silu_f32(a1[u]) * a3[u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) hs[t * bp + kk + u] = from_f32<T>(h[u]);
    }
  };
  float acc[1][MT / 2] = {};
  stream_product<T, MT, 1>(W, d, k0, kend, n0, ws, hs, bp, fill, acc);
  float* out = Pd + (size_t)(s * FS + fs) * Tn * d;
  for_each_out<T, MT, 1>(acc, [&](int, int t, int col, float v) {
    const int n = n0 + col;
    if (t < Tn && n < d) out[(size_t)t * d + n] = v;
  });
}

template <typename T>
__global__ void moe_reduce_kernel(const float* __restrict__ Pd,
                                  const unsigned char* __restrict__ active,
                                  T* __restrict__ y, int E, int slots,
                                  int FS, int n) {
  const int nv = min(slots, slot_expert(active, E, 0).y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  pdl_wait();  // the down pass has finished and Pd is visible
  if (i >= n) return;
  float acc = 0.f;
  for (int q = 0; q < nv * FS; ++q) acc += Pd[(size_t)q * n + i];
  y[i] = from_f32<T>(acc);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int MT>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           const void* combine, int ldc, const void* active, void* P,
           void* Pd, void* y, int Tn, int d, int f, int E, int slots,
           int KS, int FS, cudaStream_t s) {
  using L = Lay<T>;
  const int kr = ceil_div(ceil_div(d, KS), KST<2>) * KST<2>;
  const int fr = ceil_div(ceil_div(f, FS), KST<1>) * KST<1>;
  const int smem_up = (STAGES * 2 * KST<2> * L::WP + MT * (kr + L::PAD)) *
                      (int)sizeof(T);
  const int smem_dn =
      (STAGES * KST<1> * L::WP + MT * (fr + L::PAD)) * (int)sizeof(T);
  auto up = &moe_up_kernel<T, MT>;
  auto dn = &moe_down_kernel<T, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_up);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dn);
  if (err != cudaSuccess) return (int)err;
  const auto* act = static_cast<const unsigned char*>(active);
  up<<<dim3(ceil_div(f, BN), KS, slots), NTHR, smem_up, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), act, static_cast<float*>(P), Tn, d, f, E,
      KS, kr);
  // down and reduce start early (programmatic dependent launch): each
  // finds its expert and, for down, fills its weight ring while the pass
  // before it ends, and waits for that pass only to read its output
  err = launch_pdl(dn, dim3(ceil_div(d, BN), FS, slots), dim3(NTHR),
                   smem_dn, s, P, w2, combine, ldc, act, Pd, Tn, d, f, E,
                   KS, FS, fr);
  if (err != cudaSuccess) return (int)err;
  err = launch_pdl(&moe_reduce_kernel<T>, dim3(ceil_div(Tn * d, 256)),
                   dim3(256), 0, s, Pd, act, y, E, slots, FS, Tn * d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(int Tn, const void* x, const void* w1, const void* w3,
             const void* w2, const void* combine, int ldc,
             const void* active, void* P, void* Pd, void* y, int d, int f,
             int E, int slots, int KS, int FS, cudaStream_t s) {
  // token-count bucket -> token rows held (T <= 32)
  auto fn = Tn <= 8 ? &launch<T, 8> : Tn <= 16 ? &launch<T, 16>
                                               : &launch<T, 32>;
  return fn(x, w1, w3, w2, combine, ldc, active, P, Pd, y, Tn, d, f, E,
            slots, KS, FS, s);
}

}  // namespace

// x (T, d), w1 / w3 (E, d, f), w2 (E, f, d) in one dtype, 16-byte aligned,
// d and f multiples of 8; combine (T, E) f32 with row stride ldc (a
// column slice needs no copy); active (E,) bool. P (slots, KS, 2, T, f)
// and Pd (slots, FS, T, d) are f32 scratch.
extern "C" int moe_ffn(const void* x, const void* w1, const void* w3,
                       const void* w2, const void* combine, int ldc,
                       const void* active, void* P, void* Pd, void* y,
                       int Tn, int d, int f, int E, int slots, int KS,
                       int FS, int dtype, void* stream) {
  if (Tn < 1 || Tn > 32 || d % 8 || f % 8 || slots < 1 || KS < 1 || FS < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_t<float>(Tn, x, w1, w3, w2, combine, ldc, active, P, Pd,
                           y, d, f, E, slots, KS, FS, s);
  return launch_t<__nv_bfloat16>(Tn, x, w1, w3, w2, combine, ldc, active,
                                 P, Pd, y, d, f, E, slots, KS, FS, s);
}
