// moe_ffn — the XShare masked expert FFN of a decode step.
//
// Replaces the Pallas kernel `moe_ffn` (body `_kernel`) of
// src/repro/kernels/moe_ffn.py:
//     y = sum over e in active of combine[:, e] * FFN_e(x)
// over at most max_active selected experts; only their weights are read.
// The expert ids come from the wrapper as ids = argsort(~active,
// stable)[:max_active] with valid = arange(max_active) < active.sum(),
// computed on the device without a host sync.
//
// What bounds it on the H100: at decode sizes (T <= 32 tokens, here 8)
// the products are (T x 1024) x (1024 x 512), so every weight element
// is used by only T tokens. It is bound by the bytes of the selected
// experts' weights: 3 * 1024 * 512 * 2 B = 3 MB per expert in bf16,
// read once per step.
//
// Design: three launches, each streaming weights exactly once with
// neighbouring threads on neighbouring columns (coalesced rows of W),
// tokens held in registers, x and the hidden activations staged in
// shared memory.
//   1. up:     per (slot, 64-column f tile), four k-groups of threads
//              split d; H[s] = combine[:, ids[s]] * silu(x W1) * (x W3)
//              into an f32 (max_active, T, f) scratch.
//   2. down:   per (64-column d tile, slot), four f-groups split f;
//              part[s] = H[s] W2[ids[s]] into an f32 (max_active, T, d)
//              scratch.
//   3. reduce: y = sum over valid slots of part[s], in slot order.
// Every sum runs in a fixed order (no float atomics), so the same
// inputs give the same bits run after run and greedy tokens repeat.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int UC = 64;            // output columns per block
constexpr int KG = NT / UC;       // thread groups splitting the reduction
constexpr int KC = 64;            // reduction rows staged per chunk
constexpr int KPG = KC / KG;      // rows per group per chunk

// Sum the KG groups' per-thread accumulators into group 0, in order.
template <int MT>
__device__ __forceinline__ void reduce_groups(float (&acc)[MT],
                                              float (*red)[MT][UC], int g,
                                              int c) {
  if (g > 0) {
#pragma unroll
    for (int t = 0; t < MT; ++t) red[g - 1][t][c] = acc[t];
  }
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int gg = 0; gg < KG - 1; ++gg)
#pragma unroll
      for (int t = 0; t < MT; ++t) acc[t] += red[gg][t][c];
  }
  __syncthreads();
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT)
moe_up_kernel(const T* __restrict__ x, const T* __restrict__ w1,
              const T* __restrict__ w3, const float* __restrict__ combine,
              const int* __restrict__ ids, const int* __restrict__ valid,
              float* __restrict__ H, int Tn, int d, int f, int E) {
  const int s = blockIdx.x;
  if (!valid[s]) return;  // H[s] of an unused slot is never read
  const int e = ids[s];
  const int c = threadIdx.x % UC, g = threadIdx.x / UC;
  const int col = blockIdx.y * UC + c;
  const T* W1 = w1 + (size_t)e * d * f;
  const T* W3 = w3 + (size_t)e * d * f;

  __shared__ float xs[MT][KC];
  __shared__ float red[KG - 1][MT][UC];
  float a1[MT] = {}, a3[MT] = {};

  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int i = threadIdx.x; i < MT * KC; i += NT) {
      const int t = i / KC, kk = i % KC;
      xs[t][kk] = (t < Tn && k0 + kk < d) ? to_f32(x[(size_t)t * d + k0 + kk])
                                          : 0.f;
    }
    __syncthreads();
    if (col < f) {
      for (int kk = g * KPG; kk < (g + 1) * KPG && k0 + kk < d; ++kk) {
        const size_t at = (size_t)(k0 + kk) * f + col;
        const float b1 = to_f32(W1[at]), b3 = to_f32(W3[at]);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          a1[t] += xs[t][kk] * b1;
          a3[t] += xs[t][kk] * b3;
        }
      }
    }
    __syncthreads();
  }
  reduce_groups<MT>(a1, red, g, c);
  reduce_groups<MT>(a3, red, g, c);
  if (g == 0 && col < f) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
      if (t < Tn)
        H[((size_t)s * Tn + t) * f + col] =
            combine[(size_t)t * E + e] * silu_f32(a1[t]) * a3[t];
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT)
moe_down_kernel(const float* __restrict__ H, const T* __restrict__ w2,
                const int* __restrict__ ids, const int* __restrict__ valid,
                float* __restrict__ part, int Tn, int d, int f) {
  const int s = blockIdx.y;
  if (!valid[s]) return;  // the reduce skips unused slots
  const int e = ids[s];
  const int c = threadIdx.x % UC, g = threadIdx.x / UC;
  const int col = blockIdx.x * UC + c;
  const T* W2 = w2 + (size_t)e * f * d;

  __shared__ float hs[MT][KC];
  __shared__ float red[KG - 1][MT][UC];
  float acc[MT] = {};

  for (int k0 = 0; k0 < f; k0 += KC) {
    for (int i = threadIdx.x; i < MT * KC; i += NT) {
      const int t = i / KC, kk = i % KC;
      hs[t][kk] = (t < Tn && k0 + kk < f)
                      ? H[((size_t)s * Tn + t) * f + k0 + kk]
                      : 0.f;
    }
    __syncthreads();
    if (col < d) {
      for (int kk = g * KPG; kk < (g + 1) * KPG && k0 + kk < f; ++kk) {
        const float b = to_f32(W2[(size_t)(k0 + kk) * d + col]);
#pragma unroll
        for (int t = 0; t < MT; ++t) acc[t] += hs[t][kk] * b;
      }
    }
    __syncthreads();
  }
  reduce_groups<MT>(acc, red, g, c);
  if (g == 0 && col < d) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
      if (t < Tn) part[((size_t)s * Tn + t) * d + col] = acc[t];
  }
}

template <typename T>
__global__ void moe_reduce_kernel(const float* __restrict__ part,
                                  const int* __restrict__ valid,
                                  T* __restrict__ y, int slots, int Tn,
                                  int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Tn * d) return;
  float acc = 0.f;
  for (int s = 0; s < slots; ++s)
    if (valid[s]) acc += part[(size_t)s * Tn * d + i];
  y[i] = from_f32<T>(acc);
}

template <typename T, int MT>
void launch_up(const void* x, const void* w1, const void* w3,
               const void* combine, const void* ids, const void* valid,
               void* h, int Tn, int d, int f, int E, int slots,
               cudaStream_t s) {
  const dim3 grid(slots, (f + UC - 1) / UC);
  moe_up_kernel<T, MT><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<const float*>(combine),
      static_cast<const int*>(ids), static_cast<const int*>(valid),
      static_cast<float*>(h), Tn, d, f, E);
}

template <typename T, int MT>
void launch_down(const void* h, const void* w2, const void* ids,
                 const void* valid, void* part, int Tn, int d, int f,
                 int slots, cudaStream_t s) {
  const dim3 grid((d + UC - 1) / UC, slots);
  moe_down_kernel<T, MT><<<grid, NT, 0, s>>>(
      static_cast<const float*>(h), static_cast<const T*>(w2),
      static_cast<const int*>(ids), static_cast<const int*>(valid),
      static_cast<float*>(part), Tn, d, f);
}

// Token-count bucket -> register-array size (T <= 32).
#define MOE_DISPATCH_T(Tn, FN, T, ...)      \
  do {                                       \
    if ((Tn) <= 8)                           \
      FN<T, 8>(__VA_ARGS__);                 \
    else if ((Tn) <= 16)                     \
      FN<T, 16>(__VA_ARGS__);                \
    else                                     \
      FN<T, 32>(__VA_ARGS__);                \
  } while (0)

}  // namespace

extern "C" int moe_ffn_up(const void* x, const void* w1, const void* w3,
                          const void* combine, const void* ids,
                          const void* valid, void* h, int Tn, int d, int f,
                          int E, int slots, int dtype, void* stream) {
  if (Tn > 32 || Tn < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    MOE_DISPATCH_T(Tn, launch_up, float, x, w1, w3, combine, ids, valid, h,
                   Tn, d, f, E, slots, s);
  else
    MOE_DISPATCH_T(Tn, launch_up, __nv_bfloat16, x, w1, w3, combine, ids,
                   valid, h, Tn, d, f, E, slots, s);
  return (int)cudaGetLastError();
}

extern "C" int moe_ffn_down(const void* h, const void* w2, const void* ids,
                            const void* valid, void* part, int Tn, int d,
                            int f, int slots, int dtype, void* stream) {
  if (Tn > 32 || Tn < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    MOE_DISPATCH_T(Tn, launch_down, float, h, w2, ids, valid, part, Tn, d,
                   f, slots, s);
  else
    MOE_DISPATCH_T(Tn, launch_down, __nv_bfloat16, h, w2, ids, valid, part,
                   Tn, d, f, slots, s);
  return (int)cudaGetLastError();
}

extern "C" int moe_ffn_reduce(const void* part, const void* valid, void* y,
                              int slots, int Tn, int d, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = Tn * d, threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (dtype == kF32)
    moe_reduce_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(part), static_cast<const int*>(valid),
        static_cast<float*>(y), slots, Tn, d);
  else
    moe_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(part), static_cast<const int*>(valid),
        static_cast<__nv_bfloat16*>(y), slots, Tn, d);
  return (int)cudaGetLastError();
}
