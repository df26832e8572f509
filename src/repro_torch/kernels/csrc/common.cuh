// Shared helpers of the hand-written Hopper kernels: element conversion
// between the storage types (float, bf16) and the f32 the kernels
// accumulate in, and SwiGLU's activation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float silu_f32(float x) {
  return x / (1.0f + expf(-x));
}

// dtype codes shared with kernels/build.py; kE4M3 is decode_attention's
// float8_e4m3fn cache (read with bf16 queries)
enum DType { kF32 = 0, kBF16 = 1, kE4M3 = 2 };

// ---- Hopper building blocks shared by the tensor-core kernels ----------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared, bypassing L1; when !pred the
// 16 destination bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8. .trans hands each thread the transposed
// elements, so a tile stored k-major loads as an M-major mma operand.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// This lane's address for an ldmatrix.x4 over rows [r0, r0 + 16) and
// columns [c0, c0 + 16) of a row-major bf16 tile of pitch p. Matrix m
// (lanes 8m .. 8m + 7) covers the row half rh and column half ch:
// ROW_FIRST: m = rh + 2 ch (an mma A operand, or a .trans B operand);
// else m = ch + 2 rh (two n-tiles of a B operand stored [n][k], or an A
// operand stored [k][m] and loaded with .trans).
template <bool ROW_FIRST>
__device__ __forceinline__ const __nv_bfloat16* x4_addr(
    const __nv_bfloat16* t, int p, int r0, int c0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  const int rh = ROW_FIRST ? (m & 1) : (m >> 1);
  const int ch = ROW_FIRST ? (m >> 1) : (m & 1);
  return t + (r0 + (l & 7) + rh * 8) * p + c0 + ch * 8;
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) · b (16 x 8, bf16) on
// the tensor cores. Fragments (g = lane / 4, q = lane % 4): a holds rows
// g and g + 8 at columns 2q, 2q + 1 and 2q + 8, 2q + 9; b holds column g
// at rows 2q, 2q + 1 (b[0]) and 2q + 8, 2q + 9 (b[1]); c[0], c[1] are row
// g, columns 2q, 2q + 1 and c[2], c[3] the same of row g + 8.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Programmatic dependent launch (Hopper): a grid launched with
// launch_pdl may start while the grid before it on the stream still
// runs, once every block of that grid has called pdl_launch_dependents
// (or exited); pdl_wait blocks until that grid has finished and its
// writes are visible. Without the launch attribute both are no-ops.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       int smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}
