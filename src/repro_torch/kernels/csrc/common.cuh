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

// ---- f32 products on the tensor cores: 3xTF32 ----------------------------
//
// TF32 keeps 10 of f32's 23 mantissa bits. An f32 value a splits into two
// TF32 values, hi = tf32(a) and lo = tf32(a - hi) (a - hi is exact in f32),
// and a·b is taken as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b in an f32
// accumulator: only lo_a·lo_b (~2^-22 of the product) is dropped, so the
// result is as accurate as an f32 FMA chain. A single TF32 product keeps
// ~3 decimal digits and is never used on f32 data. A bf16 value widened to
// f32 is exact in TF32: its lo is zero and its terms can be skipped.

// f32 -> TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero), in two integer instructions: half an ulp of TF32 added to the
// magnitude's bits, the 13 low mantissa bits cleared. The same bits as
// the instruction for every finite a (a NaN may come out as inf), and on
// sm_90a several times cheaper: cvt.rna.tf32.f32 is not one instruction
// there.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, element by element
template <int N>
__device__ __forceinline__ void split_tf32(const float (&a)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    hi[e] = tf32_rna(a[e]);
    lo[e] = tf32_rna(a[e] - __uint_as_float(hi[e]));
  }
}

// c (16 x 8, f32) += a (16 x 8, TF32, row-major) · b (8 x 8, TF32) on the
// tensor cores. Fragments (g = lane / 4, q = lane % 4): a holds rows g and
// g + 8 at columns q (a[0], a[1]) and q + 4 (a[2], a[3]); b holds column g
// at rows q (b[0]) and q + 4 (b[1]); c as mma_bf16's. Not volatile: the
// compiler may interleave products of different accumulators (one
// accumulator's are ordered by their data).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n0 + u] += a · b[u] for G side-by-side tiles at f32 accuracy: the
// lo_a·hi_b terms of all G tiles, then their hi_a·lo_b, then hi_a·hi_b,
// so each accumulator takes its three terms in that order and no mma
// waits on the one issued just before it. A_EXACT (B_EXACT): a's (b's) lo
// is zero and its term skipped.
template <bool A_EXACT, bool B_EXACT, int G, int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], int n0,
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[G][2],
                                           const uint32_t (&bl)[G][2]) {
  if (!A_EXACT) {
#pragma unroll
    for (int u = 0; u < G; ++u) mma_tf32(c[n0 + u], al, bh[u]);
  }
  if (!B_EXACT) {
#pragma unroll
    for (int u = 0; u < G; ++u) mma_tf32(c[n0 + u], ah, bl[u]);
  }
#pragma unroll
  for (int u = 0; u < G; ++u) mma_tf32(c[n0 + u], ah, bh[u]);
}

// TF32 fragments read from a row-major shared tile t of pitch p (elements
// of T, widened to f32). Two orders of k: "standard" k runs along a row as
// the fragment maps above; "permuted" reads k slot q from column 2q and
// slot q + 4 from 2q + 1, which is how an accumulator's columns sit in
// its registers, so an accumulator feeds the next product's a directly
// (acc_as_a) when that product's b is read permuted too. With a pitch of
// 4 mod 8 words, lda, ldb and ldb_perm hit no bank twice.

// a: rows r0 .. r0 + 15, k along the row from k0 (standard)
template <typename T>
__device__ __forceinline__ void lda_tf32(const T* t, int p, int r0, int k0,
                                         float (&v)[4]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const T* s = t + (r0 + g) * p + k0 + q;
  v[0] = to_f32(s[0]);
  v[1] = to_f32(s[8 * p]);
  v[2] = to_f32(s[4]);
  v[3] = to_f32(s[8 * p + 4]);
}
// a: rows r0 .. r0 + 15, k along the row from k0 (permuted)
template <typename T>
__device__ __forceinline__ void lda_tf32_perm(const T* t, int p, int r0,
                                              int k0, float (&v)[4]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const T* s = t + (r0 + g) * p + k0 + 2 * q;
  v[0] = to_f32(s[0]);
  v[1] = to_f32(s[8 * p]);
  v[2] = to_f32(s[1]);
  v[3] = to_f32(s[8 * p + 1]);
}
// a from a k-major tile (t[k][m]): m rows r0 .. r0 + 15, k down the tile's
// rows from k0 (permuted)
template <typename T>
__device__ __forceinline__ void lda_tf32_kmajor(const T* t, int p, int r0,
                                                int k0, float (&v)[4]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const T* s = t + (k0 + 2 * q) * p + r0 + g;
  v[0] = to_f32(s[0]);
  v[1] = to_f32(s[8]);
  v[2] = to_f32(s[p]);
  v[3] = to_f32(s[p + 8]);
}
// b: column n is the tile's row n0 + n, k along that row from k0 (standard)
template <typename T>
__device__ __forceinline__ void ldb_tf32(const T* t, int p, int n0, int k0,
                                         float (&v)[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const T* s = t + (n0 + g) * p + k0 + q;
  v[0] = to_f32(s[0]);
  v[1] = to_f32(s[4]);
}
// b: k down the tile's rows from k0 (permuted), column n its column n0 + n
template <typename T>
__device__ __forceinline__ void ldb_tf32_perm(const T* t, int p, int k0,
                                              int n0, float (&v)[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const T* s = t + (k0 + 2 * q) * p + n0 + g;
  v[0] = to_f32(s[0]);
  v[1] = to_f32(s[p]);
}
// an accumulator (16 x 8) as the a of a product over its 8 columns, k
// permuted
__device__ __forceinline__ void acc_as_a(const float (&c)[4], float (&v)[4]) {
  v[0] = c[0];
  v[1] = c[2];
  v[2] = c[1];
  v[3] = c[3];
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
