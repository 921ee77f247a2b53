// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 activations (the `dtype` code the
// Python wrappers pass: 0 = float32, 1 = bfloat16), beside int8 weights or
// an int8 KV cache where it is quantized, computes in float32, and writes
// its output in the activations' type (or the type the caller asks for). The C entry points return
// cudaGetLastError() after the launch, so a refused launch is reported to
// the wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LCT_DTYPE_F32 0
#define LCT_DTYPE_BF16 1

__device__ __forceinline__ float lct_to_float(float x) { return x; }
__device__ __forceinline__ float lct_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float lct_to_float(int8_t x) {
  return static_cast<float>(x);  // exact
}

template <typename T>
__device__ __forceinline__ T lct_from_float(float x);
template <>
__device__ __forceinline__ float lct_from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 lct_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Sum over the lanes of a group of `width` neighbouring lanes (width a
// power of two <= 32); every lane of the group gets the total.
template <int width>
__device__ __forceinline__ float lct_group_sum(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------------------
// Tensor-core and copy helpers (K2's bf16 form, K6 and K10).
// ---------------------------------------------------------------------------

// c += a * b on the tensor cores: one mma.sync m16n8k16, bf16 A (16 x 16,
// row-major fragment) and B (16 x 8, column-major fragment), float32
// accumulators. Lane l holds rows l / 4 and l / 4 + 8 of c, columns
// 2 * (l % 4) and 2 * (l % 4) + 1.
__device__ __forceinline__ void lct_mma_bf16(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// addresses of matrix i's 8 rows (16 bytes each), r[i] gets lane l's two
// elements of it: row l / 4, columns 2 * (l % 4) and + 1; with .trans,
// column l / 4, rows 2 * (l % 4) and + 1.
__device__ __forceinline__ void lct_ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void lct_ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from device to shared memory without passing through registers;
// with valid false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void lct_cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void lct_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void lct_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}
