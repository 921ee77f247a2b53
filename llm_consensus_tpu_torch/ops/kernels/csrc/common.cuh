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
// Tensor-core and copy helpers (K2's bf16 form; ldmatrix also K6 and K10).
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

// 4 bytes from device to shared memory (cp.async.ca); zeroed when !valid.
__device__ __forceinline__ void lct_cp_async4(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers (Hopper; the split-KV pass of K3 and K4, and K6 and K10).
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned lct_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A barrier whose phase completes after `count` arrivals (and, where a
// thread announced some, that many bytes of TMA copies).
__device__ __forceinline__ void lct_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(lct_smem(bar)), "r"(count) : "memory");
}
// Makes the initialised barriers visible to the async proxy; a
// __syncthreads() after it makes them visible to the block.
__device__ __forceinline__ void lct_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void lct_mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(lct_smem(bar)) : "memory");
}
// One arrival that also announces `bytes` of TMA copies to come.
__device__ __forceinline__ void lct_mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(lct_smem(bar)), "r"(bytes) : "memory");
}
// One arrival once every cp.async this thread issued so far has landed
// (counted in the barrier's arrivals).
__device__ __forceinline__ void lct_cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(lct_smem(bar)) : "memory");
}
// Wait until the barrier's phase of the given parity (0, 1, 0, ... for
// its first, second, third completion) has completed.
__device__ __forceinline__ void lct_mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = lct_smem(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// Programmatic dependent launches (Hopper): a chain of kernels on one stream
// whose later members start while the earlier ones run.
// ---------------------------------------------------------------------------

// Lets the next kernel of the stream, if it was launched as a programmatic
// dependent, start its blocks now.
__device__ __forceinline__ void lct_pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Waits until the kernel this one was launched after has finished and its
// writes are visible; returns at once when this kernel was launched
// normally. A dependent calls it before it reads what that kernel wrote,
// and on every path before it exits, so that its own end implies the
// earlier kernel's (what a chain of three relies on).
__device__ __forceinline__ void lct_pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launches kernel<<<grid, block, smem, stream>>>(args...), as a programmatic
// dependent of the stream's previous kernel when `dependent`; returns the
// launch's error code.
template <typename... KArgs, typename... Args>
int lct_launch(void (*kernel)(KArgs...), dim3 grid, dim3 block, int smem, cudaStream_t stream,
               bool dependent, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// Opts a kernel in to `smem` bytes of dynamic shared memory (above 48 KB
// needs it), once per kernel.
template <typename K>
int lct_smem_opt_in(K kernel, int smem, bool& done) {
  if (done || smem <= 48 * 1024) return 0;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  done = true;
  return 0;
}
