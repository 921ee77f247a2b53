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
