// K1: RMSNorm over the last axis.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/norms.py
// (fused_rms_norm -> _rms_kernel). Same arithmetic: the mean of squares in
// float32, rsqrt(ms + eps), times the weight, cast back to the input type.
//
// What bounds it on the card: bytes. Each element is read once and
// written once, with a handful of operations per element, far below the
// H100's ~295 operations per byte. Design: one block per row, so a row
// (d_model = 2048 on llama-1b) is read once from device memory into
// registers; 256 threads each keep their slice of the row in registers
// between the reduction and the scaled write, so the row is not read
// twice. The sum of squares is reduced with warp shuffles, then across the
// block's warps through shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Row elements a thread keeps in registers; rows up to kThreads * kMaxPer
// (8192) take the register path, longer rows re-read the input.
constexpr int kMaxPer = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int d, float eps) {
  const T* xr = x + (size_t)blockIdx.x * d;
  T* outr = out + (size_t)blockIdx.x * d;
  const bool in_regs = d <= kThreads * kMaxPer;

  float vals[kMaxPer];
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int i = threadIdx.x + e * kThreads;
    float v = 0.f;
    if (in_regs && i < d) v = lct_to_float(xr[i]);
    vals[e] = v;
    ss += v * v;
  }
  if (!in_regs) {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = lct_to_float(xr[i]);
      ss += v * v;
    }
  }

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_shared;
  ss = lct_group_sum<32>(ss);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    inv_shared = rsqrtf(total / (float)d + eps);
  }
  __syncthreads();
  const float inv = inv_shared;

  if (in_regs) {
#pragma unroll
    for (int e = 0; e < kMaxPer; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i < d) outr[i] = lct_from_float<T>(vals[e] * inv * lct_to_float(w[i]));
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      outr[i] = lct_from_float<T>(lct_to_float(xr[i]) * inv * lct_to_float(w[i]));
    }
  }
}

}  // namespace

extern "C" int lct_rms_norm(const void* x, const void* w, void* out, int rows,
                            int d, float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == LCT_DTYPE_F32) {
    rms_norm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, eps);
  } else if (dtype == LCT_DTYPE_BF16) {
    rms_norm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
