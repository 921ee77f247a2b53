// K1: RMSNorm over the last axis.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/norms.py
// (fused_rms_norm -> _rms_kernel). Same arithmetic: the mean of squares in
// float32, rsqrt(ms + eps), times the weight, cast back to the input type.
//
// What bounds it on the card: bytes. Each element is read once and
// written once, with a handful of operations per element, far below the
// H100's ~295 operations per byte. So the design is about keeping enough
// loads in flight and paying nothing per row besides them.
//
// Design: one warp per row, several warps per block (the wrapper's
// rms_norm_launch picks how many, so that even the 64 rows of a decode step
// spread over 64 SMs), rows walked grid-stride where they outnumber the
// warps launched. Loads and stores are 16 bytes a lane (8 bf16 or 4
// float32): lane l takes vectors l, l + 32, ... of the row, NV of them, NV
// a template (the smallest instantiated count that covers the row). All NV
// loads of a row are issued before the sum, so a 2048-wide bf16 row is 8
// loads in flight per lane, and the row stays in registers between the sum
// and the scaled write: it is read once. The sum of squares is float32,
// reduced with warp shuffles only: no shared memory, no __syncthreads. The
// weight is loaded once per warp into registers and serves every row the
// warp walks (for NV <= 16, every bf16 preset width; wider float32 rows
// re-read it per row, from L1).

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;  // warps per block, at most (rms_norm_launch)

__device__ __forceinline__ float sum_squares(const uint4& x, float) {
  const float4 f = *reinterpret_cast<const float4*>(&x);
  return f.x * f.x + f.y * f.y + f.z * f.z + f.w * f.w;
}
__device__ __forceinline__ float sum_squares(const uint4& x, __nv_bfloat16) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&x);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(u + i));
    ss += f.x * f.x + f.y * f.y;
  }
  return ss;
}

// (x * inv) * w per element, in float32, rounded once to the type.
__device__ __forceinline__ uint4 scale_vec(const uint4& x, const uint4& w,
                                           float inv, float) {
  const float4 a = *reinterpret_cast<const float4*>(&x);
  const float4 b = *reinterpret_cast<const float4*>(&w);
  const float4 r = make_float4(a.x * inv * b.x, a.y * inv * b.y, a.z * inv * b.z,
                               a.w * inv * b.w);
  return *reinterpret_cast<const uint4*>(&r);
}
__device__ __forceinline__ uint4 scale_vec(const uint4& x, const uint4& w,
                                           float inv, __nv_bfloat16) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(&w);
  uint4 r;
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + i));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + i));
    const __nv_bfloat162 h = __floats2bfloat162_rn(fa.x * inv * fb.x, fa.y * inv * fb.y);
    o[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return r;
}

// x, w, out as 16-byte vectors; nvec = d / (elements per vector) per row.
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxWarps * 32)
    rms_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                    uint4* __restrict__ out, int rows, int nvec, float d,
                    float eps) {
  constexpr bool kWeightInRegs = NV <= 16;
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (blockDim.x / 32);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 wr[kWeightInRegs ? NV : 1];
  if constexpr (kWeightInRegs) {
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int i = lane + 32 * e;
      wr[e] = i < nvec ? __ldg(w + i) : zero;
    }
  }

  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; row < rows;
       row += warps) {
    const uint4* xr = x + (size_t)row * nvec;
    uint4 xv[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int i = lane + 32 * e;
      xv[e] = i < nvec ? __ldg(xr + i) : zero;
    }
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) ss += sum_squares(xv[e], T());
    ss = lct_group_sum<32>(ss);
    const float inv = rsqrtf(ss / d + eps);
    uint4* outr = out + (size_t)row * nvec;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int i = lane + 32 * e;
      if (i < nvec) {
        uint4 wv;
        if constexpr (kWeightInRegs) {
          wv = wr[e];
        } else {
          wv = __ldg(w + i);
        }
        outr[i] = scale_vec(xv[e], wv, inv, T());
      }
    }
  }
}

template <typename T>
int dispatch_nv(const void* x, const void* w, void* out, int rows, int nvec,
                int d, float eps, int nv, int warps, int blocks, cudaStream_t s) {
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* wv = static_cast<const uint4*>(w);
  uint4* ov = static_cast<uint4*>(out);
  const dim3 grid(blocks), block(warps * 32);
  const float df = (float)d;
  switch (nv) {
#define LCT_RMS_CASE(N) \
  case N: rms_norm_kernel<T, N><<<grid, block, 0, s>>>(xv, wv, ov, rows, nvec, df, eps); break;
    LCT_RMS_CASE(1) LCT_RMS_CASE(2) LCT_RMS_CASE(3) LCT_RMS_CASE(4)
    LCT_RMS_CASE(6) LCT_RMS_CASE(8) LCT_RMS_CASE(16) LCT_RMS_CASE(32)
#undef LCT_RMS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// x, out: [rows, d] contiguous, 16-byte aligned; w: [d]. nv: 16-byte
// vectors per lane and row (an instantiated count with nv * 32 vectors
// covering the row); warps per block (1-8) and blocks as rms_norm_launch
// gives them.
extern "C" int lct_rms_norm(const void* x, const void* w, void* out, int rows,
                            int d, float eps, int dtype, int nv, int warps,
                            int blocks, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_vec = dtype == LCT_DTYPE_F32 ? 4 : 8;
  const int nvec = d / per_vec;
  if (d <= 0 || d % per_vec || nvec > 32 * nv || warps < 1 || warps > kMaxWarps ||
      blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int rc;
  if (dtype == LCT_DTYPE_F32) {
    rc = dispatch_nv<float>(x, w, out, rows, nvec, d, eps, nv, warps, blocks, s);
  } else if (dtype == LCT_DTYPE_BF16) {
    rc = dispatch_nv<__nv_bfloat16>(x, w, out, rows, nvec, d, eps, nv, warps, blocks, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
