// K6: the W8A16 matmul. x [M, K] (bfloat16 or float32) times int8 w [K, N]
// with a float32 scale per column: float32 sums, times the scale, cast to
// the output type (bfloat16 or float32).
//
// Replaces llm_consensus_tpu/ops/pallas/quant_matmul.py: quant_matmul_2d
// (-> _qmm_kernel) and quant_matmul_stacked (-> _qmm_stacked_kernel, which
// exists because a Pallas operand must be a whole buffer; here it is this
// kernel on a layer's view). For bf16 x it computes what _qmm_kernel
// computes: bf16 x times the int8 weight converted exactly to bf16, float32
// sums, times the scale. Pallas casts every x to bf16 first; a float32 x
// stays float32 here, which is what the JAX package computes wherever its
// kernel is off (every CPU run included).
//
// What bounds it on the card. The product reads K * N weight bytes and
// does 2 * M * K * N operations. In decode (M <= 64) that is at most 128
// operations per weight byte, below the ~295 at which the tensor cores
// rather than the memory would be the limit: it is bytes-bound, and int8
// halves the bytes of bf16. One llama-1b decode step reads ~0.79 GB of
// int8 weights (16 layers x 45.1 MB plus the 65.5 MB lm_head), ~0.24 ms at
// 3.35 TB/s, against ~0.47 ms for the bf16 weights. On the CUDA cores
// (67 TFLOP/s in float32) the same step at M = 64 would be bound by its
// operations, ~1.5 ms; hence the tensor cores for bf16 x.
//
// bf16 x (16-byte aligned, K a multiple of 128, N of 128, M <= 256) takes
// quant_wgmma.cuh's kernel on its int8 weight format, K10's design: the
// weights as wgmma's A operand from registers (out^T = w^T x^T), each byte
// unpacked exactly to bf16 by two byte permutes and an add; x^T as B from a
// 128-byte-swizzled shared-memory box; 128-column tiles, so x is read from
// L2 once per 128 columns (at M = 64 as many bytes as the weights); a TMA
// ring of 128-row stages (two 64-row w boxes and two x boxes) fed by one
// producer warp; split-K reduced in rank order inside a thread-block
// cluster, with no workspace and no second launch. Its launch comes from
// ops/kernels/quant_matmul.py: wgmma_tile. What still bounds it is in that
// header's note.
//
// The CUDA-core form (float32 x, and bf16 x that the wgmma form does not
// take). One block of 256 threads per (tile of up to MT = 8 rows of M, 32
// columns of N); blockIdx.x walks the M tiles fastest, so the blocks that
// share a column tile run together and the weights are re-read once per M
// tile, from L2 after the first. Each thread owns 4 neighbouring columns
// and reads them as one 4-byte load per weight row; the block's 32 groups
// of 8 threads split K (each takes every 32nd row), in chunks of 512 rows,
// the next chunk's loads in flight while x's chunk is staged in shared
// memory as float. The 32 partial sums of each output are added in a fixed
// order. Its float32 products run at the CUDA cores' rate, which only the
// float32 reference models use.
//
// K10: the W4A16 matmul. x [M, K] (bfloat16 or float32) times packed int4 w
// [K/2, N]: byte (r, n) holds logical rows r (low nibble) and r + K/2 (high
// nibble) of column n, both sign-extended. Replaces
// llm_consensus_tpu/ops/pallas/quant_matmul.py: quant4_matmul_2d
// (-> _q4mm_kernel), and computes what it computes: bf16 x times the
// nibbles converted exactly to bf16 (every value in [-8, 7] is exact),
// float32 sums, times the column's float32 scale after the sum, cast to
// the output type. A float32 x stays float32, as for K6.
//
// What bounds it on the card: bytes, as K6, with half of K6's weight bytes
// for the same work. At decode's M <= 64 it does 2 * M * K * N operations
// on K * N / 2 bytes, at most 256 per weight byte, near the ~295 of the
// tensor cores' ridge in bf16. One llama-1b decode step reads ~0.41 GB of
// int4 weights (16 layers x 23.6 MB plus the 32.8 MB lm_head), ~0.12 ms at
// 3.35 TB/s, against ~0.24 ms for int8.
//
// This file holds K10's CUDA-core form, for float32 x (and bf16 x that is
// not 16-byte aligned): it stages 256 packed rows a chunk (both halves of
// x, 512 columns) and applies both nibbles of each 4-byte load, sign
// extension being integer work, ((b & 0xF) ^ 8) - 8. bf16 x takes the
// wgmma kernel through quant4_matmul.cu.

#include "quant_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 32;                                  // columns a block
constexpr int kColsPerThread = 4;                           // one 4-byte load
constexpr int kThreadsPerRow = kTileN / kColsPerThread;     // 8
constexpr int kKLanes = kThreads / kThreadsPerRow;          // 32
constexpr int kChunkK = 512;                                // rows of K a chunk
constexpr int kRowsPerLane = kChunkK / kKLanes;             // 16

// The CUDA-core forms' epilogue: the 32 K lanes' partial sums of each
// output added in a fixed order through shared memory (`smem`, at least
// kKLanes * MT * kTileN floats), times the scale, cast, stored.
template <typename TO, int MT>
__device__ __forceinline__ void cc_store(const float (&acc)[MT][kColsPerThread],
                                         float* smem, const float* __restrict__ scale,
                                         TO* __restrict__ out, int m, int n, int m0,
                                         int n0, int kl, int c0) {
  __syncthreads();  // the last chunk of x is no longer read
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    *reinterpret_cast<float4*>(&smem[(kl * MT + r) * kTileN + c0]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * kTileN; idx += kThreads) {
    const int r = idx / kTileN, col = idx % kTileN;
    if (m0 + r >= m) continue;
    float s = 0.f;
    for (int lane = 0; lane < kKLanes; ++lane) {
      s += smem[(lane * MT + r) * kTileN + col];
    }
    out[(size_t)(m0 + r) * n + n0 + col] =
        lct_from_float<TO>(s * scale[n0 + col]);
  }
}

// The sign-extended nibbles of a packed byte (b: the byte as a signed int).
__device__ __forceinline__ int lo_nibble(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int hi_nibble(int b) { return (((b >> 4) & 0xF) ^ 8) - 8; }

template <typename TX, typename TO, int MT>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, TO* __restrict__ out,
                        int m, int k, int n) {
  // The x chunk [kChunkK][MT] in the main loop; the partial sums
  // [kKLanes][MT][kTileN] in the epilogue.
  constexpr int kSmem = kKLanes * MT * kTileN > kChunkK * MT
                            ? kKLanes * MT * kTileN
                            : kChunkK * MT;
  __shared__ __align__(16) float smem[kSmem];

  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * kTileN;
  const int t = threadIdx.x;
  const int kl = t / kThreadsPerRow;                     // this thread's rows
  const int c0 = (t % kThreadsPerRow) * kColsPerThread;  // first of 4 columns
  const int8_t* __restrict__ wp = w + n0 + c0;

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;
  }

  char4 wnext[kRowsPerLane];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const int kk = k0 + kl + i * kKLanes;
      wnext[i] = kk < k ? *reinterpret_cast<const char4*>(wp + (size_t)kk * n)
                        : make_char4(0, 0, 0, 0);
    }
  };
  load(0);
  for (int k0 = 0; k0 < k; k0 += kChunkK) {
    char4 wr[kRowsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) wr[i] = wnext[i];
    if (k0 + kChunkK < k) load(k0 + kChunkK);

    __syncthreads();  // the previous chunk of x is no longer read
    for (int idx = t; idx < kChunkK * MT; idx += kThreads) {
      const int r = idx / kChunkK, kk = idx % kChunkK;
      const int row = m0 + r, col = k0 + kk;
      smem[kk * MT + r] =
          (row < m && col < k) ? lct_to_float(x[(size_t)row * k + col]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const float* xs = &smem[(kl + i * kKLanes) * MT];
      float xr[MT];
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < MT / 4; ++j) {
          const float4 v4 = reinterpret_cast<const float4*>(xs)[j];
          xr[4 * j] = v4.x;
          xr[4 * j + 1] = v4.y;
          xr[4 * j + 2] = v4.z;
          xr[4 * j + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < MT; ++r) xr[r] = xs[r];
      }
      const float wf[kColsPerThread] = {lct_to_float(wr[i].x), lct_to_float(wr[i].y),
                                        lct_to_float(wr[i].z), lct_to_float(wr[i].w)};
#pragma unroll
      for (int r = 0; r < MT; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          acc[r][c] = fmaf(xr[r], wf[c], acc[r][c]);
        }
      }
    }
  }

  cc_store<TO, MT>(acc, smem, scale, out, m, n, m0, n0, kl, c0);
}

// K10's CUDA-core form: K6's, over packed rows. A chunk is kChunk4 packed
// rows; smem rows [0, kChunk4) hold x's columns r0 + i (the low nibbles'
// rows), rows [kChunk4, kChunkK) columns K/2 + r0 + i (the high nibbles').
constexpr int kChunk4 = kChunkK / 2;                         // 256
constexpr int kRowsPerLane4 = kChunk4 / kKLanes;             // 8

template <typename TX, typename TO, int MT>
__global__ void __launch_bounds__(kThreads)
    quant4_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ scale, TO* __restrict__ out,
                         int m, int k, int n) {
  constexpr int kSmem = kKLanes * MT * kTileN > kChunkK * MT
                            ? kKLanes * MT * kTileN
                            : kChunkK * MT;
  __shared__ __align__(16) float smem[kSmem];

  const int k2 = k / 2;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * kTileN;
  const int t = threadIdx.x;
  const int kl = t / kThreadsPerRow;
  const int c0 = (t % kThreadsPerRow) * kColsPerThread;
  const int8_t* __restrict__ wp = w + n0 + c0;

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;
  }

  char4 wnext[kRowsPerLane4];
  auto load = [&](int r0) {
#pragma unroll
    for (int i = 0; i < kRowsPerLane4; ++i) {
      const int rr = r0 + kl + i * kKLanes;
      wnext[i] = rr < k2 ? *reinterpret_cast<const char4*>(wp + (size_t)rr * n)
                         : make_char4(0, 0, 0, 0);
    }
  };
  load(0);
  for (int r0 = 0; r0 < k2; r0 += kChunk4) {
    char4 wr[kRowsPerLane4];
#pragma unroll
    for (int i = 0; i < kRowsPerLane4; ++i) wr[i] = wnext[i];
    if (r0 + kChunk4 < k2) load(r0 + kChunk4);

    __syncthreads();  // the previous chunk of x is no longer read
    for (int idx = t; idx < kChunkK * MT; idx += kThreads) {
      const int r = idx / kChunkK, kk = idx % kChunkK;
      const int rr = r0 + kk % kChunk4, row = m0 + r;
      smem[kk * MT + r] =
          (row < m && rr < k2)
              ? lct_to_float(x[(size_t)row * k + (kk / kChunk4) * k2 + rr])
              : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerLane4; ++i) {
      const int rr = kl + i * kKLanes;
      const float* xl = &smem[rr * MT];
      const float* xh = &smem[(kChunk4 + rr) * MT];
      const int b[kColsPerThread] = {wr[i].x, wr[i].y, wr[i].z, wr[i].w};
      float wl[kColsPerThread], wh[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        wl[c] = static_cast<float>(lo_nibble(b[c]));
        wh[c] = static_cast<float>(hi_nibble(b[c]));
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float lo = xl[r], hi = xh[r];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          acc[r][c] = fmaf(hi, wh[c], fmaf(lo, wl[c], acc[r][c]));
        }
      }
    }
  }
  cc_store<TO, MT>(acc, smem, scale, out, m, n, m0, n0, kl, c0);
}

// K6's (kInt4 false) or K10's (true) CUDA-core kernels; k is the logical
// contraction dim for both.
template <bool kInt4, typename TX, typename TO, int MT>
auto cc_kernel() {
  if constexpr (kInt4) {
    return quant4_matmul_kernel<TX, TO, MT>;
  } else {
    return quant_matmul_kernel<TX, TO, MT>;
  }
}

template <bool kInt4, typename TX, typename TO>
int launch(const void* x, const void* w, const void* scale, void* out, int m,
           int k, int n, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  TO* op = static_cast<TO*>(out);
  const int mt = m >= 8 ? 8 : m >= 4 ? 4 : m >= 2 ? 2 : 1;
  const dim3 grid((m + mt - 1) / mt, n / kTileN);
  const auto kernel = mt == 8   ? cc_kernel<kInt4, TX, TO, 8>()
                      : mt == 4 ? cc_kernel<kInt4, TX, TO, 4>()
                      : mt == 2 ? cc_kernel<kInt4, TX, TO, 2>()
                                : cc_kernel<kInt4, TX, TO, 1>();
  kernel<<<grid, kThreads, 0, st>>>(xp, wp, sp, op, m, k, n);
  return 0;
}

template <bool kInt4, typename TX>
int launch_x(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
             int out_dtype, cudaStream_t st) {
  if (out_dtype == LCT_DTYPE_F32) return launch<kInt4, TX, float>(x, w, scale, out, m, k, n, st);
  if (out_dtype == LCT_DTYPE_BF16) {
    return launch<kInt4, TX, __nv_bfloat16>(x, w, scale, out, m, k, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kInt4>
int dispatch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
             int x_dtype, int out_dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n % kTileN || k <= 0 || (kInt4 && k % 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_dtype == LCT_DTYPE_F32) {
    rc = launch_x<kInt4, float>(x, w, scale, out, m, k, n, out_dtype, st);
  } else if (x_dtype == LCT_DTYPE_BF16) {
    rc = launch_x<kInt4, __nv_bfloat16>(x, w, scale, out, m, k, n, out_dtype, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core forms. x: [M, K] float32 or bfloat16 (x_dtype); w: [K, N]
// int8 (K6) or the packed int4 [K/2, N] (K10; K even, the logical
// contraction dim); scale: [N] float32; out: [M, N] float32 or bfloat16
// (out_dtype); all contiguous on the card. N must be a multiple of 32.
extern "C" int lct_quant_matmul(const void* x, const void* w, const void* scale, void* out,
                                int m, int k, int n, int x_dtype, int out_dtype, void* stream) {
  return dispatch<false>(x, w, scale, out, m, k, n, x_dtype, out_dtype, stream);
}

extern "C" int lct_quant4_matmul(const void* x, const void* w, const void* scale, void* out,
                                 int m, int k, int n, int x_dtype, int out_dtype, void* stream) {
  return dispatch<true>(x, w, scale, out, m, k, n, x_dtype, out_dtype, stream);
}

// K6 for bf16 x on the tensor cores: x [M, K] bf16, 16-byte aligned; w [K, N]
// int8, 16-byte aligned; scale [N] float32; out [M, N] float32 or bfloat16
// (out_dtype); all contiguous on the card. N a multiple of 128. The launch
// (ops/kernels/quant_matmul.py: wgmma_tile): mp in {8, 16, 32, 64, 96,
// 128, 192, 256} with M <= mp; splits in {1, 2, 4, 8} with K a multiple of
// 128 * splits; 2 <= stages <= 8.
extern "C" int lct_quant_matmul_wg(const void* x, const void* w, const void* scale, void* out,
                                   int m, int k, int n, int out_dtype, int mp, int splits,
                                   int stages, void* stream) {
  return wgmma::run<false>(x, w, scale, out, m, k, n, out_dtype, mp, splits, stages, stream);
}
