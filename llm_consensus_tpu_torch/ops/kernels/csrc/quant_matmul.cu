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
// The tensor-core form (bf16 x; K a multiple of 128). mma.sync m16n8k16,
// bf16 x bf16 -> float32. One block of 4 warps per (16, 32 or 64 rows of
// M, 32 columns, part z of K). Each 128-row chunk of K is staged in shared
// memory, x as bf16 (rows padded by 16 bytes so the A-fragment loads hit
// distinct banks) and w as int8 (48-byte rows, likewise for the B
// fragments), while the next chunk's loads are in flight in registers.
// Warp v runs the chunk's k16-steps v and v + 4; each weight pair is
// converted to bf16 as its B fragment is built and serves all of the
// block's 16-row tiles. The 4 warps' sums are added in a fixed order
// through shared memory. Decode's products have few 32-column tiles (16
// for wk at M <= 16), so the wrapper cuts K into up to 16 parts until the
// grid holds two blocks per SM; each part writes its float32 sums to a
// workspace and split_reduce_kernel adds the parts in order, scales and
// casts. Results do not change from run to run.
//
// The CUDA-core form (float32 x, and any bf16 x the tensor-core form does
// not take). One block of 256 threads per (tile of up to MT = 8 rows of
// M, 32 columns of N); blockIdx.x walks the M tiles fastest, so the blocks
// that share a column tile run together and the weights are re-read once
// per M tile, from L2 after the first. Each thread owns 4 neighbouring
// columns and reads them as one 4-byte load per weight row; the block's 32
// groups of 8 threads split K (each takes every 32nd row), in chunks of
// 512 rows, the next chunk's loads in flight while x's chunk is staged in
// shared memory as float. The 32 partial sums of each output are added in
// a fixed order. Its float32 products run at the CUDA cores' rate, which
// only the float32 reference models use.
//
// Later work: wgmma with TMA-fed stages for the prefill-sized products, a
// deeper pipeline than one chunk in flight, and a fused epilogue for the
// gate and up products.
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
// tensor-core form in quant4_matmul.cu (wgmma, TMA-fed stages, split-K
// reduced inside a thread-block cluster).

#include "common.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core form (bf16 x): see the note at the top.
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcBN = 32;        // columns a block: 4 n-tiles of 8
constexpr int kTcBK = 128;       // rows of K a chunk: 8 k16-steps, 2 a warp
constexpr int kXPad = 8;         // bf16 per staged x row: spreads the banks
constexpr int kWRow = 48;        // bytes per staged weight row (32 + 16 pad)

// Two small integers as a bf16 pair (exact: |v| <= 127).
__device__ __forceinline__ uint32_t pack_bf16(int lo, int hi) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The tensor-core forms' epilogue: the 4 warps' sums added in a fixed
// order through shared memory (`smem`, at least 4 * BM * kTcBN floats);
// then scale, cast, store, or (ws != nullptr) the float32 partial to
// ws[blockIdx.z] for split_reduce_kernel.
template <typename TO, int MI>
__device__ __forceinline__ void tc_store(const float (&acc)[MI][4][4],
                                         unsigned char* smem,
                                         const float* __restrict__ scale,
                                         TO* __restrict__ out, float* __restrict__ ws,
                                         int m, int n, int m0, int n0) {
  constexpr int BM = 16 * MI;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, tq = lane % 4;
  __syncthreads();  // the last chunk is no longer read
  float* red = reinterpret_cast<float*>(smem);  // [4 warps][BM][kTcBN]
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* r = red + (warp * BM + mi * 16 + g) * kTcBN + nt * 8 + 2 * tq;
      r[0] = acc[mi][nt][0];
      r[1] = acc[mi][nt][1];
      r[8 * kTcBN] = acc[mi][nt][2];
      r[8 * kTcBN + 1] = acc[mi][nt][3];
    }
  }
  __syncthreads();
  for (int idx = t; idx < BM * kTcBN; idx += kTcThreads) {
    const int r = idx / kTcBN, c = idx % kTcBN;
    if (m0 + r >= m) continue;
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) sum += red[(v * BM + r) * kTcBN + c];
    const size_t o = (size_t)(m0 + r) * n + n0 + c;
    if (ws) {
      ws[(size_t)blockIdx.z * m * n + o] = sum;
    } else {
      out[o] = lct_from_float<TO>(sum * scale[n0 + c]);
    }
  }
}

// Grid (M tiles of 16 * MI rows, N / 32, splits). splits == 1: scale,
// cast, store; else the float32 partial goes to ws[z] for
// split_reduce_kernel.
template <typename TO, int MI>
__global__ void __launch_bounds__(kTcThreads)
    quant_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ scale, TO* __restrict__ out,
                           float* __restrict__ ws, int m, int k, int n,
                           int k_split) {
  constexpr int BM = 16 * MI;
  constexpr int kXRow = kTcBK + kXPad;
  constexpr int kXVecs = BM * kTcBK / 8 / kTcThreads;   // uint4 of x a thread
  constexpr int kWVecs = kTcBK * kTcBN / 16 / kTcThreads;  // uint4 of w: 2
  constexpr int kStage = BM * kXRow * 2 + kTcBK * kWRow;
  constexpr int kRed = 4 * BM * kTcBN * 4;
  __shared__ __align__(16) unsigned char smem[kStage > kRed ? kStage : kRed];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + BM * kXRow * 2);

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTcBN;
  const int k_lo = blockIdx.z * k_split, k_hi = min(k, k_lo + k_split);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, tq = lane % 4;

  uint4 xr[kXVecs], wr[kWVecs];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int v = t + i * kTcThreads, row = v / (kTcBK / 8), c = v % (kTcBK / 8);
      xr[i] = m0 + row < m
                  ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * k + k0 + c * 8)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int v = t + i * kTcThreads, row = v / 2, c = v % 2;
      wr[i] = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + row) * n + n0 + c * 16);
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  if (k_lo < k_hi) load(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += kTcBK) {
    __syncthreads();  // the previous chunk is no longer read
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int v = t + i * kTcThreads, row = v / (kTcBK / 8), c = v % (kTcBK / 8);
      *reinterpret_cast<uint4*>(xs + row * kXRow + c * 8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int v = t + i * kTcThreads, row = v / 2, c = v % 2;
      *reinterpret_cast<uint4*>(wsm + row * kWRow + c * 16) = wr[i];
    }
    __syncthreads();
    if (k0 + kTcBK < k_hi) load(k0 + kTcBK);

#pragma unroll
    for (int step = warp; step < kTcBK / 16; step += 4) {
      const int kb = step * 16;
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const __nv_bfloat16* r0 = xs + (mi * 16 + g) * kXRow + kb + 2 * tq;
        const __nv_bfloat16* r8 = r0 + 8 * kXRow;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* wc = wsm + (kb + 2 * tq) * kWRow + nt * 8 + g;
        const uint32_t b0 = pack_bf16(wc[0], wc[kWRow]);
        const uint32_t b1 = pack_bf16(wc[8 * kWRow], wc[9 * kWRow]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) lct_mma_bf16(acc[mi][nt], a[mi], b0, b1);
      }
    }
  }

  tc_store<TO, MI>(acc, smem, scale, out, ws, m, n, m0, n0);
}

// out = cast(scale * (sum over z of ws[z])), z in order.
template <typename TO>
__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ scale,
                                    TO* __restrict__ out, int m, int n,
                                    int splits) {
  const size_t mn = (size_t)m * n;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += ws[z * mn + idx];
  out[idx] = lct_from_float<TO>(sum * scale[idx % n]);
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

// K6's tensor-core kernel; the kernel takes the rows of w a part covers.
template <typename TO>
int launch_tc(const void* x, const void* w, const void* scale, void* out,
              float* ws, int m, int k, int n, int splits, cudaStream_t st) {
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  TO* op = static_cast<TO*>(out);
  float* wsp = splits > 1 ? ws : nullptr;
  const int mi = m <= 16 ? 1 : m <= 32 ? 2 : 4;
  const dim3 grid((m + 16 * mi - 1) / (16 * mi), n / kTcBN, splits);
  const int rows_split = k / splits;
  const auto kernel = mi == 1   ? quant_matmul_tc_kernel<TO, 1>
                      : mi == 2 ? quant_matmul_tc_kernel<TO, 2>
                                : quant_matmul_tc_kernel<TO, 4>;
  kernel<<<grid, kTcThreads, 0, st>>>(xp, wp, sp, op, wsp, m, k, n, rows_split);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    split_reduce_kernel<TO><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, sp, op, m, n, splits);
  }
  return 0;
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
int launch_x(const void* x, const void* w, const void* scale, void* out,
             float* ws, int m, int k, int n, int out_dtype, int splits,
             cudaStream_t st) {
  if constexpr (sizeof(TX) == 2 && !kInt4) {
    if (splits > 0) {
      if (out_dtype == LCT_DTYPE_F32) {
        return launch_tc<float>(x, w, scale, out, ws, m, k, n, splits, st);
      }
      if (out_dtype == LCT_DTYPE_BF16) {
        return launch_tc<__nv_bfloat16>(x, w, scale, out, ws, m, k, n, splits, st);
      }
      return (int)cudaErrorInvalidValue;
    }
  }
  if (out_dtype == LCT_DTYPE_F32) return launch<kInt4, TX, float>(x, w, scale, out, m, k, n, st);
  if (out_dtype == LCT_DTYPE_BF16) {
    return launch<kInt4, TX, __nv_bfloat16>(x, w, scale, out, m, k, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kInt4>
int dispatch(const void* x, const void* w, const void* scale, void* out, void* ws,
             int m, int k, int n, int x_dtype, int out_dtype, int splits,
             void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n % kTileN || k <= 0 || (kInt4 && k % 2)) return (int)cudaErrorInvalidValue;
  if (splits > 0 && (kInt4 || x_dtype != LCT_DTYPE_BF16 || k % (kTcBK * splits) ||
                     (splits > 1 && !ws))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  int rc;
  if (x_dtype == LCT_DTYPE_F32) {
    rc = launch_x<kInt4, float>(x, w, scale, out, wsp, m, k, n, out_dtype, 0, st);
  } else if (x_dtype == LCT_DTYPE_BF16) {
    rc = launch_x<kInt4, __nv_bfloat16>(x, w, scale, out, wsp, m, k, n, out_dtype, splits, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// x: [M, K] float32 or bfloat16 (x_dtype); w: [K, N] int8; scale: [N]
// float32; out: [M, N] float32 or bfloat16 (out_dtype); all contiguous on
// the card. N must be a multiple of 32. splits > 0 (bf16 x only; K a
// multiple of 128 * splits, x 16-byte aligned) selects the tensor-core
// kernel with K cut into `splits` parts; ws is then a float32 workspace of
// splits * M * N elements when splits > 1. splits == 0: the CUDA-core
// kernel.
extern "C" int lct_quant_matmul(const void* x, const void* w,
                                const void* scale, void* out, void* ws,
                                int m, int k, int n, int x_dtype,
                                int out_dtype, int splits, void* stream) {
  return dispatch<false>(x, w, scale, out, ws, m, k, n, x_dtype, out_dtype,
                         splits, stream);
}

// K10's CUDA-core form: as lct_quant_matmul with splits == 0 (the only
// value it takes), w the packed int4 [K/2, N] (K even, the logical
// contraction dim). bf16 x takes lct_quant4_matmul_wg (quant4_matmul.cu).
extern "C" int lct_quant4_matmul(const void* x, const void* w,
                                 const void* scale, void* out, void* ws,
                                 int m, int k, int n, int x_dtype,
                                 int out_dtype, int splits, void* stream) {
  return dispatch<true>(x, w, scale, out, ws, m, k, n, x_dtype, out_dtype,
                        splits, stream);
}
