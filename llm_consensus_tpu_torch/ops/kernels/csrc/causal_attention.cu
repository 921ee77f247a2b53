// K2: causal (prefill) attention with grouped KV heads.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/attention.py
// (flash_causal_attention -> _causal_kernel). Same semantics: index-causal
// mask, the softmax scale applied to float32 scores, softmax and the
// probability-weighted sum of V in float32, output in q's type; the
// G = H / Hkv query heads of one KV head share every K/V read.
//
// What bounds it on the card. Prefill attention does ~4 * B * H * D * S^2 / 2
// operations on B * S * (2 H + 2 Hkv) * D elements moved. At llama-1b's
// heads (16 / 8 / 128) that is ~S / 3 operations per bf16 byte: below the
// H100's ~295 at S = 256 (bytes-bound), far above it at the panel's
// 2048-token bucket (bound by the tensor cores' operations).
//
// Two kernels, picked by the wrapper from the inputs' type.
//
// bf16 (causal_attention_tc_kernel): the tensor cores, mma.sync m16n8k16.
// The block's rows are (query position, head of the group) pairs, flattened
// as position * G + head, so one block serves all G heads of its KV head
// whatever G is and every K/V tile it stages is shared by them. One block
// of 4 warps per (batch, KV head, 64 rows); each warp owns 16 rows, the M of
// the product, with its Q fragments in registers (loaded once). Keys come in
// tiles of kBK = 64, kept bf16 in dynamic shared memory (rows padded by 16
// bytes, so the ldmatrix row reads hit distinct banks) and copied with
// 16-byte cp.async in two stages: tile t + 1 is in flight while tile t is
// multiplied. Per tile a warp computes its 16 x 64 scores on the tensor
// cores (K fragments by ldmatrix), scales them in float32 by scale * log2(e),
// masks only in the tile that crosses its diagonal, and updates the online
// softmax on the accumulator fragments (row max over the quad by two
// shuffles, exp2f; the row sums stay per lane until the end). P stays float32
// in value: it is written as hi = bf16(P) and lo = bf16(P - hi), and both
// go through P * V (V fragments by ldmatrix.trans) into the same float32
// accumulators, which keeps ~16 bits of P. Rounding P to bf16 alone (the
// usual FlashAttention-2 recipe) misses the one-bf16-ulp tolerance against
// the float32 reference by ~100x; the split holds it. Q * K^T on bf16
// inputs with float32 accumulation has exact products and needs no split.
// Key tiles wholly above a warp's last row are skipped; a ragged last key
// tile is zero-filled by cp.async and masked. Blocks are issued longest
// first. mma.sync was built rather than wgmma: it takes 16-row warp tiles
// whatever G is, and at S = 256 the kernel is bound by bytes, where the
// instruction is not the limit. wgmma with TMA-fed stages (64-row warpgroup
// tiles, a producer warp) is the next step for the long buckets.
//
// float32 (causal_attention_f32_kernel): the parity path of the reference
// check, held to 1e-4 absolute, which TF32 or a bf16 split of q and k would
// not hold: the products on the CUDA cores in float32. One block per
// (batch, kv head, tile of BQ query positions); its BQ * G query rows share
// each K/V tile of kBKF keys, staged in shared memory. kTPR = D / 32
// neighbouring threads own one query row, each keeping 32 of its dimensions
// (interleaved, so the threads of a row read neighbouring shared-memory
// words) for q and for the running output in registers; a row's partial dot
// products are summed with warp shuffles. Key tiles past the block's last
// query are skipped.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBK = 64;     // keys per tile
constexpr int kStages = 2;  // tiles in shared memory: one copied while one is read
constexpr int kWarps = 4;   // 16 rows each: 64 rows a block (causal_tile_bf16)

template <int D>
constexpr int tc_smem_bytes() {  // ops/kernels/attention.py: causal_tile_bf16
  return kStages * 2 * kBK * (D + 8) * (int)sizeof(__nv_bfloat16);
}

// (a, b) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), low half first.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    causal_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int s, int h,
                               int hkv, float scale_log2) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = kWarps * 16;
  constexpr int kStride = D + 8;        // bf16 per staged key row
  constexpr int kTile = kBK * kStride;  // bf16 per staged K (or V) tile
  constexpr int kKS = D / 16;           // k16-steps of Q * K^T
  constexpr int kND = D / 8;            // n8-tiles of the output
  constexpr int kRowChunks = D / 8;     // 16-byte chunks per key row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][key][kStride]
  __nv_bfloat16* vs = ks + kStages * kTile;

  const int G = h / hkv;
  const int rows = s * G;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;

  // This warp's 16 rows; the lane's are rA and rB = rA + 8.
  const int wrow0 = row0 + warp * 16;
  const bool warp_live = wrow0 < rows;
  const int wq_lo = wrow0 / G;
  const int wq_hi = min(wrow0 + 15, rows - 1) / G;
  const int rA = wrow0 + g, rB = rA + 8;
  const bool vA = rA < rows, vB = rB < rows;
  const int qA = rA / G, qB = rB / G;
  const size_t offA = (((size_t)b * s + qA) * h + kvh * G + rA % G) * D;
  const size_t offB = (((size_t)b * s + qB) * h + kvh * G + rB % G) * D;

  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = vA ? *reinterpret_cast<const uint32_t*>(q + offA + c) : 0u;
    qf[kk][1] = vB ? *reinterpret_cast<const uint32_t*>(q + offB + c) : 0u;
    qf[kk][2] = vA ? *reinterpret_cast<const uint32_t*>(q + offA + c + 8) : 0u;
    qf[kk][3] = vB ? *reinterpret_cast<const uint32_t*>(q + offB + c + 8) : 0u;
  }

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;

  const size_t key_stride = (size_t)hkv * D;
  const __nv_bfloat16* kb = k + ((size_t)b * s * hkv + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * s * hkv + kvh) * D;
  auto load = [&](int tile) {
    const int k0 = tile * kBK;
    __nv_bfloat16* kd = ks + (tile % kStages) * kTile;
    __nv_bfloat16* vd = vs + (tile % kStages) * kTile;
#pragma unroll
    for (int i = tid; i < kBK * kRowChunks; i += kThreads) {
      const int key = i / kRowChunks, c = (i % kRowChunks) * 8;
      const bool in = k0 + key < s;
      const size_t src = in ? (size_t)(k0 + key) * key_stride + c : 0;
      lct_cp_async16(kd + key * kStride + c, kb + src, in);
      lct_cp_async16(vd + key * kStride + c, vb + src, in);
    }
    lct_cp_async_commit();
  };

  const int last_q = (min(row0 + kRows, rows) - 1) / G;
  const int n_tiles = last_q / kBK + 1;
  load(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load(tile + 1);  // its stage was last read before the previous barrier
      lct_cp_async_wait<1>();
    } else {
      lct_cp_async_wait<0>();
    }
    __syncthreads();  // tile `tile` has landed for every thread
    const int k0 = tile * kBK;
    if (warp_live && k0 <= wq_hi) {
      const __nv_bfloat16* kt = ks + (tile % kStages) * kTile;
      const __nv_bfloat16* vt = vs + (tile % kStages) * kTile;

      // Scores: 8 n8-tiles of keys.
      float sc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t r[4];
          const int key = (2 * n2 + lane / 16) * 8 + lane % 8;
          lct_ldmatrix_x4(r, kt + key * kStride + kk * 16 + ((lane / 8) % 2) * 8);
          lct_mma_bf16(sc[2 * n2], qf[kk], r[0], r[1]);
          lct_mma_bf16(sc[2 * n2 + 1], qf[kk], r[2], r[3]);
        }
      }

      // Scale, mask (only the tile that crosses the warp's diagonal), max.
      const bool diagonal = k0 + kBK - 1 > wq_lo;
      float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nt][e] * scale_log2;
          if (diagonal && k0 + nt * 8 + 2 * t4 + (e & 1) > (e < 2 ? qA : qB)) x = -INFINITY;
          sc[nt][e] = x;
        }
        xA = fmaxf(xA, fmaxf(sc[nt][0], sc[nt][1]));
        xB = fmaxf(xB, fmaxf(sc[nt][2], sc[nt][3]));
      }
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
      // Tile 0 holds key 0, which every row sees: the maxima are finite
      // from the first tile on, and exp2f(-inf) = 0 rescales nothing away.
      const float nA = fmaxf(mA, xA), nB = fmaxf(mB, xB);
      const float aA = exp2f(mA - nA), aB = exp2f(mB - nB);
      mA = nA;
      mB = nB;
      lA *= aA;
      lB *= aB;
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        o[nd][0] *= aA;
        o[nd][1] *= aA;
        o[nd][2] *= aB;
        o[nd][3] *= aB;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        sc[nt][0] = exp2f(sc[nt][0] - mA);
        sc[nt][1] = exp2f(sc[nt][1] - mA);
        sc[nt][2] = exp2f(sc[nt][2] - mB);
        sc[nt][3] = exp2f(sc[nt][3] - mB);
        lA += sc[nt][0] + sc[nt][1];
        lB += sc[nt][2] + sc[nt][3];
      }

      // O += P * V, P as hi + lo bf16. The score fragments of n8-tiles
      // 2j and 2j + 1 are the A fragment of keys [16j, 16j + 16).
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t ph[4], pl[4];
        split_bf16x2(sc[2 * j][0], sc[2 * j][1], ph[0], pl[0]);
        split_bf16x2(sc[2 * j][2], sc[2 * j][3], ph[1], pl[1]);
        split_bf16x2(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pl[2]);
        split_bf16x2(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pl[3]);
        const int key = j * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int p2 = 0; p2 < kND / 2; ++p2) {
          uint32_t r[4];
          lct_ldmatrix_x4_trans(r, vt + key * kStride + (2 * p2 + lane / 16) * 8);
          lct_mma_bf16(o[2 * p2], ph, r[0], r[1]);
          lct_mma_bf16(o[2 * p2], pl, r[0], r[1]);
          lct_mma_bf16(o[2 * p2 + 1], ph, r[2], r[3]);
          lct_mma_bf16(o[2 * p2 + 1], pl, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the stage is read by every warp before it is refilled
  }

  if (!warp_live) return;
  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  const float iA = 1.f / lA, iB = 1.f / lB;
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) {
    const int c = nd * 8 + 2 * t4;
    if (vA) {
      *reinterpret_cast<__nv_bfloat162*>(out + offA + c) =
          __floats2bfloat162_rn(o[nd][0] * iA, o[nd][1] * iA);
    }
    if (vB) {
      *reinterpret_cast<__nv_bfloat162*>(out + offB + c) =
          __floats2bfloat162_rn(o[nd][2] * iB, o[nd][3] * iB);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b,
              int s, int h, int hkv, float scale, cudaStream_t stream) {
  constexpr int kSmem = tc_smem_bytes<D>();
  auto kernel = causal_attention_tc_kernel<D>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (rc != cudaSuccess) return (int)rc;
  constexpr int kRows = kWarps * 16;
  const int rows = s * (h / hkv);
  dim3 grid((rows + kRows - 1) / kRows, hkv, b);
  kernel<<<grid, kWarps * 32, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s,
      h, hkv, scale * 1.4426950408889634f);
  return 0;
}

int dispatch_tc(const void* q, const void* k, const void* v, void* out, int b,
                int s, int h, int hkv, int d, int rows, float scale,
                cudaStream_t stream) {
  if (rows != kWarps * 16) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_tc<16>(q, k, v, out, b, s, h, hkv, scale, stream);
    case 32: return launch_tc<32>(q, k, v, out, b, s, h, hkv, scale, stream);
    case 64: return launch_tc<64>(q, k, v, out, b, s, h, hkv, scale, stream);
    case 128: return launch_tc<128>(q, k, v, out, b, s, h, hkv, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBKF = 16;          // keys per shared-memory tile
constexpr int kMaxThreads = 512;  // BQ * G * kTPR <= this (wrapper checks)

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
    causal_attention_f32_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ out, int s, int h, int hkv,
                                int bq, float scale) {
  constexpr int kTPR = D >= 32 ? D / 32 : 1;  // threads per query row
  constexpr int kDPT = D / kTPR;               // dims per thread
  __shared__ float ks[kBKF][D];
  __shared__ float vs[kBKF][D];

  const int g_count = h / hkv;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int row = tid / kTPR, part = tid % kTPR;
  const int qpos = q0 + row / g_count;
  const int head = kvh * g_count + row % g_count;
  const bool valid_row = qpos < s;

  float qr[kDPT], acc[kDPT];
  const size_t q_off = (((size_t)b * s + qpos) * h + head) * D;
#pragma unroll
  for (int e = 0; e < kDPT; ++e) {
    qr[e] = valid_row ? q[q_off + e * kTPR + part] * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int last_q = min(q0 + bq, s) - 1;
  const int n_tiles = last_q / kBKF + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBKF;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBKF * D; idx += nthreads) {
      const int j = idx / D, dd = idx % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < s) {
        const size_t off = (((size_t)b * s + key) * hkv + kvh) * D + dd;
        kv = k[off];
        vv = v[off];
      }
      ks[j][dd] = kv;
      vs[j][dd] = vv;
    }
    __syncthreads();

    float sc[kBKF];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < kDPT; ++e) p += qr[e] * ks[j][e * kTPR + part];
      p = lct_group_sum<kTPR>(p);
      const int key = k0 + j;
      sc[j] = (valid_row && key <= qpos) ? p : -INFINITY;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // nothing visible to this row yet
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      const float p = (sc[j] == -INFINITY) ? 0.f : expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int e = 0; e < kDPT; ++e) acc[e] += p * vs[j][e * kTPR + part];
    }
    m = m_new;
  }

  if (valid_row) {
    const float inv_l = 1.f / l;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) out[q_off + e * kTPR + part] = acc[e] * inv_l;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int s, int h, int hkv, int bq, float scale, cudaStream_t stream) {
  constexpr int kTPR = D >= 32 ? D / 32 : 1;
  const int g_count = h / hkv;
  dim3 grid((s + bq - 1) / bq, hkv, b);
  causal_attention_f32_kernel<D><<<grid, bq * g_count * kTPR, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, h, hkv, bq, scale);
  return 0;
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out, int b,
                 int s, int h, int hkv, int d, int bq, float scale,
                 cudaStream_t stream) {
  switch (d) {
    case 16: return launch_f32<16>(q, k, v, out, b, s, h, hkv, bq, scale, stream);
    case 32: return launch_f32<32>(q, k, v, out, b, s, h, hkv, bq, scale, stream);
    case 64: return launch_f32<64>(q, k, v, out, b, s, h, hkv, bq, scale, stream);
    case 128: return launch_f32<128>(q, k, v, out, b, s, h, hkv, bq, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, S, H, D]; k, v: [B, S, Hkv, D]; out: [B, S, H, D]; all contiguous
// (bf16: 16-byte aligned). tile: for float32 the query positions per block,
// with tile * (H / Hkv) * max(1, D / 32) <= 512 (causal_block_q); for bf16
// the (position, head) rows per block, 64 (causal_tile_bf16).
extern "C" int lct_causal_attention(const void* q, const void* k,
                                    const void* v, void* out, int b, int s,
                                    int h, int hkv, int d, int tile, float scale,
                                    int dtype, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == LCT_DTYPE_F32) {
    rc = dispatch_f32(q, k, v, out, b, s, h, hkv, d, tile, scale, st);
  } else if (dtype == LCT_DTYPE_BF16) {
    rc = dispatch_tc(q, k, v, out, b, s, h, hkv, d, tile, scale, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
