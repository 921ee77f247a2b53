// K2: causal (prefill) attention with grouped KV heads.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/attention.py
// (flash_causal_attention -> _causal_kernel). Same semantics: index-causal
// mask, softmax and the probability-weighted sum of V in float32, output in
// q's type; the G = H / Hkv query heads of one KV head share every K/V read.
//
// What bounds it on the card: operations. Prefill attention does
// ~4 * B * H * D * S^2 / 2 operations on (B * S * (H + 2 Hkv) * D) input
// elements, far above the H100's ~295 operations per byte once S is in the
// hundreds. This first version runs the products on the CUDA cores in
// float32 (no tensor cores), so it is slow against that bound; a wgmma
// version is later work.
//
// Design. The Pallas body builds the whole [blk_q * G, S] score tile in
// VMEM; on Hopper a block has at most 227 KB of shared memory, so this
// kernel walks the keys in tiles of kBK with an online (flash) softmax
// instead, which gives the same result without the score tile. One block
// per (batch, kv head, tile of BQ query positions); its BQ * G query rows
// (all G heads of the KV head) share each K/V tile, which the block stages
// once in shared memory as float32. kTPR = D / 32 neighbouring threads own
// one query row, each keeping 32 of its dimensions (interleaved, so the
// threads of a row read neighbouring shared-memory words) for q and for
// the running output in registers; a row's partial dot products are summed
// with warp shuffles. Key tiles past the block's last query are skipped.

#include "common.cuh"

namespace {

constexpr int kBK = 16;          // keys per shared-memory tile
constexpr int kMaxThreads = 512;  // BQ * G * kTPR <= this (wrapper checks)

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
    causal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int s, int h, int hkv, int bq, float scale) {
  constexpr int kTPR = D >= 32 ? D / 32 : 1;  // threads per query row
  constexpr int kDPT = D / kTPR;               // dims per thread
  __shared__ float ks[kBK][D];
  __shared__ float vs[kBK][D];

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
    qr[e] = valid_row ? lct_to_float(q[q_off + e * kTPR + part]) * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int last_q = min(q0 + bq, s) - 1;
  const int n_tiles = last_q / kBK + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBK * D; idx += nthreads) {
      const int j = idx / D, dd = idx % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < s) {
        const size_t off = (((size_t)b * s + key) * hkv + kvh) * D + dd;
        kv = lct_to_float(k[off]);
        vv = lct_to_float(v[off]);
      }
      ks[j][dd] = kv;
      vs[j][dd] = vv;
    }
    __syncthreads();

    float sc[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
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
    for (int j = 0; j < kBK; ++j) {
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
    for (int e = 0; e < kDPT; ++e) {
      out[q_off + e * kTPR + part] = lct_from_float<T>(acc[e] * inv_l);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, int b,
            int s, int h, int hkv, int bq, float scale, cudaStream_t stream) {
  constexpr int kTPR = D >= 32 ? D / 32 : 1;
  const int g_count = h / hkv;
  dim3 grid((s + bq - 1) / bq, hkv, b);
  causal_attention_kernel<T, D><<<grid, bq * g_count * kTPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, hkv, bq, scale);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int b,
               int s, int h, int hkv, int d, int bq, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(q, k, v, out, b, s, h, hkv, bq, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, out, b, s, h, hkv, bq, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, out, b, s, h, hkv, bq, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, out, b, s, h, hkv, bq, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q: [B, S, H, D]; k, v: [B, S, Hkv, D]; out: [B, S, H, D]; all contiguous.
// bq: query positions per block, with bq * (H / Hkv) * max(1, D / 32) <= 512.
extern "C" int lct_causal_attention(const void* q, const void* k,
                                    const void* v, void* out, int b, int s,
                                    int h, int hkv, int d, int bq, float scale,
                                    int dtype, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == LCT_DTYPE_F32) {
    rc = dispatch_d<float>(q, k, v, out, b, s, h, hkv, d, bq, scale, st);
  } else if (dtype == LCT_DTYPE_BF16) {
    rc = dispatch_d<__nv_bfloat16>(q, k, v, out, b, s, h, hkv, d, bq, scale, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
