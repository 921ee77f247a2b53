// The split-KV decode pass: one-token decode attention over a KV cache,
// templated on the cache's layout. Two caches use it:
//
// - Dense<T>: the token-major cache [B, S_max, Hkv, D] in q's type (float32
//   or bfloat16), no scales. K3 (decode_attention.cu).
// - Q8: the head-major int8 cache [B, Hkv, S_max, D] with a float32 scale
//   per slot [B, Hkv, S_max]; the K scale folds into the scores and the V
//   scale into the value product only (p * v_scale), the denominator stays
//   the true sum of p. K4 and K5 (decode_attention_q8.cu).
//
// Semantics (both): q [B, 1, H, D]; query head h reads kv head h / G;
// scores are q . k times d^-1/2; slots >= valid_len[b] are masked; the
// softmax and the weighted sum of V run in float32; output in q's type. A
// row with valid_len 0 gives zeros.
//
// What bounds it on the card: bytes. A slot costs 2 * D * sizeof(T) bytes
// per kv head on the dense cache (2 * (D + 4) on the int8 one) for ~4 * G
// operations an element: far below the ridge, so tensor cores would buy
// nothing. What matters is having enough bytes in flight on every SM
// (Little's law: ~20 KB an SM to keep 3.35 TB/s moving) and enough blocks
// to reach every SM at decode's small batches.
//
// Design. Grid (Hkv, B, n_split): a block takes one contiguous span of
// slots of one (row, kv head) and serves all G query heads of the kv head
// from one read. n_split and the span (a whole number of 32-slot chunks, at
// least 128 slots) come from the host-known shapes only
// (ops/kernels/attention.py: decode_splits), never from valid_len, which
// lives on the card: a block whose span starts past its row's valid_len
// writes an empty partial (max -inf, sum 0) and exits.
//
// A block is 4 warps, each an independent pipeline: warp w takes chunks w,
// w + 4, ... of the span through its own ring of stages (the K and V rows
// of 32 slots, and the int8 cache's scales), filled by its own lanes with
// 16-byte cp.async (4-byte for the scales; on the token-major dense cache
// each lane copies its own pieces of rows Hkv * D elements apart) and
// tracked by one mbarrier a stage that each lane's copies arrive on. The
// ring has two stages wherever 4 warps' worth fits in 128 KB, so that a
// warp's next chunk is in flight while it scores one (every int8 shape,
// bf16 up to D = 64, float32 up to D = 32), else one, and then the chunks
// in flight while a warp scores are the other resident warps'. A stage is
// 16.9 KB at D = 128 in bf16 and 8.8 KB in int8: a bf16 block of one
// stage a warp holds ~70 KB, as an int8 block of two does, three blocks an
// SM; two bf16 stages a warp (~135 KB, one block an SM) left each SM 4
// warps that score one after another and timed slower on the H100 (PERF.md
// §6). The host's split rule aims at two blocks an SM where the shared
// memory holds them (one for float32 at D = 128). Every warp works
// whatever G is. A chunk is scored with lane s scoring slot s
// for every head (K rows padded by 16 bytes so the 32 lanes' 16-byte reads
// hit distinct banks; int8 to float by a byte permute and an add, bf16 by
// a shift), one max reduction and one exp a lane a chunk, then P * V from
// shared memory with lane i holding dimensions D/32 * i onwards and p
// (times the V scale) read back four slots at a time. The warps' states
// merge by log-sum-exp through shared memory. With n_split > 1 each block
// writes its (max, sum, unnormalised output) to a float32 workspace and a
// second small launch merges the splits in split order, so a result does
// not change from run to run; it is launched as a programmatic dependent
// (its blocks wait on the split pass with griddepcontrol.wait), which
// hides its launch. With one split the block writes the output itself.
#pragma once

#include "common.cuh"

namespace {
namespace kv_split {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;               // slots a stage: one lane a slot
constexpr int kRingBudget = 128 * 1024;  // bytes of ring that allow two stages a warp

struct Args {
  const void* q;
  const void* k;
  const float* ks;  // int8 cache: [B, Hkv, S_max] scales; else null
  const void* v;
  const float* vs;
  const int* valid_len;
  void* out;
  // n_split > 1: [n_split, B * H] max and sum, [n_split, B * H, D] output.
  float* pm;
  float* pl;
  float* pacc;
  int b, s_max, hkv, span, n_split;
  float scale;
};

// Four int8 values (one 32-bit word) as floats, exactly: each byte, biased
// to unsigned, becomes the low mantissa byte of 2^23, and one add takes
// 2^23 + 128 off. A byte permute and an add a value, where a conversion
// instruction runs at a quarter of the add's rate.
__device__ __forceinline__ void i8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// The two bf16 values of a 32-bit word as floats (exact: a shift, a mask).
__device__ __forceinline__ void bf16x2_to_float(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}

// The int8 head-major cache: row (b, kvh, slot) at ((b * Hkv + kvh) *
// S_max + slot) * D, its scales at the same row index.
struct Q8 {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  __device__ static size_t row(int b, int kvh, int slot, int s_max, int hkv) {
    return ((size_t)b * hkv + kvh) * s_max + slot;
  }
  __device__ static void unpack16(const uint4& w, float* f) {
    i8x4_to_float(w.x, f);
    i8x4_to_float(w.y, f + 4);
    i8x4_to_float(w.z, f + 8);
    i8x4_to_float(w.w, f + 12);
  }
  // The kDPL dimensions from lane * kDPL of a staged row, as floats.
  template <int D>
  __device__ static void load_share(const int8_t* row, int lane, float* r) {
    constexpr int kDPL = (D + 31) / 32;
    const int d0 = lane * kDPL;
    if (d0 >= D) {  // D = 16: lanes 16..31 hold nothing
#pragma unroll
      for (int e = 0; e < kDPL; ++e) r[e] = 0.f;
      return;
    }
    if constexpr (kDPL == 4) {
      i8x4_to_float(*reinterpret_cast<const uint32_t*>(row + d0), r);
    } else if constexpr (kDPL == 2) {
      const char2 c = *reinterpret_cast<const char2*>(row + d0);
      r[0] = c.x;
      r[1] = c.y;
    } else {
      r[0] = row[d0];
    }
  }
};

// The dense token-major cache of E (float or __nv_bfloat16): row (b, kvh,
// slot) at ((b * S_max + slot) * Hkv + kvh) * D.
template <typename E>
struct Dense {
  using Elem = E;
  static constexpr bool kScaled = false;
  __device__ static size_t row(int b, int kvh, int slot, int s_max, int hkv) {
    return ((size_t)b * s_max + slot) * hkv + kvh;
  }
  __device__ static void unpack16(const uint4& w, float* f) {
    if constexpr (sizeof(E) == 4) {
      f[0] = __uint_as_float(w.x);
      f[1] = __uint_as_float(w.y);
      f[2] = __uint_as_float(w.z);
      f[3] = __uint_as_float(w.w);
    } else {
      bf16x2_to_float(w.x, f);
      bf16x2_to_float(w.y, f + 2);
      bf16x2_to_float(w.z, f + 4);
      bf16x2_to_float(w.w, f + 6);
    }
  }
  template <int D>
  __device__ static void load_share(const E* row, int lane, float* r) {
    constexpr int kDPL = (D + 31) / 32;
    const int d0 = lane * kDPL;
    if (d0 >= D) {
#pragma unroll
      for (int e = 0; e < kDPL; ++e) r[e] = 0.f;
      return;
    }
    if constexpr (sizeof(E) == 4) {
      if constexpr (kDPL == 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + d0);
        r[0] = v.x;
        r[1] = v.y;
        r[2] = v.z;
        r[3] = v.w;
      } else if constexpr (kDPL == 2) {
        const float2 v = *reinterpret_cast<const float2*>(row + d0);
        r[0] = v.x;
        r[1] = v.y;
      } else {
        r[0] = lct_to_float(row[d0]);
      }
    } else {
      if constexpr (kDPL == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + d0);
        bf16x2_to_float(v.x, r);
        bf16x2_to_float(v.y, r + 2);
      } else if constexpr (kDPL == 2) {
        bf16x2_to_float(*reinterpret_cast<const uint32_t*>(row + d0), r);
      } else {
        r[0] = lct_to_float(row[d0]);
      }
    }
  }
};

// A stage: the K rows (padded by one 16-byte vector, for the banks) and V
// rows of 32 slots, and for the int8 cache their scales.
template <typename Cache, int D>
struct __align__(16) Stage {
  using E = typename Cache::Elem;
  static constexpr int kPerVec = 16 / (int)sizeof(E);  // elements a 16-byte vector
  E k[kChunk][D + kPerVec];
  E v[kChunk][D];
  float ks[Cache::kScaled ? kChunk : 1];
  float vs[Cache::kScaled ? kChunk : 1];
};

// Stages a warp's ring holds: two (one in flight while one is scored)
// where 4 warps' worth fits the budget, else one.
template <typename Cache, int D>
__host__ __device__ constexpr int ring_stages() {
  return kWarps * 2 * (int)sizeof(Stage<Cache, D>) <= kRingBudget ? 2 : 1;
}

// Dynamic shared memory of a block: each warp's ring, then q, then each
// warp's probabilities (times the V scale) for the chunk it scores, then
// the ring's barriers.
template <typename Cache, int D, int G>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int kS = ring_stages<Cache, D>();
  return kWarps * kS * (int)sizeof(Stage<Cache, D>) + G * D * 4 + kWarps * G * kChunk * 4 +
         kWarps * kS * 8;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename Cache, typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  using E = typename Cache::Elem;
  using St = Stage<Cache, D>;
  constexpr int kS = ring_stages<Cache, D>();
  constexpr int kDPL = (D + 31) / 32;      // V dimensions a lane holds
  constexpr int kPerVec = St::kPerVec;     // elements a 16-byte vector
  constexpr int kVec = D / kPerVec;        // 16-byte vectors in a row
  constexpr int kQ4 = kPerVec / 4;         // float4s of q a vector meets
  extern __shared__ __align__(16) unsigned char smem[];
  St* ring = reinterpret_cast<St*>(smem);  // [warp][stage]
  float(*sq)[D] = reinterpret_cast<float(*)[D]>(smem + kWarps * kS * sizeof(St));
  float(*sp)[G][kChunk] = reinterpret_cast<float(*)[G][kChunk]>(&sq[G][0]);  // [warp]
  uint64_t* full = reinterpret_cast<uint64_t*>(&sp[kWarps][0][0]);           // [warp][stage]

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int h = a.hkv * G;
  const size_t head0 = (size_t)b * h + kvh * G;  // first query head
  const size_t bh = (size_t)a.b * h;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const T* q = static_cast<const T*>(a.q);
  const E* kc = static_cast<const E*>(a.k);
  const E* vc = static_cast<const E*>(a.v);
  T* out = static_cast<T*>(a.out);
  // q is read before valid_len is known, so the two loads overlap.
  float qv[(G * D + kThreads - 1) / kThreads];
#pragma unroll
  for (int r = 0; r < (G * D + kThreads - 1) / kThreads; ++r) {
    const int i = t + r * kThreads;
    qv[r] = i < G * D ? lct_to_float(q[head0 * D + i]) * a.scale : 0.f;
  }
  const int n = min(max(a.valid_len[b], 0), a.s_max);
  const int lo = split * a.span, hi = min(n, lo + a.span);

  if (lo >= hi) {  // nothing to read (block-uniform): an empty partial
    if (a.n_split > 1) {
      for (int g = t; g < G; g += kThreads) {
        a.pm[split * bh + head0 + g] = -INFINITY;
        a.pl[split * bh + head0 + g] = 0.f;
      }
    } else {
      for (int i = t; i < G * D; i += kThreads) out[head0 * D + i] = lct_from_float<T>(0.f);
    }
    return;
  }

#pragma unroll
  for (int r = 0; r < (G * D + kThreads - 1) / kThreads; ++r) {
    const int i = t + r * kThreads;
    if (i < G * D) sq[i / D][i % D] = qv[r];
  }
  if (lane < kS) lct_mbar_init(&full[warp * kS + lane], 32);
  lct_mbar_init_fence();
  __syncthreads();

  // Warp w takes chunks w, w + 4, ... of the block's span, through its own
  // ring: its lanes fill its stages and it alone reads them.
  const int n_chunks = (hi - lo + kChunk - 1) / kChunk;
  const int my_chunks = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  St* my_ring = ring + warp * kS;
  uint64_t* my_full = full + warp * kS;
  // The warp's i-th chunk into its stage i % kS; each lane arrives once a
  // fill, when its copies have landed; slots past hi are zero-filled.
  auto fill = [&](int i) {
    St& st = my_ring[i % kS];
    const int c0 = lo + (warp + i * kWarps) * kChunk, nc = min(kChunk, hi - c0);
#pragma unroll
    for (int j = lane; j < kChunk * kVec; j += 32) {
      const int s = j / kVec, v = j % kVec;
      const size_t off =
          Cache::row(b, kvh, c0 + min(s, nc - 1), a.s_max, a.hkv) * D + v * kPerVec;
      lct_cp_async16(&st.k[s][v * kPerVec], kc + off, s < nc);
      lct_cp_async16(&st.v[s][v * kPerVec], vc + off, s < nc);
    }
    if constexpr (Cache::kScaled) {
      const size_t so = Cache::row(b, kvh, c0 + min(lane, nc - 1), a.s_max, a.hkv);
      lct_cp_async4(&st.ks[lane], a.ks + so, lane < nc);
      lct_cp_async4(&st.vs[lane], a.vs + so, lane < nc);
    }
    lct_cp_async_mbar_arrive(&my_full[i % kS]);
  };

  // Per head: running max (warp-uniform), this lane's share of the running
  // sum, and the output dimensions this lane holds.
  float m[G], l[G], acc[G][kDPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < kS - 1 && i < my_chunks; ++i) fill(i);
  for (int i = 0; i < my_chunks; ++i) {
    __syncwarp();  // every lane is done with the stage the next fill takes
    if (i + kS - 1 < my_chunks) fill(i + kS - 1);
    lct_mbar_wait(&my_full[i % kS], (i / kS) & 1);
    const St& st = my_ring[i % kS];
    const int nc = min(kChunk, hi - (lo + (warp + i * kWarps) * kChunk));

    // Lane s scores slot s for every head, in four partial sums a head (so
    // the adds do not form one chain of D dependent instructions).
    float sc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[g][u] = 0.f;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      float kf[kPerVec];
      Cache::unpack16(*reinterpret_cast<const uint4*>(&st.k[lane][v * kPerVec]), kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4* qq = reinterpret_cast<const float4*>(&sq[g][v * kPerVec]);
#pragma unroll
        for (int u = 0; u < kQ4; ++u) {
          const float4 q4 = qq[u];
          sc[g][(v * kQ4 + u) % 4] += q4.x * kf[4 * u] + q4.y * kf[4 * u + 1] +
                                      q4.z * kf[4 * u + 2] + q4.w * kf[4 * u + 3];
        }
      }
    }
    float ksc = 1.f, vsc = 1.f;  // the int8 cache's scales of this lane's slot
    if constexpr (Cache::kScaled) {
      ksc = st.ks[lane];
      vsc = st.vs[lane];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float dot = (sc[g][0] + sc[g][1]) + (sc[g][2] + sc[g][3]);
      const float s_lane = lane < nc ? (Cache::kScaled ? dot * ksc : dot) : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(s_lane));  // lane 0's slot is valid
      const float alpha = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = lane < nc ? expf(s_lane - m_new) : 0.f;
      l[g] = l[g] * alpha + p;
      // The V scale folds into the value product only.
      sp[warp][g][lane] = Cache::kScaled ? p * vsc : p;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) acc[g][e] *= alpha;
      m[g] = m_new;
    }
    __syncwarp();
    for (int s0 = 0; s0 < nc; s0 += 4) {
      float vr[4][kDPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) Cache::template load_share<D>(st.v[s0 + u], lane, vr[u]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sp[warp][g][s0]);
#pragma unroll
        for (int e = 0; e < kDPL; ++e) {
          acc[g][e] += p4.x * vr[0][e] + p4.y * vr[1][e] + p4.z * vr[2][e] + p4.w * vr[3][e];
        }
      }
    }
  }
  // The merge launch (if any) may start arriving; it waits for this grid.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // The 4 warps' states merged by log-sum-exp through shared memory (the
  // rings are no longer read).
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [warp][G]
  float* wl = wm + kWarps * G;                 // [warp][G]
  float* wacc = wl + kWarps * G;               // [warp][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float l_tot = lct_group_sum<32>(l[g]);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l_tot;
    }
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = lane * kDPL + e;
      if (d < D) wacc[(warp * G + g) * D + d] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = t; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float tot_l = 0.f, tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (wm[w * G + g] == -INFINITY) continue;  // a warp that had no chunk
      const float c = expf(wm[w * G + g] - mx);
      tot_l += wl[w * G + g] * c;
      tot += wacc[(w * G + g) * D + d] * c;
    }
    const size_t head = head0 + g;
    if (a.n_split == 1) {
      out[head * D + d] = lct_from_float<T>(tot_l > 0.f ? tot / tot_l : 0.f);
    } else {
      if (d == 0) {
        a.pm[split * bh + head] = mx;
        a.pl[split * bh + head] = tot_l;
      }
      a.pacc[(split * bh + head) * D + d] = tot;
    }
  }
}

// The splits of each (row, head) merged by log-sum-exp, in split order. One
// block of D threads per query head; empty splits (max -inf) are skipped.
// Launched as a programmatic dependent of the split pass: its blocks may
// be resident early and wait here for that grid to finish and flush.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_merge_kernel(Args a, int h) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t head = blockIdx.x, bh = (size_t)a.b * h;
  const int d = threadIdx.x;
  float mx = -INFINITY;
#pragma unroll 8
  for (int sp = 0; sp < a.n_split; ++sp) mx = fmaxf(mx, a.pm[sp * bh + head]);
  float tot_l = 0.f, tot = 0.f;
  if (mx != -INFINITY) {
#pragma unroll 8
    for (int sp = 0; sp < a.n_split; ++sp) {
      const float pm = a.pm[sp * bh + head];
      const float c = pm == -INFINITY ? 0.f : expf(pm - mx);
      tot_l += a.pl[sp * bh + head] * c;
      tot += (pm == -INFINITY ? 0.f : a.pacc[(sp * bh + head) * D + d]) * c;
    }
  }
  static_cast<T*>(a.out)[head * D + d] = lct_from_float<T>(tot_l > 0.f ? tot / tot_l : 0.f);
}

template <typename Cache, typename T, int D, int G>
int launch_g(const Args& a, cudaStream_t st) {
  const auto kernel = decode_split_kernel<Cache, T, D, G>;
  constexpr int smem = smem_bytes<Cache, D, G>();
  static bool opted_in = false;  // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    opted_in = true;
  }
  kernel<<<dim3(a.hkv, a.b, a.n_split), kThreads, smem, st>>>(a);
  return 0;
}

template <typename Cache, typename T, int D>
int launch_d(const Args& a, int g, cudaStream_t st) {
  int rc;
  switch (g) {
    case 1: rc = launch_g<Cache, T, D, 1>(a, st); break;
    case 2: rc = launch_g<Cache, T, D, 2>(a, st); break;
    case 4: rc = launch_g<Cache, T, D, 4>(a, st); break;
    case 8: rc = launch_g<Cache, T, D, 8>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc || a.n_split == 1) return rc;
  const int h = a.hkv * g;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * h, 1, 1);
  cfg.blockDim = dim3(D, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_merge_kernel<T, D>, a, h);
}

// The pass over `Cache` with q (and out) of type T, for head_dim d and
// group size g; then cudaGetLastError().
template <typename Cache, typename T>
int dispatch(const Args& a, int g, int d, cudaStream_t st) {
  int rc;
  switch (d) {
    case 16: rc = launch_d<Cache, T, 16>(a, g, st); break;
    case 32: rc = launch_d<Cache, T, 32>(a, g, st); break;
    case 64: rc = launch_d<Cache, T, 64>(a, g, st); break;
    case 128: rc = launch_d<Cache, T, 128>(a, g, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// The launch's arguments, or false where the split does not cover S_max
// exactly once (span a multiple of 32, n_split * span >= S_max >
// (n_split - 1) * span) or a workspace is missing. ws: n_split > 1, a
// float32 workspace of n_split * B * H * (D + 2) elements; else unused.
inline bool make_args(Args& a, const void* q, const void* k, const void* ks, const void* v,
                      const void* vs, const void* valid_len, void* out, void* ws, int b,
                      int s_max, int h, int hkv, int n_split, int span, float scale) {
  if (hkv <= 0 || h % hkv || n_split < 1 || span <= 0 || span % kChunk ||
      (size_t)n_split * span < (size_t)s_max ||
      (size_t)(n_split - 1) * span >= (size_t)max(s_max, 1) || (n_split > 1 && !ws)) {
    return false;
  }
  const size_t bh = (size_t)b * h;
  float* w = static_cast<float*>(ws);
  a = Args{q, k, static_cast<const float*>(ks), v, static_cast<const float*>(vs),
           static_cast<const int*>(valid_len), out,
           w, w ? w + n_split * bh : nullptr, w ? w + 2 * n_split * bh : nullptr,
           b, s_max, hkv, span, n_split, scale};
  return true;
}

}  // namespace kv_split
}  // namespace
