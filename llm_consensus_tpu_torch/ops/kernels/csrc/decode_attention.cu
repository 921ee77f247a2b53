// K3, K7 and K7-q8: one-token decode attention over the KV cache, plain
// and with a prefix shared by every row, over the dense cache or over the
// int8 cache. (K4, decode over the int8 cache without a shared prefix, is
// decode_attention_q8.cu.)
//
// K3 replaces the Pallas kernel llm_consensus_tpu/ops/pallas/attention.py
// (flash_decode_attention -> _decode_kernel). Same semantics: query head h
// reads KV head h // G (G = H / Hkv, as q.reshape(b, 1, hkv, g, d) there),
// cache slots >= valid_len[b] are masked, softmax and the weighted sum of V
// run in float32, output in q's type.
//
// K7 replaces flash_decode_attention_shared_prefix (dense cache, through
// _ragged_attention there). Every row's slots [0, prefix_len) hold the same
// K/V (the self-consistency fan-out after one shared prefill), so the
// prefix is read once for all rows, each row reads only its own slots
// [prefix_len, valid_len), and the partial softmaxes merge by log-sum-exp.
//
// K7-q8 replaces flash_decode_attention_shared_prefix_q8 (through
// _ragged_attention, the scale fold of _online_fold). The int8 cache is
// head-major, [B, Hkv, S_max, D] int8 with a float32 scale per slot [B,
// Hkv, S_max]. As there, the scales fold into the scores (q . k_q times
// k_scale * d^-1/2) and into the value product only (p * v_scale); the
// softmax denominator stays the true sum of p. The _stacked form
// (K7-q8-stacked) exists in the JAX package because a Pallas operand must
// be a whole buffer; here it is this kernel launched on a layer's views. Pallas' choice
// between a row program and a per-head program (_ROW_KERNEL_MAX_KV_BYTES)
// is a VMEM budget, not semantics, and has no counterpart here.
//
// What bounds them on the card: bytes. K3 reads each row's valid K/V slots
// (2 * valid_len * Hkv * D elements per row) and does ~4 * G operations per
// element read, far below ~295 operations per byte. K7 reads the prefix
// once instead of B times: 2 * (prefix + B * suffix) * Hkv * D elements,
// with ~4 * B * G operations per prefix element, still bytes-bound while
// B * G is below a few hundred. The int8 forms read D + 4 bytes per slot
// and head instead of 2 * D: half the bf16 cache's bytes at D = 128.
//
// K3 is decode_split.cuh's split-KV pass on its Dense<T> layout (K4 runs
// the same pass on the int8 cache): a grid of (Hkv, B, n_split) blocks from
// the host-known shapes, warp-private rings of 16-byte cp.async copies on
// mbarriers, lane-per-slot scoring of every head of the kv head from one
// read, and a merge in split order as a programmatic dependent launch. On
// the token-major cache a slot's row for one kv head is D * sizeof(T)
// contiguous bytes, Hkv * D * sizeof(T) bytes from the next slot's, so each
// lane copies its own 16-byte pieces. A bf16 stage of 32 slots is 16.9 KB
// at D = 128 (twice the int8 one), so there a warp's ring holds one stage:
// a block is ~70 KB, three an SM, and twelve warps an SM keep chunks in
// flight while others score (two stages a warp, one ~135 KB block an SM,
// timed slower). The host's split rule is K4's, two blocks for each of the
// 132 SMs (ops/kernels/attention.py: decode_splits); a float32 cache at D =
// 128 (one 33.3 KB stage a warp, one block an SM) aims at one. What still
// bounds K3: each warp's chunks go load, then score, one after another; the
// first chunk's round trip in every block; and the merge launch.
//
// The row kernel (the suffix-and-merge pass of K7 and K7-q8; the cache type
// is a template, Dense<T> or Q8, which says where a slot's row lies and how
// a lane reads its share of it). One block per (batch row, kv head); its 8
// warps split the row's slots [lo, valid_len) round-robin, so only those
// are read from device memory. A warp reads one slot's K and V row per
// step (dense: lane i holds dimensions i, i + 32, ...; int8: lane i holds
// dimensions 4i .. 4i + 3 at D = 128, one 4-byte load, and the slot's two
// scales) and serves all G query heads of the KV head from that one read,
// keeping an online-softmax state (max, sum, output slice) per head in
// registers; it loads its next slot while working on the current one. The
// warps' partial states and the prefix partials are merged by log-sum-exp
// at the end.
//
// Design of K7's prefix pass. One block per (kv head, tile of 16 queries,
// 64-slot split of the prefix). The block stages row 0's prefix K/V for the
// split in shared memory, 32 slots at a time (16-byte loads, the next
// chunk in flight while the current one is used; for int8 also the chunk's
// 32 scale pairs), and each warp runs 2 of the tile's (row, head) queries
// over the staged slots: one lane per slot for the scores, one softmax
// update per chunk, then the weighted sum of V. The split's (max, sum,
// output) per query goes to a float32 workspace that the row kernel
// merges. Moving K7's and K7-q8's row pass onto the split-KV pass, and
// tensor-core score tiles for K7's prefix, are later work.

#include "decode_split.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kSplit = 64;     // prefix slots per block of the prefix pass
constexpr int kChunk = 32;     // prefix slots staged in shared memory at once
constexpr int kQPerWarp = 2;   // queries per warp in the prefix pass
constexpr int kQPerBlock = kWarps * kQPerWarp;

struct RowArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 cache: [B, Hkv, S_max] scales; else null
  const float* vs;
  const int* valid_len;
  void* out;
  int b, s_max, hkv;
  float scale;
  int lo;  // first slot the row kernel reads (0, or K7's prefix length)
  // K7's prefix partials, [n_split, B, H] and [n_split, B, H, D] float32;
  // n_split = 0 for K3.
  const float* pm;
  const float* pl;
  const float* pacc;
  int n_split;
};

// The dense cache: [B, S_max, Hkv, D] of T. Lane `lane` holds dimensions
// lane, lane + 32, ... of a slot's row.
template <typename T>
struct Dense {
  using Elem = T;
  static constexpr bool kScaled = false;
  // Index of the D-element row of (batch row b, kv head kvh, slot).
  __device__ static size_t row(const RowArgs& a, int b, int kvh, int slot) {
    return ((size_t)b * a.s_max + slot) * a.hkv + kvh;
  }
  template <int D>
  __device__ static int dim(int e, int lane) {
    return e * 32 + lane;
  }
  template <int D>
  __device__ static void load(const T* p, int lane, T* r) {
#pragma unroll
    for (int e = 0; e < (D + 31) / 32; ++e) {
      const int d = e * 32 + lane;
      r[e] = d < D ? p[d] : lct_from_float<T>(0.f);
    }
  }
};

// The int8 cache: head-major [B, Hkv, S_max, D] int8, its scales [B, Hkv,
// S_max] at the same row index. Lane `lane` holds the kDPL neighbouring
// dimensions from lane * kDPL, read as one kDPL-byte load.
struct Q8 {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  __device__ static size_t row(const RowArgs& a, int b, int kvh, int slot) {
    return ((size_t)b * a.hkv + kvh) * a.s_max + slot;
  }
  template <int D>
  __device__ static int dim(int e, int lane) {
    return lane * ((D + 31) / 32) + e;
  }
  template <int D>
  __device__ static void load(const int8_t* p, int lane, int8_t* r) {
    constexpr int kDPL = (D + 31) / 32;
    const int d0 = lane * kDPL;
    if (d0 >= D) {  // D = 16: lanes 16..31 hold nothing
#pragma unroll
      for (int e = 0; e < kDPL; ++e) r[e] = 0;
      return;
    }
    if constexpr (kDPL == 4) {
      const char4 c = *reinterpret_cast<const char4*>(p + d0);
      r[0] = c.x;
      r[1] = c.y;
      r[2] = c.z;
      r[3] = c.w;
    } else if constexpr (kDPL == 2) {
      const char2 c = *reinterpret_cast<const char2*>(p + d0);
      r[0] = c.x;
      r[1] = c.y;
    } else {
      r[0] = p[d0];
    }
  }
};

template <typename Cache, typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32) decode_row_kernel(RowArgs a) {
  using E = typename Cache::Elem;
  constexpr int kDPL = (D + 31) / 32;  // dims per lane
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const E* __restrict__ k = static_cast<const E*>(a.k);
  const E* __restrict__ v = static_cast<const E*>(a.v);
  const int b = blockIdx.y, kvh = blockIdx.x, hkv = a.hkv;
  const int h = hkv * G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = min(max(a.valid_len[b], 0), a.s_max);

  float qr[G][kDPL], acc[G][kDPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t q_off = ((size_t)b * h + kvh * G + g) * D;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = Cache::template dim<D>(e, lane);
      qr[g][e] = d < D ? lct_to_float(q[q_off + d]) * a.scale : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  // Each warp loads its next slot's K/V row (and, int8, its scales)
  // before working on the current one, so a device-memory round trip
  // overlaps the math.
  E kn[kDPL], vn[kDPL];
  float ksn = 1.f, vsn = 1.f;
  auto load = [&](int slot) {
    const size_t r = Cache::row(a, b, kvh, slot);
    Cache::template load<D>(k + r * D, lane, kn);
    Cache::template load<D>(v + r * D, lane, vn);
    if constexpr (Cache::kScaled) {
      ksn = a.ks[r];
      vsn = a.vs[r];
    }
  };
  if (a.lo + warp < n) load(a.lo + warp);
  for (int slot = a.lo + warp; slot < n; slot += kWarps) {
    float kr[kDPL], vr[kDPL];
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      kr[e] = lct_to_float(kn[e]);
      vr[e] = lct_to_float(vn[e]);
    }
    const float ks = ksn, vs = vsn;
    if (slot + kWarps < n) load(slot + kWarps);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc = 0.f;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) sc += qr[g][e] * kr[e];
      sc = lct_group_sum<32>(sc);
      if constexpr (Cache::kScaled) sc *= ks;
      const float m_new = fmaxf(m[g], sc);
      const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
      float pv = p;
      if constexpr (Cache::kScaled) pv *= vs;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) acc[g][e] = acc[g][e] * alpha + pv * vr[e];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = Cache::template dim<D>(e, lane);
      if (d < D) sm_acc[warp][g][d] = acc[g][e];
    }
  }
  __syncthreads();

  // Merge the warps' partials and the prefix splits' (normalized) ones.
  // An empty partial (a warp that saw no slot) has m = -inf and is skipped.
  const size_t bh = (size_t)a.b * h;
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D, d = idx % D;
    const size_t row_head = (size_t)b * h + kvh * G + g;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    for (int sp = 0; sp < a.n_split; ++sp) mx = fmaxf(mx, a.pm[sp * bh + row_head]);
    float tot_l = 0.f, tot_acc = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        if (sm_m[w][g] == -INFINITY) continue;
        const float c = expf(sm_m[w][g] - mx);
        tot_l += sm_l[w][g] * c;
        tot_acc += sm_acc[w][g][d] * c;
      }
      for (int sp = 0; sp < a.n_split; ++sp) {
        const float pm = a.pm[sp * bh + row_head];
        if (pm == -INFINITY) continue;
        const float wl = a.pl[sp * bh + row_head] * expf(pm - mx);
        tot_l += wl;
        tot_acc += wl * a.pacc[(sp * bh + row_head) * D + d];
      }
    }
    const float o = tot_l > 0.f ? tot_acc / tot_l : 0.f;
    static_cast<T*>(a.out)[row_head * D + d] = lct_from_float<T>(o);
  }
}

// The 16 bytes of a staged vector as floats (4 float32, 8 bfloat16 or 16
// int8).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r,
                                                        float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 t = __bfloat1622float2(p[u]);
    f[2 * u] = t.x;
    f[2 * u + 1] = t.y;
  }
}
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& r, float* f) {
  const char4* p = reinterpret_cast<const char4*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    f[4 * u] = p[u].x;
    f[4 * u + 1] = p[u].y;
    f[4 * u + 2] = p[u].z;
    f[4 * u + 3] = p[u].w;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// K7's prefix pass. Grid (hkv, ceil(B * G / kQPerBlock), n_split). Query j
// of kv head kvh is (row j / G, head kvh * G + j % G). Writes each query's
// (max, sum, normalized output) over this split's prefix slots.
//
// Per staged chunk of 32 slots, lane s of a warp scores slot s for the
// warp's queries (its K row against the query held in shared memory), so
// the chunk needs one max reduction and one exp per lane instead of one
// online-softmax update per slot; the probabilities are then broadcast by
// shuffle for the weighted sum of V, where lane i holds dimensions i, i +
// 32, ...
template <typename Cache, typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    prefix_kernel(RowArgs a, int g_size, int prefix_len, float* __restrict__ pm,
                  float* __restrict__ pl, float* __restrict__ pacc) {
  using E = typename Cache::Elem;
  constexpr int kDPL = (D + 31) / 32;
  // A slot's K (or V) row of one kv head is D * sizeof(E) contiguous
  // bytes, moved as 16-byte vectors. K rows are padded by one vector so
  // that 32 lanes reading 32 rows hit distinct banks.
  constexpr int kElemPerVec = 16 / (int)sizeof(E);
  constexpr int kVecPerRow = D / kElemPerVec;
  constexpr int kVecPerThread =
      (kChunk * kVecPerRow + kWarps * 32 - 1) / (kWarps * 32);
  __shared__ __align__(16) E sk[kChunk][D + kElemPerVec];
  __shared__ __align__(16) E sv[kChunk][D];
  __shared__ float sks[kChunk], svs[kChunk];  // int8 cache: the chunk's scales
  __shared__ __align__(16) float sq[kWarps][kQPerWarp][D];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const E* __restrict__ k = static_cast<const E*>(a.k);
  const E* __restrict__ v = static_cast<const E*>(a.v);
  const int kvh = blockIdx.x, split = blockIdx.z;
  const int b_rows = a.b, h = a.hkv * g_size, nq = b_rows * g_size;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lo = split * kSplit, hi = min(prefix_len, lo + kSplit);
  const int j0 = blockIdx.y * kQPerBlock + warp * kQPerWarp;

  // m: running max; l: this lane's share of the running sum (summed over
  // the warp at the end); acc: the output dimensions this lane holds.
  float acc[kQPerWarp][kDPL], m[kQPerWarp], l[kQPerWarp];
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    const int j = j0 + i;
    const size_t q_off =
        ((size_t)(j / g_size) * h + kvh * g_size + j % g_size) * D;
    for (int d = lane; d < D; d += 32) {
      sq[warp][i][d] = j < nq ? lct_to_float(q[q_off + d]) * a.scale : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[i][e] = 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  __syncwarp();  // each warp reads only its own queries

  // The next chunk is loaded into registers (every load issued before any
  // is used) while the current one is worked on from shared memory.
  uint4 kbuf[kVecPerThread], vbuf[kVecPerThread];
  float ksb = 0.f, vsb = 0.f;  // int8: thread t < kChunk holds slot t's scales
  auto load = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kVecPerThread; ++r) {
      const int idx = threadIdx.x + r * kWarps * 32;
      const int s = idx / kVecPerRow, c = idx % kVecPerRow;
      if (s < kChunk && c0 + s < hi) {
        const size_t off = Cache::row(a, 0, kvh, c0 + s) * D;  // row 0
        kbuf[r] = reinterpret_cast<const uint4*>(k + off)[c];
        vbuf[r] = reinterpret_cast<const uint4*>(v + off)[c];
      }
    }
    if constexpr (Cache::kScaled) {
      const int s = threadIdx.x;
      if (s < kChunk && c0 + s < hi) {
        const size_t r = Cache::row(a, 0, kvh, c0 + s);
        ksb = a.ks[r];
        vsb = a.vs[r];
      }
    }
  };
  if (lo < hi) load(lo);
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int nc = min(kChunk, hi - c0);
    __syncthreads();  // the previous chunk is no longer read
#pragma unroll
    for (int r = 0; r < kVecPerThread; ++r) {
      const int idx = threadIdx.x + r * kWarps * 32;
      const int s = idx / kVecPerRow, c = idx % kVecPerRow;
      if (s < nc) {
        reinterpret_cast<uint4*>(sk[s])[c] = kbuf[r];
        reinterpret_cast<uint4*>(sv[s])[c] = vbuf[r];
      }
    }
    if constexpr (Cache::kScaled) {
      if (threadIdx.x < nc) {
        sks[threadIdx.x] = ksb;
        svs[threadIdx.x] = vsb;
      }
    }
    __syncthreads();
    if (c0 + kChunk < hi) load(c0 + kChunk);
    if (j0 >= nq) continue;  // this warp has no query (it still syncs)

    float sc[kQPerWarp];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) sc[i] = 0.f;
    if (lane < nc) {
      const uint4* krow = reinterpret_cast<const uint4*>(sk[lane]);
#pragma unroll 4
      for (int c = 0; c < kVecPerRow; ++c) {
        float kf[kElemPerVec];
        unpack16<E>(krow[c], kf);
#pragma unroll
        for (int i = 0; i < kQPerWarp; ++i) {
          const float4* qv =
              reinterpret_cast<const float4*>(&sq[warp][i][c * kElemPerVec]);
#pragma unroll
          for (int u = 0; u < kElemPerVec / 4; ++u) {
            const float4 qq = qv[u];
            sc[i] += qq.x * kf[4 * u] + qq.y * kf[4 * u + 1] +
                     qq.z * kf[4 * u + 2] + qq.w * kf[4 * u + 3];
          }
        }
      }
      if constexpr (Cache::kScaled) {
#pragma unroll
        for (int i = 0; i < kQPerWarp; ++i) sc[i] *= sks[lane];
      }
    }
    float p[kQPerWarp];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) {
      const float s_lane = lane < nc ? sc[i] : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s_lane));  // lane 0 is valid
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_new);
      p[i] = lane < nc ? expf(s_lane - m_new) : 0.f;
      l[i] = l[i] * alpha + p[i];
#pragma unroll
      for (int e = 0; e < kDPL; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }
    for (int s = 0; s < nc; ++s) {
      float vr[kDPL];
#pragma unroll
      for (int e = 0; e < kDPL; ++e) {
        const int d = e * 32 + lane;
        vr[e] = d < D ? lct_to_float(sv[s][d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kQPerWarp; ++i) {
        float ps = __shfl_sync(0xffffffffu, p[i], s);
        if constexpr (Cache::kScaled) ps *= svs[s];
#pragma unroll
        for (int e = 0; e < kDPL; ++e) acc[i][e] += ps * vr[e];
      }
    }
  }

  const size_t bh = (size_t)b_rows * h;
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    const int j = j0 + i;
    const float l_tot = lct_group_sum<32>(l[i]);  // every lane takes part
    if (j >= nq) continue;
    const size_t idx = split * bh + (size_t)(j / g_size) * h + kvh * g_size +
                       j % g_size;
    if (lane == 0) {
      pm[idx] = m[i];
      pl[idx] = l_tot;
    }
    const float inv = l_tot > 0.f ? 1.f / l_tot : 0.f;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) pacc[idx * D + d] = acc[i][e] * inv;
    }
  }
}

template <typename Cache, typename T, int D>
int launch_rows(const RowArgs& a, int g, cudaStream_t st) {
  dim3 grid(a.hkv, a.b);
  switch (g) {
    case 1: decode_row_kernel<Cache, T, D, 1><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 2: decode_row_kernel<Cache, T, D, 2><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 4: decode_row_kernel<Cache, T, D, 4><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 8: decode_row_kernel<Cache, T, D, 8><<<grid, kWarps * 32, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename Cache, typename T, int D>
int launch_d(const RowArgs& a, int g, int prefix_len, float* ws,
             cudaStream_t st) {
  if (a.n_split > 0) {
    const size_t bh = (size_t)a.b * a.hkv * g;
    dim3 grid(a.hkv, (a.b * g + kQPerBlock - 1) / kQPerBlock, a.n_split);
    prefix_kernel<Cache, T, D><<<grid, kWarps * 32, 0, st>>>(
        a, g, prefix_len, ws, ws + a.n_split * bh, ws + 2 * a.n_split * bh);
  }
  return launch_rows<Cache, T, D>(a, g, st);
}

template <typename Cache, typename T>
int dispatch_d(const RowArgs& a, int g, int d, int prefix_len, float* ws,
               cudaStream_t st) {
  switch (d) {
    case 16: return launch_d<Cache, T, 16>(a, g, prefix_len, ws, st);
    case 32: return launch_d<Cache, T, 32>(a, g, prefix_len, ws, st);
    case 64: return launch_d<Cache, T, 64>(a, g, prefix_len, ws, st);
    case 128: return launch_d<Cache, T, 128>(a, g, prefix_len, ws, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q8: the int8 head-major cache (a.ks / a.vs set); else the dense cache in
// q's type.
int run(RowArgs a, bool q8, int h, int d, int dtype, int prefix_len,
        float* ws, void* stream) {
  if (a.b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = h / a.hkv;
  int rc;
  if (dtype == LCT_DTYPE_F32) {
    rc = q8 ? dispatch_d<Q8, float>(a, g, d, prefix_len, ws, st)
            : dispatch_d<Dense<float>, float>(a, g, d, prefix_len, ws, st);
  } else if (dtype == LCT_DTYPE_BF16) {
    rc = q8 ? dispatch_d<Q8, __nv_bfloat16>(a, g, d, prefix_len, ws, st)
            : dispatch_d<Dense<__nv_bfloat16>, __nv_bfloat16>(a, g, d,
                                                               prefix_len, ws, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

RowArgs row_args(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* valid_len, void* out, int b,
                 int s_max, int hkv, float scale, int prefix_len, float* ws,
                 int h) {
  const int n_split = (prefix_len + kSplit - 1) / kSplit;
  const size_t bh = (size_t)b * h;
  return RowArgs{q, k, v, static_cast<const float*>(ks),
                 static_cast<const float*>(vs),
                 static_cast<const int*>(valid_len), out, b, s_max, hkv,
                 scale, prefix_len, ws, ws ? ws + n_split * bh : nullptr,
                 ws ? ws + 2 * n_split * bh : nullptr, n_split};
}

}  // namespace

// K3. q: [B, 1, H, D]; k, v: [B, S_max, Hkv, D] in q's type (float32 or
// bfloat16, dtype), 16-byte aligned; valid_len: [B] int32 on the card; out:
// [B, 1, H, D]; all contiguous. H = Hkv * G. The split (n_split, span) and
// the workspace ws as K4's (decode_attention_q8.cu): span a multiple of 32,
// n_split * span >= S_max > (n_split - 1) * span; ws, n_split > 1, a
// float32 workspace of n_split * B * H * (D + 2) elements, else unused.
extern "C" int lct_decode_attention(const void* q, const void* k, const void* v,
                                    const void* valid_len, void* out, void* ws, int b,
                                    int s_max, int h, int hkv, int d, int n_split, int span,
                                    float scale, int dtype, void* stream) {
  if (b <= 0) return 0;
  kv_split::Args a;
  if (!kv_split::make_args(a, q, k, nullptr, v, nullptr, valid_len, out, ws, b, s_max, h, hkv,
                           n_split, span, scale)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == LCT_DTYPE_F32) {
    return kv_split::dispatch<kv_split::Dense<float>, float>(a, h / hkv, d, st);
  }
  if (dtype == LCT_DTYPE_BF16) {
    return kv_split::dispatch<kv_split::Dense<__nv_bfloat16>, __nv_bfloat16>(a, h / hkv, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K7. As K3, plus prefix_len (0 <= prefix_len <= S_max: slots below it are
// the same in every row) and ws, a float32 workspace of
// n_split * B * H * (D + 2) elements, n_split = ceil(prefix_len / 64).
extern "C" int lct_shared_prefix_attention(const void* q, const void* k,
                                           const void* v,
                                           const void* valid_len, void* out,
                                           void* ws, int b, int s_max, int h,
                                           int hkv, int d, int prefix_len,
                                           float scale, int dtype,
                                           void* stream) {
  float* w = static_cast<float*>(ws);
  const RowArgs a = row_args(q, k, v, nullptr, nullptr, valid_len, out, b,
                             s_max, hkv, scale, prefix_len, w, h);
  return run(a, false, h, d, dtype, prefix_len, w, stream);
}

// K7-q8. q: [B, 1, H, D] float32 or bfloat16; k_q, v_q: [B, Hkv, S_max, D]
// int8; k_scale, v_scale: [B, Hkv, S_max] float32; valid_len: [B] int32;
// out: [B, 1, H, D] in q's type; all contiguous on the card. Plus
// prefix_len and the workspace ws, as K7.
extern "C" int lct_shared_prefix_attention_q8(
    const void* q, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* valid_len, void* out, void* ws, int b,
    int s_max, int h, int hkv, int d, int prefix_len, float scale, int dtype,
    void* stream) {
  float* w = static_cast<float*>(ws);
  const RowArgs a = row_args(q, k_q, v_q, k_scale, v_scale, valid_len, out,
                             b, s_max, hkv, scale, prefix_len, w, h);
  return run(a, true, h, d, dtype, prefix_len, w, stream);
}
