// The split-KV decode pass: one-token decode attention over a KV cache,
// templated on where a slot's row lies. Three layouts use it:
//
// - Dense<T>: the token-major cache [B, S_max, Hkv, D] in q's type (float32
//   or bfloat16), no scales. K3 and K7's suffix (decode_attention.cu).
// - Q8: the head-major int8 cache [B, Hkv, S_max, D] with a float32 scale
//   per slot [B, Hkv, S_max]; the K scale folds into the scores and the V
//   scale into the value product only (p * v_scale), the denominator stays
//   the true sum of p. K4, K5 and K7-q8's suffix (decode_attention_q8.cu).
// - Paged<E>: the serving page pool [n_pages, pg, Hkv, D] of E (float32 or
//   bfloat16, under float32 or bfloat16 queries), a slot's row found
//   through the row's page table [B, P]: page table[b, slot / pg], row
//   (page * pg + slot % pg) * Hkv + kvh. K8's decode rows
//   (ragged_paged_attention.cu).
//
// Semantics (all): q [B, 1, H, D]; query head h reads kv head h / G;
// scores are q . k times d^-1/2; a row reads its slots [first, valid_len)
// where first = max(lo0, shared_start[b], valid_len[b] - window) (lo0 a
// host int, K7's prefix length; shared_start and the window K8's, each
// where given); the softmax and the weighted sum of V run in float32;
// output in q's type. Partials of a shared run that another pass computed
// (K7's prefix, K8's group run: the "extras", in the same unnormalised
// (max, sum, output) form as the splits') are merged in first, in their
// order. A row with nothing to read and no extras gives zeros.
//
// What bounds it on the card: bytes. A slot costs 2 * D * sizeof(T) bytes
// per kv head on the dense cache (2 * (D + 4) on the int8 one) for ~4 * G
// operations an element: far below the ridge, so tensor cores would buy
// nothing. What matters is having enough bytes in flight on every SM
// (Little's law: ~20 KB an SM to keep 3.35 TB/s moving) and enough blocks
// to reach every SM at decode's small batches.
//
// Design. Grid (Hkv, B, n_split): a block takes one contiguous span of
// slots of one (row, kv head), [lo0 + z * span, lo0 + (z + 1) * span), and
// serves all G query heads of the kv head from one read. n_split and the
// span (a whole number of 32-slot chunks, at least 128 slots) come from the
// host-known shapes only (ops/kernels/attention.py: decode_splits; for K8
// the table's width P * pg), never from valid_len, which lives on the card:
// a block whose span lies wholly below its row's first slot or at or past
// its valid_len writes an empty partial (max -inf, sum 0) and exits; a span
// that holds the first slot starts its chunks there.
//
// A block is 4 warps, each an independent pipeline: warp w takes chunks w,
// w + 4, ... of the span through its own ring of stages (the K and V rows
// of 32 slots, and the int8 cache's scales), filled by its own lanes with
// 16-byte cp.async (4-byte for the scales; on the token-major and paged
// layouts each lane copies its own pieces of rows Hkv * D elements apart;
// on the paged one each lane looks up its own slot's page and the warp
// shares the rows by shuffle) and tracked by one mbarrier a stage that each
// lane's copies arrive on. The
// ring has two stages wherever 4 warps' worth fits in 128 KB, so that a
// warp's next chunk is in flight while it scores one (every int8 shape,
// bf16 up to D = 64, float32 up to D = 32), else one, and then the chunks
// in flight while a warp scores are the other resident warps'. A stage is
// 16.9 KB at D = 128 in bf16 and 8.8 KB in int8: a bf16 block of one
// stage a warp holds ~70 KB, as an int8 block of two does, three blocks an
// SM; two bf16 stages a warp (~135 KB, one block an SM) left each SM 4
// warps that score one after another and timed slower on the H100 (PERF.md
// §6). The host's split rule aims at two blocks an SM where the shared
// memory holds them (one for float32 at D = 128). A launch whose span
// gives fewer than 4 warps a chunk (K7's short suffix) allocates only
// those warps' rings, so that more of its blocks fit on an SM. Every warp
// works whatever G is. A chunk is scored with lane s scoring slot s
// for every head (K rows padded by 16 bytes so the 32 lanes' 16-byte reads
// hit distinct banks; int8 to float by a byte permute and an add, bf16 by
// a shift), one max reduction and one exp a lane a chunk, then P * V from
// shared memory with lane i holding dimensions D/32 * i onwards and p
// (times the V scale) read back four slots at a time. The warps' states
// merge by log-sum-exp through shared memory. With n_split > 1 each block
// writes its (max, sum, unnormalised output) to a float32 workspace and a
// second small launch merges the extras and then the splits, in order, so
// a result does not change from run to run; it is launched as a
// programmatic dependent (its blocks wait on the split pass with
// griddepcontrol.wait), which hides its launch. With one split the block
// merges the extras and writes the output itself. Where the extras come
// from a tile pass launched just before (decode_tile.cuh), the split pass
// is that pass's programmatic dependent too: its blocks stream their
// slots while the tile pass runs and wait for it only before they read
// the extras (and before they exit).
#pragma once

#include "common.cuh"

namespace {
namespace kv_split {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;               // slots a stage: one lane a slot
constexpr int kRingBudget = 128 * 1024;  // bytes of ring that allow two stages a warp

// Partials of a shared run computed by another pass, merged into each
// row's result before its own splits: max and sum [n, rows], unnormalised
// output [n, rows, D], rows = B * NQ * H (query (b, i, h) at (b * NQ + i) *
// H + h). Every row has n of them (K7's prefix splits), or, with gid, a
// row in group gid[b] >= 0 has those of the splits of span slots that
// cover the group's run [0, min(gend[gid[b]], slots)) and an ungrouped row
// none (K8's group run).
struct Extra {
  const float* m;
  const float* l;
  const float* acc;
  size_t stride;  // rows
  int n;
  const int* gid;
  const int* gend;
  int span, slots;

  __device__ int count(int b) const {
    if (m == nullptr) return 0;
    if (gid == nullptr) return n;
    const int gi = gid[b];
    if (gi < 0) return 0;
    const int ge = min(gend[gi], slots);
    return ge > 0 ? min(n, (ge + span - 1) / span) : 0;
  }
  __device__ float max_at(int i, size_t row) const { return m[i * stride + row]; }
  __device__ float sum_at(int i, size_t row) const { return l[i * stride + row]; }
  template <int D>
  __device__ const float* acc_at(int i, size_t row) const {
    return acc + (i * stride + row) * D;
  }
};

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
  int lo0;             // the grid covers slots [lo0, S_max)
  const int* table;    // Paged: [B, P]; else null
  const int* sstart;   // [B] first slot of each row's own walk, or null
  int pg, p_per;       // Paged: page size, pages a table row
  int window;          // > 0: a row reads slots >= valid_len - window
  Extra x;
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

// A layout is a view of one sequence's slots of one kv head: built from
// (batch row, its table row or null, kv head, S_max, Hkv, page size), it
// gives the index (in rows of D elements) of a slot's row. kIndirect: the
// row is looked up in a table (each lane finds its own slot's).

// The int8 head-major cache: row (b, kvh, slot) at ((b * Hkv + kvh) *
// S_max + slot) * D, its scales at the same row index.
struct Q8 {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  static constexpr bool kIndirect = false;
  size_t base;
  __device__ Q8(int b, const int*, int kvh, int s_max, int hkv, int)
      : base(((size_t)b * hkv + kvh) * s_max) {}
  __device__ size_t row(int slot) const { return base + slot; }
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

// What the unscaled layouts of E (float or __nv_bfloat16) share: how a
// staged row is read.
template <typename E>
struct Plain {
  using Elem = E;
  static constexpr bool kScaled = false;
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

// The dense token-major cache: row (b, kvh, slot) at ((b * S_max + slot) *
// Hkv + kvh) * D.
template <typename E>
struct Dense : Plain<E> {
  static constexpr bool kIndirect = false;
  size_t base;
  int hkv;
  __device__ Dense(int b, const int*, int kvh, int s_max, int hkv_, int)
      : base((size_t)b * s_max * hkv_ + kvh), hkv(hkv_) {}
  __device__ size_t row(int slot) const { return base + (size_t)slot * hkv; }
};

// The page pool [n_pages, pg, Hkv, D]: slot s of a sequence whose table
// row is tbl lies at ((tbl[s / pg] * pg + s % pg) * Hkv + kvh) * D.
template <typename E>
struct Paged : Plain<E> {
  static constexpr bool kIndirect = true;
  const int* tbl;
  int kvh, hkv, pg;
  __device__ Paged(int, const int* tbl_, int kvh_, int, int hkv_, int pg_)
      : tbl(tbl_), kvh(kvh_), hkv(hkv_), pg(pg_) {}
  __device__ size_t row(int slot) const {
    return ((size_t)tbl[slot / pg] * pg + slot % pg) * hkv + kvh;
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
// the rings' barriers (the fixed part). smem_bytes is the whole; a launch
// whose span gives fewer than 4 warps a chunk allocates only their rings
// (ring_area_bytes), so more of its blocks fit on an SM.
template <typename Cache, int D, int G>
__host__ __device__ constexpr int fixed_smem_bytes() {
  return G * D * 4 + kWarps * G * kChunk * 4 + kWarps * ring_stages<Cache, D>() * 8;
}
template <typename Cache, int D, int G>
__host__ __device__ constexpr int smem_bytes() {
  return kWarps * ring_stages<Cache, D>() * (int)sizeof(Stage<Cache, D>) +
         fixed_smem_bytes<Cache, D, G>();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One query head's result from its extras (in order) and its own states
// (max, sum, unnormalised output dimension d; max -inf: empty), merged by
// log-sum-exp: the largest max first, then the sums in that fixed order.
// Zero where everything is empty.
template <int D, int N>
__device__ __forceinline__ float merge_out(const Extra& x, int nx, size_t row, int d,
                                           const float (&m)[N], const float (&l)[N],
                                           const float (&acc)[N]) {
  float mx = -INFINITY;
  for (int i = 0; i < nx; ++i) mx = fmaxf(mx, x.max_at(i, row));
#pragma unroll
  for (int w = 0; w < N; ++w) mx = fmaxf(mx, m[w]);
  if (mx == -INFINITY) return 0.f;
  float tot_l = 0.f, tot = 0.f;
  for (int i = 0; i < nx; ++i) {
    const float pm = x.max_at(i, row);
    if (pm == -INFINITY) continue;
    const float c = expf(pm - mx);
    tot_l += x.sum_at(i, row) * c;
    tot += x.template acc_at<D>(i, row)[d] * c;
  }
#pragma unroll
  for (int w = 0; w < N; ++w) {
    if (m[w] == -INFINITY) continue;
    const float c = expf(m[w] - mx);
    tot_l += l[w] * c;
    tot += acc[w] * c;
  }
  return tot_l > 0.f ? tot / tot_l : 0.f;
}

// A block's G heads' results from their nx extras (in order) and the 4
// warps' states (wm, wl [warp][G], wacc [warp][G][D] in shared memory),
// written to out in T. The extras' maxima and sums are staged in shared
// memory after wacc, one load a thread, all in flight at once; one thread a
// head takes the largest max, the weights exp(max - largest) and the sum;
// then each (head, dimension) adds the parts' outputs in order, its loads
// unrolled so that several are in flight. A chain of dependent loads here
// (one part after another) took longer than the block's own slots.
template <int D, int G, typename T>
__device__ __forceinline__ void merge_extras(const Extra& x, int nx, size_t head0,
                                             const float* wm, const float* wl, float* wacc,
                                             T* out) {
  const int t = threadIdx.x;
  float* xm = wacc + kWarps * G * D;                      // [G][nx]
  float* xl = xm + G * nx;                                // [G][nx]
  float* xw = xl + G * nx;                                // [G][nx] weights
  float* ww = xw + G * nx;                                // [G][warp] weights
  float* lt = ww + G * kWarps;                            // [G] sums
  for (int i = t; i < G * nx; i += kThreads) {
    xm[i] = x.max_at(i % nx, head0 + i / nx);
    xl[i] = x.sum_at(i % nx, head0 + i / nx);
  }
  __syncthreads();
  for (int g = t; g < G; g += kThreads) {
    float mx = -INFINITY;
    for (int p = 0; p < nx; ++p) mx = fmaxf(mx, xm[g * nx + p]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float tl = 0.f;
    for (int p = 0; p < nx; ++p) {
      const float m = xm[g * nx + p];
      const float c = mx == -INFINITY || m == -INFINITY ? 0.f : expf(m - mx);
      xw[g * nx + p] = c;
      tl += xl[g * nx + p] * c;
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float m = wm[w * G + g];
      const float c = mx == -INFINITY || m == -INFINITY ? 0.f : expf(m - mx);
      ww[g * kWarps + w] = c;
      tl += wl[w * G + g] * c;
    }
    lt[g] = tl;
  }
  __syncthreads();
  for (int i = t; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float tot = 0.f;
#pragma unroll 4
    for (int p = 0; p < nx; ++p) {
      const float c = xw[g * nx + p];
      tot += (c == 0.f ? 0.f : x.template acc_at<D>(p, head0 + g)[d]) * c;
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += wacc[(w * G + g) * D + d] * ww[g * kWarps + w];
    out[(head0 + g) * D + d] = lct_from_float<T>(lt[g] > 0.f ? tot / lt[g] : 0.f);
  }
}

// Shared memory the epilogue of a block with nx extras needs: the warps'
// states, then merge_extras's arrays. It reuses the rings.
template <int D, int G>
__host__ __device__ constexpr int extras_smem_bytes(int nx) {
  return (kWarps * G * (D + 2) + 3 * G * nx + G * kWarps + G) * 4;
}

// Bytes before the fixed part: the rings of the warps a span of `span`
// slots gives a chunk, or the epilogue's arrays where those need more
// (rounded to 16 bytes). The whole ring for any span of 128 slots or more.
template <typename Cache, int D, int G>
__host__ __device__ int ring_area_bytes(int span, int nx) {
  const int warps = span >= kWarps * kChunk ? kWarps : (span + kChunk - 1) / kChunk;
  const int rings = warps * ring_stages<Cache, D>() * (int)sizeof(Stage<Cache, D>);
  const int epilogue = (extras_smem_bytes<D, G>(nx) + 15) / 16 * 16;
  return rings > epilogue ? rings : epilogue;
}

template <typename Cache, typename T, int D, int G>
__device__ __forceinline__ void split_body(const Args& a) {
  using E = typename Cache::Elem;
  using St = Stage<Cache, D>;
  constexpr int kS = ring_stages<Cache, D>();
  constexpr int kDPL = (D + 31) / 32;      // V dimensions a lane holds
  constexpr int kPerVec = St::kPerVec;     // elements a 16-byte vector
  constexpr int kVec = D / kPerVec;        // 16-byte vectors in a row
  constexpr int kQ4 = kPerVec / 4;         // float4s of q a vector meets
  extern __shared__ __align__(16) unsigned char smem[];
  St* ring = reinterpret_cast<St*>(smem);  // [warp][stage]
  float(*sq)[D] = reinterpret_cast<float(*)[D]>(
      smem + ring_area_bytes<Cache, D, G>(a.span, a.n_split == 1 && a.x.m ? a.x.n : 0));
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
  int first = a.lo0;
  if (a.sstart != nullptr) first = max(first, a.sstart[b]);
  if (a.window > 0) first = max(first, n - a.window);
  const int start = a.lo0 + split * a.span;
  const int lo = max(start, first), hi = min(n, start + a.span);
  const bool to_ws = a.n_split > 1;         // partials, merged by the merge launch
  const int nx = to_ws ? 0 : a.x.count(b);  // extras this block merges

  if (lo >= hi && nx == 0) {  // nothing to read or merge (block-uniform)
    if (to_ws) {  // an empty partial
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
  const Cache seq(b, a.table ? a.table + (size_t)b * a.p_per : nullptr, kvh, a.s_max, a.hkv,
                  a.pg);
  const int n_chunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;
  const int my_chunks = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  St* my_ring = ring + warp * kS;
  uint64_t* my_full = full + warp * kS;
  // The warp's i-th chunk into its stage i % kS; each lane arrives once a
  // fill, when its copies have landed; slots past hi are zero-filled.
  auto fill = [&](int i) {
    St& st = my_ring[i % kS];
    const int c0 = lo + (warp + i * kWarps) * kChunk, nc = min(kChunk, hi - c0);
    const size_t my_row = seq.row(c0 + min(lane, nc - 1));  // lane s: slot s's row
#pragma unroll
    for (int j = lane; j < kChunk * kVec; j += 32) {
      const int s = j / kVec, v = j % kVec;
      size_t r;
      if constexpr (Cache::kIndirect) {
        r = __shfl_sync(0xffffffffu, (unsigned long long)my_row, s);
      } else {
        r = seq.row(c0 + min(s, nc - 1));
      }
      const size_t off = r * D + v * kPerVec;
      lct_cp_async16(&st.k[s][v * kPerVec], kc + off, s < nc);
      lct_cp_async16(&st.v[s][v * kPerVec], vc + off, s < nc);
    }
    if constexpr (Cache::kScaled) {
      lct_cp_async4(&st.ks[lane], a.ks + my_row, lane < nc);
      lct_cp_async4(&st.vs[lane], a.vs + my_row, lane < nc);
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
  lct_pdl_trigger();

  // The 4 warps' states merged by log-sum-exp through shared memory (the
  // rings are no longer read).
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);  // [warp][G]
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
  if (nx > 0) {  // one split: this block merges the extras, then its warps
    lct_pdl_wait();  // the extras' pass has finished
    merge_extras<D, G>(a.x, nx, head0, wm, wl, wacc, out);
    return;
  }
  for (int i = t; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const size_t head = head0 + g;
    float mw[kWarps], lw[kWarps], aw[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = wm[w * G + g];
      lw[w] = wl[w * G + g];
      aw[w] = wacc[(w * G + g) * D + d];
    }
    if (!to_ws) {
      out[head * D + d] = lct_from_float<T>(merge_out<D>(a.x, 0, head, d, mw, lw, aw));
      continue;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w]);
    float tot_l = 0.f, tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (mw[w] == -INFINITY) continue;  // a warp that had no chunk
      const float c = expf(mw[w] - mx);
      tot_l += lw[w] * c;
      tot += aw[w] * c;
    }
    if (d == 0) {
      a.pm[split * bh + head] = mx;
      a.pl[split * bh + head] = tot_l;
    }
    a.pacc[(split * bh + head) * D + d] = tot;
  }
}

template <typename Cache, typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  split_body<Cache, T, D, G>(a);
  lct_pdl_wait();  // launched after a tile pass: end only after it ends
}

// The extras and then the splits of each (row, head) merged by log-sum-exp,
// in order. One block of D threads per query head. The parts' maxima and
// sums are staged in shared memory, one load a thread, all in flight at
// once; every thread takes the largest max from there, the weights exp(max
// - largest) are computed once a part (0 for an empty part, max -inf), and
// each thread adds its dimension of the parts' outputs in order, its loads
// unrolled so that several are in flight (a chain of dependent loads, one
// part after another, took most of the launch's time). Launched as a
// programmatic dependent of the split pass: its blocks may be resident
// early and wait here for that grid to finish and flush. Dynamic shared
// memory: merge_smem_bytes.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_merge_kernel(Args a, int h) {
  extern __shared__ float parts[];  // maxima, sums, weights: [3][x.n + n_split]
  lct_pdl_wait();
  const size_t head = blockIdx.x, bh = (size_t)a.b * h;
  const int d = threadIdx.x;
  const int nx = a.x.count((int)blockIdx.x / h), np = nx + a.n_split;
  const int cap = a.x.n + a.n_split;
  float* pm = parts;
  float* pl = parts + cap;
  float* pw = parts + 2 * cap;
  for (int i = d; i < np; i += D) {
    pm[i] = i < nx ? a.x.max_at(i, head) : a.pm[(i - nx) * bh + head];
    pl[i] = i < nx ? a.x.sum_at(i, head) : a.pl[(i - nx) * bh + head];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int i = 0; i < np; ++i) mx = fmaxf(mx, pm[i]);
  for (int i = d; i < np; i += D) {
    pw[i] = mx == -INFINITY || pm[i] == -INFINITY ? 0.f : expf(pm[i] - mx);
  }
  __syncthreads();
  float tot_l = 0.f, tot = 0.f;
#pragma unroll 4
  for (int i = 0; i < np; ++i) {
    const float c = pw[i];
    const float* acc = i < nx ? a.x.template acc_at<D>(i, head) : a.pacc + ((i - nx) * bh + head) * D;
    tot_l += pl[i] * c;
    tot += (c == 0.f ? 0.f : acc[d]) * c;
  }
  static_cast<T*>(a.out)[head * D + d] = lct_from_float<T>(tot_l > 0.f ? tot / tot_l : 0.f);
}

inline int merge_smem_bytes(const Args& a) { return 3 * (a.x.n + a.n_split) * 4; }

template <typename Cache, typename T, int D, int G>
int launch_g(const Args& a, bool dependent, cudaStream_t st) {
  const auto kernel = decode_split_kernel<Cache, T, D, G>;
  // The rings of the warps the span gives a chunk (or the epilogue's
  // arrays, where one split merges its extras, if they need more), then
  // the fixed part.
  constexpr int full = smem_bytes<Cache, D, G>();
  const int smem = ring_area_bytes<Cache, D, G>(a.span, a.n_split == 1 && a.x.m ? a.x.n : 0) +
                   fixed_smem_bytes<Cache, D, G>();
  if (smem > full) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;  // dynamic shared memory above 48 KB
  const int rc = lct_smem_opt_in(kernel, full, opted_in);
  if (rc) return rc;
  if (!dependent) {
    kernel<<<dim3(a.hkv, a.b, a.n_split), kThreads, smem, st>>>(a);
    return 0;
  }
  return lct_launch(kernel, dim3(a.hkv, a.b, a.n_split), dim3(kThreads), smem, st, true, a);
}

template <typename Cache, typename T, int D>
int launch_d(const Args& a, int g, bool dependent, cudaStream_t st) {
  int rc;
  switch (g) {
    case 1: rc = launch_g<Cache, T, D, 1>(a, dependent, st); break;
    case 2: rc = launch_g<Cache, T, D, 2>(a, dependent, st); break;
    case 4: rc = launch_g<Cache, T, D, 4>(a, dependent, st); break;
    case 8: rc = launch_g<Cache, T, D, 8>(a, dependent, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc || a.n_split == 1) return rc;
  return lct_launch(decode_merge_kernel<T, D>, dim3(a.b * a.hkv * g), dim3(D),
                    merge_smem_bytes(a), st, true, a, a.hkv * g);
}

// The pass over `Cache` with q (and out) of type T, for head_dim d and
// group size g, and its merge where n_split > 1; then cudaGetLastError().
// dependent: launched as a programmatic dependent of the stream's previous
// kernel (a tile pass of this call, whose partials are the extras).
template <typename Cache, typename T>
int dispatch(const Args& a, int g, int d, cudaStream_t st, bool dependent = false) {
  int rc;
  switch (d) {
    case 16: rc = launch_d<Cache, T, 16>(a, g, dependent, st); break;
    case 32: rc = launch_d<Cache, T, 32>(a, g, dependent, st); break;
    case 64: rc = launch_d<Cache, T, 64>(a, g, dependent, st); break;
    case 128: rc = launch_d<Cache, T, 128>(a, g, dependent, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// The launch's arguments, or false where the split does not cover the
// slots [lo0, S_max) exactly once (span a multiple of 32, n_split * span >=
// S_max - lo0 > (n_split - 1) * span) or a workspace is missing. ws:
// n_split > 1, a float32 workspace of n_split * B * H * (D + 2) elements;
// else unused. The caller sets the paged, shared-start, window and extras
// fields where it has them.
inline bool make_args(Args& a, const void* q, const void* k, const void* ks, const void* v,
                      const void* vs, const void* valid_len, void* out, void* ws, int b,
                      int s_max, int h, int hkv, int n_split, int span, float scale,
                      int lo0 = 0) {
  const int len = s_max - lo0;
  if (hkv <= 0 || h % hkv || n_split < 1 || span <= 0 || span % kChunk || lo0 < 0 ||
      len < 0 || (size_t)n_split * span < (size_t)len ||
      (size_t)(n_split - 1) * span >= (size_t)max(len, 1) || (n_split > 1 && !ws)) {
    return false;
  }
  const size_t bh = (size_t)b * h;
  float* w = static_cast<float*>(ws);
  a = Args{};
  a.q = q;
  a.k = k;
  a.ks = static_cast<const float*>(ks);
  a.v = v;
  a.vs = static_cast<const float*>(vs);
  a.valid_len = static_cast<const int*>(valid_len);
  a.out = out;
  a.pm = w;
  a.pl = w ? w + n_split * bh : nullptr;
  a.pacc = w ? w + 2 * n_split * bh : nullptr;
  a.b = b;
  a.s_max = s_max;
  a.hkv = hkv;
  a.span = span;
  a.n_split = n_split;
  a.scale = scale;
  a.lo0 = lo0;
  return true;
}

}  // namespace kv_split
}  // namespace
