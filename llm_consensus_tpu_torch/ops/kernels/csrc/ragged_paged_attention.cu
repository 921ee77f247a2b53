// K8: ragged paged attention — mixed decode rows, speculative-verify rows,
// one prefill-chunk row and shared-prefix groups over the serving page pool.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/attention.py
// (ragged_paged_attention -> _ragged_attention -> _ragged_kernel), on the
// pool layout: k/v [n_pages, pg, Hkv, D] in q's type or bfloat16 under
// float32 queries (the serving pool is bfloat16 whatever the weights),
// page_table [B, P] int32, valid_len [B]. Same semantics as there (query
// head h reads KV head h // G; softmax and the weighted sum of V in
// float32; output in q's type):
//   - a decode row b walks its own table from max(shared_start[b], the
//     window's edge) to valid_len[b]; with NQ queries per row (the verify
//     lane) query i sits at valid_len - NQ + i and sees slots <= its own
//     position (ragged causal), slots >= shared_start, and with a window
//     slots > position - window;
//   - the chunk row: C queries at chunk_start + i through chunk_table, the
//     same ragged-causal rule from slot 0;
//   - a group gi: every member's queries against the shared run [0,
//     group_end[gi]) read through group_rep[gi]'s table (no causal bound:
//     decode queries sit past the run; with a window each query's own
//     edge), merged into the member rows' partials by log-sum-exp.
// A row with nothing to read (valid_len 0: an idle slot) gives zeros, as
// the Pallas kernel does.
//
// The TPU kernel's sequential (program, page) grid, its scratch carried
// between grid steps, and its remap of dead pages to page 0 do not carry
// over. Here each block computes its own live slot range and reads only
// the pages in it: pages past a row's valid_len are not read at all. A
// slot with no sequence has a NULL table; the paged steps give such a row
// valid_len 0 (models/transformer._attn_len), so it reads nothing, however
// far its cache length has grown while it idled.
//
// What bounds it on the card: bytes. Each decode row reads its live K/V
// slots once (2 * slots * Hkv * D elements) and does ~4 * G * NQ
// operations per element read; a group's shared run is read once per
// group (per tile of 16 member queries: once at the serving shapes, up to
// 8 members of G = 2) instead of once per member; the chunk row reads its
// table's [0, chunk_start + C) once per tile of 16 (query, head) pairs
// and does ~4 * 16 operations per element read. All far below the card's
// ~295 operations per byte.
//
// Design. Up to three launches on the caller's stream:
//   1. group pass (when groups are given): one block per (kv head, group x
//      query tile, 64-slot split of the run). The block compacts the
//      group's member rows from group_id, stages the rep's pages 32 slots
//      at a time in shared memory (16-byte loads, the next chunk in flight
//      while the current one is used), each warp runs 2 member queries
//      over them, and the split's (max, sum, output) per query goes to a
//      float32 workspace. This is K7's prefix pass with the slot address
//      resolved through a table.
//   2. decode rows: NQ = 1, one block per (kv head, row); 8 warps split
//      the row's live slots round-robin, one slot's K/V row per step
//      serving all G query heads, online softmax in registers, then the
//      warps' partials and the group's splits merge by log-sum-exp (K3's
//      row kernel with a paged slot address). NQ > 1 (verify rows) take
//      the tile code of 3 per row.
//   3. the chunk row: one block per (kv head, tile of 16 (query, head)
//      pairs); the block stages the table's slots [first live, last
//      query's position] in shared memory as in 1 and each warp folds its
//      2 queries under the ragged-causal mask.
// Tensor-core score tiles, TMA and split-KV for long rows are later work.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kSplit = 64;   // run slots per block of the group pass
constexpr int kChunk = 32;   // slots staged in shared memory at once
constexpr int kQPerWarp = 2;
constexpr int kQPerBlock = kWarps * kQPerWarp;
constexpr int kMaxRows = 256;  // decode rows the group pass can scan

struct Args {
  const void* q;      // decode queries [B, NQ, H, D]
  const void* qc;     // chunk queries [C, H, D], or null
  const void* k;      // pool [n_pages, pg, Hkv, D]
  const void* v;
  const int* table;   // [B, P]
  const int* valid;   // [B]
  const int* ctable;  // [P], or null
  const int* gid;     // [B], or null (no groups)
  const int* rep;     // [Gm]
  const int* gend;    // [Gm] tokens
  const int* sstart;  // [B], or null (all 0)
  void* out;          // [B, NQ, H, D]
  void* out_c;        // [C, H, D]
  // Group partials: max and sum [n_split, B * NQ * H], normalized output
  // [n_split, B * NQ * H, D].
  float* pm;
  float* pl;
  float* pacc;
  int b, nq, hkv, g, pg, p_per, c, chunk_start, gm, n_split, window;
  float scale;
};

// Row index (of D elements) of (kv head kvh, slot) through a table row.
__device__ __forceinline__ size_t slot_row(const Args& a, const int* tbl,
                                           int slot, int kvh) {
  const int page = tbl[slot / a.pg];
  return ((size_t)page * a.pg + slot % a.pg) * a.hkv + kvh;
}

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Fold the group pass's splits for query (row b, query qi, head h) into a
// running (m, l, acc) state: m the max, l the sum at m, acc[e] the output
// dimensions e * 32 + lane (unnormalized, at m). Empty splits (m = -inf)
// are skipped. Only splits that cover the group's run were written.
template <int D>
__device__ __forceinline__ void merge_groups(const Args& a, int b, int qi,
                                             int h, int lane, float& m,
                                             float& l, float* acc) {
  constexpr int kDPL = (D + 31) / 32;
  if (a.gid == nullptr) return;
  const int gi = a.gid[b];
  if (gi < 0) return;
  const int ns = min(a.n_split, (a.gend[gi] + kSplit - 1) / kSplit);
  const size_t bqh = (size_t)a.b * a.nq * a.hkv * a.g;
  const size_t q_idx = ((size_t)b * a.nq + qi) * a.hkv * a.g + h;
  for (int sp = 0; sp < ns; ++sp) {
    const size_t idx = sp * bqh + q_idx;
    const float pm = a.pm[idx];
    if (pm == -INFINITY) continue;
    const float m_new = fmaxf(m, pm);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    const float w = a.pl[idx] * expf(pm - m_new);
    l = l * alpha + w;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = e * 32 + lane;
      acc[e] = acc[e] * alpha + (d < D ? w * a.pacc[idx * D + d] : 0.f);
    }
    m = m_new;
  }
}

// 2. Decode rows, NQ = 1. Grid (Hkv, B). TQ: the queries' and outputs'
// type; T: the pool's.
template <typename TQ, typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32) row_kernel(Args a) {
  constexpr int kDPL = (D + 31) / 32;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const TQ* __restrict__ q = static_cast<const TQ*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int b = blockIdx.y, kvh = blockIdx.x;
  const int h = a.hkv * G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int* tbl = a.table + (size_t)b * a.p_per;
  const int n = min(max(a.valid[b], 0), a.p_per * a.pg);
  int lo = a.sstart ? max(a.sstart[b], 0) : 0;
  if (a.window > 0) lo = max(lo, n - a.window);

  float qr[G][kDPL], acc[G][kDPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t q_off = ((size_t)b * h + kvh * G + g) * D;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = e * 32 + lane;
      qr[g][e] = d < D ? lct_to_float(q[q_off + d]) * a.scale : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  // Each warp loads its next slot's K/V row before working on the
  // current one, so a device-memory round trip overlaps the math.
  T kn[kDPL], vn[kDPL];
  auto load = [&](int slot) {
    const size_t r = slot_row(a, tbl, slot, kvh) * D;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = e * 32 + lane;
      kn[e] = d < D ? k[r + d] : lct_from_float<T>(0.f);
      vn[e] = d < D ? v[r + d] : lct_from_float<T>(0.f);
    }
  };
  if (lo + warp < n) load(lo + warp);
  for (int slot = lo + warp; slot < n; slot += kWarps) {
    float kr[kDPL], vr[kDPL];
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      kr[e] = lct_to_float(kn[e]);
      vr[e] = lct_to_float(vn[e]);
    }
    if (slot + kWarps < n) load(slot + kWarps);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc = 0.f;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) sc += qr[g][e] * kr[e];
      sc = lct_group_sum<32>(sc);
      const float m_new = fmaxf(m[g], sc);
      const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[e];
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
      const int d = e * 32 + lane;
      if (d < D) sm_acc[warp][g][d] = acc[g][e];
    }
  }
  __syncthreads();

  // Warp w merges head g = w (and w + 8, ...): the warps' partials, then
  // the group pass's splits; lane holds dimensions lane, lane + 32, ...
  for (int g = warp; g < G; g += kWarps) {
    float mt = -INFINITY, lt = 0.f, at[kDPL];
#pragma unroll
    for (int e = 0; e < kDPL; ++e) at[e] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float pm = sm_m[w][g];
      if (pm == -INFINITY) continue;
      const float m_new = fmaxf(mt, pm);
      const float alpha = (mt == -INFINITY) ? 0.f : expf(mt - m_new);
      const float c = expf(pm - m_new);
      lt = lt * alpha + sm_l[w][g] * c;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) {
        const int d = e * 32 + lane;
        at[e] = at[e] * alpha + (d < D ? sm_acc[w][g][d] * c : 0.f);
      }
      mt = m_new;
    }
    merge_groups<D>(a, b, 0, kvh * G + g, lane, mt, lt, at);
    const size_t o_off = ((size_t)b * h + kvh * G + g) * D;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) {
        static_cast<TQ*>(a.out)[o_off + d] =
            lct_from_float<TQ>(lt > 0.f ? at[e] / lt : 0.f);
      }
    }
  }
}

// 1 and 3: the tile code. kGroup: the group pass (grid (Hkv, Gm * tiles,
// n_split)); else query rows with the ragged-causal rule (grid (Hkv,
// tiles, rows)): the chunk row when chunk_row, else verify row blockIdx.z.
//
// Per staged chunk of 32 slots, lane s of a warp scores slot s for the
// warp's queries against the query held in shared memory, so the chunk
// needs one max reduction and one exp per lane instead of one online-
// softmax update per slot; the probabilities are then broadcast by shuffle
// for the weighted sum of V, where lane i holds dimensions i, i + 32, ...
template <typename TQ, typename T, int D, bool kGroup>
__global__ void __launch_bounds__(kWarps * 32)
    tile_kernel(Args a, int tiles, int chunk_row) {
  constexpr int kDPL = (D + 31) / 32;
  constexpr int kElemPerVec = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = D / kElemPerVec;
  constexpr int kVecPerThread =
      (kChunk * kVecPerRow + kWarps * 32 - 1) / (kWarps * 32);
  // K rows padded by one vector so that 32 lanes reading 32 rows hit
  // distinct banks.
  __shared__ __align__(16) T sk[kChunk][D + kElemPerVec];
  __shared__ __align__(16) T sv[kChunk][D];
  __shared__ __align__(16) float sq[kWarps][kQPerWarp][D];
  __shared__ int members[kGroup ? kMaxRows : 1];
  __shared__ int n_members;

  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int kvh = blockIdx.x, g_size = a.g, h = a.hkv * a.g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tile = kGroup ? blockIdx.y % tiles : blockIdx.y;

  // The block's rows: a table, the query count per row, the live range.
  const int* tbl;
  int nqr, kvlen = 0, lo = 0, hi = 0, gi = 0, row = 0;
  if (kGroup) {
    gi = blockIdx.y / tiles;
    const int ge = min(a.gend[gi], a.p_per * a.pg);
    lo = blockIdx.z * kSplit;
    hi = min(ge, lo + kSplit);
    if (lo >= hi) return;  // a split past the run: nobody reads it
    if (threadIdx.x == 0) {
      int cnt = 0;
      for (int r = 0; r < a.b && cnt < kMaxRows; ++r) {
        if (a.gid[r] == gi) members[cnt++] = r;
      }
      n_members = cnt;
    }
    __syncthreads();
    tbl = a.table + (size_t)a.rep[gi] * a.p_per;
    nqr = a.nq;
  } else if (chunk_row) {
    tbl = a.ctable;
    nqr = a.c;
    kvlen = a.chunk_start + a.c;
  } else {
    row = blockIdx.z;
    tbl = a.table + (size_t)row * a.p_per;
    nqr = a.nq;
    kvlen = a.valid[row];
    lo = a.sstart ? max(a.sstart[row], 0) : 0;
  }
  const int nq_total = kGroup ? n_members * nqr * g_size : nqr * g_size;
  const int j_first = tile * kQPerBlock;
  if (j_first >= nq_total) return;  // the whole block has no query
  const int j_last = min(nq_total, j_first + kQPerBlock) - 1;
  if (!kGroup) {
    // Slots the tile's queries can see: up to the last query's position,
    // from the first query's window edge.
    const int qpos_first = kvlen - nqr + j_first / g_size;
    const int qpos_last = kvlen - nqr + j_last / g_size;
    hi = min(qpos_last + 1, a.p_per * a.pg);
    if (a.window > 0) lo = max(lo, qpos_first + 1 - a.window);
  }
  lo = max(lo, 0);

  // This warp's queries: (row, query index, head), its position and its
  // lowest visible slot.
  const int j0 = j_first + warp * kQPerWarp;
  int q_row[kQPerWarp], q_i[kQPerWarp], q_h[kQPerWarp];
  int q_hi[kQPerWarp], q_lo[kQPerWarp];
  float m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][kDPL];
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    const int j = j0 + i;
    const bool ok = j < nq_total;
    int r, qi, gg;
    if (kGroup) {
      const int per = nqr * g_size;
      r = ok ? members[j / per] : 0;
      qi = (j % per) / g_size;
      gg = j % g_size;
    } else {
      r = row;
      qi = j / g_size;
      gg = j % g_size;
    }
    q_row[i] = r;
    q_i[i] = qi;
    q_h[i] = kvh * g_size + gg;
    if (kGroup) {
      q_hi[i] = ok ? hi : lo;  // the run: no causal bound
      q_lo[i] = lo;
      if (ok && a.window > 0) {
        q_lo[i] = max(lo, a.valid[r] - nqr + qi + 1 - a.window);
      }
    } else {
      const int qpos = kvlen - nqr + qi;
      q_hi[i] = ok ? qpos + 1 : lo;
      q_lo[i] = lo;
      if (a.window > 0) q_lo[i] = max(lo, qpos + 1 - a.window);
    }
    const TQ* qp;
    size_t q_off;
    if (!kGroup && chunk_row) {
      qp = static_cast<const TQ*>(a.qc);
      q_off = ((size_t)qi * h + q_h[i]) * D;
    } else {
      qp = static_cast<const TQ*>(a.q);
      q_off = (((size_t)r * nqr + qi) * h + q_h[i]) * D;
    }
    for (int d = lane; d < D; d += 32) {
      sq[warp][i][d] = ok ? lct_to_float(qp[q_off + d]) * a.scale : 0.f;
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
  auto load = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kVecPerThread; ++r) {
      const int idx = threadIdx.x + r * kWarps * 32;
      const int s = idx / kVecPerRow, c = idx % kVecPerRow;
      if (s < kChunk && c0 + s < hi) {
        const size_t off = slot_row(a, tbl, c0 + s, kvh) * D;
        kbuf[r] = reinterpret_cast<const uint4*>(k + off)[c];
        vbuf[r] = reinterpret_cast<const uint4*>(v + off)[c];
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
    __syncthreads();
    if (c0 + kChunk < hi) load(c0 + kChunk);
    if (j0 >= nq_total) continue;  // this warp has no query (it still syncs)

    float sc[kQPerWarp];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) sc[i] = 0.f;
    if (lane < nc) {
      const uint4* krow = reinterpret_cast<const uint4*>(sk[lane]);
#pragma unroll 4
      for (int c = 0; c < kVecPerRow; ++c) {
        float kf[kElemPerVec];
        unpack16<T>(krow[c], kf);
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
    }
    const int slot = c0 + lane;
    float p[kQPerWarp];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) {
      const bool ok = lane < nc && slot >= q_lo[i] && slot < q_hi[i];
      const float s_lane = ok ? sc[i] : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s_lane));
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_new);
      p[i] = ok ? expf(s_lane - m_new) : 0.f;
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
        const float ps = __shfl_sync(0xffffffffu, p[i], s);
#pragma unroll
        for (int e = 0; e < kDPL; ++e) acc[i][e] += ps * vr[e];
      }
    }
  }

  const size_t bqh = (size_t)a.b * a.nq * h;
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    const int j = j0 + i;
    float l_tot = lct_group_sum<32>(l[i]);  // every lane takes part
    if (j >= nq_total) continue;
    if (kGroup) {
      const size_t idx = blockIdx.z * bqh +
                         ((size_t)q_row[i] * a.nq + q_i[i]) * h + q_h[i];
      if (lane == 0) {
        a.pm[idx] = m[i];
        a.pl[idx] = l_tot;
      }
      const float inv = l_tot > 0.f ? 1.f / l_tot : 0.f;
#pragma unroll
      for (int e = 0; e < kDPL; ++e) {
        const int d = e * 32 + lane;
        if (d < D) a.pacc[idx * D + d] = acc[i][e] * inv;
      }
      continue;
    }
    float mt = m[i];
    if (!chunk_row) merge_groups<D>(a, q_row[i], q_i[i], q_h[i], lane, mt, l_tot, acc[i]);
    TQ* out;
    size_t o_off;
    if (chunk_row) {
      out = static_cast<TQ*>(a.out_c);
      o_off = ((size_t)q_i[i] * h + q_h[i]) * D;
    } else {
      out = static_cast<TQ*>(a.out);
      o_off = (((size_t)q_row[i] * a.nq + q_i[i]) * h + q_h[i]) * D;
    }
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) out[o_off + d] = lct_from_float<TQ>(l_tot > 0.f ? acc[i][e] / l_tot : 0.f);
    }
  }
}

template <typename TQ, typename T, int D>
int launch_rows(const Args& a, cudaStream_t st) {
  const dim3 grid(a.hkv, a.b);
  switch (a.g) {
    case 1: row_kernel<TQ, T, D, 1><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 2: row_kernel<TQ, T, D, 2><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 4: row_kernel<TQ, T, D, 4><<<grid, kWarps * 32, 0, st>>>(a); break;
    case 8: row_kernel<TQ, T, D, 8><<<grid, kWarps * 32, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename TQ, typename T, int D>
int launch_d(const Args& a, cudaStream_t st) {
  const int threads = kWarps * 32;
  if (a.b > 0 && a.gm > 0) {  // 1. group pass
    const int tiles = (a.b * a.nq * a.g + kQPerBlock - 1) / kQPerBlock;
    const dim3 grid(a.hkv, a.gm * tiles, a.n_split);
    tile_kernel<TQ, T, D, true><<<grid, threads, 0, st>>>(a, tiles, 0);
  }
  if (a.b > 0) {  // 2. decode rows
    if (a.nq == 1) {
      const int rc = launch_rows<TQ, T, D>(a, st);
      if (rc) return rc;
    } else {
      const int tiles = (a.nq * a.g + kQPerBlock - 1) / kQPerBlock;
      const dim3 grid(a.hkv, tiles, a.b);
      tile_kernel<TQ, T, D, false><<<grid, threads, 0, st>>>(a, tiles, 0);
    }
  }
  if (a.c > 0) {  // 3. the chunk row
    const int tiles = (a.c * a.g + kQPerBlock - 1) / kQPerBlock;
    const dim3 grid(a.hkv, tiles, 1);
    tile_kernel<TQ, T, D, false><<<grid, threads, 0, st>>>(a, tiles, 1);
  }
  return 0;
}

template <typename TQ, typename T>
int dispatch_d(const Args& a, int d, cudaStream_t st) {
  switch (d) {
    case 16: return launch_d<TQ, T, 16>(a, st);
    case 32: return launch_d<TQ, T, 32>(a, st);
    case 64: return launch_d<TQ, T, 64>(a, st);
    case 128: return launch_d<TQ, T, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, NQ, H, D]; k, v: [n_pages, pg, Hkv, D]; page_table: [B, P] int32;
// valid_len: [B] int32; q_chunk: [C, H, D] and chunk_table: [P] int32 (C =
// 0: no chunk row, both may be null); group_id [B], group_rep [Gm],
// group_end [Gm] int32 (Gm = 0: no groups, all may be null); shared_start
// [B] int32 or null; out: [B, NQ, H, D]; out_chunk: [C, H, D]; ws: float32
// workspace of n_split * B * NQ * H * (D + 2) elements, n_split =
// ceil(P * pg / 64) (null without groups). All contiguous on the card.
// dtype: q's, q_chunk's and the outputs' type; kv_dtype: the pools' (the
// same, or float32 queries over a bfloat16 pool). H = Hkv * G.
extern "C" int lct_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* valid_len, const void* q_chunk, const void* chunk_table,
    const void* group_id, const void* group_rep, const void* group_end,
    const void* shared_start, void* out, void* out_chunk, void* ws, int b,
    int nq, int h, int hkv, int d, int pg, int p_per, int c, int chunk_start,
    int gm, int window, float scale, int dtype, int kv_dtype, void* stream) {
  if (hkv <= 0 || h % hkv || b > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.qc = q_chunk;
  a.k = k;
  a.v = v;
  a.table = static_cast<const int*>(page_table);
  a.valid = static_cast<const int*>(valid_len);
  a.ctable = static_cast<const int*>(chunk_table);
  a.gid = gm > 0 ? static_cast<const int*>(group_id) : nullptr;
  a.rep = static_cast<const int*>(group_rep);
  a.gend = static_cast<const int*>(group_end);
  a.sstart = static_cast<const int*>(shared_start);
  a.out = out;
  a.out_c = out_chunk;
  a.b = b;
  a.nq = nq;
  a.hkv = hkv;
  a.g = h / hkv;
  a.pg = pg;
  a.p_per = p_per;
  a.c = c;
  a.chunk_start = chunk_start;
  a.gm = gm;
  a.n_split = (p_per * pg + kSplit - 1) / kSplit;
  a.window = window;
  a.scale = scale;
  const size_t bqh = (size_t)b * nq * h;
  float* w = static_cast<float*>(ws);
  a.pm = w;
  a.pl = w ? w + a.n_split * bqh : nullptr;
  a.pacc = w ? w + 2 * a.n_split * bqh : nullptr;
  if (gm > 0 && w == nullptr) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == LCT_DTYPE_F32 && kv_dtype == LCT_DTYPE_F32) {
    rc = dispatch_d<float, float>(a, d, st);
  } else if (dtype == LCT_DTYPE_BF16 && kv_dtype == LCT_DTYPE_BF16) {
    rc = dispatch_d<__nv_bfloat16, __nv_bfloat16>(a, d, st);
  } else if (dtype == LCT_DTYPE_F32 && kv_dtype == LCT_DTYPE_BF16) {
    rc = dispatch_d<float, __nv_bfloat16>(a, d, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
