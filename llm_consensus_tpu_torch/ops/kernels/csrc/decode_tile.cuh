// The tile pass: attention of many queries over slots they all read. One
// pass, templated on where a slot's row lies (decode_split.cuh's layouts)
// and run in one of four modes, serves every place where that happens:
//
// - kPrefix (K7, K7-q8): every (row, head) query of the fan-out against row
//   0's slots [0, prefix_len) of the dense or the int8 cache, which every
//   row shares. Writes partials.
// - kGroup (K8's group pass): every member query of a group against the
//   shared run [0, group_end) read through the representative's page
//   table; no causal bound, with a window each query's own edge. The
//   members are found on the card from group_id. Writes partials.
// - kChunk (K8's chunk row): the C queries of the prefill chunk at
//   chunk_start + i against the chunk table's slots, ragged causal (slots
//   <= the query's position), with the window where one is set. Writes the
//   chunk's output.
// - kVerify (K8's verify rows, NQ > 1): row b's NQ queries at valid_len -
//   NQ + i against its own table from shared_start, ragged causal, with
//   the window; merges the row's group partials first. Writes the output.
//
// Partials are (max, sum, unnormalised output) per query and split of the
// run, as decode_split.cuh's extras: it merges them into the decode rows'
// results first, in split order, so a result is the same bits on every
// run. Queries (query, head) are flattened as query * G + head (in a
// group, member-major), so one block serves all G heads of its kv head and
// every slot it stages is read by all of them.
//
// What bounds it on the card: operations on the CUDA cores, where the
// tensor cores would not be. A block of R query rows does 4 * R operations
// per element it reads; at the fan-out's N = 64 with G = 2 that is 512 an
// element read once per 64 rows, far past float32's ridge (~20 a byte on
// the H100's CUDA cores) and near bf16's on the tensor cores (~295).
//
// Two kernels, picked by the queries' type.
//
// bf16 queries (tile_mma_kernel): the tensor cores, mma.sync m16n8k16, as
// K2 (causal_attention.cu). A block of 4 warps takes 64 (query, head) rows,
// each warp 16 with its Q fragments in registers; the block stages 64-slot
// K/V tiles by 16-byte cp.async in two stages (rows padded by 16 bytes for
// ldmatrix), so a slot of the run is read once per 64 rows. Scores in
// float32, times d^-1/2 (and the int8 cache's K scale, per column); each
// row's visible slots [lo, hi) masked per element; the online softmax on
// the accumulator fragments; P into P * V as hi = bf16(P) plus lo =
// bf16(P - hi) (rounding P to bf16 alone misses the one-bf16-ulp
// tolerance by ~100x, K2 found), the int8 cache's V scale multiplied into
// P's columns before the split while the row sums keep the true p. The int8
// cache is staged as bytes and turned into an exact bf16 tile in shared
// memory (the byte permute of i8x4_to_float, the top halves of two floats
// packed by a second permute), so the same fragment code serves it. Tiles
// that none of a warp's rows can see are skipped by that warp.
//
// float32 queries (tile_cc_kernel): the parity path, held to 1e-4, which no
// bf16 split of q . k holds: the CUDA cores in float32. A block of 8 warps
// takes 16 rows, 2 a warp; 32-slot chunks staged in shared memory (the next
// chunk's loads in flight in registers), lane s scoring slot s for the
// warp's rows, one online-softmax update a chunk, then P * V with p
// broadcast by shuffle.
#pragma once

#include <limits.h>

#include "decode_split.cuh"

namespace {
namespace kv_tile {

using kv_split::Extra;

constexpr int kBK = 64;       // slots a tile (bf16 kernel)
constexpr int kStages = 2;    // tiles in flight: one copied while one is used
constexpr int kWarps = 4;     // bf16 kernel: 16 rows a warp
constexpr int kRows = kWarps * 16;
constexpr int kCcWarps = 8;   // float32 kernel: 2 rows a warp
constexpr int kCcQPerWarp = 2;
constexpr int kCcRows = kCcWarps * kCcQPerWarp;
constexpr int kCcChunk = 32;  // slots a staged chunk (float32 kernel)
constexpr int kMaxRows = 256; // decode rows the group pass can scan

enum Mode : int { kPrefix = 0, kGroup = 1, kChunk = 2, kVerify = 3 };

struct Args {
  int mode;
  const void* q;      // kPrefix [B, 1, H, D]; kGroup, kVerify [B, NQ, H, D]; kChunk [C, H, D]
  const void* k;      // the cache or the pool
  const void* v;
  const float* ks;    // the int8 cache's scales; else null
  const float* vs;
  const int* table;   // kGroup, kVerify [B, P]; kChunk the chunk's table [P]
  const int* valid;   // [B]
  const int* gid;     // kGroup: [B] group of each row (-1: none)
  const int* rep;     // kGroup: [Gm] the row whose table maps the run
  const int* gend;    // kGroup: [Gm] the run's length in slots
  const int* sstart;  // kVerify: [B] first slot of a row's own walk, or null
  void* out;          // kChunk [C, H, D]; kVerify [B, NQ, H, D]
  // kPrefix, kGroup: [n_split, rows] max and sum, [n_split, rows, D]
  // unnormalised output; rows = B * NQ * H.
  float* pm;
  float* pl;
  float* pacc;
  Extra x;            // kVerify: the group partials
  int b, nq, hkv, g, s_max, pg, p_per, c, chunk_start, window;
  int run;            // kPrefix: the prefix length
  int span;           // kPrefix, kGroup: slots a split of the run
  int tiles;          // row tiles of a block column (kGroup: of a group)
  float scale;
};

// What a block reads: slots [lo, hi) of the sequence `seq` (its table row
// tbl), its first (query, head) row j0 of n_rows, and its split.
struct Block {
  int lo, hi, j0, n_rows, split, seq;
  const int* tbl;
};

// One (query, head) row: its query's and output's index (query * H + head,
// in rows of D), the batch row it belongs to, and the slots it sees.
struct RowQ {
  bool ok;
  int b, lo, hi;
  size_t idx;
};

__device__ __forceinline__ int table_slots(const Args& a) { return a.p_per * a.pg; }

// Row j of the block column, with the block's slot range `bk`.
__device__ __forceinline__ RowQ row_q(const Args& a, const Block& bk, const int* members,
                                      int kvh, int j) {
  RowQ r{false, 0, INT_MAX, INT_MIN, 0};
  if (j >= bk.n_rows) return r;
  const int h_all = a.hkv * a.g, head = kvh * a.g + j % a.g;
  r.ok = true;
  r.lo = bk.lo;
  r.hi = bk.hi;
  switch (a.mode) {
    case kPrefix:
      r.b = j / a.g;
      r.idx = (size_t)r.b * h_all + head;
      break;
    case kGroup: {
      const int per = a.nq * a.g, qi = (j % per) / a.g;
      r.b = members[j / per];
      r.idx = ((size_t)r.b * a.nq + qi) * h_all + head;
      if (a.window > 0) r.lo = max(r.lo, a.valid[r.b] - a.nq + qi + 1 - a.window);
      break;
    }
    default: {  // kChunk, kVerify: ragged causal
      const int qi = j / a.g;
      int pos;
      if (a.mode == kChunk) {
        pos = a.chunk_start + qi;
        r.idx = (size_t)qi * h_all + head;
      } else {
        r.b = bk.seq;
        pos = a.valid[r.b] - a.nq + qi;
        r.idx = ((size_t)r.b * a.nq + qi) * h_all + head;
      }
      if (a.window > 0) r.lo = max(r.lo, pos + 1 - a.window);
      r.hi = min(r.hi, pos + 1);
    }
  }
  return r;
}

// The block's slots and rows; false where it has nothing to write (a split
// past a group's run, a group with no member, rows past the last).
// `members` / `n_members`: shared memory the group scan fills.
__device__ __forceinline__ bool block_setup(const Args& a, int rows_per_block, int* members,
                                            int* n_members, Block& bk) {
  const int slots = a.mode == kPrefix ? a.s_max : table_slots(a);
  bk.split = blockIdx.z;
  bk.seq = 0;
  bk.tbl = nullptr;
  int tile = blockIdx.y;
  switch (a.mode) {
    case kPrefix:
      bk.lo = bk.split * a.span;
      bk.hi = min(a.run, bk.lo + a.span);
      bk.n_rows = a.b * a.g;
      break;
    case kGroup: {
      const int gi = blockIdx.y / a.tiles;
      tile = blockIdx.y % a.tiles;
      bk.lo = bk.split * a.span;
      bk.hi = min(min(a.gend[gi], slots), bk.lo + a.span);
      if (bk.lo >= bk.hi) return false;  // past the run: nobody counts it
      if (threadIdx.x == 0) {
        int cnt = 0;
        for (int r = 0; r < a.b && cnt < kMaxRows; ++r) {
          if (a.gid[r] == gi) members[cnt++] = r;
        }
        *n_members = cnt;
      }
      __syncthreads();
      bk.n_rows = *n_members * a.nq * a.g;
      bk.tbl = a.table + (size_t)a.rep[gi] * a.p_per;
      break;
    }
    case kChunk:
      bk.lo = 0;
      bk.hi = slots;
      bk.n_rows = a.c * a.g;
      bk.tbl = a.table;
      break;
    default:  // kVerify
      bk.seq = blockIdx.z;
      bk.split = 0;
      bk.lo = a.sstart != nullptr ? max(a.sstart[bk.seq], 0) : 0;
      bk.hi = slots;
      bk.n_rows = a.nq * a.g;
      bk.tbl = a.table + (size_t)bk.seq * a.p_per;
  }
  bk.j0 = tile * rows_per_block;
  if (bk.j0 >= bk.n_rows) return false;
  if (a.mode == kChunk || a.mode == kVerify) {
    // The rows sit in position order: the first sees the lowest slots, the
    // last the highest.
    const int j1 = min(bk.n_rows, bk.j0 + rows_per_block) - 1;
    const RowQ first = row_q(a, bk, members, blockIdx.x, bk.j0);
    const RowQ last = row_q(a, bk, members, blockIdx.x, j1);
    bk.lo = max(first.lo, 0);
    bk.hi = last.hi;
  }
  return true;
}

// ---------------------------------------------------------------------------
// bf16 queries: the tensor cores
// ---------------------------------------------------------------------------

template <typename Cache, int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  constexpr int kTile = kBK * (D + 8) * 2;  // a bf16 K or V tile, rows padded
  if constexpr (Cache::kScaled) {
    // Byte stages of K and V, their scales, and one bf16 K and V tile.
    return kStages * 2 * kBK * D + kStages * 2 * kBK * 4 + 2 * kTile;
  } else {
    return kStages * 2 * kTile;
  }
}

// (a, b) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), low half first.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Sixteen int8 values as sixteen bf16 (exact), in order.
__device__ __forceinline__ void i8x16_to_bf16(const uint4& w, uint4& lo, uint4& hi) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t o[8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float f[4];
    kv_split::i8x4_to_float(in[u], f);
    o[2 * u] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    o[2 * u + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

template <typename Cache, int D>
__device__ __forceinline__ void mma_body(const Args& a) {
  constexpr bool kQ8 = Cache::kScaled;
  constexpr int kStride = D + 8;        // bf16 per staged row
  constexpr int kTile = kBK * kStride;  // bf16 per staged K (or V) tile
  constexpr int kKS = D / 16;           // k16-steps of Q * K^T
  constexpr int kND = D / 8;            // n8-tiles of the output
  constexpr int kThreads = kWarps * 32;
  using E = typename Cache::Elem;
  constexpr int kPerVec = 16 / (int)sizeof(E);
  constexpr int kVec = D / kPerVec;     // 16-byte vectors a staged row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int members[kMaxRows];
  __shared__ int n_members;
  // bf16: [stage][key][kStride] K tiles, then V. int8: byte stages
  // [stage][K, V][key][D], scales [stage][K, V][key], then one bf16 K and V
  // tile.
  __nv_bfloat16* kt_all = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* raw = reinterpret_cast<int8_t*>(smem);
  float* raw_s = reinterpret_cast<float*>(smem + kStages * 2 * kBK * D);
  __nv_bfloat16* conv =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * 2 * kBK * D + kStages * 2 * kBK * 4);

  lct_pdl_trigger();  // a dependent (the split pass, the merge) may start
  Block bk;
  if (!block_setup(a, kRows, members, &n_members, bk)) return;
  const int kvh = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wrow = bk.j0 + warp * 16;
  const RowQ rA = row_q(a, bk, members, kvh, wrow + g8);
  const RowQ rB = row_q(a, bk, members, kvh, wrow + g8 + 8);

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const int c = kk * 16 + 2 * t4;
    const size_t oA = rA.idx * D + c, oB = rB.idx * D + c;
    qf[kk][0] = rA.ok ? *reinterpret_cast<const uint32_t*>(q + oA) : 0u;
    qf[kk][1] = rB.ok ? *reinterpret_cast<const uint32_t*>(q + oB) : 0u;
    qf[kk][2] = rA.ok ? *reinterpret_cast<const uint32_t*>(q + oA + 8) : 0u;
    qf[kk][3] = rB.ok ? *reinterpret_cast<const uint32_t*>(q + oB + 8) : 0u;
  }
  // The slots any of the warp's rows sees.
  int wlo = min(rA.lo, rB.lo), whi = max(rA.hi, rB.hi);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;

  const Cache seq(bk.seq, bk.tbl, kvh, a.s_max, a.hkv, a.pg);
  const E* kc = static_cast<const E*>(a.k);
  const E* vc = static_cast<const E*>(a.v);
  const int n_tiles = bk.hi > bk.lo ? (bk.hi - bk.lo + kBK - 1) / kBK : 0;
  auto load = [&](int t) {
    const int s0 = bk.lo + t * kBK, st = t % kStages;
#pragma unroll
    for (int i = tid; i < kBK * kVec; i += kThreads) {
      const int s = i / kVec, c = i % kVec;
      const bool in = s0 + s < bk.hi;
      const size_t src = seq.row(min(s0 + s, bk.hi - 1)) * D + c * kPerVec;
      if constexpr (kQ8) {
        lct_cp_async16(raw + ((st * 2 + 0) * kBK + s) * D + c * 16, kc + src, in);
        lct_cp_async16(raw + ((st * 2 + 1) * kBK + s) * D + c * 16, vc + src, in);
      } else {
        __nv_bfloat16* kd = kt_all + st * kTile;
        __nv_bfloat16* vd = kt_all + (kStages + st) * kTile;
        lct_cp_async16(kd + s * kStride + c * 8, kc + src, in);
        lct_cp_async16(vd + s * kStride + c * 8, vc + src, in);
      }
    }
    if constexpr (kQ8) {
      for (int s = tid; s < kBK; s += kThreads) {
        const bool in = s0 + s < bk.hi;
        const size_t r = seq.row(min(s0 + s, bk.hi - 1));
        lct_cp_async4(raw_s + (st * 2 + 0) * kBK + s, a.ks + r, in);
        lct_cp_async4(raw_s + (st * 2 + 1) * kBK + s, a.vs + r, in);
      }
    }
    lct_cp_async_commit();
  };

  if (n_tiles > 0) load(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(t + 1);  // its stage was last read before the previous barrier
      lct_cp_async_wait<1>();
    } else {
      lct_cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    const int s0 = bk.lo + t * kBK, st = t % kStages;
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const float* kscale = raw_s + (st * 2 + 0) * kBK;
    const float* vscale = raw_s + (st * 2 + 1) * kBK;
    if constexpr (kQ8) {
      // The staged bytes into the bf16 tiles, exactly.
      for (int i = tid; i < 2 * kBK * (D / 16); i += kThreads) {
        const int kv = i / (kBK * (D / 16)), s = (i / (D / 16)) % kBK, c = i % (D / 16);
        const uint4 w =
            *reinterpret_cast<const uint4*>(raw + ((st * 2 + kv) * kBK + s) * D + c * 16);
        uint4 lo, hi;
        i8x16_to_bf16(w, lo, hi);
        uint4* dst = reinterpret_cast<uint4*>(conv + kv * kTile + s * kStride + c * 16);
        dst[0] = lo;
        dst[1] = hi;
      }
      __syncthreads();
      kt = conv;
      vt = conv + kTile;
    } else {
      kt = kt_all + st * kTile;
      vt = kt_all + (kStages + st) * kTile;
    }
    if (s0 < whi && s0 + kBK > wlo) {
      // Scores: 8 n8-tiles of slots.
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
      // Scale (and the K scale), mask each row to its slots, row maxima.
      float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1), slot = s0 + col;
          float x = sc[nt][e] * a.scale;
          if constexpr (kQ8) x *= kscale[col];
          const bool vis = e < 2 ? (slot >= rA.lo && slot < rA.hi) : (slot >= rB.lo && slot < rB.hi);
          sc[nt][e] = vis ? x : -INFINITY;
        }
        xA = fmaxf(xA, fmaxf(sc[nt][0], sc[nt][1]));
        xB = fmaxf(xB, fmaxf(sc[nt][2], sc[nt][3]));
      }
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
      // A row that has seen nothing yet keeps max -inf; exp against 0 then
      // gives 0 for every masked score and rescales nothing.
      const float nA = fmaxf(mA, xA), nB = fmaxf(mB, xB);
      const float uA = nA == -INFINITY ? 0.f : nA, uB = nB == -INFINITY ? 0.f : nB;
      const float aA = expf(mA - uA), aB = expf(mB - uB);
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
        sc[nt][0] = expf(sc[nt][0] - uA);
        sc[nt][1] = expf(sc[nt][1] - uA);
        sc[nt][2] = expf(sc[nt][2] - uB);
        sc[nt][3] = expf(sc[nt][3] - uB);
        lA += sc[nt][0] + sc[nt][1];
        lB += sc[nt][2] + sc[nt][3];
        if constexpr (kQ8) {  // the V scale into P's columns only
          const int col = nt * 8 + 2 * t4;
          sc[nt][0] *= vscale[col];
          sc[nt][1] *= vscale[col + 1];
          sc[nt][2] *= vscale[col];
          sc[nt][3] *= vscale[col + 1];
        }
      }
      // O += P * V, P as hi + lo bf16. The score fragments of n8-tiles
      // 2j and 2j + 1 are the A fragment of slots [16j, 16j + 16).
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

  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  if (a.mode == kPrefix || a.mode == kGroup) {
    const size_t base = (size_t)bk.split * a.b * a.nq * a.hkv * a.g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const RowQ& r = half ? rB : rA;
      if (!r.ok) continue;
      const size_t i = base + r.idx;
      if (t4 == 0) {
        a.pm[i] = half ? mB : mA;
        a.pl[i] = half ? lB : lA;
      }
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        *reinterpret_cast<float2*>(a.pacc + i * D + nd * 8 + 2 * t4) =
            make_float2(o[nd][2 * half], o[nd][2 * half + 1]);
      }
    }
    return;
  }
  // kChunk, kVerify: the row's extras (kVerify's group partials) first,
  // then this block's state; the output in bf16.
  lct_pdl_wait();  // the extras' pass has finished
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const RowQ& r = half ? rB : rA;
    if (!r.ok) continue;
    const float m = half ? mB : mA, l = half ? lB : lA;
    const int nx = a.mode == kVerify ? a.x.count(r.b) : 0;
    float mx = m;
    for (int i = 0; i < nx; ++i) mx = fmaxf(mx, a.x.max_at(i, r.idx));
    float tot_l = 0.f, tot[kND][2];
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) tot[nd][0] = tot[nd][1] = 0.f;
    if (mx != -INFINITY) {
      for (int i = 0; i < nx; ++i) {
        const float pm = a.x.max_at(i, r.idx);
        if (pm == -INFINITY) continue;
        const float c = expf(pm - mx);
        tot_l += a.x.sum_at(i, r.idx) * c;
        const float* xa = a.x.template acc_at<D>(i, r.idx);
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          const float2 v = *reinterpret_cast<const float2*>(xa + nd * 8 + 2 * t4);
          tot[nd][0] += v.x * c;
          tot[nd][1] += v.y * c;
        }
      }
      if (m != -INFINITY) {
        const float c = expf(m - mx);
        tot_l += l * c;
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          tot[nd][0] += o[nd][2 * half] * c;
          tot[nd][1] += o[nd][2 * half + 1] * c;
        }
      }
    }
    const float inv = tot_l > 0.f ? 1.f / tot_l : 0.f;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(out + r.idx * D + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(tot[nd][0] * inv, tot[nd][1] * inv);
    }
  }
}

template <typename Cache, int D>
__global__ void __launch_bounds__(kWarps * 32) tile_mma_kernel(Args a) {
  mma_body<Cache, D>(a);
  lct_pdl_wait();  // a dependent in a chain ends only after what it follows
}

// ---------------------------------------------------------------------------
// float32 queries: the CUDA cores
// ---------------------------------------------------------------------------

template <typename Cache, int D>
__device__ __forceinline__ void cc_body(const Args& a) {
  using E = typename Cache::Elem;
  constexpr int kThreads = kCcWarps * 32;
  constexpr int kDPL = (D + 31) / 32;
  // A slot's K (or V) row of one kv head is D * sizeof(E) contiguous bytes,
  // moved as 16-byte vectors. K rows are padded by one vector so that 32
  // lanes reading 32 rows hit distinct banks.
  constexpr int kPerVec = 16 / (int)sizeof(E);
  constexpr int kVec = D / kPerVec;
  constexpr int kVecPerThread = (kCcChunk * kVec + kThreads - 1) / kThreads;
  __shared__ __align__(16) E sk[kCcChunk][D + kPerVec];
  __shared__ __align__(16) E sv[kCcChunk][D];
  __shared__ float sks[kCcChunk], svs[kCcChunk];  // the int8 cache's scales
  __shared__ __align__(16) float sq[kCcWarps][kCcQPerWarp][D];
  __shared__ int members[kMaxRows];
  __shared__ int n_members;

  lct_pdl_trigger();
  Block bk;
  if (!block_setup(a, kCcRows, members, &n_members, bk)) return;
  const int kvh = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* q = static_cast<const float*>(a.q);
  RowQ rq[kCcQPerWarp];
  float m[kCcQPerWarp], l[kCcQPerWarp], acc[kCcQPerWarp][kDPL];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kCcQPerWarp; ++i) {
    rq[i] = row_q(a, bk, members, kvh, bk.j0 + warp * kCcQPerWarp + i);
    any |= rq[i].ok;
    for (int d = lane; d < D; d += 32) {
      sq[warp][i][d] = rq[i].ok ? q[rq[i].idx * D + d] * a.scale : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[i][e] = 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  __syncwarp();  // each warp reads only its own queries

  const Cache seq(bk.seq, bk.tbl, kvh, a.s_max, a.hkv, a.pg);
  const E* kc = static_cast<const E*>(a.k);
  const E* vc = static_cast<const E*>(a.v);
  // The next chunk is loaded into registers (every load issued before any
  // is used) while the current one is worked on from shared memory.
  uint4 kbuf[kVecPerThread], vbuf[kVecPerThread];
  float ksb = 0.f, vsb = 0.f;  // int8: thread t < kCcChunk holds slot t's scales
  auto load = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kVecPerThread; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int s = idx / kVec, c = idx % kVec;
      if (s < kCcChunk && c0 + s < bk.hi) {
        const size_t off = seq.row(c0 + s) * D;
        kbuf[r] = reinterpret_cast<const uint4*>(kc + off)[c];
        vbuf[r] = reinterpret_cast<const uint4*>(vc + off)[c];
      }
    }
    if constexpr (Cache::kScaled) {
      const int s = threadIdx.x;
      if (s < kCcChunk && c0 + s < bk.hi) {
        const size_t r = seq.row(c0 + s);
        ksb = a.ks[r];
        vsb = a.vs[r];
      }
    }
  };
  if (bk.lo < bk.hi) load(bk.lo);
  for (int c0 = bk.lo; c0 < bk.hi; c0 += kCcChunk) {
    const int nc = min(kCcChunk, bk.hi - c0);
    __syncthreads();  // the previous chunk is no longer read
#pragma unroll
    for (int r = 0; r < kVecPerThread; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int s = idx / kVec, c = idx % kVec;
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
    if (c0 + kCcChunk < bk.hi) load(c0 + kCcChunk);
    if (!any) continue;  // this warp has no row (it still syncs)

    float sc[kCcQPerWarp];
#pragma unroll
    for (int i = 0; i < kCcQPerWarp; ++i) sc[i] = 0.f;
    if (lane < nc) {
      const uint4* krow = reinterpret_cast<const uint4*>(sk[lane]);
#pragma unroll 4
      for (int c = 0; c < kVec; ++c) {
        float kf[kPerVec];
        Cache::unpack16(krow[c], kf);
#pragma unroll
        for (int i = 0; i < kCcQPerWarp; ++i) {
          const float4* qv = reinterpret_cast<const float4*>(&sq[warp][i][c * kPerVec]);
#pragma unroll
          for (int u = 0; u < kPerVec / 4; ++u) {
            const float4 qq = qv[u];
            sc[i] += qq.x * kf[4 * u] + qq.y * kf[4 * u + 1] + qq.z * kf[4 * u + 2] +
                     qq.w * kf[4 * u + 3];
          }
        }
      }
      if constexpr (Cache::kScaled) {
#pragma unroll
        for (int i = 0; i < kCcQPerWarp; ++i) sc[i] *= sks[lane];
      }
    }
    const int slot = c0 + lane;
    float p[kCcQPerWarp];
#pragma unroll
    for (int i = 0; i < kCcQPerWarp; ++i) {
      const bool vis = lane < nc && slot >= rq[i].lo && slot < rq[i].hi;
      const float s_lane = vis ? sc[i] : -INFINITY;
      const float m_new = fmaxf(m[i], kv_split::warp_max(s_lane));
      const float u = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - u);
      p[i] = vis ? expf(s_lane - u) : 0.f;
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
      for (int i = 0; i < kCcQPerWarp; ++i) {
        float ps = __shfl_sync(0xffffffffu, p[i], s);
        if constexpr (Cache::kScaled) ps *= svs[s];  // the V scale: value product only
#pragma unroll
        for (int e = 0; e < kDPL; ++e) acc[i][e] += ps * vr[e];
      }
    }
  }

  const bool partial = a.mode == kPrefix || a.mode == kGroup;
  if (!partial) lct_pdl_wait();  // the extras' pass has finished
  const size_t base = (size_t)bk.split * a.b * a.nq * a.hkv * a.g;
#pragma unroll
  for (int i = 0; i < kCcQPerWarp; ++i) {
    const float l_tot = lct_group_sum<32>(l[i]);  // every lane takes part
    const RowQ& r = rq[i];
    if (!r.ok) continue;
    if (partial) {
      const size_t idx = base + r.idx;
      if (lane == 0) {
        a.pm[idx] = m[i];
        a.pl[idx] = l_tot;
      }
#pragma unroll
      for (int e = 0; e < kDPL; ++e) {
        const int d = e * 32 + lane;
        if (d < D) a.pacc[idx * D + d] = acc[i][e];
      }
      continue;
    }
    const int nx = a.mode == kVerify ? a.x.count(r.b) : 0;
    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = e * 32 + lane;
      if (d >= D) continue;
      const float mw[1] = {m[i]}, lw[1] = {l_tot}, aw[1] = {acc[i][e]};
      out[r.idx * D + d] = kv_split::merge_out<D>(a.x, nx, r.idx, d, mw, lw, aw);
    }
  }
}

template <typename Cache, int D>
__global__ void __launch_bounds__(kCcWarps * 32) tile_cc_kernel(Args a) {
  cc_body<Cache, D>(a);
  lct_pdl_wait();
}

// (query, head) rows a block takes for queries of type TQ: 64 on the
// tensor cores (bf16), 16 on the CUDA cores (float32).
template <typename TQ>
constexpr int rows_per_block() {
  return sizeof(TQ) == 2 ? kRows : kCcRows;
}

// The grid of a launch in a.mode (its row tiles into a.tiles): (Hkv, row
// tiles, z), z the run's splits (kPrefix), the groups' row tiles times the
// groups and z the splits (kGroup), one (kChunk), the rows (kVerify).
template <typename TQ>
dim3 grid_of(Args& a, int gm, int n_split) {
  const int r = rows_per_block<TQ>();
  switch (a.mode) {
    case kPrefix:
      a.tiles = (a.b * a.g + r - 1) / r;
      return dim3(a.hkv, a.tiles, n_split);
    case kGroup:
      a.tiles = (a.b * a.nq * a.g + r - 1) / r;
      return dim3(a.hkv, gm * a.tiles, n_split);
    case kChunk:
      a.tiles = (a.c * a.g + r - 1) / r;
      return dim3(a.hkv, a.tiles, 1);
    default:
      a.tiles = (a.nq * a.g + r - 1) / r;
      return dim3(a.hkv, a.tiles, a.b);
  }
}

template <typename Cache, typename TQ, int D>
int launch_d(const Args& a, dim3 grid, bool dependent, cudaStream_t st) {
  if constexpr (sizeof(TQ) == 2) {
    const auto kernel = tile_mma_kernel<Cache, D>;
    constexpr int smem = mma_smem_bytes<Cache, D>();
    static bool opted_in = false;
    const int rc = lct_smem_opt_in(kernel, smem, opted_in);
    if (rc) return rc;
    return lct_launch(kernel, grid, dim3(kWarps * 32), smem, st, dependent, a);
  } else {
    return lct_launch(tile_cc_kernel<Cache, D>, grid, dim3(kCcWarps * 32), 0, st, dependent,
                      a);
  }
}

// One launch of the pass in a.mode: queries of type TQ (bfloat16: the
// tensor cores; float32: the CUDA cores) over `Cache`, head_dim d; gm the
// groups (kGroup), n_split the run's splits (kPrefix, kGroup). dependent:
// a programmatic dependent of the stream's previous kernel. Returns
// cudaGetLastError().
template <typename Cache, typename TQ>
int dispatch(Args a, int d, int gm, int n_split, bool dependent, cudaStream_t st) {
  const dim3 grid = grid_of<TQ>(a, gm, n_split);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  int rc;
  switch (d) {
    case 16: rc = launch_d<Cache, TQ, 16>(a, grid, dependent, st); break;
    case 32: rc = launch_d<Cache, TQ, 32>(a, grid, dependent, st); break;
    case 64: rc = launch_d<Cache, TQ, 64>(a, grid, dependent, st); break;
    case 128: rc = launch_d<Cache, TQ, 128>(a, grid, dependent, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// K7 and K7-q8: the prefix pass over row 0's slots [0, prefix_len) (n_pre
// splits of pre_span slots, a multiple of 64), then the split-KV pass over
// each row's own slots from prefix_len (n_split splits of span), launched
// as the prefix pass's programmatic dependent, which merges the prefix's
// partials first. ws: float32, (n_pre + (n_split > 1 ? n_split : 0)) * B * H
// * (D + 2) elements: the prefix's partials, then the splits'. T: q's and
// out's type.
template <typename Cache, typename T>
int shared_prefix(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                  const void* valid_len, void* out, void* ws, int b, int s_max, int h, int hkv,
                  int d, int prefix_len, int n_pre, int pre_span, int n_split, int span,
                  float scale, cudaStream_t st) {
  if (b <= 0) return 0;
  if (hkv <= 0 || h % hkv || prefix_len < 0 || prefix_len > s_max ||
      (prefix_len == 0 && n_pre != 0) ||
      (prefix_len > 0 && (pre_span <= 0 || pre_span % kBK ||
                          n_pre != (prefix_len + pre_span - 1) / pre_span || !ws))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bh = (size_t)b * h;
  float* w = static_cast<float*>(ws);
  kv_split::Args sa;
  if (!kv_split::make_args(sa, q, k, ks, v, vs, valid_len, out,
                           w ? w + n_pre * bh * (d + 2) : nullptr, b, s_max, h, hkv, n_split,
                           span, scale, prefix_len)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_pre > 0) {
    Args ta{};
    ta.mode = kPrefix;
    ta.q = q;
    ta.k = k;
    ta.v = v;
    ta.ks = static_cast<const float*>(ks);
    ta.vs = static_cast<const float*>(vs);
    ta.pm = w;
    ta.pl = w + n_pre * bh;
    ta.pacc = w + 2 * n_pre * bh;
    ta.b = b;
    ta.nq = 1;
    ta.hkv = hkv;
    ta.g = h / hkv;
    ta.s_max = s_max;
    ta.run = prefix_len;
    ta.span = pre_span;
    ta.scale = scale;
    const int rc = dispatch<Cache, T>(ta, d, 0, n_pre, false, st);
    if (rc) return rc;
    sa.x = Extra{ta.pm, ta.pl, ta.pacc, bh, n_pre, nullptr, nullptr, 0, 0};
  }
  return kv_split::dispatch<Cache, T>(sa, h / hkv, d, st, n_pre > 0);
}

}  // namespace kv_tile
}  // namespace
