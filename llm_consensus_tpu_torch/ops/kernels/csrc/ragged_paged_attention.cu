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
//     edge), merged into the member rows' results by log-sum-exp.
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
// What bounds it on the card. Each decode row reads its live K/V slots once
// (2 * slots * Hkv * D elements) and does ~4 * G operations per element
// read: bytes. A group's shared run is read once per group and does ~4 *
// members * G operations an element, the chunk row's table [0, chunk_start
// + C) ~4 * C * G an element: operations, past the CUDA cores' ridge.
//
// Design. Up to four launches on the caller's stream, each later one a
// programmatic dependent of the one before (it starts while that one runs
// and waits for it where it reads its results, and before it ends):
//   1. the group pass (when groups are given): decode_tile.cuh's tile pass
//      (kGroup), grid (Hkv, groups x row tiles, 64-slot splits of the
//      table). A block finds its group's members from group_id on the card,
//      stages the representative's pages of its split, and writes every
//      member query's partial (unnormalised max, sum, output) to the
//      workspace;
//   2. the chunk row: the tile pass (kChunk), each block up to 64 (query,
//      head) rows (bf16; 16 for float32) against the chunk table's slots up
//      to its last query, ragged causal;
//   3. decode rows, NQ = 1: decode_split.cuh's split-KV pass on its Paged
//      layout, grid (Hkv, B, n_split) from the table's width P * pg (the
//      host's rule, ops/kernels/attention.py: decode_splits): each block
//      streams one span of a row's own slots from max(shared_start, the
//      window's edge), each lane looking up its slot's page; the group
//      partials merge first, then the splits (a merge launch where n_split
//      > 1). NQ > 1 (verify rows): the tile pass (kVerify), one block
//      column per row, merging the row's group partials first.
// bf16 queries run the tile pass on the tensor cores (mma.sync, P as hi +
// lo bf16), float32 ones (the parity path) on the CUDA cores.

#include "decode_tile.cuh"

namespace {

constexpr int kGroupSpan = 64;  // slots a split of the group pass

template <typename TQ, typename E>
int run(const void* q, const void* k, const void* v, const int* table, const int* valid,
        const void* q_chunk, const int* ctable, const int* gid, const int* rep, const int* gend,
        const int* sstart, void* out, void* out_chunk, float* ws, int b, int nq, int h,
        int hkv, int d, int pg, int p_per, int c, int chunk_start, int gm, int window,
        int n_split, int span, float scale, cudaStream_t st) {
  using Cache = kv_split::Paged<E>;
  const int slots = p_per * pg, g = h / hkv;
  const size_t bqh = (size_t)b * nq * h;
  const int n_x = gm > 0 ? (slots + kGroupSpan - 1) / kGroupSpan : 0;
  kv_tile::Args ta{};
  ta.k = k;
  ta.v = v;
  ta.valid = valid;
  ta.b = b;
  ta.nq = nq;
  ta.hkv = hkv;
  ta.g = g;
  ta.s_max = slots;
  ta.pg = pg;
  ta.p_per = p_per;
  ta.window = window;
  ta.scale = scale;
  kv_split::Extra x{};
  bool chained = false;  // a kernel of this call is on the stream
  int rc;
  if (b > 0 && gm > 0) {  // 1. the group pass
    kv_tile::Args ga = ta;
    ga.mode = kv_tile::kGroup;
    ga.q = q;
    ga.table = table;
    ga.gid = gid;
    ga.rep = rep;
    ga.gend = gend;
    ga.pm = ws;
    ga.pl = ws + n_x * bqh;
    ga.pacc = ws + 2 * n_x * bqh;
    ga.span = kGroupSpan;
    rc = kv_tile::dispatch<Cache, TQ>(ga, d, gm, n_x, false, st);
    if (rc) return rc;
    x = kv_split::Extra{ga.pm, ga.pl, ga.pacc, bqh, n_x, gid, gend, kGroupSpan, slots};
    chained = true;
  }
  if (c > 0) {  // 2. the chunk row
    kv_tile::Args ca = ta;
    ca.mode = kv_tile::kChunk;
    ca.q = q_chunk;
    ca.table = ctable;
    ca.out = out_chunk;
    ca.c = c;
    ca.chunk_start = chunk_start;
    rc = kv_tile::dispatch<Cache, TQ>(ca, d, 0, 1, chained, st);
    if (rc) return rc;
    chained = true;
  }
  if (b <= 0) return 0;
  if (nq > 1) {  // 3. verify rows
    kv_tile::Args va = ta;
    va.mode = kv_tile::kVerify;
    va.q = q;
    va.table = table;
    va.sstart = sstart;
    va.out = out;
    va.x = x;
    return kv_tile::dispatch<Cache, TQ>(va, d, 0, 1, chained, st);
  }
  kv_split::Args sa;  // 3. decode rows
  if (!kv_split::make_args(sa, q, k, nullptr, v, nullptr, valid, out,
                           ws ? ws + n_x * bqh * (d + 2) : nullptr, b, slots, h, hkv, n_split,
                           span, scale)) {
    return (int)cudaErrorInvalidValue;
  }
  sa.table = table;
  sa.pg = pg;
  sa.p_per = p_per;
  sa.sstart = sstart;
  sa.window = window;
  sa.x = x;
  return kv_split::dispatch<Cache, TQ>(sa, g, d, st, chained);
}

}  // namespace

// q: [B, NQ, H, D]; k, v: [n_pages, pg, Hkv, D]; page_table: [B, P] int32;
// valid_len: [B] int32; q_chunk: [C, H, D] and chunk_table: [P] int32 (C =
// 0: no chunk row, both may be null); group_id [B], group_rep [Gm],
// group_end [Gm] int32 (Gm = 0: no groups, all may be null); shared_start
// [B] int32 or null; out: [B, NQ, H, D]; out_chunk: [C, H, D]. The decode
// rows' split (NQ = 1): n_split splits of span slots (a multiple of 32)
// over the table's P * pg slots, n_split * span >= P * pg > (n_split - 1)
// * span. ws: a float32 workspace of (n_x * B * NQ + (NQ == 1 && n_split >
// 1 ? n_split * B : 0)) * H * (D + 2) elements, n_x = ceil(P * pg / 64)
// with groups and 0 without (null where that is 0): the group partials,
// then the splits'. All contiguous on the card. dtype: q's, q_chunk's and
// the outputs' type; kv_dtype: the pools' (the same, or float32 queries
// over a bfloat16 pool). H = Hkv * G.
extern "C" int lct_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* valid_len, const void* q_chunk, const void* chunk_table,
    const void* group_id, const void* group_rep, const void* group_end,
    const void* shared_start, void* out, void* out_chunk, void* ws, int b,
    int nq, int h, int hkv, int d, int pg, int p_per, int c, int chunk_start,
    int gm, int window, int n_split, int span, float scale, int dtype, int kv_dtype,
    void* stream) {
  if (hkv <= 0 || h % hkv || b > kv_tile::kMaxRows || nq < 1 || pg <= 0 ||
      (gm > 0 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(page_table);
  const int* vl = static_cast<const int*>(valid_len);
  const int* ct = static_cast<const int*>(chunk_table);
  const int* gid = gm > 0 ? static_cast<const int*>(group_id) : nullptr;
  const int* rep = static_cast<const int*>(group_rep);
  const int* gend = static_cast<const int*>(group_end);
  const int* sst = static_cast<const int*>(shared_start);
  float* w = static_cast<float*>(ws);
  int rc;
  if (dtype == LCT_DTYPE_F32 && kv_dtype == LCT_DTYPE_F32) {
    rc = run<float, float>(q, k, v, tbl, vl, q_chunk, ct, gid, rep, gend, sst, out, out_chunk,
                           w, b, nq, h, hkv, d, pg, p_per, c, chunk_start, gm, window, n_split,
                           span, scale, st);
  } else if (dtype == LCT_DTYPE_BF16 && kv_dtype == LCT_DTYPE_BF16) {
    rc = run<__nv_bfloat16, __nv_bfloat16>(q, k, v, tbl, vl, q_chunk, ct, gid, rep, gend, sst,
                                           out, out_chunk, w, b, nq, h, hkv, d, pg, p_per, c,
                                           chunk_start, gm, window, n_split, span, scale, st);
  } else if (dtype == LCT_DTYPE_F32 && kv_dtype == LCT_DTYPE_BF16) {
    rc = run<float, __nv_bfloat16>(q, k, v, tbl, vl, q_chunk, ct, gid, rep, gend, sst, out,
                                   out_chunk, w, b, nq, h, hkv, d, pg, p_per, c, chunk_start,
                                   gm, window, n_split, span, scale, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
