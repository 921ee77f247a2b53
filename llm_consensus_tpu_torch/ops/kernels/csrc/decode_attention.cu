// K3 and K7: one-token decode attention over the dense KV cache, plain and
// with a prefix shared by every row. (K4, decode over the int8 cache, and
// K7-q8, its shared-prefix form, are decode_attention_q8.cu.)
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
// What bounds them on the card. K3 reads each row's valid K/V slots (2 *
// valid_len * Hkv * D elements per row) and does ~4 * G operations per
// element read, far below ~295 operations per byte: bytes. K7 reads the
// prefix once instead of B times: 2 * (prefix + B * suffix) * Hkv * D
// elements, with ~4 * B * G operations per prefix element: its suffix is
// bound by bytes as K3 is, its prefix by operations on the CUDA cores (512
// an element at the N = 64 fan-out with G = 2), where the tensor cores
// would not be.
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
// K7 is two passes, both shared with other kernels. The prefix runs
// decode_tile.cuh's tile pass (kPrefix): every (row, head) query of the
// fan-out, 64 a block, against row 0's prefix staged in 64-slot tiles, on
// the tensor cores for bf16 (mma.sync, P split into hi + lo bf16) and on
// the CUDA cores for float32; its splits of the prefix (the host's rule,
// ops/kernels/attention.py: prefix_splits) write unnormalised partials.
// The suffix is K3's split-KV pass over [prefix_len, S_max) (its split
// from suffix_splits: one split for a fan-out's short suffix), launched as
// the tile pass's programmatic dependent: its blocks stream the rows' own
// slots while the prefix is scored, and merge the prefix's partials
// first, then their own. A block's shared memory holds the rings of the
// warps its span gives a chunk (decode_split.cuh), so a short suffix's
// blocks are small and all of a fan-out's fit on the card at once while
// they wait for the prefix.

#include "decode_tile.cuh"

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
// the same in every row) and its split: n_pre = ceil(prefix_len / pre_span)
// splits of pre_span slots (a multiple of 64; n_pre 0 without a prefix).
// The suffix's split (n_split, span) covers [prefix_len, S_max) as K3's
// covers [0, S_max). ws: a float32 workspace of (n_pre + (n_split > 1 ?
// n_split : 0)) * B * H * (D + 2) elements (null where that is 0).
extern "C" int lct_shared_prefix_attention(const void* q, const void* k, const void* v,
                                           const void* valid_len, void* out, void* ws, int b,
                                           int s_max, int h, int hkv, int d, int prefix_len,
                                           int n_pre, int pre_span, int n_split, int span,
                                           float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == LCT_DTYPE_F32) {
    return kv_tile::shared_prefix<kv_split::Dense<float>, float>(
        q, k, nullptr, v, nullptr, valid_len, out, ws, b, s_max, h, hkv, d, prefix_len, n_pre,
        pre_span, n_split, span, scale, st);
  }
  if (dtype == LCT_DTYPE_BF16) {
    return kv_tile::shared_prefix<kv_split::Dense<__nv_bfloat16>, __nv_bfloat16>(
        q, k, nullptr, v, nullptr, valid_len, out, ws, b, s_max, h, hkv, d, prefix_len, n_pre,
        pre_span, n_split, span, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
