// K4 (and K5, which is K4 on one layer's view of the stacked cache):
// one-token decode attention over the int8 head-major cache, as a split-KV
// pass; and K7-q8 (with its stacked form, K7-q8 on a layer's views), the
// same with a prefix shared by every row.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/attention.py
// flash_decode_attention_q8 (-> _decode_q8_row_kernel and _decode_q8_kernel,
// whose arithmetic is _q8_attend). Same semantics: q [B, 1, H, D] (float32
// or bf16), the cache [B, Hkv, S_max, D] int8 with a float32 scale per slot
// [B, Hkv, S_max]; query head h reads kv head h / G; scores are
// q . k_q times k_scale * d^-1/2; slots >= valid_len[b] are masked; the
// softmax runs in float32, the V scale folds into the value product only
// (p * v_scale), the denominator stays the true sum of p; output in q's type.
// A row with valid_len 0 gives zeros.
//
// The kernel is decode_split.cuh's split-KV pass on its Q8 cache layout (K3
// runs the same pass on the dense cache): what bounds it and what its design
// does about that are in that file's note. A slot costs D + 4 bytes of K and
// as many of V per kv head, and an int8 block (~70 KB of rings at D = 128)
// leaves room for three on an SM; the host's split rule aims at two
// (ops/kernels/attention.py: decode_splits).
//
// K7-q8 replaces flash_decode_attention_shared_prefix_q8 (and its _stacked
// form; through _ragged_attention, the scale fold of _online_fold). As
// K7 (decode_attention.cu): the prefix [0, prefix_len), the same bytes in
// every row, through decode_tile.cuh's tile pass (kPrefix) over row 0 of
// the int8 cache, each byte made an exact bf16 in shared memory for the
// tensor cores under bf16 queries (the K scale on the score columns, the V
// scale on P's columns before the hi + lo split, the sum of p left true),
// the CUDA cores under float32 ones; each row's own slots through K4's
// split-KV pass over [prefix_len, S_max), which merges the prefix's
// partials first. The prefix reads 2 * (D + 4) bytes a slot and head once
// for all rows.

#include "decode_tile.cuh"

// K4. q: [B, 1, H, D] float32 or bfloat16 (dtype); k_q, v_q: [B, Hkv, S_max,
// D] int8, 16-byte aligned; k_scale, v_scale: [B, Hkv, S_max] float32;
// valid_len: [B] int32; out: [B, 1, H, D] in q's type; all contiguous on the
// card. Block z of a (row, kv head) reads slots [z * span, (z + 1) * span):
// span a multiple of 32, n_split * span >= S_max > (n_split - 1) * span. ws:
// n_split > 1, a float32 workspace of n_split * B * H * (D + 2) elements;
// else unused.
extern "C" int lct_decode_attention_q8(const void* q, const void* k_q,
                                       const void* k_scale, const void* v_q,
                                       const void* v_scale,
                                       const void* valid_len, void* out,
                                       void* ws, int b, int s_max, int h,
                                       int hkv, int d, int n_split, int span,
                                       float scale, int dtype, void* stream) {
  if (b <= 0) return 0;
  kv_split::Args a;
  if (!kv_split::make_args(a, q, k_q, k_scale, v_q, v_scale, valid_len, out, ws, b, s_max, h,
                           hkv, n_split, span, scale)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == LCT_DTYPE_F32) return kv_split::dispatch<kv_split::Q8, float>(a, h / hkv, d, st);
  if (dtype == LCT_DTYPE_BF16) {
    return kv_split::dispatch<kv_split::Q8, __nv_bfloat16>(a, h / hkv, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K7-q8. As K4, plus prefix_len and the prefix's split (n_pre, pre_span),
// the suffix's split (n_split, span) over [prefix_len, S_max) and the
// workspace ws, all as K7's (decode_attention.cu).
extern "C" int lct_shared_prefix_attention_q8(
    const void* q, const void* k_q, const void* k_scale, const void* v_q, const void* v_scale,
    const void* valid_len, void* out, void* ws, int b, int s_max, int h, int hkv, int d,
    int prefix_len, int n_pre, int pre_span, int n_split, int span, float scale, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == LCT_DTYPE_F32) {
    return kv_tile::shared_prefix<kv_split::Q8, float>(
        q, k_q, k_scale, v_q, v_scale, valid_len, out, ws, b, s_max, h, hkv, d, prefix_len,
        n_pre, pre_span, n_split, span, scale, st);
  }
  if (dtype == LCT_DTYPE_BF16) {
    return kv_tile::shared_prefix<kv_split::Q8, __nv_bfloat16>(
        q, k_q, k_scale, v_q, v_scale, valid_len, out, ws, b, s_max, h, hkv, d, prefix_len,
        n_pre, pre_span, n_split, span, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
