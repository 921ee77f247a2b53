#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and ``nvcc`` (the kernels are built from
``llm_consensus_tpu_torch/ops/kernels/csrc`` at first use) and imports
nothing of JAX or of the JAX package. Phases:

1. Build the kernels; print the card's name and power limit, and nvcc's
   register, shared-memory and spill report for K1's and K2's bf16
   instantiations, for the split-KV pass (K3, K4, and the suffix and
   decode rows of K7, K7-q8 and K8) and its merge, for the tile pass (K7's
   and K7-q8's prefix, K8's group pass, chunk and verify rows; both
   kernels), and for the wgmma kernel of K6 and K10.
2. Hold each kernel (K1 RMSNorm, K2 causal prefill attention, K3 decode
   attention, K7 shared-prefix decode attention; K4 int8-cache decode
   attention and K5, K4 on a layer of the stacked cache; K6 the W8A16
   matmul; K7-q8 shared-prefix decode over the int8 cache and its
   stacked form) against its plain PyTorch twin on the card at llama-1b
   shapes (B in {1, 8}, prompt buckets 128 and 256, cache length prompt
   + 128; K6 at M = B on the w_gate shape), bf16 and fp32, plus the main
   path's own largest shapes in ``MAIN_PATH_CASES`` and K6 at every
   llama-1b projection shape for the engine's and the serving path's M
   (``k6_cases``; its largest, the lm_head at the fan-out's M = 64), also
   in both types, and in bf16 at mixtral-8x7b's wq, wk/wv, wo and lm_head
   (K = 4096) for M in ``K6_MOE_MS``; K10 (the W4A16 matmul) at the same llama-1b shapes and
   M and at llama3-8b's projections at M = 64 (random
   packed bytes), both types, each case also held against K6 on the same
   integer weights unpacked to int8. K1 also at 3 x 37 rows and at
   llama3-8b's width over a 2048-token prompt, both types; K2 in bf16 also
   at a ragged bucket (200), at llama3-8b's heads (G = 4) over a
   2048-token prompt, and at head_dim 64 with G = 3. K4 (and K5) also at
   valid_len 1 and S_max, at S_max = 300 (not a whole number of its
   32-slot chunks), one row over 2176 slots, and every head_dim in {16,
   32, 64, 128} x group size in {1, 2, 4, 8}; K10 also at N = 384 and
   1152 (multiples of 128, not of 256) for M in {1, 16, 80, 256}
   and at every llama-1b projection at M = 256, both types. K7 and K7-q8
   also at a prefix of 100 slots (not a multiple of 32 or 64), a prefix
   equal to every row's valid_len (no suffix), a prefix equal to S_max,
   one row over 2176 slots, and every head_dim x group size, both types.
   K3, K4, K6, K7, K7-q8, K8 and K10 are launched twice on the same inputs
   and must give the same bits (``repeat_bitwise``). K7 is also held
   against K3, and K7-q8 against K4, on the same cache. Print
   the max abs error and the worst ratio of error to tolerance, the
   kernel's time, the twin's time, one PyTorch call computing the same
   function (``library_ms``: F.rms_norm, scaled_dot_product_attention on
   the cache dequantized ahead of time, the bf16 cuBLAS product on the
   weight dequantized ahead of time) and the bound (the least time the
   card could take for the same work). K8 (ragged paged attention) on
   the cases of ``K8_CASES`` at llama-1b serving shapes (page 64, 32
   pages a table; also one row of the whole 2048-slot table, a window
   whose edge falls inside a split, shared starts and group ends at 200,
   verify rows in groups): bf16, float32, and float32 queries over a bf16
   pool; its fused case and its 16 decode rows timed against the twin and
   SDPA (two calls for the fused case) on K/V gathered out of the pool
   ahead of time.
3. The main path, part one: llama-1b at full width and depth, random
   weights from a fixed seed, answers one question through Coordinator
   -> LocalBackend -> InferenceEngine (default panel, round cap 2, 64 new
   tokens): once in bf16 (bf16 weights, bf16 KV cache), once on the int8
   path (the same weights quantized at engine init, int8 KV cache:
   ``EngineConfig(quant="int8", kv_quant=True)``), once on the int4 path
   (``quant="int4"``, int8 KV cache).
4. The main path, part two, on the same engine after each phase 3:
   self-consistency with N = 8 and N = 64 on one 128-token prompt, 128
   new tokens, majority vote; candidate-tokens/s. The fan-out decodes
   through K7 (bf16) or K7-q8 (int8), the prompt's K/V read once per
   step. The kernels' launch counts are set to 0 just before each path's
   phase 3 and read just after its phase 4; each kernel of that path must
   be > 0. On the int4 engine, the capacity planner: ``memory_estimate``
   and ``plan_memory`` for the N=64 call beside the bytes the card holds
   (params, the N-row KV cache the call decodes over, which must equal the
   plan's terms) and the call's peak allocation (``plan vs allocated``).
3m, 4m. Mixtral (MoE) at full width and depth: mixtral-8x7b, int8 weights
   drawn and quantized on the card a matrix at a time
   (``init_params_quantized``), the int8 KV cache. One consensus question
   (default panel, round cap 2, 32 new tokens; the panel's prefill runs
   the MoE capacity dispatch, its 4-row decode the dense all-experts
   path), self-consistency N = 8, a greedy ``generate_stream`` (its text
   must equal ``generate_texts``'), ``score_texts`` of two texts in both
   orders (equal, finite): K1, K2, K4, K6 and K7-q8 must launch. Seconds
   per question, candidate-tokens/s, wall ms per decode step and
   ``max_memory_allocated`` are printed beside the card. K6 is then held
   against its twin at every shape that run gave it (``K6Shapes``); then
   the planner for the N = 8 call against the bytes held.
3w. Mistral's sliding window: mistral-7b, bf16 weights and cache, one
   4591-token prompt (past the 4096 window) prefilled in chunks of 512,
   32 greedy new tokens. K1 must launch; K2, K3, K7 (and the int8
   kernels) must not. The chunked prefill's last logits against the
   one-shot windowed prefill's: relative L2 error within 4 * sqrt(32) *
   2^-9.
3s, 4s. The serving path: llama-1b, bf16 weights, a ContinuousBatcher
   with ``ContinuousConfig(max_slots=SERVE_SLOTS)`` (16): one consensus question
   through ContinuousBackend, then a 32-request burst (4 groups of 8
   sharing a 300-token header; ``serving burst:`` prints requests/s,
   generated tokens/s, wall ms per scheduler iteration, device programs
   per iteration, prefix pages shared and copied, mean decode-group
   size); then 8 requests on int8 weights and 8 on int4 weights
   (``serving int4 burst:``). K1 and K8 (and K6 on int8, K10 on int4)
   must launch in each run.
5. Reference check on the card: llama-1b's widths cut to 2 layers, in
   float32, kernels path against the plain path (prefill and decode
   logits, greedy tokens), for two ragged prompts and for a 4-row
   fan-out of one prompt decoding through K7 (bf16 cache) or K7-q8;
   then the same on int8 weights and the int8 cache (each step's new int8
   K/V shared by the two paths: ``SharedKvQuant``), the plain path with
   ``ops.quant.set_kernel_enabled(False)``, once with
   ``set_stacked_decode(False)`` and once with ``True`` (K5 and
   K7-q8-stacked count their launches there); again on int4 weights (the
   plain path with ``set_kernel4_enabled(False)``); the paged steps on the
   same cache (float32 pool, 16 rows as in phase 4s; float32 weights,
   then int8 and int4 weights with K6 and K10 against the twins) and the
   greedy serving burst over the batcher's bf16 pool,
   kernels against plain, at pipeline depth 1 and 2 with the fused step
   on and off; and finite outputs of phases 3 and 4. Then mixtral-8x7b's
   widths cut to 2 layers, float32 weights and cache, then int8 weights
   and the int8 cache (K4 and K7-q8 must launch), prompts of 256
   (prefills of 512 and 1024 tokens run the capacity dispatch, the
   decode the dense path), kernels against plain as above.
6. dp2 x mp2 serving on one card: the kernel library built in phase 1,
   the parent computes the single-card references, then starts a world of
   4 ranks on cuda:0 with the port's launcher over ``gloo`` (NCCL refuses
   two ranks on one device; gloo carries CUDA tensors through host
   memory). (a) K9 (``ragged_paged_attention_sharded``) on every rank
   against its twin and against the unsharded K8 on the global inputs, on
   the cases of ``K9_CASES`` at the mesh batcher's per-rank shapes (8
   rows, 256 pages of 64, 8 heads, 4 kv heads): the chunk lane owned by
   either shard, a group whose members are all on the other shard, NULL
   rows, a window; the fused case timed. (b) llama-1b at full width and
   depth: the paged steps on float32 weights against the single card's
   logits, and a greedy burst of 8 requests through the mesh batcher
   against the single card's text (a difference only at an argmax
   near-tie, reported with its gap); the same burst on bf16 and on int8
   weights (K6 must launch). (c) The 32-request burst on bf16 weights:
   requests/s, tokens/s, ms per iteration, K9 launches per rank, prefix
   pages shared per shard and the share of rank 0's wall spent in
   collectives, all labelled as 4 ranks on one card over gloo. A rank that
   fails, times out or disagrees fails the run.

Any failure raises (exit code != 0). The last five lines are the
``big_models`` JSON (phases 3m, 4m, 3w), the ``serving`` JSON (with the
``plan`` check's numbers), the ``kernels``
JSON, the card's ``nvidia-smi`` name and power limit, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import math
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

QUESTION = "Why do leaves change color in the fall?"
SC_PROMPT = (
    "Q: A baker makes 24 muffins and sells 3 boxes of 6 muffins each. "
    "How many muffins are left? Think step by step. A:"
)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


class Timer:
    """Device time of one call: CUDA events around it, the 50 MB L2
    flushed before each launch (the model's layers find their inputs
    cold). A spin kernel queued first (~1 ms) keeps the card busy while
    the host queues the flush, the events and the call, so the events
    time the call's device work and not the host's launch overhead."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def tolerance(dtype, ref):
    """Per-element tolerance. fp32: 1e-4 abs (sum order differs from the
    twin's). bf16: one bf16 ulp of each element, 2^-7 * |ref|, plus 1e-5
    abs (both round a float32 result to bf16; a last-bit difference in
    float32 flips at most one rounding)."""
    import torch

    if dtype == torch.float32:
        return torch.full_like(ref, 1e-4, dtype=torch.float32)
    return 2.0**-7 * ref.float().abs() + 1e-5


def compare(dtype, got, ref) -> tuple[float, float]:
    """(max abs error, worst error / tolerance); the second must be <= 1."""
    err = (got.float() - ref.float()).abs()
    return float(err.max()), float((err / tolerance(dtype, ref)).max())


# (kernel, B, prompt bucket S) cases of phase 2 besides the B x S grid,
# run in bf16 and float32: the main path's own largest shapes — K1 on one
# decode step of the N=64 fan-out, K2 on the panel's evaluation prefill
# (4 prompts, bucket 2048), K3 and K4 on that panel's decode (int8 cache
# [4, 8, 2176, 128]), K7 and K7-q8 on the N=64 fan-out's decode (cache
# 256, prefix 115).
MAIN_PATH_CASES = (
    ("fused_rms_norm", 64, 1),
    ("flash_causal_attention", 4, 2048),
    ("flash_decode_attention", 4, 2048),
    ("flash_decode_attention_shared_prefix", 64, 128),
    ("flash_decode_attention_q8", 4, 2048),
    ("flash_decode_attention_shared_prefix_q8", 64, 128),
)
# The serving phases' batcher: ContinuousConfig(max_slots=SERVE_SLOTS).
SERVE_SLOTS = 16


def projection_shapes(cfg):
    """(K, N, out type) of every projection of ``cfg``: wq (and wo's
    transpose), wk/wv, w_gate/w_up, w_down, and the lm_head with float32
    logits."""
    d, dh = cfg.d_model, cfg.head_dim
    return ((d, cfg.n_heads * dh, None), (d, cfg.n_kv_heads * dh, None),
            (d, cfg.d_ff, None), (cfg.d_ff, d, None), (d, cfg.vocab_size, "float32"))


def k6_cases(cfg):
    """K6 and K10 at every llama-1b projection shape for the engine
    paths' M: the question (1), the panel (4), the N=64 fan-out's decode
    (64) and a one-prompt prefill of the 128 bucket (128); and for the
    serving path's, from its ContinuousConfig: a decode step of max_slots
    rows, a standalone chunk of prefill_chunk rows, a fused step of both."""
    from llm_consensus_tpu_torch.serving import ContinuousConfig

    c = ContinuousConfig(max_slots=SERVE_SLOTS)
    ms = sorted({1, 4, 64, 128, c.max_slots, c.prefill_chunk, c.max_slots + c.prefill_chunk})
    return tuple((m, k, n, out) for m in ms for k, n, out in projection_shapes(cfg))


def attention_and_head_shapes(cfg):
    """(K, N, out type) of ``cfg``'s wq, wk/wv, wo and lm_head (float32
    logits), without repeats: the products an MoE model sends to K6 (its
    experts are dequantized, as in the JAX package)."""
    d, dh = cfg.d_model, cfg.head_dim
    shapes = ((d, cfg.n_heads * dh, None), (d, cfg.n_kv_heads * dh, None),
              (cfg.n_heads * dh, d, None), (d, cfg.vocab_size, "float32"))
    return tuple(dict.fromkeys(shapes))


# K6 at mixtral-8x7b's shapes (K = 4096), bf16, for the M its main path
# (phases 3m and 4m) gives K6: decodes of 1, 4 and 8 rows, prefills of
# 64, 128 and 256 tokens. Every shape that path launches is held against
# the twin again after it (``K6Shapes``).
K6_MOE_MODEL, K6_MOE_MS = "mixtral-8x7b", (1, 4, 8, 64, 128, 256)
# K10 beyond llama-1b: llama3-8b's projections at the fan-out's M = 64,
# where int4 weights are what make a model fit (random packed bytes made
# on the card, no model).
K10_BIG_MODEL, K10_BIG_M = "llama3-8b", 64
# K1 and K2 beyond llama-1b: llama3-8b's width and heads (32 / 8 / 128),
# and the draft model's head_dim 64 with G = 3 (12 / 4 / 64).
K2_BIG_MODEL, K2_D64_MODEL = "llama3-8b", "llama-draft-100m"
# The case each kernel reports in the kernels JSON line.
REPORTED = {"dtype": "torch.bfloat16", "b": 8, "s": 256}
REPORTED_K6 = {"dtype": "torch.bfloat16", "b": 64, "s": None, "kn": (2048, 5632)}
REPORTED_K8 = {"dtype": "torch.bfloat16", "reported": True}
REPORTED_K10 = {"dtype": "torch.bfloat16", "b": 64, "kn": (2048, 5632), "model": "llama-1b"}


def kernel_cases(torch, cfg, timer):
    import torch.nn.functional as F

    from llm_consensus_tpu_torch.models.cache import quantize_kv
    from llm_consensus_tpu_torch.ops.kernels import attention as ka
    from llm_consensus_tpu_torch.ops.kernels import norms as kn
    from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.ops.kernels.quant_matmul import quant4_matmul_supported
    from llm_consensus_tpu_torch.ops.quant import (
        Quantized4Tensor,
        dequantize,
        dequantize4,
        quantize_tensor,
        quantize_tensor4,
    )

    gen = torch.Generator(device="cuda").manual_seed(1234)
    d_model, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def row(kernel, dtype, b, s, shape, got, ref, fn, plain, library, nbytes, ops,
            plain_iters=20, out_dtype=None):
        err, ratio = compare(out_dtype or dtype, got, ref)
        return dict(
            kernel=kernel, dtype=str(dtype), b=b, s=s, shape=shape,
            err=err, ratio=ratio, ms=timer.ms(fn),
            plain_ms=timer.ms(plain, iters=plain_iters), library_ms=timer.ms(library),
            bound=bound_ms(nbytes, ops, dtype),
        )

    def held_against(r, name, dtype, got, other, fn):
        """K7 against K3, K7-q8 against K4: the same function on the same
        cache through the kernel that reads every row's prefix."""
        err, ratio = compare(dtype, got, other)
        r.update(vs=name, vs_err=err, vs_ratio=ratio, vs_ms=timer.ms(fn))
        return r

    def k1(dtype, b, s, d=d_model):  # x [B, S, d]
        es = torch.finfo(dtype).bits // 8
        x = randn(b, s, d, dtype=dtype)
        w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(dtype)
        return row(
            "fused_rms_norm", dtype, b, s, f"x[{b},{s},{d}]",
            kn.fused_rms_norm(x, w, eps), kn.fused_rms_norm_plain(x, w, eps),
            lambda: kn.fused_rms_norm(x, w, eps),
            lambda: kn.fused_rms_norm_plain(x, w, eps),
            lambda: F.rms_norm(x, (d,), w, eps),
            (2 * x.numel() + d) * es, 4 * x.numel(),
        )

    def k2(dtype, b, s, heads=None):  # prefill of B prompts in bucket S
        h, hkv, dh = heads or (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        es = torch.finfo(dtype).bits // 8
        q = randn(b, s, h, dh, dtype=dtype)
        k = randn(b, s, hkv, dh, dtype=dtype)
        v = randn(b, s, hkv, dh, dtype=dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = b * h * s * (s + 1) / 2  # (query, key) pairs under the mask
        return row(
            "flash_causal_attention", dtype, b, s,
            f"q[{b},{s},{h},{dh}] kv[{b},{s},{hkv},{dh}]",
            ka.flash_causal_attention(q, k, v), ka.flash_causal_attention_plain(q, k, v),
            lambda: ka.flash_causal_attention(q, k, v),
            lambda: ka.flash_causal_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            (2 * q.numel() + 2 * k.numel()) * es, 4 * pairs * dh, plain_iters=5,
        )

    def k3(dtype, b, s, lo=1):  # decode over a cache of prompt + 128 slots
        es = torch.finfo(dtype).bits // 8
        s_max = s + 128
        qd = randn(b, 1, h, dh, dtype=dtype)
        kc = randn(b, s_max, hkv, dh, dtype=dtype)
        vc = randn(b, s_max, hkv, dh, dtype=dtype)
        vl = torch.randint(lo, s_max + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
        mask = (torch.arange(s_max, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
        qdt, kct, vct = (t.transpose(1, 2) for t in (qd, kc, vc))
        n_valid = int(vl.sum())  # only valid slots need reading
        fn = lambda: ka.flash_decode_attention(qd, kc, vc, vl)  # noqa: E731
        got = fn()
        r = row(
            "flash_decode_attention", dtype, b, s,
            f"q[{b},1,{h},{dh}] cache[{b},{s_max},{hkv},{dh}]",
            got, ka.flash_decode_attention_plain(qd, kc, vc, vl), fn,
            lambda: ka.flash_decode_attention_plain(qd, kc, vc, vl),
            lambda: F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=mask, enable_gqa=True),
            (2 * n_valid * hkv * dh + 2 * qd.numel()) * es + 4 * b,
            4 * n_valid * h * dh,
        )
        r["bitwise"] = bool(torch.equal(got, fn()))  # a second launch, the same bits
        return r

    def k7(dtype, b, s, s_max=None, plen=None, valid=None, heads=None):
        """The fan-out's decode, 64 tokens into the answer, over a cache of
        prompt + 128 slots (a prompt of s - 13 tokens in bucket s); or
        (edge cases, s None) over ``s_max`` slots with ``plen`` shared and
        the given ``valid`` lengths and (H, Hkv, D) ``heads``."""
        h, hkv, dh = heads or (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        es = torch.finfo(dtype).bits // 8
        if s is not None:
            s_max, plen = s + 128, s - 13
        qd = randn(b, 1, h, dh, dtype=dtype)
        kc = randn(b, s_max, hkv, dh, dtype=dtype)
        vc = randn(b, s_max, hkv, dh, dtype=dtype)
        kc[:, :plen], vc[:, :plen] = kc[:1, :plen].clone(), vc[:1, :plen].clone()
        if valid is None:
            vl = torch.full((b,), plen + 64, device="cuda", dtype=torch.int32)
        else:
            vl = torch.tensor(valid, device="cuda", dtype=torch.int32)
        mask = (torch.arange(s_max, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
        qdt, kct, vct = (t.transpose(1, 2) for t in (qd, kc, vc))
        fn = lambda: ka.flash_decode_attention_shared_prefix(qd, kc, vc, vl, plen)  # noqa: E731
        got = fn()
        n_read = plen + int((vl - plen).clamp(min=0).sum())  # the prefix once, each suffix
        r = row(
            "flash_decode_attention_shared_prefix", dtype, b, s,
            f"q[{b},1,{h},{dh}] cache[{b},{s_max},{hkv},{dh}] prefix {plen}"
            + (f" valid_len {valid}" if valid is not None else ""),
            got, ka.flash_decode_attention_shared_prefix_plain(qd, kc, vc, vl, plen), fn,
            lambda: ka.flash_decode_attention_shared_prefix_plain(qd, kc, vc, vl, plen),
            lambda: F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=mask, enable_gqa=True),
            (2 * n_read * hkv * dh + 2 * qd.numel()) * es + 4 * b,
            4 * int(vl.sum()) * h * dh,
        )
        r["bitwise"] = bool(torch.equal(got, fn()))  # a second launch, the same bits
        return held_against(r, "k3", dtype, got, ka.flash_decode_attention(qd, kc, vc, vl),
                            lambda: ka.flash_decode_attention(qd, kc, vc, vl))

    def q8_cache(b, s_max, plen=0, layers=1, heads=None):
        """An int8 head-major cache [L, B, Hkv, S_max, D] (scales [L, B,
        Hkv, S_max]) made by quantize_kv, rows sharing slots [0, plen);
        and the same cache dequantized to float32 (the library's input).
        ``heads``: (Hkv, D), llama-1b's by default."""
        n_kv, d = heads or (hkv, dh)
        out = []
        for _ in range(2):  # K, then V
            x = randn(layers, b, n_kv, s_max, d, dtype=torch.float32)
            x[:, :, :, :plen] = x[:, :1, :, :plen].clone()
            xq, xs = quantize_kv(x)
            out += [xq, xs]
        deq = [(out[i].float() * out[i + 1][..., None]) for i in (0, 2)]
        return out, deq

    def q8_bytes(n_slots, qd, es, b, n_kv=hkv, d=dh):
        """Bytes a decode over the int8 cache must move: each read slot's
        int8 K and V rows and their two float32 scales, q, out, valid_len."""
        return n_slots * n_kv * (2 * d + 8) + 2 * qd.numel() * es + 4 * b

    def k4(dtype, b, s, lo=1, stacked=False, s_max=None, valid=None, heads=None):
        """int8 decode over a cache of prompt + 128 slots, valid_len drawn
        from [lo, S_max]; or (edge cases, s None) over ``s_max`` slots with
        the given ``valid`` lengths and (H, Hkv, D) ``heads``."""
        h, hkv, dh = heads or (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        es = torch.finfo(dtype).bits // 8
        s_max = s_max or s + 128
        layer = 1 if stacked else 0
        qd = randn(b, 1, h, dh, dtype=dtype)
        (kq_, ks, vq_, vs), (kd, vd) = q8_cache(b, s_max, layers=layer + 1, heads=(hkv, dh))
        if valid is None:
            vl = torch.randint(lo, s_max + 1, (b,), generator=gen, device="cuda",
                               dtype=torch.int32)
        else:
            vl = torch.tensor(valid, device="cuda", dtype=torch.int32)
        mask = (torch.arange(s_max, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
        qdt, kdl, vdl = qd.transpose(1, 2), kd[layer].to(dtype), vd[layer].to(dtype)
        views = (kq_[layer], ks[layer], vq_[layer], vs[layer])
        if stacked:
            name = "flash_decode_attention_q8_stacked"
            fn = lambda: ka.flash_decode_attention_q8_stacked(qd, kq_, ks, vq_, vs, vl, layer)  # noqa: E731
        else:
            name = "flash_decode_attention_q8"
            fn = lambda: ka.flash_decode_attention_q8(qd, *views, vl)  # noqa: E731
        n_valid = int(vl.sum())
        got = fn()
        r = row(
            name, dtype, b, s, f"q[{b},1,{h},{dh}] cache_q8[{b},{hkv},{s_max},{dh}]"
            + (f" layer {layer} of 2" if stacked else "")
            + (f" valid_len {valid}" if valid is not None else ""),
            got, ka.flash_decode_attention_q8_plain(qd, *views, vl), fn,
            lambda: ka.flash_decode_attention_q8_plain(qd, *views, vl),
            lambda: F.scaled_dot_product_attention(qdt, kdl, vdl, attn_mask=mask, enable_gqa=True),
            q8_bytes(n_valid, qd, es, b, hkv, dh), 4 * n_valid * h * dh,
        )
        r["bitwise"] = bool(torch.equal(got, fn()))  # a second launch, the same bits
        return r

    def k7q8(dtype, b, s, stacked=False, s_max=None, plen=None, valid=None, heads=None):
        """The int8 fan-out's decode, as :func:`k7`; or its edge cases."""
        h, hkv, dh = heads or (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        es = torch.finfo(dtype).bits // 8
        if s is not None:
            s_max, plen = s + 128, s - 13
        layer = 1 if stacked else 0
        qd = randn(b, 1, h, dh, dtype=dtype)
        (kq_, ks, vq_, vs), (kd, vd) = q8_cache(b, s_max, plen, layers=layer + 1,
                                                heads=(hkv, dh))
        if valid is None:
            vl = torch.full((b,), plen + 64, device="cuda", dtype=torch.int32)
        else:
            vl = torch.tensor(valid, device="cuda", dtype=torch.int32)
        mask = (torch.arange(s_max, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
        qdt, kdl, vdl = qd.transpose(1, 2), kd[layer].to(dtype), vd[layer].to(dtype)
        views = (kq_[layer], ks[layer], vq_[layer], vs[layer])
        if stacked:
            name = "flash_decode_attention_shared_prefix_q8_stacked"
            fn = lambda: ka.flash_decode_attention_shared_prefix_q8_stacked(  # noqa: E731
                qd, kq_, ks, vq_, vs, vl, plen, layer)
        else:
            name = "flash_decode_attention_shared_prefix_q8"
            fn = lambda: ka.flash_decode_attention_shared_prefix_q8(qd, *views, vl, plen)  # noqa: E731
        got = fn()
        n_read = plen + int((vl - plen).clamp(min=0).sum())  # the prefix once, each suffix
        r = row(
            name, dtype, b, s,
            f"q[{b},1,{h},{dh}] cache_q8[{b},{hkv},{s_max},{dh}] prefix {plen}"
            + (f" layer {layer} of 2" if stacked else "")
            + (f" valid_len {valid}" if valid is not None else ""),
            got, ka.flash_decode_attention_shared_prefix_q8_plain(qd, *views, vl, plen), fn,
            lambda: ka.flash_decode_attention_shared_prefix_q8_plain(qd, *views, vl, plen),
            lambda: F.scaled_dot_product_attention(qdt, kdl, vdl, attn_mask=mask, enable_gqa=True),
            q8_bytes(n_read, qd, es, b, hkv, dh), 4 * int(vl.sum()) * h * dh,
        )
        r["bitwise"] = bool(torch.equal(got, fn()))  # a second launch, the same bits
        return held_against(r, "k4", dtype, got, ka.flash_decode_attention_q8(qd, *views, vl),
                            lambda: ka.flash_decode_attention_q8(qd, *views, vl))

    def k6(dtype, m, k, n, out=None, model=None):  # x [M, K] @ int8 w [K, N]
        es = torch.finfo(dtype).bits // 8
        out_dtype = getattr(torch, out) if out else None
        x = randn(m, k, dtype=dtype)
        qt = quantize_tensor(randn(k, n, dtype=torch.float32) * 0.02, 0)
        w_lib = dequantize(qt, dtype)  # the library's weight, made ahead of time
        fn = lambda: kq.quant_matmul_2d(x, qt.q, qt.scale, out_dtype)  # noqa: E731
        out_es = torch.finfo(out_dtype or dtype).bits // 8
        got = fn()
        r = row(
            "quant_matmul_2d", dtype, m, None,
            (f"{model} " if model else "") + f"x[{m},{k}] w_q[{k},{n}] -> {out or str(dtype)[6:]}",
            got, kq.quant_matmul_2d_plain(x, qt.q, qt.scale, out_dtype), fn,
            lambda: kq.quant_matmul_2d_plain(x, qt.q, qt.scale, out_dtype),
            lambda: x @ w_lib,
            k * n + 4 * n + m * k * es + m * n * out_es, 2 * m * k * n,
            out_dtype=out_dtype,
        )
        r.update(kn=(k, n), bitwise=bool(torch.equal(got, fn())))
        return r

    def k10(dtype, m, k, n, out=None, model="llama-1b"):  # x [M, K] @ int4 w [K/2, N]
        es = torch.finfo(dtype).bits // 8
        out_dtype = getattr(torch, out) if out else None
        x = randn(m, k, dtype=dtype)
        if model == "llama-1b":
            qt = quantize_tensor4(randn(k, n, dtype=torch.float32) * 0.02, 0)
        else:  # random bytes; scales for weights of std ~0.02 (nibbles' std ~4.6)
            qt = Quantized4Tensor(
                q=torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                                dtype=torch.int8),
                scale=(0.02 / 4.6) * (0.5 + torch.rand(1, n, generator=gen, device="cuda")))
        w_lib = dequantize4(qt, dtype)  # the library's weight, made ahead of time
        w8 = kq.unpack4(qt.q, torch.int8)  # the same integers, for K6
        fn = lambda: kq.quant4_matmul_2d(x, qt.q, qt.scale, out_dtype)  # noqa: E731
        k6 = lambda: kq.quant_matmul_2d(x, w8, qt.scale, out_dtype)  # noqa: E731
        out_es = torch.finfo(out_dtype or dtype).bits // 8
        got = fn()
        r = row(
            "quant4_matmul_2d", dtype, m, None,
            f"{model} x[{m},{k}] w_q4[{k // 2},{n}] -> {out or str(dtype)[6:]}",
            got, kq.quant4_matmul_2d_plain(x, qt.q, qt.scale, out_dtype), fn,
            lambda: kq.quant4_matmul_2d_plain(x, qt.q, qt.scale, out_dtype),
            lambda: x @ w_lib,
            k * n // 2 + 4 * n + m * k * es + m * n * out_es, 2 * m * k * n,
            out_dtype=out_dtype,
        )
        r.update(kn=(k, n), model=model, bitwise=bool(torch.equal(got, fn())))
        return held_against(r, "k6", out_dtype or dtype, got, k6(), k6)

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            for s in (128, 256):
                rows += [k1(dtype, b, s), k2(dtype, b, s), k3(dtype, b, s), k7(dtype, b, s),
                         k4(dtype, b, s), k4(dtype, b, s, stacked=True),
                         k7q8(dtype, b, s), k7q8(dtype, b, s, stacked=True)]
            rows.append(k6(dtype, b, 2048, 5632))
    cases = {"fused_rms_norm": k1, "flash_causal_attention": k2,
             "flash_decode_attention": lambda dt, b, s: k3(dt, b, s, lo=s + 1),
             "flash_decode_attention_shared_prefix": k7,
             "flash_decode_attention_q8": lambda dt, b, s: k4(dt, b, s, lo=s + 1),
             "flash_decode_attention_shared_prefix_q8": k7q8}
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, b, s in MAIN_PATH_CASES:
            rows.append(cases[kernel](dtype, b, s))
        for m, k, n, out in k6_cases(cfg):
            rows += [k6(dtype, m, k, n, out), k10(dtype, m, k, n, out)]
        for k, n, out in projection_shapes(get_config(K10_BIG_MODEL)):
            rows.append(k10(dtype, K10_BIG_M, k, n, out, model=K10_BIG_MODEL))
        # K1 beyond llama-1b's grid: a row count that no block size divides
        # (3 x 37) and llama3-8b's d_model over one 2048-token prompt.
        rows += [k1(dtype, 3, 37), k1(dtype, 1, 2048, d=get_config(K2_BIG_MODEL).d_model)]
    for m in K6_MOE_MS:
        for k, n, out in attention_and_head_shapes(get_config(K6_MOE_MODEL)):
            rows.append(k6(torch.bfloat16, m, k, n, out, model=K6_MOE_MODEL))
    # K4 (K5) at its edges, both types: valid_len 1 and S_max, S_max not a
    # whole number of 32-slot chunks, one row over the panel's 2176 slots
    # (the most splits), every head_dim x group size at one size; K10 at N
    # = 384 and 1152 (multiples of 128, not of 256) and at M = 256.
    for dtype in (torch.bfloat16, torch.float32):
        rows += [k4(dtype, 3, None, s_max=300, valid=[1, 300, 137]),
                 k4(dtype, 3, None, s_max=300, valid=[300, 1, 33], stacked=True),
                 k4(dtype, 1, None, s_max=2176, valid=[2176])]
        for d in (16, 32, 64, 128):
            for g in (1, 2, 4, 8):
                rows.append(k4(dtype, 2, None, s_max=200, valid=[200, 77], heads=(4 * g, 4, d)))
        # K7 and K7-q8 (the prefix on the tile pass, the suffix on the
        # split-KV pass) at their edges: a prefix not a multiple of 32 or
        # 64, a prefix equal to valid_len (no suffix) and to S_max, one row
        # over 2176 slots, every head_dim x group size at one size.
        for fn in (k7, k7q8):
            rows += [fn(dtype, 3, None, s_max=300, plen=100, valid=[101, 300, 250]),
                     fn(dtype, 3, None, s_max=300, plen=150, valid=[150, 150, 150]),
                     fn(dtype, 2, None, s_max=300, plen=300, valid=[300, 300]),
                     fn(dtype, 1, None, s_max=2176, plen=1000, valid=[2176])]
            for d in (16, 32, 64, 128):
                for g in (1, 2, 4, 8):
                    rows.append(fn(dtype, 2, None, s_max=200, plen=77, valid=[200, 90],
                                   heads=(4 * g, 4, d)))
        for m in (1, 16, 80, 256):
            for n in (384, 1152):
                rows.append(k10(dtype, m, cfg.d_model, n))
        rows += [k10(dtype, 256, k, n, out) for k, n, out in projection_shapes(cfg)
                 if quant4_matmul_supported(256, k, n)]
    # K2's bf16 tensor-core kernel beyond the grid: a ragged bucket (200) at
    # llama-1b's heads, llama3-8b's heads (G = 4) over one 2048-token prompt,
    # and head_dim 64 with G = 3 (the draft model's heads) at a ragged S.
    for c, b, s in ((cfg, 2, 200), (get_config(K2_BIG_MODEL), 1, 2048),
                    (get_config(K2_D64_MODEL), 2, 300)):
        rows.append(k2(torch.bfloat16, b, s, heads=(c.n_heads, c.n_kv_heads, c.head_dim)))
    for r in rows:
        ok = r["ratio"] <= 1.0 and math.isfinite(r["err"]) and r.get("bitwise", True)
        extra = "" if "bitwise" not in r else f" repeat_bitwise={r['bitwise']}"
        if "vs_ms" in r:
            ok = ok and r["vs_ratio"] <= 1.0
            extra += f" vs_{r['vs']}_err={r['vs_err']:.3e} {r['vs']}_ms={r['vs_ms']:.4f}"
        print(
            f"  {r['kernel']:48s} {r['dtype']:15s} {r['shape']:62s} "
            f"max_abs_err={r['err']:.3e} err/tol={r['ratio']:.3f} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}){extra} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"{r['kernel']} disagrees with its twin: {r}")
    return rows


# K8 at llama-1b serving shapes: the pool's page size and table width are
# ContinuousConfig's defaults (64 and 32), the 16 decode rows the serving
# phase's SERVE_SLOTS, the chunk its prefill_chunk. (label, kwargs); the
# "fused" case is the one the kernels JSON line reports.
K8_PG, K8_P = 64, 32
K8_CASES = (
    ("16 decode rows, lengths 70-1500", dict()),
    ("the 16 rows in 2 groups sharing a 256-token run", dict(groups=2)),
    ("fused: 8 grouped decode rows + a 64-token chunk at 256",
     dict(b=8, groups=2, chunk=64)),
    ("a chunk at 256 with dead decode rows only", dict(b=4, chunk=64, dead=True)),
    ("4 verify rows of NQ=4", dict(b=4, nq=4)),
    ("window 256", dict(window=256)),
    ("fused, window 256", dict(b=8, groups=2, chunk=64, window=256)),
    ("one row of the full 2048-slot table", dict(b=1, full=True)),
    ("window 77 (its edge inside a split)", dict(window=77)),
    ("shared starts and group ends at 200 (not a multiple of 32)", dict(groups=2, run=200)),
    ("verify rows of NQ=4 in 2 groups", dict(b=8, nq=4, groups=2)),
)
K8_REPORTED = "fused: 8 grouped decode rows + a 64-token chunk at 256"
# Timed besides the reported case: the decode rows alone (K8's split-KV pass).
K8_TIMED = (K8_REPORTED, "16 decode rows, lengths 70-1500")


def ragged_cases(torch, cfg, timer):
    """K8 against its twin on every case of ``K8_CASES``: bf16 queries over
    a bf16 pool, float32 over float32, and float32 queries over the bf16
    pool (the serving phase 5's pairing). The reported case is timed
    against the twin and the library (two scaled_dot_product_attention
    calls, decode rows and chunk, on K/V gathered out of the pool ahead
    of time)."""
    import torch.nn.functional as F

    from llm_consensus_tpu_torch.ops.kernels import ragged_attention as kr

    gen = torch.Generator(device="cuda").manual_seed(4321)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pg, P = K8_PG, K8_P

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def case(label, dtype, kv_dtype, b=16, nq=0, groups=0, chunk=0, cstart=256,
             window=0, dead=False, run=256, full=False):
        n_pages = 1 + b * P + P
        kp = randn(n_pages, pg, hkv, dh, dtype=kv_dtype)
        vp = randn(n_pages, pg, hkv, dh, dtype=kv_dtype)
        perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).int()
        tbl = perm[: b * P].reshape(b, P).contiguous()
        ctbl = perm[b * P : b * P + P].contiguous()
        vl = torch.randint(70, 1501, (b,), generator=gen, device="cuda", dtype=torch.int32)
        if full:
            vl.fill_(P * pg)
        if dead:
            tbl.zero_()
            vl.zero_()
        kw = dict(window=window)
        sst = torch.zeros(b, dtype=torch.int32, device="cuda")
        n_groups = 0
        if groups:
            per = b // groups
            n_groups = groups
            rp = -(-run // pg)
            for gi in range(groups):  # members map the first member's run
                tbl[gi * per : (gi + 1) * per, :rp] = tbl[gi * per, :rp]
            vl = torch.clamp(vl, min=run + 1)
            sst.fill_(run)
            kw["groups"] = (
                (torch.arange(b, device="cuda") // per).int(),
                (torch.arange(groups, device="cuda") * per).int(),
                torch.full((groups,), run, dtype=torch.int32, device="cuda"),
                sst,
            )
        q = randn(*((b, nq, h, dh) if nq else (b, h, dh)), dtype=dtype)
        if chunk:
            kw.update(q_chunk=randn(chunk, h, dh, dtype=dtype), chunk_table=ctbl,
                      chunk_start=cstart)
        fn = lambda: kr.ragged_paged_attention(q, kp, vp, tbl, vl, **kw)  # noqa: E731
        plain = lambda: kr.ragged_paged_attention_plain(q, kp, vp, tbl, vl, **kw)  # noqa: E731
        got, again, ref = fn(), fn(), plain()
        if not chunk:
            got, again, ref = (got,), (again,), (ref,)
        errs = [compare(dtype, a, r) for a, r in zip(got, ref)]
        r = dict(kernel="ragged_paged_attention", label=label, dtype=str(dtype),
                 kv_dtype=str(kv_dtype), err=max(e for e, _ in errs),
                 ratio=max(x for _, x in errs),
                 finite=all(bool(torch.isfinite(a).all()) for a in got),
                 bitwise=all(bool(torch.equal(a, x)) for a, x in zip(got, again)),
                 shape=f"q[{b},{nq or 1},{h},{dh}] pool[{n_pages},{pg},{hkv},{dh}]"
                 + (f" chunk {chunk}@{cstart}" if chunk else "")
                 + (f" {groups} groups" if groups else ""))
        if label not in K8_TIMED or dtype != kv_dtype:
            return r
        r["reported"] = label == K8_REPORTED
        # The library: decode rows and chunk through SDPA on K/V gathered
        # out of the pool (in q's type) ahead of time.
        kd = kp[tbl.long()].reshape(b, P * pg, hkv, dh).transpose(1, 2).to(dtype)
        vd = vp[tbl.long()].reshape(b, P * pg, hkv, dh).transpose(1, 2).to(dtype)
        slot = torch.arange(P * pg, device="cuda")
        lo = (vl[:, None] - window) if window else torch.zeros_like(vl)[:, None]
        dmask = ((slot[None] < vl[:, None]) & (slot[None] >= lo))[:, None, None, :]
        qd = q[:, :, None] if not nq else q.transpose(1, 2)
        kc = kp[ctbl.long()].reshape(1, P * pg, hkv, dh).transpose(1, 2).to(dtype)
        vc = vp[ctbl.long()].reshape(1, P * pg, hkv, dh).transpose(1, 2).to(dtype)
        qc = kw["q_chunk"].transpose(0, 1)[None] if chunk else None
        cpos = cstart + torch.arange(chunk, device="cuda")
        cmask = (slot[None, :] <= cpos[:, None])[None, None]

        def library():
            F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask, enable_gqa=True)
            if chunk:
                F.scaled_dot_product_attention(qc, kc, vc, attn_mask=cmask, enable_gqa=True)

        es, kes = torch.finfo(dtype).bits // 8, torch.finfo(kv_dtype).bits // 8
        # Bytes: each slot's K and V row once (the shared run once per
        # group, each row's own slots past it, the chunk's table up to its
        # last query), q and out, tables and lengths. Operations: 4 * D
        # per (query head, visible slot).
        slots_read = n_groups * run + int((vl - sst).sum()) + (cstart + chunk) * bool(chunk)
        nbytes = (2 * slots_read * hkv * dh * kes + 2 * (q.numel() + chunk * h * dh) * es
                  + 4 * (b * P + P * bool(chunk) + 4 * b))
        pairs = int(vl.sum()) * h + h * sum(cstart + i + 1 for i in range(chunk))
        r.update(ms=timer.ms(fn), plain_ms=timer.ms(plain, iters=5),
                 library_ms=timer.ms(library),
                 bound=bound_ms(nbytes, 4 * pairs * dh, dtype))
        return r

    rows = []
    for dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16)):
        for label, kw in K8_CASES:
            rows.append(case(label, dtype, kv_dtype, **kw))
    for r in rows:
        ok = r["ratio"] <= 1.0 and math.isfinite(r["err"]) and r["finite"] and r["bitwise"]
        timing = ""
        if "ms" in r:
            timing = (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                      f"library_ms={r['library_ms']:.4f} "
                      f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
        print(f"  K8 {r['dtype']:15s} over {r['kv_dtype']:15s} {r['label']:58s} "
              f"{r['shape']:52s} max_abs_err={r['err']:.3e} err/tol={r['ratio']:.3f}"
              f"{timing} repeat_bitwise={r['bitwise']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ragged_paged_attention disagrees with its twin: {r}")
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def build_engine(torch, cfg, max_new_tokens: int = 64, quant: str = "none",
                 kv_quant: bool = False):
    """The main path's engine: ``cfg`` on the card, random bf16 weights
    from seed 0, quantized at engine init when ``quant`` is "int8" or
    "int4"; the KV cache in int8 when ``kv_quant``."""
    from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_consensus_tpu_torch.models.transformer import init_params

    params = init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    return InferenceEngine(
        cfg, params, engine_config=EngineConfig(
            max_new_tokens=max_new_tokens, quant=quant, kv_quant=kv_quant)
    )


def run_consensus(inner, new_tokens: int = 64):
    """One consensus question over the backend ``inner`` (LocalBackend over
    the engine, or ContinuousBackend over the batcher), ``new_tokens`` a
    call."""
    from llm_consensus_tpu_torch.backends.base import Backend, SamplingParams
    from llm_consensus_tpu_torch.consensus import (
        Coordinator,
        CoordinatorConfig,
        default_panel,
    )

    class CountingBackend(Backend):
        def __init__(self, inner):
            self.inner, self.calls = inner, 0

        async def generate_batch(self, requests):
            self.calls += len(requests)
            return await self.inner.generate_batch(requests)

    backend = CountingBackend(inner)
    coord = Coordinator(
        default_panel(),
        backend,
        CoordinatorConfig(
            max_rounds=2,
            seed=0,
            sampling=SamplingParams(max_new_tokens=new_tokens, temperature=0.7, seed=0),
        ),
    )
    t0 = time.perf_counter()
    result = asyncio.run(coord.run(QUESTION))
    secs = time.perf_counter() - t0
    print(
        f"  consensus: calls={backend.calls} rounds={result.rounds} "
        f"endorsed={result.endorsed} author={result.author!r} "
        f"answer_chars={len(result.answer)} seconds={secs:.3f}"
    )
    if not isinstance(result.answer, str) or result.rounds < 1 or backend.calls < 5:
        raise AssertionError(f"consensus run incomplete: {result}")
    return result


def run_self_consistency(torch, engine, card: str, ns=(8, 64), new_tokens: int = 128):
    from llm_consensus_tpu_torch.consensus import self_consistency

    prompt_len = len(engine.tokenizer.encode(SC_PROMPT))
    if not 64 < prompt_len <= 128:
        raise AssertionError(f"prompt is {prompt_len} tokens, not in the 128 bucket")
    out = {}
    for n in ns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = self_consistency(
            engine, SC_PROMPT, n, temperature=0.7, seed=0, max_new_tokens=new_tokens,
            method="majority",
        )
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if len(sc.candidates) != n or not all(math.isfinite(x) for x in sc.logprobs):
            raise AssertionError(f"self-consistency N={n} gave bad candidates")
        if not 0 < sc.total_tokens <= n * new_tokens:
            raise AssertionError(f"self-consistency N={n}: {sc.total_tokens} tokens")
        rate = sc.total_tokens / secs
        out[n] = rate
        print(
            f"  self_consistency N={n}: prompt_tokens={prompt_len} "
            f"candidate_tokens={sc.total_tokens} seconds={secs:.4f} "
            f"candidate_tokens_per_s={rate:.1f} winner_votes="
            f"{max(sc.vote.tally.values()):.0f} card={card!r}"
        )
    return out


def planner_check(torch, engine, card: str, n: int = 64, new: int = 128,
                  label: str = "int4 engine"):
    """The capacity planner against what the card holds: ``memory_estimate``
    and the config-only ``plan_memory`` for the N = ``n`` fan-out (the
    self-consistency prompt, ``new`` new tokens) beside the bytes of the
    engine's params and of the N-row KV cache that one such call decodes
    over, and that call's peak allocation (for information: activations
    and temporaries are outside the plan)."""
    import importlib

    from llm_consensus_tpu_torch.engine.engine import plan_memory
    from llm_consensus_tpu_torch.ops.quant import quantized_bytes

    # The module (the package's ``generate`` attribute is the function).
    generate_mod = importlib.import_module("llm_consensus_tpu_torch.engine.generate")

    prompt_len = len(engine.tokenizer.encode(SC_PROMPT))
    est = engine.memory_estimate(n_candidates=n, prompt_len=prompt_len, new_tokens=new)
    plan = plan_memory(engine.cfg, quant=engine.config.quant,
                       kv_quant=engine.config.kv_quant, n_candidates=n,
                       prompt_len=prompt_len, new_tokens=new)
    held = []  # bytes of each cache the decode loop runs over
    decode_loop = generate_mod._decode_loop

    def recording(cfg, params, logits, cache, *args, **kw):
        held.append(sum(t.numel() * t.element_size() for t in cache.leaves))
        return decode_loop(cfg, params, logits, cache, *args, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    generate_mod._decode_loop = recording
    try:
        engine.generate_texts([SC_PROMPT] * n, temperatures=[0.7] * n, seed=0,
                              max_new_tokens=new)
        torch.cuda.synchronize()
    finally:
        generate_mod._decode_loop = decode_loop
    params_bytes = quantized_bytes(engine.params)
    out = dict(
        n_candidates=n, prompt_tokens=prompt_len, new_tokens=new,
        params_bytes_held=params_bytes, params_bytes_planned=plan["params_bytes"],
        kv_cache_bytes_held=held, kv_cache_bytes_planned=plan["kv_cache_bytes"],
        logits_bytes_planned=plan["logits_bytes"], total_bytes_planned=plan["total_bytes"],
        allocated_bytes_before_call=before,
        max_allocated_bytes_of_call=torch.cuda.max_memory_allocated(),
        total_memory=torch.cuda.get_device_properties(0).total_memory,
    )
    print(f"  plan vs allocated ({label}, N={n}): " + " ".join(
        f"{k}={v}" for k, v in out.items()) + f" card={card!r}")
    if est != plan or params_bytes != plan["params_bytes"] or held != [plan["kv_cache_bytes"]]:
        raise AssertionError(f"the plan disagrees with the card: {out} estimate {est}")
    return out


# ---------------------------------------------------------------------------
# Phases 3m, 4m and 3w: Mixtral (MoE, int8) and Mistral (sliding window)
# ---------------------------------------------------------------------------

# New tokens a call on both models' runs.
BIG_NEW_TOKENS = 32
# Mistral's prompt: 4590 characters (+ BOS: 4591 byte-tokenizer tokens),
# past its 4096-token window, in the 4608 bucket, prefilled in chunks.
WINDOW_PROMPT_CHARS = 4590
WINDOW_ENGINE = dict(prefill_chunk=512, seq_buckets=(64, 128, 256, 512, 1024, 2048, 4608))


class DecodeStepClock:
    """Wall time of each decode step the engine runs (``generate``'s loop
    and ``decode_steps``), the card synchronized after each step."""

    def __init__(self, torch):
        import importlib

        self.torch = torch
        self.mod = importlib.import_module("llm_consensus_tpu_torch.engine.generate")
        self.walls: list[float] = []

    def __enter__(self):
        inner = self.real = self.mod.decode_step
        torch = self.torch

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            self.walls.append(time.perf_counter() - t0)
            return out

        self.mod.decode_step = timed
        return self

    def __exit__(self, *exc):
        self.mod.decode_step = self.real

    def report(self) -> str:
        n = len(self.walls)
        ms = 1e3 * sum(self.walls) / max(1, n)
        return f"decode_steps={n} wall_ms_per_decode_step={ms:.3f}"


class MoeCounter:
    """MoE layer calls by path: the capacity dispatch and the dense
    all-experts path (every MoE layer routes; only the dispatch calls
    ``_moe_dispatch``)."""

    def __enter__(self):
        from llm_consensus_tpu_torch.models import transformer

        self.mod, self.routed, self.dispatch = transformer, 0, 0
        self.real = (transformer._route, transformer._moe_dispatch)
        route, dispatch = self.real

        def counting_route(*a, **kw):
            self.routed += 1
            return route(*a, **kw)

        def counting_dispatch(*a, **kw):
            self.dispatch += 1
            return dispatch(*a, **kw)

        transformer._route, transformer._moe_dispatch = counting_route, counting_dispatch
        return self

    def __exit__(self, *exc):
        self.mod._route, self.mod._moe_dispatch = self.real

    def report(self) -> str:
        return (f"moe_layers_dispatch={self.dispatch} "
                f"moe_layers_dense={self.routed - self.dispatch}")


class K6Shapes:
    """The (M, K, N, x type, out type) of every product a path sends to
    K6: ``ops.quant``'s reference to the wrapper, wrapped (the launch
    count stays in the wrapper)."""

    def __enter__(self):
        from llm_consensus_tpu_torch.ops import quant

        self.mod, self.real, self.seen = quant, quant.quant_matmul_2d, set()
        real = self.real

        def recording(x, w_q, scale, out_dtype=None):
            self.seen.add((x.shape[0], x.shape[1], w_q.shape[1], x.dtype, out_dtype))
            return real(x, w_q, scale, out_dtype)

        quant.quant_matmul_2d = recording
        return self

    def __exit__(self, *exc):
        self.mod.quant_matmul_2d = self.real


def hold_k6_shapes(torch, shapes, label: str) -> None:
    """K6 against its twin at every shape in ``shapes`` (a path's
    ``K6Shapes``), on random x and int8 weights of std 0.02, with phase 2's
    tolerance; a second launch must give the same bits."""
    from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq
    from llm_consensus_tpu_torch.ops.quant import quantize_tensor

    gen = torch.Generator(device="cuda").manual_seed(99)
    worst = (-1.0, 0.0, None)
    for m, k, n, dtype, out_dtype in sorted(shapes, key=str):
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        qt = quantize_tensor(torch.randn((k, n), generator=gen, device="cuda") * 0.02, 0)
        got = kq.quant_matmul_2d(x, qt.q, qt.scale, out_dtype)
        err, ratio = compare(out_dtype or dtype, got,
                             kq.quant_matmul_2d_plain(x, qt.q, qt.scale, out_dtype))
        again = kq.quant_matmul_2d(x, qt.q, qt.scale, out_dtype)
        if not (ratio <= 1.0 and math.isfinite(err) and torch.equal(got, again)):
            raise AssertionError(f"K6 disagrees with its twin at the {label} path's "
                                 f"x[{m},{k}] w_q[{k},{n}] {dtype} -> {out_dtype}: "
                                 f"err {err} ratio {ratio}")
        worst = max(worst, (ratio, err, (m, k, n)), key=lambda t: t[0])
    print(f"  K6 at each of the {len(shapes)} shapes the {label} path launched, against "
          f"its twin: worst err/tol={worst[0]:.3f} max_abs_err={worst[1]:.3e} at (M, K, N) "
          f"{worst[2]}, repeat_bitwise=True")


def check_launches(label: str, counts: dict, needed=(), absent=()) -> None:
    missing = [name for name in needed if counts[name] == 0]
    if missing:
        raise AssertionError(f"the {label} path never launched {missing}")
    stray = [name for name in absent if counts[name] != 0]
    if stray:
        raise AssertionError(f"the {label} path launched {stray}")


def moe_phases(torch, kernels, card: str, path_counts: dict) -> dict:
    """Phases 3m and 4m: mixtral-8x7b at full width and depth on int8
    weights drawn and quantized on the card a matrix at a time
    (``init_params_quantized``) and the int8 KV cache. One consensus
    question (default panel, round cap 2, 32 new tokens: the panel's
    prefill holds more than ``moe_dense_decode_tokens`` tokens, so it runs
    the capacity dispatch; its decode at 4 rows the dense path), then
    self-consistency N = 8, a stream of one prompt (its greedy text must
    equal ``generate_texts``'s), ``score_texts`` of two texts in both
    orders (equal and finite), all in one counted run: K1, K2, K4, K6 and
    K7-q8 must launch. Then K6 against its twin at every shape the run
    gave it, and the planner against the bytes held."""
    from llm_consensus_tpu_torch.backends.local import LocalBackend
    from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params_quantized
    from llm_consensus_tpu_torch.ops.quant import quantized_bytes

    class IdTokenizer(ByteTokenizer):
        """The byte tokenizer's encoding; its decoding gives every id a
        character of its own, so two texts are equal exactly when their
        ids are (the byte tokenizer drops the ids past 258: most of a
        random 32000-id model's output)."""

        def __init__(self, vocab_size: int):
            super().__init__()
            self.vocab_size = vocab_size

        def decode(self, ids) -> str:
            return "".join(chr(0x4E00 + i) for i in ids)

    cfg = get_config("mixtral-8x7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_quantized(cfg, 0, bits=8, device="cuda")
    torch.cuda.synchronize()
    print(f"  int8 weights drawn and quantized on the card in {time.perf_counter() - t0:.1f} s: "
          f"params_bytes={quantized_bytes(params)} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} card={card!r}")
    engine = InferenceEngine(cfg, params, engine_config=EngineConfig(
        max_new_tokens=BIG_NEW_TOKENS, quant="int8", kv_quant=True))
    del params
    out = {}
    kernels.reset_launch_counts()
    with MoeCounter() as moe, K6Shapes() as k6_shapes:
        print("phase 3m (mixtral-8x7b, int8): consensus question, full width and depth")
        with DecodeStepClock(torch) as clock:
            t0 = time.perf_counter()
            run_consensus(LocalBackend(engine), new_tokens=BIG_NEW_TOKENS)
            torch.cuda.synchronize()
            out["question_seconds"] = time.perf_counter() - t0
        print(f"  {moe.report()} {clock.report()} card={card!r}")
        if moe.dispatch == 0 or moe.routed == moe.dispatch:
            raise AssertionError(f"the question did not run both MoE paths: {moe.report()}")
        out["question_ms_per_decode_step"] = 1e3 * sum(clock.walls) / len(clock.walls)
        print("phase 4m (mixtral-8x7b, int8): self-consistency N=8, a stream, scoring")
        with DecodeStepClock(torch) as clock:
            out["candidate_tokens_per_s"] = run_self_consistency(
                torch, engine, card, ns=(8,), new_tokens=BIG_NEW_TOKENS)[8]
        print(f"  N=8 {clock.report()} card={card!r}")
        out["fan_out_ms_per_decode_step"] = 1e3 * sum(clock.walls) / len(clock.walls)
        ids_engine = InferenceEngine(cfg, engine.params, tokenizer=IdTokenizer(cfg.vocab_size),
                                     engine_config=engine.config)
        streamed = "".join(ids_engine.generate_stream(QUESTION, max_new_tokens=BIG_NEW_TOKENS))
        batch = ids_engine.generate_texts([QUESTION], temperatures=[0.0],
                                          max_new_tokens=BIG_NEW_TOKENS)[0].text
        print(f"  generate_stream equals generate_texts (greedy): {streamed == batch} "
              f"tokens={len(batch)}")
        if streamed != batch:
            raise AssertionError("the stream's greedy text differs from generate_texts'")
        texts = ["Leaves lose chlorophyll in the cold.", "Because of the autumn light."]
        fwd = engine.score_texts(QUESTION, texts)
        rev = engine.score_texts(QUESTION, texts[::-1])[::-1]
        print(f"  score_texts: {fwd} reversed order: {rev}")
        if fwd != rev or not all(math.isfinite(x) for x in fwd):
            raise AssertionError(f"score_texts differs by order or is not finite: {fwd} {rev}")
        torch.cuda.synchronize()
    counts = launch_counts(kernels)
    print(f"  launches over phases 3m and 4m: {counts} {moe.report()}")
    check_launches("mixtral-8x7b", counts, needed=(
        "fused_rms_norm", "flash_causal_attention", "quant_matmul_2d",
        "flash_decode_attention_q8", "flash_decode_attention_shared_prefix_q8"))
    path_counts["mixtral"] = counts
    hold_k6_shapes(torch, k6_shapes.seen, "mixtral-8x7b")
    out["plan"] = planner_check(torch, engine, card, n=8, new=BIG_NEW_TOKENS,
                                label="mixtral-8x7b int8 engine")
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"  mixtral-8x7b: question_seconds={out['question_seconds']:.3f} "
          f"candidate_tokens_per_s={out['candidate_tokens_per_s']:.1f} "
          f"max_memory_allocated={out['max_memory_allocated']} card={card!r}")
    del engine
    torch.cuda.empty_cache()
    return out


def window_phase(torch, kernels, card: str, path_counts: dict) -> dict:
    """Phase 3w: mistral-7b at full width and depth, bf16 weights and
    cache, one prompt of 4591 tokens (past the 4096 window) prefilled in
    chunks of 512 (``EngineConfig(prefill_chunk=512)``), 32 greedy new
    tokens. K1 must launch; K2, K3 and K7 (and the int8 kernels) must not:
    a windowed config takes the plain attention ops, as in the JAX
    package. Then the chunked prefill's last logits against the one-shot
    windowed prefill's on the same tokens: relative L2 error within
    4 * sqrt(n_layers) * 2^-9 (bf16's unit roundoff a layer, accumulated
    as a random walk over the layers, times 4)."""
    from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_consensus_tpu_torch.models.cache import KVCache
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.models.transformer import (
        init_params,
        prefill,
        prefill_chunked,
    )

    cfg = get_config("mistral-7b")
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(
        cfg, init_params(cfg, 0, dtype=torch.bfloat16, device="cuda"),
        engine_config=EngineConfig(max_new_tokens=BIG_NEW_TOKENS, **WINDOW_ENGINE))
    words = ("leaf ", "color ", "autumn ", "pigment ", "light ", "tree ", "season ")
    prompt = "".join(words[i % len(words)] for i in range(WINDOW_PROMPT_CHARS))
    prompt = prompt[:WINDOW_PROMPT_CHARS]
    ids = engine.tokenizer.encode(prompt)
    if not cfg.sliding_window < len(ids) <= WINDOW_ENGINE["seq_buckets"][-1]:
        raise AssertionError(f"the prompt is {len(ids)} tokens")
    print(f"phase 3w (mistral-7b, bf16, window {cfg.sliding_window}): one {len(ids)}-token "
          f"prompt, chunked prefill of {WINDOW_ENGINE['prefill_chunk']}, "
          f"{BIG_NEW_TOKENS} greedy new tokens")
    kernels.reset_launch_counts()
    with DecodeStepClock(torch) as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate_texts([prompt], temperatures=[0.0])[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = launch_counts(kernels)
    print(f"  generated {res.num_tokens} tokens in {secs:.3f} s, logprob={res.logprob:.4f} "
          f"{clock.report()} card={card!r}")
    print(f"  launches (mistral-7b): {counts}")
    check_launches("mistral-7b", counts, needed=("fused_rms_norm",), absent=(
        "flash_causal_attention", "flash_decode_attention",
        "flash_decode_attention_shared_prefix", "flash_decode_attention_q8",
        "flash_decode_attention_shared_prefix_q8"))
    if not (res.num_tokens >= 1 and math.isfinite(res.logprob)):
        raise AssertionError(f"mistral-7b generated {res.num_tokens} tokens, logprob {res.logprob}")
    path_counts["mistral"] = counts
    s = WINDOW_ENGINE["seq_buckets"][-1]
    tokens = torch.zeros((1, s), dtype=torch.int64, device="cuda")
    tokens[0, : len(ids)] = torch.tensor(ids, device="cuda")
    lengths = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
    logits = {}
    for name in ("chunked", "one-shot"):
        cache = KVCache.create(cfg, 1, s + BIG_NEW_TOKENS, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "chunked":
            logits[name], _ = prefill_chunked(cfg, engine.params, tokens, lengths, cache,
                                              chunk=WINDOW_ENGINE["prefill_chunk"])
        else:
            logits[name], _ = prefill(cfg, engine.params, tokens, lengths, cache)
        torch.cuda.synchronize()
        print(f"  {name} prefill: seconds={time.perf_counter() - t0:.3f} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} card={card!r}")
    a, b = logits["chunked"].float(), logits["one-shot"].float()
    rel = float((a - b).norm() / b.norm())
    tol = 4 * math.sqrt(cfg.n_layers) * 2.0 ** -9
    same_top = bool((a.argmax(-1) == b.argmax(-1)).all())
    print(f"  chunked vs one-shot last logits: rel_l2_err={rel:.3e} tol={tol:.3e} "
          f"max_abs_err={float((a - b).abs().max()):.3e} same_argmax={same_top} "
          f"finite={bool(torch.isfinite(a).all())}")
    if not (rel <= tol and bool(torch.isfinite(a).all())):
        raise AssertionError(f"chunked prefill disagrees with one-shot: {rel} > {tol}")
    out = dict(prompt_tokens=len(ids), seconds=secs, new_tokens=res.num_tokens,
               ms_per_decode_step=1e3 * sum(clock.walls) / len(clock.walls),
               chunked_vs_oneshot_rel_l2=rel)
    del engine, logits, a, b
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The serving path: the continuous batcher (phases 3s and 4s)
# ---------------------------------------------------------------------------

_WORDS = ("leaf", "color", "autumn", "pigment", "light", "tree", "season",
          "green", "cold", "sugar", "day", "night", "red", "yellow")


def serving_burst(n_groups=4, per_group=8, new_tokens=(64, 128), greedy_only=False,
                  seed=0):
    """(prompt, submit kwargs) of a burst: ``n_groups`` groups of
    ``per_group`` requests, each group sharing a 300-token header (the
    byte tokenizer: one token per character, plus BOS), each request a
    distinct tail of 10-150 tokens and 64-128 new tokens; even requests
    greedy, odd ones at temperature 0.7 (all greedy with
    ``greedy_only``), stop strings on every fourth."""
    import random

    rng = random.Random(seed)

    def words(n):
        out = ""
        while len(out) < n:
            out += rng.choice(_WORDS) + " "
        return out[:n]

    burst = []
    for g in range(n_groups):
        header = f"Panel {g}. " + words(290)
        for _ in range(per_group):
            i = len(burst)
            tail = f" [{i}] " + words(rng.randint(10, 150) - len(f" [{i}] "))
            kw = dict(max_new_tokens=rng.randint(*new_tokens), seed=i,
                      temperature=0.0 if greedy_only or i % 2 == 0 else 0.7)
            if i % 4 == 3:
                kw["stop"] = ("\n\n", "Q:")
            burst.append((header + tail, kw))
    return burst


def serve_burst(torch, batcher, burst, card: str, label: str):
    """Submit the whole burst at once; every request must resolve. Prints
    the burst's rates and the batcher's counters over it."""
    st0 = batcher.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [batcher.submit(p, **kw) for p, kw in burst]
    outs = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = batcher.stats()

    def d(key):
        return st[key] - st0[key]

    bad = [i for i, o in enumerate(outs) if not isinstance(o.text, str) or o.num_tokens < 1]
    if bad or len(outs) != len(burst):
        raise AssertionError(f"{label}: requests {bad} did not resolve")
    tokens = sum(o.num_tokens for o in outs)
    iters = d("work_iterations")
    programs = d("device_programs_fused") + d("device_programs_decode") + d("device_programs_prefill")
    groups = d("decode_groups_sum")
    out = dict(
        requests=len(outs), seconds=wall, requests_per_s=len(outs) / wall,
        generated_tokens=tokens, generated_tokens_per_s=tokens / wall,
        iterations=iters, ms_per_iteration=1e3 * wall / max(1, iters),
        programs_per_iteration=programs / max(1, iters),
        programs_fused=d("device_programs_fused"), programs_decode=d("device_programs_decode"),
        programs_prefill=d("device_programs_prefill"),
        prefix_pages_shared=d("prefix_pages_shared"),
        prefix_pages_copied=d("prefix_pages_copied"),
        mean_group_size=d("decode_group_rows_sum") / groups if groups else 0.0,
        mean_ttft_s=d("ttft_seconds_sum") / max(1, d("ttft_seconds_count")),
        mean_tbt_s=d("tbt_seconds_sum") / max(1, d("tbt_seconds_count")),
        pipeline_flushes=d("pipeline_flushes"),
    )
    print(f"  serving {label}: " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in out.items())
        + f" card={card!r}")
    return out


def serving_phases(torch, cfg, kernels, card: str, path_counts: dict):
    """Phases 3s and 4s: the serving path at llama-1b full depth on bf16
    weights, ContinuousConfig(max_slots=SERVE_SLOTS) and the rest at its defaults:
    one consensus question through Coordinator -> ContinuousBackend, then
    the 32-request burst; then 8 requests on int8 weights and 8 on int4
    weights. Each run's launch counts are set to 0 just before it and
    read just after."""
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.ops.quant import quantize_params
    from llm_consensus_tpu_torch.serving import (
        ContinuousBackend,
        ContinuousBatcher,
        ContinuousConfig,
    )

    params = init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    results = {}
    runs = (  # (label, weight bits or None for bf16, kernels that must launch)
        ("serve", None, ("fused_rms_norm", "ragged_paged_attention")),
        ("serve_int8", 8, ("fused_rms_norm", "quant_matmul_2d", "ragged_paged_attention")),
        ("serve_int4", 4, ("fused_rms_norm", "quant4_matmul_2d", "ragged_paged_attention")),
    )
    for label, bits, needed in runs:
        p = params if bits is None else quantize_params(params, bits=bits)
        batcher = ContinuousBatcher(cfg, p, config=ContinuousConfig(max_slots=SERVE_SLOTS))
        try:
            kernels.reset_launch_counts()
            if label == "serve":
                print("phase 3s (serving): consensus question through ContinuousBackend")
                run_consensus(ContinuousBackend(batcher))
                print("phase 4s (serving): 32-request burst, 4 groups of 8 sharing a header")
                results[label] = serve_burst(torch, batcher, serving_burst(), card, "burst")
            else:
                print(f"phase 4s (serving, int{bits} weights): 8 requests, 2 groups of 4")
                results[label] = serve_burst(
                    torch, batcher, serving_burst(n_groups=2, per_group=4), card,
                    f"int{bits} burst")
            torch.cuda.synchronize()
            counts = launch_counts(kernels)
        finally:
            batcher.close()
        print(f"  launches ({label}): {counts}")
        missing = [name for name in needed if counts[name] == 0]
        if missing:
            raise AssertionError(f"the {label} path never launched {missing}")
        path_counts[label] = counts
        del batcher, p
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 5: the kernels path against the plain path on the card
# ---------------------------------------------------------------------------


def set_matmul_kernels(switch) -> None:
    """The int8 and int4 matmul kernels' switch (ops.quant), both at once."""
    from llm_consensus_tpu_torch.ops import quant

    quant.set_kernel_enabled(switch)
    quant.set_kernel4_enabled(switch)


class SharedKvQuant:
    """The int8 cache's writes, shared by the two paths of a step. The
    kernels path quantizes its new K/V and records each (q, scale); the
    plain path quantizes its own, which must be the recorded ones up to
    float32 rounding (at most one int8 step apart, and rarely; scales
    within 1e-4 relative), and writes the recorded ones. So both paths'
    caches stay identical, the step's own new slot included (a decode
    step reads the slot it writes), and the logits compare each step's
    arithmetic on one cache: an entry one int8 step apart in the first
    layer's new slot would otherwise move the next layer's K/V by ~1e-4
    and mixtral's logits by ~2e-3."""

    def __enter__(self):
        from llm_consensus_tpu_torch.models import transformer

        self.mod, self.real = transformer, transformer.quantize_kv
        self.mode, self.recorded = "record", []
        self.max_step, self.moved, self.entries, self.scale_rel = 0, 0, 0, 0.0
        transformer.quantize_kv = self.quantize
        return self

    def __exit__(self, *exc):
        self.mod.quantize_kv = self.real

    def quantize(self, x):
        q, scale = self.real(x)
        if self.mode == "record":
            self.recorded.append((q, scale))
            return q, scale
        rq, rs = self.recorded.pop(0)
        diff = (q.int() - rq.int()).abs()
        self.max_step = max(self.max_step, int(diff.max()))
        self.moved += int((diff > 0).sum())
        self.entries += diff.numel()
        self.scale_rel = max(self.scale_rel, float(
            ((scale - rs).abs() / rs.abs().clamp(min=1e-30)).max()))
        return rq, rs

    def report(self) -> str:
        return (f" cache_entries_one_step_apart={self.moved}/{self.entries}"
                f" max_int8_step={self.max_step} scale_max_rel_diff={self.scale_rel:.2e}")

    def check(self) -> None:
        if self.recorded:
            raise AssertionError(f"the plain path wrote {len(self.recorded)} fewer K/V")
        if self.max_step > 1 or self.moved > 1e-3 * self.entries or self.scale_rel > 1e-4:
            raise AssertionError(f"the two paths wrote different int8 caches:{self.report()}")


def reference_check(torch, cfg_full, bits: int = 0, s: int = 128):
    """``bits`` 8 or 4: int8 or packed int4 weights (the plain path with
    the matmul kernels switched off) and the int8 KV cache (the two paths'
    writes shared, ``SharedKvQuant``); 0: float32 weights and cache.
    ``s``: the prompts' width (mixtral's check takes 256, so that the two
    prompts' prefill of 512 tokens runs the MoE capacity dispatch and the
    decode the dense path)."""
    from llm_consensus_tpu_torch.engine.generate import broadcast_cache
    from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache
    from llm_consensus_tpu_torch.models.transformer import (
        decode_step,
        init_params,
        prefill,
    )
    from llm_consensus_tpu_torch.ops import quant

    cfg_k = cfg_full.with_(n_layers=2, use_pallas=True)
    cfg_p = cfg_k.with_(use_pallas=False)
    params = init_params(cfg_k, 7, dtype=torch.float32, device="cuda")
    int8 = bits > 0
    if bits:
        params = quant.quantize_params(params, bits=bits)
    gen = torch.Generator(device="cuda").manual_seed(3)
    steps = 16
    ragged = torch.randint(3, 259, (2, s), generator=gen, device="cuda")
    scenarios = (  # (label, tokens, lengths, shared prefix length or None)
        ("two ragged prompts", ragged, [s, 77], None),
        (f"fan-out of one prompt ({'K7-q8' if int8 else 'K7'})",
         ragged[:1].expand(4, s), [100] * 4, 100),
    )
    paths = (("kernels", cfg_k, None), ("plain", cfg_p, False))  # (name, cfg, kernel switch)

    def on_path(shared, name, switch, fn, *args, **kw):
        set_matmul_kernels(switch)
        shared.mode = "record" if name == "kernels" else "replay"
        try:
            return fn(*args, **kw)
        finally:
            set_matmul_kernels(None)

    for label, tokens, lens, plen in scenarios:
        b = tokens.shape[0]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        # An MoE prefill's capacity dispatch depends on the whole batch, so
        # identical rows prefilled together need not get identical K/V;
        # its fan-out prefills one row and copies the cache, as the
        # engine's shared prefill does.
        rows = 1 if plen is not None and cfg_k.is_moe else b
        caches, seqs, toks = {}, {}, {}
        with SharedKvQuant() as shared:
            for name, cfg, switch in paths:
                if int8:
                    cache = QuantKVCache.create(cfg, rows, s + steps, "cuda")
                else:
                    cache = KVCache.create(cfg, rows, s + steps, torch.float32, "cuda")
                logits, caches[name] = on_path(shared, name, switch, prefill, cfg, params,
                                               tokens[:rows], lengths[:rows], cache)
                if rows < b:
                    logits, caches[name] = logits.expand(b, -1), broadcast_cache(caches[name], b)
                seqs[name], toks[name] = [logits], [logits.argmax(-1)]
            for _ in range(steps):
                for name, cfg, switch in paths:
                    logits, caches[name] = on_path(
                        shared, name, switch, decode_step, cfg, params,
                        toks[name][-1][:, None].to(torch.int64), caches[name],
                        uniform_write=plen is not None, shared_prefix_len=plen)
                    seqs[name].append(logits)
                    toks[name].append(logits.argmax(-1))
        worst = 0.0
        for lk, lp in zip(seqs["kernels"], seqs["plain"]):
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("non-finite logits on the kernels path")
            worst = max(worst, float((lk - lp).abs().max()))
        same = bool((torch.stack(toks["kernels"]) == torch.stack(toks["plain"])).all())
        tol = 1e-3  # float32 logits of magnitude ~1 after 2 layers
        weights = (f"int{bits} weights + " if bits else "") + (
            "int8 cache" if int8 else "float32 cache")
        print(
            f"  {cfg_full.name} widths, 2 layers, float32, {weights}, {label}, B={b} S={s}: prefill+{steps} "
            f"decode steps max_abs_logit_err={worst:.3e} tol={tol:.0e} "
            f"greedy_tokens_equal={same}{shared.report() if int8 else ''}"
        )
        shared.check()
        if worst > tol or not same:
            raise AssertionError(f"kernels path disagrees with the plain path: {label}")


def paged_steps_check(torch, cfg_k, params, kernels, bits: int = 0):
    """The paged steps, kernels path against plain path, on the same cache
    (SERVE_SLOTS rows, so the steps' products have the serving phases'
    M): chunked prefill of three prompts (two sharing two pages), two
    grouped decode steps, one fused step. Before each step the plain path
    gets a copy of the kernels path's cache, so the outputs compare one
    step's arithmetic. The pool is float32: a bf16 pool rounds the K/V a
    step writes and then reads (a chunk attends over its own tokens), so
    a last-bit float32 difference between the paths becomes a one-ulp
    bf16 difference there (the kernels path on the bf16 pool is held by
    phase 2's float32-over-bf16 K8 cases and the burst's text below).
    Only live rows' logits are compared:
    the 13 idle rows attend over nothing on the kernels path (zeros) and
    over their NULL table on the plain path, and both are discarded.
    ``bits`` 8 or 4: int8 or int4 weights, the plain path with the matmul
    kernels off."""
    from llm_consensus_tpu_torch.models.paged_cache import (
        GroupTracker,
        PagedKVCache,
        install_seq,
    )
    from llm_consensus_tpu_torch.models.transformer import (
        decode_step_paged,
        fused_step_paged,
        prefill_chunk_paged,
    )

    cfg_p = cfg_k.with_(use_pallas=False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    pg, P, slots = 64, 8, SERVE_SLOTS
    cache = PagedKVCache.create(cfg_k, 40, pg, slots, P, torch.float32, device="cuda")
    tol = 1e-3  # float32 logits of magnitude ~1 after 2 layers
    worst = {"chunk hidden": 0.0, "decode logits": 0.0, "fused logits": 0.0,
             "fused hidden": 0.0}
    prompts_live = 3

    def toks(n):
        return torch.randint(3, 259, (n,), generator=gen, device="cuda")

    def both(key, step, *args, **kw):
        """The step on the kernels path's cache and on a copy for the
        plain path; returns the kernels path's outputs."""
        plain_cache = PagedKVCache(cache.k.clone(), cache.v.clone(),
                                   cache.page_table.clone(), cache.length.clone())
        out_k = step(cfg_k, params, *args, cache, **kw)
        set_matmul_kernels(False)
        try:
            out_p = step(cfg_p, params, *args, plain_cache, **kw)
        finally:
            set_matmul_kernels(None)
        for name, a, b in zip(key, out_k[:-1], out_p[:-1]):
            if "logits" in name:
                a, b = a[:prompts_live], b[:prompts_live]
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"non-finite {name} on the kernels path")
            worst[name] = max(worst[name], float((a - b).abs().max()))
        return out_k

    def table(pages):
        t = torch.zeros(P, dtype=torch.int32, device="cuda")
        t[: len(pages)] = torch.tensor(pages, dtype=torch.int32)
        return t

    kernels.reset_launch_counts()
    p0 = toks(200)
    prompts = [(p0, table([1, 2, 3, 4]), 0),
               (torch.cat([p0[:128], toks(60)]), table([1, 2, 5, 6]), 128),
               (toks(100), table([7, 8]), 0)]
    for ids, tbl, start in prompts:
        for pos in range(start, len(ids), pg):
            chunk = torch.zeros(1, pg, dtype=torch.int64, device="cuda")
            seg = ids[pos : pos + pg]
            chunk[0, : len(seg)] = seg
            both(("chunk hidden",), prefill_chunk_paged, chunk, tbl, pos)
    groups = GroupTracker(slots, pg, device="cuda")
    for i, (ids, tbl, _) in enumerate(prompts):
        install_seq(cache, i, tbl, len(ids))
        groups.add(i, tbl[: len(ids) // pg].tolist())
    nxt = toks(slots)[:, None]
    for _ in range(2):
        logits, _ = both(("decode logits",), decode_step_paged, nxt, groups=groups.arrays())
        nxt = logits.argmax(-1)[:, None]
    ctoks = toks(pg)[None]
    both(("fused logits", "fused hidden"), fused_step_paged, nxt, groups=groups.arrays(),
         chunk_tokens=ctoks, chunk_table=table([9]), chunk_start=0)
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    weights = f"int{bits} weights" if bits else "float32 weights"
    matmul_kernel = {8: ("quant_matmul_2d",), 4: ("quant4_matmul_2d",)}.get(bits, ())
    needed = ("fused_rms_norm", "ragged_paged_attention") + matmul_kernel
    print(f"  llama-1b widths, 2 layers, {weights}, float32 activations and pool, "
          f"{slots} rows ({prompts_live} live), paged steps on the same cache: "
          + " ".join(f"max_abs_err[{k}]={v:.3e}" for k, v in worst.items())
          + f" tol={tol:.0e} launches={ {name: counts[name] for name in needed} }")
    if max(worst.values()) > tol:
        raise AssertionError(f"paged steps ({weights}): kernels path disagrees with the "
                             f"plain path: {worst}")
    missing = [name for name in needed if counts[name] == 0]
    if missing:
        raise AssertionError(f"paged steps ({weights}) never launched {missing}")


def serving_reference_check(torch, cfg_full, kernels):
    """The serving path, kernels against plain, in float32 at llama-1b's
    widths cut to 2 layers.

    1. :func:`paged_steps_check` on float32, int8 and int4 weights.
    2. A 16-request greedy burst (4 groups of 4) through the batcher (its
       bfloat16 pool, float32 queries over it) at
       pipeline depth 1 and 2, with the fused step on and off: the kernels
       path's text must be byte-identical to the plain path's."""
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.ops.quant import quantize_params
    from llm_consensus_tpu_torch.serving import ContinuousBatcher, ContinuousConfig

    cfg_k = cfg_full.with_(n_layers=2, use_pallas=True)
    cfg_p = cfg_k.with_(use_pallas=False)
    params = init_params(cfg_k, 7, dtype=torch.float32, device="cuda")
    paged_steps_check(torch, cfg_k, params, kernels)
    for bits in (8, 4):
        paged_steps_check(torch, cfg_k, quantize_params(params, bits=bits), kernels, bits)

    burst = serving_burst(n_groups=4, per_group=4, new_tokens=(24, 40), greedy_only=True)
    agree = []
    for depth in (1, 2):
        for fused in (True, False):
            texts = {}
            for name, cfg in (("kernels", cfg_k), ("plain", cfg_p)):
                kernels.reset_launch_counts()
                b = ContinuousBatcher(cfg, params, config=ContinuousConfig(
                    max_slots=SERVE_SLOTS, pipeline_depth=depth, ragged_attention=fused))
                try:
                    futs = [b.submit(p, **kw) for p, kw in burst]
                    texts[name] = [f.result(timeout=300).text for f in futs]
                    stats = b.stats()
                finally:
                    b.close()
                k8 = kernels.ragged_paged_attention.launches
                if (k8 == 0) if name == "kernels" else (k8 != 0):
                    raise AssertionError(f"{name} path: ragged_paged_attention launches {k8}")
                if (stats["device_programs_fused"] > 0) != fused:
                    raise AssertionError(f"fused={fused}: {stats['device_programs_fused']} fused programs")
            same = texts["kernels"] == texts["plain"]
            agree.append(texts["kernels"])
            print(f"  serving burst, 16 greedy requests, float32, pipeline_depth={depth} "
                  f"fused_step={fused}: kernels_text_equals_plain={same}")
            if not same:
                raise AssertionError(
                    f"serving burst depth={depth} fused={fused}: kernels path text differs: "
                    + ascii([(a, b) for a, b in zip(texts["kernels"], texts["plain"]) if a != b]))
    print(f"  kernels-path text equal across the four configurations: "
          f"{all(t == agree[0] for t in agree)}")


# ---------------------------------------------------------------------------
# Phase 6: dp2 x mp2 serving on one card
# ---------------------------------------------------------------------------

# The mesh of phase 6: 4 ranks, all on cuda:0. NCCL refuses two ranks on
# one device, so the ranks use gloo, which carries CUDA tensors through
# host memory: every rank's kernels, pool and weight shard are real and on
# the card, the collectives are slow. Its numbers are per-rank device work
# and correctness, never a 4-card number.
MESH = {"data": 2, "model": 2}
MESH_BACKEND = "gloo"
MESH_DEADLINE_S = 700.0
# K9 at the mesh batcher's per-rank shapes (ContinuousConfig(max_slots=
# SERVE_SLOTS): 16 slots, 512 pages of 64, tables of 32): globally 16
# decode rows over 512 pages, per rank 8 rows, 256 pages, 8 query heads and
# 4 kv heads of 128. Rows [0, 8) and their pages live on data shard 0, rows
# [8, 16) on shard 1. (label, kwargs); the "fused" case is reported.
K9_CASES = (
    ("16 rows, lengths 70-1500, a NULL-table row on each shard",
     dict(null_rows=(3, 12))),
    ("2 groups sharing a 256-token run, one per shard", dict(groups=2)),
    ("fused: 16 grouped rows + a 64-token chunk at 256 owned by shard 1",
     dict(groups=2, chunk=64)),
    ("a chunk at 256 owned by shard 0, dead decode rows only",
     dict(chunk=64, dead=True, chunk_shard=0)),
    ("4 verify rows of NQ=4", dict(b=4, nq=4)),
    ("window 256", dict(window=256)),
    ("fused, window 256", dict(groups=2, chunk=64, window=256)),
)
K9_REPORTED = K9_CASES[2][0]
# Parity (phase 6b): a logit may differ from the single card's by float32
# reordering (TP sums partials in another order), ~1e-5 at llama-1b's
# magnitudes; 1e-3 is well above that and far below the ~0.2 typical gap
# between the two largest logits of a random-weight model. A text
# difference is accepted only at an argmax near-tie: a gap below
# NEAR_TIE between the two tokens on the single card.
STEP_LOGIT_TOL = 1e-3
NEAR_TIE = 2e-3


def in_turns(mesh, fn):
    """``fn()`` on each rank in turn while the others wait (the card's
    time is then this rank's alone); returns this rank's value."""
    out = None
    for r in range(mesh.config.size):
        if mesh.rank == r:
            out = fn()
        mesh.barrier()
    return out


def k9_rank_cases(torch, mesh, cfg, timer):
    """Phase 6a on this rank: K9 (kernel) against its twin on this rank's
    shard, and against the unsharded K8 kernel on the global inputs (this
    rank's block of its output), every case of ``K9_CASES`` in three
    (query, pool) type pairs; the reported case timed."""
    import torch.nn.functional as F

    from llm_consensus_tpu_torch.ops.kernels import ragged_attention as kr

    dp, mp = mesh.size("data"), mesh.size("model")
    d, m = mesh.index("data"), mesh.index("model")
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pg, P, n_pages = K8_PG, K8_P, 512
    lp, hl, kl = n_pages // dp, h // mp, hkv // mp

    def case(seed, label, dtype, kv_dtype, b=16, nq=0, groups=0, chunk=0, cstart=256,
             window=0, dead=False, null_rows=(), chunk_shard=1):
        # The same global inputs on every rank (one seed, one card).
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def randn(*shape, dtype):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        def pages_of(shard, shape):
            return (shard * lp + 1 + torch.randint(
                0, lp - 1, shape, generator=gen, device="cuda")).int()

        bl = b // dp
        kp = randn(n_pages, pg, hkv, dh, dtype=kv_dtype)
        vp = randn(n_pages, pg, hkv, dh, dtype=kv_dtype)
        tbl = torch.cat([pages_of(s, (bl, P)) for s in range(dp)]).contiguous()
        ctbl = pages_of(chunk_shard, (P,)).contiguous()
        vl = torch.randint(70, 1501, (b,), generator=gen, device="cuda", dtype=torch.int32)
        sst = torch.zeros(b, dtype=torch.int32, device="cuda")
        kw = dict(window=window)
        run = 256
        if groups:
            per = b // groups
            for gi in range(groups):  # members map the first member's run
                tbl[gi * per:(gi + 1) * per, :run // pg] = tbl[gi * per, :run // pg]
            vl = torch.clamp(vl, min=run + 1)
            sst.fill_(run)
            kw["groups"] = ((torch.arange(b, device="cuda") // per).int(),
                            (torch.arange(groups, device="cuda") * per).int(),
                            torch.full((groups,), run, dtype=torch.int32, device="cuda"), sst)
        for r in (range(b) if dead else null_rows):
            tbl[r] = 0  # the global NULL page; length 0: nothing to read
            vl[r] = 0
        q = randn(*((b, nq, h, dh) if nq else (b, h, dh)), dtype=dtype)
        if chunk:
            kw.update(q_chunk=randn(chunk, h, dh, dtype=dtype), chunk_table=ctbl,
                      chunk_start=cstart)
        ref_global = kr.ragged_paged_attention(q, kp, vp, tbl, vl, **kw)
        # This rank's shard.
        rows, heads = slice(d * bl, (d + 1) * bl), slice(m * hl, (m + 1) * hl)
        kvh = slice(m * kl, (m + 1) * kl)
        pages = slice(d * lp, (d + 1) * lp)
        kpl = kp[pages, :, kvh].contiguous()
        vpl = vp[pages, :, kvh].contiguous()
        ql = (q[rows, :, heads] if nq else q[rows, heads]).contiguous()
        lkw = dict(window=window)
        if groups:
            gid, rep, gend, _ = kw["groups"]
            lkw["groups"] = (gid[rows].contiguous(), rep, gend, sst[rows].contiguous())
        if chunk:
            lkw.update(q_chunk=kw["q_chunk"][:, heads].contiguous(), chunk_table=ctbl,
                       chunk_start=cstart)
        args = (mesh, ql, kpl, vpl, tbl[rows].contiguous(), vl[rows].contiguous())

        def fn():
            return kr.ragged_paged_attention_sharded(*args, **lkw)

        def plain():
            return kr.ragged_paged_attention_sharded_plain(*args, **lkw)

        got, twin = fn(), plain()
        ref = ref_global[0] if chunk else ref_global
        ref_rows = (ref[rows, :, heads] if nq else ref[rows, heads])
        pairs = [(got[0] if chunk else got, twin[0] if chunk else twin, ref_rows)]
        if chunk:
            pairs.append((got[1], twin[1], ref_global[1][:, heads]))
        e_twin = [compare(dtype, a, t) for a, t, _ in pairs]
        e_k8 = [compare(dtype, a, r) for a, _, r in pairs]
        r = dict(kernel="ragged_paged_attention_sharded", label=label, dtype=str(dtype),
                 kv_dtype=str(kv_dtype), rank=mesh.rank,
                 owns_chunk=bool(chunk) and d == chunk_shard,
                 err=max(e for e, _ in e_twin), ratio=max(x for _, x in e_twin),
                 err_vs_k8=max(e for e, _ in e_k8), ratio_vs_k8=max(x for _, x in e_k8),
                 finite=all(bool(torch.isfinite(a).all()) for a, _, _ in pairs),
                 shape=f"per rank q[{bl},{nq or 1},{hl},{dh}] pool[{lp},{pg},{kl},{dh}] "
                 f"tables[{bl},{P}]" + (f" chunk {chunk}@{cstart}" if chunk else "")
                 + (f" {groups} groups" if groups else ""))
        if label != K9_REPORTED or dtype != kv_dtype or dtype != torch.bfloat16:
            return r
        r["reported"] = True
        # The local work alone: K8 on this shard with the tables rebased
        # (the rebase and the sum over data left out), timed in turns.
        off = d * lp
        ktbl = (tbl[rows] - off).clamp(0, lp - 1).int().contiguous()
        kkw = dict(window=window, q_chunk=lkw["q_chunk"],
                   chunk_table=(ctbl - off).clamp(0, lp - 1).int().contiguous(),
                   chunk_start=cstart)
        gid_l, rep, gend, sst_l = lkw["groups"]
        kkw["groups"] = (gid_l, (rep - d * bl).clamp(0, bl - 1).int(), gend, sst_l)
        vl_l = vl[rows].contiguous()

        def local():
            return kr.ragged_paged_attention(ql, kpl, vpl, ktbl, vl_l, **kkw)

        # The library: two SDPA calls on this shard (decode rows, chunk) on
        # K/V gathered out of the local pool ahead of time, as K8's row.
        kd = kpl[ktbl.long()].reshape(bl, P * pg, kl, dh).transpose(1, 2)
        vd = vpl[ktbl.long()].reshape(bl, P * pg, kl, dh).transpose(1, 2)
        slot = torch.arange(P * pg, device="cuda")
        dmask = (slot[None] < vl_l[:, None])[:, None, None, :]
        qd = ql[:, :, None]
        ck = kkw["chunk_table"].long()
        kc = kpl[ck].reshape(1, P * pg, kl, dh).transpose(1, 2)
        vc = vpl[ck].reshape(1, P * pg, kl, dh).transpose(1, 2)
        qc = lkw["q_chunk"].transpose(0, 1)[None]
        cpos = cstart + torch.arange(chunk, device="cuda")
        cmask = (slot[None, :] <= cpos[:, None])[None, None]

        def library():
            F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask, enable_gqa=True)
            F.scaled_dot_product_attention(qc, kc, vc, attn_mask=cmask, enable_gqa=True)

        es, kes = torch.finfo(dtype).bits // 8, torch.finfo(kv_dtype).bits // 8
        # This shard's bytes, as K8's row reckons them: the shared run once
        # for the group with members here, each row's slots past it, the
        # chunk's table up to its last query on the shard that owns the
        # chunk (another shard's result is zeros: it needs no chunk K/V),
        # q and out, tables and lengths. Operations: 4 * D per (query head,
        # visible slot) of this shard's heads.
        owned = chunk if r["owns_chunk"] else 0
        slots_read = run + int((vl_l - sst_l).sum()) + (cstart + chunk) * bool(owned)
        nbytes = (2 * slots_read * kl * dh * kes + 2 * (ql.numel() + chunk * hl * dh) * es
                  + 4 * (bl * P + P + 4 * bl))
        pairs_ = int(vl_l.sum()) * hl + hl * sum(cstart + i + 1 for i in range(owned))
        r.update(ms=timer.ms(fn), plain_ms=timer.ms(plain, iters=5),
                 kernel_ms=in_turns(mesh, lambda: timer.ms(local)),
                 library_ms=in_turns(mesh, lambda: timer.ms(library)),
                 bound=bound_ms(nbytes, 4 * pairs_ * dh, dtype))
        return r

    rows = []
    seed = 9000
    for dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16)):
        for label, kw in K9_CASES:
            seed += 1
            rows.append(case(seed, label, dtype, kv_dtype, **kw))
    return rows


def mesh_steps_script(cfg):
    """Phase 6b's paged-step script, host values only (the single card
    and every mesh rank replay it): four prompts on rows 0, 1 (data shard
    0, pages 1-255) and 8, 9 (shard 1, pages 257-511), each pair sharing
    its first two pages, chunked by 64; then three decode steps with fixed
    input tokens; then a fused step with a fifth prompt's chunk on shard 1.
    Rows 0/1 and 8/9 form one decode group each."""
    import numpy as np

    from llm_consensus_tpu_torch.models.paged_cache import GroupTracker

    rng = np.random.default_rng(6)
    pg, P, slots = K8_PG, K8_P, SERVE_SLOTS

    def table(pages):
        t = np.zeros(P, np.int32)
        t[: len(pages)] = pages
        return t

    base = [rng.integers(3, 259, 128), rng.integers(3, 259, 128)]
    prompts = {0: np.concatenate([base[0], rng.integers(3, 259, 90)]),
               1: np.concatenate([base[0], rng.integers(3, 259, 50)]),
               8: np.concatenate([base[1], rng.integers(3, 259, 70)]),
               9: np.concatenate([base[1], rng.integers(3, 259, 100)])}
    tables = {0: table([1, 2, 3, 4, 5]), 1: table([1, 2, 6, 7]),
              8: table([257, 258, 259, 260, 261]), 9: table([257, 258, 262, 263, 264])}
    chunks = []
    for row, ids in prompts.items():
        start = 0 if row in (0, 8) else 128  # rows 1 and 9 map the shared pages
        for s in range(start, len(ids), 64):
            toks = np.zeros((1, 64), np.int32)
            seg = ids[s:s + 64]
            toks[0, :len(seg)] = seg
            chunks.append((toks, s, tables[row]))
    groups = GroupTracker(slots, pg)
    for row, ids in prompts.items():
        groups.add(row, tables[row][: len(ids) // pg])
    return dict(
        chunks=chunks, installs={r: (tables[r], len(ids)) for r, ids in prompts.items()},
        live=sorted(prompts), groups=groups.host_arrays(),
        tokens=[rng.integers(3, 259, (slots, 1)).astype(np.int32) for _ in range(3)],
        fused=(rng.integers(3, 259, (1, 64)).astype(np.int32), table([300, 301])),
    )


def run_steps(torch, cfg, params, script, mesh=None):
    """Replay :func:`mesh_steps_script` over a float32 pool, on the single
    card (``mesh`` None) or on this rank's shard; returns the chunks'
    hidden states and the live rows' logits (gathered over ``data``)."""
    from llm_consensus_tpu_torch.models import paged_cache as pc
    from llm_consensus_tpu_torch.models import transformer as tt
    from llm_consensus_tpu_torch.utils.device import h2d

    dev = torch.device("cuda")
    cache = pc.PagedKVCache.create(cfg, 512, K8_PG, SERVE_SLOTS, K8_P, torch.float32,
                                   device=dev, mesh=mesh)
    lo, hi = cache.row_offset, cache.row_offset + cache.max_seqs

    def full(x):
        return x if mesh is None else mesh.gather(x.contiguous(), "data", dim=0)

    out = {"hidden": [], "logits": []}
    for toks, start, table in script["chunks"]:
        hid, _ = tt.prefill_chunk_paged(cfg, params, h2d(toks, dev, torch.int64),
                                        h2d(table, dev), start, cache, mesh=mesh)
        out["hidden"].append(hid[0].cpu())
    for row, (table, n) in script["installs"].items():
        pc.install_seq(cache, row, table, n)
    groups = pc.DecodeGroupArrays.from_host(script["groups"], dev, slice(lo, hi))
    live = script["live"]
    for toks in script["tokens"]:
        logits, _ = tt.decode_step_paged(cfg, params, h2d(toks[lo:hi], dev, torch.int64),
                                         cache, groups=groups, mesh=mesh)
        out["logits"].append(full(logits)[live].cpu())
    ids, table = script["fused"]
    logits, hid, _ = tt.fused_step_paged(
        cfg, params, h2d(script["tokens"][-1][lo:hi], dev, torch.int64), cache,
        h2d(ids, dev, torch.int64), h2d(table, dev), 0, groups=groups, mesh=mesh)
    out["logits"].append(full(logits)[live].cpu())
    out["hidden"].append(hid[0].cpu())
    return out


def parity_burst():
    """Phase 6b's burst: 8 greedy requests, 2 groups of 4 sharing a header."""
    return serving_burst(n_groups=2, per_group=4, new_tokens=(32, 48), greedy_only=True,
                         seed=3)


def mesh_rank(ref: dict) -> dict:
    """Phase 6 on one rank of the dp2 x mp2 world (4 ranks on cuda:0).

    (a) K9's cases (:func:`k9_rank_cases`). (b) Parity on llama-1b, full
    width and depth: the paged-step script on float32 weights, then the
    greedy parity burst through the mesh batcher on float32, bf16 and
    int8 weights (rank 0 returns the texts; the parent compares them with
    the single card's). (c) The 32-request burst of :func:`serving_burst`
    on bf16 weights, launch counts set to 0 just before it and read just
    after on every rank. Rank 0 runs the batcher; the others its worker
    loop."""
    import torch

    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.ops import kernels
    from llm_consensus_tpu_torch.ops.quant import quantize_params
    from llm_consensus_tpu_torch.parallel import MeshConfig, make_mesh, shard_params
    from llm_consensus_tpu_torch.serving import (
        ContinuousBatcher,
        ContinuousConfig,
        serve_worker,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(MeshConfig(**MESH), device=dev)
    cfg = get_config("llama-1b")
    card = ref["card"]
    out: dict = {"rank": mesh.rank, "coords": mesh.coords}
    lead = mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    say(f"phase 6a: K9 against its twin and the unsharded K8, {MESH} over {MESH_BACKEND}, "
        "4 ranks on one card")
    out["k9_rows"] = k9_rank_cases(torch, mesh, cfg, Timer(torch))

    def serve(params, burst, label):
        """One mesh batcher over ``burst`` (every rank), counts reset
        before and read after; rank 0 returns the burst's numbers."""
        config = ContinuousConfig(max_slots=SERVE_SLOTS)
        kernels.reset_launch_counts()
        res = None
        if lead:
            batcher = ContinuousBatcher(cfg, params, config=config, mesh=mesh)
            try:
                c0 = mesh.collective_seconds
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                futs = [batcher.submit(p, **kw) for p, kw in burst]
                outs = [f.result(timeout=600) for f in futs]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = batcher.stats()
                res = dict(texts=[o.text for o in outs], tokens=[o.num_tokens for o in outs],
                           wall=wall, stats=st, collective_s=mesh.collective_seconds - c0)
            finally:
                batcher.close()
        else:
            serve_worker(cfg, params, config, mesh)
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        say(f"  mesh {label}: rank 0 launches {counts}")
        return res, counts

    say("phase 6b: parity on llama-1b, float32 weights: paged steps, then the greedy burst")
    p32 = init_params(cfg, 0, dtype=torch.float32, device=dev)
    out["steps"] = run_steps(torch, cfg.with_(use_pallas=True), shard_params(p32, mesh),
                             ref["script"], mesh)
    out["parity"] = {}
    out["parity_counts"] = {}
    out["parity"]["float32"], out["parity_counts"]["float32"] = serve(
        p32, parity_burst(), "float32 parity burst")
    del p32
    torch.cuda.empty_cache()
    p16 = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    out["parity"]["int8"], out["parity_counts"]["int8"] = serve(
        quantize_params(p16, bits=8), parity_burst(), "int8 parity burst")
    out["parity"]["bfloat16"], out["parity_counts"]["bfloat16"] = serve(
        p16, parity_burst(), "bf16 parity burst")
    say("phase 6c: the 32-request burst on bf16 weights through the mesh batcher")
    out["burst"], out["burst_counts"] = serve(p16, serving_burst(), "32-request burst")
    return out


def near_tie_gap(torch, cfg, params, tokenizer, prompt, got: str, want: str):
    """Where the mesh's text ``got`` leaves the single card's ``want``:
    the single card's float32 logits after the common prefix, and the gap
    between the two tokens chosen there (EOS where a text ended)."""
    from llm_consensus_tpu_torch.models.transformer import forward

    a = tokenizer.encode(got, add_bos=False) + [tokenizer.eos_id]
    b = tokenizer.encode(want, add_bos=False) + [tokenizer.eos_id]
    t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    ids = tokenizer.encode(prompt) + b[:t]
    logits = forward(cfg, params, torch.tensor([ids], device="cuda"))[0, -1]
    return t, abs(float(logits[a[t]] - logits[b[t]]))


def mesh_phase(torch, cfg, card: str) -> dict:
    """Phase 6: the parent's single-card references, then the dp2 x mp2
    world of 4 ranks on this card (the kernel library is already built,
    so the ranks only load it), then every check on the ranks' results.
    Raises on any failed rank or check."""
    import tempfile
    from pathlib import Path

    from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.ops.kernels import build
    from llm_consensus_tpu_torch.parallel import launch
    from llm_consensus_tpu_torch.serving import ContinuousBatcher, ContinuousConfig

    print(f"phase 6: dp2 x mp2 serving on one card: {MESH} as 4 ranks on cuda:0 over "
          f"--dist-backend {MESH_BACKEND}")
    cfg_k = cfg.with_(use_pallas=True)
    script = mesh_steps_script(cfg)
    p32 = init_params(cfg, 0, dtype=torch.float32, device="cuda")
    single_steps = run_steps(torch, cfg_k, p32, script)
    b = ContinuousBatcher(cfg, p32, config=ContinuousConfig(max_slots=SERVE_SLOTS))
    try:
        single = [f.result(timeout=600) for f in
                  [b.submit(p, **kw) for p, kw in parity_burst()]]
    finally:
        b.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="mesh-", dir=build.BUILD_DIR) as work:
        results = launch(f"{Path(__file__).resolve()}:mesh_rank", 4,
                         ({"card": card, "script": script},), backend=MESH_BACKEND,
                         workdir=work, deadline_s=MESH_DEADLINE_S, timeout_s=300.0)
    print(f"  world of 4 ranks ran in {time.perf_counter() - t0:.1f} s")
    for r in results:
        if not r.ok:
            raise AssertionError(f"mesh rank {r.rank} failed: {r.error}\n{r.log}")
    print(results[0].log, end="")
    ranks = [r.result for r in results]

    # (a) K9 on every case and rank.
    rows = [row for rk in ranks for row in rk["k9_rows"]]
    for r in rows:
        ok = (r["ratio"] <= 1.0 and r["ratio_vs_k8"] <= 1.0 and r["finite"]
              and math.isfinite(r["err"]))
        timing = ""
        if "ms" in r:
            timing = (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                      f"kernel_ms={r['kernel_ms']:.4f} library_ms={r['library_ms']:.4f} "
                      f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
        print(f"  K9 rank {r['rank']} {r['dtype']:15s} over {r['kv_dtype']:15s} "
              f"{r['label']:66s} max_abs_err={r['err']:.3e} err/tol={r['ratio']:.3f} "
              f"vs_unsharded_k8={r['err_vs_k8']:.3e} err/tol={r['ratio_vs_k8']:.3f}"
              f"{timing} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K9 disagrees on rank {r['rank']}: {r}")

    # (b) Parity with the single card.
    worst = 0.0
    for kind in ("hidden", "logits"):
        for i, (a, w) in enumerate(zip(ranks[0]["steps"][kind], single_steps[kind])):
            err = float((a - w.cpu()).abs().max())
            worst = max(worst, err)
            if not err <= STEP_LOGIT_TOL:
                raise AssertionError(f"mesh paged step {kind} {i}: max abs err {err}")
    print(f"  paged steps, float32 weights and pool, mesh vs single card: "
          f"max_abs_err={worst:.3e} (tolerance {STEP_LOGIT_TOL})")
    tok = ByteTokenizer()
    par = ranks[0]["parity"]
    texts = [o.text for o in single]
    ties = []
    for i, (got, want) in enumerate(zip(par["float32"]["texts"], texts)):
        if got == want:
            continue
        t, gap = near_tie_gap(torch, cfg, p32, tok, parity_burst()[i][0], got, want)
        if gap >= NEAR_TIE:
            raise AssertionError(f"mesh float32 text {i} differs at token {t} with gap "
                                 f"{gap}: {ascii(got)} != {ascii(want)}")
        ties.append((i, t, gap))
    print(f"  greedy parity burst (8 requests, float32 weights): mesh tokens equal the single "
          f"card's in {8 - len(ties)} of 8 requests"
          + (f"; near-ties (request, token, gap): {ties}" if ties else ""))
    del p32
    torch.cuda.empty_cache()
    for label, need in (("float32", ("ragged_paged_attention_sharded",)),
                        ("bfloat16", ("ragged_paged_attention_sharded",)),
                        ("int8", ("ragged_paged_attention_sharded", "quant_matmul_2d"))):
        res = par[label]
        if len(res["texts"]) != 8 or min(res["tokens"]) < 1:
            raise AssertionError(f"mesh {label} burst incomplete: {res['tokens']}")
        for rk in ranks:
            missing = [n for n in need if rk["parity_counts"][label][n] == 0]
            if missing:
                raise AssertionError(f"mesh {label} run on rank {rk['rank']} never "
                                     f"launched {missing}")
        print(f"  mesh {label} burst: tokens={sum(res['tokens'])} K9 launches per rank="
              f"{[rk['parity_counts'][label]['ragged_paged_attention_sharded'] for rk in ranks]}"
              + (f" K6 launches per rank="
                 f"{[rk['parity_counts'][label]['quant_matmul_2d'] for rk in ranks]}"
                 if label == "int8" else ""))

    # (c) The 32-request burst.
    res = ranks[0]["burst"]
    st = res["stats"]
    need = ("fused_rms_norm", "ragged_paged_attention", "ragged_paged_attention_sharded")
    for rk in ranks:
        missing = [n for n in need if rk["burst_counts"][n] == 0]
        if missing:
            raise AssertionError(f"mesh burst on rank {rk['rank']} never launched {missing}")
    wall = res["wall"]
    tokens = sum(res["tokens"])
    k9 = [rk["burst_counts"]["ragged_paged_attention_sharded"] for rk in ranks]
    burst = dict(
        label="4 ranks (dp2 x mp2) on one card over gloo", card=card,
        requests=len(res["tokens"]), seconds=wall, requests_per_s=len(res["tokens"]) / wall,
        generated_tokens=tokens, generated_tokens_per_s=tokens / wall,
        iterations=st["work_iterations"],
        ms_per_iteration=1e3 * wall / max(1, st["work_iterations"]),
        k9_launches_per_rank=k9,
        prefix_pages_shared_per_shard=st["prefix_pages_shared_per_shard"],
        rank0_collective_seconds=res["collective_s"],
        rank0_collective_share=res["collective_s"] / wall,
        mesh_data_shards=st["mesh_data_shards"], mesh_model_shards=st["mesh_model_shards"],
    )
    if len(res["tokens"]) != 32 or min(res["tokens"]) < 1:
        raise AssertionError(f"mesh burst incomplete: {res['tokens']}")
    print("  serving mesh burst: " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in burst.items()))
    # The reported case's chunk belongs to data shard 1: its first rank
    # (rank 2) does all the work K9 needs on a shard.
    rep = next(r for rk in ranks for r in rk["k9_rows"] if r.get("reported")
               and r["owns_chunk"])
    k9_row = {
        "name": "ragged_paged_attention_sharded", "route": "cuda",
        "source": "llm_consensus_tpu_torch/ops/kernels/csrc/ragged_paged_attention.cu",
        "wrapper": "llm_consensus_tpu_torch/ops/kernels/ragged_attention.py",
        "replaces": "llm_consensus_tpu/ops/pallas/attention.py:1286",
        "launches": sum(k9), "launches_per_rank": k9, "launches_from": ["mesh_burst"],
        "max_abs_err": max(r["err"] for r in rows if r["dtype"] == "torch.bfloat16"
                           and r["kv_dtype"] == "torch.bfloat16"),
        "ms": rep["ms"], "plain_ms": rep["plain_ms"], "kernel_ms": rep["kernel_ms"],
        "bound_ms": rep["bound"][0], "bound_by": rep["bound"][1],
        "library_ms": rep["library_ms"], "shape": rep["shape"], "dtype": "bfloat16",
        "timing": f"rank {rep['rank']} of 4 (the chunk's owner shard) on one card over "
                  "gloo: ms and plain_ms with all ranks in step (the chunk's sum over data "
                  "included); kernel_ms and library_ms alone on the card; bound_ms from "
                  "this rank's shard",
    }
    return {"burst": burst, "k9_row": k9_row, "near_ties": ties, "step_max_abs_err": worst}


# ---------------------------------------------------------------------------


def ptxas_lines(build, kernels) -> list[str]:
    """nvcc's ``-Xptxas -v`` report (registers, spills) for each entry
    function whose name holds one of ``kernels``, from the build's log: one
    line per instantiation, its name demangled as far as ``c++filt`` goes."""
    log = build.library_path().with_suffix(".log")
    if not log.exists():
        return [f"no build log at {log}"]
    out, name, props = [], None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if any(k in line for k in kernels) else None
            props = ""
        elif name and "spill" in line:
            props = line.strip()
        elif name and "Used" in line:
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, check=True).stdout.strip()
                name = name.replace("(anonymous namespace)::", "").split("(")[0]
                name = name.removeprefix("void ")
            except (OSError, subprocess.CalledProcessError):
                pass
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {props}")
            name = None
    return out


def launch_counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels.KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from llm_consensus_tpu_torch.backends.local import LocalBackend
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.ops import kernels
    from llm_consensus_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {smi} total_memory={torch.cuda.get_device_properties(0).total_memory}")

    print("phase 1: build")
    t0 = time.perf_counter()
    build.load_library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({build.library_path().name})")
    for line in ptxas_lines(build, ("rms_norm_kernel", "causal_attention_tc_kernel",
                                    "decode_split_kernel", "decode_merge_kernel",
                                    "tile_mma_kernel", "tile_cc_kernel",
                                    "quant_wgmma_kernel")):
        print(f"  ptxas {line}")

    cfg = get_config("llama-1b")
    print("phase 2: kernels against their twins")
    timer = Timer(torch)
    rows = kernel_cases(torch, cfg, timer)
    rows += ragged_cases(torch, cfg, timer)

    # Each main path, and the kernels it must launch. K5 and K7-q8-stacked
    # run only under set_stacked_decode(True) (off by default, as in the
    # JAX package): they count in phase 5's stacked run.
    paths = (
        ("bf16", dict(), ("fused_rms_norm", "flash_causal_attention",
                          "flash_decode_attention", "flash_decode_attention_shared_prefix")),
        ("int8", dict(quant="int8", kv_quant=True), (
            "fused_rms_norm", "flash_causal_attention", "quant_matmul_2d",
            "flash_decode_attention_q8", "flash_decode_attention_shared_prefix_q8")),
        ("int4", dict(quant="int4", kv_quant=True), (
            "fused_rms_norm", "flash_causal_attention", "quant4_matmul_2d",
            "flash_decode_attention_q8", "flash_decode_attention_shared_prefix_q8")),
    )
    path_counts = {}
    plan = None
    for label, engine_kw, needed in paths:
        print(f"phase 3 ({label}): consensus question on llama-1b, full depth")
        engine = build_engine(torch, cfg, **engine_kw)
        kernels.reset_launch_counts()
        run_consensus(LocalBackend(engine))
        torch.cuda.synchronize()
        print(f"  launches: {launch_counts(kernels)}")
        print(f"phase 4 ({label}): self-consistency on llama-1b")
        run_self_consistency(torch, engine, card)
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        print(f"  launches over phases 3 and 4 ({label}): {counts}")
        missing = [name for name in needed if counts[name] == 0]
        if missing:
            raise AssertionError(f"the {label} main path never launched {missing}")
        path_counts[label] = counts
        if label == "int4":
            plan = planner_check(torch, engine, card)
        del engine
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    big = {"mixtral": moe_phases(torch, kernels, card, path_counts),
           "mistral": window_phase(torch, kernels, card, path_counts)}
    big_seconds = time.perf_counter() - t0
    print(f"  phases 3m, 4m and 3w took {big_seconds:.1f} s")

    serving = serving_phases(torch, cfg, kernels, card, path_counts)

    print("phase 5: reference check")
    from llm_consensus_tpu_torch.models.transformer import set_stacked_decode

    reference_check(torch, cfg)
    serving_reference_check(torch, cfg, kernels)
    q8_decode = ("flash_decode_attention_q8", "flash_decode_attention_shared_prefix_q8")
    for bits, stacked, needed in (
            (8, False, ("quant_matmul_2d",) + q8_decode),
            (8, True, ("flash_decode_attention_q8_stacked",
                       "flash_decode_attention_shared_prefix_q8_stacked")),
            (4, False, ("quant4_matmul_2d",) + q8_decode)):
        set_stacked_decode(stacked)
        kernels.reset_launch_counts()
        try:
            reference_check(torch, cfg, bits=bits)
        finally:
            set_stacked_decode(False)
        counts = launch_counts(kernels)
        print(f"  launches, int{bits} check, stacked decode {stacked}: {counts}")
        missing = [name for name in needed if counts[name] == 0]
        if missing:
            raise AssertionError(
                f"the int{bits} check (stacked {stacked}) never launched {missing}")
        if stacked:
            path_counts["int8_stacked_check"] = counts
    t0 = time.perf_counter()
    moe_cfg = get_config("mixtral-8x7b")
    f32_decode = ("flash_causal_attention", "flash_decode_attention",
                  "flash_decode_attention_shared_prefix")
    for bits, needed in ((0, f32_decode),
                         (8, ("quant_matmul_2d", "flash_causal_attention") + q8_decode)):
        kernels.reset_launch_counts()
        with MoeCounter() as moe:
            reference_check(torch, moe_cfg, bits=bits, s=256)
        counts = launch_counts(kernels)
        label = f"mixtral-8x7b {f'int{bits}' if bits else 'float32'} weights check"
        print(f"  launches, {label}: {counts} {moe.report()}")
        check_launches(label, counts, needed)
        if moe.dispatch == 0 or moe.routed == moe.dispatch:
            raise AssertionError(f"the mixtral check did not run both MoE paths: {moe.report()}")
    torch.cuda.empty_cache()
    big_seconds += time.perf_counter() - t0
    print(f"  phase 5's mixtral checks took {time.perf_counter() - t0:.1f} s; "
          f"the phases of mixtral-8x7b and mistral-7b {big_seconds:.1f} s in all")

    mesh = mesh_phase(torch, cfg, card)

    d = "llm_consensus_tpu_torch/ops/kernels/csrc/"
    p = "llm_consensus_tpu/ops/pallas/"
    # name -> (source, TPU kernel it replaces, the runs whose launches count)
    sources = {
        "fused_rms_norm": (d + "rms_norm.cu", p + "norms.py:26",
                           ("bf16", "int8", "int4", "mixtral", "mistral", "serve", "serve_int8",
                            "serve_int4")),
        "flash_causal_attention": (d + "causal_attention.cu", p + "attention.py:90",
                                   ("bf16", "int8", "int4", "mixtral")),
        "flash_decode_attention": (d + "decode_split.cuh", p + "attention.py:391", ("bf16",)),
        "flash_decode_attention_shared_prefix": (
            d + "decode_tile.cuh", p + "attention.py:1494", ("bf16",)),
        "flash_decode_attention_q8": (d + "decode_split.cuh", p + "attention.py:280",
                                      ("int8", "int4", "mixtral")),
        "flash_decode_attention_q8_stacked": (
            d + "decode_split.cuh", p + "attention.py:444", ("int8_stacked_check",)),
        "quant_matmul_2d": (d + "quant_wgmma.cuh", p + "quant_matmul.py:59",
                            ("int8", "mixtral", "serve_int8")),
        "flash_decode_attention_shared_prefix_q8": (
            d + "decode_tile.cuh", p + "attention.py:1541", ("int8", "int4", "mixtral")),
        "flash_decode_attention_shared_prefix_q8_stacked": (
            d + "decode_tile.cuh", p + "attention.py:1586", ("int8_stacked_check",)),
        "ragged_paged_attention": (
            d + "ragged_paged_attention.cu", p + "attention.py:1213",
            ("serve", "serve_int8", "serve_int4")),
        "quant4_matmul_2d": (d + "quant_wgmma.cuh", p + "quant_matmul.py:161",
                             ("int4", "serve_int4")),
    }
    summary = []
    for name, (source, replaces, runs) in sources.items():
        want = {"quant_matmul_2d": REPORTED_K6, "quant4_matmul_2d": REPORTED_K10,
                "ragged_paged_attention": REPORTED_K8}.get(name, REPORTED)
        r = next(r for r in rows if r["kernel"] == name
                 and all(r.get(k) == v for k, v in want.items()))
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(path_counts[run][name] for run in runs),
            "launches_from": list(runs), "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": "bfloat16",
        })
    summary.append(mesh["k9_row"])
    serving["mesh_burst"] = mesh["burst"]
    print(json.dumps({"big_models": big, "card": smi}))
    print(json.dumps({"serving": serving, "plan": plan, "card": smi}))
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
