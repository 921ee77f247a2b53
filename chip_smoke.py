#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and ``nvcc`` (the kernels are built from
``llm_consensus_tpu_torch/ops/kernels/csrc`` at first use) and imports
nothing of JAX or of the JAX package. Phases:

1. Build the kernels; print the card's name and power limit.
2. Hold each kernel (K1 RMSNorm, K2 causal prefill attention, K3 decode
   attention, K7 shared-prefix decode attention; K4 int8-cache decode
   attention and K5, K4 on a layer of the stacked cache; K6 the W8A16
   matmul; K7-q8 shared-prefix decode over the int8 cache and its
   stacked form) against its plain PyTorch twin on the card at llama-1b
   shapes (B in {1, 8}, prompt buckets 128 and 256, cache length prompt
   + 128; K6 at M = B on the w_gate shape), bf16 and fp32, plus the main
   path's own largest shapes in ``MAIN_PATH_CASES`` and K6 at every
   llama-1b projection shape in ``K6_CASES``, also in both types. K7 is
   also held against K3, and K7-q8 against K4, on the same cache. Print
   the max abs error and the worst ratio of error to tolerance, the
   kernel's time, the twin's time, one PyTorch call computing the same
   function (``library_ms``: F.rms_norm, scaled_dot_product_attention on
   the cache dequantized ahead of time, the bf16 cuBLAS product on the
   weight dequantized ahead of time) and the bound (the least time the
   card could take for the same work).
3. The main path, part one: llama-1b at full width and depth, random
   weights from a fixed seed, answers one question through Coordinator
   -> LocalBackend -> InferenceEngine (default panel, round cap 2, 64 new
   tokens): once in bf16 (bf16 weights, bf16 KV cache), once on the int8
   path (the same weights quantized at engine init, int8 KV cache:
   ``EngineConfig(quant="int8", kv_quant=True)``).
4. The main path, part two, on the same engine after each phase 3:
   self-consistency with N = 8 and N = 64 on one 128-token prompt, 128
   new tokens, majority vote; candidate-tokens/s. The fan-out decodes
   through K7 (bf16) or K7-q8 (int8), the prompt's K/V read once per
   step. The kernels' launch counts are set to 0 just before each path's
   phase 3 and read just after its phase 4; each kernel of that path must
   be > 0.
5. Reference check on the card: llama-1b's widths cut to 2 layers, in
   float32, kernels path against the plain path (prefill and decode
   logits, greedy tokens), for two ragged prompts and for a 4-row
   fan-out of one prompt decoding through K7 (bf16 cache) or K7-q8;
   then the same on int8 weights and the int8 cache, the plain path with
   ``ops.quant.set_kernel_enabled(False)``, once with
   ``set_stacked_decode(False)`` and once with ``True`` (K5 and
   K7-q8-stacked count their launches there); and finite outputs of
   phases 3 and 4.

Any failure raises (exit code != 0). The last three lines are the
``kernels`` JSON, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
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
# K6 at every llama-1b projection shape (K, N, out type; wq/wo, wk/wv,
# w_gate/w_up, w_down, the lm_head with float32 logits) for the main
# path's M: the question (1), the panel (4), the N=64 fan-out's decode
# (64) and a one-prompt prefill of the 128 bucket (128).
K6_CASES = tuple(
    (m, k, n, out)
    for m in (1, 4, 64, 128)
    for k, n, out in ((2048, 2048, None), (2048, 512, None), (2048, 5632, None),
                      (5632, 2048, None), (2048, 32000, "float32"))
)
# The case each kernel reports in the kernels JSON line.
REPORTED = {"dtype": "torch.bfloat16", "b": 8, "s": 256}
REPORTED_K6 = {"dtype": "torch.bfloat16", "b": 64, "s": None, "kn": (2048, 5632)}


def kernel_cases(torch, cfg, timer):
    import torch.nn.functional as F

    from llm_consensus_tpu_torch.models.cache import quantize_kv
    from llm_consensus_tpu_torch.ops.kernels import attention as ka
    from llm_consensus_tpu_torch.ops.kernels import norms as kn
    from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq
    from llm_consensus_tpu_torch.ops.quant import dequantize, quantize_tensor

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

    def k1(dtype, b, s):  # x [B, S, d_model]
        es = torch.finfo(dtype).bits // 8
        x = randn(b, s, d_model, dtype=dtype)
        w = (1.0 + 0.1 * randn(d_model, dtype=torch.float32)).to(dtype)
        return row(
            "fused_rms_norm", dtype, b, s, f"x[{b},{s},{d_model}]",
            kn.fused_rms_norm(x, w, eps), kn.fused_rms_norm_plain(x, w, eps),
            lambda: kn.fused_rms_norm(x, w, eps),
            lambda: kn.fused_rms_norm_plain(x, w, eps),
            lambda: F.rms_norm(x, (d_model,), w, eps),
            (2 * x.numel() + d_model) * es, 4 * x.numel(),
        )

    def k2(dtype, b, s):  # prefill of B prompts in bucket S
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
        return row(
            "flash_decode_attention", dtype, b, s,
            f"q[{b},1,{h},{dh}] cache[{b},{s_max},{hkv},{dh}]",
            ka.flash_decode_attention(qd, kc, vc, vl),
            ka.flash_decode_attention_plain(qd, kc, vc, vl),
            lambda: ka.flash_decode_attention(qd, kc, vc, vl),
            lambda: ka.flash_decode_attention_plain(qd, kc, vc, vl),
            lambda: F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=mask, enable_gqa=True),
            (2 * n_valid * hkv * dh + 2 * qd.numel()) * es + 4 * b,
            4 * n_valid * h * dh,
        )

    def k7(dtype, b, s):  # the fan-out's decode, 64 tokens into the answer
        es = torch.finfo(dtype).bits // 8
        s_max, plen = s + 128, s - 13  # a prompt of s - 13 tokens in bucket s
        qd = randn(b, 1, h, dh, dtype=dtype)
        kc = randn(b, s_max, hkv, dh, dtype=dtype)
        vc = randn(b, s_max, hkv, dh, dtype=dtype)
        kc[:, :plen], vc[:, :plen] = kc[:1, :plen].clone(), vc[:1, :plen].clone()
        vl = torch.full((b,), plen + 64, device="cuda", dtype=torch.int32)
        mask = (torch.arange(s_max, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
        qdt, kct, vct = (t.transpose(1, 2) for t in (qd, kc, vc))
        got = ka.flash_decode_attention_shared_prefix(qd, kc, vc, vl, plen)
        n_read = plen + int((vl - plen).sum())  # the prefix once, each suffix
        r = row(
            "flash_decode_attention_shared_prefix", dtype, b, s,
            f"q[{b},1,{h},{dh}] cache[{b},{s_max},{hkv},{dh}] prefix {plen}",
            got, ka.flash_decode_attention_shared_prefix_plain(qd, kc, vc, vl, plen),
            lambda: ka.flash_decode_attention_shared_prefix(qd, kc, vc, vl, plen),
            lambda: ka.flash_decode_attention_shared_prefix_plain(qd, kc, vc, vl, plen),
            lambda: F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=mask, enable_gqa=True),
            (2 * n_read * hkv * dh + 2 * qd.numel()) * es + 4 * b,
            4 * int(vl.sum()) * h * dh,
        )
        return held_against(r, "k3", dtype, got, ka.flash_decode_attention(qd, kc, vc, vl),
                            lambda: ka.flash_decode_attention(qd, kc, vc, vl))

    def q8_cache(b, s_max, plen=0, layers=1):
        """An int8 head-major cache [L, B, Hkv, S_max, D] (scales [L, B,
        Hkv, S_max]) made by quantize_kv, rows sharing slots [0, plen);
        and the same cache dequantized to float32 (the library's input)."""
        out = []
        for _ in range(2):  # K, then V
            x = randn(layers, b, hkv, s_max, dh, dtype=torch.float32)
            x[:, :, :, :plen] = x[:, :1, :, :plen].clone()
            xq, xs = quantize_kv(x)
            out += [xq, xs]
        deq = [(out[i].float() * out[i + 1][..., None]) for i in (0, 2)]
        return out, deq

    def q8_bytes(n_slots, qd, es, b):
        """Bytes a decode over the int8 cache must move: each read slot's
        int8 K and V rows and their two float32 scales, q, out, valid_len."""
        return n_slots * hkv * (2 * dh + 8) + 2 * qd.numel() * es + 4 * b

    def k4(dtype, b, s, lo=1, stacked=False):  # int8 decode, cache prompt + 128
        es = torch.finfo(dtype).bits // 8
        s_max = s + 128
        layer = 1 if stacked else 0
        qd = randn(b, 1, h, dh, dtype=dtype)
        (kq_, ks, vq_, vs), (kd, vd) = q8_cache(b, s_max, layers=layer + 1)
        vl = torch.randint(lo, s_max + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
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
        return row(
            name, dtype, b, s, f"q[{b},1,{h},{dh}] cache_q8[{b},{hkv},{s_max},{dh}]"
            + (f" layer {layer} of 2" if stacked else ""),
            fn(), ka.flash_decode_attention_q8_plain(qd, *views, vl), fn,
            lambda: ka.flash_decode_attention_q8_plain(qd, *views, vl),
            lambda: F.scaled_dot_product_attention(qdt, kdl, vdl, attn_mask=mask, enable_gqa=True),
            q8_bytes(n_valid, qd, es, b), 4 * n_valid * h * dh,
        )

    def k7q8(dtype, b, s, stacked=False):  # the int8 fan-out's decode
        es = torch.finfo(dtype).bits // 8
        s_max, plen = s + 128, s - 13
        layer = 1 if stacked else 0
        qd = randn(b, 1, h, dh, dtype=dtype)
        (kq_, ks, vq_, vs), (kd, vd) = q8_cache(b, s_max, plen, layers=layer + 1)
        vl = torch.full((b,), plen + 64, device="cuda", dtype=torch.int32)
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
        n_read = plen + int((vl - plen).sum())  # the prefix once, each suffix
        r = row(
            name, dtype, b, s,
            f"q[{b},1,{h},{dh}] cache_q8[{b},{hkv},{s_max},{dh}] prefix {plen}"
            + (f" layer {layer} of 2" if stacked else ""),
            got, ka.flash_decode_attention_shared_prefix_q8_plain(qd, *views, vl, plen), fn,
            lambda: ka.flash_decode_attention_shared_prefix_q8_plain(qd, *views, vl, plen),
            lambda: F.scaled_dot_product_attention(qdt, kdl, vdl, attn_mask=mask, enable_gqa=True),
            q8_bytes(n_read, qd, es, b), 4 * int(vl.sum()) * h * dh,
        )
        return held_against(r, "k4", dtype, got, ka.flash_decode_attention_q8(qd, *views, vl),
                            lambda: ka.flash_decode_attention_q8(qd, *views, vl))

    def k6(dtype, m, k, n, out=None):  # x [M, K] @ int8 w [K, N]
        es = torch.finfo(dtype).bits // 8
        out_dtype = getattr(torch, out) if out else None
        x = randn(m, k, dtype=dtype)
        qt = quantize_tensor(randn(k, n, dtype=torch.float32) * 0.02, 0)
        w_lib = dequantize(qt, dtype)  # the library's weight, made ahead of time
        fn = lambda: kq.quant_matmul_2d(x, qt.q, qt.scale, out_dtype)  # noqa: E731
        out_es = torch.finfo(out_dtype or dtype).bits // 8
        r = row(
            "quant_matmul_2d", dtype, m, None,
            f"x[{m},{k}] w_q[{k},{n}] -> {out or str(dtype)[6:]}",
            fn(), kq.quant_matmul_2d_plain(x, qt.q, qt.scale, out_dtype), fn,
            lambda: kq.quant_matmul_2d_plain(x, qt.q, qt.scale, out_dtype),
            lambda: x @ w_lib,
            k * n + 4 * n + m * k * es + m * n * out_es, 2 * m * k * n,
            out_dtype=out_dtype,
        )
        r["kn"] = (k, n)
        return r

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
        for m, k, n, out in K6_CASES:
            rows.append(k6(dtype, m, k, n, out))
    for r in rows:
        ok = r["ratio"] <= 1.0 and math.isfinite(r["err"])
        extra = ""
        if "vs_ms" in r:
            ok = ok and r["vs_ratio"] <= 1.0
            extra = f" vs_{r['vs']}_err={r['vs_err']:.3e} {r['vs']}_ms={r['vs_ms']:.4f}"
        print(
            f"  {r['kernel']:48s} {r['dtype']:15s} {r['shape']:62s} "
            f"max_abs_err={r['err']:.3e} err/tol={r['ratio']:.3f} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}){extra} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"{r['kernel']} disagrees with its twin: {r}")
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def build_engine(torch, cfg, max_new_tokens: int = 64, quant: str = "none",
                 kv_quant: bool = False):
    """The main path's engine: ``cfg`` on the card, random bf16 weights
    from seed 0, quantized at engine init when ``quant="int8"``; the KV
    cache in int8 when ``kv_quant``."""
    from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_consensus_tpu_torch.models.transformer import init_params

    params = init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    return InferenceEngine(
        cfg, params, engine_config=EngineConfig(
            max_new_tokens=max_new_tokens, quant=quant, kv_quant=kv_quant)
    )


def run_consensus(engine):
    from llm_consensus_tpu_torch.backends.base import Backend, SamplingParams
    from llm_consensus_tpu_torch.backends.local import LocalBackend
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

    backend = CountingBackend(LocalBackend(engine))
    coord = Coordinator(
        default_panel(),
        backend,
        CoordinatorConfig(
            max_rounds=2,
            seed=0,
            sampling=SamplingParams(max_new_tokens=64, temperature=0.7, seed=0),
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


def run_self_consistency(torch, engine, card: str):
    from llm_consensus_tpu_torch.consensus import self_consistency

    prompt_len = len(engine.tokenizer.encode(SC_PROMPT))
    if not 64 < prompt_len <= 128:
        raise AssertionError(f"prompt is {prompt_len} tokens, not in the 128 bucket")
    out = {}
    for n in (8, 64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = self_consistency(
            engine, SC_PROMPT, n, temperature=0.7, seed=0, max_new_tokens=128,
            method="majority",
        )
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if len(sc.candidates) != n or not all(math.isfinite(x) for x in sc.logprobs):
            raise AssertionError(f"self-consistency N={n} gave bad candidates")
        if not 0 < sc.total_tokens <= n * 128:
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


# ---------------------------------------------------------------------------
# Phase 5: the kernels path against the plain path on the card
# ---------------------------------------------------------------------------


def reference_check(torch, cfg_full, int8: bool = False):
    """``int8``: int8 weights (the plain path with the matmul kernel
    switched off) and the int8 KV cache."""
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
    if int8:
        params = quant.quantize_params(params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    s, steps = 128, 16
    ragged = torch.randint(3, 259, (2, s), generator=gen, device="cuda")
    scenarios = (  # (label, tokens, lengths, shared prefix length or None)
        ("two ragged prompts", ragged, [s, 77], None),
        (f"fan-out of one prompt ({'K7-q8' if int8 else 'K7'})",
         ragged[:1].expand(4, s), [100] * 4, 100),
    )
    paths = (("kernels", cfg_k, None), ("plain", cfg_p, False))  # (name, cfg, kernel switch)

    def on_path(switch, fn, *args, **kw):
        quant.set_kernel_enabled(switch)
        try:
            return fn(*args, **kw)
        finally:
            quant.set_kernel_enabled(None)

    def same_cache(caches, stats):
        """int8: the two paths quantize float32 K/V that differ in the last
        bit, so an entry at a rounding boundary can land one int8 step
        apart. Check that this is all (at most one step, rare), then give
        the plain path the kernels path's cache, so that the logits compare
        each step's arithmetic on the same cache."""
        ck, cp = caches["kernels"], caches["plain"]
        for a, b_ in zip(ck.leaves, cp.leaves):
            if a.dtype == torch.int8:
                diff = (a.int() - b_.int()).abs()
                stats["max_step"] = max(stats["max_step"], int(diff.max()))
                stats["moved"] += int((diff > 0).sum())
                stats["entries"] += diff.numel()
            else:
                stats["scale_rel"] = max(stats["scale_rel"], float(
                    ((a - b_).abs() / a.abs().clamp(min=1e-30)).max()))
            b_.copy_(a)

    for label, tokens, lens, plen in scenarios:
        b = tokens.shape[0]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        caches, seqs, toks = {}, {}, {}
        for name, cfg, switch in paths:
            if int8:
                cache = QuantKVCache.create(cfg, b, s + steps, "cuda")
            else:
                cache = KVCache.create(cfg, b, s + steps, torch.float32, "cuda")
            logits, caches[name] = on_path(switch, prefill, cfg, params, tokens, lengths, cache)
            seqs[name], toks[name] = [logits], [logits.argmax(-1)]
        stats = dict(max_step=0, moved=0, entries=0, scale_rel=0.0)
        for _ in range(steps):
            if int8:
                same_cache(caches, stats)
            for name, cfg, switch in paths:
                logits, caches[name] = on_path(
                    switch, decode_step, cfg, params, toks[name][-1][:, None].to(torch.int64),
                    caches[name], uniform_write=plen is not None, shared_prefix_len=plen)
                seqs[name].append(logits)
                toks[name].append(logits.argmax(-1))
        worst = 0.0
        for lk, lp in zip(seqs["kernels"], seqs["plain"]):
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("non-finite logits on the kernels path")
            worst = max(worst, float((lk - lp).abs().max()))
        same = bool((torch.stack(toks["kernels"]) == torch.stack(toks["plain"])).all())
        tol = 1e-3  # float32 logits of magnitude ~1 after 2 layers
        weights = "int8 weights + int8 cache" if int8 else "float32 cache"
        extra = ""
        if int8:
            share = stats["moved"] / stats["entries"]
            extra = (f" cache_entries_one_step_apart={stats['moved']}/{stats['entries']}"
                     f" max_int8_step={stats['max_step']}"
                     f" scale_max_rel_diff={stats['scale_rel']:.2e}")
            if stats["max_step"] > 1 or share > 1e-3 or stats["scale_rel"] > 1e-4:
                raise AssertionError(f"the two paths wrote different int8 caches: {extra}")
        print(
            f"  llama-1b widths, 2 layers, float32, {weights}, {label}, B={b} S={s}: prefill+{steps} "
            f"decode steps max_abs_logit_err={worst:.3e} tol={tol:.0e} "
            f"greedy_tokens_equal={same}{extra}"
        )
        if worst > tol or not same:
            raise AssertionError(f"kernels path disagrees with the plain path: {label}")


# ---------------------------------------------------------------------------


def launch_counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels.KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.ops import kernels
    from llm_consensus_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {smi}")

    print("phase 1: build")
    t0 = time.perf_counter()
    build.load_library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({build.library_path().name})")

    cfg = get_config("llama-1b")
    print("phase 2: kernels against their twins")
    rows = kernel_cases(torch, cfg, Timer(torch))

    # Each main path, and the kernels it must launch. K5 and K7-q8-stacked
    # run only under set_stacked_decode(True) (off by default, as in the
    # JAX package): they count in phase 5's stacked run.
    paths = (
        ("bf16", dict(), ("fused_rms_norm", "flash_causal_attention",
                          "flash_decode_attention", "flash_decode_attention_shared_prefix")),
        ("int8", dict(quant="int8", kv_quant=True), (
            "fused_rms_norm", "flash_causal_attention", "quant_matmul_2d",
            "flash_decode_attention_q8", "flash_decode_attention_shared_prefix_q8")),
    )
    path_counts = {}
    for label, engine_kw, needed in paths:
        print(f"phase 3 ({label}): consensus question on llama-1b, full depth")
        engine = build_engine(torch, cfg, **engine_kw)
        kernels.reset_launch_counts()
        run_consensus(engine)
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
        del engine
        torch.cuda.empty_cache()

    print("phase 5: reference check")
    from llm_consensus_tpu_torch.models.transformer import set_stacked_decode

    reference_check(torch, cfg)
    for stacked, needed in ((False, ("quant_matmul_2d", "flash_decode_attention_q8",
                                     "flash_decode_attention_shared_prefix_q8")),
                            (True, ("flash_decode_attention_q8_stacked",
                                    "flash_decode_attention_shared_prefix_q8_stacked"))):
        set_stacked_decode(stacked)
        kernels.reset_launch_counts()
        try:
            reference_check(torch, cfg, int8=True)
        finally:
            set_stacked_decode(False)
        counts = launch_counts(kernels)
        print(f"  launches, int8 check, stacked decode {stacked}: {counts}")
        missing = [name for name in needed if counts[name] == 0]
        if missing:
            raise AssertionError(f"the int8 check (stacked {stacked}) never launched {missing}")
        if stacked:
            path_counts["int8_stacked_check"] = counts

    d = "llm_consensus_tpu_torch/ops/kernels/csrc/"
    p = "llm_consensus_tpu/ops/pallas/"
    # name -> (source, TPU kernel it replaces, the runs whose launches count)
    sources = {
        "fused_rms_norm": (d + "rms_norm.cu", p + "norms.py:26", ("bf16", "int8")),
        "flash_causal_attention": (d + "causal_attention.cu", p + "attention.py:90",
                                   ("bf16", "int8")),
        "flash_decode_attention": (d + "decode_attention.cu", p + "attention.py:391", ("bf16",)),
        "flash_decode_attention_shared_prefix": (
            d + "decode_attention.cu", p + "attention.py:1494", ("bf16",)),
        "flash_decode_attention_q8": (d + "decode_attention.cu", p + "attention.py:280",
                                      ("int8",)),
        "flash_decode_attention_q8_stacked": (
            d + "decode_attention.cu", p + "attention.py:444", ("int8_stacked_check",)),
        "quant_matmul_2d": (d + "quant_matmul.cu", p + "quant_matmul.py:59", ("int8",)),
        "flash_decode_attention_shared_prefix_q8": (
            d + "decode_attention.cu", p + "attention.py:1541", ("int8",)),
        "flash_decode_attention_shared_prefix_q8_stacked": (
            d + "decode_attention.cu", p + "attention.py:1586", ("int8_stacked_check",)),
    }
    summary = []
    for name, (source, replaces, runs) in sources.items():
        want = REPORTED_K6 if name == "quant_matmul_2d" else REPORTED
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
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
