#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and ``nvcc`` (the kernels are built from
``llm_consensus_tpu_torch/ops/kernels/csrc`` at first use) and imports
nothing of JAX or of the JAX package. Phases:

1. Build the kernels; print the card's name and power limit.
2. Hold each kernel (K1 RMSNorm, K2 causal prefill attention, K3 decode
   attention, K7 shared-prefix decode attention) against its plain
   PyTorch twin on the card at llama-1b shapes (B in {1, 8}, prompt
   buckets 128 and 256, cache length prompt + 128, bf16 and fp32, plus
   the main path's own largest shapes in ``MAIN_PATH_CASES``, also in
   both types). K7 is also held against K3 on the same cache. Print the
   max abs error and the worst ratio of error to tolerance, the kernel's
   time, the twin's time, one PyTorch call computing the same function
   (``library_ms``: F.rms_norm, scaled_dot_product_attention) and the
   bound (the least time the card could take for the same work).
3. The main path, part one: llama-1b at full width and depth in bf16,
   random weights from a fixed seed, answers one question through
   Coordinator -> LocalBackend -> InferenceEngine (default panel, round
   cap 2, 64 new tokens).
4. The main path, part two: self-consistency with N = 8 and N = 64 on one
   128-token prompt, 128 new tokens, majority vote; candidate-tokens/s.
   The fan-out decodes through K7 (the prompt's K/V read once per step).
   The kernels' launch counts are set to 0 just before phase 3 and read
   just after phase 4; each must be > 0.
5. Reference check on the card: llama-1b's widths cut to 2 layers, in
   float32, kernels path against the plain path (prefill and decode
   logits, greedy tokens), for two ragged prompts and for a 4-row
   fan-out of one prompt decoding through K7; and finite outputs of
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
# (4 prompts, bucket 2048), K3 on that panel's decode, K7 on the N=64
# fan-out's decode.
MAIN_PATH_CASES = (
    ("fused_rms_norm", 64, 1),
    ("flash_causal_attention", 4, 2048),
    ("flash_decode_attention", 4, 2048),
    ("flash_decode_attention_shared_prefix", 64, 128),
)
# The case each kernel reports in the kernels JSON line.
REPORTED = {"dtype": "torch.bfloat16", "b": 8, "s": 256}


def kernel_cases(torch, cfg, timer):
    import torch.nn.functional as F

    from llm_consensus_tpu_torch.ops.kernels import attention as ka
    from llm_consensus_tpu_torch.ops.kernels import norms as kn

    gen = torch.Generator(device="cuda").manual_seed(1234)
    d_model, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def row(kernel, dtype, b, s, shape, got, ref, fn, plain, library, nbytes, ops,
            plain_iters=20):
        err, ratio = compare(dtype, got, ref)
        return dict(
            kernel=kernel, dtype=str(dtype), b=b, s=s, shape=shape,
            err=err, ratio=ratio, ms=timer.ms(fn),
            plain_ms=timer.ms(plain, iters=plain_iters), library_ms=timer.ms(library),
            bound=bound_ms(nbytes, ops, dtype),
        )

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
        # The same function through K3, which reads every row's prefix.
        k3_err, k3_ratio = compare(dtype, got, ka.flash_decode_attention(qd, kc, vc, vl))
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
        r.update(k3_err=k3_err, k3_ratio=k3_ratio,
                 k3_ms=timer.ms(lambda: ka.flash_decode_attention(qd, kc, vc, vl)))
        return r

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            for s in (128, 256):
                rows += [k1(dtype, b, s), k2(dtype, b, s), k3(dtype, b, s), k7(dtype, b, s)]
    cases = {"fused_rms_norm": k1, "flash_causal_attention": k2,
             "flash_decode_attention": lambda dt, b, s: k3(dt, b, s, lo=s + 1),
             "flash_decode_attention_shared_prefix": k7}
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, b, s in MAIN_PATH_CASES:
            rows.append(cases[kernel](dtype, b, s))
    for r in rows:
        ok = r["ratio"] <= 1.0 and math.isfinite(r["err"])
        extra = ""
        if "k3_ms" in r:
            ok = ok and r["k3_ratio"] <= 1.0
            extra = f" vs_k3_err={r['k3_err']:.3e} k3_ms={r['k3_ms']:.4f}"
        print(
            f"  {r['kernel']:36s} {r['dtype']:15s} {r['shape']:50s} "
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


def build_engine(torch, cfg, max_new_tokens: int = 64):
    """The main path's engine: ``cfg`` on the card in bf16, random weights
    from seed 0."""
    from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_consensus_tpu_torch.models.transformer import init_params

    params = init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    return InferenceEngine(
        cfg, params, engine_config=EngineConfig(max_new_tokens=max_new_tokens)
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


def reference_check(torch, cfg_full):
    from llm_consensus_tpu_torch.models.cache import KVCache
    from llm_consensus_tpu_torch.models.transformer import (
        decode_step,
        init_params,
        prefill,
    )

    cfg_k = cfg_full.with_(n_layers=2, use_pallas=True)
    cfg_p = cfg_k.with_(use_pallas=False)
    params = init_params(cfg_k, 7, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    s, steps = 128, 16
    ragged = torch.randint(3, 259, (2, s), generator=gen, device="cuda")
    scenarios = (  # (label, tokens, lengths, shared prefix length or None)
        ("two ragged prompts", ragged, [s, 77], None),
        ("fan-out of one prompt (K7)", ragged[:1].expand(4, s), [100] * 4, 100),
    )
    for label, tokens, lens, plen in scenarios:
        b = tokens.shape[0]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        toks = {}
        for name, cfg in (("kernels", cfg_k), ("plain", cfg_p)):
            cache = KVCache.create(cfg, b, s + steps, torch.float32, "cuda")
            logits, cache = prefill(cfg, params, tokens, lengths, cache)
            seq = [logits]
            tok = logits.argmax(-1)
            out = [tok]
            for _ in range(steps):
                logits, cache = decode_step(
                    cfg, params, tok[:, None].to(torch.int64), cache,
                    uniform_write=plen is not None, shared_prefix_len=plen)
                seq.append(logits)
                tok = logits.argmax(-1)
                out.append(tok)
            toks[name] = (torch.stack(out, 1), seq)
        worst = 0.0
        for lk, lp in zip(toks["kernels"][1], toks["plain"][1]):
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("non-finite logits on the kernels path")
            worst = max(worst, float((lk - lp).abs().max()))
        same = bool((toks["kernels"][0] == toks["plain"][0]).all())
        tol = 1e-3  # float32 logits of magnitude ~1 after 2 layers
        print(
            f"  llama-1b widths, 2 layers, float32, {label}, B={b} S={s}: prefill+{steps} "
            f"decode steps max_abs_logit_err={worst:.3e} tol={tol:.0e} "
            f"greedy_tokens_equal={same}"
        )
        if worst > tol or not same:
            raise AssertionError(f"kernels path disagrees with the plain path: {label}")


# ---------------------------------------------------------------------------


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

    print("phase 3: consensus question on llama-1b, bf16, full depth")
    engine = build_engine(torch, cfg)
    kernels.reset_launch_counts()
    run_consensus(engine)
    torch.cuda.synchronize()
    consensus_counts = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    print(f"  launches: {consensus_counts}")

    print("phase 4: self-consistency on llama-1b, bf16")
    run_self_consistency(torch, engine, card)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    print(f"  launches over phases 3 and 4: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    del engine
    torch.cuda.empty_cache()

    print("phase 5: reference check")
    reference_check(torch, cfg)

    sources = {
        "fused_rms_norm": ("llm_consensus_tpu_torch/ops/kernels/csrc/rms_norm.cu",
                           "llm_consensus_tpu/ops/pallas/norms.py:26"),
        "flash_causal_attention": (
            "llm_consensus_tpu_torch/ops/kernels/csrc/causal_attention.cu",
            "llm_consensus_tpu/ops/pallas/attention.py:90"),
        "flash_decode_attention": (
            "llm_consensus_tpu_torch/ops/kernels/csrc/decode_attention.cu",
            "llm_consensus_tpu/ops/pallas/attention.py:391"),
        "flash_decode_attention_shared_prefix": (
            "llm_consensus_tpu_torch/ops/kernels/csrc/decode_attention.cu",
            "llm_consensus_tpu/ops/pallas/attention.py:1494"),
    }
    summary = []
    for name, (source, replaces) in sources.items():
        r = next(r for r in rows if r["kernel"] == name
                 and all(r[k] == v for k, v in REPORTED.items()))
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
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
