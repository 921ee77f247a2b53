"""InferenceEngine: text-in/text-out over the generate loop.

Counterpart of ``llm_consensus_tpu.engine.engine.InferenceEngine`` on the
dense path: tokenization, right-padding, shape bucketing (dummy rows pad
the batch up to a bucket), per-call generators and detokenization. It
stands where the reference's ``call_gemini`` stood (``src/main.rs:82-86``),
but batched.

Weights may be quantized to int8 or packed int4 at init (``quant``) and
the KV cache kept in int8 (``kv_quant``), as in the JAX package; long
prompts prefill in chunks (``prefill_chunk``). ``generate_texts`` takes
a shared ``prefix`` (prefilled once, kept in :class:`PrefixCache`) and
stop sequences of any length (a multi-token stop decodes in chunks of
``stop_check_chunk`` steps with host checks between them).
:meth:`InferenceEngine.generate_stream` yields text as it decodes,
:meth:`InferenceEngine.score_texts` scores given completions and
:meth:`InferenceEngine.stats` counts calls. :meth:`InferenceEngine.
memory_estimate` and :func:`plan_memory` are the JAX package's capacity
planner for one card, MoE configs included. Not ported yet: speculative
decoding, meshes and the native batch encoder.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from llm_consensus_tpu_torch.engine.generate import (
    GenerateOutput,
    prefill_into_cache,
    decode_steps,
    generate,
    generate_from_prefix,
    prefill_from_prefix,
    score_completions,
)
from llm_consensus_tpu_torch.engine.prefix_cache import PrefixCache
from llm_consensus_tpu_torch.engine.sampler import SamplerConfig, sample_token
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer, Tokenizer
from llm_consensus_tpu_torch.models.cache import KVCache
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.models.transformer import prefill, prefill_chunked
from llm_consensus_tpu_torch.ops.quant import quantize_params
from llm_consensus_tpu_torch.utils.device import resolve_device, to_device
from llm_consensus_tpu_torch.utils.stops import (
    VisibleIdFilter,
    earliest_stop_cut,
    single_token_stop_ids,
    stop_tail_window,
)

log = logging.getLogger(__name__)


def _next_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _kv_cache_bytes(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    quant: bool,
    slack: int = 0,
    shared_len: int = 0,
) -> int:
    """KV-cache bytes for a generate call: the one copy of the cache
    capacity formula (``memory_estimate`` and ``plan_memory`` both call
    it).

    ``shared_len``: prompt-prefix tokens stored once for the whole batch
    instead of once per row (the paged serving path's shared pages: an
    N-way fan-out holds prefix + N * suffix). 0 (the default) models the
    engine's dense per-row cache, which duplicates the prefix.
    """
    shared_len = max(0, min(shared_len, cache_len))
    tokens = batch * (cache_len + slack) - (batch - 1) * shared_len
    slots = cfg.n_layers * tokens * cfg.n_kv_heads
    if quant:
        # int8 k+v + one f32 scale each per (slot, head)
        return slots * (2 * cfg.head_dim + 2 * 4)
    return slots * 2 * cfg.head_dim * 2  # bf16 k+v


def _logits_bytes(cfg: ModelConfig, batch: int) -> int:
    return batch * cfg.vocab_size * 4


def _memory_plan(
    cfg: ModelConfig,
    params_bytes: int,
    *,
    seq_buckets: tuple[int, ...],
    batch_buckets: tuple[int, ...],
    n_candidates: int,
    prompt_len: int,
    new_tokens: int,
    kv_quant: bool,
    shared_prefix_len: int,
    hbm_bytes: int | None,
    mesh_shape: dict | None = None,
) -> dict:
    """The terms of ``memory_estimate`` and ``plan_memory``: the engine's
    bucketing of the batch and the prompt, the KV cache and logits of one
    generate call at those shapes, and their total with the params. On a
    mesh (``mesh_shape``) the terms are per rank: ``params_bytes`` comes
    in already sharded, and the KV cache and the logits divide by
    ``data`` x ``model`` (the cache's batch over data, its kv heads over
    model; the JAX package's division)."""
    s = min(_next_bucket(prompt_len, seq_buckets), cfg.max_seq_len)
    b = _next_bucket(n_candidates, batch_buckets)
    cache_len = s + max(1, min(new_tokens, cfg.max_seq_len - s))
    kv = _kv_cache_bytes(
        cfg, b, cache_len, kv_quant, shared_len=min(shared_prefix_len, s)
    )
    logits = _logits_bytes(cfg, b)
    shape = mesh_shape or {}
    c_div = shape.get("data", 1) * shape.get("model", 1)
    kv //= c_div
    logits //= max(1, c_div)
    out = {
        "params_bytes": params_bytes,
        "kv_cache_bytes": kv,
        "logits_bytes": logits,
        "total_bytes": params_bytes + kv + logits,
        "batch": b,
        "cache_len": cache_len,
    }
    if hbm_bytes is not None:
        out["fits"] = out["total_bytes"] <= hbm_bytes
    return out


_QUANT_BITS = {"int8": 8, "int4": 4}


@dataclass
class EngineConfig:
    max_new_tokens: int = 256
    # Prompt-length buckets (right-padded up; keeps the set of shapes small).
    seq_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    # Batch-size buckets (padded up with dummy rows).
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    # Weight-only per-channel quantization at engine init (ops/quant.py):
    # "int8" halves the weight bytes every decode step reads, "int4"
    # (packed nibbles) halves them again at reduced precision.
    quant: str = "none"
    # int8 KV cache (models/cache.QuantKVCache): halves the cache bytes
    # every decode step reads.
    kv_quant: bool = False
    # > 0: prefill prompts longer than this in fixed-size chunks
    # (models/transformer.prefill_chunked): bounded activation memory for
    # long contexts. With kv_quant each chunk's K/V is quantized at write
    # time with the one-shot prefill's per-(token, head) rule; the chunks'
    # attention reads a dequantized copy, so past the first layer (which
    # is bit-identical to the one-shot cache) a few entries move by one
    # int8 step, as in the JAX package.
    prefill_chunk: int = 0
    # Prefix cache (engine/prefix_cache.py): shared prompt prefixes are
    # prefilled once and their K/V reused across calls, within these
    # entry and byte budgets.
    prefix_cache_entries: int = 8
    prefix_cache_bytes: int = 1 << 30
    # Decode steps between host checks when a call carries multi-token
    # stop sequences (the device ends rows only on single-token stops).
    stop_check_chunk: int = 16


@dataclass
class EngineResult:
    text: str
    num_tokens: int
    logprob: float
    token_ids: list[int]


class InferenceEngine:
    """Batched local text generation on one model's weights.

    ``device``: where the weights live and the model runs; the card
    (``"cuda"``) unless the caller asks for ``"cpu"``. Without a card and
    without ``device="cpu"`` the constructor raises.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        tokenizer: Tokenizer | None = None,
        engine_config: EngineConfig | None = None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.tokenizer = tokenizer or ByteTokenizer()
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds model "
                f"vocab {cfg.vocab_size}"
            )
        self.config = engine_config or EngineConfig()
        if self.config.quant in _QUANT_BITS:
            self.params = quantize_params(
                self.params, bits=_QUANT_BITS[self.config.quant]
            )
        elif self.config.quant != "none":
            raise ValueError(f"unknown quant mode {self.config.quant!r}")
        self.prefix_cache = PrefixCache(
            max_entries=self.config.prefix_cache_entries,
            max_bytes=self.config.prefix_cache_bytes,
        )
        # Lifetime counters; see stats().
        self._calls = {"generate": 0, "stream": 0, "score": 0}
        self._tokens_generated = 0
        # Tail window of the incremental stop checks (its memo persists
        # across calls).
        self._vis_filter = VisibleIdFilter(
            self.tokenizer, skip_ids=(self.tokenizer.eos_id,)
        )

    # ------------------------------------------------------------------

    def _prepare(
        self, prompts: list[str], add_bos: bool = True
    ) -> tuple[np.ndarray, np.ndarray, int]:
        tok = self.tokenizer
        # Left-truncate over-long prompts (keep the question tail); the cap
        # is the model context, not just the largest bucket.
        max_prompt = min(self.config.seq_buckets[-1], self.cfg.max_seq_len - 1)
        encoded = [tok.encode(p, add_bos=add_bos)[-max_prompt:] for p in prompts]
        enc_lengths = np.array([len(ids) for ids in encoded], np.int32)
        longest = int(enc_lengths.max())
        s = _next_bucket(longest, self.config.seq_buckets)
        s = min(s, self.cfg.max_seq_len)
        b = _next_bucket(len(prompts), self.config.batch_buckets)
        tokens = np.full((b, s), tok.pad_id, np.int32)
        for i, ids in enumerate(encoded):
            tokens[i, : len(ids)] = ids
        lengths = np.zeros((b,), np.int32)
        lengths[: len(prompts)] = enc_lengths
        # Dummy pad rows get length 1 so gather/clip stay in range.
        lengths[len(prompts) :] = 1
        return tokens, lengths, len(prompts)

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def generate_texts(
        self,
        prompts: list[str],
        temperatures: list[float] | None = None,
        seed: int = 0,
        max_new_tokens: int | None = None,
        sampler: SamplerConfig | None = None,
        prefix: str | None = None,
        stop: list[str] | None = None,
        _outer: bool = True,
    ) -> list[EngineResult]:
        """Generate one completion per prompt.

        One batch per chunk of ``batch_buckets[-1]`` prompts; most calls
        fit a single chunk. ``sampler`` overrides the engine's default
        top-k/top-p config for this call.

        ``prefix``: a shared prompt prefix; row i's prompt is ``prefix +
        prompts[i]``. The prefix's K/V is prefilled once and kept in
        ``self.prefix_cache``, so later calls with the same prefix skip its
        prefill (int8-cache engines quantize the stored prefix on entry).
        Prefix and suffix are tokenized separately.

        ``stop``: stop sequences. Text is trimmed at the earliest
        occurrence of any stop string (the stop itself is removed); stops
        that tokenize to a single id also end their row's decoding, like
        EOS. A multi-token stop decodes in ``stop_check_chunk``-step calls
        with host text checks between them, and the accounting is
        realigned to the prefix through the stop
        (:meth:`_exact_stop_accounting`).
        """
        if not prompts:
            return []
        if _outer:
            self._calls["generate"] += 1
        chunk = self.config.batch_buckets[-1]
        if len(prompts) > chunk:
            out: list[EngineResult] = []
            for i in range(0, len(prompts), chunk):
                out.extend(
                    self.generate_texts(
                        prompts[i : i + chunk],
                        temperatures=(
                            temperatures[i : i + chunk]
                            if temperatures is not None
                            else None
                        ),
                        seed=seed + i,
                        max_new_tokens=max_new_tokens,
                        sampler=sampler,
                        prefix=prefix,
                        stop=stop,
                        _outer=False,
                    )
                )
            return out
        if prefix:
            return self._generate_with_prefix(
                prompts, prefix, temperatures, seed, max_new_tokens, sampler, stop
            )
        tokens, lengths, n_real = self._prepare(prompts)
        b = tokens.shape[0]
        temps = np.zeros((b,), np.float32)
        if temperatures is not None:
            temps[:n_real] = np.asarray(temperatures, np.float32)
        mnt = max_new_tokens or self.config.max_new_tokens
        # Clamp so prompt + generation fits the model context.
        mnt = max(1, min(mnt, self.cfg.max_seq_len - tokens.shape[1]))
        # Identical prompts (self-consistency fan-out) prefill once and
        # copy the cache instead of prefilling B copies.
        shared = n_real == b and len(set(prompts)) == 1 and b > 1
        tokens_t, lengths_t, temps_t = (
            self._h2d(tokens), self._h2d(lengths), self._h2d(temps))
        if self._multi_token_stop(stop):
            logits, cache = prefill_into_cache(
                self.cfg, self.params, tokens_t, lengths_t,
                cache_len=tokens.shape[1] + mnt, shared_prefill=shared,
                kv_quant=self.config.kv_quant, prefill_chunk=self.config.prefill_chunk,
            )
            return self._chunked_stop_decode(
                logits, cache, temps_t, n_real, seed, mnt, sampler, stop
            )
        out: GenerateOutput = generate(
            self.cfg,
            self.params,
            tokens_t,
            lengths_t,
            torch.Generator(device=self.device).manual_seed(seed),
            temps_t,
            max_new_tokens=mnt,
            sampler=sampler if sampler is not None else self.config.sampler,
            eos_id=self.tokenizer.eos_id,
            pad_id=self.tokenizer.pad_id,
            shared_prefill=shared,
            stop_ids=single_token_stop_ids(self.tokenizer, stop or ()),
            kv_quant=self.config.kv_quant,
            prefill_chunk=self.config.prefill_chunk,
        )
        return self._trim_stops(self._collect(out, n_real), stop)

    def _multi_token_stop(self, stop: list[str] | None) -> bool:
        return bool(stop) and any(
            len(self.tokenizer.encode(x, add_bos=False)) > 1 for x in stop
        )

    # -- prefix-cached generation --------------------------------------

    def _prefix_kv(self, ids: list[int]):
        """(k, v) [L, 1, Pb, Hkv, D] of the prefilled prefix ``ids``
        (cached). The buffers are padded to the power-of-two bucket Pb of
        the true length; the pad slots are never attended."""
        key = tuple(ids)
        hit = self.prefix_cache.get(key)
        if hit is not None:
            return hit
        p = len(ids)
        pb = min(1 << max(p - 1, 0).bit_length(), self.cfg.max_seq_len - 2)
        cache = KVCache.create(self.cfg, 1, pb, self.params["embed"].dtype, self.device)
        tokens = self._h2d(np.asarray([ids + [self.tokenizer.pad_id] * (pb - p)], np.int32))
        lengths = self._h2d(np.asarray([p], np.int32))
        if self.config.prefill_chunk and pb > self.config.prefill_chunk:
            _, cache = prefill_chunked(self.cfg, self.params, tokens, lengths, cache,
                                       chunk=self.config.prefill_chunk)
        else:
            _, cache = prefill(self.cfg, self.params, tokens, lengths, cache)
        self.prefix_cache.put(key, cache.k, cache.v)
        return cache.k, cache.v

    def _generate_with_prefix(
        self, prompts, prefix, temperatures, seed, max_new_tokens, sampler, stop,
    ) -> list[EngineResult]:
        """The prefix path (the JAX package's rules): suffixes that cannot
        sit whole after the prefix, or exceed the chunked-prefill bound,
        take the plain path on the concatenated prompts."""
        ctx = self.cfg.max_seq_len
        prefix_ids = self.tokenizer.encode(prefix)[-(ctx - 2):]
        p = len(prefix_ids)

        def fallback():
            log.debug("prefix cache bypassed (suffix does not fit)")
            return self.generate_texts(
                [prefix + q for q in prompts], temperatures=temperatures, seed=seed,
                max_new_tokens=max_new_tokens, sampler=sampler, stop=stop, _outer=False,
            )

        suf = [self.tokenizer.encode(q, add_bos=False)[:ctx] for q in prompts]
        longest = max(len(x) for x in suf)
        if min(len(x) for x in suf) < 1 or p + longest + 1 > ctx:
            return fallback()
        s = max(min(_next_bucket(longest, self.config.seq_buckets), ctx - p - 1), longest)
        if self.config.prefill_chunk and s > self.config.prefill_chunk:
            return fallback()
        pk, pv = self._prefix_kv(prefix_ids)
        b = _next_bucket(len(prompts), self.config.batch_buckets)
        tokens = np.full((b, s), self.tokenizer.pad_id, np.int32)
        for i, ids in enumerate(suf):
            tokens[i, : len(ids)] = ids
        lengths = np.ones((b,), np.int32)  # dummy rows: length 1
        lengths[: len(prompts)] = [len(x) for x in suf]
        n_real = len(prompts)
        pb = pk.shape[2]
        if pb + s > ctx:
            pb = ctx - s
            if pb < p:
                return fallback()
            pk, pv = pk[:, :, :pb], pv[:, :, :pb]
        temps = np.zeros((b,), np.float32)
        if temperatures is not None:
            temps[:n_real] = np.asarray(temperatures, np.float32)
        mnt = max_new_tokens or self.config.max_new_tokens
        mnt = max(1, min(mnt, ctx - p - s))
        shared = n_real == b and len(set(prompts)) == 1 and b > 1
        # The suffix chunk's MoE path is the one a plain one-shot prefill
        # of the concatenated prompt takes (batch x its seq bucket).
        moe_dense = None
        if self.cfg.is_moe and self.cfg.moe_capacity_factor > 0:
            s_plain = min(_next_bucket(p + longest, self.config.seq_buckets), ctx)
            moe_dense = self.cfg.moe_dense_at((1 if shared else b) * s_plain)
        tokens_t, lengths_t, temps_t = (
            self._h2d(tokens), self._h2d(lengths), self._h2d(temps))
        if self._multi_token_stop(stop):
            logits, cache = prefill_from_prefix(
                self.cfg, self.params, pk, pv, p, tokens_t, lengths_t,
                cache_len=pb + s + mnt, shared_suffix=shared,
                kv_quant=self.config.kv_quant, moe_suffix_dense=moe_dense,
            )
            return self._chunked_stop_decode(
                logits, cache, temps_t, n_real, seed, mnt, sampler, stop
            )
        out = generate_from_prefix(
            self.cfg, self.params, pk, pv, p, tokens_t, lengths_t,
            torch.Generator(device=self.device).manual_seed(seed), temps_t,
            max_new_tokens=mnt,
            sampler=sampler if sampler is not None else self.config.sampler,
            eos_id=self.tokenizer.eos_id,
            pad_id=self.tokenizer.pad_id,
            stop_ids=single_token_stop_ids(self.tokenizer, stop or ()),
            shared_suffix=shared,
            kv_quant=self.config.kv_quant,
            moe_suffix_dense=moe_dense,
        )
        return self._trim_stops(self._collect(out, n_real), stop)

    # -- multi-token stops ---------------------------------------------

    def _chunked_stop_decode(
        self, logits, cache, temps_t, n_real, seed, mnt, sampler, stop
    ) -> list[EngineResult]:
        """Decode from first-token logits and a filled cache in
        ``stop_check_chunk``-step calls, checking each live row's text for
        a stop between calls; a row whose text holds a stop is marked done
        on the card at the next call. Greedy text equals the one-shot
        path's (cut at the stop); sampled rows draw from one generator in
        call order."""
        tok_ = self.tokenizer
        b = logits.shape[0]
        sampler_cfg = sampler if sampler is not None else self.config.sampler
        stop_ids = single_token_stop_ids(tok_, stop)
        terminal = {tok_.eos_id, *stop_ids}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok, lp0 = sample_token(logits, gen, temps_t, sampler_cfg)
        toks0 = tok.cpu().numpy()
        done_np = np.array([int(t) in terminal for t in toks0])
        cols_toks = [toks0[:, None].astype(np.int32)]
        cols_live = [np.ones((b, 1), bool)]
        cols_lp = [lp0.float().cpu().numpy()[:, None]]
        stop_hit = np.zeros((b,), bool)
        done = self._h2d(done_np)
        produced = 1
        chunk = max(1, self.config.stop_check_chunk)
        win = stop_tail_window(tok_, stop)
        row_ids = [[] if done_np[r] else [int(toks0[r])] for r in range(n_real)]
        while produced < mnt:
            active = [r for r in range(n_real) if not done_np[r] and not stop_hit[r]]
            if not active:
                break
            k = min(chunk, mnt - produced)
            out, live, cache, done, tok, lp = decode_steps(
                self.cfg, self.params, cache, tok, done, gen, temps_t, steps=k,
                sampler=sampler_cfg, eos_id=tok_.eos_id, pad_id=tok_.pad_id,
                stop_ids=stop_ids,
            )
            out_np = out.cpu().numpy().astype(np.int32)
            live_np = live.cpu().numpy()
            cols_toks.append(out_np)
            cols_live.append(live_np)
            cols_lp.append(lp.float().cpu().numpy())
            produced += k
            done_np = done.cpu().numpy().copy()
            for r in active:
                row_ids[r].extend(
                    int(t) for t, alive in zip(out_np[r], live_np[r])
                    if alive and int(t) not in terminal
                )
                ids = row_ids[r]
                if not done_np[r] and self._vis_filter.confirmed_stop_hit(
                        ids, stop, win, lambda ids=ids: tok_.decode(ids)):
                    stop_hit[r] = True
            if stop_hit.any():
                done = self._h2d(done_np | stop_hit)
        tokens_arr = np.concatenate(cols_toks, axis=1)
        live_arr = np.concatenate(cols_live, axis=1)
        lp_arr = np.concatenate(cols_lp, axis=1)
        out = GenerateOutput(
            tokens=torch.from_numpy(tokens_arr),
            num_tokens=torch.from_numpy(live_arr.sum(axis=1).astype(np.int32)),
            logprob_sum=torch.from_numpy(lp_arr.sum(axis=1)),
        )
        results = self._trim_stops(self._collect(out, n_real), stop)
        return self._exact_stop_accounting(results, tokens_arr, lp_arr, stop)

    def _exact_stop_accounting(self, results, toks_np, lp_np, stop) -> list[EngineResult]:
        """Align the chunked path's ``num_tokens`` / ``logprob`` /
        ``token_ids`` with the single-token-stop path's: exactly the
        prefix through the first complete stop (its tokens counted, like
        EOS), not up to one ``stop_check_chunk`` of overshoot, so vote
        weights do not depend on how a stop tokenizes. The search assumes
        the decoded prefix's containment of a stop is monotone in its
        token count (exact for byte-level tokenizers)."""
        eos = self.tokenizer.eos_id
        for i, r in enumerate(results):
            n = r.num_tokens
            if n <= 1:
                continue

            def ids(m: int) -> list[int]:
                return [int(t) for t in toks_np[i, :m] if int(t) != eos]

            if earliest_stop_cut(self.tokenizer.decode(ids(n)), stop) < 0:
                continue
            lo, hi = 1, n
            while lo < hi:
                mid = (lo + hi) // 2
                if earliest_stop_cut(self.tokenizer.decode(ids(mid)), stop) >= 0:
                    hi = mid
                else:
                    lo = mid + 1
            if lo < n:
                self._tokens_generated -= n - lo
                r.num_tokens = lo
                r.logprob = float(lp_np[i, :lo].sum())
                r.token_ids = ids(lo)
        return results

    # -- streaming and scoring -----------------------------------------

    def generate_stream(
        self,
        prompt: str,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        max_new_tokens: int | None = None,
        chunk: int = 16,
        sampler: SamplerConfig | None = None,
        stop: list[str] | None = None,
    ):
        """Yield text increments for one prompt as tokens decode: prefill
        once, then decode in calls of ``chunk`` steps, yielding the newly
        decoded text after each. Greedy streaming concatenates to exactly
        ``generate_texts``'s text. A tail that may still grow into a stop
        string, and trailing replacement characters of a split multi-byte
        sequence, are held back until they resolve."""
        self._calls["stream"] += 1
        tok_ = self.tokenizer
        tokens, lengths, _ = self._prepare([prompt])
        tokens, lengths = tokens[:1], lengths[:1]
        s = tokens.shape[1]
        mnt = max_new_tokens or self.config.max_new_tokens
        mnt = max(1, min(mnt, self.cfg.max_seq_len - s))
        chunk = max(1, chunk)
        sampler_cfg = sampler if sampler is not None else self.config.sampler
        stop = stop or []
        stop_ids = single_token_stop_ids(tok_, stop)
        terminal = {tok_.eos_id, *stop_ids}
        temps = self._h2d(np.asarray([temperature], np.float32))
        logits, cache = prefill_into_cache(
            self.cfg, self.params, self._h2d(tokens), self._h2d(lengths),
            cache_len=s + mnt, kv_quant=self.config.kv_quant,
            prefill_chunk=self.config.prefill_chunk,
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok, _ = sample_token(logits, gen, temps, sampler_cfg)
        first = int(tok[0])
        ids: list[int] = [] if first in terminal else [first]
        done = self._h2d(np.asarray([first in terminal]))
        self._tokens_generated += 1
        yielded = 0

        def flush(final: bool):
            """(increment, finished): the decoded text past what was
            already yielded, holding back a tail that is a partial match
            of a stop string and trailing replacement characters."""
            nonlocal yielded
            t = tok_.decode(ids)
            cut = earliest_stop_cut(t, stop)
            finished = cut >= 0
            if finished:
                t = t[:cut]
            emit_to = len(t)
            if not finished and not final:
                hold = 0
                for x in stop:
                    for k in range(min(len(x) - 1, len(t)), 0, -1):
                        if t.endswith(x[:k]):
                            hold = max(hold, k)
                            break
                emit_to = len(t) - hold
                while emit_to > yielded and t[emit_to - 1] == "\ufffd":
                    emit_to -= 1
            inc = t[yielded:emit_to]
            yielded = max(yielded, emit_to)
            return inc, finished

        inc, finished = flush(final=False)
        if inc:
            yield inc
        if finished:
            return
        produced = 1
        while produced < mnt and not bool(done[0]):
            k = min(chunk, mnt - produced)
            out, live, cache, done, tok, _ = decode_steps(
                self.cfg, self.params, cache, tok, done, gen, temps, steps=k,
                sampler=sampler_cfg, eos_id=tok_.eos_id, pad_id=tok_.pad_id,
                stop_ids=stop_ids,
            )
            produced += k
            out0, live0 = out[0].tolist(), live[0].tolist()
            self._tokens_generated += sum(live0)
            # A sampled pad id while live stays in the text, as in
            # generate_texts; terminal tokens and post-end padding go.
            ids.extend(t for t, alive in zip(out0, live0) if alive and t not in terminal)
            inc, finished = flush(final=False)
            if inc:
                yield inc
            if finished:
                return
        inc, _ = flush(final=True)
        if inc:
            yield inc

    def score_texts(
        self,
        prompt: str,
        completions: list[str],
        *,
        normalize: bool = False,
        _outer: bool = True,
    ) -> list[float]:
        """Log-probability of each completion given ``prompt``
        (teacher-forced, no sampling): the prompt prefills once, its cache
        is copied to the completions' rows, and every completion's tokens
        score in one chunk forward. ``normalize``: divide by the token
        count. Batches beyond the largest batch bucket score in chunks."""
        if not completions:
            return []
        if _outer:
            self._calls["score"] += 1
        max_b = self.config.batch_buckets[-1]
        if len(completions) > max_b:
            out: list[float] = []
            for i in range(0, len(completions), max_b):
                out.extend(self.score_texts(prompt, completions[i:i + max_b],
                                            normalize=normalize, _outer=False))
            return out
        tok = self.tokenizer
        ctx = self.cfg.max_seq_len
        p_ids = tok.encode(prompt)[-(ctx - 2):]
        p = len(p_ids)
        # The prompt pads to a seq bucket; its true length rides as data.
        sp = max(p, min(_next_bucket(p, self.config.seq_buckets), ctx - 1))
        comp_cap = min(ctx - p, self.config.seq_buckets[-1])
        comp = [tok.encode(c, add_bos=False)[:comp_cap] for c in completions]
        if any(len(c) < 1 for c in comp):
            raise ValueError("cannot score an empty completion")
        longest = max(len(c) for c in comp)
        k = max(min(_next_bucket(longest, self.config.seq_buckets), comp_cap), longest)
        b = _next_bucket(len(comp), self.config.batch_buckets)
        ctoks = np.full((b, k), tok.pad_id, np.int32)
        for i, ids in enumerate(comp):
            ctoks[i, : len(ids)] = ids
        clens = np.ones((b,), np.int32)
        clens[: len(comp)] = [len(c) for c in comp]
        ptoks = np.full((1, sp), tok.pad_id, np.int32)
        ptoks[0, :p] = p_ids
        sums, _ = score_completions(
            self.cfg, self.params, self._h2d(ptoks), self._h2d(np.asarray([p], np.int32)),
            self._h2d(ctoks), self._h2d(clens), cache_len=sp + k,
        )
        out = sums.cpu()[: len(comp)].tolist()
        if normalize:
            out = [s_ / max(len(c), 1) for s_, c in zip(out, comp)]
        return out

    def stats(self) -> dict:
        """Lifetime counters: calls per API, generated tokens, and the
        prefix cache's hits, misses, evictions, entries and bytes."""
        pc = self.prefix_cache
        return {
            "calls": dict(self._calls),
            "tokens_generated": self._tokens_generated,
            "prefix_cache": {
                "hits": pc.stats.hits,
                "misses": pc.stats.misses,
                "evictions": pc.stats.evictions,
                "entries": len(pc),
                "bytes": pc.nbytes,
            },
        }

    def memory_estimate(
        self,
        n_candidates: int = 1,
        prompt_len: int = 128,
        new_tokens: int | None = None,
        hbm_bytes: int | None = None,
        shared_prefix_len: int = 0,
        mesh_shape: dict | None = None,
    ) -> dict:
        """Device-memory estimate for a generate call at these shapes.

        Bytes of the resident params (as stored, quantized leaves
        included), of the KV cache the call would allocate (after the
        engine's bucketing, honouring ``kv_quant``), of the float32
        logits, and their total; ``fits`` when ``hbm_bytes`` is given.
        ``shared_prefix_len``: prompt-prefix tokens stored once for every
        candidate (the paged serving path); 0 models the engine's dense
        per-row cache. ``mesh_shape`` (e.g. ``{"data": 2, "model": 2}``):
        the per-rank terms of the same call sharded over that mesh —
        params per :func:`~llm_consensus_tpu_torch.parallel.partitioning.
        sharded_param_bytes`, KV and logits divided by data x model. The
        JAX package's draft term does not arise: the port's engine has no
        draft model.
        """
        from llm_consensus_tpu_torch.parallel.partitioning import sharded_param_bytes

        c = self.config
        return _memory_plan(
            self.cfg,
            sharded_param_bytes(self.params, mesh_shape or {}),
            seq_buckets=c.seq_buckets,
            batch_buckets=c.batch_buckets,
            n_candidates=n_candidates,
            prompt_len=prompt_len,
            new_tokens=new_tokens or c.max_new_tokens,
            kv_quant=c.kv_quant,
            shared_prefix_len=shared_prefix_len,
            hbm_bytes=hbm_bytes,
            mesh_shape=mesh_shape,
        )

    @staticmethod
    def _trim_stops(results: list[EngineResult], stop: list[str] | None):
        """Cut each text at the earliest stop occurrence (stop removed);
        ``num_tokens``/``logprob`` keep the decode loop's accounting."""
        if not stop:
            return results
        for r in results:
            cut = earliest_stop_cut(r.text, stop)
            if cut >= 0:
                r.text = r.text[:cut]
        return results

    def _collect(self, out: GenerateOutput, n_real: int) -> list[EngineResult]:
        toks = out.tokens.cpu().numpy()
        nums = out.num_tokens.cpu().numpy()
        lps = out.logprob_sum.float().cpu().numpy()
        self._tokens_generated += int(nums[:n_real].sum())
        results = []
        for i in range(n_real):
            n = int(nums[i])
            ids = [int(t) for t in toks[i, :n] if t != self.tokenizer.eos_id]
            results.append(
                EngineResult(
                    text=self.tokenizer.decode(ids),
                    num_tokens=n,
                    logprob=float(lps[i]),
                    token_ids=ids,
                )
            )
        return results


def plan_memory(
    cfg: ModelConfig,
    *,
    quant: str = "none",
    kv_quant: bool = False,
    n_candidates: int = 1,
    prompt_len: int = 128,
    new_tokens: int = 256,
    mesh_shape: dict | None = None,
    hbm_bytes: int | None = None,
    seq_buckets: tuple[int, ...] | None = None,
    batch_buckets: tuple[int, ...] | None = None,
    shared_prefix_len: int = 0,
    host_cache_bytes: int = 0,
    page_size: int = 64,
) -> dict:
    """Config-only device-memory plan: no weights are allocated.

    The companion of :meth:`InferenceEngine.memory_estimate` for models
    too large to build first ("does llama3-8b at N = 64 fit one H100?").
    Param bytes come from ``init_params`` and ``quantize_params`` on the
    ``meta`` device (shapes and types only, leaf for leaf the JAX
    package's ``eval_shape``). The KV and logits terms are
    ``memory_estimate``'s, with the engine's bucketing of
    ``n_candidates`` and ``prompt_len`` (``batch_buckets`` and
    ``seq_buckets`` default to ``EngineConfig``'s).

    ``host_cache_bytes`` > 0 adds the host tier of the serving path: how
    many ``page_size``-token KV pages (this config's KV type, scales
    included) that many bytes of host memory hold, and the prefix tokens
    they buy. Host bytes never count against ``hbm_bytes``.

    ``mesh_shape`` (e.g. ``{"data": 4, "model": 2}``) gives the per-rank
    plan: each param leaf divided by the axes its spec names
    (:func:`~llm_consensus_tpu_torch.parallel.partitioning.
    sharded_param_bytes`), the KV and logits terms by data x model.
    ``pipe``, ``expert`` or ``seq`` above 1 raise (not ported), as do
    int4 weights with ``model`` > 1. MoE configs plan their router and
    expert stacks (the JAX package's bytes).
    """
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.parallel.mesh import MeshConfig
    from llm_consensus_tpu_torch.parallel.partitioning import sharded_param_bytes

    shape = dict(mesh_shape or {})
    MeshConfig(**shape)  # refuses the axes that are not ported
    tree = init_params(cfg, dtype=torch.bfloat16, device="meta")
    if quant in _QUANT_BITS:
        tree = quantize_params(tree, bits=_QUANT_BITS[quant])

    dflt = EngineConfig()
    out = _memory_plan(
        cfg,
        sharded_param_bytes(tree, shape),
        seq_buckets=seq_buckets if seq_buckets is not None else dflt.seq_buckets,
        batch_buckets=batch_buckets if batch_buckets is not None else dflt.batch_buckets,
        n_candidates=n_candidates,
        prompt_len=prompt_len,
        new_tokens=new_tokens,
        kv_quant=kv_quant,
        shared_prefix_len=shared_prefix_len,
        hbm_bytes=hbm_bytes,
        mesh_shape=shape,
    )
    if host_cache_bytes > 0:
        page_bytes = _kv_cache_bytes(cfg, 1, page_size, kv_quant)
        host_pages = host_cache_bytes // max(1, page_bytes)
        out["host_cache_bytes"] = host_cache_bytes
        out["host_page_bytes"] = page_bytes
        out["host_capacity_pages"] = host_pages
        out["host_capacity_tokens"] = host_pages * page_size
    return out
