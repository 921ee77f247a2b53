"""Batched generation: one prefill into a fixed-shape KV cache, then the
decode loop.

Counterpart of ``llm_consensus_tpu.engine.generate``'s ``generate``,
``_prefill_into_cache`` and ``_decode_loop``, with the same outputs:

- prompts are right-padded into a [B, S] batch;
- ``prefill`` fills the KV cache and yields last-token logits;
- the decode loop runs ``max_new_tokens - 1`` steps; rows that hit EOS
  or a single-token stop keep stepping but emit pad and stop
  accumulating logprobs (a ``done`` mask, as in the JAX scan).

Where the JAX package compiles the loop as one ``lax.scan``, this is a
Python loop of eager steps. It ends early once every row is done, which
changes no output: the remaining slots are pad either way.

Under ``shared_prefill`` the decode loop reads the common prompt's K/V
once per step for the whole fan-out (``shared_prefix_attention``, on by
default as in the JAX package); off, each row reads its whole cache.
Both give the same outputs.

``kv_quant`` keeps the cache in int8 (``QuantKVCache``, a float32 scale
per token and kv head), as the JAX package's ``kv_quant``;
``prefill_chunk`` prefills prompts longer than it in chunks
(``prefill_chunked``).

Besides :func:`generate`: :func:`generate_from_prefix` (continue from a
prefilled shared prefix, the prefix cache's path), :func:`decode_steps`
(a fixed number of decode steps from a held cache: streaming and the
multi-token-stop path) and :func:`score_completions` (teacher-forced
log-probabilities of completions).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from llm_consensus_tpu_torch.engine.sampler import SamplerConfig, sample_token
from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache, quantize_kv
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.models.transformer import (
    _chunk_hidden,
    _unembed,
    decode_chunk,
    decode_step,
    prefill,
    prefill_chunked,
)

# Decode steps between host checks of "every row is done" (each check
# waits for the card).
_DONE_CHECK_EVERY = 16


@dataclass
class GenerateOutput:
    tokens: torch.Tensor  # [B, max_new_tokens] int32, pad-filled after EOS
    num_tokens: torch.Tensor  # [B] int32 generated tokens incl. EOS
    logprob_sum: torch.Tensor  # [B] float32 sum of sampled-token logprobs


@torch.inference_mode()
def generate(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    *,
    max_new_tokens: int,
    sampler: SamplerConfig = SamplerConfig(),
    eos_id: int = 2,
    pad_id: int = 0,
    cache_len: int | None = None,
    shared_prefill: bool = False,
    stop_ids: tuple[int, ...] = (),
    shared_prefix_attention: bool = True,
    kv_quant: bool = False,
    prefill_chunk: int = 0,
) -> GenerateOutput:
    """Generate up to ``max_new_tokens`` for a batch of right-padded prompts.

    tokens: [B, S] right-padded prompts; lengths: [B] true lengths;
    generator: a ``torch.Generator`` on the tokens' device (drawn from
    once per decode step); temperature: [B] per-row (0 = greedy).
    ``shared_prefill``: every row holds the same prompt, so the prompt is
    prefilled once at B=1 and its cache copied to all B rows.
    ``shared_prefix_attention``: under ``shared_prefill``, decode reads
    the prompt's slots [0, lengths[0]) once per step for all rows.
    ``kv_quant``: the KV cache is int8 (``QuantKVCache``).
    ``prefill_chunk`` > 0: a prompt longer than it prefills in chunks.
    """
    b, s = tokens.shape
    if cache_len is None:
        cache_len = s + max_new_tokens
    if cache_len < s + max_new_tokens:
        raise ValueError(
            f"cache_len {cache_len} < prompt {s} + max_new_tokens {max_new_tokens}"
        )
    logits, cache = prefill_into_cache(
        cfg, params, tokens, lengths,
        cache_len=cache_len,
        shared_prefill=shared_prefill,
        kv_quant=kv_quant,
        prefill_chunk=prefill_chunk,
    )
    return _decode_loop(
        cfg,
        params,
        logits,
        cache,
        generator,
        temperature,
        sampler=sampler,
        eos_id=eos_id,
        pad_id=pad_id,
        max_new_tokens=max_new_tokens,
        uniform_write=shared_prefill,
        stop_ids=stop_ids,
        shared_prefix_len=(
            int(lengths[0]) if shared_prefill and shared_prefix_attention else None
        ),
    )


def prefill_into_cache(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cache_len: int,
    shared_prefill: bool = False,
    kv_quant: bool = False,
    prefill_chunk: int = 0,
):
    """Allocate the cache, fill it, return (first-token logits [B, V],
    cache at B rows). Shared with the engine's chunked-decode path
    (multi-token stops need prefill and decode as separate calls)."""
    b = tokens.shape[0]
    dtype = params["embed"].dtype

    def make_cache(batch: int):
        if kv_quant:
            return QuantKVCache.create(cfg, batch, cache_len, tokens.device)
        return KVCache.create(cfg, batch, cache_len, dtype, tokens.device)

    def fill(p_tokens, p_lengths, p_cache):
        # Chunked prefill (bounded activation memory) when the prompt
        # exceeds the chunk; it writes the one-shot prefill's cache.
        if 0 < prefill_chunk < p_tokens.shape[1]:
            return prefill_chunked(cfg, params, p_tokens, p_lengths, p_cache,
                                   chunk=prefill_chunk)
        return prefill(cfg, params, p_tokens, p_lengths, p_cache)

    if shared_prefill:
        # Self-consistency fan-out: all B rows decode from the SAME
        # prompt, so prefill once at B=1 and copy the cache to B rows
        # (the rows then diverge, so each needs its own buffer).
        cache1 = make_cache(1)
        logits1, cache1 = fill(tokens[:1], lengths[:1], cache1)
        logits = logits1.expand(b, -1)
        cache = broadcast_cache(cache1, b)
    else:
        cache = make_cache(b)
        logits, cache = fill(tokens, lengths, cache)
    return logits, cache


def broadcast_cache(cache1, b: int):
    """Copy a B=1 cache's buffers (and length) to B rows."""
    return type(cache1)(
        *(t.repeat(1, b, *([1] * (t.ndim - 2))) for t in cache1.leaves),
        length=cache1.length.expand(b).contiguous(),
    )


def _is_terminal(tok: torch.Tensor, eos_id: int, stop_ids: tuple[int, ...]):
    hit = tok == eos_id
    for t in stop_ids:
        hit = hit | (tok == t)
    return hit


def _decode_loop(
    cfg: ModelConfig,
    params: dict,
    logits: torch.Tensor,
    cache: KVCache,
    generator: torch.Generator,
    temperature: torch.Tensor,
    *,
    sampler: SamplerConfig,
    eos_id: int,
    pad_id: int,
    max_new_tokens: int,
    uniform_write: bool,
    stop_ids: tuple[int, ...] = (),
    shared_prefix_len: int | None = None,
) -> GenerateOutput:
    """The decode loop, from first-token logits onward.

    ``stop_ids``: extra single-token terminators — a row that samples any
    of them finishes exactly as if it sampled EOS (the stop token is
    still emitted and counted, like EOS). ``shared_prefix_len``: the
    length of the cache prefix identical across rows, passed to every
    decode step.
    """
    b = logits.shape[0]
    tok, lp_sum = sample_token(logits, generator, temperature, sampler)
    done = _is_terminal(tok, eos_id, stop_ids)
    # Slot i of the output holds the (i+1)-th generated token; done_before
    # marks slots emitted after the row had already finished.
    toks = [tok]
    done_before = [torch.zeros_like(done)]
    for i in range(max_new_tokens - 1):
        if i % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        logits, cache = decode_step(
            cfg, params, tok[:, None], cache, uniform_write=uniform_write,
            shared_prefix_len=shared_prefix_len,
        )
        next_tok, lp = sample_token(logits, generator, temperature, sampler)
        next_tok = torch.where(done, pad_id, next_tok)
        lp_sum = lp_sum + torch.where(done, 0.0, lp)
        toks.append(next_tok)
        done_before.append(done)
        done = done | _is_terminal(next_tok, eos_id, stop_ids)
        tok = next_tok

    all_toks = torch.stack(toks, dim=1)
    all_done_before = torch.stack(done_before, dim=1)
    pad = max_new_tokens - all_toks.shape[1]
    if pad:  # every row finished early: the rest is pad, done before
        all_toks = torch.cat(
            [all_toks, torch.full((b, pad), pad_id, dtype=all_toks.dtype,
                                  device=all_toks.device)], dim=1)
        all_done_before = torch.cat(
            [all_done_before, torch.ones((b, pad), dtype=torch.bool,
                                         device=all_toks.device)], dim=1)
    num = (~all_done_before).sum(dim=1).to(torch.int32)
    all_toks = torch.where(all_done_before, pad_id, all_toks)
    return GenerateOutput(tokens=all_toks, num_tokens=num, logprob_sum=lp_sum)


@torch.inference_mode()
def generate_from_prefix(
    cfg: ModelConfig,
    params: dict,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prefix_len: int,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    *,
    max_new_tokens: int,
    sampler: SamplerConfig = SamplerConfig(),
    eos_id: int = 2,
    pad_id: int = 0,
    cache_len: int | None = None,
    stop_ids: tuple[int, ...] = (),
    shared_suffix: bool = False,
    kv_quant: bool = False,
    moe_suffix_dense: bool | None = None,
    shared_prefix_attention: bool = True,
) -> GenerateOutput:
    """Generate continuing from a prefilled shared prompt prefix.

    A prefix shared by many calls (a few-shot header, a debate's
    transcript) is prefilled once at B=1; its K/V (``prefix_k``/``prefix_v``
    [L, 1, Pb, Hkv, D], a :class:`KVCache`'s buffers) is copied into every
    later batch instead of being recomputed. The per-row suffixes
    ([B, S] right-padded ``tokens``, true ``lengths``) run as one chunk
    forward at position ``prefix_len``, then the decode loop runs. ``Pb``
    may exceed ``prefix_len`` (a bucket); the pad slots are never
    attended. ``shared_suffix``: every row has the same suffix (the
    fan-out under a cached header): the chunk runs at B=1 and the decode
    reads the whole prefilled region once a step through the shared-prefix
    path. ``kv_quant``: continue into an int8 cache, the stored prefix
    quantized on entry with the prefill's own rule. ``moe_suffix_dense``:
    the MoE dispatch path of the suffix chunk (see
    :func:`prefill_from_prefix`). Outputs equal :func:`generate`'s on the
    concatenated prompts (the JAX package's contract).
    """
    b, s = tokens.shape
    p = prefix_k.shape[2]
    if cache_len is None:
        cache_len = p + s + max_new_tokens
    if cache_len < p + s + max_new_tokens:
        raise ValueError(
            f"cache_len {cache_len} < prefix bucket {p} + suffix {s} "
            f"+ max_new_tokens {max_new_tokens}"
        )
    logits, cache = prefill_from_prefix(
        cfg, params, prefix_k, prefix_v, prefix_len, tokens, lengths,
        cache_len=cache_len, shared_suffix=shared_suffix, kv_quant=kv_quant,
        moe_suffix_dense=moe_suffix_dense,
    )
    return _decode_loop(
        cfg,
        params,
        logits,
        cache,
        generator,
        temperature,
        sampler=sampler,
        eos_id=eos_id,
        pad_id=pad_id,
        max_new_tokens=max_new_tokens,
        uniform_write=shared_suffix,
        stop_ids=stop_ids,
        shared_prefix_len=(
            int(prefix_len) + int(lengths[0])
            if shared_suffix and shared_prefix_attention else None
        ),
    )


@torch.inference_mode()
def prefill_from_prefix(
    cfg: ModelConfig,
    params: dict,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prefix_len: int,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cache_len: int,
    shared_suffix: bool = False,
    kv_quant: bool = False,
    moe_suffix_dense: bool | None = None,
):
    """The prefill half of :func:`generate_from_prefix` (copy the prefix
    into a fresh cache, run the suffix chunk): (first-token logits
    [B, V], cache at B rows). Shared with the engine's multi-token-stop
    path.

    ``moe_suffix_dense``: the suffix chunk's MoE path, dense (True) or
    capacity (False), resolved by the caller from the token count a plain
    one-shot prefill of the concatenated prompt takes, so the split into
    prefix and suffix does not flip the chunk across
    ``moe_dense_decode_tokens``; None decides from the bucket width (the
    JAX package's ``_prefix_prefill_impl``).
    """
    b, s = tokens.shape
    cb = 1 if shared_suffix else b
    total = cb * (prefix_k.shape[2] + s)
    if moe_suffix_dense is None:
        cfg = cfg.moe_pin_for(total, total)
    elif moe_suffix_dense:
        cfg = cfg.with_moe_dense_up_to(total)
    else:
        cfg = cfg.with_moe_capacity_pinned()
    pb = prefix_k.shape[2]
    dev = tokens.device
    plen = torch.full((cb,), int(prefix_len), dtype=torch.int32, device=dev)
    if kv_quant:
        cache = QuantKVCache.create(cfg, cb, cache_len, dev)
        kq, ks = quantize_kv(prefix_k)  # [L, 1, Pb, Hkv, D] / [L, 1, Pb, Hkv]
        vq, vs = quantize_kv(prefix_v)
        # Sequence-major -> the int8 cache's head-major layout.
        cache.k_q[:, :, :, :pb] = kq.transpose(2, 3)
        cache.v_q[:, :, :, :pb] = vq.transpose(2, 3)
        cache.k_scale[:, :, :, :pb] = ks.transpose(2, 3)
        cache.v_scale[:, :, :, :pb] = vs.transpose(2, 3)
    else:
        cache = KVCache.create(cfg, cb, cache_len, prefix_k.dtype, dev)
        cache.k[:, :, :pb] = prefix_k
        cache.v[:, :, :pb] = prefix_v
    cache = cache.with_length(plen)
    hidden, cache = _chunk_hidden(cfg, params, tokens[:cb], cache)
    last = torch.clamp(lengths[:cb].long() - 1, 0, s - 1)
    logits = _unembed(cfg, params, hidden[torch.arange(cb, device=dev), last])
    if shared_suffix:
        return (logits.expand(b, -1),
                broadcast_cache(cache, b).with_length(plen[:1] + lengths.to(torch.int32)))
    return logits, cache.with_length(plen + lengths.to(torch.int32))


@torch.inference_mode()
def decode_steps(
    cfg: ModelConfig,
    params: dict,
    cache,
    tok: torch.Tensor,
    done: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    *,
    steps: int,
    sampler: SamplerConfig = SamplerConfig(),
    eos_id: int = 2,
    pad_id: int = 0,
    stop_ids: tuple[int, ...] = (),
):
    """Run ``steps`` decode iterations from a held cache (streaming).

    ``tok`` [B]: the last sampled token, not yet in the cache (this call's
    first input); ``done`` [B]: rows already finished. The cache is
    written in place. Returns (tokens [B, steps], pad after a row ends;
    live [B, steps], True where the row was still generating when the
    slot was emitted; the cache; done; the last token; logprobs
    [B, steps], each step's sampled-token logprob, 0 where the row was
    done) — the JAX package's tuple.
    """
    toks, lives, lps = [], [], []
    for _ in range(steps):
        logits, cache = decode_step(cfg, params, tok[:, None], cache)
        nxt, lp = sample_token(logits, generator, temperature, sampler)
        nxt = torch.where(done, pad_id, nxt)
        lps.append(torch.where(done, 0.0, lp))
        lives.append(~done)
        toks.append(nxt)
        done = done | _is_terminal(nxt, eos_id, stop_ids)
        tok = nxt
    return (torch.stack(toks, dim=1), torch.stack(lives, dim=1), cache, done, tok,
            torch.stack(lps, dim=1))


@torch.inference_mode()
def score_completions(
    cfg: ModelConfig,
    params: dict,
    prompt_tokens: torch.Tensor,
    prompt_len: torch.Tensor,
    comp_tokens: torch.Tensor,
    comp_lens: torch.Tensor,
    *,
    cache_len: int,
):
    """Teacher-forced log-probability of completions under the model.

    prompt_tokens: [1, S] right-padded shared prompt; prompt_len: [1];
    comp_tokens: [B, K] right-padded completions; comp_lens: [B]. The
    prompt prefills once at B=1, its cache is copied to the B rows, and
    all K completion positions score in one chunk forward. The cache is
    bf16 whatever the weights' type, as the JAX package's (no decode
    kernel reads it). Returns (logprob_sum [B], per-token logprobs
    [B, K], 0 past each completion's length).
    """
    b, k = comp_tokens.shape
    cache1 = KVCache.create(cfg, 1, cache_len, torch.bfloat16, prompt_tokens.device)
    logits1, cache1 = prefill(cfg, params, prompt_tokens, prompt_len, cache1)
    chunk_logits, _ = decode_chunk(cfg, params, comp_tokens, broadcast_cache(cache1, b))
    # Position i of the chunk predicts token i + 1; the prompt's last
    # logits predict token 0.
    all_logits = torch.cat(
        [logits1.expand(b, -1)[:, None], chunk_logits[:, :-1].float()], dim=1
    )
    lps = torch.log_softmax(all_logits, dim=-1)
    tok_lp = lps.gather(-1, comp_tokens[..., None].long())[..., 0]
    mask = torch.arange(k, device=comp_tokens.device)[None, :] < comp_lens[:, None]
    tok_lp = torch.where(mask, tok_lp, 0.0)
    return tok_lp.sum(dim=1), tok_lp
