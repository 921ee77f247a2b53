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
per token and kv head), as the JAX package's ``kv_quant``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from llm_consensus_tpu_torch.engine.sampler import SamplerConfig, sample_token
from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.models.transformer import decode_step, prefill

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
    """
    b, s = tokens.shape
    if cache_len is None:
        cache_len = s + max_new_tokens
    if cache_len < s + max_new_tokens:
        raise ValueError(
            f"cache_len {cache_len} < prompt {s} + max_new_tokens {max_new_tokens}"
        )
    logits, cache = _prefill_into_cache(
        cfg, params, tokens, lengths,
        cache_len=cache_len,
        shared_prefill=shared_prefill,
        kv_quant=kv_quant,
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


def _prefill_into_cache(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cache_len: int,
    shared_prefill: bool = False,
    kv_quant: bool = False,
):
    """Allocate the cache, fill it, return (first-token logits [B, V],
    cache at B rows)."""
    b = tokens.shape[0]
    dtype = params["embed"].dtype

    def make_cache(batch: int):
        if kv_quant:
            return QuantKVCache.create(cfg, batch, cache_len, tokens.device)
        return KVCache.create(cfg, batch, cache_len, dtype, tokens.device)

    if shared_prefill:
        # Self-consistency fan-out: all B rows decode from the SAME
        # prompt, so prefill once at B=1 and copy the cache to B rows
        # (the rows then diverge, so each needs its own buffer).
        cache1 = make_cache(1)
        logits1, cache1 = prefill(cfg, params, tokens[:1], lengths[:1], cache1)
        logits = logits1.expand(b, -1)
        cache = _broadcast_cache(cache1, b)
    else:
        cache = make_cache(b)
        logits, cache = prefill(cfg, params, tokens, lengths, cache)
    return logits, cache


def _broadcast_cache(cache1, b: int):
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
