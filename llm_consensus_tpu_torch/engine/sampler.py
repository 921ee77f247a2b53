"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of ``llm_consensus_tpu.engine.sampler``. Per-row temperature
is data ([B] tensor; 0 selects greedy for that row); top-k/top-p are the
call's static :class:`SamplerConfig` in :func:`sample_token`, and per-row
data in :func:`sample_token_per_request` (the continuous batcher's
sampler). Random draws come from an explicit ``torch.Generator``
(Gumbel-max over the filtered logits), so a seed reproduces a run on the
same device; the numbers differ from JAX's threefry stream for the same
seed, so sampled rows are compared by distribution, greedy rows exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_NEG_INF = -1e30


@dataclass(frozen=True)
class SamplerConfig:
    """Per-call sampler configuration."""

    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled


def filter_scaled_logits(
    scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor
) -> torch.Tensor:
    """Per-row top-k + nucleus masking of temperature-scaled logits.

    scaled: [B, V]; top_k [B] int (0 = off); top_p [B] float (1.0 = off).
    ONE descending sort serves both filters. The nucleus is taken over
    the top-k-masked distribution and keeps every token tied at the kth
    logit, exactly as the JAX package's version.
    """
    k = top_k.to(device=scaled.device, dtype=torch.int64)
    p = top_p.to(device=scaled.device, dtype=torch.float32)
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(k > 0, torch.clamp(k, 1, v), torch.full_like(k, v))
    kth = torch.gather(sorted_desc, -1, (k_eff - 1)[:, None])
    filtered = torch.where(scaled < kth, _NEG_INF, scaled)
    in_k = sorted_desc >= kth
    sorted_k = torch.where(in_k, sorted_desc, _NEG_INF)
    sorted_probs = torch.softmax(sorted_k, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = ((cum - sorted_probs) < p[:, None]) & in_k
    min_kept = torch.where(keep_sorted, sorted_k, torch.inf).amin(
        dim=-1, keepdim=True
    )
    nucleus = torch.where(filtered < min_kept, _NEG_INF, filtered)
    return torch.where(p[:, None] >= 1.0, filtered, nucleus)


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    config: SamplerConfig = SamplerConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one token per row.

    logits: [B, V] float32; generator: on logits' device; temperature: [B]
    (0 => greedy for that row).

    Returns (tokens [B] int32, logprobs [B] float32), where logprobs are
    the log-probability of the chosen token under the *pre-filtering*
    temperature-scaled distribution.
    """
    b, v = logits.shape
    temperature = temperature.to(device=logits.device, dtype=torch.float32)
    greedy_tok = torch.argmax(logits, dim=-1)

    safe_t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    scaled = logits / safe_t
    filtered = scaled
    if config.top_k > 0 or config.top_p < 1.0:
        filtered = filter_scaled_logits(
            scaled,
            torch.full((b,), config.top_k, device=logits.device),
            torch.full((b,), config.top_p, device=logits.device),
        )
    u = torch.rand(
        (b, v), generator=generator, device=logits.device, dtype=torch.float32
    )
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled_tok = torch.argmax(filtered + gumbel, dim=-1)

    tok = torch.where(temperature > 0, sampled_tok, greedy_tok)
    logprob = torch.log_softmax(scaled, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok.to(torch.int32), logprob


def request_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of one request's ``index``-th sampled token: seeded
    from (seed, index) alone, so the draw never depends on the request's
    batch neighbours — the JAX batcher's ``fold_in(PRNGKey(seed), index)``
    stream, in spirit (not in its numbers)."""
    # splitmix64 of (seed, index): the CPU generator keeps only the low 32
    # bits of its seed, so both halves must reach them.
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(index) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    g = torch.Generator(device=device)
    g.manual_seed(z ^ (z >> 31))
    return g


_MASK64 = (1 << 64) - 1


def sample_token_per_request(
    logits: torch.Tensor,
    keys,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    *,
    filters_active: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_token` with a generator per row AND per-row top_k /
    top_p as data — the continuous batcher's sampler, where every row
    belongs to another request.

    logits: [B, V] float32; keys: B entries, a :func:`request_generator`
    for each row that samples (temperature > 0) and None for greedy rows;
    temperature / top_k / top_p: [B] tensors on logits' device.
    ``filters_active`` False skips the filters' full-vocab sort (the
    caller knows every row has top_k 0 and top_p 1.0). Greedy rows take
    the argmax, exactly as in the JAX package. Returns (tokens [B] int32,
    logprobs [B] float32 under the pre-filtering temperature-scaled
    distribution).
    """
    b, v = logits.shape
    greedy_tok = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    scaled = logits / safe_t
    tok = greedy_tok
    rows = [i for i, g in enumerate(keys) if g is not None]
    if rows:
        filtered = filter_scaled_logits(scaled, top_k, top_p) if filters_active else scaled
        u = torch.full((b, v), 0.5, device=logits.device)
        for i in rows:
            u[i].uniform_(generator=keys[i])
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        sampled = torch.argmax(filtered + gumbel, dim=-1)
        tok = torch.where(temperature > 0, sampled, greedy_tok)
    logprob = torch.log_softmax(scaled, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok.to(torch.int32), logprob
