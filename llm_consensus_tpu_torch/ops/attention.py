"""Attention: causal prefill and single-step decode against a KV cache.

The plain PyTorch versions of ``llm_consensus_tpu.ops.attention``'s
``causal_attention``, ``decode_attention``,
``decode_attention_shared_prefix`` and their int8-cache forms
``decode_attention_quant`` and ``decode_attention_shared_prefix_quant``;
the hand-written kernels that replace them on the hot path are in
:mod:`llm_consensus_tpu_torch.ops.kernels.attention`.

Conventions (the JAX package's):
- q/k/v are [B, S, H, D] / [B, S, Hkv, D]; GQA groups are expanded by
  reshaping q to [B, S, Hkv, G, D] (no materialized repeat of K/V).
- Scores, softmax and the probability-weighted sum run in float32;
  outputs are cast back to the input dtype.
- Masked scores are set to -1e30, as in the JAX package.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scores [B, Hkv, G, Sq, Sk] in float32, where H = Hkv * G."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, d)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    b, hkv, g, sq, sk = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, hkv * g, -1).to(dtype)


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Causal self-attention over a full (prefill) sequence.

    q: [B, S, H, D]; k/v: [B, S, Hkv, D] with H a multiple of Hkv (GQA).
    positions: optional [B, S] integer positions; when given, key j attends
    to query i iff pos_j <= pos_i. Default is index-causal. ``window`` > 0
    adds sliding-window masking: query i also ignores keys with
    pos_i - pos_j >= window.
    """
    scale = q.shape[-1] ** -0.5
    scores = _gqa_scores(q, k) * scale  # [B, Hkv, G, Sq, Sk]
    sq, sk = scores.shape[-2], scores.shape[-1]
    if positions is None:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        mask = kj <= qi
        if window > 0:
            mask &= (qi - kj) < window
        mask = mask[None, None, None]
    else:
        qi = positions[:, :, None]
        kj = positions[:, None, :]
        mask = kj <= qi
        if window > 0:
            mask &= (qi - kj) < window
        mask = mask[:, None, None]  # [B, 1, 1, Sq, Sk]
    scores = torch.where(mask, scores, _NEG_INF)
    return _gqa_out(_softmax(scores), v, q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """One-token decode attention against a fixed-size KV cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, max_len, Hkv, D];
    valid_len: [B] number of valid cache slots per sequence (the new token's
    k/v must already be written; slots >= valid_len are masked out).
    ``window`` > 0: only the last ``window`` cache slots attend.
    """
    scale = q.shape[-1] ** -0.5
    scores = _gqa_scores(q, k_cache) * scale  # [B, Hkv, G, 1, max_len]
    slot = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    mask = slot < valid_len[:, None]
    if window > 0:
        mask &= slot >= (valid_len[:, None] - window)
    mask = mask[:, None, None, None]  # [B, 1, 1, 1, max_len]
    scores = torch.where(mask, scores, _NEG_INF)
    return _gqa_out(_softmax(scores), v_cache, q.dtype)


def merge_decode_partials(m1, l1, o1, m2, l2, o2) -> torch.Tensor:
    """Exact log-sum-exp merge of two partial softmax-attention results.

    Each partial is an (m, l, o) triple over a disjoint slot range: the
    max score, the softmax denominator at that max, and the normalized
    output. ``m = max(m1, m2); a_i = l_i * exp(m_i - m)``; the result is
    ``(a1 * o1 + a2 * o2) / (a1 + a2)``. An empty partial (l = 0) gets
    weight zero.
    """
    m = torch.maximum(m1, m2)
    m_safe = torch.where(m <= _NEG_INF / 2, 0.0, m)
    a1 = torch.where(l1 > 0, l1 * torch.exp(m1 - m_safe), 0.0)
    a2 = torch.where(l2 > 0, l2 * torch.exp(m2 - m_safe), 0.0)
    return (a1 * o1 + a2 * o2) / torch.clamp(a1 + a2, min=1e-30)


def _partial_softmax(scores: torch.Tensor, v: torch.Tensor, mask: torch.Tensor):
    """(m, l, o) over one masked slot range. scores: [B, Hkv, G, 1, S]
    float32; v: [B, S, Hkv, D]. Returns m/l [B, Hkv, G, 1, 1] and o
    [B, Hkv, G, 1, D] (zeros where the range is empty)."""
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return m, l, acc / torch.clamp(l, min=1e-30)


def decode_attention_shared_prefix(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    prefix_len: int,
) -> torch.Tensor:
    """Two-phase decode attention over a batch sharing one prompt prefix.

    Every row's cache slots [0, prefix_len) hold identical K/V (the
    self-consistency fan-out after a shared prefill). Phase 1 attends all
    rows' queries to row 0's copy of the prefix; phase 2 attends each row
    to its own slots [prefix_len, valid_len). The two partials merge
    exactly (:func:`merge_decode_partials`), so the output equals
    :func:`decode_attention` wherever the precondition holds.

    q: [B, 1, H, D]; k_cache/v_cache: [B, max_len, Hkv, D]; valid_len:
    [B]; prefix_len: the shared prompt length (0 gives the plain path).
    """
    scale = q.shape[-1] ** -0.5
    b, _, h, _ = q.shape
    slot = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    # Phase 1: all rows' queries against row 0's prefix.
    scores1 = _gqa_scores(q, k_cache[:1].expand_as(k_cache)) * scale
    mask1 = (slot < prefix_len)[:, None, None, None]
    m1, l1, o1 = _partial_softmax(scores1, v_cache[:1].expand_as(v_cache), mask1)
    # Phase 2: each row against its own suffix.
    scores2 = _gqa_scores(q, k_cache) * scale
    mask2 = ((slot >= prefix_len) & (slot < valid_len[:, None]))[:, None, None, None]
    m2, l2, o2 = _partial_softmax(scores2, v_cache, mask2)
    out = merge_decode_partials(m1, l1, o1, m2, l2, o2)  # [B, Hkv, G, 1, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, -1).to(q.dtype)


def _dequantize_kv(k_q, k_scale, dtype):
    """int8 head-major [B, Hkv, S, D] with scales [B, Hkv, S] ->
    token-major [B, S, Hkv, D] in ``dtype``."""
    return (k_q.float() * k_scale[..., None]).to(dtype).transpose(1, 2)


def decode_attention_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention over an int8 cache (the plain path).

    q: [B, 1, H, D]; k_q/v_q: [B, Hkv, S, D] int8 (head-major,
    ``QuantKVCache`` layout); k_scale/v_scale: [B, Hkv, S] float32.
    Dequantizes into q's type and defers to :func:`decode_attention`.
    """
    return decode_attention(
        q,
        _dequantize_kv(k_q, k_scale, q.dtype),
        _dequantize_kv(v_q, v_scale, q.dtype),
        valid_len,
        window=window,
    )


def decode_attention_shared_prefix_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len: torch.Tensor,
    prefix_len: int,
) -> torch.Tensor:
    """Shared-prefix decode attention over the int8 head-major cache (the
    plain path: dequantize, defer). Layouts as
    :func:`decode_attention_quant`."""
    return decode_attention_shared_prefix(
        q,
        _dequantize_kv(k_q, k_scale, q.dtype),
        _dequantize_kv(v_q, v_scale, q.dtype),
        valid_len,
        prefix_len,
    )
