"""Rotary position embeddings (RoPE), rotate-half convention.

Counterpart of ``llm_consensus_tpu.ops.rope``. Frequencies are computed
from integer positions, so decode steps with per-sequence offsets need no
precomputed table.
"""

from __future__ import annotations

import math

import torch


def _llama3_rescale(inv_freq: torch.Tensor, scaling) -> torch.Tensor:
    """Llama-3.1 'llama3' rope_scaling: long wavelengths divide by
    ``factor``, short ones stay, a smooth ramp interpolates between
    (matches transformers' _compute_llama3_parameters)."""
    orig = scaling.original_max_position_embeddings
    low_wavelen = orig / scaling.low_freq_factor
    high_wavelen = orig / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / scaling.factor
    smooth = (orig / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    mid = (1 - smooth) * scaled + smooth * inv_freq
    out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
    return torch.where(
        (wavelen <= low_wavelen) & (wavelen >= high_wavelen), mid, out
    )


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    scaling=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions.

    positions: [...] integer tensor (any shape, e.g. [B, S]).
    Returns float32 cos, sin of shape [..., head_dim] (half-frequencies
    duplicated, matching the rotate-half convention). ``scaling``:
    optional :class:`llm_consensus_tpu_torch.models.configs.RopeScaling`.
    """
    half = head_dim // 2
    freq_exponents = (
        torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    inv_freq = 1.0 / (theta**freq_exponents)  # [half]
    if scaling is not None:
        inv_freq = _llama3_rescale(inv_freq, scaling)
    angles = positions[..., None].float() * inv_freq  # [..., half]
    angles = torch.cat([angles, angles], dim=-1)  # [..., head_dim]
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding to q or k.

    x: [B, S, H, D]; cos/sin: [B, S, D] (broadcast over the head axis).
    Rotation runs in float32 and is cast back to x.dtype.
    """
    xf = x.float()
    c = cos[..., None, :]  # [B, S, 1, D]
    s = sin[..., None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
