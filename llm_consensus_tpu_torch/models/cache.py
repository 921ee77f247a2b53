"""KV cache: fixed-shape buffers so every decode step has the same shapes.

Counterpart of ``llm_consensus_tpu.models.cache``: ``KVCache`` (the
cache in the weights' type) and ``QuantKVCache`` (int8 with a float32
scale per token and kv head), in the JAX package's layouts. Unlike the
functional JAX version, the model writes new K/V into these buffers in
place, so one cache serves a whole generate call without copies.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from llm_consensus_tpu_torch.models.configs import ModelConfig


@dataclass
class KVCache:
    # [n_layers, B, max_len, n_kv_heads, head_dim]
    k: torch.Tensor
    v: torch.Tensor
    # [B] int32 number of filled slots per sequence.
    length: torch.Tensor

    @staticmethod
    def create(
        cfg: ModelConfig,
        batch: int,
        max_len: int,
        dtype=torch.bfloat16,
        device: str | torch.device = "cpu",
    ) -> "KVCache":
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        """The buffers, in the order the model passes them."""
        return (self.k, self.v)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def advanced(self, n: int | torch.Tensor = 1) -> "KVCache":
        """Return a cache (same buffers) with fill length advanced by n."""
        return KVCache(k=self.k, v=self.v, length=self.length + n)

    def with_length(self, length: torch.Tensor) -> "KVCache":
        return KVCache(k=self.k, v=self.v, length=length)


@dataclass
class QuantKVCache:
    """int8 KV cache: a symmetric scale per (token, kv head).

    Decode re-reads the whole cache every step, so at large candidate
    counts the cache rivals the weights for bytes read; int8 halves it.
    The layout is head-major, ``[L, B, Hkv, S, D]`` (the bf16 cache is
    ``[L, B, S, Hkv, D]``): each (row, kv head)'s slots are one contiguous
    ``[S, D]`` slab, which the int8 decode kernels read.
    """

    # [n_layers, B, n_kv_heads, max_len, head_dim] int8
    k_q: torch.Tensor
    v_q: torch.Tensor
    # [n_layers, B, n_kv_heads, max_len] float32
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: torch.Tensor  # [B] int32

    @staticmethod
    def create(
        cfg: ModelConfig,
        batch: int,
        max_len: int,
        device: str | torch.device = "cpu",
    ) -> "QuantKVCache":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        sshape = shape[:-1]
        return QuantKVCache(
            k_q=torch.zeros(shape, dtype=torch.int8, device=device),
            v_q=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def leaves(self) -> tuple[torch.Tensor, ...]:
        """The four buffers, in the order the model passes them."""
        return (self.k_q, self.v_q, self.k_scale, self.v_scale)

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]

    def advanced(self, n: int | torch.Tensor = 1) -> "QuantKVCache":
        """Return a cache (same buffers) with fill length advanced by n."""
        return self.with_length(self.length + n)

    def with_length(self, length: torch.Tensor) -> "QuantKVCache":
        return QuantKVCache(*self.leaves, length=length)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], float32 scale [...]), amax-symmetric
    over D."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale
