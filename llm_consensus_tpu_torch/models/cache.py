"""KV cache: fixed-shape buffers so every decode step has the same shapes.

Counterpart of ``llm_consensus_tpu.models.cache.KVCache`` (the int8
``QuantKVCache`` waits for the port's quantized slice). The layout is the
JAX package's, ``[n_layers, B, max_len, n_kv_heads, head_dim]``; unlike
the functional JAX version, the model writes new K/V into these buffers
in place, so one cache serves a whole generate call without copies.
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
    def max_len(self) -> int:
        return self.k.shape[2]

    def advanced(self, n: int | torch.Tensor = 1) -> "KVCache":
        """Return a cache (same buffers) with fill length advanced by n."""
        return KVCache(k=self.k, v=self.v, length=self.length + n)

    def with_length(self, length: torch.Tensor) -> "KVCache":
        return KVCache(k=self.k, v=self.v, length=length)
