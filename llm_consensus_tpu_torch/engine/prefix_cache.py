"""LRU of prefilled prompt prefixes (radix-style KV reuse).

Counterpart of ``llm_consensus_tpu.engine.prefix_cache``. The protocol
re-sends the same prompt material constantly (a few-shot header, a
debate's question and transcript); the engine prefills such a prefix
once at B=1, keeps its per-layer K/V on the device, and
:func:`llm_consensus_tpu_torch.engine.generate.generate_from_prefix`
copies it into every later batch.

This module is the bookkeeping only: an LRU keyed by the exact token-id
tuple of the prefix, holding B=1 ``(k, v)`` buffers ([L, 1, P, Hkv, D])
on the device; an evicted entry's memory returns to PyTorch's allocator
when its last reference goes. Capacity is bounded both by entry count
and by bytes, so a long-header workload cannot eat the memory the decode
batch needs.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch


def _entry_bytes(k: torch.Tensor, v: torch.Tensor) -> int:
    return k.numel() * k.element_size() + v.numel() * v.element_size()


@dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PrefixCache:
    """LRU: token-id tuple -> (k, v) device buffers of a prefilled prefix."""

    def __init__(self, max_entries: int = 8, max_bytes: int = 1 << 30):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._entries: OrderedDict[tuple[int, ...], tuple] = OrderedDict()
        self._bytes = 0
        self.stats = PrefixCacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key: tuple[int, ...]):
        """(k, v) for the prefix, or None. Refreshes LRU order on a hit."""
        entry = self._entries.get(key)
        if entry is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return entry

    def put(self, key: tuple[int, ...], k: torch.Tensor, v: torch.Tensor):
        """Insert a prefilled prefix; evicts LRU entries over budget (the
        newest entry stays even when it alone is over the byte budget)."""
        if key in self._entries:
            self._bytes -= _entry_bytes(*self._entries.pop(key))
        self._entries[key] = (k, v)
        self._bytes += _entry_bytes(k, v)
        while len(self._entries) > self.max_entries or (
            self._bytes > self.max_bytes and len(self._entries) > 1
        ):
            _, old = self._entries.popitem(last=False)
            self._bytes -= _entry_bytes(*old)
            self.stats.evictions += 1

    def clear(self) -> None:
        """Drop every entry; they count as evictions."""
        self.stats.evictions += len(self._entries)
        self._entries.clear()
        self._bytes = 0
