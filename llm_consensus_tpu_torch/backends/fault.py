"""Fault-injecting backend wrapper (chaos testing for the protocol).

Counterpart of ``llm_consensus_tpu.backends.fault``. The reference panics
on any backend failure (``expect`` at ``src/main.rs:85,97,138,178``); the
coordinator here supervises its backend calls with timeouts and bounded
retries, and this wrapper puts that supervision under seeded,
reproducible faults around any :class:`~llm_consensus_tpu_torch.backends.
base.Backend`:

- **errors**: a call raises :class:`BackendError` with probability
  ``error_rate`` (transient: a retry of the same call may pass);
- **delays**: a call sleeps ``delay_s`` seconds with probability
  ``delay_rate`` (drives the timeout paths);
- **garbage**: a result's text is replaced with malformed output with
  probability ``garbage_rate`` (the verdict parser's unknown-evaluation
  path).

Faults are drawn from ``random.Random(seed)``, so a failing chaos run
reproduces exactly. :class:`FaultStats` counts what was injected.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass

from llm_consensus_tpu_torch.backends.base import (
    Backend,
    BackendError,
    GenerationRequest,
    GenerationResult,
)


@dataclass
class FaultStats:
    calls: int = 0
    errors_injected: int = 0
    delays_injected: int = 0
    garbage_injected: int = 0


@dataclass
class FaultConfig:
    error_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.05
    garbage_rate: float = 0.0
    garbage_text: str = "?? GARBLED ??"
    seed: int = 0

    def __post_init__(self):
        for name in ("error_rate", "delay_rate", "garbage_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")


class FaultInjectingBackend(Backend):
    """Wrap ``inner`` with seeded transient errors, delays and garbage."""

    def __init__(self, inner: Backend, config: FaultConfig | None = None):
        self.inner = inner
        self.config = config or FaultConfig()
        self._rng = random.Random(self.config.seed)
        self.stats = FaultStats()

    async def generate_batch(
        self, requests: list[GenerationRequest]
    ) -> list[GenerationResult]:
        cfg = self.config
        self.stats.calls += 1
        # Every decision of this call is drawn before the first await:
        # concurrent calls (the coordinator gathers its panel) would
        # otherwise consume the stream in completion order and break the
        # seeded reproduction.
        delay = self._rng.random() < cfg.delay_rate
        error = self._rng.random() < cfg.error_rate
        garbage = [self._rng.random() < cfg.garbage_rate for _ in requests]
        if delay:
            self.stats.delays_injected += 1
            await asyncio.sleep(cfg.delay_s)
        if error:
            self.stats.errors_injected += 1
            raise BackendError("injected transient fault")
        results = await self.inner.generate_batch(requests)
        out = []
        for r, garbled in zip(results, garbage):
            if garbled:
                self.stats.garbage_injected += 1
                out.append(GenerationResult(
                    text=cfg.garbage_text, num_tokens=r.num_tokens, logprob=r.logprob))
            else:
                out.append(r)
        return out

    async def close(self) -> None:
        await self.inner.close()
