"""LocalBackend: the Backend seam implemented by the on-device engine.

This replaces the reference's L1 compute layer — one fresh HTTPS client
and one remote Gemini call per protocol step (``call_gemini``,
``src/main.rs:82-86``) — with local batched decoding: a whole panel
fan-out arrives as one ``generate_batch`` list and runs as one batched
prefill plus decode loop on the card. The speculative branch of the JAX
package's backend is not ported yet.

Heterogeneous panels (BASELINE.md config[3]) register several engines
keyed by model name; requests route by ``GenerationRequest.model`` and
each engine still batches its own group.
"""

from __future__ import annotations

import asyncio
import logging
from collections import defaultdict

from llm_consensus_tpu_torch.backends.base import (
    Backend,
    BackendError,
    GenerationRequest,
    GenerationResult,
)
from llm_consensus_tpu_torch.engine.engine import InferenceEngine

log = logging.getLogger(__name__)


class LocalBackend(Backend):
    """Batched local inference over one or more :class:`InferenceEngine`s."""

    def __init__(
        self,
        engine: InferenceEngine,
        engines: dict[str, InferenceEngine] | None = None,
    ):
        self.engine = engine
        self.engines = engines or {}

    def _engine_for(self, model: str | None) -> InferenceEngine:
        if model is None:
            return self.engine
        if model in self.engines:
            return self.engines[model]
        if model == self.engine.cfg.name:
            return self.engine
        raise BackendError(
            f"no engine for model {model!r}; have "
            f"{[self.engine.cfg.name, *self.engines]}"
        )

    async def generate_batch(
        self, requests: list[GenerationRequest]
    ) -> list[GenerationResult]:
        if not requests:
            return []
        # Group by (engine, static sampling config); each group is one
        # device program honoring its requests' max_new_tokens/top_k/top_p
        # exactly (temperature and seed are per-row data). The compute is
        # synchronous PyTorch — run it in a thread so the asyncio loop
        # (and any concurrent REPL work) stays responsive.
        groups: dict[tuple, list[int]] = defaultdict(list)
        engines: dict[tuple, InferenceEngine] = {}
        for i, req in enumerate(requests):
            eng = self._engine_for(req.model)
            key = (
                id(eng),
                req.params.max_new_tokens,
                req.params.top_k,
                req.params.top_p,
                req.params.stop,
            )
            groups[key].append(i)
            engines[key] = eng

        results: list[GenerationResult | None] = [None] * len(requests)

        def _run(key: tuple, eng: InferenceEngine, idxs: list[int]) -> None:
            from llm_consensus_tpu_torch.engine.sampler import SamplerConfig

            _, max_new, top_k, top_p, stop = key
            reqs = [requests[i] for i in idxs]
            outs = eng.generate_texts(
                [r.prompt for r in reqs],
                temperatures=[r.params.temperature for r in reqs],
                # One batch shares a generator; per-row independence
                # comes from the batched sampler. Mix the first seed in
                # so distinct requests get distinct streams.
                seed=reqs[0].params.seed,
                max_new_tokens=max_new,
                sampler=SamplerConfig(top_k=top_k, top_p=top_p),
                stop=list(stop) or None,
            )
            for i, out in zip(idxs, outs):
                results[i] = GenerationResult(
                    text=out.text,
                    num_tokens=out.num_tokens,
                    logprob=out.logprob,
                )

        try:
            await asyncio.gather(
                *(
                    asyncio.to_thread(_run, key, engines[key], idxs)
                    for key, idxs in groups.items()
                )
            )
        except BackendError:
            raise
        except Exception as e:  # noqa: BLE001 - surface as typed error
            raise BackendError(f"local generation failed: {e}") from e
        assert all(r is not None for r in results)
        return results  # type: ignore[return-value]
