"""Backend seam: the single boundary between the consensus protocol and the
compute substrate.

In the reference this seam is ``call_gemini(prompt) -> text``
(``src/main.rs:82-86``): one remote HTTPS round-trip per protocol step, one
fresh client per call. Here it is an abstract ``Backend`` with a batched
async ``generate`` so that:

- tests run against a deterministic :class:`FakeBackend` (the test strategy
  the reference lacks, SURVEY.md §4),
- production runs against
  :class:`~llm_consensus_tpu_torch.backends.local.LocalBackend` — batched
  decoding on the card, where a whole panel fan-out becomes ONE batched
  forward instead of N HTTP requests,
- per-request sampling params and per-candidate PRNG seeds are first-class
  (needed for N-way self-consistency, BASELINE.md).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SamplingParams:
    """Decode-time sampling configuration for one request."""

    max_new_tokens: int = 256
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled
    seed: int = 0
    # Stop sequences: generation text is trimmed at the earliest
    # occurrence (stop removed); backends end decoding early where their
    # substrate allows (engine: single-token device stops + chunked
    # host checks; continuous batcher: every token is host-checked).
    # A tuple so the dataclass stays frozen/hashable.
    stop: tuple[str, ...] = ()


@dataclass(frozen=True)
class GenerationRequest:
    prompt: str
    params: SamplingParams = field(default_factory=SamplingParams)
    # Optional model preset for heterogeneous panels; None = backend default.
    model: str | None = None


@dataclass
class GenerationResult:
    text: str
    # Number of generated (candidate) tokens; 0 when the backend does not
    # tokenize (e.g. the fake backend).
    num_tokens: int = 0
    # Sum of log-probabilities of the sampled tokens, for logit-pooled
    # aggregation; None when unavailable.
    logprob: float | None = None
    # Backend-specific serving metadata: the continuous batcher
    # attaches its per-request timing summary (TTFT, inter-token-gap
    # percentiles, speculation tallies, header-page provenance) — the
    # gateway surfaces it as the response's "meta". None when the
    # backend records nothing. compare=False: result equality means
    # "same generation", and timing stamps never repeat.
    meta: dict | None = field(default=None, compare=False)


class Backend(abc.ABC):
    """Text-generation backend: the ``call_gemini`` seam, batched."""

    @abc.abstractmethod
    async def generate_batch(
        self, requests: list[GenerationRequest]
    ) -> list[GenerationResult]:
        """Generate one completion per request.

        Implementations should treat the list as a batch when the substrate
        allows (the local backend pads them into one batch).
        """

    async def generate(self, request: GenerationRequest) -> GenerationResult:
        """Single-request convenience wrapper over :meth:`generate_batch`."""
        (result,) = await self.generate_batch([request])
        return result

    async def close(self) -> None:  # pragma: no cover - default no-op
        """Release resources (device buffers, threads)."""
        return None


class BackendError(RuntimeError):
    """Raised when a backend fails permanently (after retries).

    The reference ``expect``-panics on any backend error
    (``src/main.rs:85,97,138,178``); the rebuild surfaces a typed error the
    coordinator's failure-detection layer can handle (SURVEY.md §5).
    """
