from llm_consensus_tpu_torch.backends.base import (
    Backend,
    BackendError,
    GenerationRequest,
    GenerationResult,
    SamplingParams,
)
from llm_consensus_tpu_torch.backends.fake import FakeBackend, ScriptedBackend
from llm_consensus_tpu_torch.backends.fault import (
    FaultConfig,
    FaultInjectingBackend,
    FaultStats,
)

__all__ = [
    "Backend",
    "BackendError",
    "ContinuousBackend",
    "FakeBackend",
    "FaultConfig",
    "FaultInjectingBackend",
    "FaultStats",
    "GenerationRequest",
    "GenerationResult",
    "SamplingParams",
    "ScriptedBackend",
]


def __getattr__(name):
    # The continuous batcher's backend lives in ``serving`` (which
    # imports this package), so it is resolved on first use.
    if name == "ContinuousBackend":
        from llm_consensus_tpu_torch.serving.continuous import ContinuousBackend

        return ContinuousBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
