from llm_consensus_tpu_torch.backends.base import (
    Backend,
    BackendError,
    GenerationRequest,
    GenerationResult,
    SamplingParams,
)
from llm_consensus_tpu_torch.backends.fake import FakeBackend, ScriptedBackend

__all__ = [
    "Backend",
    "BackendError",
    "FakeBackend",
    "GenerationRequest",
    "GenerationResult",
    "SamplingParams",
    "ScriptedBackend",
]
