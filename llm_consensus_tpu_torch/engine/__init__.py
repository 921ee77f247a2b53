"""Inference engine: tokenizer, sampler, batched generation loop."""

from llm_consensus_tpu_torch.engine.engine import (
    EngineConfig,
    InferenceEngine,
    plan_memory,
)
from llm_consensus_tpu_torch.engine.generate import GenerateOutput, generate
from llm_consensus_tpu_torch.engine.sampler import SamplerConfig, sample_token
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer, Tokenizer

__all__ = [
    "ByteTokenizer",
    "EngineConfig",
    "GenerateOutput",
    "InferenceEngine",
    "SamplerConfig",
    "Tokenizer",
    "generate",
    "plan_memory",
    "sample_token",
]
