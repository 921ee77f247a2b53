"""Inference engine: tokenizer, sampler, batched generation loop."""

from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
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
    "sample_token",
]
