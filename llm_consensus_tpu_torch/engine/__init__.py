"""Inference engine: tokenizer, sampler, batched generation loop."""

from llm_consensus_tpu_torch.engine.engine import (
    EngineConfig,
    InferenceEngine,
    plan_memory,
)
from llm_consensus_tpu_torch.engine.generate import (
    GenerateOutput,
    decode_steps,
    generate,
    generate_from_prefix,
    score_completions,
)
from llm_consensus_tpu_torch.engine.prefix_cache import PrefixCache, PrefixCacheStats
from llm_consensus_tpu_torch.engine.sampler import SamplerConfig, sample_token
from llm_consensus_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    Tokenizer,
    load_tokenizer,
)

__all__ = [
    "ByteTokenizer",
    "EngineConfig",
    "GenerateOutput",
    "HFTokenizer",
    "InferenceEngine",
    "PrefixCache",
    "PrefixCacheStats",
    "SamplerConfig",
    "Tokenizer",
    "decode_steps",
    "generate",
    "generate_from_prefix",
    "load_tokenizer",
    "plan_memory",
    "sample_token",
    "score_completions",
]
