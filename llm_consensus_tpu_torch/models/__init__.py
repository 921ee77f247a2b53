from llm_consensus_tpu_torch.models.cache import KVCache
from llm_consensus_tpu_torch.models.configs import PRESETS, ModelConfig, get_config
from llm_consensus_tpu_torch.models.transformer import (
    decode_step,
    forward,
    init_params,
    param_count,
    params_from_jax,
    prefill,
)

__all__ = [
    "KVCache",
    "ModelConfig",
    "PRESETS",
    "decode_step",
    "forward",
    "get_config",
    "init_params",
    "param_count",
    "params_from_jax",
    "prefill",
]
