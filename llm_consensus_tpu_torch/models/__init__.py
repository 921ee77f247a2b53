from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache, quantize_kv
from llm_consensus_tpu_torch.models.configs import PRESETS, ModelConfig, get_config
from llm_consensus_tpu_torch.models.transformer import (
    decode_step,
    forward,
    init_params,
    init_params_quantized,
    param_count,
    params_from_jax,
    prefill,
    set_stacked_decode,
)

__all__ = [
    "KVCache",
    "ModelConfig",
    "PRESETS",
    "QuantKVCache",
    "decode_step",
    "forward",
    "get_config",
    "init_params",
    "init_params_quantized",
    "param_count",
    "params_from_jax",
    "prefill",
    "quantize_kv",
    "set_stacked_decode",
]
