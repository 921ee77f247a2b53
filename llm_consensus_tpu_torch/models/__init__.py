from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache, quantize_kv
from llm_consensus_tpu_torch.models.configs import PRESETS, ModelConfig, get_config
from llm_consensus_tpu_torch.models.hf_loader import config_from_hf, load_hf_params
from llm_consensus_tpu_torch.models.transformer import (
    decode_chunk,
    decode_step,
    forward,
    init_params,
    init_params_quantized,
    moe_router_aux,
    param_count,
    params_from_jax,
    prefill,
    prefill_chunked,
    set_stacked_decode,
)

__all__ = [
    "KVCache",
    "ModelConfig",
    "PRESETS",
    "QuantKVCache",
    "config_from_hf",
    "decode_chunk",
    "decode_step",
    "forward",
    "get_config",
    "init_params",
    "init_params_quantized",
    "load_hf_params",
    "moe_router_aux",
    "param_count",
    "params_from_jax",
    "prefill",
    "prefill_chunked",
    "quantize_kv",
    "set_stacked_decode",
]
