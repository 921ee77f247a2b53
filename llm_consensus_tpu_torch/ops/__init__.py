from llm_consensus_tpu_torch.ops.activations import swiglu
from llm_consensus_tpu_torch.ops.attention import causal_attention, decode_attention
from llm_consensus_tpu_torch.ops.norms import rms_norm
from llm_consensus_tpu_torch.ops.rope import apply_rope, rope_cos_sin

__all__ = [
    "apply_rope",
    "causal_attention",
    "decode_attention",
    "rms_norm",
    "rope_cos_sin",
    "swiglu",
]
