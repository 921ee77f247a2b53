"""Hand-written Hopper kernels: the counterpart of ``llm_consensus_tpu.ops.pallas``.

Each kernel is CUDA C++ under ``csrc/``, built for ``sm_90a`` at first use
(:mod:`.build`) and bound through ``ctypes``. Beside each wrapper sits its
plain PyTorch twin (``*_plain``), which the wrapper takes for CPU tensors
only, and a launch counter (``wrapper.launches``) that counts the kernel's
launches and nothing else.

- K1 :func:`~.norms.fused_rms_norm` (``csrc/rms_norm.cu``)
- K2 :func:`~.attention.flash_causal_attention` (``csrc/causal_attention.cu``)
- K3 :func:`~.attention.flash_decode_attention` (``csrc/decode_attention.cu``,
  the split-KV pass of ``csrc/decode_split.cuh`` on the dense cache)
- K7 :func:`~.attention.flash_decode_attention_shared_prefix`
  (``csrc/decode_attention.cu``: the tile pass of ``csrc/decode_tile.cuh``
  over the shared prefix, then the split-KV pass over each row's own
  slots)
- K4 :func:`~.attention.flash_decode_attention_q8` and K5
  :func:`~.attention.flash_decode_attention_q8_stacked`, K4 on a layer's
  views (``csrc/decode_attention_q8.cu``, the same split-KV pass on the
  int8 cache)
- K6 :func:`~.quant_matmul.quant_matmul_2d` (``csrc/quant_matmul.cu``: the
  wgmma kernel of ``csrc/quant_wgmma.cuh`` on int8 weights for bf16 x, a
  CUDA-core kernel for float32 x; ``quant_matmul_stacked`` is the same
  kernel on a layer's views)
- K7-q8 :func:`~.attention.flash_decode_attention_shared_prefix_q8` and
  :func:`~.attention.flash_decode_attention_shared_prefix_q8_stacked`
  (``csrc/decode_attention_q8.cu``: the same two passes on the int8 cache)
- K8 :func:`~.ragged_attention.ragged_paged_attention` and its thin
  wrappers ``paged_decode_attention`` and
  ``paged_decode_attention_grouped`` (``csrc/ragged_paged_attention.cu``:
  the tile pass for the group run, the chunk and verify rows, the
  split-KV pass on the page pool for decode rows)
- K10 :func:`~.quant_matmul.quant4_matmul_2d`, the packed-int4 matmul
  (``csrc/quant4_matmul.cu``, the same wgmma kernel on packed weights, for
  bf16 x; ``csrc/quant_matmul.cu`` for float32 x)
"""

from llm_consensus_tpu_torch.ops.kernels.attention import (
    flash_causal_attention,
    flash_decode_attention,
    flash_decode_attention_q8,
    flash_decode_attention_q8_stacked,
    flash_decode_attention_shared_prefix,
    flash_decode_attention_shared_prefix_q8,
    flash_decode_attention_shared_prefix_q8_stacked,
)
from llm_consensus_tpu_torch.ops.kernels.norms import fused_rms_norm
from llm_consensus_tpu_torch.ops.kernels.quant_matmul import (
    quant4_matmul_2d,
    quant_matmul_2d,
)
from llm_consensus_tpu_torch.ops.kernels.ragged_attention import (
    paged_decode_attention,
    paged_decode_attention_grouped,
    ragged_paged_attention,
    ragged_paged_attention_sharded,
)

KERNELS = (
    fused_rms_norm,
    flash_causal_attention,
    flash_decode_attention,
    flash_decode_attention_shared_prefix,
    flash_decode_attention_q8,
    flash_decode_attention_q8_stacked,
    quant_matmul_2d,
    flash_decode_attention_shared_prefix_q8,
    flash_decode_attention_shared_prefix_q8_stacked,
    ragged_paged_attention,
    quant4_matmul_2d,
    ragged_paged_attention_sharded,
)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "KERNELS",
    "flash_causal_attention",
    "flash_decode_attention",
    "flash_decode_attention_q8",
    "flash_decode_attention_q8_stacked",
    "flash_decode_attention_shared_prefix",
    "flash_decode_attention_shared_prefix_q8",
    "flash_decode_attention_shared_prefix_q8_stacked",
    "fused_rms_norm",
    "paged_decode_attention",
    "paged_decode_attention_grouped",
    "quant4_matmul_2d",
    "quant_matmul_2d",
    "ragged_paged_attention",
    "ragged_paged_attention_sharded",
    "reset_launch_counts",
]
