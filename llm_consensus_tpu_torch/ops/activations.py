"""SwiGLU MLP.

Counterpart of ``llm_consensus_tpu.ops.activations``. Weights may be
plain tensors (``torch.matmul``, as the JAX package leaves them to XLA)
or int8 :class:`~llm_consensus_tpu_torch.ops.quant.QuantizedTensor`
leaves: every product goes through the quantization-aware
:func:`~llm_consensus_tpu_torch.ops.quant.matmul`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llm_consensus_tpu_torch.ops.quant import matmul as _qmm


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU feed-forward: silu(x @ w_gate) * (x @ w_up) @ w_down.

    x: [..., d_model]; w_gate/w_up: [d_model, d_ff]; w_down: [d_ff, d_model]
    (each a plain tensor or a QuantizedTensor).
    """
    gate = F.silu(_qmm(x, w_gate))
    return _qmm(gate * _qmm(x, w_up), w_down)
