"""SwiGLU MLP.

Counterpart of ``llm_consensus_tpu.ops.activations``. The matmuls are
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves them to
XLA; the int8 weight path waits for the port's quantized slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
) -> torch.Tensor:
    """SwiGLU feed-forward: silu(x @ w_gate) * (x @ w_up) @ w_down.

    x: [..., d_model]; w_gate/w_up: [d_model, d_ff]; w_down: [d_ff, d_model].
    """
    gate = F.silu(x @ w_gate)
    return (gate * (x @ w_up)) @ w_down
