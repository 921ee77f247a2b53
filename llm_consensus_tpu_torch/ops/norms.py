"""RMSNorm, the plain PyTorch version.

Counterpart of ``llm_consensus_tpu.ops.norms``. The hand-written kernel
that replaces it on the hot path is
:func:`llm_consensus_tpu_torch.ops.kernels.norms.fused_rms_norm`.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Root-mean-square layer norm (Llama convention: scale only, no bias).

    The reduction runs in float32 regardless of input dtype, and the
    result is cast back to ``x``'s dtype.
    """
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
