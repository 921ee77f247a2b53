"""K1: fused RMSNorm — the wrapper of ``csrc/rms_norm.cu`` and its twin.

Replaces ``llm_consensus_tpu/ops/pallas/norms.py:fused_rms_norm``. The
source note in ``csrc/rms_norm.cu`` says what bounds it on the card and
what its design does about that.
"""

from __future__ import annotations

import torch

from llm_consensus_tpu_torch.ops.kernels import build
from llm_consensus_tpu_torch.ops.norms import rms_norm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_rms_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """The plain PyTorch twin: the same function as the kernel."""
    return rms_norm(x, weight, eps)


def fused_rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """RMSNorm over the last axis. x: [..., D]; weight: [D].

    CPU tensors take the plain twin; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    if not x.is_cuda:
        return fused_rms_norm_plain(x, weight, eps)
    d = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"fused_rms_norm takes float32 or bfloat16 x and a weight of the "
            f"same type, got {x.dtype} and {weight.dtype}"
        )
    if not x.is_contiguous() or weight.shape != (d,) or not weight.is_cuda:
        raise ValueError("fused_rms_norm needs a contiguous x and a [D] weight on the card")
    lib = build.load_library()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    rc = lib.lct_rms_norm(
        x.data_ptr(), weight.contiguous().data_ptr(), out.data_ptr(),
        rows, d, float(eps), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "rms_norm")
    fused_rms_norm.launches += 1
    return out


fused_rms_norm.launches = 0
