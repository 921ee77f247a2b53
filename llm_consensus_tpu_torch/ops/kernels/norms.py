"""K1: fused RMSNorm — the wrapper of ``csrc/rms_norm.cu`` and its twin.

Replaces ``llm_consensus_tpu/ops/pallas/norms.py:fused_rms_norm``. The
source note in ``csrc/rms_norm.cu`` says what bounds it on the card and
what its design does about that.
"""

from __future__ import annotations

import functools

import torch

from llm_consensus_tpu_torch.ops.kernels import build
from llm_consensus_tpu_torch.ops.norms import rms_norm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Elements of a 16-byte vector, the kernel's unit of load and store.
_VEC = {torch.float32: 4, torch.bfloat16: 8}
# csrc/rms_norm.cu: the vectors-per-lane counts it is instantiated for (the
# preset widths need all of them, in one type or the other), and its warps
# per block at most.
_LANE_VECTORS = (1, 2, 3, 4, 6, 8, 16, 32)
_MAX_WARPS = 8
# Warps launched per SM at most; rows beyond them are walked grid-stride.
_WARPS_PER_SM = 32


def rms_norm_launch(rows: int, d: int, dtype: torch.dtype, sms: int) -> tuple[int, int, int]:
    """(vectors per lane, warps per block, blocks) of the kernel for
    ``rows`` rows of width ``d`` on a card of ``sms`` SMs.

    One warp per row: as many warps per block (up to 8) as still leave
    one block per SM, so the 64 rows of a decode step take 64 SMs. Raises
    on a width the kernel does not take: not a whole number of 16-byte
    vectors, or wider than 32 of them a lane.
    """
    vec = _VEC[dtype]
    if d <= 0 or d % vec:
        raise ValueError(
            f"fused_rms_norm takes d a multiple of {vec} in {dtype}, got d={d}"
        )
    need = -(-d // (32 * vec))
    nv = next((n for n in _LANE_VECTORS if n >= need), None)
    if nv is None:
        raise ValueError(
            f"fused_rms_norm takes d up to {32 * vec * _LANE_VECTORS[-1]} in "
            f"{dtype}, got d={d}"
        )
    warps = _MAX_WARPS
    while warps > 1 and -(-rows // warps) < sms:
        warps //= 2
    blocks = max(1, min(-(-rows // warps), sms * _WARPS_PER_SM // warps))
    return nv, warps, blocks


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    rows = x.numel() // d if d else 0
    nv, warps, blocks = rms_norm_launch(rows, d, x.dtype, _sm_count(x.device))
    weight = weight.contiguous()
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("fused_rms_norm needs x and the weight 16-byte aligned")
    lib = build.load_library()
    out = torch.empty_like(x)
    rc = lib.lct_rms_norm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(),
        rows, d, float(eps), _DTYPES[x.dtype], nv, warps, blocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "rms_norm")
    fused_rms_norm.launches += 1
    return out


fused_rms_norm.launches = 0
