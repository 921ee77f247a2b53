"""K2, K3 and K7: causal prefill, decode and shared-prefix decode
attention — the wrappers of ``csrc/causal_attention.cu`` and
``csrc/decode_attention.cu`` and their twins.

They replace ``llm_consensus_tpu/ops/pallas/attention.py``'s
``flash_causal_attention``, ``flash_decode_attention`` and (dense cache)
``flash_decode_attention_shared_prefix``. The source note
of each ``.cu`` file says what bounds it on the card and what its design
does about that. Layouts are the JAX package's: q [B, S, H, D], k/v
[B, S, Hkv, D], the cache [B, S_max, Hkv, D].
"""

from __future__ import annotations

import torch

from llm_consensus_tpu_torch.ops.attention import (
    causal_attention,
    decode_attention,
    decode_attention_shared_prefix,
)
from llm_consensus_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_DECODE_GROUPS = (1, 2, 4, 8)
_MAX_THREADS = 512  # csrc/causal_attention.cu: kMaxThreads
_PREFIX_SPLIT = 64  # csrc/decode_attention.cu: kSplit


def _check(name: str, q: torch.Tensor, *tensors: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    for t in (q, *tensors):
        if t.dtype != q.dtype or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"{name} needs contiguous {q.dtype} tensors on the card"
            )
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {_HEAD_DIMS}, got {d}")


def flash_causal_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch twin: index-causal GQA attention."""
    return causal_attention(q, k, v)


def causal_block_q(h: int, hkv: int, d: int) -> int:
    """Query positions per block: 64, or fewer when the block's
    ``bq * G * (D / 32)`` threads would pass the kernel's limit."""
    per_pos = (h // hkv) * max(1, d // 32)
    bq = 64
    while bq > 1 and bq * per_pos > _MAX_THREADS:
        bq //= 2
    return bq


def flash_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Causal attention, index-causal positions (the prefill hot path).

    q: [B, S, H, D]; k/v: [B, S, Hkv, D]. Any S (the kernel masks the
    ragged last query tile). Returns [B, S, H, D] in q's dtype. CPU
    tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if not q.is_cuda:
        return flash_causal_attention_plain(q, k, v)
    _check("flash_causal_attention", q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"bad shapes q {q.shape} k {k.shape} v {v.shape}")
    bq = causal_block_q(h, hkv, d)
    threads = bq * (h // hkv) * max(1, d // 32)
    if threads > _MAX_THREADS or threads % 32:
        raise ValueError(f"flash_causal_attention: no block shape for H={h} Hkv={hkv} D={d}")
    lib = build.load_library()
    out = torch.empty_like(q)
    rc = lib.lct_causal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, hkv, d, bq, float(d ** -0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "causal_attention")
    flash_causal_attention.launches += 1
    return out


flash_causal_attention.launches = 0


def flash_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch twin: decode attention with valid_len masking."""
    return decode_attention(q, k_cache, v_cache, valid_len)


def flash_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
) -> torch.Tensor:
    """One-token decode attention with ragged valid lengths.

    q: [B, 1, H, D]; k_cache/v_cache: [B, S_max, Hkv, D]; valid_len: [B]
    int32, each >= 1 (decode passes the fill length plus the new token;
    a row with none gives zeros here, where the twin averages every
    slot). Returns [B, 1, H, D] in q's dtype. CPU tensors take the plain
    twin; CUDA tensors launch the kernel.
    """
    if not q.is_cuda:
        return flash_decode_attention_plain(q, k_cache, v_cache, valid_len)
    b, s_max, h, hkv, d = _check_decode("flash_decode_attention", q, k_cache, v_cache, valid_len)
    lib = build.load_library()
    out = torch.empty_like(q)
    rc = lib.lct_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid_len.data_ptr(), out.data_ptr(),
        b, s_max, h, hkv, d, float(d ** -0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def _check_decode(name, q, k_cache, v_cache, valid_len):
    """Validate decode operands on the card; return (B, S_max, H, Hkv, D)."""
    _check(name, q, k_cache, v_cache)
    b, one, h, d = q.shape
    _, s_max, hkv, _ = k_cache.shape
    if (
        one != 1
        or k_cache.shape != (b, s_max, hkv, d)
        or v_cache.shape != k_cache.shape
        or h % hkv
        or h // hkv not in _DECODE_GROUPS
    ):
        raise ValueError(
            f"bad shapes q {q.shape} cache {k_cache.shape} (G in {_DECODE_GROUPS})"
        )
    if (
        valid_len.dtype != torch.int32
        or valid_len.shape != (b,)
        or not valid_len.is_cuda
        or not valid_len.is_contiguous()
    ):
        raise ValueError("valid_len must be a contiguous int32 [B] tensor on the card")
    return b, s_max, h, hkv, d


def flash_decode_attention_shared_prefix_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    prefix_len: int,
) -> torch.Tensor:
    """The plain PyTorch twin: two-phase decode attention, merged by
    log-sum-exp."""
    return decode_attention_shared_prefix(q, k_cache, v_cache, valid_len, prefix_len)


def flash_decode_attention_shared_prefix(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    prefix_len: int,
) -> torch.Tensor:
    """Decode attention for a fan-out whose rows share a cache prefix.

    As :func:`flash_decode_attention`, plus ``prefix_len``: every row's
    slots [0, prefix_len) hold the same K/V, so the kernel reads them
    once (from row 0) for all rows and each row reads only its slots
    [prefix_len, valid_len). CPU tensors take the plain twin; CUDA
    tensors launch the kernel (a prefix pass, then the rows' suffix pass
    that merges both).
    """
    prefix_len = int(prefix_len)
    if not q.is_cuda:
        return flash_decode_attention_shared_prefix_plain(
            q, k_cache, v_cache, valid_len, prefix_len
        )
    b, s_max, h, hkv, d = _check_decode(
        "flash_decode_attention_shared_prefix", q, k_cache, v_cache, valid_len
    )
    if not 0 <= prefix_len <= s_max:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {s_max}]")
    n_split = -(-prefix_len // _PREFIX_SPLIT)
    ws = torch.empty(max(1, n_split * b * h * (d + 2)), dtype=torch.float32, device=q.device)
    lib = build.load_library()
    out = torch.empty_like(q)
    rc = lib.lct_shared_prefix_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, s_max, h, hkv, d, prefix_len, float(d ** -0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "shared_prefix_attention")
    flash_decode_attention_shared_prefix.launches += 1
    return out


flash_decode_attention_shared_prefix.launches = 0
