"""K2, K3, K7 and their int8-cache forms K4, K5, K7-q8: causal prefill,
decode and shared-prefix decode attention — the wrappers of
``csrc/causal_attention.cu`` and ``csrc/decode_attention.cu`` and their
twins.

They replace ``llm_consensus_tpu/ops/pallas/attention.py``'s
``flash_causal_attention``, ``flash_decode_attention``,
``flash_decode_attention_shared_prefix``, ``flash_decode_attention_q8``,
``flash_decode_attention_q8_stacked``,
``flash_decode_attention_shared_prefix_q8`` and
``flash_decode_attention_shared_prefix_q8_stacked``. The source note of
each ``.cu`` file says what bounds it on the card and what its design
does about that. Layouts are the JAX package's: q [B, S, H, D], k/v
[B, S, Hkv, D], the dense cache [B, S_max, Hkv, D], the int8 cache
head-major [B, Hkv, S_max, D] with float32 scales [B, Hkv, S_max].

The two ``_stacked`` forms exist in the JAX package because a Pallas
operand must be a whole buffer, so the layer index rides scalar
prefetch. Here ``k_q[layer]`` is a zero-copy view: each launches the
K4 or K7-q8 kernel on the layer's views, and counts its own launches.
"""

from __future__ import annotations

import torch

from llm_consensus_tpu_torch.ops.attention import (
    _NEG_INF,
    causal_attention,
    decode_attention,
    decode_attention_shared_prefix,
    merge_decode_partials,
)
from llm_consensus_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_DECODE_GROUPS = (1, 2, 4, 8)
_MAX_THREADS = 512  # csrc/causal_attention.cu: kMaxThreads
# csrc/causal_attention.cu's bf16 kernel: keys per tile, tiles in shared memory.
_TC_KEYS = 64
_TC_STAGES = 2
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
    """Query positions per block of the float32 kernel: 64, or fewer when
    the block's ``bq * G * (D / 32)`` threads would pass its limit."""
    per_pos = (h // hkv) * max(1, d // 32)
    bq = 64
    while bq > 1 and bq * per_pos > _MAX_THREADS:
        bq //= 2
    return bq


def causal_tile_bf16(h: int, hkv: int, d: int) -> tuple[int, int]:
    """(rows per block, dynamic shared-memory bytes) of the bf16 kernel.

    A block's rows are (query position, head of the group) pairs, 16 per
    warp, whatever G = H / Hkv is: 64 rows (4 warps) at every D, which
    timed faster than 128 rows (8 warps) on the H100 at all but one of
    the shapes tried (PERF.md §6). The shared memory holds two stages
    of a 64-key K and V tile in bf16, each key row padded by 16 bytes.
    """
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_causal_attention takes head_dim in {_HEAD_DIMS}, got {d}")
    if hkv <= 0 or h % hkv:
        raise ValueError(f"flash_causal_attention needs H a multiple of Hkv, got {h}, {hkv}")
    return 64, _TC_STAGES * 2 * _TC_KEYS * (d + 8) * 2


def flash_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Causal attention, index-causal positions (the prefill hot path).

    q: [B, S, H, D]; k/v: [B, S, Hkv, D]. Any S (the kernel masks the
    ragged last query and key tiles). Returns [B, S, H, D] in q's dtype.
    CPU tensors take the plain twin; CUDA tensors launch the kernel for
    their type: bf16 the tensor-core kernel, float32 the CUDA-core one.
    """
    if not q.is_cuda:
        return flash_causal_attention_plain(q, k, v)
    _check("flash_causal_attention", q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"bad shapes q {q.shape} k {k.shape} v {v.shape}")
    if q.dtype == torch.bfloat16:
        tile = causal_tile_bf16(h, hkv, d)[0]
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_causal_attention needs bf16 q, k, v 16-byte aligned")
    else:
        tile = causal_block_q(h, hkv, d)
        threads = tile * (h // hkv) * max(1, d // 32)
        if threads > _MAX_THREADS or threads % 32:
            raise ValueError(f"flash_causal_attention: no block shape for H={h} Hkv={hkv} D={d}")
    lib = build.load_library()
    out = torch.empty_like(q)
    rc = lib.lct_causal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, hkv, d, tile, float(d ** -0.5), _DTYPES[q.dtype],
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


# ---------------------------------------------------------------------------
# K4, K5, K7-q8: decode over the int8 head-major cache
# ---------------------------------------------------------------------------


def _q8_scores(q, k_q, k_scale):
    """Scores [B, Hkv, G, S] in float32: ``q . k_q`` times the slot's K
    scale and d^-1/2 (the Pallas kernels' ``_q8_attend`` fold)."""
    b, _, h, d = q.shape
    hkv = k_q.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k_q.float())
    return scores * (k_scale[:, :, None, :] * d**-0.5)


def _q8_partial(scores, v_q, v_scale, mask):
    """(m, l, o) over one masked slot range, the V scale folded into the
    value product only (l stays the true softmax sum, as ``_online_fold``
    keeps it). scores [B, Hkv, G, S]; mask broadcastable to it."""
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bksd->bkgd", p * v_scale[:, :, None, :], v_q.float())
    return m, l, acc / torch.clamp(l, min=1e-30)


def _q8_out(o, q):
    b, _, h, d = q.shape
    return o.reshape(b, 1, h, d).to(q.dtype)


def flash_decode_attention_q8_plain(q, k_q, k_scale, v_q, v_scale, valid_len):
    """The plain PyTorch twin of K4: ``_q8_attend``'s arithmetic."""
    s = k_q.shape[2]
    slot = torch.arange(s, device=q.device)
    mask = (slot[None, :] < valid_len[:, None])[:, None, None, :]
    _, _, o = _q8_partial(_q8_scores(q, k_q, k_scale), v_q, v_scale, mask)
    return _q8_out(o, q)


def flash_decode_attention_shared_prefix_q8_plain(
    q, k_q, k_scale, v_q, v_scale, valid_len, prefix_len
):
    """The plain PyTorch twin of K7-q8: all rows' queries against row 0's
    prefix slots [0, prefix_len), each row against its own slots
    [prefix_len, valid_len), merged by log-sum-exp."""
    s = k_q.shape[2]
    slot = torch.arange(s, device=q.device)
    mask1 = (slot < prefix_len)[None, None, None, :]
    p1 = _q8_partial(
        _q8_scores(q, k_q[:1].expand_as(k_q), k_scale[:1].expand_as(k_scale)),
        v_q[:1].expand_as(v_q), v_scale[:1].expand_as(v_scale), mask1,
    )
    mask2 = ((slot[None, :] >= prefix_len) & (slot[None, :] < valid_len[:, None]))[
        :, None, None, :
    ]
    p2 = _q8_partial(_q8_scores(q, k_q, k_scale), v_q, v_scale, mask2)
    return _q8_out(merge_decode_partials(*p1, *p2), q)


def _check_decode_q8(name, q, k_q, k_scale, v_q, v_scale, valid_len):
    """Validate int8-cache decode operands on the card; return
    (B, S_max, H, Hkv, D)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 q, got {q.dtype}")
    b, one, h, d = q.shape
    _, hkv, s_max, _ = k_q.shape
    if (
        one != 1
        or k_q.shape != (b, hkv, s_max, d)
        or v_q.shape != k_q.shape
        or k_scale.shape != (b, hkv, s_max)
        or v_scale.shape != k_scale.shape
        or h % hkv
        or h // hkv not in _DECODE_GROUPS
        or d not in _HEAD_DIMS
    ):
        raise ValueError(
            f"bad shapes q {q.shape} cache {k_q.shape} scales {k_scale.shape} "
            f"(G in {_DECODE_GROUPS}, D in {_HEAD_DIMS})"
        )
    for t, dtype in ((q, q.dtype), (k_q, torch.int8), (v_q, torch.int8),
                     (k_scale, torch.float32), (v_scale, torch.float32),
                     (valid_len, torch.int32)):
        if t.dtype != dtype or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"{name} needs contiguous tensors on the card: q float32/bfloat16, "
                "k_q/v_q int8, scales float32, valid_len int32"
            )
    if valid_len.shape != (b,):
        raise ValueError("valid_len must be an int32 [B] tensor")
    return b, s_max, h, hkv, d


def _launch_q8(name, q, k_q, k_scale, v_q, v_scale, valid_len, prefix_len=None):
    """Launch K4 (``prefix_len`` None) or K7-q8 on the card; the caller
    counts the launch."""
    b, s_max, h, hkv, d = _check_decode_q8(name, q, k_q, k_scale, v_q, v_scale, valid_len)
    lib = build.load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if prefix_len is None:
        rc = lib.lct_decode_attention_q8(
            q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
            v_scale.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
            b, s_max, h, hkv, d, float(d ** -0.5), _DTYPES[q.dtype], stream,
        )
        build.check(rc, "decode_attention_q8")
        return out
    if not 0 <= prefix_len <= s_max:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {s_max}]")
    n_split = -(-prefix_len // _PREFIX_SPLIT)
    ws = torch.empty(max(1, n_split * b * h * (d + 2)), dtype=torch.float32, device=q.device)
    rc = lib.lct_shared_prefix_attention_q8(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), valid_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, s_max, h, hkv, d, prefix_len, float(d ** -0.5), _DTYPES[q.dtype], stream,
    )
    build.check(rc, "shared_prefix_attention_q8")
    return out


def flash_decode_attention_q8(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len: torch.Tensor,
) -> torch.Tensor:
    """K4: one-token decode attention over the int8 head-major cache.

    q: [B, 1, H, D]; k_q/v_q: [B, Hkv, S_max, D] int8; k_scale/v_scale:
    [B, Hkv, S_max] float32; valid_len: [B] int32, each >= 1. Returns
    [B, 1, H, D] in q's dtype. CPU tensors take the plain twin; CUDA
    tensors launch the kernel.
    """
    if not q.is_cuda:
        return flash_decode_attention_q8_plain(q, k_q, k_scale, v_q, v_scale, valid_len)
    out = _launch_q8("flash_decode_attention_q8", q, k_q, k_scale, v_q, v_scale, valid_len)
    flash_decode_attention_q8.launches += 1
    return out


flash_decode_attention_q8.launches = 0


def flash_decode_attention_q8_stacked(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """K5: K4 over layer ``layer`` of the whole stacked cache (k_q/v_q
    [L, B, Hkv, S_max, D], scales [L, B, Hkv, S_max]), launched on the
    layer's zero-copy views."""
    views = (k_q[layer], k_scale[layer], v_q[layer], v_scale[layer])
    if not q.is_cuda:
        return flash_decode_attention_q8_plain(q, *views, valid_len)
    out = _launch_q8("flash_decode_attention_q8_stacked", q, *views, valid_len)
    flash_decode_attention_q8_stacked.launches += 1
    return out


flash_decode_attention_q8_stacked.launches = 0


def flash_decode_attention_shared_prefix_q8(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len: torch.Tensor,
    prefix_len: int,
) -> torch.Tensor:
    """K7-q8: as :func:`flash_decode_attention_q8`, plus ``prefix_len``:
    every row's slots [0, prefix_len) hold the same K/V, so the kernel
    reads them once (from row 0) for all rows and each row reads only its
    slots [prefix_len, valid_len). CPU tensors take the plain twin; CUDA
    tensors launch the kernel (a prefix pass, then the rows' suffix pass
    that merges both)."""
    prefix_len = int(prefix_len)
    if not q.is_cuda:
        return flash_decode_attention_shared_prefix_q8_plain(
            q, k_q, k_scale, v_q, v_scale, valid_len, prefix_len
        )
    out = _launch_q8(
        "flash_decode_attention_shared_prefix_q8",
        q, k_q, k_scale, v_q, v_scale, valid_len, prefix_len,
    )
    flash_decode_attention_shared_prefix_q8.launches += 1
    return out


flash_decode_attention_shared_prefix_q8.launches = 0


def flash_decode_attention_shared_prefix_q8_stacked(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len: torch.Tensor,
    prefix_len: int,
    layer: int,
) -> torch.Tensor:
    """K7-q8 over layer ``layer`` of the whole stacked cache, launched on
    the layer's zero-copy views."""
    prefix_len = int(prefix_len)
    views = (k_q[layer], k_scale[layer], v_q[layer], v_scale[layer])
    if not q.is_cuda:
        return flash_decode_attention_shared_prefix_q8_plain(q, *views, valid_len, prefix_len)
    out = _launch_q8(
        "flash_decode_attention_shared_prefix_q8_stacked", q, *views, valid_len, prefix_len
    )
    flash_decode_attention_shared_prefix_q8_stacked.launches += 1
    return out


flash_decode_attention_shared_prefix_q8_stacked.launches = 0
