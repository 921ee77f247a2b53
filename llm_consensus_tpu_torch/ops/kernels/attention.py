"""K2, K3, K7 and their int8-cache forms K4, K5, K7-q8: causal prefill,
decode and shared-prefix decode attention — the wrappers of
``csrc/causal_attention.cu``, ``csrc/decode_attention.cu`` and
``csrc/decode_attention_q8.cu`` and their twins. K3 and K4 are one
split-KV pass (``csrc/decode_split.cuh``) on the dense and the int8 cache;
:func:`decode_splits` picks its grid from the host-known shapes. K7 and
K7-q8 run the tile pass (``csrc/decode_tile.cuh``) over the shared prefix,
its splits from :func:`prefix_splits`, then the same split-KV pass over
each row's own slots, its splits from :func:`suffix_splits`.

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

import functools

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
# csrc/decode_tile.cuh, the tile pass of K7's prefix and K8's shared runs.
_TILE_KEYS = 64  # kBK: slots a tile; a split of the run is a multiple
_TILE_ROWS = 64  # kRows: (query, head) rows a bf16 block
# csrc/decode_split.cuh, the split-KV pass of K3 and K4.
_SPLIT_CHUNK = 32  # kChunk: slots a stage
_SPLIT_MIN_SPAN = 128  # the floor on slots a split: a chunk for each of 4 warps
_SPLIT_WARPS = 4  # kWarps
_SPLIT_RING_BUDGET = 128 * 1024  # kRingBudget: two stages a warp fit in it
_SM_SMEM = 233472  # shared memory of an H100 SM: 228 KB
_BLOCK_SMEM_RESERVED = 1024  # what the card keeps of it for each resident block
_SMS = 132  # the H100's SMs


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


def _split_stage_bytes(elem_bytes: int, d: int) -> int:
    """``sizeof(Stage)`` of csrc/decode_split.cuh: 32 K rows padded by 16
    bytes, 32 V rows, and two float scales a slot (int8) or one each (the
    dense cache), rounded up to 16 bytes."""
    rows = _SPLIT_CHUNK * ((d * elem_bytes + 16) + d * elem_bytes)
    scales = 2 * 4 * (_SPLIT_CHUNK if elem_bytes == 1 else 1)
    return -(-(rows + scales) // 16) * 16


def decode_split_smem(elem_bytes: int, d: int, g: int) -> int:
    """Dynamic shared memory of a split-KV block (csrc/decode_split.cuh:
    smem_bytes) for a cache of ``elem_bytes``-byte elements (1: int8, 2:
    bf16, 4: float32): each warp's ring of two stages, or one where two
    would pass the ring budget; q; each warp's probabilities; the ring's
    barriers."""
    stage = _split_stage_bytes(elem_bytes, d)
    stages = 2 if _SPLIT_WARPS * 2 * stage <= _SPLIT_RING_BUDGET else 1
    return (_SPLIT_WARPS * stages * stage + g * d * 4 + _SPLIT_WARPS * g * _SPLIT_CHUNK * 4
            + _SPLIT_WARPS * stages * 8)


@functools.lru_cache(maxsize=None)
def decode_blocks_per_sm(elem_bytes: int, d: int, g: int) -> int:
    """Split-KV blocks the grid aims to keep on each SM: as many as its
    shared memory holds, at most two (two for the int8 and bf16 caches at
    every shape, one for float32 at D = 128)."""
    smem = decode_split_smem(elem_bytes, d, g)
    return max(1, min(2, _SM_SMEM // (smem + _BLOCK_SMEM_RESERVED)))


@functools.lru_cache(maxsize=None)
def decode_splits(b: int, hkv: int, s_max: int, blocks_per_sm: int = 2) -> tuple[int, int]:
    """(n_split, span) of the split-KV grid (Hkv, B, n_split) of K3 and K4:
    block z of a (row, kv head) reads slots [z * span, (z + 1) * span).

    From the host-known shapes only: valid_len lives on the card and is
    never read here. The span is a whole number of 32-slot chunks, at least
    four (one for each of the block's warps), and short enough that the
    grid holds ``blocks_per_sm`` blocks (:func:`decode_blocks_per_sm`) for
    each of the H100's 132 SMs where the cache is long enough;
    ``n_split * span >= s_max > (n_split - 1) * span``.
    """
    s_max = max(int(s_max), 1)
    target = -(-blocks_per_sm * _SMS // max(1, b * hkv))
    span = max(_SPLIT_MIN_SPAN, (s_max // target) // _SPLIT_CHUNK * _SPLIT_CHUNK)
    return -(-s_max // span), span


@functools.lru_cache(maxsize=None)
def suffix_splits(b: int, hkv: int, length: int, blocks_per_sm: int = 2) -> tuple[int, int]:
    """(n_split, span) of the split-KV pass over K7's and K7-q8's suffix,
    the ``length`` = S_max - prefix_len slots past the prefix: a sibling of
    :func:`decode_splits` that picks the count first — one split for every
    128 slots at most, and no more than ``blocks_per_sm`` blocks for each
    of the H100's 132 SMs — then the span, the length over that count
    rounded up to 32 slots. A fan-out's suffix is short (its decode budget),
    so it takes one split, whose blocks merge the prefix's partials
    themselves: no merge launch. From the host-known shapes only."""
    length = max(int(length), 1)
    target = -(-blocks_per_sm * _SMS // max(1, b * hkv))
    n = max(1, min(target, length // _SPLIT_MIN_SPAN))
    span = -(-length // (n * _SPLIT_CHUNK)) * _SPLIT_CHUNK
    return -(-length // span), span


def decode_workspace(b: int, h: int, d: int, n_split: int) -> int:
    """Float32 elements of the split-KV workspace: each split's max and sum
    and unnormalised output for every (row, query head); none for one
    split."""
    return n_split * b * h * (d + 2) if n_split > 1 else 0


def prefix_splits(b: int, h: int, hkv: int, prefix_len: int) -> tuple[int, int]:
    """(n_pre, pre_span) of K7's prefix pass (csrc/decode_tile.cuh, grid
    (Hkv, row tiles, n_pre)): split z reads prefix slots [z * pre_span,
    (z + 1) * pre_span). The span is the fewest whole 64-slot tiles that
    keep each (kv head, row tile) to ceil(132 / their count) splits, about
    one wave over the H100's 132 SMs (row tiles counted at 64 (row, head)
    rows a block); (0, 64) without a prefix. From the host-known shapes
    only."""
    if prefix_len <= 0:
        return 0, _TILE_KEYS
    tiles = -(-b * (h // hkv) // _TILE_ROWS)
    target = -(-_SMS // (hkv * tiles))
    span = max(_TILE_KEYS, -(-prefix_len // (target * _TILE_KEYS)) * _TILE_KEYS)
    return -(-prefix_len // span), span


def shared_prefix_workspace(b: int, h: int, d: int, n_pre: int, n_split: int) -> int:
    """Float32 elements of K7's workspace: the prefix splits' partials
    (max, sum, unnormalised output for every (row, query head)), then the
    suffix's split-KV partials (none for one split, whose blocks merge the
    prefix's partials themselves)."""
    return (n_pre + (n_split if n_split > 1 else 0)) * b * h * (d + 2)


def _launch_shared_prefix(entry, q, cache, valid_len, prefix_len, dims):
    """Launch K7 (``cache`` (k, v)) or K7-q8 (``cache`` (k_q, k_scale, v_q,
    v_scale)): the prefix's and the suffix's splits from the shapes, one
    workspace for both, the C entry point. Returns (out, the entry's
    return code)."""
    b, s_max, h, hkv, d = dims
    if not 0 <= prefix_len <= s_max:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {s_max}]")
    n_pre, pre_span = prefix_splits(b, h, hkv, prefix_len)
    n_split, span = suffix_splits(
        b, hkv, s_max - prefix_len, decode_blocks_per_sm(cache[0].element_size(), d, h // hkv))
    n_ws = shared_prefix_workspace(b, h, d, n_pre, n_split)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    out = torch.empty_like(q)
    rc = entry(
        q.data_ptr(), *(t.data_ptr() for t in cache), valid_len.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(),
        b, s_max, h, hkv, d, prefix_len, n_pre, pre_span, n_split, span, float(d ** -0.5),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, rc


def _launch_split(name, entry, q, cache, valid_len, dims):
    """Launch K3 (``cache`` (k, v)) or K4 (``cache`` (k_q, k_scale, v_q,
    v_scale)) on the card: the split from the shapes, the workspace, the C
    entry point."""
    b, s_max, h, hkv, d = dims
    k, v = cache[0], cache[-2 if len(cache) == 4 else 1]
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name} needs the K and V caches 16-byte aligned")
    n_split, span = decode_splits(
        b, hkv, s_max, decode_blocks_per_sm(k.element_size(), d, h // hkv))
    n_ws = decode_workspace(b, h, d, n_split)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    out = torch.empty_like(q)
    rc = entry(
        q.data_ptr(), *(t.data_ptr() for t in cache), valid_len.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(),
        b, s_max, h, hkv, d, n_split, span, float(d ** -0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, name)
    return out


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
    twin; CUDA tensors launch the split-KV pass (its grid from
    :func:`decode_splits`; the caches must be 16-byte aligned, as a
    layer's view of a stacked cache is only where its offset is).
    """
    if not q.is_cuda:
        return flash_decode_attention_plain(q, k_cache, v_cache, valid_len)
    dims = _check_decode("flash_decode_attention", q, k_cache, v_cache, valid_len)
    out = _launch_split("decode_attention", build.load_library().lct_decode_attention,
                        q, (k_cache, v_cache), valid_len, dims)
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
    tensors launch the kernel: the tile pass over the prefix
    (:func:`prefix_splits`), then the split-KV pass over the rows' own
    slots (:func:`suffix_splits` over S_max - prefix_len), which merges
    both; the caches must be 16-byte aligned.
    """
    prefix_len = int(prefix_len)
    if not q.is_cuda:
        return flash_decode_attention_shared_prefix_plain(
            q, k_cache, v_cache, valid_len, prefix_len
        )
    b, s_max, h, hkv, d = _check_decode(
        "flash_decode_attention_shared_prefix", q, k_cache, v_cache, valid_len
    )
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode_attention_shared_prefix needs the caches 16-byte aligned")
    out, rc = _launch_shared_prefix(
        build.load_library().lct_shared_prefix_attention, q, (k_cache, v_cache), valid_len,
        prefix_len, (b, s_max, h, hkv, d))
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
    dims = _check_decode_q8(name, q, k_q, k_scale, v_q, v_scale, valid_len)
    lib = build.load_library()
    if prefix_len is None:
        return _launch_split("decode_attention_q8", lib.lct_decode_attention_q8,
                             q, (k_q, k_scale, v_q, v_scale), valid_len, dims)
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError(f"{name} needs the K and V caches 16-byte aligned")
    out, rc = _launch_shared_prefix(lib.lct_shared_prefix_attention_q8, q,
                                    (k_q, k_scale, v_q, v_scale), valid_len, prefix_len, dims)
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
    tensors launch the kernel, as :func:`flash_decode_attention_shared_prefix`
    does."""
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
