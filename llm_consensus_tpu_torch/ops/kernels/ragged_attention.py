"""K8: ragged paged attention over the serving page pool — the wrapper of
``csrc/ragged_paged_attention.cu``, its plain twin and the thin wrappers
of the pre-ragged family.

Replaces ``llm_consensus_tpu/ops/pallas/attention.py``'s
``ragged_paged_attention`` (and through it ``paged_decode_attention`` and
``paged_decode_attention_grouped``). One call serves decode rows (one
query each, or NQ verify queries), one optional prefill-chunk row and
shared-prefix groups, with an optional sliding window; the source note of
the ``.cu`` file says what bounds it on the card and how it is built.
Layouts are the JAX package's: q [B, H, D] or [B, NQ, H, D], the pool
[n_pages, page, Hkv, D], page_table [B, P] int32, valid_len [B].

The twin :func:`ragged_paged_attention_plain` follows the kernel's
decomposition — group partials over each group's shared run read through
its representative's table, per-row partials from ``shared_start``, then
the log-sum-exp merge — so it gives the kernel's zeros for a dead row
where :func:`~llm_consensus_tpu_torch.ops.attention.
ragged_paged_attention_reference` averages the row's table.
"""

from __future__ import annotations

import torch

from llm_consensus_tpu_torch.ops.attention import _NEG_INF, merge_decode_partials
from llm_consensus_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (query, pool) types the kernel is built for: one type, or float32
# queries over the bfloat16 serving pool.
_TYPE_PAIRS = {
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),
}
_HEAD_DIMS = (16, 32, 64, 128)
_GROUPS = (1, 2, 4, 8)
_MAX_ROWS = 256  # csrc/ragged_paged_attention.cu: kMaxRows
_SPLIT = 64  # csrc/ragged_paged_attention.cu: kSplit


def _partial(scores, mask, v):
    """(m, l, o) over one masked slot range. scores [R, Hkv, Q, S]
    float32; mask broadcastable to it; v [R, S, Hkv, D]. o is normalized
    (zeros where the range is empty)."""
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("rkqs,rskd->rkqd", p, v.float())
    return m, l, acc / torch.clamp(l, min=1e-30)


def _gather(pool, tables):
    """[R, P] tables -> [R, P * page, Hkv, D] K or V out of the pool."""
    r = tables.shape[0]
    return pool[tables.long()].reshape(r, -1, *pool.shape[2:])


def ragged_paged_attention_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    q_chunk: torch.Tensor | None = None,
    chunk_table: torch.Tensor | None = None,
    chunk_start=None,
    groups: tuple | None = None,
    window: int = 0,
):
    """The plain PyTorch twin of K8 (same arguments and returns as
    :func:`ragged_paged_attention`)."""
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    b, nq, h, d = q4.shape
    hkv = k_pool.shape[2]
    g = h // hkv
    scale = d**-0.5
    dev = q.device
    # Queries [B, Hkv, NQ * G, D], (nq, g)-ordered; position of each.
    qg = q4.float().reshape(b, nq, hkv, g, d).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(b, hkv, nq * g, d) * scale
    valid = valid_len.to(device=dev, dtype=torch.int64)
    qi = torch.arange(nq, device=dev).repeat_interleave(g)  # [NQ * G]
    qpos = valid[:, None] - nq + qi[None, :]  # [B, NQ * G]
    k_seq = _gather(k_pool, page_table)
    v_seq = _gather(v_pool, page_table)
    slot = torch.arange(k_seq.shape[1], device=dev)
    scores = torch.einsum("bkqd,bskd->bkqs", qg, k_seq.float())
    if groups is not None:
        gid, rep, gend, sstart = (t.to(device=dev, dtype=torch.int64) for t in groups)
    else:
        sstart = torch.zeros((b,), dtype=torch.int64, device=dev)
    # Each row's own walk: ragged causal, from shared_start, the window.
    mask = (slot[None, None, :] <= qpos[:, :, None]) & (
        slot[None, None, :] >= sstart[:, None, None]
    )
    if window > 0:
        mask &= slot[None, None, :] > qpos[:, :, None] - window
    part = _partial(scores, mask[:, None], v_seq)
    if groups is not None:
        # Each member against its group's shared run [0, group_end),
        # read through the representative's table.
        gc = gid.clamp(min=0)
        kg = _gather(k_pool, page_table[rep[gc]])
        vg = _gather(v_pool, page_table[rep[gc]])
        scores_g = torch.einsum("bkqd,bskd->bkqs", qg, kg.float())
        mask_g = (gid >= 0)[:, None, None] & (
            slot[None, None, :] < gend[gc][:, None, None]
        )
        if window > 0:
            mask_g = mask_g & (slot[None, None, :] >= qpos[:, :, None] + 1 - window)
        part_g = _partial(scores_g, mask_g[:, None], vg)
        o = merge_decode_partials(*part_g, *part)
    else:
        o = part[2]
    out = o.reshape(b, hkv, nq, g, d).permute(0, 2, 1, 3, 4).reshape(b, nq, h, d)
    out = out.to(q.dtype)
    if squeeze:
        out = out[:, 0]
    if q_chunk is None:
        return out
    c = q_chunk.shape[0]
    qc = q_chunk.float().reshape(c, hkv, g, d).permute(1, 0, 2, 3)
    qc = qc.reshape(1, hkv, c * g, d) * scale
    kc = _gather(k_pool, chunk_table[None])
    vc = _gather(v_pool, chunk_table[None])
    cpos = int(chunk_start) + torch.arange(c, device=dev).repeat_interleave(g)
    slot_c = torch.arange(kc.shape[1], device=dev)
    mask_c = slot_c[None, :] <= cpos[:, None]
    if window > 0:
        mask_c &= slot_c[None, :] > cpos[:, None] - window
    scores_c = torch.einsum("bkqd,bskd->bkqs", qc, kc.float())
    oc = _partial(scores_c, mask_c[None, None], vc)[2]
    out_chunk = (
        oc.reshape(hkv, c, g, d).permute(1, 0, 2, 3).reshape(c, h, d).to(q.dtype)
    )
    return out, out_chunk


def _check_int(name, t, shape):
    if (
        t.dtype != torch.int32
        or tuple(t.shape) != tuple(shape)
        or not t.is_cuda
        or not t.is_contiguous()
    ):
        raise ValueError(
            f"ragged_paged_attention: {name} must be a contiguous int32 "
            f"{list(shape)} tensor on the card, got {t.dtype} {list(t.shape)}"
        )


def ragged_paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    q_chunk: torch.Tensor | None = None,
    chunk_table: torch.Tensor | None = None,
    chunk_start=None,
    groups: tuple | None = None,
    window: int = 0,
):
    """Mixed prefill + decode attention over the page pool — K8.

    q: [B, H, D] decode-row queries, or [B, NQ, H, D] verify rows (row
    b's queries at positions ``valid_len[b] - NQ + i``, their K/V already
    written); k_pool/v_pool: [n_pages, page, Hkv, D] in q's type or
    bfloat16; page_table: [B, P] int32; valid_len: [B] int32 tokens
    readable per row.

    ``q_chunk`` [C, H, D] adds ONE prefill-chunk row: C queries at
    absolute positions ``chunk_start + i`` (an int), walking
    ``chunk_table`` [P] (the chunk's K/V already written through it).
    ``groups`` = (group_id [B] (-1 ungrouped), group_rep [Gm], group_end
    [Gm] tokens, shared_start [B]): rows sharing a prefix page run read
    it once per group; each row's own walk starts at ``shared_start``.
    ``window`` > 0 applies sliding-window masking to every row kind.
    Returns out_dec shaped like q (and out_chunk [C, H, D] when
    ``q_chunk``), in q's dtype.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (up
    to three launches: group pass, decode rows, chunk row), counted once
    per call in ``ragged_paged_attention.launches``.
    """
    if not q.is_cuda:
        return ragged_paged_attention_plain(
            q, k_pool, v_pool, page_table, valid_len, q_chunk=q_chunk,
            chunk_table=chunk_table, chunk_start=chunk_start, groups=groups,
            window=window,
        )
    squeeze = q.dim() == 3
    b, nq, h, d = (q.shape[0], 1, *q.shape[1:]) if squeeze else q.shape
    n_pages, pg, hkv, _ = k_pool.shape
    p_per = page_table.shape[1]
    if (q.dtype, k_pool.dtype) not in _TYPE_PAIRS:
        raise TypeError(
            "ragged_paged_attention takes float32 or bfloat16 queries over a "
            f"pool of their type or bfloat16, got {q.dtype} over {k_pool.dtype}"
        )
    for t, dt in ((q, q.dtype), (k_pool, k_pool.dtype), (v_pool, k_pool.dtype)) + (
        () if q_chunk is None else ((q_chunk, q.dtype),)
    ):
        if t.dtype != dt or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"ragged_paged_attention needs contiguous {q.dtype} q and q_chunk "
                f"and {k_pool.dtype} pools on the card"
            )
    if (
        v_pool.shape != k_pool.shape
        or k_pool.shape[3] != d
        or h % hkv
        or h // hkv not in _GROUPS
        or d not in _HEAD_DIMS
        or b > _MAX_ROWS
    ):
        raise ValueError(
            f"ragged_paged_attention: bad shapes q {list(q.shape)} pool "
            f"{list(k_pool.shape)} (G in {_GROUPS}, D in {_HEAD_DIMS}, "
            f"B <= {_MAX_ROWS})"
        )
    _check_int("page_table", page_table, (b, p_per))
    _check_int("valid_len", valid_len, (b,))
    c = 0
    if q_chunk is not None:
        c = q_chunk.shape[0]
        if q_chunk.shape != (c, h, d):
            raise ValueError(f"q_chunk must be [C, {h}, {d}], got {list(q_chunk.shape)}")
        _check_int("chunk_table", chunk_table, (p_per,))
        chunk_start = int(chunk_start)
    gm = 0
    gid = rep = gend = sstart = None
    ws = None
    if groups is not None:
        gid, rep, gend, sstart = groups
        gm = rep.shape[0]
        _check_int("group_id", gid, (b,))
        _check_int("group_rep", rep, (gm,))
        _check_int("group_end", gend, (gm,))
        _check_int("shared_start", sstart, (b,))
        n_split = -(-(p_per * pg) // _SPLIT)
        ws = torch.empty(
            max(1, n_split * b * nq * h * (d + 2)), dtype=torch.float32, device=q.device
        )
    out = torch.empty_like(q)
    out_chunk = None if q_chunk is None else torch.empty_like(q_chunk)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load_library()
    rc = lib.lct_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        valid_len.data_ptr(), ptr(q_chunk), ptr(chunk_table), ptr(gid), ptr(rep),
        ptr(gend), ptr(sstart), out.data_ptr(), ptr(out_chunk), ptr(ws),
        b, nq, h, hkv, d, pg, p_per, c, chunk_start or 0, gm, int(window),
        float(d**-0.5), _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out if q_chunk is None else (out, out_chunk)


ragged_paged_attention.launches = 0


def _sharded(attend, mesh, q, k_pool, v_pool, page_table, valid_len, *, q_chunk,
             chunk_table, chunk_start, groups, window):
    """K9's body over ``attend`` (K8's wrapper or its twin) on this rank's
    shard; see :func:`ragged_paged_attention_sharded`."""
    local_pages = k_pool.shape[0]
    rows = q.shape[0]
    d = mesh.index("data")
    poff = d * local_pages
    # Global page ids -> this shard's pool indices, clamped (NULL and
    # foreign ids appear only where nothing is read or the output is
    # dropped: dead rows, the chunk lane on a shard that does not own it).
    tbl = (page_table - poff).clamp(0, local_pages - 1).to(torch.int32)
    g = None
    if groups is not None:
        gid, rep, gend, sstart = groups
        g = (gid, (rep - d * rows).clamp(0, rows - 1).to(torch.int32), gend, sstart)
    if q_chunk is None:
        return attend(q, k_pool, v_pool, tbl, valid_len, groups=g, window=window)
    ct = (chunk_table - poff).clamp(0, local_pages - 1).to(torch.int32)
    out, out_chunk = attend(
        q, k_pool, v_pool, tbl, valid_len, q_chunk=q_chunk, chunk_table=ct,
        chunk_start=chunk_start, groups=g, window=window,
    )
    # The chunk's first page names its owner shard (the admitting slot's
    # pool); the others folded local pages under the same masks and
    # contribute exact zeros to the sum. The test stays on the device.
    first = chunk_table[0]
    owner = (first >= poff) & (first < poff + local_pages)
    out_chunk = torch.where(owner, out_chunk, torch.zeros_like(out_chunk))
    return out, mesh.sum(out_chunk, "data")


def ragged_paged_attention_sharded_plain(
    mesh,
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    q_chunk: torch.Tensor | None = None,
    chunk_table: torch.Tensor | None = None,
    chunk_start=None,
    groups: tuple | None = None,
    window: int = 0,
):
    """The plain twin of K9: the same wrapper over
    :func:`ragged_paged_attention_plain`."""
    return _sharded(
        ragged_paged_attention_plain, mesh, q, k_pool, v_pool, page_table,
        valid_len, q_chunk=q_chunk, chunk_table=chunk_table,
        chunk_start=chunk_start, groups=groups, window=window,
    )


def ragged_paged_attention_sharded(
    mesh,
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    q_chunk: torch.Tensor | None = None,
    chunk_table: torch.Tensor | None = None,
    chunk_start=None,
    groups: tuple | None = None,
    window: int = 0,
):
    """K9: :func:`ragged_paged_attention` on a dp x mp mesh, one rank's
    shard — the counterpart of ``llm_consensus_tpu/ops/pallas/
    attention.py``'s ``ragged_paged_attention_sharded`` (K8 under
    ``shard_map``).

    Each rank passes its own shard: q rows [B/dp, (NQ,) H/mp, D]; the pool
    [n_pages/dp, page, Hkv/mp, D] (pages of data shard d are the global
    ids [d * n_pages/dp, (d + 1) * n_pages/dp)); its rows' tables (GLOBAL
    page ids) and lengths; the chunk lane (q_chunk [C, H/mp, D], its
    global table, its start) replicated over ``data``; ``groups`` with
    group_id and shared_start of its rows, group_rep (GLOBAL row indices)
    and group_end replicated. Outputs are this rank's: out rows [B/dp, ...]
    and, with a chunk, the chunk's [C, H/mp, D], the same on every data
    shard.

    What it does: rebases the global page ids of the tables and the chunk
    table to local pool indices (``id - d * local_pages``, clamped, as the
    JAX wrapper does); rebases ``group_rep`` to a local row the same way
    (groups never span shards: one prefix registry per data shard), as
    the JAX wrapper does, rather than passing only the groups with local
    members. A group with no member on this shard costs no reads and
    changes no output: K8's group pass compacts the group's members from
    ``group_id`` and a block with no member query returns before it reads
    a page (``csrc/ragged_paged_attention.cu``, the group pass), and the
    twin masks such a group out. Then K8 runs on the local shard, the
    chunk output is zeroed on the shards that do not own the chunk (the
    owner is the shard whose range holds ``chunk_table[0]``) and summed
    over ``data``.

    No CUDA source of its own: the rebase is three elementwise ops, done
    outside the kernel as in JAX (where they sit outside the
    ``pallas_call``), as K5 is K4 on a view. CUDA tensors launch K8 (which
    counts its own launches) and count one launch of K9 per call in
    ``ragged_paged_attention_sharded.launches``; CPU tensors take the twin
    (:func:`ragged_paged_attention_sharded_plain`).
    """
    kw = dict(q_chunk=q_chunk, chunk_table=chunk_table, chunk_start=chunk_start,
              groups=groups, window=window)
    if not q.is_cuda:
        return ragged_paged_attention_sharded_plain(
            mesh, q, k_pool, v_pool, page_table, valid_len, **kw
        )
    out = _sharded(ragged_paged_attention, mesh, q, k_pool, v_pool, page_table,
                   valid_len, **kw)
    ragged_paged_attention_sharded.launches += 1
    return out


ragged_paged_attention_sharded.launches = 0


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    valid_len: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention through the page table: the all-decode,
    ungrouped case of :func:`ragged_paged_attention`."""
    return ragged_paged_attention(
        q, k_pool, v_pool, page_table, valid_len, window=window
    )


def paged_decode_attention_grouped(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    valid_len: torch.Tensor,
    group_id: torch.Tensor,
    group_rep: torch.Tensor,
    group_pages: torch.Tensor,
    shared_start: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Group-aware paged decode attention, group metadata as built by
    :class:`~llm_consensus_tpu_torch.models.paged_cache.GroupTracker`
    (``group_pages`` in pages). Output-equal to
    :func:`paged_decode_attention`."""
    pg = k_pool.shape[1]
    return ragged_paged_attention(
        q, k_pool, v_pool, page_table, valid_len,
        groups=(group_id, group_rep, (group_pages * pg).to(torch.int32), shared_start),
        window=window,
    )
