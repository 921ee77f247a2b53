"""The arithmetic of the port's split-KV pass (``csrc/decode_split.cuh``)
and tile pass (``csrc/decode_tile.cuh``), in torch on the CPU, for the
tests of K7, K7-q8 and K8 (``tests/test_torch_ops.py``,
``tests/test_torch_paged.py``).

The CUDA kernels cannot run here. These functions follow their
decomposition step by step — the splits the host's rules pick, each
block's first and last slot, the chunks a warp takes, one online-softmax
update a chunk, the partials kept unnormalised (max, sum, output), the
shared run's partials merged first and then the splits, in order — so that
the tests can hold that decomposition against the twins and the JAX
package's kernels. ``tile_bf16`` follows the tensor-core form of the tile
pass: bf16 scores with exact products, P into P * V as hi + lo bf16, the
int8 cache's bytes as exact bf16, the scale folds.
"""

from __future__ import annotations

import torch

from llm_consensus_tpu_torch.ops.kernels import attention as ka
from llm_consensus_tpu_torch.ops.kernels import ragged_attention as kr

NEG = float("-inf")
SPLIT_CHUNK = 32  # decode_split.cuh: kChunk
SPLIT_WARPS = 4  # decode_split.cuh: kWarps
CC_CHUNK = 32  # decode_tile.cuh: kCcChunk (the float32 tile pass)
MMA_TILE = 64  # decode_tile.cuh: kBK (the bf16 tile pass)


def empty(r: int, d: int):
    return torch.full((r,), NEG), torch.zeros(r), torch.zeros(r, d)


def fold(state, scores, v, mask, v_scale=None):
    """One online-softmax update of (m, l, acc) [R], [R], [R, D] with the
    scores [R, S] of one chunk (masked where ``mask`` is False) and its V
    rows [S, D]; the V scale [S] (int8 cache) folds into the value product
    only."""
    m, l, acc = state
    s = torch.where(mask, scores, torch.tensor(NEG))
    m_new = torch.maximum(m, s.amax(-1))
    u = torch.where(m_new == NEG, 0.0, m_new)
    alpha = torch.exp(m - u)
    p = torch.where(mask, torch.exp(s - u[:, None]), 0.0)
    pv = p if v_scale is None else p * v_scale[None, :]
    return m_new, l * alpha + p.sum(-1), acc * alpha[:, None] + pv @ v


def merge(parts):
    """Partials (m, l, acc) merged by log-sum-exp in the given order: the
    largest max first, then the sums; empty ones (max -inf) skipped."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    u = torch.where(mx == NEG, 0.0, mx)
    tot_l, tot = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        c = torch.where(m == NEG, 0.0, torch.exp(m - u))
        tot_l, tot = tot_l + l * c, tot + acc * c[:, None]
    return mx, tot_l, tot


def normalise(state):
    _, l, acc = state
    return torch.where(l[:, None] > 0, acc / torch.clamp(l[:, None], min=1e-30), 0.0)


def chunked(q, k, v, lo, hi, s_lo, s_hi, chunk, k_scale=None, v_scale=None):
    """The tile pass on the CUDA cores (or one warp's walk): rows q [R, D]
    (already times d^-1/2) over slots [s_lo, s_hi) of k, v [S, D] in chunks
    of ``chunk`` slots from s_lo, row r seeing slots [lo[r], hi[r])."""
    state = empty(q.shape[0], q.shape[1])
    for c0 in range(s_lo, s_hi, chunk):
        c1 = min(s_hi, c0 + chunk)
        slot = torch.arange(c0, c1)
        sc = q @ k[c0:c1].T
        if k_scale is not None:
            sc = sc * k_scale[c0:c1]
        mask = (slot[None, :] >= lo[:, None]) & (slot[None, :] < hi[:, None])
        state = fold(state, sc, v[c0:c1], mask, None if v_scale is None else v_scale[c0:c1])
    return state


def split_pass(q, k, v, first, n, lo0, n_split, span, k_scale=None, v_scale=None):
    """decode_split.cuh for one (row, kv head): q [G, D] (times d^-1/2) over
    k, v [S, D]; split z reads [max(lo0 + z * span, first), min(n, lo0 + (z
    + 1) * span)); warp w of a split takes its chunks w, w + 4, ... of 32
    slots; the warps merge, then each split is one partial. Returns the
    splits' partials in order."""
    g = q.shape[0]
    parts = []
    for z in range(n_split):
        start = lo0 + z * span
        lo, hi = max(start, first), min(n, start + span)
        warps = [empty(g, q.shape[1]) for _ in range(SPLIT_WARPS)]
        if lo < hi:
            chunks = -(-(hi - lo) // SPLIT_CHUNK)
            for c in range(chunks):
                c0 = lo + c * SPLIT_CHUNK
                c1 = min(hi, c0 + SPLIT_CHUNK)
                w = c % SPLIT_WARPS
                sc = q @ k[c0:c1].T
                if k_scale is not None:
                    sc = sc * k_scale[c0:c1]
                warps[w] = fold(warps[w], sc, v[c0:c1], torch.ones_like(sc, dtype=torch.bool),
                                None if v_scale is None else v_scale[c0:c1])
        parts.append(merge(warps))
    return parts


# ---------------------------------------------------------------------------
# K7 and K7-q8: the prefix's tile pass, then the suffix's split-KV pass
# ---------------------------------------------------------------------------


def shared_prefix(q, k, v, valid_len, prefix_len, k_scale=None, v_scale=None, elem_bytes=4):
    """K7 (k, v [B, Hkv, S_max, D], head-major here) or K7-q8 (int8 k, v
    with their scales [B, Hkv, S_max]) on float32 queries q [B, 1, H, D]:
    the prefix splits of :func:`ka.prefix_splits` over row 0's slots, every
    (row, head) a row of the tile pass in 32-slot chunks; each row's own
    slots [prefix_len, valid_len) on the split-KV pass, its grid from
    :func:`ka.suffix_splits` over S_max - prefix_len; the prefix partials
    merged first, then the splits."""
    b, _, h, d = q.shape
    hkv, s_max = k.shape[1], k.shape[2]
    g = h // hkv
    qs = q.float().reshape(b, hkv, g, d) * d**-0.5
    n_pre, pre_span = ka.prefix_splits(b, h, hkv, prefix_len)
    n_split, span = ka.suffix_splits(b, hkv, s_max - prefix_len,
                                     ka.decode_blocks_per_sm(elem_bytes, d, g))
    out = torch.zeros(b, 1, h, d)
    for kvh in range(hkv):
        kk, vv = k[0, kvh].float(), v[0, kvh].float()
        ks = None if k_scale is None else k_scale[0, kvh]
        vs = None if v_scale is None else v_scale[0, kvh]
        rows = qs[:, kvh].reshape(b * g, d)  # (row, head), row-major
        inf = torch.full((b * g,), 1 << 30)
        pre = [chunked(rows, kk, vv, torch.zeros(b * g, dtype=torch.long), inf, z * pre_span,
                       min(prefix_len, (z + 1) * pre_span), CC_CHUNK, ks, vs)
               for z in range(n_pre)]
        for bi in range(b):
            n = min(max(int(valid_len[bi]), 0), s_max)
            own = split_pass(
                qs[bi, kvh], k[bi, kvh].float(), v[bi, kvh].float(), prefix_len, n, prefix_len,
                n_split, span, None if k_scale is None else k_scale[bi, kvh],
                None if v_scale is None else v_scale[bi, kvh])
            sl = slice(bi * g, (bi + 1) * g)
            extras = [(m[sl], l[sl], a[sl]) for m, l, a in pre]
            out[bi, 0, kvh * g:(kvh + 1) * g] = normalise(merge(extras + own))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# K8: group pass, chunk row, decode rows (split-KV) or verify rows
# ---------------------------------------------------------------------------


def ragged(q, k_pool, v_pool, page_table, valid_len, *, q_chunk=None, chunk_table=None,
           chunk_start=None, groups=None, window=0):
    """K8 on float32 queries over a float32 pool, as its launches compute it
    (the same arguments and returns as ``kr.ragged_paged_attention``)."""
    squeeze = q.dim() == 3
    q4 = (q[:, None] if squeeze else q).float()
    b, nq, h, d = q4.shape
    pg, hkv = k_pool.shape[1], k_pool.shape[2]
    p_per = page_table.shape[1]
    slots, g = p_per * pg, h // hkv
    scale = d**-0.5

    def seq(pool, tbl, kvh):  # a table row's slots of one kv head, [slots, D]
        return pool[tbl.long()].reshape(slots, hkv, d)[:, kvh].float()

    valid = [int(x) for x in valid_len]
    gid = rep = gend = sstart = None
    if groups is not None:
        gid, rep, gend, sstart = ([int(x) for x in t] for t in groups)
    span_x = kr._GROUP_SPAN
    n_x = -(-slots // span_x) if groups is not None else 0
    # Group partials: (row, query, head) -> the partials of the splits that
    # cover its group's run, in order.
    extras = {}
    for gi in range(len(rep) if groups is not None else 0):
        ge = min(gend[gi], slots)
        members = [r for r in range(b) if gid[r] == gi]
        for kvh in range(hkv):
            kk, vv = seq(k_pool, page_table[rep[gi]], kvh), seq(v_pool, page_table[rep[gi]], kvh)
            rows = [(r, i, kvh * g + hh) for r in members for i in range(nq) for hh in range(g)]
            if not rows:
                continue
            qr = torch.stack([q4[r, i, hh] for r, i, hh in rows]) * scale
            for z in range(n_x):
                lo, hi = z * span_x, min(ge, (z + 1) * span_x)
                if lo >= hi:
                    continue
                lo_r = torch.tensor([max(lo, valid[r] - nq + i + 1 - window) if window > 0 else lo
                                     for r, i, _ in rows])
                part = chunked(qr, kk, vv, lo_r, torch.full((len(rows),), hi), lo, hi, CC_CHUNK)
                for j, key in enumerate(rows):
                    extras.setdefault(key, []).append(tuple(t[j:j + 1] for t in part))
    out = torch.zeros(b, nq, h, d)
    if nq == 1:
        n_split, span = kr.ragged_splits(slots)
        for r in range(b):
            n = min(max(valid[r], 0), slots)
            first = sstart[r] if sstart is not None else 0
            if window > 0:
                first = max(first, n - window)
            for kvh in range(hkv):
                kk, vv = seq(k_pool, page_table[r], kvh), seq(v_pool, page_table[r], kvh)
                own = split_pass(q4[r, 0, kvh * g:(kvh + 1) * g] * scale, kk, vv, first, n, 0,
                                 n_split, span)
                for hh in range(g):
                    x = extras.get((r, 0, kvh * g + hh), [])
                    parts = x + [tuple(t[hh:hh + 1] for t in p) for p in own]
                    out[r, 0, kvh * g + hh] = normalise(merge(parts))[0]
    else:
        for r in range(b):
            base = max(sstart[r], 0) if sstart is not None else 0
            for kvh in range(hkv):
                kk, vv = seq(k_pool, page_table[r], kvh), seq(v_pool, page_table[r], kvh)
                qr = q4[r, :, kvh * g:(kvh + 1) * g].reshape(nq * g, d) * scale
                pos = torch.tensor([valid[r] - nq + j // g for j in range(nq * g)])
                lo_r = torch.clamp(pos + 1 - window, min=base) if window > 0 else torch.full_like(
                    pos, base)
                hi_r = torch.clamp(pos + 1, max=slots)
                s_lo, s_hi = max(int(lo_r[0]), 0), int(hi_r[-1])
                own = chunked(qr, kk, vv, lo_r, hi_r, s_lo, max(s_hi, s_lo), CC_CHUNK)
                for j in range(nq * g):
                    i, hh = j // g, j % g
                    x = extras.get((r, i, kvh * g + hh), [])
                    out[r, i, kvh * g + hh] = normalise(merge(x + [tuple(t[j:j + 1] for t in own)]))[0]
    out = out.to(q.dtype)
    if squeeze:
        out = out[:, 0]
    if q_chunk is None:
        return out
    c = q_chunk.shape[0]
    out_c = torch.zeros(c, h, d)
    for kvh in range(hkv):
        kk, vv = seq(k_pool, chunk_table, kvh), seq(v_pool, chunk_table, kvh)
        qr = q_chunk[:, kvh * g:(kvh + 1) * g].float().reshape(c * g, d) * scale
        pos = int(chunk_start) + torch.arange(c).repeat_interleave(g)
        lo_r = torch.clamp(pos + 1 - window, min=0) if window > 0 else torch.zeros_like(pos)
        hi_r = torch.clamp(pos + 1, max=slots)
        own = chunked(qr, kk, vv, lo_r, hi_r, int(lo_r[0]), int(hi_r[-1]), CC_CHUNK)
        out_c[:, kvh * g:(kvh + 1) * g] = normalise(own).reshape(c, g, d)
    return out, out_c.to(q_chunk.dtype)


# ---------------------------------------------------------------------------
# The tile pass on the tensor cores (bf16 queries)
# ---------------------------------------------------------------------------


def tile_bf16(q, k, v, lo, hi, s_lo, s_hi, k_scale=None, v_scale=None, split_p=True):
    """The bf16 tile pass over one run: rows q [R, D] bf16 against k, v [S,
    D] (bf16, or int8 values, exact in bf16) in 64-slot tiles from s_lo,
    row r seeing slots [lo[r], hi[r]). Scores q . k in float32 from exact
    products, times d^-1/2 (and the K scale per column); P times the V scale
    per column, then into P * V as hi = bf16(P) plus lo = bf16(P - hi) (or,
    with ``split_p`` False, as bf16(P) alone) with float32 sums; the sum of p
    true. Returns the unnormalised partial (m, l, acc)."""
    d = q.shape[1]
    qf = q.float()
    kb = k.float().to(torch.bfloat16).float()  # int8 values are exact in bf16
    vb = v.float().to(torch.bfloat16).float()
    state = empty(q.shape[0], d)
    for c0 in range(s_lo, s_hi, MMA_TILE):
        c1 = min(s_hi, c0 + MMA_TILE)
        slot = torch.arange(c0, c1)
        sc = (qf @ kb[c0:c1].T) * torch.tensor(d**-0.5, dtype=torch.float32)
        if k_scale is not None:
            sc = sc * k_scale[c0:c1]
        mask = (slot[None, :] >= lo[:, None]) & (slot[None, :] < hi[:, None])
        m, l, acc = state
        s = torch.where(mask, sc, torch.tensor(NEG))
        m_new = torch.maximum(m, s.amax(-1))
        u = torch.where(m_new == NEG, 0.0, m_new)
        alpha = torch.exp(m - u)
        p = torch.where(mask, torch.exp(s - u[:, None]), 0.0)
        pv = p if v_scale is None else p * v_scale[c0:c1][None, :]
        p_hi = pv.to(torch.bfloat16).float()
        acc = acc * alpha[:, None] + p_hi @ vb[c0:c1]
        if split_p:
            acc = acc + (pv - p_hi).to(torch.bfloat16).float() @ vb[c0:c1]
        state = (m_new, l * alpha + p.sum(-1), acc)
    return state
