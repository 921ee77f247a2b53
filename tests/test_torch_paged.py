"""The port's paged cache, K8 twin and paged steps against the JAX
package's, on the same numpy inputs.

- Host side: ``PagePool``, ``PrefixRegistry`` (match, register, evict,
  the boundary-copy report) and ``GroupTracker`` driven through the same
  operation sequences must end in the same states.
- K8: ``ragged_paged_attention_plain`` (the twin the wrapper takes for CPU
  tensors) against the JAX Pallas ``ragged_paged_attention`` in interpret
  mode and against ``ragged_paged_attention_reference``, float32, within
  1e-5 (the same arithmetic summed in another order). Dead rows (length
  0) give zeros in both kernels; the reference averages their table, so
  only live rows are held against it.
- The paged steps on ``test-tiny`` through ``params_from_jax``: float32
  logits of live rows and the pool's real pages within 1e-5, identical
  page tables and lengths. Idle rows attend over nothing here (the JAX
  package reads the NULL page for them); their outputs are discarded.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.models import paged_cache as jpc
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu.ops.attention import ragged_paged_attention_reference as j_ref
from llm_consensus_tpu.ops.pallas.attention import ragged_paged_attention as j_ragged
from llm_consensus_tpu_torch.models import paged_cache as tpc
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.ops import attention as t_attn
from llm_consensus_tpu_torch.ops import kernels
from llm_consensus_tpu_torch.ops.kernels import ragged_attention as kr

import torch_kernel_emulation as emu  # tests/: the split-KV and tile passes' arithmetic

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# Host side: pool, registry, group tracker
# ---------------------------------------------------------------------------


def _registry_state(reg, pool, ids_list):
    return (
        pool.available,
        pool.held,
        len(reg),
        reg.reclaimable_pages(),
        (reg.lookups, reg.hits, reg.pages_shared, reg.pages_copied, reg.evictions),
        [reg.probe(ids)[1] for ids in ids_list],
    )


def _drive_registry(mod, ops_log):
    """One scripted admission/retirement sequence over a pool of 12 pages
    of 4 tokens; returns every observable result."""
    pool = mod.PagePool(range(1, 13))
    reg = mod.PrefixRegistry(pool, 4)
    header = [5, 6, 7, 8, 9, 10, 11, 12, 13]
    prompts = [
        header + [20, 21, 22],
        header + [30, 31],
        [5, 6, 7, 8, 9, 10, 99, 98, 97, 96],  # diverges inside page 2
        [1, 2, 3],
    ]
    out = []
    held = []
    for ids in prompts:
        m = reg.match(ids, min_boundary=2)
        out.append(("match", m.pages, m.shared_tokens, m.boundary_common,
                    m.boundary_page is not None))
        need = -(-len(ids) // 4) - len(m.pages)
        new = pool.alloc(need)
        pages = m.pages + new
        reg.record_commit(m, copied=m.boundary_page is not None)
        created = reg.register(ids, pages)
        for node, end in created:
            reg.mark_ready(node)
            out.append(("created", end, reg.chain_tokens(node)))
        held.append(pages)
        out.append(("state", _registry_state(reg, pool, prompts)))
    for pages in held[:2]:  # two retirements
        for p in pages:
            pool.release(p)
    out.append(("state", _registry_state(reg, pool, prompts)))
    out.append(("evict", reg.evict(3)))
    out.append(("state", _registry_state(reg, pool, prompts)))
    out.append(("evict_all", reg.evict(100)))
    out.append(("state", _registry_state(reg, pool, prompts)))
    out.append(("chain_key", mod.prefix_chain_key(prompts[0], 4)))
    with pytest.raises(RuntimeError):
        pool.alloc(1000)
    with pytest.raises(ValueError):
        pool.release(999)
    ops_log.append(out)
    return out


def test_page_pool_and_prefix_registry_match_jax():
    log = []
    got = _drive_registry(tpc, log)
    want = _drive_registry(jpc, log)
    assert got == want
    # The scenario reaches every branch it names.
    kinds = {e[0] for e in got}
    assert {"match", "created", "evict", "evict_all"} <= kinds
    assert any(e[0] == "match" and e[3] > 0 and e[4] for e in got)  # boundary copy
    assert any(e[0] == "match" and e[1] for e in got)  # full-page share


@pytest.mark.parametrize("max_groups", [None, 1])
def test_group_tracker_matches_jax(max_groups):
    seqs = {0: [3, 4, 5], 1: [3, 4, 9], 2: [3, 4], 3: [7], 4: [7, 8], 5: [11], 6: []}
    jg = jpc.GroupTracker(8, 16, max_groups)
    tg = tpc.GroupTracker(8, 16, max_groups)
    for step in range(3):
        for s, run in seqs.items():
            jg.add(s, run)
            tg.add(s, run)
        if step == 1:
            jg.remove(1)
            tg.remove(1)
        if step == 2:
            for s in (3, 4):
                jg.remove(s)
                tg.remove(s)
        ja, ta = jg.arrays(), tg.arrays()
        assert (ja is None) == (ta is None)
        if ja is not None:
            for f in ("group_id", "group_rep", "group_pages", "shared_start"):
                np.testing.assert_array_equal(getattr(ta, f).numpy(), np.asarray(getattr(ja, f)))
        assert (tg.saved_tokens_per_step, tg.largest_group, tg.peak_group) == (
            jg.saved_tokens_per_step, jg.largest_group, jg.peak_group)
        assert tg.stream_buckets() == jg.stream_buckets()
    for s in list(seqs):
        jg.remove(s)
        tg.remove(s)
    assert tg.arrays() is None and jg.arrays() is None


def test_device_cache_ops_match_jax():
    cfg = get_config("test-tiny")
    jcache = jpc.PagedKVCache.create(j_get_config("test-tiny"), 10, 4, 3, 4, jnp.float32)
    tcache = tpc.PagedKVCache.create(cfg, 10, 4, 3, 4, torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    L, hkv, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    table = np.array([2, 5, 7, 0], np.int32)
    jcache = jpc.assign_pages(jcache, jnp.int32(1), jnp.asarray(table))
    tpc.assign_pages(tcache, 1, table)
    kv = rng.standard_normal((2, L, 8, hkv, d)).astype(np.float32)
    jcache = jpc.write_prefill_kv(jcache, jnp.int32(1), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                  jnp.int32(6))
    tpc.write_prefill_kv(tcache, 1, _t(kv[0]), _t(kv[1]), 6)
    new = rng.standard_normal((2, L, 2, hkv, d)).astype(np.float32)
    seqs = np.array([1, 1], np.int32)
    for i in range(2):
        jcache = jpc.write_decode_kv(jcache, jnp.asarray(seqs[i:i + 1]),
                                     jnp.asarray(new[0][:, i:i + 1]), jnp.asarray(new[1][:, i:i + 1]))
        tpc.write_decode_kv(tcache, _t(seqs[i:i + 1]), _t(new[0][:, i:i + 1]), _t(new[1][:, i:i + 1]))
    jcache = jpc.copy_page(jcache, jnp.int32(5), jnp.int32(9))
    tpc.copy_page(tcache, 5, 9)
    jcache = jpc.install_seq(jcache, jnp.int32(2), jnp.asarray(table[::-1].copy()), jnp.int32(3))
    tpc.install_seq(tcache, 2, table[::-1].copy(), 3)
    jk, jv = jpc.gather_seq_kv(jcache, jnp.asarray([1, 2]))
    tk, tv = tpc.gather_seq_kv(tcache, torch.tensor([1, 2]))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jcache = jpc.release_seq(jcache, jnp.int32(1))
    tpc.release_seq(tcache, 1)
    np.testing.assert_array_equal(tcache.page_table.numpy(), np.asarray(jcache.page_table))
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))
    assert (tcache.page_size, tcache.n_pages, tcache.max_seqs, tcache.pages_per_seq) == (
        jcache.page_size, jcache.n_pages, jcache.max_seqs, jcache.pages_per_seq)


# ---------------------------------------------------------------------------
# K8: the twin against the JAX kernel (interpret mode) and the reference
# ---------------------------------------------------------------------------


def _k8_case(seed, *, b=4, hkv=2, g=3, d=32, pg=8, p_per=6, nq=0, cq=0, cstart=11,
             vl=(13, 1, 40, 23), groups=None, share=(), dead=False):
    rng = np.random.default_rng(seed)
    h = hkv * g
    kp = rng.standard_normal((40, pg, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((40, pg, hkv, d)).astype(np.float32)
    q = rng.standard_normal((b, nq, h, d) if nq else (b, h, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, 40))
    tbl = perm[: b * p_per].reshape(b, p_per).astype(np.int32)
    for r in share:  # rows sharing row 0's first page
        tbl[r, 0] = tbl[0, 0]
    if dead:
        tbl[:] = 0
    ctbl = perm[b * p_per : b * p_per + p_per].astype(np.int32)
    kw = {}
    if cq:
        kw = dict(q_chunk=rng.standard_normal((cq, h, d)).astype(np.float32),
                  chunk_table=ctbl, chunk_start=cstart)
    return kp, vp, q, tbl, np.asarray(vl, np.int32), kw, groups


K8_CASES = {
    "mixed_rows": dict(seed=0, cq=16),
    "mixed_rows_window": dict(seed=0, cq=16, window=9),
    "mqa_single_kv_head": dict(seed=1, hkv=1, g=4, p_per=4, b=3, vl=(7, 30, 12)),
    "grouped_rows_with_chunk": dict(
        seed=2, cq=16, vl=(13, 9, 40, 23), share=(2, 3),
        groups=([0, -1, 0, 0], [0], [8], [8, 0, 8, 8])),
    "grouped_rows_with_chunk_window": dict(
        seed=2, cq=16, vl=(13, 9, 40, 23), share=(2, 3), window=9,
        groups=([0, -1, 0, 0], [0], [8], [8, 0, 8, 8])),
    "one_member_group": dict(
        seed=3, g=2, b=3, p_per=4, vl=(20, 11, 30),
        groups=([-1, 0, -1], [1], [8], [0, 8, 0])),
    "all_prefill_dead_decode_rows": dict(seed=4, g=2, b=3, p_per=4, cq=8, cstart=0,
                                         vl=(0, 0, 0), dead=True),
    "verify_rows_nq4": dict(seed=5, nq=4, vl=(13, 4, 40, 23)),
    "verify_rows_nq3_grouped_window": dict(
        seed=6, nq=3, vl=(13, 9, 40, 23), share=(2, 3), window=11,
        groups=([0, -1, 0, 0], [0], [8], [8, 0, 8, 8])),
}


@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_k8_twin_matches_jax_kernel_and_reference(name):
    spec = dict(K8_CASES[name])
    window = spec.pop("window", 0)
    kp, vp, q, tbl, vl, kw, groups = _k8_case(**spec)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: (v if k == "chunk_start" else _t(v)) for k, v in kw.items()}
    jgroups = tgroups = None
    if groups is not None:
        jgroups = tuple(jnp.asarray(np.asarray(x, np.int32)) for x in groups)
        tgroups = tuple(torch.tensor(x, dtype=torch.int32) for x in groups)
    got = kr.ragged_paged_attention_plain(
        _t(q), _t(kp), _t(vp), _t(tbl), _t(vl), groups=tgroups, window=window, **tkw)
    # The wrapper on CPU tensors is the twin, and launches nothing.
    kernels.reset_launch_counts()
    via = kernels.ragged_paged_attention(
        _t(q), _t(kp), _t(vp), _t(tbl), _t(vl), groups=tgroups, window=window, **tkw)
    assert kernels.ragged_paged_attention.launches == 0
    jk = j_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                  jnp.asarray(vl), groups=jgroups, window=window, interpret=True, **jkw)
    ref = j_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                jnp.asarray(vl), window=window, **jkw)
    ref_t = t_attn.ragged_paged_attention_reference(
        _t(q), _t(kp), _t(vp), _t(tbl), _t(vl), window=window, **tkw)
    if not kw:
        got, via, jk, ref, ref_t = (got,), (via,), (jk,), (ref,), (ref_t,)
    live = vl > 0
    for i, (a, v_, k_, r_, rt) in enumerate(zip(got, via, jk, ref, ref_t)):
        a = a.numpy()
        np.testing.assert_array_equal(a, v_.numpy())
        np.testing.assert_allclose(a, np.asarray(k_), **TOL)
        if i == 0:  # decode rows: the reference only where the row is live
            a, r_, rt = a[live], np.asarray(r_)[live], rt.numpy()[live]
        np.testing.assert_allclose(a, np.asarray(r_), **TOL)
        np.testing.assert_allclose(rt, np.asarray(r_), **TOL)
        assert np.isfinite(a).all()


def _k8_torch(kp, vp, q, tbl, vl, kw, groups):
    tkw = {k: (v if k == "chunk_start" else _t(v)) for k, v in kw.items()}
    tgroups = None if groups is None else tuple(
        torch.tensor(x, dtype=torch.int32) for x in groups)
    return (_t(q), _t(kp), _t(vp), _t(tbl), _t(vl)), tkw, tgroups


@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_k8_launches_emulated_match_twin_and_jax_kernel(name):
    """K8's launches as the card runs them (tests/torch_kernel_emulation.
    ragged): the group pass's partials over 64-slot splits of the run, the
    decode rows on the split-KV pass from their first slot (shared start,
    window edge) with the group partials merged first, verify and chunk
    rows on the tile pass; against the twin and the Pallas kernel in
    interpret mode, 1e-5."""
    spec = dict(K8_CASES[name])
    window = spec.pop("window", 0)
    kp, vp, q, tbl, vl, kw, groups = _k8_case(**spec)
    args, tkw, tgroups = _k8_torch(kp, vp, q, tbl, vl, kw, groups)
    got = emu.ragged(*args, groups=tgroups, window=window, **tkw)
    twin = kr.ragged_paged_attention_plain(*args, groups=tgroups, window=window, **tkw)
    jgroups = None if groups is None else tuple(
        jnp.asarray(np.asarray(x, np.int32)) for x in groups)
    jk = j_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                  jnp.asarray(vl), groups=jgroups, window=window, interpret=True,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    if not kw:
        got, twin, jk = (got,), (twin,), (jk,)
    for a, t, k in zip(got, twin, jk):
        np.testing.assert_allclose(a.numpy(), t.numpy(), **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(k), **TOL)


def test_k8_split_rule_and_workspace():
    """K8's decode rows on the split-KV pass: 128-slot splits (one chunk a
    warp) covering the table's width once, whatever B is (K9's shards split
    a row where the unsharded K8 does); the workspace the wrapper allocates
    is the C entry point's: the group partials for every 64-slot split of
    the table, then the decode splits' (none for one split or verify rows)."""
    src = (ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc/ragged_paged_attention.cu").read_text()
    assert "(n_x * B * NQ + (NQ == 1 && n_split >\n// 1 ? n_split * B : 0)) * H * (D + 2)" in src
    assert "constexpr int kGroupSpan = 64;" in src
    for slots in (8, 48, 128, 512, 2048, 4096):
        n, span = kr.ragged_splits(slots)
        assert span == 128 and n * span >= slots > (n - 1) * span
        n_x = -(-slots // 64)
        for b, nq, groups in ((16, 1, True), (16, 1, False), (4, 3, True)):
            want = (n_x * b * nq * groups + (n * b if nq == 1 and n > 1 else 0)) * 16 * 130
            assert kr.ragged_workspace(b, nq, 16, 128, slots, groups, n) == want


# Rows long enough for several splits of the decode rows' split-KV pass
# (a 512-slot table: 4 splits of 128 at B = 1), windows whose edge falls
# inside a split, shared starts and group ends that are not multiples of
# 32, verify rows with groups.
K8_LONG_CASES = {
    "one_row_the_whole_table": dict(b=1, vl=(512,)),
    "window_inside_a_split": dict(b=2, vl=(400, 300), window=77),
    "shared_starts_and_group_ends_off_32": dict(
        b=4, vl=(300, 111, 280, 512), groups=([0, -1, 0, 0], [0], [88], [88, 0, 88, 88])),
    "verify_rows_with_groups": dict(
        b=3, nq=4, vl=(300, 200, 130), window=100,
        groups=([0, 0, -1], [0], [72], [72, 72, 0])),
}


@pytest.mark.parametrize("name", sorted(K8_LONG_CASES))
def test_k8_long_rows_emulated_match_twin_and_reference(name):
    """As the test above on rows long enough for several splits, against
    the twin and the JAX package's reference (live rows)."""
    spec = dict(K8_LONG_CASES[name])
    window = spec.pop("window", 0)
    rng = np.random.default_rng(len(name))
    b, nq, hkv, g, d, pg, p_per = spec["b"], spec.get("nq", 0), 2, 2, 16, 16, 32
    kp = rng.standard_normal((2 + b * p_per, pg, hkv, d)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    q = rng.standard_normal((b, nq, hkv * g, d) if nq else (b, hkv * g, d)).astype(np.float32)
    tbl = (1 + rng.permutation(b * p_per)).reshape(b, p_per).astype(np.int32)
    groups = spec.get("groups")
    if groups is not None:  # members map the representative's run
        run_pages = -(-groups[2][0] // pg)
        for r, gi in enumerate(groups[0]):
            if gi >= 0:
                tbl[r, :run_pages] = tbl[groups[1][gi], :run_pages]
    vl = np.asarray(spec["vl"], np.int32)
    args, _, tgroups = _k8_torch(kp, vp, q, tbl, vl, {}, groups)
    got = emu.ragged(*args, groups=tgroups, window=window)
    twin = kr.ragged_paged_attention_plain(*args, groups=tgroups, window=window)
    ref = j_ref(*map(jnp.asarray, (q, kp, vp, tbl, vl)), window=window)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_k8_thin_wrappers_match_the_ragged_call():
    kp, vp, q, tbl, vl, _, _ = _k8_case(7, share=(1, 2), vl=(20, 17, 33, 9))
    args = (_t(q), _t(kp), _t(vp), _t(tbl), _t(vl))
    plain = kernels.paged_decode_attention(*args)
    torch.testing.assert_close(plain, kr.ragged_paged_attention_plain(*args), rtol=0, atol=0)
    gid, rep = torch.tensor([0, 0, 0, -1], dtype=torch.int32), torch.tensor([0], dtype=torch.int32)
    gpages = torch.tensor([1], dtype=torch.int32)
    sst = torch.tensor([8, 8, 8, 0], dtype=torch.int32)
    grouped = kernels.paged_decode_attention_grouped(*args, gid, rep, gpages, sst)
    torch.testing.assert_close(grouped, plain, **TOL)


# ---------------------------------------------------------------------------
# The paged steps against the JAX package's, on test-tiny
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("test-tiny")
    params = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, get_config("test-tiny"), tparams


def _same_cache(tcache, jcache):
    """Tables, lengths and every real page. The NULL page holds what idle
    rows write, from attention outputs that are garbage in JAX and zeros
    here (they attend over nothing); nobody reads it."""
    np.testing.assert_array_equal(tcache.page_table.numpy(), np.asarray(jcache.page_table))
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    for t, j in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(np.delete(t.numpy(), tpc.NULL_PAGE, axis=1),
                                   np.delete(np.asarray(j), tpc.NULL_PAGE, axis=1), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_paged_steps_match_jax(tiny, use_pallas):
    """Chunked prefill of two prompts sharing their first page, a grouped
    decode step, then a fused step carrying a third prompt's chunk."""
    jcfg, jparams, tcfg, tparams = tiny
    jcfg, tcfg = jcfg.with_(use_pallas=use_pallas), tcfg.with_(use_pallas=use_pallas)
    pg, n_pages, slots, p_per = 8, 24, 3, 6
    jcache = jpc.PagedKVCache.create(jcfg, n_pages, pg, slots, p_per, jnp.float32)
    tcache = tpc.PagedKVCache.create(tcfg, n_pages, pg, slots, p_per, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    p0 = rng.integers(3, 259, 13).astype(np.int32)
    p1 = np.concatenate([p0[:8], rng.integers(3, 259, 12)]).astype(np.int32)
    p2 = rng.integers(3, 259, 8).astype(np.int32)
    tables = [np.array(t + [0] * (p_per - len(t)), np.int32)
              for t in ([1, 2, 3, 4], [1, 5, 6, 7], [8, 9, 10])]

    def chunk(ids, start, width, table):
        nonlocal jcache
        toks = np.zeros((1, width), np.int32)
        seg = ids[start:start + width]
        toks[0, :len(seg)] = seg
        jh, jcache = jt.prefill_chunk_paged(jcfg, jparams, jnp.asarray(toks),
                                            jnp.asarray(table), jnp.int32(start), jcache)
        th, _ = tt.prefill_chunk_paged(tcfg, tparams, _t(toks), _t(table), start, tcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        return th

    for start in (0, 8):
        h0 = chunk(p0, start, 8, tables[0])
    for start in (8, 16):  # p1 maps p0's first page and starts past it
        h1 = chunk(p1, start, 8, tables[1])
    first = [int(tt.unembed_one(tcfg, tparams, h0[0, 12 - 8]).argmax()),
             int(tt.unembed_one(tcfg, tparams, h1[0, 19 - 16]).argmax())]
    jfirst = [int(jt.unembed_one(jcfg, jparams, jnp.asarray(h0[0, 4].numpy())).argmax()),
              int(jt.unembed_one(jcfg, jparams, jnp.asarray(h1[0, 3].numpy())).argmax())]
    assert first == jfirst
    for i, (ids, tbl) in enumerate(((p0, tables[0]), (p1, tables[1]))):
        jcache = jpc.install_seq(jcache, jnp.int32(i), jnp.asarray(tbl), jnp.int32(len(ids)))
        tpc.install_seq(tcache, i, tbl, len(ids))
    jg, tg = jpc.GroupTracker(slots, pg), tpc.GroupTracker(slots, pg)
    for tr in (jg, tg):
        tr.add(0, tables[0][:13 // pg])
        tr.add(1, tables[1][:20 // pg])
    toks = np.array([[first[0]], [first[1]], [0]], np.int32)
    for _ in range(2):
        jl, jcache = jt.decode_step_paged(jcfg, jparams, jnp.asarray(toks), jcache,
                                          groups=jg.arrays())
        tl, _ = tt.decode_step_paged(tcfg, tparams, _t(toks), tcache, groups=tg.arrays())
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        _same_cache(tcache, jcache)
        toks = tl.argmax(-1).to(torch.int32)[:, None].numpy()
        toks[2] = 0
    ctoks = p2[None]
    jl, jh, jcache = jt.fused_step_paged(jcfg, jparams, jnp.asarray(toks), jcache,
                                         jnp.asarray(ctoks), jnp.asarray(tables[2]),
                                         jnp.int32(0), groups=jg.arrays())
    tl, th, _ = tt.fused_step_paged(tcfg, tparams, _t(toks), tcache, _t(ctoks),
                                    _t(tables[2]), 0, groups=tg.arrays())
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _same_cache(tcache, jcache)


@pytest.mark.parametrize("fused", [False, True])
def test_idle_rows_reach_k8_with_no_length(tiny, monkeypatch, fused):
    """A slot with a NULL table (idle or mid-prefill) reaches K8 with
    valid_len 0 however far its cache length grew, so it reads no page;
    live rows keep length + 1, and every row's cache length advances by
    one as in the JAX package. The live row's logits do not depend on the
    idle rows' lengths."""
    _, _, tcfg, tparams = tiny
    pg, slots, p_per = 8, 3, 6
    seen = []
    real = kernels.ragged_paged_attention

    def spy(q, k_pool, v_pool, page_table, valid_len, **kw):
        seen.append(valid_len.tolist())
        return real(q, k_pool, v_pool, page_table, valid_len, **kw)

    monkeypatch.setattr(kernels, "ragged_paged_attention", spy)
    rng = np.random.default_rng(1)
    toks = _t(rng.integers(3, 259, (slots, 1)).astype(np.int32))
    kv = None
    logits = []
    for idle_len in (0, 300):
        cache = tpc.PagedKVCache.create(tcfg, 12, pg, slots, p_per, torch.float32, "cpu")
        if kv is None:
            kv = [_t(rng.standard_normal(cache.k.shape).astype(np.float32)) for _ in "kv"]
        cache.k.copy_(kv[0])
        cache.v.copy_(kv[1])
        tpc.install_seq(cache, 0, np.array([1, 2, 0, 0, 0, 0], np.int32), 10)
        cache.length[1] = idle_len
        seen.clear()
        if fused:
            out = tt.fused_step_paged(tcfg, tparams, toks, cache, toks[:1, :1].T.contiguous(),
                                      _t(np.array([3, 0, 0, 0, 0, 0], np.int32)), 0)
        else:
            out = tt.decode_step_paged(tcfg, tparams, toks, cache)
        logits.append(out[0][0])
        assert seen == [[11, 0, 0]] * tcfg.n_layers
        assert cache.length.tolist() == [11, idle_len + 1, 1]
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# On the card: K8 against its twin (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_k8_kernel_matches_twin_on_card(cuda, name, q_dtype, kv_dtype):
    spec = dict(K8_CASES[name])
    window = spec.pop("window", 0)
    kp, vp, q, tbl, vl, kw, groups = _k8_case(**spec)

    def on(a, dtype=None):
        return _t(a, dtype).to(cuda).contiguous()

    tkw = {k: (v if k == "chunk_start" else on(v, q_dtype if k == "q_chunk" else None))
           for k, v in kw.items()}
    tgroups = None if groups is None else tuple(
        torch.tensor(x, dtype=torch.int32, device=cuda) for x in groups)
    args = (on(q, q_dtype), on(kp, kv_dtype), on(vp, kv_dtype), on(tbl), on(vl))
    kernels.reset_launch_counts()
    got = kernels.ragged_paged_attention(*args, groups=tgroups, window=window, **tkw)
    assert kernels.ragged_paged_attention.launches == 1
    want = kr.ragged_paged_attention_plain(*args, groups=tgroups, window=window, **tkw)
    tol = 1e-4 if q_dtype == torch.float32 else 2.0**-6
    for a, b in zip(got if kw else (got,), want if kw else (want,)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
