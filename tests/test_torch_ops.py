"""The port's ops and kernel twins against the JAX package's ops and its
Pallas kernels (interpret mode on the CPU), on the same numpy inputs.

The CUDA kernels themselves cannot run on the CPU; their tests are marked
``cuda`` and skip without a card. On the card they hold each kernel
against its twin. Tolerances:

- float32 twin vs JAX: 2e-5 abs/rel (the same arithmetic, summed in
  another order);
- bfloat16: the twin computes in float32 and rounds once to bf16, so it
  is held against a float32 oracle on the same bf16 inputs within one
  bf16 rounding, 2^-8 relative plus 2^-8 absolute.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_consensus_tpu.ops.pallas.attention as j_pattn
from llm_consensus_tpu.models import cache as j_cache
from llm_consensus_tpu.models.configs import RopeScaling as JRopeScaling
from llm_consensus_tpu.models.transformer import _pallas_blk
from llm_consensus_tpu.ops import activations as j_act
from llm_consensus_tpu.ops import attention as j_attn
from llm_consensus_tpu.ops import norms as j_norms
from llm_consensus_tpu.ops import rope as j_rope
from llm_consensus_tpu.ops.pallas import (
    flash_causal_attention as j_flash_causal,
    flash_decode_attention as j_flash_decode,
    flash_decode_attention_shared_prefix as j_flash_shared_prefix,
    fused_rms_norm as j_fused_rms,
)
from llm_consensus_tpu_torch.models.cache import quantize_kv
from llm_consensus_tpu_torch.models.configs import PRESETS, RopeScaling
from llm_consensus_tpu_torch.ops import activations, attention, norms, rope
from llm_consensus_tpu_torch.ops import kernels
from llm_consensus_tpu_torch.ops.kernels import attention as ka
from llm_consensus_tpu_torch.ops.kernels import norms as kn
from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq
from llm_consensus_tpu_torch.parallel.mesh import Mesh, MeshConfig

import torch_kernel_emulation as emu  # tests/: the split-KV and tile passes' arithmetic

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0**-8, atol=2.0**-8)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _qkv(rng, b, s, h, hkv, d):
    return (
        rng.standard_normal((b, s, h, d), np.float32),
        rng.standard_normal((b, s, hkv, d), np.float32),
        rng.standard_normal((b, s, hkv, d), np.float32),
    )


# ---------------------------------------------------------------------------
# K1: RMSNorm
# ---------------------------------------------------------------------------


def test_rms_norm_twin_matches_jax_and_pallas():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 33, 64), np.float32) * 3
    w = 1.0 + 0.1 * rng.standard_normal(64).astype(np.float32)  # non-trivial
    ref = _np(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pallas = _np(j_fused_rms(jnp.asarray(x), jnp.asarray(w), 1e-5, blk=16, interpret=True))
    got = kn.fused_rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_allclose(norms.rms_norm(_t(x), _t(w), 1e-5).numpy(), ref, **F32_TOL)


def test_rms_norm_bf16_within_one_rounding_of_fp32_oracle():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((4, 64)), torch.bfloat16)
    w = _t(1.0 + 0.1 * rng.standard_normal(64), torch.bfloat16)
    got = kn.fused_rms_norm(x, w)
    assert got.dtype == torch.bfloat16
    oracle = kn.fused_rms_norm(x.float(), w.float())
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(), **BF16_TOL)


# ---------------------------------------------------------------------------
# K2: causal prefill attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [64, 100])  # 100: not a multiple of 64
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4), (8, 2)])
def test_causal_twin_matches_jax_and_pallas(s, h, hkv):
    rng = np.random.default_rng(s + h)
    q, k, v = _qkv(rng, 2, s, h, hkv, 16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = _np(j_attn.causal_attention(jq, jk, jv))
    pallas = _np(j_flash_causal(jq, jk, jv, blk_q=_pallas_blk(s), interpret=True))
    got = ka.flash_causal_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_causal_attention_with_positions_matches_jax(window):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 12, 4, 2, 8)
    pos = np.stack([np.arange(12), np.r_[np.arange(6), np.arange(6)]]).astype(np.int32)
    ref = _np(j_attn.causal_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(pos), window=window))
    got = attention.causal_attention(
        _t(q), _t(k), _t(v), torch.from_numpy(pos), window=window
    ).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_causal_bf16_within_one_rounding_of_fp32_oracle():
    rng = np.random.default_rng(3)
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(rng, 2, 70, 4, 2, 16))
    got = ka.flash_causal_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    oracle = ka.flash_causal_attention(q.float(), k.float(), v.float())
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(), **BF16_TOL)


def _bf16_tolerance(ref):
    """chip_smoke.tolerance for bf16: one bf16 ulp of each element plus 1e-5."""
    return 2.0**-7 * ref.float().abs() + 1e-5


def _emulate_tc_causal(q, k, v, split_p=True):
    """The arithmetic of K2's bf16 tensor-core kernel, in torch on the CPU.

    bf16 q/k/v; float32 scores with exact products, scaled by
    scale * log2(e) in float32; an online softmax over 64-key tiles with
    exp2; P through P * V as hi = bf16(P) plus lo = bf16(P - hi) into
    float32 sums (or, with ``split_p`` False, P rounded to bf16 alone, the
    usual FlashAttention-2 recipe); one rounding of the output to bf16.
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    scores = scores * torch.tensor(d**-0.5 * 1.4426950408889634, dtype=torch.float32)
    pos = torch.arange(s)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, S, D]
    m = torch.full(scores.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(scores.shape[:-1] + (d,))
    for k0 in range(0, s, 64):
        st = scores[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        vt = vf[..., k0:k0 + 64, :]
        o = o * alpha + hi @ vt
        if split_p:
            o = o + (p - hi).to(torch.bfloat16).float() @ vt
        m = m_new
    out = (o / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return out.to(torch.bfloat16)


def _tc_err_over_tol(b, s, h, hkv, d, split_p, seed=11):
    rng = np.random.default_rng(seed)
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(rng, b, s, h, hkv, d))
    oracle = j_attn.causal_attention(*(jnp.asarray(_np(t.float())) for t in (q, k, v)))
    ref = torch.from_numpy(_np(oracle).copy()).to(torch.bfloat16)
    got = _emulate_tc_causal(q, k, v, split_p=split_p)
    return float(((got.float() - ref.float()).abs() / _bf16_tolerance(ref)).max())


# llama-1b's heads (16 / 8 / 128) at the reported bucket and a ragged one,
# and G = 4.
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 16, 8, 128), (2, 200, 16, 8, 128), (2, 256, 8, 2, 128)])
def test_tc_causal_scheme_with_p_split_within_bf16_tolerance(b, s, h, hkv, d):
    assert _tc_err_over_tol(b, s, h, hkv, d, split_p=True) <= 1.0


def test_tc_causal_scheme_with_bf16_p_misses_bf16_tolerance():
    # Why K2's bf16 kernel splits P into hi + lo: rounded to bf16 alone,
    # P's error in P * V is many bf16 ulps of the output.
    assert _tc_err_over_tol(2, 256, 16, 8, 128, split_p=False) > 10.0


_TILE_PRESETS = sorted(n for n, c in PRESETS.items() if c.head_dim in ka._HEAD_DIMS)


@pytest.mark.parametrize("name", _TILE_PRESETS)
def test_k2_tiles_fit_every_preset(name):
    c = PRESETS[name]
    rows, smem = ka.causal_tile_bf16(c.n_heads, c.n_kv_heads, c.head_dim)
    assert rows == 64 and smem <= 227 * 1024
    bq = ka.causal_block_q(c.n_heads, c.n_kv_heads, c.head_dim)
    threads = bq * (c.n_heads // c.n_kv_heads) * max(1, c.head_dim // 32)
    assert threads <= 512 and threads % 32 == 0


def test_k2_tile_refuses_head_dims_it_does_not_take():
    assert any(c.head_dim not in ka._HEAD_DIMS for c in PRESETS.values())  # arith-3m: 48
    for d in (48, 96, 256):
        with pytest.raises(ValueError, match="head_dim"):
            ka.causal_tile_bf16(4, 4, d)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ka.causal_tile_bf16(6, 4, 64)


@pytest.mark.parametrize("name", sorted(PRESETS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_launch_shape_every_preset(name, dtype):
    d, sms = PRESETS[name].d_model, 132
    vec = kn._VEC[dtype]
    for rows in (1, 64, 3 * 37, 2048, 8192, 200_000):
        nv, warps, blocks = kn.rms_norm_launch(rows, d, dtype, sms)
        assert nv in kn._LANE_VECTORS and 32 * nv * vec >= d > 32 * (nv // 2) * vec
        assert 1 <= warps <= 8 and blocks >= 1
        # Every row has a warp, or every SM its share of warps (grid-stride).
        assert blocks * warps >= min(rows, sms * 32 // warps * warps)
        # Small row counts spread one block per SM as far as they go.
        assert blocks >= min(rows, sms)


@pytest.mark.parametrize("d,dtype", [
    (36, torch.bfloat16), (4100, torch.bfloat16), (6, torch.float32), (0, torch.float32),
    (8200, torch.bfloat16), (4100, torch.float32)])
def test_k1_launch_refuses_widths_it_does_not_take(d, dtype):
    with pytest.raises(ValueError, match=f"d={d}"):
        kn.rms_norm_launch(64, d, dtype, 132)


# ---------------------------------------------------------------------------
# K3: decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_max", [32, 100])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 8)])
def test_decode_twin_matches_jax_and_pallas(s_max, h, hkv):
    rng = np.random.default_rng(s_max + h)
    q = rng.standard_normal((3, 1, h, 16), np.float32)
    kc = rng.standard_normal((3, s_max, hkv, 16), np.float32)
    vc = rng.standard_normal((3, s_max, hkv, 16), np.float32)
    valid = np.array([1, 17, s_max], np.int32)  # ragged fills incl. both edges
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(valid))
    ref = _np(j_attn.decode_attention(*args))
    pallas = _np(j_flash_decode(*args, interpret=True))
    got = ka.flash_decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    # Slots past valid_len are masked: garbage there changes nothing.
    kc2, vc2 = kc.copy(), vc.copy()
    for r, n in enumerate(valid):
        kc2[r, n:] = 1e3
        vc2[r, n:] = -1e3
    got2 = ka.flash_decode_attention(_t(q), _t(kc2), _t(vc2), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got2, got, **F32_TOL)


def test_decode_attention_window_matches_jax():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 1, 4, 8), np.float32)
    kc = rng.standard_normal((2, 20, 2, 8), np.float32)
    vc = rng.standard_normal((2, 20, 2, 8), np.float32)
    valid = np.array([9, 20], np.int32)
    ref = _np(j_attn.decode_attention(*map(jnp.asarray, (q, kc, vc, valid)), window=4))
    got = attention.decode_attention(
        _t(q), _t(kc), _t(vc), torch.from_numpy(valid), window=4
    ).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_decode_bf16_within_one_rounding_of_fp32_oracle():
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((2, 1, 4, 16)), torch.bfloat16)
    kc = _t(rng.standard_normal((2, 40, 2, 16)), torch.bfloat16)
    vc = _t(rng.standard_normal((2, 40, 2, 16)), torch.bfloat16)
    valid = torch.tensor([3, 40], dtype=torch.int32)
    got = ka.flash_decode_attention(q, kc, vc, valid)
    assert got.dtype == torch.bfloat16
    oracle = ka.flash_decode_attention(q.float(), kc.float(), vc.float(), valid)
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(), **BF16_TOL)


# ---------------------------------------------------------------------------
# K7: shared-prefix decode attention
# ---------------------------------------------------------------------------


def _shared_cache(rng, b, s, hkv, d, plen):
    """Dense K/V whose slots [0, plen) are the same in every row."""
    kc = rng.standard_normal((b, s, hkv, d), np.float32)
    vc = rng.standard_normal((b, s, hkv, d), np.float32)
    kc[:, :plen] = kc[0, :plen]
    vc[:, :plen] = vc[0, :plen]
    return kc, vc


# plen 18: ends inside a 64-slot split; 100: two splits, the second partial.
@pytest.mark.parametrize("plen", [0, 18, 100])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 8)])
def test_shared_prefix_twin_matches_jax_and_pallas(plen, h, hkv):
    rng = np.random.default_rng(plen + h)
    b, s, d = 3, 128, 128  # d = 128: the Pallas kernel's lane width
    q = rng.standard_normal((b, 1, h, d), np.float32)
    kc, vc = _shared_cache(rng, b, s, hkv, d, plen)
    valid = np.array([plen + 1, plen + 9, s], np.int32)
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(valid))
    ref = _np(j_attn.decode_attention_shared_prefix(*args, jnp.int32(plen)))
    pallas = _np(j_flash_shared_prefix(*args, jnp.int32(plen), interpret=True))
    tq, tk, tv, tvl = _t(q), _t(kc), _t(vc), torch.from_numpy(valid)
    got = ka.flash_decode_attention_shared_prefix(tq, tk, tv, tvl, plen).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    # The same as reading every row's whole cache (the ungrouped K3 twin).
    plain = ka.flash_decode_attention(tq, tk, tv, tvl).numpy()
    np.testing.assert_allclose(got, plain, **F32_TOL)


def test_shared_prefix_reads_the_prefix_from_row_zero_only():
    rng = np.random.default_rng(21)
    q = _t(rng.standard_normal((2, 1, 4, 16)))
    kc, vc = _shared_cache(rng, 2, 40, 2, 16, 24)
    valid = torch.tensor([30, 40], dtype=torch.int32)
    want = ka.flash_decode_attention_shared_prefix(q, _t(kc), _t(vc), valid, 24)
    kc[1:, :24] = 1e3  # rows > 0 hold garbage in the prefix: never read
    vc[1:, :24] = -1e3
    got = ka.flash_decode_attention_shared_prefix(q, _t(kc), _t(vc), valid, 24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_shared_prefix_bf16_within_one_rounding_of_fp32_oracle():
    rng = np.random.default_rng(6)
    kc, vc = _shared_cache(rng, 4, 80, 2, 16, 70)
    q, kc, vc = (_t(a, torch.bfloat16) for a in (rng.standard_normal((4, 1, 4, 16)), kc, vc))
    valid = torch.tensor([71, 75, 78, 80], dtype=torch.int32)
    got = ka.flash_decode_attention_shared_prefix(q, kc, vc, valid, 70)
    assert got.dtype == torch.bfloat16
    oracle = ka.flash_decode_attention_shared_prefix(
        q.float(), kc.float(), vc.float(), valid, 70)
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(), **BF16_TOL)


# ---------------------------------------------------------------------------
# K7, K7-q8: the prefix on the tile pass, the suffix on the split-KV pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("hkv", [1, 8])
def test_k7_prefix_split_rule(b, hkv):
    """K7's prefix splits (csrc/decode_tile.cuh's grid (Hkv, row tiles,
    n_pre)): whole 64-slot tiles, every prefix slot covered once, the
    shortest span that keeps the grid to about one wave over the H100's
    132 SMs (or one tile); none without a prefix. The suffix takes K3's rule over S_max - prefix_len.
    The workspace holds both splits' partials, as the C entry point says."""
    src = (ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc/decode_attention.cu").read_text()
    assert "(n_pre + (n_split > 1 ?\n// n_split : 0)) * B * H * (D + 2)" in src
    h = 2 * hkv
    tiles = -(-b * 2 // 64)
    assert ka.prefix_splits(b, h, hkv, 0)[0] == 0
    for plen in (1, 31, 64, 100, 115, 243, 1000, 2176, 8192):
        n, span = ka.prefix_splits(b, h, hkv, plen)
        assert span % 64 == 0 and span >= 64
        assert n * span >= plen > (n - 1) * span
        target = -(-132 // (hkv * tiles))  # splits for one wave of 132 blocks
        assert n <= target or span == 64
        if span > 64:  # the shortest such span: one tile less makes too many splits
            assert -(-plen // (span - 64)) > target
        for n_split in (1, 3):  # the prefix's partials, then the suffix's
            want = (n + (n_split if n_split > 1 else 0)) * b * h * 130
            assert ka.shared_prefix_workspace(b, h, 128, n, n_split) == want


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("hkv", [1, 8])
def test_k7_suffix_split_rule(b, hkv):
    """K7's suffix splits (the split-KV pass over [prefix_len, S_max)):
    whole 32-slot chunks covering the suffix once, at most one split for
    every 128 slots and at most two blocks an SM's worth; a suffix shorter
    than 256 slots (a fan-out's decode budget) takes one split, so its
    blocks merge the prefix's partials themselves and no merge launches."""
    for length in (0, 1, 31, 45, 141, 300, 1176, 2061, 8192):
        n, span = ka.suffix_splits(b, hkv, length, 2)
        assert span % 32 == 0
        assert n * span >= max(length, 1) > (n - 1) * span
        assert n <= max(1, length // 128) and n <= -(-264 // (b * hkv))
        if length < 256:
            assert n == 1


def _tile_smem(elem_bytes, d):
    """csrc/decode_tile.cuh's mma_smem_bytes: two stages of a 64-slot bf16
    K and V tile, rows padded by 16 bytes; for the int8 cache two byte
    stages, their scales and one bf16 K and V tile."""
    tile = 64 * (d + 8) * 2
    if elem_bytes == 1:
        return 2 * 2 * 64 * d + 2 * 2 * 64 * 4 + 2 * tile
    return 2 * 2 * tile


@pytest.mark.parametrize("elem_bytes", [1, 2])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tile_pass_shared_memory(elem_bytes, d):
    """The tensor-core tile pass's blocks (its dynamic shared memory and
    the group scan's 1 KB) leave room for three an SM at every head_dim;
    the CUDA-core form's static shared memory stays under 48 KB."""
    cuh = (ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc/decode_tile.cuh").read_text()
    assert "return kStages * 2 * kBK * D + kStages * 2 * kBK * 4 + 2 * kTile;" in cuh
    assert "return kStages * 2 * kTile;" in cuh and "constexpr int kBK = 64;" in cuh
    smem = _tile_smem(elem_bytes, d) + 4 * 257
    assert 3 * (smem + 1024) <= 233472
    for cc_elem in (1, 2, 4):  # sk, sv, the scales, sq, the group scan
        cc = 32 * (d + 16 // cc_elem) * cc_elem + 32 * d * cc_elem + 2 * 32 * 4 + 16 * d * 4
        assert cc + 4 * 257 <= 48 * 1024


@pytest.mark.parametrize("b,h,hkv,d,s_max,plen,valid", [
    (3, 8, 2, 128, 300, 100, [100, 300, 150]),  # a prefix inside a tile; a row with no suffix
    (2, 8, 4, 128, 200, 200, [200, 200]),  # prefix_len == S_max: no suffix splits at all
    (1, 8, 1, 128, 700, 250, [700]),  # G = 8, one row, four suffix splits
    (4, 16, 8, 128, 256, 115, [179, 179, 200, 256]),  # the fan-out's prefix (N cut to 4)
])
def test_k7_prefix_and_suffix_emulated_matches_twin_and_jax(b, h, hkv, d, s_max, plen, valid):
    rng = np.random.default_rng(plen + s_max)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc, vc = _shared_cache(rng, b, s_max, hkv, d, plen)
    valid = np.array(valid, np.int32)
    tq, tk, tv, tvl = _t(q), _t(kc), _t(vc), torch.from_numpy(valid)
    got = emu.shared_prefix(tq, tk.transpose(1, 2), tv.transpose(1, 2), tvl, plen).numpy()
    twin = ka.flash_decode_attention_shared_prefix_plain(tq, tk, tv, tvl, plen).numpy()
    pallas = _np(j_flash_shared_prefix(*map(jnp.asarray, (q, kc, vc, valid)), jnp.int32(plen),
                                       interpret=True))
    np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,hkv,d,s_max,plen,valid", [
    (3, 8, 2, 32, 300, 100, [100, 300, 150]),
    (2, 8, 4, 16, 200, 200, [200, 200]),
    (1, 8, 1, 64, 700, 250, [700]),
    (4, 16, 8, 16, 256, 115, [179, 179, 200, 256]),
])
def test_k7q8_prefix_and_suffix_emulated_matches_twin_and_jax(b, h, hkv, d, s_max, plen, valid):
    rng = np.random.default_rng(plen + s_max + 1)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kv = []
    for _ in range(2):
        x = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
        x[:, :, :plen] = x[:1, :, :plen]
        kv += [np.asarray(a) for a in j_cache.quantize_kv(jnp.asarray(x))]
    valid = np.array(valid, np.int32)
    t = [torch.from_numpy(np.array(a)) for a in (*kv, valid)]
    got = emu.shared_prefix(_t(q), t[0], t[2], t[4], plen, t[1], t[3], elem_bytes=1).numpy()
    twin = ka.flash_decode_attention_shared_prefix_q8_plain(_t(q), *t, plen).numpy()
    pallas = _np(j_pattn.flash_decode_attention_shared_prefix_q8(
        jnp.asarray(q), *map(jnp.asarray, (*kv, valid)), jnp.int32(plen), interpret=True))
    np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def _tile_bf16_err_over_tol(kind, split_p=True, seed=3):
    """The tensor-core tile pass's arithmetic (tests/torch_kernel_emulation.
    tile_bf16) on 64 bf16 (query, head) rows of llama-1b's head_dim over a
    243-slot run, against a float32 oracle on the same inputs, in units of
    the bf16 tolerance (one bf16 ulp of each element plus 1e-5). kind:
    "dense" (bf16 K/V, K7's prefix and K8's group run), "q8" (the int8
    cache and its scales, K7-q8's prefix), "ragged" (bf16 K/V under K8's
    ragged-causal mask and a window, its chunk and verify rows)."""
    gen = torch.Generator().manual_seed(seed)
    r, s, d = 64, 243, 128
    q = torch.randn(r, d, generator=gen).to(torch.bfloat16)
    k_scale = v_scale = None
    if kind == "q8":
        k, k_scale = quantize_kv(torch.randn(1, 1, s, d, generator=gen))
        v, v_scale = quantize_kv(torch.randn(1, 1, s, d, generator=gen))
        k, v, k_scale, v_scale = k[0, 0], v[0, 0], k_scale[0, 0], v_scale[0, 0]
        kf, vf = k.float() * k_scale[:, None], v.float()
    else:
        k = torch.randn(s, d, generator=gen).to(torch.bfloat16)
        v = torch.randn(s, d, generator=gen).to(torch.bfloat16)
        kf, vf = k.float(), v.float()
    lo, hi = torch.zeros(r, dtype=torch.long), torch.full((r,), s)
    if kind == "ragged":  # positions s - 64 + i, a window of 100
        pos = s - r + torch.arange(r)
        lo, hi = pos + 1 - 100, pos + 1
    m, l, acc = emu.tile_bf16(q, k, v, lo, hi, int(lo.min().clamp(min=0)), s, k_scale, v_scale,
                              split_p=split_p)
    got = (acc / l[:, None]).to(torch.bfloat16)
    slot = torch.arange(s)
    sc = (q.float() @ kf.T) * d**-0.5
    sc = sc.masked_fill((slot[None] < lo[:, None]) | (slot[None] >= hi[:, None]), float("-inf"))
    p = torch.softmax(sc.double(), -1)
    oracle = (p @ (vf.double() if v_scale is None else vf.double() * v_scale.double()[:, None]))
    ref = oracle.float().to(torch.bfloat16)
    return float(((got.float() - ref.float()).abs() / _bf16_tolerance(ref)).max())


@pytest.mark.parametrize("kind", ["dense", "q8", "ragged"])
def test_tile_pass_bf16_scheme_within_bf16_tolerance(kind):
    assert _tile_bf16_err_over_tol(kind) <= 1.0


@pytest.mark.parametrize("kind", ["dense", "q8", "ragged"])
def test_tile_pass_with_bf16_p_misses_bf16_tolerance(kind):
    # Why the tile pass splits P into hi + lo, as K2 does: rounded to bf16
    # alone, P's error in P * V is many bf16 ulps of the output (20-57x the
    # tolerance here).
    assert _tile_bf16_err_over_tol(kind, split_p=False) > 10.0


# ---------------------------------------------------------------------------
# Plain ops without kernels
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# K4 (K5): the int8-cache decode as a split-KV pass
# ---------------------------------------------------------------------------


def _split_rule_holds(b, hkv, s_max, blocks_per_sm):
    """The split-KV grid of K3 and K4 for one cache length: whole 32-slot
    chunks, at least four a split (one for each warp), every slot covered
    once, and ``blocks_per_sm`` blocks for each of the H100's 132 SMs
    unless the floor of 128 slots a split binds."""
    n, span = ka.decode_splits(b, hkv, s_max, blocks_per_sm)
    assert span % 32 == 0 and span >= 128
    assert n * span >= s_max > (n - 1) * span
    assert b * hkv * n >= blocks_per_sm * 132 or n == -(-s_max // 128)
    return n


@pytest.mark.parametrize("b", [1, 2, 4, 8, 64])
@pytest.mark.parametrize("hkv", [1, 2, 8])
def test_k4_split_rule(b, hkv):
    """K4's grid (Hkv, B, n_split) from the host-known shapes: two blocks
    an SM at every int8 shape (its ~70 KB blocks leave room for that), the
    split rule's properties, and the workspace the wrapper allocates is the
    C entry point's n_split * B * H * (D + 2) floats (none for one split)."""
    src = (ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc/decode_attention_q8.cu").read_text()
    assert "n_split * B * H * (D + 2)" in src
    assert all(ka.decode_blocks_per_sm(1, d, g) == 2 for d in (16, 32, 64, 128) for g in (1, 2, 4, 8))
    for s_max in (1, 31, 64, 100, 256, 300, 384, 2176, 8192):
        n = _split_rule_holds(b, hkv, s_max, 2)
        for h, d in ((hkv, 128), (8 * hkv, 16)):
            want = n * b * h * (d + 2) if n > 1 else 0
            assert ka.decode_workspace(b, h, d, n) == want


@pytest.mark.parametrize("b", [1, 2, 4, 8, 64])
@pytest.mark.parametrize("hkv", [1, 2, 8])
def test_k3_split_rule(b, hkv):
    """K3's grid from the same rule, aimed at the blocks the card keeps
    resident for the dense cache's element size: a bf16 block at D = 128
    (one 16.9 KB stage for each of 4 warps) leaves room for three on a 228
    KB SM, so the grid aims at two as K4's does; a float32 one at D = 128
    (one 33.3 KB stage a warp) leaves room for one; the shared memory is csrc/decode_split.cuh's (the ring's
    budget and stage layout read from its text); the workspace is the C
    entry point's."""
    src = (ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc/decode_attention.cu").read_text()
    assert "n_split * B * H * (D + 2)" in src
    cuh = (ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc/decode_split.cuh").read_text()
    assert "kRingBudget = 128 * 1024" in cuh and "E k[kChunk][D + kPerVec];" in cuh
    assert ka.decode_split_smem(2, 128, 2) == 4 * 16912 + 2 * 128 * 4 + 4 * 2 * 32 * 4 + 32
    assert ka.decode_split_smem(2, 64, 2) == 8 * 8720 + 2 * 64 * 4 + 4 * 2 * 32 * 4 + 64
    assert ka.decode_split_smem(4, 128, 2) == 4 * 33296 + 2 * 128 * 4 + 4 * 2 * 32 * 4 + 32
    for elem in (2, 4):
        for d in (16, 32, 64, 128):
            for g in (1, 2, 4, 8):
                per_sm = ka.decode_blocks_per_sm(elem, d, g)
                assert per_sm == (1 if elem * d >= 512 else 2), (elem, d, g)
                assert (ka.decode_split_smem(elem, d, g) + 1024) * per_sm <= 233472
    for s_max in (1, 31, 64, 100, 256, 300, 384, 2176, 8192):
        n = _split_rule_holds(b, hkv, s_max, 2)
        assert (n, _split_rule_holds(b, hkv, s_max, 1)) == (
            ka.decode_splits(b, hkv, s_max)[0], ka.decode_splits(b, hkv, s_max, 1)[0])
        for h, d in ((hkv, 128), (8 * hkv, 16)):
            want = n * b * h * (d + 2) if n > 1 else 0
            assert ka.decode_workspace(b, h, d, n) == want


def _emulate_split(q, k, v, valid_len, blocks_per_sm, k_scale=None, v_scale=None):
    """csrc/decode_split.cuh's arithmetic in float32 torch, on a head-major
    cache k, v [B, Hkv, S_max, D] (the int8 one with its scales, or the
    dense one transposed): per (row, kv head) the splits the rule picks; in
    a split, warp w scores chunks w, w + 4, ... of 32 slots (q times d^-1/2
    first) with one online-softmax update a chunk (the int8 cache's K scale
    on the scores, its V scale folded into p); the warps merged by
    log-sum-exp, then the splits, in order."""
    b, _, h, d = q.shape
    hkv, s_max = k.shape[1], k.shape[2]
    g = h // hkv
    n_split, span = ka.decode_splits(b, hkv, s_max, blocks_per_sm)
    neg = torch.tensor(-float("inf"))

    def merge(states):
        mx = torch.stack([m for m, _, _ in states]).amax(0)
        tot_l, tot = torch.zeros(g), torch.zeros(g, d)
        for m, l, acc in states:
            c = torch.where(m == neg, 0.0, torch.exp(m - torch.where(mx == neg, 0.0, mx)))
            tot_l, tot = tot_l + l * c, tot + acc * c[:, None]
        return mx, tot_l, tot

    out = torch.zeros(b, 1, h, d)
    for bi in range(b):
        n = min(max(int(valid_len[bi]), 0), s_max)
        for kvh in range(hkv):
            qg = q[bi, 0, kvh * g:(kvh + 1) * g].float() * d**-0.5
            parts = []
            for sp in range(n_split):
                lo, hi = sp * span, min(n, sp * span + span)
                chunks = max(0, -(-(hi - lo) // 32))
                warps = []
                for w in range(4):
                    m, l, acc = torch.full((g,), -float("inf")), torch.zeros(g), torch.zeros(g, d)
                    for c in range(w, chunks, 4):
                        c0 = lo + 32 * c
                        c1 = min(hi, c0 + 32)
                        sc = qg @ k[bi, kvh, c0:c1].float().T
                        if k_scale is not None:
                            sc = sc * k_scale[bi, kvh, c0:c1]
                        m_new = torch.maximum(m, sc.amax(-1))
                        alpha = torch.where(m == neg, 0.0, torch.exp(m - m_new))
                        p = torch.exp(sc - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        pv = p if v_scale is None else p * v_scale[bi, kvh, c0:c1]
                        acc = acc * alpha[:, None] + pv @ v[bi, kvh, c0:c1].float()
                        m = m_new
                    warps.append((m, l, acc))
                parts.append(merge(warps))
            _, tot_l, tot = merge(parts)
            o = torch.where(tot_l[:, None] > 0, tot / torch.clamp(tot_l[:, None], min=1e-30), 0.0)
            out[bi, 0, kvh * g:(kvh + 1) * g] = o
    return out.to(q.dtype)


def _emulate_k4(q, k_q, k_scale, v_q, v_scale, valid_len):
    return _emulate_split(q, k_q, v_q, valid_len, 2, k_scale, v_scale)


def _emulate_k3(q, k_cache, v_cache, valid_len):
    """K3: the split-KV pass over the token-major dense cache, its grid
    aimed at the blocks per SM of a bf16 cache of this head_dim."""
    per_sm = ka.decode_blocks_per_sm(2, q.shape[-1], q.shape[2] // k_cache.shape[2])
    return _emulate_split(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), valid_len, per_sm)


@pytest.mark.parametrize("b,h,hkv,d,s_max,valid", [
    (3, 8, 2, 128, 600, [1, 600, 290]),  # 5 splits of 128, some past valid_len; a ragged chunk
    (2, 8, 8, 16, 37, [37, 1]),  # G = 1, one split, S_max not a multiple of 32
    (1, 8, 1, 128, 2100, [2100]),  # G = 8, 17 splits, the last one ragged
    (4, 16, 8, 16, 2176, [2049, 2176, 2100, 2150]),  # the panel's decode at D = 16: 10 splits
])
def test_k3_split_and_merge_emulated_matches_twin_and_jax(b, h, hkv, d, s_max, valid):
    rng = np.random.default_rng(b * 1000 + s_max)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    valid = np.array(valid, np.int32)
    t = [_t(kc), _t(vc), torch.from_numpy(valid)]
    got = _emulate_k3(_t(q), *t).numpy()
    plain = ka.flash_decode_attention_plain(_t(q), *t).numpy()
    jax_out = _np(j_flash_decode(*map(jnp.asarray, (q, kc, vc, valid)), interpret=True))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-5)
    # valid_len 0: zeros (decode never passes it).
    t[-1] = torch.zeros(b, dtype=torch.int32)
    assert not _emulate_k3(_t(q), *t).any()


@pytest.mark.parametrize("b,h,hkv,d,s_max,valid", [
    (3, 8, 2, 32, 400, [1, 400, 150]),  # 4 splits of 128; splits past valid_len; ragged chunks
    (2, 4, 4, 16, 37, [37, 1]),  # G = 1, one split, S_max not a multiple of 32
    (1, 8, 1, 64, 600, [600]),  # G = 8, 5 splits, the last one ragged
    (2, 8, 4, 128, 257, [257, 128]),  # D = 128, a split of one slot
])
def test_k4_split_and_merge_emulated_matches_twin_and_jax(b, h, hkv, d, s_max, valid):
    rng = np.random.default_rng(b * 1000 + s_max)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    kq_, ks = (np.asarray(a) for a in j_cache.quantize_kv(jnp.asarray(k)))
    vq_, vs = (np.asarray(a) for a in j_cache.quantize_kv(jnp.asarray(v)))
    valid = np.array(valid, np.int32)
    t = [torch.from_numpy(np.array(a)) for a in (kq_, ks, vq_, vs, valid)]
    got = _emulate_k4(_t(q), *t).numpy()
    plain = ka.flash_decode_attention_q8_plain(_t(q), *t).numpy()
    jax_out = _np(j_pattn.flash_decode_attention_q8(
        jnp.asarray(q), *map(jnp.asarray, (kq_, ks, vq_, vs, valid)), interpret=True))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-5)
    # valid_len 0: zeros, as the twin gives (the JAX kernel averages every
    # slot there; decode never passes it).
    t[-1] = torch.zeros(b, dtype=torch.int32)
    assert not _emulate_k4(_t(q), *t).any()
    assert not ka.flash_decode_attention_q8_plain(_t(q), *t).any()


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_matches_jax(scaled):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, 16), np.float32)
    kw = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
              original_max_position_embeddings=256)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), 16, 500000.0,
                                 JRopeScaling(**kw) if scaled else None)
    c, s = rope.rope_cos_sin(torch.from_numpy(pos), 16, 500000.0,
                             RopeScaling(**kw) if scaled else None)
    np.testing.assert_allclose(c.numpy(), _np(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5, atol=1e-5)
    ref = _np(j_rope.apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(rope.apply_rope(_t(x), c, s).numpy(), ref, **F32_TOL)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(4)
    x, wg, wu, wd = (rng.standard_normal(sh, np.float32) * 0.3
                     for sh in ((3, 16), (16, 24), (16, 24), (24, 16)))
    ref = _np(j_act.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    got = activations.swiglu(*map(_t, (x, wg, wu, wd))).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_cpu_twin_path_counts_no_launch():
    kernels.reset_launch_counts()
    x = torch.ones(2, 8)
    kn.fused_rms_norm(x, torch.ones(8))
    q = torch.ones(1, 4, 2, 16)
    ka.flash_causal_attention(q, q, q)
    ka.flash_decode_attention(q[:, :1], q, q, torch.tensor([4], dtype=torch.int32))
    ka.flash_decode_attention_shared_prefix(
        q[:, :1], q, q, torch.tensor([4], dtype=torch.int32), 2)
    kq8, ks = torch.zeros(1, 2, 4, 16, dtype=torch.int8), torch.ones(1, 2, 4)
    vl = torch.tensor([4], dtype=torch.int32)
    ka.flash_decode_attention_q8(q[:, :1], kq8, ks, kq8, ks, vl)
    ka.flash_decode_attention_q8_stacked(q[:, :1], kq8[None], ks[None], kq8[None], ks[None], vl, 0)
    ka.flash_decode_attention_shared_prefix_q8(q[:, :1], kq8, ks, kq8, ks, vl, 2)
    ka.flash_decode_attention_shared_prefix_q8_stacked(
        q[:, :1], kq8[None], ks[None], kq8[None], ks[None], vl, 2, 0)
    kq.quant_matmul_2d(torch.ones(2, 128), torch.ones(128, 128, dtype=torch.int8),
                       torch.ones(1, 128))
    kq.quant4_matmul_2d(torch.ones(2, 128), torch.ones(64, 128, dtype=torch.int8),
                        torch.ones(1, 128))
    pool = torch.ones(3, 4, 2, 16)
    kernels.ragged_paged_attention(
        q[0, :2], pool, pool, torch.ones(2, 2, dtype=torch.int32),
        torch.tensor([3, 0], dtype=torch.int32),
        q_chunk=q[0], chunk_table=torch.tensor([2, 1], dtype=torch.int32), chunk_start=1)
    kernels.ragged_paged_attention_sharded(
        Mesh(MeshConfig(), "cpu"), q[0, :2], pool, pool, torch.ones(2, 2, dtype=torch.int32),
        torch.tensor([3, 0], dtype=torch.int32),
        q_chunk=q[0], chunk_table=torch.tensor([2, 1], dtype=torch.int32), chunk_start=1)
    assert len(kernels.KERNELS) == 12
    assert [fn.launches for fn in kernels.KERNELS] == [0] * len(kernels.KERNELS)


def test_every_kernel_has_a_cuda_source():
    csrc = ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "rms_norm.cu", "causal_attention.cu", "decode_attention.cu", "decode_attention_q8.cu",
        "quant_matmul.cu", "quant4_matmul.cu", "ragged_paged_attention.cu",
    }


# ---------------------------------------------------------------------------
# On the card: each kernel against its twin (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_twins_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    g_cache = torch.Generator(device=cuda).manual_seed(1)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-6

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    x, w = rn(3, 33, 256), (1 + 0.1 * rn(256))
    torch.testing.assert_close(
        kn.fused_rms_norm(x, w), kn.fused_rms_norm_plain(x, w), rtol=tol, atol=tol)
    for d in (16, 64, 128):
        q, k, v = rn(2, 100, 8, d), rn(2, 100, 2, d), rn(2, 100, 2, d)
        torch.testing.assert_close(
            ka.flash_causal_attention(q, k, v),
            ka.flash_causal_attention_plain(q, k, v), rtol=tol, atol=tol)
        qd, kc, vc = rn(3, 1, 8, d), rn(3, 70, 2, d), rn(3, 70, 2, d)
        vl = torch.tensor([1, 33, 70], dtype=torch.int32, device=cuda)
        torch.testing.assert_close(
            ka.flash_decode_attention(qd, kc, vc, vl),
            ka.flash_decode_attention_plain(qd, kc, vc, vl), rtol=tol, atol=tol)
        kc[:, :65], vc[:, :65] = kc[:1, :65].clone(), vc[:1, :65].clone()
        vl = torch.tensor([66, 67, 70], dtype=torch.int32, device=cuda)
        torch.testing.assert_close(
            ka.flash_decode_attention_shared_prefix(qd, kc, vc, vl, 65),
            ka.flash_decode_attention_shared_prefix_plain(qd, kc, vc, vl, 65),
            rtol=tol, atol=tol)
    # K4's split-KV pass at its edges: valid_len 1 and S_max, S_max not a
    # whole number of 32-slot chunks, one row over a long cache (many
    # splits), every head_dim x group size; a second launch gives the same
    # bits.
    for b, s_max, valid, grp, d in ((3, 300, [1, 300, 137], 2, 128), (1, 2176, [2176], 2, 128),
                                    *((2, 200, [200, 77], grp, d) for grp in (1, 2, 4, 8)
                                      for d in (16, 32, 64, 128))):
        qd = rn(b, 1, 4 * grp, d)
        kv = [quantize_kv(torch.randn(b, 4, s_max, d, generator=g_cache, device=cuda))
              for _ in range(2)]
        vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
        args = (qd, kv[0][0], kv[0][1], kv[1][0], kv[1][1], vl)
        got = ka.flash_decode_attention_q8(*args)
        ref = ka.flash_decode_attention_q8_plain(*args)
        bound = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs() + 1e-5
        assert bool(((got.float() - ref.float()).abs() <= bound).all()), (b, s_max, grp, d)
        assert torch.equal(got, ka.flash_decode_attention_q8(*args))
