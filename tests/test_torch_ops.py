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
from llm_consensus_tpu_torch.models.configs import RopeScaling
from llm_consensus_tpu_torch.ops import activations, attention, norms, rope
from llm_consensus_tpu_torch.ops import kernels
from llm_consensus_tpu_torch.ops.kernels import attention as ka
from llm_consensus_tpu_torch.ops.kernels import norms as kn
from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq

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
# Plain ops without kernels
# ---------------------------------------------------------------------------


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
    assert len(kernels.KERNELS) == 9
    assert [fn.launches for fn in kernels.KERNELS] == [0] * len(kernels.KERNELS)


def test_every_kernel_has_a_cuda_source():
    csrc = ROOT / "llm_consensus_tpu_torch/ops/kernels/csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "rms_norm.cu", "causal_attention.cu", "decode_attention.cu", "quant_matmul.cu"
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
