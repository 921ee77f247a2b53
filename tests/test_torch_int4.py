"""The port's int4 path and capacity planner against the JAX package's, on
the same numpy inputs and the same weights, on the CPU.

The JAX package runs here on simulated CPU devices, so its model takes its
plain int4 path (the packed matmul unpacks and dequantizes); its Pallas
int4 kernel is called directly in interpret mode. Tolerances:

- quantization: bit-identical ``q``, ``scale``, unpacked nibbles and
  dequantized weights;
- K10 twin against Pallas, bf16 x: one bf16 rounding of the output,
  2^-8 relative plus 2^-8 of the output's scale absolute (both round a
  float32 sum once to bf16); float32 out: 1e-5 relative and 1e-5 of the
  scale absolute (the same products, summed in another order);
- K10 twin, float32 x, against the JAX package's ``x @ dequantize4(w)``:
  1e-5 relative and 1e-5 of the output's scale absolute. The twin
  multiplies by the scale after the sum, JAX's dequantized weight before
  it, so every term differs by a float32 rounding of ``nibble * scale``;
- model logits: 1e-4 abs (float32, the products and the dequantized cache
  in another order); greedy tokens, text and transcripts: identical;
- planner: equal dicts.
"""

import asyncio
import dataclasses
import json
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import cli as j_cli
from llm_consensus_tpu.backends.base import SamplingParams as JSamplingParams
from llm_consensus_tpu.backends.local import LocalBackend as JLocalBackend
from llm_consensus_tpu.consensus.coordinator import Coordinator as JCoordinator
from llm_consensus_tpu.consensus.coordinator import CoordinatorConfig as JCoordinatorConfig
from llm_consensus_tpu.consensus.personas import default_panel as j_default_panel
from llm_consensus_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_consensus_tpu.engine.engine import InferenceEngine as JInferenceEngine
from llm_consensus_tpu.engine.engine import plan_memory as j_plan_memory
from llm_consensus_tpu.engine.generate import generate as j_generate
from llm_consensus_tpu.models import cache as j_cache
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu.ops import quant as j_quant
from llm_consensus_tpu.ops.pallas import quant_matmul as j_qmm
from llm_consensus_tpu.serving.continuous import ContinuousBatcher as JBatcher
from llm_consensus_tpu.serving.continuous import ContinuousConfig as JConfig
from llm_consensus_tpu_torch import cli
from llm_consensus_tpu_torch.backends.base import SamplingParams
from llm_consensus_tpu_torch.backends.local import LocalBackend
from llm_consensus_tpu_torch.consensus.coordinator import Coordinator, CoordinatorConfig
from llm_consensus_tpu_torch.consensus.personas import default_panel
from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine, plan_memory
from llm_consensus_tpu_torch.engine.generate import generate
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.ops import kernels, quant
from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq
from llm_consensus_tpu_torch.serving import ContinuousBatcher, ContinuousConfig

LOGIT_TOL = dict(rtol=0, atol=1e-4)
# test-tiny widened so that every projection and the lm_head reach K10's
# shape rule (K and N multiples of 128; vocab 384); test-tiny's d_model of
# 64 never reaches the twin.
WIDE4 = dict(d_model=256, d_ff=512)
BLOCK_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(use_pallas):
    return (dataclasses.replace(j_get_config("test-tiny"), use_pallas=use_pallas, **WIDE4),
            dataclasses.replace(get_config("test-tiny"), use_pallas=use_pallas, **WIDE4))


def _same_leaf(got, ref):
    assert isinstance(got, quant.Quantized4Tensor)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert tuple(got.shape) == tuple(ref.shape)


# ---------------------------------------------------------------------------
# Quantization: bit-identical to the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor4_unpack_and_dequantize_bit_identical(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    w[0, :, 0] = np.resize(np.arange(-14, 15) * 0.5, 40)  # amax 7, scale 1: exact half-steps
    w[1, :, 1] = 0.0  # an all-zero channel: scale 1e-8 / 7
    w[2, :, 2] = -w[2, :, 2].max()  # every value at -amax
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = _t(w, getattr(torch, dtype))
    ref = j_quant.quantize_tensor4(jw, 1)
    got = quant.quantize_tensor4(tw, 1)
    _same_leaf(got, ref)
    assert got.shape == (3, 40, 24) and got.q.shape == (3, 20, 24)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            quant.unpack4(got.q, td).float().numpy(), _np(j_quant.unpack4(ref.q, jd)))
        np.testing.assert_array_equal(
            quant.dequantize4(got, td).float().numpy(), _np(j_quant.dequantize4(ref, jd)))
        np.testing.assert_array_equal(
            quant.maybe_dequantize(got, td).float().numpy(),
            _np(j_quant.maybe_dequantize(ref, jd)))


def test_quantize_tensor4_raises_as_jax():
    for fn, arr in ((j_quant.quantize_tensor4, jnp.zeros), (quant.quantize_tensor4, torch.zeros)):
        with pytest.raises(ValueError, match="axis -2"):
            fn(arr((64, 128)), axis=1)
        with pytest.raises(ValueError, match="even"):
            fn(arr((63, 128)), axis=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_int4_bit_identical_to_jax(dtype):
    jcfg = j_get_config("test-tiny")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=getattr(jnp, dtype))
    ref = j_quant.quantize_params(jparams, bits=4)
    got = quant.quantize_params(tt.params_from_jax(_jax_tree(jparams), device="cpu"), bits=4)
    for name in BLOCK_LEAVES:
        _same_leaf(got["blocks"][name], ref["blocks"][name])
    _same_leaf(got["lm_head"], ref["lm_head"])
    assert got["embed"].dtype == getattr(torch, dtype)  # the gather table stays
    assert quant.quantized_bytes(got) == j_quant.quantized_bytes(ref)
    assert tt.param_count(got) == jt.param_count(ref)
    # Quantizing again leaves the int4 leaves as they are.
    again = quant.quantize_params(got, bits=8)
    assert again["blocks"]["wq"] is got["blocks"]["wq"]


def test_int4_block_bytes_half_of_int8():
    params = tt.init_params(get_config("test-tiny"), 0, dtype=torch.bfloat16, device="cpu")
    q8, q4 = quant.quantize_params(params, bits=8), quant.quantize_params(params, bits=4)

    def block_bytes(p):
        return sum(p["blocks"][n].q.numel() * p["blocks"][n].q.element_size()
                   for n in BLOCK_LEAVES)

    assert block_bytes(q4) == block_bytes(q8) // 2


# ---------------------------------------------------------------------------
# K10: the W4A16 matmul's twin and routing
# ---------------------------------------------------------------------------


def _q4weight(rng, *shape):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    return j_quant.quantize_tensor4(jnp.asarray(w), len(shape) - 2)


def _leaf4(jw) -> quant.Quantized4Tensor:
    """A JAX Quantized4Tensor's bits as the port's."""
    return quant.Quantized4Tensor(torch.from_numpy(np.array(jw.q)),
                                  torch.from_numpy(np.array(jw.scale)))


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("k,n", [(256, 384), (384, 256)])
def test_quant4_matmul_twin_matches_pallas_and_jax(m, k, n):
    rng = np.random.default_rng(m + k)
    jw = _q4weight(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    leaf = _leaf4(jw)
    assert kq.quant4_matmul_supported(m, k, n) and j_qmm.quant4_matmul_supported(m, k, n)
    # float32 x: against the JAX package's matmul (its kernel is off).
    ref = _np(j_quant.matmul(jnp.asarray(x), jw))
    got = kq.quant4_matmul_2d(_t(x), leaf.q, leaf.scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    got = quant.matmul(_t(x)[None], leaf)  # [1, M, K] lead
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # bf16 x: against the Pallas kernel (interpret mode), one bf16 rounding.
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = _np(j_qmm.quant4_matmul_2d(xb, jw.q, jw.scale, interpret=True))
    got = kq.quant4_matmul_2d(_t(x, torch.bfloat16), leaf.q, leaf.scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=2.0**-8,
                               atol=2.0**-8 * np.abs(pallas).max())
    # float32 out from bf16 x (the lm_head's call).
    pallas32 = _np(j_qmm.quant4_matmul_2d(xb, jw.q, jw.scale, out_dtype=jnp.float32,
                                          interpret=True))
    got32 = kq.quant4_matmul_2d(_t(x, torch.bfloat16), leaf.q, leaf.scale, torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), pallas32, rtol=1e-5,
                               atol=1e-5 * np.abs(pallas32).max())


def _projections(name):
    c = get_config(name)
    d, dh = c.d_model, c.head_dim
    return ((d, c.n_heads * dh), (d, c.n_kv_heads * dh), (d, c.d_ff), (c.d_ff, d),
            (d, c.vocab_size))


def _magic_unpack(word: torch.Tensor) -> torch.Tensor:
    """K10's unpack (csrc/quant4_matmul.cu: nibbles_bf16) in torch integer
    ops: the nibbles at bits 0-3 and 16-19 of each int32 ``word``, as the
    bf16 pair ``((word & 0x000F000F) ^ 0x43084308) - 136``, low half first."""
    biased = (word & 0x000F000F) ^ 0x43084308
    halves = torch.stack([biased & 0xFFFF, biased >> 16], dim=-1).to(torch.int16)
    return halves.view(torch.bfloat16) - torch.tensor(136.0, dtype=torch.bfloat16)


def test_k10_magic_unpack_bit_for_bit_on_every_byte():
    """Every byte value, in both halves of a 32-bit word and as its low and
    high nibble (the word shifted right by 4, as the kernel does): the same
    bf16 bits as ``unpack4`` and as the JAX ``_q4mm_kernel``'s ``low`` and
    ``high`` arithmetic."""
    packed = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)[:, None]  # [256, 1]
    ref = kq.unpack4(packed, torch.bfloat16)[:, 0]  # rows: 256 low nibbles, then 256 high
    w32 = jnp.asarray(packed.numpy()).astype(jnp.int32)[:, 0]
    j_low = ((w32 & 0xF) - ((w32 & 0x8) << 1)).astype(jnp.bfloat16)
    nib = (w32 >> 4) & 0xF
    j_high = (nib - ((nib & 0x8) << 1)).astype(jnp.bfloat16)
    u = packed[:, 0].to(torch.int32) & 0xFF
    for name, word in (("low half", u), ("high half", u << 16), ("both", u | (u << 16))):
        for shift, want, jwant in ((0, ref[:256], j_low), (4, ref[256:], j_high)):
            got = _magic_unpack(word >> shift)
            half = 1 if name == "high half" else 0
            assert torch.equal(got[:, half].view(torch.int16), want.view(torch.int16)), name
            np.testing.assert_array_equal(
                got[:, half].float().numpy(), np.asarray(jwant, np.float32))
            if name == "both":
                assert torch.equal(got[:, 0].view(torch.int16), got[:, 1].view(torch.int16))


def _k10_ms():
    """The M values at which phase 2 of chip_smoke.py holds K10 (the engine's
    and the serving path's), and M = 256, the largest the rule accepts."""
    import chip_smoke

    return sorted({m for m, *_ in chip_smoke.k6_cases(get_config("llama-1b"))} | {256})


@pytest.mark.parametrize("model", ["llama-1b", "llama3-8b"])
def test_k10_launch_rule_covers_every_projection(model):
    """For every projection the shape rule sends to K10, the wgmma launch
    has a tile with mp >= M, a cluster of at most 8 blocks that cuts K/2
    into whole 64-row stages, 128-column tiles that cover N exactly (N =
    384 and 1152 included, which a 256-column tile would not), and shared
    memory within the H100's 227 KB."""
    shapes = _projections(model) + ((2048, 384), (2048, 1152))
    seen = 0
    for k, n in shapes:
        for m in _k10_ms():
            if not kq.quant4_matmul_supported(m, k, n):
                continue
            seen += 1
            t = kq.wgmma_tile(m, k, n, True)
            splits, tiles = t["grid"]
            assert t["mp"] == min(p for p in (8, 16, 32, 64, 96, 128, 192, 256) if p >= m)
            assert splits == t["splits"] and splits in (1, 2, 4, 8)
            assert splits * t["stages_per_block"] * 64 == k // 2
            assert tiles * 128 == n
            assert 3 <= t["stages"] <= 8
            assert t["smem"] == kq.wgmma_smem_bytes(t["mp"], t["stages"], True)
            assert t["mp"] * (128 + 8) * 4 + 128 <= t["smem"] <= 232448
            assert t["stages"] * (128 * 64 + 2 * t["mp"] * 128) + 128 <= t["smem"]
    assert seen >= 5 * 2


def test_k10_launch_rule_refuses_what_it_cannot_tile():
    for m, k, n in ((0, 256, 128), (257, 256, 128), (4, 256, 200), (4, 255, 128), (4, 96, 128)):
        with pytest.raises(ValueError):
            kq.wgmma_tile(m, k, n, True)


@pytest.mark.parametrize("model", ["llama-1b", "llama3-8b"])
def test_quant4_shape_rule_agrees_with_jax(model):
    ms = (1, 64, 80, 146, 147, 256, 257)
    shapes = _projections(model) + ((384, 256), (256, 384), (130, 256), (128, 200))
    for k, n in shapes:
        for m in ms:
            assert kq.quant4_matmul_supported(m, k, n) == j_qmm.quant4_matmul_supported(m, k, n)
    if model == "llama3-8b":  # x [M, 14336] in bf16 fits 4 MiB up to M = 146
        assert kq.quant4_matmul_supported(146, 14336, 4096)
        assert not kq.quant4_matmul_supported(147, 14336, 4096)


def test_int4_matmul_routes_like_jax(monkeypatch):
    rng = np.random.default_rng(10)
    jw = _q4weight(rng, 128, 256)
    leaf = _leaf4(jw)
    kernels.reset_launch_counts()
    # At a supported shape, a CPU tensor takes the twin (no launch counted).
    x = rng.standard_normal((2, 128)).astype(np.float32)
    want = kq.quant4_matmul_2d_plain(_t(x), leaf.q, leaf.scale)
    torch.testing.assert_close(quant.matmul(_t(x), leaf), want, rtol=0, atol=0)
    assert kq.quant4_matmul_2d.launches == 0
    # Beyond the rule (M > 256) both packages dequantize; no wrapper runs.
    m = 300
    assert not kq.quant4_matmul_supported(m, 128, 256)
    assert not j_qmm.quant4_matmul_supported(m, 128, 256)

    def no_kernel(*a, **k):
        raise AssertionError("the K10 wrapper was called at M > 256")

    monkeypatch.setattr(quant, "quant4_matmul_2d", no_kernel)
    monkeypatch.setattr(quant, "quant4_matmul_2d_plain", no_kernel)
    xl = rng.standard_normal((m, 128)).astype(np.float32)
    ref = _np(j_quant.matmul(jnp.asarray(xl), jw))
    np.testing.assert_allclose(quant.matmul(_t(xl), leaf).numpy(), ref, rtol=2e-5, atol=2e-5)
    refb = _np(j_quant.matmul(jnp.asarray(xl).astype(jnp.bfloat16), jw))
    gotb = quant.matmul(_t(xl, torch.bfloat16), leaf).float().numpy()
    np.testing.assert_allclose(gotb, refb, rtol=2.0**-7, atol=2.0**-7 * np.abs(refb).max())


def test_kernel4_switch_routes_twin_or_raises_on_cpu():
    rng = np.random.default_rng(11)
    leaf = _leaf4(_q4weight(rng, 128, 128))
    x = _t(rng.standard_normal((2, 128)))
    want = kq.quant4_matmul_2d_plain(x, leaf.q, leaf.scale)
    try:
        quant.set_kernel4_enabled(False)
        torch.testing.assert_close(quant.matmul(x, leaf), want, rtol=0, atol=0)
        quant.set_kernel4_enabled(True)
        with pytest.raises(RuntimeError, match="int4 .*CPU"):
            quant.matmul(x, leaf)
    finally:
        quant.set_kernel4_enabled(None)
    torch.testing.assert_close(quant.matmul(x, leaf), want, rtol=0, atol=0)
    assert kq.quant4_matmul_2d.launches == 0


def test_params_from_jax_keeps_int4_leaves_int4():
    """A JAX Quantized4Tensor carries over as a Quantized4Tensor, bytes
    intact; a JAX int8 leaf still as a QuantizedTensor."""
    jcfg = j_get_config("test-tiny")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    q4 = _jax_tree(j_quant.quantize_params(jparams, bits=4))
    carried = tt.params_from_jax(q4, device="cpu")
    for name in BLOCK_LEAVES:
        _same_leaf(carried["blocks"][name], q4["blocks"][name])
    _same_leaf(carried["lm_head"], q4["lm_head"])
    assert quant.quantized_bytes(carried) == j_quant.quantized_bytes(q4)
    q8 = tt.params_from_jax(_jax_tree(j_quant.quantize_params(jparams, bits=8)), device="cpu")
    assert type(q8["blocks"]["wq"]) is quant.QuantizedTensor
    assert type(q8["lm_head"]) is quant.QuantizedTensor


# ---------------------------------------------------------------------------
# The model, the generate loop, the engine and the batcher on int4 weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q4params():
    """float32 weights quantized to int4 by the JAX package, as a JAX tree
    and as the port's tree (carried over by params_from_jax)."""
    jcfg, _ = _configs(False)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = _jax_tree(params)
    rng = np.random.default_rng(0)
    for name in ("attn_norm", "mlp_norm"):
        a = tree["blocks"][name]
        tree["blocks"][name] = (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    qtree = _jax_tree(j_quant.quantize_params(jax.tree.map(jnp.asarray, tree), bits=4))
    return jax.tree.map(jnp.asarray, qtree), tt.params_from_jax(qtree, device="cpu")


def _same_int8_cache(tcache, jcache):
    """The port wrote the JAX package's quantized K/V up to rare flips of
    one int8 step at a rounding boundary; then the port's cache takes
    JAX's values, so each step's logits compare the arithmetic on the
    same cache (as tests/test_torch_quant.py does)."""
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        got, ref = getattr(tcache, name), np.asarray(getattr(jcache, name))
        if name.endswith("_q"):
            diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and np.mean(diff) < 1e-3
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)
        got.copy_(torch.from_numpy(np.array(ref)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_logits_on_int4_match_jax(q4params, kv_quant, use_pallas):
    jcfg, tcfg = _configs(use_pallas)
    jparams, tparams = q4params
    assert isinstance(tparams["blocks"]["wq"], quant.Quantized4Tensor)
    rng = np.random.default_rng(1)
    b, s, steps = 3, 24, 4
    tokens = rng.integers(3, jcfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([s, 7, 15], np.int32)
    if kv_quant:
        jc = j_cache.QuantKVCache.create(jcfg, b, s + steps)
        tc = QuantKVCache.create(tcfg, b, s + steps)
    else:
        jc = j_cache.KVCache.create(jcfg, b, s + steps, dtype=jnp.float32)
        tc = KVCache.create(tcfg, b, s + steps, torch.float32)
    jlog, jc = jt.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths), jc)
    tlog, tc = tt.prefill(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    for _ in range(steps):
        if kv_quant:
            _same_int8_cache(tc, jc)
        nxt = rng.integers(3, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jlog, jc = jt.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        tlog, tc = tt.decode_step(tcfg, tparams, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n", [1, 4])
def test_greedy_generate_tokens_on_int4_match_jax(q4params, n, shared, kv_quant):
    jcfg, tcfg = _configs(True)
    jparams, tparams = q4params
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, jcfg.vocab_size, (n, 16)).astype(np.int32)
    lengths = rng.integers(1, 17, (n,)).astype(np.int32)
    lengths[0] = 16
    if shared:
        tokens[:] = tokens[0]
        lengths[:] = lengths[0]
    kw = dict(max_new_tokens=8, eos_id=-1, pad_id=0, shared_prefill=shared, kv_quant=kv_quant)
    jout = j_generate(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                      jax.random.PRNGKey(0), jnp.zeros((n,), jnp.float32), **kw)
    tout = generate(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
                    torch.Generator().manual_seed(0), torch.zeros(n), **kw)
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))


def test_int4_engine_text_and_transcript_equal_jax(q4params):
    jcfg, tcfg = _configs(False)
    jparams, tparams = q4params
    # The engines get the already-quantized trees; quant="int4" on a
    # quantized tree leaves it as it is.
    ec = dict(max_new_tokens=6, seq_buckets=(32,), batch_buckets=(1, 2, 4, 8),
              quant="int4", kv_quant=True)
    jeng = JInferenceEngine(jcfg, jparams, engine_config=JEngineConfig(**ec))
    teng = InferenceEngine(tcfg, tparams, engine_config=EngineConfig(**ec), device="cpu")
    assert teng.params["blocks"]["wq"].q is tparams["blocks"]["wq"].q
    for prompts in (["What is 2+2?", "Name a color.", "x"], ["Same prompt"] * 4):
        ref = jeng.generate_texts(prompts, temperatures=[0.0] * len(prompts))
        got = teng.generate_texts(prompts, temperatures=[0.0] * len(prompts))
        assert [r.token_ids for r in got] == [r.token_ids for r in ref]
        assert [r.text for r in got] == [r.text for r in ref], ascii([r.text for r in got])
    transcripts = []
    for Coord, Config, Local, panel, Params, eng in (
        (Coordinator, CoordinatorConfig, LocalBackend, default_panel, SamplingParams, teng),
        (JCoordinator, JCoordinatorConfig, JLocalBackend, j_default_panel, JSamplingParams, jeng),
    ):
        coord = Coord(panel(), Local(eng), Config(
            seed=0, max_rounds=2, sampling=Params(max_new_tokens=6, temperature=0.0)))
        res = asyncio.run(coord.run("What is 2+2?"))
        transcripts.append((res.answer, res.rounds, res.endorsed,
                            [(e.kind, e.round, e.payload) for e in res.transcript]))
    assert transcripts[0] == transcripts[1], ascii(transcripts[0])


def test_engine_quantizes_int4_at_init_like_init_params_quantized():
    cfg = get_config("test-tiny").with_(**WIDE4)
    params = tt.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    eng = InferenceEngine(cfg, params, engine_config=EngineConfig(quant="int4", kv_quant=True),
                          device="cpu")
    assert isinstance(eng.params["lm_head"], quant.Quantized4Tensor)
    assert eng.params["embed"].dtype == torch.float32
    direct = tt.init_params_quantized(cfg, 0, bits=4, dtype=torch.float32, device="cpu")
    torch.testing.assert_close(direct["blocks"]["w_up"].q, eng.params["blocks"]["w_up"].q)
    out = eng.generate_texts(["hi", "there"], temperatures=[0.0, 0.0], max_new_tokens=3)
    assert [r.num_tokens for r in out] == [3, 3]


def test_int4_serving_burst_text_equals_jax(q4params):
    """The port's batcher on int4 weights (K10 twin and K8 twin, fused
    step, pipeline depth 2) gives the JAX batcher's greedy float32 text."""
    jcfg, tcfg = _configs(False)[0], _configs(True)[1]
    jparams, tparams = q4params
    header = "You are a careful panelist. Question: why is the sky blue? " * 2
    prompts = [header + "Answer briefly.", header + "Give one word.",
               "an unrelated short prompt", header[:70] + "xyz"]
    burst = dict(max_slots=4, page_size=16, n_pages=64, pages_per_seq=16,
                 seq_buckets=(32, 64, 128, 192), prefill_chunk=16, max_new_tokens=12,
                 pipeline_depth=2, ragged_attention=True)
    texts = []
    for batcher in (JBatcher(jcfg, jparams, config=JConfig(**burst)),
                    ContinuousBatcher(tcfg, tparams, config=ContinuousConfig(**burst),
                                      device="cpu")):
        try:
            futs = [batcher.submit(p) for p in prompts]
            texts.append([f.result(timeout=300).text for f in futs])
            stats = batcher.stats()
        finally:
            batcher.close()
    assert texts[0] == texts[1], ascii(texts)
    assert stats["device_programs_fused"] > 0 and stats["prefix_pages_shared"] > 0


# ---------------------------------------------------------------------------
# The capacity planner
# ---------------------------------------------------------------------------

H100_BYTES = cli.H100_TOTAL_MEMORY


@pytest.mark.parametrize("qmode", ["none", "int8", "int4"])
@pytest.mark.parametrize("model", ["llama-1b", "llama3-8b", "mistral-7b", "qwen2-7b"])
def test_plan_memory_equals_jax(model, qmode):
    for kv_quant in (False, True):
        for shared in (0, 100):
            kw = dict(quant=qmode, kv_quant=kv_quant, n_candidates=64, prompt_len=1900,
                      new_tokens=128, hbm_bytes=H100_BYTES, shared_prefix_len=shared)
            assert plan_memory(get_config(model), **kw) == j_plan_memory(
                j_get_config(model), **kw)
    kw = dict(quant=qmode, n_candidates=5, prompt_len=300, new_tokens=64,
              host_cache_bytes=1 << 30, page_size=16, seq_buckets=(128, 512),
              batch_buckets=(4, 8), hbm_bytes=16 << 30)
    got = plan_memory(get_config(model), **kw)
    assert got == j_plan_memory(j_get_config(model), **kw)
    assert got["host_capacity_pages"] > 0 and got["batch"] == 8


def test_plan_memory_allocates_nothing():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB
    plan = plan_memory(get_config("llama3-8b"), quant="none", n_candidates=64,
                       prompt_len=2000, new_tokens=128)
    grown_gib = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) / (1 << 20)
    assert plan["params_bytes"] > 14 << 30  # bf16 llama3-8b, had it been built
    assert grown_gib < 1.0
    # The tree it sizes lives on the meta device: shapes only.
    tree = tt.init_params(get_config("llama3-8b"), device="meta")
    assert all(t.is_meta for t in quant.leaves(quant.quantize_params(tree, bits=4)))


def test_plan_memory_raises_on_moe_and_mesh():
    with pytest.raises(NotImplementedError, match="MoE"):
        plan_memory(get_config("mixtral-8x7b"), quant="int4")
    # dp x mp plans are ported (tests/test_torch_parallel.py holds them
    # against the JAX package's); the axes of later slices still raise.
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        plan_memory(get_config("llama-1b"), mesh_shape={"data": 2, "pipe": 2})
    with pytest.raises(NotImplementedError, match="int4"):
        plan_memory(get_config("llama-1b"), quant="int4", mesh_shape={"model": 2})
    kw = dict(quant="int8", n_candidates=64, mesh_shape={"data": 2})
    assert plan_memory(get_config("llama-1b"), **kw) == j_plan_memory(
        j_get_config("llama-1b"), **kw)
    # A mesh of one card is no mesh.
    assert plan_memory(get_config("llama-1b"), mesh_shape={"data": 1}) == plan_memory(
        get_config("llama-1b"))


@pytest.mark.parametrize("qmode", ["none", "int8", "int4"])
def test_memory_estimate_equals_jax(qmode):
    jcfg = j_get_config("test-tiny")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    ec = dict(max_new_tokens=32, quant=qmode, kv_quant=qmode != "none")
    jeng = JInferenceEngine(jcfg, jparams, engine_config=JEngineConfig(**ec))
    teng = InferenceEngine(get_config("test-tiny"), tt.params_from_jax(_jax_tree(jparams), device="cpu"),
                           engine_config=EngineConfig(**ec), device="cpu")
    for kw in (dict(), dict(n_candidates=64, prompt_len=40, new_tokens=16),
               dict(n_candidates=3, prompt_len=100, hbm_bytes=1 << 20, shared_prefix_len=30)):
        assert teng.memory_estimate(**kw) == jeng.memory_estimate(**kw)
    plan = plan_memory(get_config("test-tiny"), quant=qmode, kv_quant=qmode != "none",
                       n_candidates=64, prompt_len=40, new_tokens=16)
    assert plan == teng.memory_estimate(n_candidates=64, prompt_len=40, new_tokens=16)


@pytest.mark.parametrize("args", [
    ["--model", "llama3-8b", "--plan-quant", "int4"],
    ["--model", "llama3-8b", "--plan-quant", "none", "--plan-kv", "none", "--plan-n", "64"],
    ["--model", "qwen2-7b", "--plan-context", "4096", "--max-new-tokens", "512"],
])
def test_cli_plan_prints_jax_keys_and_exit_codes(args, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no card needed
    outs = []
    for main in (cli.main, j_cli.main):
        for hbm in ("16", "80"):
            rc = main(["--plan", *args, "--plan-hbm-gib", hbm])
            outs.append((rc, json.loads(capsys.readouterr().out)))
    assert outs[:2] == outs[2:]
    assert [rc for rc, _ in outs[:2]] == [int(not o["fits"]) for _, o in outs[:2]]
    # The port's default is one H100's memory (the JAX package's a v5e's).
    assert cli.main(["--plan", *args]) in (0, 1)
    got = json.loads(capsys.readouterr().out)
    assert got["hbm_gib"] == H100_BYTES / (1 << 30)
    mesh = ["--plan-mesh", "data=2,model=2"]
    if "int4" in args:
        with pytest.raises(NotImplementedError, match="int4"):
            cli.main(["--plan", *args, *mesh])
        return
    outs = []
    for main in (cli.main, j_cli.main):
        rc = main(["--plan", *args, *mesh, "--plan-hbm-gib", "16"])
        outs.append((rc, json.loads(capsys.readouterr().out)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("backend", ["local", "continuous"])
def test_cli_int4_question_runs(backend, capsys):
    args = ["--backend", backend, "--cpu", "--model", "test-tiny", "--max-new-tokens", "4",
            "--max-rounds", "1", "--seed", "1", "--question", "hi", "--quant", "int4"]
    assert cli.main(args) == 0
    assert capsys.readouterr().out.endswith("\n")


# ---------------------------------------------------------------------------
# On the card: K10 against its twin (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_kernel_matches_twin_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    # The last rows: N a multiple of 128 but not of 256 (384, 1152), M from
    # 1 to 256; K10 must give the same bits twice.
    for m, k, n, out in ((5, 256, 384, None), (64, 384, 256, None), (3, 2048, 1024, torch.float32),
                         (1, 2048, 384, None), (16, 2048, 1152, None), (80, 2048, 1152, torch.float32),
                         (256, 2048, 384, None), (256, 5632, 2048, torch.float32)):
        x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
        w = quant.quantize_tensor4(torch.randn(k, n, generator=g, device=cuda) * 0.02, 0)
        got = kq.quant4_matmul_2d(x, w.q, w.scale, out)
        ref = kq.quant4_matmul_2d_plain(x, w.q, w.scale, out)
        # float32: sum order; bf16: one rounding of each element
        tol = 1e-4 if (out or dtype) == torch.float32 else 2.0**-7 * ref.float().abs() + 1e-5
        assert bool(((got.float() - ref.float()).abs() <= tol).all())
        assert torch.equal(got, kq.quant4_matmul_2d(x, w.q, w.scale, out))
