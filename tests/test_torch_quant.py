"""The port's int8 path against the JAX package's, on the same numpy
inputs and the same weights, on the CPU.

The JAX package runs here on 8 simulated CPU devices, so its model takes
its plain int8 paths (the quantized matmul dequantizes, int8-cache decode
dequantizes and defers); its Pallas kernels are called directly in
interpret mode. Tolerances:

- quantization (weights and KV): bit-identical ``q`` and ``scale``;
- K6 twin, float32 x: 1e-5 relative (the same products, summed in
  another order); bf16 x: one bf16 rounding of the output, 2^-8 relative
  plus 2^-8 of the output's scale absolute (Pallas rounds the float32
  sum once to bf16, as the twin does);
- K4, K5, K7-q8 twins: 2e-5 abs/rel in float32 (the same arithmetic in
  another order);
- model logits: 1e-4 abs (float32, the int8 products and the dequantized
  cache in another order); greedy tokens and text: identical.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_consensus_tpu.ops.pallas.attention as j_pattn
from llm_consensus_tpu.backends.base import SamplingParams as JSamplingParams
from llm_consensus_tpu.backends.local import LocalBackend as JLocalBackend
from llm_consensus_tpu.consensus.coordinator import Coordinator as JCoordinator
from llm_consensus_tpu.consensus.coordinator import CoordinatorConfig as JCoordinatorConfig
from llm_consensus_tpu.consensus.personas import default_panel as j_default_panel
from llm_consensus_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_consensus_tpu.engine.engine import InferenceEngine as JInferenceEngine
from llm_consensus_tpu.engine.generate import generate as j_generate
from llm_consensus_tpu.models import cache as j_cache
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu.ops import attention as j_attn
from llm_consensus_tpu.ops import quant as j_quant
from llm_consensus_tpu.ops.pallas import quant_matmul as j_qmm
from llm_consensus_tpu_torch.backends.base import SamplingParams
from llm_consensus_tpu_torch.backends.local import LocalBackend
from llm_consensus_tpu_torch.consensus.coordinator import Coordinator, CoordinatorConfig
from llm_consensus_tpu_torch.consensus.personas import default_panel
from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_consensus_tpu_torch.engine.generate import generate
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.cache import QuantKVCache, quantize_kv
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.ops import attention, kernels, quant
from llm_consensus_tpu_torch.ops.kernels import attention as ka
from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq

F32_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
# test-tiny widened to d_model 128 (as tests/test_quant.py does): K and N
# multiples of 128, so the projections and the lm_head reach the kernel.
WIDE = dict(d_model=128, n_heads=4, n_kv_heads=2, d_ff=256)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Quantization: bit-identical to the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bit_identical_to_jax(dtype):
    jcfg = j_get_config("test-tiny").with_(**WIDE)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=getattr(jnp, dtype))
    ref = _jax_tree(j_quant.quantize_params(jparams))
    got = quant.quantize_params(tt.params_from_jax(_jax_tree(jparams), device="cpu"))
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        leaf = got["blocks"][name]
        assert isinstance(leaf, quant.QuantizedTensor)
        np.testing.assert_array_equal(leaf.q.numpy(), ref["blocks"][name].q)
        np.testing.assert_array_equal(leaf.scale.numpy(), ref["blocks"][name].scale)
    np.testing.assert_array_equal(got["lm_head"].q.numpy(), ref["lm_head"].q)
    np.testing.assert_array_equal(got["lm_head"].scale.numpy(), ref["lm_head"].scale)
    assert got["embed"].dtype == getattr(torch, dtype)  # the gather table stays
    assert quant.quantized_bytes(got) == j_quant.quantized_bytes(
        j_quant.quantize_params(jparams))
    # JAX's quantized leaves carry over as QuantizedTensor, bits intact.
    carried = tt.params_from_jax(ref, device="cpu")
    np.testing.assert_array_equal(carried["blocks"]["wq"].q.numpy(), ref["blocks"]["wq"].q)
    assert carried["blocks"]["wq"].q.dtype == torch.int8
    assert tt.param_count(carried) == jt.param_count(j_quant.quantize_params(jparams))


def test_quantize_tensor_and_kv_bit_identical_with_ties():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    w[0, :, 0] = np.arange(40) - 20.5  # values at exact .5 multiples of the scale
    w[1, :, 1] = 0.0  # an all-zero channel: scale 1e-8 / 127
    for axis in (1, 2):
        ref = j_quant.quantize_tensor(jnp.asarray(w), axis)
        got = quant.quantize_tensor(torch.from_numpy(w), axis)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jq, js = j_cache.quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = quant.dequantize(quant.quantize_tensor(torch.from_numpy(w), 1), torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(j_quant.dequantize(j_quant.quantize_tensor(jnp.asarray(w), 1),
                                                   jnp.float32)))


def test_int4_and_unknown_bits_raise():
    """int4 (K10, ported) packs; unknown bit widths raise. The int4 path's
    parity with the JAX package is tests/test_torch_int4.py's."""
    params = {"blocks": {"wq": torch.zeros(1, 4, 4)}}
    q4 = quant.quantize_params(params, bits=4)["blocks"]["wq"]
    assert isinstance(q4, quant.Quantized4Tensor)
    assert q4.q.shape == (1, 2, 4) and q4.shape == (1, 4, 4)
    with pytest.raises(ValueError):
        quant.quantize_params(params, bits=3)


# ---------------------------------------------------------------------------
# K6: the W8A16 matmul
# ---------------------------------------------------------------------------


def _qweight(rng, *shape):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    return j_quant.quantize_tensor(jnp.asarray(w), len(shape) - 2)


def _leaf(jw) -> quant.QuantizedTensor:
    """A JAX QuantizedTensor's bits as the port's."""
    return quant.QuantizedTensor(torch.from_numpy(np.array(jw.q)),
                                 torch.from_numpy(np.array(jw.scale)))


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("k,n", [(256, 384), (384, 256)])
def test_quant_matmul_twin_matches_pallas_and_jax(m, k, n):
    rng = np.random.default_rng(m + k)
    jw = _qweight(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, ws = _leaf(jw).q, _leaf(jw).scale
    assert kq.quant_matmul_supported(m, k, n)
    # float32 x: against the JAX package's matmul with its kernel off.
    ref = _np(j_quant.matmul(jnp.asarray(x), jw))
    got = kq.quant_matmul_2d(_t(x), wq, ws)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    got = quant.matmul(_t(x)[None], quant.QuantizedTensor(wq, ws))  # [1, M, K] lead
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # bf16 x: against the Pallas kernel (interpret mode), one bf16 rounding.
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = _np(j_qmm.quant_matmul_2d(xb, jw.q, jw.scale, interpret=True))
    got = kq.quant_matmul_2d(_t(x, torch.bfloat16), wq, ws)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=2.0**-8,
                               atol=2.0**-8 * np.abs(pallas).max())
    # float32 out from bf16 x (the lm_head's call).
    pallas32 = _np(j_qmm.quant_matmul_2d(xb, jw.q, jw.scale, out_dtype=jnp.float32,
                                         interpret=True))
    got32 = kq.quant_matmul_2d(_t(x, torch.bfloat16), wq, ws, torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), pallas32, rtol=1e-5, atol=1e-5 * np.abs(pallas32).max())


def test_quant_matmul_stacked_twin_matches_pallas():
    rng = np.random.default_rng(9)
    jw = _qweight(rng, 3, 256, 256)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wq, ws = _leaf(jw).q, _leaf(jw).scale
    for layer in range(3):
        pallas = _np(j_qmm.quant_matmul_stacked(xb, jw.q, jw.scale, jnp.int32(layer),
                                                out_dtype=jnp.float32, interpret=True))
        got = kq.quant_matmul_stacked(_t(x, torch.bfloat16), wq, ws, layer, torch.float32)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5 * np.abs(pallas).max())


@pytest.mark.parametrize("m", [1, 4, 17, 64, 256])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 512), (5632, 2048), (2048, 32000), (384, 256)])
def test_tensor_core_splits_cut_k_in_whole_chunks(m, k, n):
    """The tensor-core K6 cuts K into parts of whole 128-row chunks, only
    while its grid holds fewer than two blocks per SM (llama-1b's shapes
    and a small one)."""
    splits = kq.tensor_core_splits(m, k, n)
    assert splits in (1, 2, 4, 8, 16) and (k // splits) % 128 == 0
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    blocks = -(-m // bm) * (n // 32)
    if splits > 1:
        assert blocks * splits // 2 < 264
    assert blocks * splits >= 264 or splits == 16 or (k // 128) % (2 * splits)


def test_large_m_takes_the_dequantize_path_in_both_packages(monkeypatch):
    rng = np.random.default_rng(10)
    m, k, n = 300, 128, 256  # M > 256: no kernel in either package
    assert not kq.quant_matmul_supported(m, k, n)
    assert not j_qmm.quant_matmul_supported(m, k, n)
    jw = _qweight(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    leaf = _leaf(jw)
    kernels.reset_launch_counts()

    def no_kernel(*a, **k):
        raise AssertionError("the kernel wrapper was called at M > 256")

    monkeypatch.setattr(quant, "quant_matmul_2d", no_kernel)
    monkeypatch.setattr(quant, "quant_matmul_2d_plain", no_kernel)
    ref = _np(j_quant.matmul(jnp.asarray(x), jw))
    np.testing.assert_allclose(quant.matmul(_t(x), leaf).numpy(), ref, **F32_TOL)
    # bf16: the weight is dequantized into bf16 first, as in the JAX package.
    refb = _np(j_quant.matmul(jnp.asarray(x).astype(jnp.bfloat16), jw))
    gotb = quant.matmul(_t(x, torch.bfloat16), leaf).float().numpy()
    np.testing.assert_allclose(gotb, refb, rtol=2.0**-7, atol=2.0**-7 * np.abs(refb).max())


def test_kernel_switch_routes_twin_or_raises_on_cpu(monkeypatch):
    rng = np.random.default_rng(11)
    jw = _qweight(rng, 128, 128)
    leaf = _leaf(jw)
    x = _t(rng.standard_normal((2, 128)))
    want = kq.quant_matmul_2d_plain(x, leaf.q, leaf.scale)
    try:
        quant.set_kernel_enabled(False)
        torch.testing.assert_close(quant.matmul(x, leaf), want, rtol=0, atol=0)
        quant.set_kernel_enabled(True)
        with pytest.raises(RuntimeError, match="CPU"):
            quant.matmul(x, leaf)
    finally:
        quant.set_kernel_enabled(None)
    torch.testing.assert_close(quant.matmul(x, leaf), want, rtol=0, atol=0)
    assert kq.quant_matmul_2d.launches == 0  # the CPU twin counts nothing


# ---------------------------------------------------------------------------
# K4, K5, K7-q8: decode over the int8 cache
# ---------------------------------------------------------------------------


def _q8_cache(rng, b, hkv, s, d, plen=0, layers=None):
    """An int8 head-major cache made by JAX's quantize_kv (rows share
    slots [0, plen)), as numpy; with ``layers``, stacked [L, ...]."""
    lead = (layers,) if layers else ()
    k = rng.standard_normal(lead + (b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal(lead + (b, hkv, s, d)).astype(np.float32)
    bax = len(lead)
    for a in (k, v):
        idx = (slice(None),) * bax
        a[idx + (slice(None), slice(None), slice(0, plen))] = a[idx + (slice(0, 1), slice(None), slice(0, plen))]
    kq_, ks = j_cache.quantize_kv(jnp.asarray(k))
    vq_, vs = j_cache.quantize_kv(jnp.asarray(v))
    return tuple(np.asarray(a) for a in (kq_, ks, vq_, vs))


def _torch(arrs):
    return tuple(torch.from_numpy(np.array(a)) for a in arrs)


@pytest.mark.parametrize("row_kernel", [True, False])
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_q8_decode_twin_matches_pallas_and_plain(row_kernel, h, hkv, monkeypatch):
    if not row_kernel:  # force Pallas' per-(batch, head) program
        monkeypatch.setattr(j_pattn, "_ROW_KERNEL_MAX_KV_BYTES", 0)
    rng = np.random.default_rng(h + hkv + row_kernel)
    b, s, d = 3, 24, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    cache = _q8_cache(rng, b, hkv, s, d)
    valid = np.array([1, 9, s], np.int32)
    jargs = (jnp.asarray(q), *map(jnp.asarray, (cache[0], cache[1], cache[2], cache[3])),
             jnp.asarray(valid))
    pallas = _np(j_pattn.flash_decode_attention_q8(*jargs, interpret=True))
    ref = _np(j_attn.decode_attention_quant(*jargs))
    kq_, ks, vq_, vs = _torch(cache)
    got = ka.flash_decode_attention_q8(_t(q), kq_, ks, vq_, vs, torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_allclose(got, ref, **F32_TOL)
    plain = attention.decode_attention_quant(_t(q), kq_, ks, vq_, vs, torch.from_numpy(valid))
    np.testing.assert_allclose(plain.numpy(), ref, **F32_TOL)


def test_q8_stacked_twin_matches_pallas():
    rng = np.random.default_rng(31)
    L, b, h, hkv, s, d = 3, 2, 4, 2, 16, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    cache = _q8_cache(rng, b, hkv, s, d, layers=L)
    valid = np.array([1, s], np.int32)
    tq = _torch(cache)
    for layer in range(L):
        pallas = _np(j_pattn.flash_decode_attention_q8_stacked(
            jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(valid), jnp.int32(layer),
            interpret=True))
        got = ka.flash_decode_attention_q8_stacked(
            _t(q), *tq, torch.from_numpy(valid), layer).numpy()
        np.testing.assert_allclose(got, pallas, **F32_TOL)


@pytest.mark.parametrize("plen", [0, 5, 32])  # 32: a full block of the 32-slot cache
def test_q8_shared_prefix_twins_match_pallas(plen):
    rng = np.random.default_rng(40 + plen)
    L, b, h, hkv, s, d = 2, 3, 4, 2, 32, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    cache = _q8_cache(rng, b, hkv, s, d, plen=plen, layers=L)
    valid = np.array([max(plen, 1), min(plen + 3, s), s], np.int32)
    tq, tv = _torch(cache), torch.from_numpy(valid)
    for layer in range(L):
        lay = tuple(a[layer] for a in cache)
        jargs = (jnp.asarray(q), *map(jnp.asarray, lay), jnp.asarray(valid))
        pallas = _np(j_pattn.flash_decode_attention_shared_prefix_q8(
            *jargs, jnp.int32(plen), interpret=True))
        got = ka.flash_decode_attention_shared_prefix_q8(_t(q), *_torch(lay), tv, plen).numpy()
        np.testing.assert_allclose(got, pallas, **F32_TOL)
        # The same as reading every row's whole cache (the K4 twin).
        np.testing.assert_allclose(
            got, ka.flash_decode_attention_q8(_t(q), *_torch(lay), tv).numpy(), **F32_TOL)
        ref = _np(j_attn.decode_attention_shared_prefix_quant(*jargs, jnp.int32(plen)))
        plain = attention.decode_attention_shared_prefix_quant(_t(q), *_torch(lay), tv, plen)
        np.testing.assert_allclose(plain.numpy(), ref, **F32_TOL)
        pallas_st = _np(j_pattn.flash_decode_attention_shared_prefix_q8_stacked(
            jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(valid), jnp.int32(plen),
            jnp.int32(layer), interpret=True))
        got_st = ka.flash_decode_attention_shared_prefix_q8_stacked(
            _t(q), *tq, tv, plen, layer).numpy()
        np.testing.assert_allclose(got_st, pallas_st, **F32_TOL)


def test_q8_shared_prefix_reads_the_prefix_from_row_zero_only():
    rng = np.random.default_rng(50)
    q = _t(rng.standard_normal((2, 1, 4, 16)))
    cache = [np.array(a) for a in _q8_cache(rng, 2, 2, 40, 16, plen=24)]
    valid = torch.tensor([30, 40], dtype=torch.int32)
    want = ka.flash_decode_attention_shared_prefix_q8(q, *_torch(cache), valid, 24)
    for a in cache:
        a[1:, :, :24] = 7  # rows > 0 hold garbage in the prefix: never read
    got = ka.flash_decode_attention_shared_prefix_q8(q, *_torch(cache), valid, 24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_q8_twins_bf16_within_one_rounding_of_fp32_oracle():
    rng = np.random.default_rng(51)
    cache = _torch(_q8_cache(rng, 4, 2, 40, 16, plen=30))
    q = _t(rng.standard_normal((4, 1, 4, 16)), torch.bfloat16)
    valid = torch.tensor([31, 33, 35, 40], dtype=torch.int32)
    for fn, extra in ((ka.flash_decode_attention_q8, ()),
                      (ka.flash_decode_attention_shared_prefix_q8, (30,))):
        got = fn(q, *cache, valid, *extra)
        assert got.dtype == torch.bfloat16
        oracle = fn(q.float(), *cache, valid, *extra)
        np.testing.assert_allclose(got.float().numpy(), oracle.numpy(),
                                   rtol=2.0**-8, atol=2.0**-8)


# ---------------------------------------------------------------------------
# The model, the generate loop and the engine on int8 weights
# ---------------------------------------------------------------------------


def _configs(use_pallas):
    return (j_get_config("test-tiny").with_(use_pallas=use_pallas, **WIDE),
            get_config("test-tiny").with_(use_pallas=use_pallas, **WIDE))


@pytest.fixture(scope="module")
def qparams():
    """float32 weights quantized by the JAX package, as a JAX tree and as
    the port's tree (carried over by params_from_jax)."""
    jcfg, _ = _configs(False)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = _jax_tree(params)
    rng = np.random.default_rng(0)
    for name in ("attn_norm", "mlp_norm"):
        a = tree["blocks"][name]
        tree["blocks"][name] = (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    qtree = _jax_tree(j_quant.quantize_params(jax.tree.map(jnp.asarray, tree)))
    return jax.tree.map(jnp.asarray, qtree), tt.params_from_jax(qtree, device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_logits_with_int8_cache_match_jax(qparams, use_pallas):
    jcfg, tcfg = _configs(use_pallas)
    jparams, tparams = qparams
    assert isinstance(tparams["blocks"]["wq"], quant.QuantizedTensor)
    rng = np.random.default_rng(1)
    b, s, steps = 3, 24, 4
    tokens = rng.integers(3, jcfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([s, 7, 15], np.int32)
    jlog, jcache = jt.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                              j_cache.QuantKVCache.create(jcfg, b, s + steps))
    tlog, tcache = tt.prefill(tcfg, tparams, torch.from_numpy(tokens),
                              torch.from_numpy(lengths), QuantKVCache.create(tcfg, b, s + steps))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    _same_int8_cache(tcache, jcache)
    for _ in range(steps):
        nxt = rng.integers(3, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jlog, jcache = jt.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache)
        tlog, tcache = tt.decode_step(tcfg, tparams, torch.from_numpy(nxt), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        _same_int8_cache(tcache, jcache)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))


def _same_int8_cache(tcache, jcache):
    """The port wrote the JAX package's quantized K/V: scales within
    float32 rounding, int8 values equal but for rare flips of one step
    (a value at a rounding boundary, its float32 activation different in
    the last bit). Then the port's cache takes JAX's values, so that each
    step's logits compare the arithmetic on the same cache."""
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        got, ref = getattr(tcache, name), np.asarray(getattr(jcache, name))
        assert got.dtype == {"k_q": torch.int8, "v_q": torch.int8}.get(name, torch.float32)
        assert got.shape == ref.shape
        if name.endswith("_q"):
            diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and np.mean(diff) < 1e-3
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)
        got.copy_(torch.from_numpy(np.array(ref)))


def _greedy(jcfg, tcfg, jparams, tparams, tokens, lengths, shared, kv_quant, new=8):
    kw = dict(max_new_tokens=new, eos_id=-1, pad_id=0, shared_prefill=shared,
              kv_quant=kv_quant)
    b = tokens.shape[0]
    jout = j_generate(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                      jax.random.PRNGKey(0), jnp.zeros((b,), jnp.float32), **kw)
    tout = generate(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
                    torch.Generator().manual_seed(0), torch.zeros(b), **kw)
    return np.asarray(jout.tokens), tout.tokens.numpy()


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n", [1, 4])
def test_greedy_generate_tokens_match_jax(qparams, n, shared, kv_quant):
    jcfg, tcfg = _configs(True)
    jparams, tparams = qparams
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, jcfg.vocab_size, (n, 16)).astype(np.int32)
    lengths = rng.integers(1, 17, (n,)).astype(np.int32)
    lengths[0] = 16
    if shared:
        tokens[:] = tokens[0]
        lengths[:] = lengths[0]
    jtok, ttok = _greedy(jcfg, tcfg, jparams, tparams, tokens, lengths, shared, kv_quant)
    np.testing.assert_array_equal(ttok, jtok)
    if kv_quant:  # the stacked-decode wrappers give the same tokens
        try:
            tt.set_stacked_decode(True)
            _, stacked = _greedy(jcfg, tcfg, jparams, tparams, tokens, lengths, shared, kv_quant)
        finally:
            tt.set_stacked_decode(False)
        np.testing.assert_array_equal(stacked, ttok)


def test_int8_engine_text_and_transcript_equal_jax(qparams):
    jcfg, tcfg = _configs(False)
    jparams, tparams = qparams
    # The engines get the already-quantized trees (JAX's own quantize_params
    # ran once); quant="int8" on a quantized tree leaves it as it is.
    ec = dict(max_new_tokens=6, seq_buckets=(32,), batch_buckets=(1, 2, 4, 8),
              quant="int8", kv_quant=True)
    jeng = JInferenceEngine(jcfg, jparams, engine_config=JEngineConfig(**ec))
    teng = InferenceEngine(tcfg, tparams, engine_config=EngineConfig(**ec), device="cpu")
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


def test_engine_quantizes_at_init_and_int8_init_matches():
    cfg = get_config("test-tiny").with_(**WIDE)
    params = tt.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    eng = InferenceEngine(cfg, params, engine_config=EngineConfig(quant="int8", kv_quant=True),
                          device="cpu")
    assert isinstance(eng.params["lm_head"], quant.QuantizedTensor)
    assert eng.params["embed"].dtype == torch.float32
    direct = tt.init_params_quantized(cfg, 0, dtype=torch.float32, device="cpu")
    torch.testing.assert_close(direct["blocks"]["w_up"].q, eng.params["blocks"]["w_up"].q)
    with pytest.raises(ValueError):
        InferenceEngine(cfg, params, engine_config=EngineConfig(quant="int3"), device="cpu")


def test_cli_int8_question_runs_and_int4_raises(capsys):
    """Both quantized modes answer a question (int4 no longer raises:
    K10 is ported)."""
    from llm_consensus_tpu_torch import cli

    args = ["--backend", "local", "--cpu", "--model", "test-tiny", "--max-new-tokens", "4",
            "--max-rounds", "1", "--seed", "1", "--question", "hi"]
    assert cli.main(args + ["--quant", "int8"]) == 0
    assert cli.main(args + ["--quant", "int4"]) == 0


# ---------------------------------------------------------------------------
# On the card: each int8 kernel against its twin (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kernels_match_twins_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)

    def close(got, ref):  # float32: sum order; bf16: one rounding of each element
        tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs() + 1e-5
        assert bool(((got.float() - ref.float()).abs() <= tol).all())

    x = torch.randn(5, 256, generator=g, device=cuda).to(dtype)
    w = quant.quantize_tensor(torch.randn(256, 384, generator=g, device=cuda) * 0.02, 0)
    close(kq.quant_matmul_2d(x, w.q, w.scale), kq.quant_matmul_2d_plain(x, w.q, w.scale))
    for d in (64, 128):
        q = torch.randn(3, 1, 8, d, generator=g, device=cuda).to(dtype)
        kv = [quantize_kv(torch.randn(2, 3, 2, 70, d, generator=g, device=cuda)) for _ in (0, 1)]
        k_q, k_s, v_q, v_s = kv[0][0], kv[0][1], kv[1][0], kv[1][1]
        for t in (k_q, k_s, v_q, v_s):
            t[:, :, :, :40] = t[:, :1, :, :40].clone()
        vl = torch.tensor([41, 55, 70], dtype=torch.int32, device=cuda)
        lay = (k_q[1], k_s[1], v_q[1], v_s[1])
        ref = ka.flash_decode_attention_q8_plain(q, *lay, vl)
        close(ka.flash_decode_attention_q8(q, *lay, vl), ref)
        close(ka.flash_decode_attention_q8_stacked(q, k_q, k_s, v_q, v_s, vl, 1), ref)
        ref = ka.flash_decode_attention_shared_prefix_q8_plain(q, *lay, vl, 40)
        close(ka.flash_decode_attention_shared_prefix_q8(q, *lay, vl, 40), ref)
        close(ka.flash_decode_attention_shared_prefix_q8_stacked(
            q, k_q, k_s, v_q, v_s, vl, 40, 1), ref)
