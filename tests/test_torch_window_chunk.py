"""Sliding windows and the chunk mode of the port's model against the
JAX package's, on the same weights and inputs, in float32 on the CPU.

- test-tiny with ``sliding_window=8``: prefill, decode and
  ``decode_chunk`` past the window give JAX's logits within 1e-4, over
  the float32 cache and over the int8 cache; a windowed config reaches
  none of the causal, decode or shared-prefix attention kernels (the JAX
  package routes it around its kernels at the same places);
- ``prefill_chunked`` gives JAX's logits and the one-shot prefill's
  within 1e-4 and writes the one-shot cache. Over the int8 cache the
  first layer's entries are bit-identical to the one-shot prefill's; the
  later layers' differ by at most one int8 step in a few entries, exactly
  where the JAX package's do (a chunk attends over the dequantized cache,
  the one-shot prefill over its float K/V, so the next layer's K/V differ
  in the last bits). Chunked engines give the one-shot text.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.cache import KVCache as JKVCache
from llm_consensus_tpu.models.cache import QuantKVCache as JQuantKVCache
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_consensus_tpu_torch.engine.generate import generate
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.ops import kernels

LOGIT_TOL = dict(rtol=0, atol=1e-4)
WINDOW = dict(sliding_window=8)


@functools.lru_cache(maxsize=None)  # the window changes no shape: one draw serves all
def _weights(seed):
    jparams = jt.init_params(j_get_config("test-tiny"), jax.random.PRNGKey(seed),
                             dtype=jnp.float32)
    return jparams, tt.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _setup(over, seed=0):
    jcfg = j_get_config("test-tiny").with_(**over)
    tcfg = get_config("test-tiny").with_(**over)
    return (jcfg, tcfg, *_weights(seed))


def _caches(jcfg, tcfg, b, n, kv_quant):
    if kv_quant:
        return JQuantKVCache.create(jcfg, b, n), QuantKVCache.create(tcfg, b, n)
    return JKVCache.create(jcfg, b, n, jnp.float32), KVCache.create(tcfg, b, n, torch.float32)


def _take_jax_cache(tcache, jcache):
    """int8: the port's cache takes JAX's values (a float32 last-bit
    difference can move an entry one int8 step), so that each step's
    logits compare the arithmetic on the same cache."""
    for t, j in zip(tcache.leaves, (jcache.k_q, jcache.v_q, jcache.k_scale, jcache.v_scale)):
        diff = np.abs(t.numpy().astype(np.float64) - np.asarray(j).astype(np.float64))
        assert diff.max() <= (1 if t.dtype == torch.int8 else 1e-6)
        t.copy_(torch.from_numpy(np.array(j)))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_windowed_prefill_decode_and_chunk_past_the_window_match_jax(kv_quant):
    jcfg, tcfg, jparams, tparams = _setup(WINDOW)
    rng = np.random.default_rng(0)
    b, s = 3, 24  # three windows' worth of prompt
    tokens = rng.integers(3, 250, (b, s)).astype(np.int32)
    lengths = np.array([24, 13, 5], np.int32)
    jc, tc = _caches(jcfg, tcfg, b, s + 12, kv_quant)
    jl, jc = jt.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths), jc)
    tl, tc = tt.prefill(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for _ in range(3):
        if kv_quant:
            _take_jax_cache(tc, jc)
        nxt = rng.integers(3, 250, (b, 1)).astype(np.int32)
        jl, jc = jt.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        tl, tc = tt.decode_step(tcfg, tparams, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    if kv_quant:
        _take_jax_cache(tc, jc)
    chunk = rng.integers(3, 250, (b, 6)).astype(np.int32)
    jl, jc = jt.decode_chunk(jcfg, jparams, jnp.asarray(chunk), jc)
    tl, tc = tt.decode_chunk(tcfg, tparams, torch.from_numpy(chunk), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_window_changes_the_logits():
    """The window is live at these lengths: the same weights without it
    give other logits."""
    _, tcfg, _, tparams = _setup(WINDOW)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(3, 250, (1, 20)))
    windowed = tt.forward(tcfg, tparams, tokens)
    full = tt.forward(tcfg.with_(sliding_window=0), tparams, tokens)
    assert float((windowed[0, :8] - full[0, :8]).abs().max()) == 0.0
    assert float((windowed[0, 9:] - full[0, 9:]).abs().max()) > 1e-3


@pytest.mark.parametrize("kv_quant", [False, True])
def test_windowed_config_reaches_no_attention_kernel(monkeypatch, kv_quant):
    """Windowed prefill, decode and the shared-prefix fan-out take the
    plain ops; the same config without a window reaches the kernels'
    wrappers (here their CPU twins)."""
    names = ("flash_causal_attention", "flash_decode_attention",
             "flash_decode_attention_shared_prefix", "flash_decode_attention_q8",
             "flash_decode_attention_shared_prefix_q8")
    called = []
    for name in names:
        real = getattr(kernels, name)

        def spy(*a, _real=real, _name=name, **kw):
            called.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(kernels, name, spy)
    _, tcfg, _, tparams = _setup(WINDOW)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(3, 250, (4, 16)))
    lengths = torch.full((4,), 16, dtype=torch.int32)

    def run(cfg):
        called.clear()
        generate(cfg, tparams, tokens, lengths, torch.Generator().manual_seed(0),
                 torch.zeros(4), max_new_tokens=4, kv_quant=kv_quant)
        generate(cfg, tparams, tokens[:1].expand(4, -1), lengths,
                 torch.Generator().manual_seed(0), torch.zeros(4), max_new_tokens=4,
                 shared_prefill=True, kv_quant=kv_quant)
        return set(called)

    assert run(tcfg) == set()
    decode = "flash_decode_attention_q8" if kv_quant else "flash_decode_attention"
    assert run(tcfg.with_(sliding_window=0)) == {
        "flash_causal_attention", decode, decode.replace("attention", "attention_shared_prefix")}


@pytest.mark.parametrize("over", [{}, WINDOW], ids=["full", "window"])
def test_prefill_chunked_matches_jax_and_the_oneshot_prefill(over):
    jcfg, tcfg, jparams, tparams = _setup(over)
    rng = np.random.default_rng(3)
    b, s = 2, 20  # not a multiple of the chunk: the last chunk is padded
    tokens = rng.integers(3, 250, (b, s)).astype(np.int32)
    lengths = np.array([20, 11], np.int32)
    jc, tc = _caches(jcfg, tcfg, b, s + 8, False)
    jl, jc = jt.prefill_chunked(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                                jc, chunk=8)
    tl, tc = tt.prefill_chunked(tcfg, tparams, torch.from_numpy(tokens),
                                torch.from_numpy(lengths), tc, chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc.length.numpy(), lengths)
    ol, oc = tt.prefill(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
                        KVCache.create(tcfg, b, s + 8, torch.float32))
    np.testing.assert_allclose(tl.numpy(), ol.numpy(), **LOGIT_TOL)
    for r, n in enumerate(lengths):
        torch.testing.assert_close(tc.k[:, r, :n], oc.k[:, r, :n], rtol=0, atol=1e-6)


def test_prefill_chunked_past_the_cache_end_drops_the_pad_writes():
    """A padded last chunk reaching past the cache writes nothing there
    (the JAX scatter drops such writes): a 20-token prompt in chunks of 8
    into a 22-slot cache."""
    jcfg, tcfg, jparams, tparams = _setup({})
    tokens = np.random.default_rng(4).integers(3, 250, (1, 20)).astype(np.int32)
    lengths = np.array([20], np.int32)
    jl, _ = jt.prefill_chunked(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                               JKVCache.create(jcfg, 1, 22, jnp.float32), chunk=8)
    tl, _ = tt.prefill_chunked(tcfg, tparams, torch.from_numpy(tokens),
                               torch.from_numpy(lengths), KVCache.create(tcfg, 1, 22, torch.float32),
                               chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_chunked_int8_cache_equals_oneshot_as_in_jax():
    jcfg, tcfg, jparams, tparams = _setup({})
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, 250, (2, 24)).astype(np.int32)
    lengths = np.array([24, 10], np.int32)

    def jax_cache(fn, **kw):
        _, c = fn(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                  JQuantKVCache.create(jcfg, 2, 32), **kw)
        return [np.asarray(x)[:, :, :, :24] for x in (c.k_q, c.v_q)]

    def port_cache(fn, **kw):
        _, c = fn(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
                  QuantKVCache.create(tcfg, 2, 32), **kw)
        return [x[:, :, :, :24].numpy() for x in (c.k_q, c.v_q)]

    chunked, oneshot = port_cache(tt.prefill_chunked, chunk=8), port_cache(tt.prefill)
    j_chunked, j_oneshot = jax_cache(jt.prefill_chunked, chunk=8), jax_cache(jt.prefill)
    for a, b, ja, jb in zip(chunked, oneshot, j_chunked, j_oneshot):
        np.testing.assert_array_equal(a[0], b[0])  # the first layer: bit for bit
        moved = a.astype(np.int32) != b.astype(np.int32)
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        np.testing.assert_array_equal(moved, ja.astype(np.int32) != jb.astype(np.int32))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_chunked_prefill_engine_text_equals_oneshot(kv_quant):
    _, tcfg, _, tparams = _setup({})
    base = dict(max_new_tokens=5, seq_buckets=(32,), batch_buckets=(1, 2), kv_quant=kv_quant)
    oneshot = InferenceEngine(tcfg, tparams, engine_config=EngineConfig(**base), device="cpu")
    chunked = InferenceEngine(tcfg, tparams, device="cpu",
                              engine_config=EngineConfig(prefill_chunk=8, **base))
    prompts = ["the quick brown fox jumps over", "a longer test prompt here"]
    want = [r.text for r in oneshot.generate_texts(prompts)]
    assert [r.text for r in chunked.generate_texts(prompts)] == want
