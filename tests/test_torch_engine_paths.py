"""The port's prefix-cached generation, multi-token stops, streaming,
scoring and engine counters against the JAX package's, in float32 on the
CPU (test-tiny and test-tiny-moe weights from JAX's ``init_params``).

Function level (``generate_from_prefix``, ``decode_steps``,
``score_completions``): the same tokens, logprobs within 1e-4 (each side
on the same cache types). Engine level: greedy text, token ids and
``num_tokens`` identical to the JAX engine's, for the prefix path (plain,
int8 cache, MoE at the dense threshold), multi-token stops (also with a
prefix and with the int8 cache), ``generate_stream`` and
``score_texts``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_consensus_tpu.engine.engine import InferenceEngine as JInferenceEngine
from llm_consensus_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.cache import KVCache as JKVCache
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_consensus_tpu_torch.engine.prefix_cache import PrefixCache
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.cache import KVCache
from llm_consensus_tpu_torch.models.configs import get_config

# The modules (each package's ``engine.generate`` attribute is the function).
jg = importlib.import_module("llm_consensus_tpu.engine.generate")
tg = importlib.import_module("llm_consensus_tpu_torch.engine.generate")
TOL = dict(rtol=0, atol=1e-4)
PROMPTS = ["What is 2+2?", "Name a color please now."]
EC = dict(max_new_tokens=12, seq_buckets=(16, 32, 64), batch_buckets=(1, 2, 4),
          stop_check_chunk=4)


def _weights(name="test-tiny", **over):
    jcfg = j_get_config(name).with_(**over)
    tcfg = get_config(name).with_(**over)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, tcfg, jparams, tt.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _weights()


@pytest.fixture(scope="module")
def engines(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    return {
        kv: (JInferenceEngine(jcfg, jparams, engine_config=JEngineConfig(kv_quant=kv, **EC)),
             InferenceEngine(tcfg, tparams, engine_config=EngineConfig(kv_quant=kv, **EC),
                             device="cpu"))
        for kv in (False, True)
    }


def _same_results(got, ref):
    assert [r.token_ids for r in got] == [r.token_ids for r in ref]
    assert [r.text for r in got] == [r.text for r in ref], ascii([r.text for r in got])
    assert [r.num_tokens for r in got] == [r.num_tokens for r in ref]


# ---------------------------------------------------------------------------
# Function level
# ---------------------------------------------------------------------------


def _prefix_inputs(cfg_pair, params_pair):
    """A prefilled 25-token prefix (float32, bucket padded to 32) on both
    sides and two right-padded suffixes."""
    (jcfg, tcfg), (jparams, tparams) = cfg_pair, params_pair
    tok = ByteTokenizer()
    ids = tok.encode("Shared few-shot header. ")
    p = len(ids)
    pad = np.zeros((1, 32), np.int32)
    pad[0, :p] = ids
    _, jc = jt.prefill(jcfg, jparams, jnp.asarray(pad), jnp.asarray([p], jnp.int32),
                       JKVCache.create(jcfg, 1, 32, jnp.float32))
    _, tc = tt.prefill(tcfg, tparams, torch.from_numpy(pad), torch.tensor([p], dtype=torch.int32),
                       KVCache.create(tcfg, 1, 32, torch.float32))
    suf = [tok.encode(s, add_bos=False) for s in ("What is 2+2?", "Name a color now.")]
    tokens = np.zeros((2, 24), np.int32)
    for i, x in enumerate(suf):
        tokens[i, : len(x)] = x
    return ids, (jc, tc), tokens, np.array([len(x) for x in suf], np.int32)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_generate_from_prefix_matches_jax_and_concatenated(tiny, shared, kv_quant):
    jcfg, tcfg, jparams, tparams = tiny
    ids, (jc, tc), tokens, lengths = _prefix_inputs((jcfg, tcfg), (jparams, tparams))
    if shared:
        tokens, lengths = np.repeat(tokens[:1], 2, 0), np.repeat(lengths[:1], 2)
    kw = dict(max_new_tokens=6, shared_suffix=shared, kv_quant=kv_quant)
    ref = jg.generate_from_prefix(
        jcfg, jparams, jc.k, jc.v, jnp.asarray(len(ids), jnp.int32), jnp.asarray(tokens),
        jnp.asarray(lengths), jax.random.PRNGKey(0), jnp.zeros(2), **kw)
    got = tg.generate_from_prefix(
        tcfg, tparams, tc.k, tc.v, len(ids), torch.from_numpy(tokens),
        torch.from_numpy(lengths), torch.Generator().manual_seed(0), torch.zeros(2), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_tokens.numpy(), np.asarray(ref.num_tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(), np.asarray(ref.logprob_sum), **TOL)
    if not kv_quant:  # the same as generating on the concatenated prompts
        full = np.zeros((2, 64), np.int32)
        for r in range(2):
            full[r, : len(ids) + lengths[r]] = ids + tokens[r, : lengths[r]].tolist()
        plain = tg.generate(tcfg, tparams, torch.from_numpy(full),
                            torch.from_numpy(len(ids) + lengths), torch.Generator().manual_seed(0),
                            torch.zeros(2), max_new_tokens=6)
        np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())


def test_decode_steps_match_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    tokens = np.random.default_rng(0).integers(3, 250, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 4], np.int32)
    jl, jc = jt.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                        JKVCache.create(jcfg, 3, 32, jnp.float32))
    tl, tc = tt.prefill(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
                        KVCache.create(tcfg, 3, 32, torch.float32))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    done = np.array([False, True, False])
    # EOS (2) and a single-token stop end rows in both.
    stop = (int(tok[2]),)
    ref = jg.decode_steps(jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(done),
                          jax.random.PRNGKey(0), jnp.zeros(3), steps=5, stop_ids=stop)
    got = tg.decode_steps(tcfg, tparams, tc, torch.from_numpy(tok), torch.from_numpy(done),
                          torch.Generator().manual_seed(0), torch.zeros(3), steps=5,
                          stop_ids=stop)
    for i in (0, 1, 3, 4):  # tokens, live, done, last token
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), **TOL)
    np.testing.assert_array_equal(got[2].length.numpy(), np.asarray(ref[2].length))


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-moe"])
def test_score_completions_match_jax(name):
    jcfg, tcfg, jparams, tparams = _weights(
        name, **({"moe_capacity_factor": 1.0, "moe_dense_decode_tokens": 0}
                 if name.endswith("moe") else {}))
    rng = np.random.default_rng(1)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :11] = rng.integers(3, 250, 11)
    comp = rng.integers(3, 250, (3, 8)).astype(np.int32)
    clens = np.array([8, 3, 5], np.int32)
    ref = jg.score_completions(jcfg, jparams, jnp.asarray(prompt), jnp.asarray([11], jnp.int32),
                               jnp.asarray(comp), jnp.asarray(clens), cache_len=24)
    got = tg.score_completions(tcfg, tparams, torch.from_numpy(prompt),
                               torch.tensor([11], dtype=torch.int32), torch.from_numpy(comp),
                               torch.from_numpy(clens), cache_len=24)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_prefix_cache_lru_and_budgets():
    for cls, k in ((PrefixCache, torch.zeros((1, 1, 4, 1, 2), dtype=torch.bfloat16)),
                   (JPrefixCache, jnp.zeros((1, 1, 4, 1, 2), jnp.bfloat16))):
        pc = cls(max_entries=2)
        pc.put((1,), k, k)
        pc.put((2,), k, k)
        assert pc.get((1,)) is not None  # refresh (1,)
        pc.put((3,), k, k)  # evicts (2,)
        assert pc.get((2,)) is None
        assert pc.get((1,)) is not None and pc.get((3,)) is not None
        assert (pc.stats.evictions, pc.stats.hits, pc.stats.misses) == (1, 3, 1)
        assert pc.stats.hit_rate == 0.75 and pc.nbytes == 2 * 2 * 16
        small = cls(max_entries=8, max_bytes=4 * 8)
        small.put((1,), k, k)
        small.put((2,), k, k)  # 2 entries of 32 bytes > 32: evict
        assert len(small) == 1 and small.nbytes <= 32
        small.put((2,), k, k)  # re-put replaces, no double count
        assert small.nbytes == 32
        small.clear()
        assert (len(small), small.nbytes, small.stats.evictions) == (0, 0, 2)
    with pytest.raises(ValueError):
        PrefixCache(max_entries=0)


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_prefix_text_equals_jax_and_rides_the_cache(engines, kv_quant):
    jeng, teng = engines[kv_quant]
    teng.prefix_cache.clear()
    prefix = "Header text: "
    ref = jeng.generate_texts(PROMPTS, temperatures=[0.0, 0.0], prefix=prefix)
    got = teng.generate_texts(PROMPTS, temperatures=[0.0, 0.0], prefix=prefix)
    _same_results(got, ref)
    hits = teng.prefix_cache.stats.hits
    again = teng.generate_texts(PROMPTS, temperatures=[0.0, 0.0], prefix=prefix)
    assert teng.prefix_cache.stats.hits == hits + 1 and len(teng.prefix_cache) == 1
    assert [r.text for r in again] == [r.text for r in got]
    # The shared-suffix fan-out under a cached header.
    _same_results(teng.generate_texts(["same q"] * 4, temperatures=[0.0] * 4, prefix=prefix),
                  jeng.generate_texts(["same q"] * 4, temperatures=[0.0] * 4, prefix=prefix))


def test_engine_prefix_falls_back_like_jax(engines):
    jeng, teng = engines[False]
    long_prefix = "x" * 300  # beyond the context with any suffix: plain path
    for prefix, prompts in ((long_prefix, PROMPTS), ("Header: ", ["", "q"])):
        _same_results(
            teng.generate_texts(prompts, temperatures=[0.0, 0.0], prefix=prefix),
            jeng.generate_texts(prompts, temperatures=[0.0, 0.0], prefix=prefix))


def test_engine_prefix_moe_straddles_dense_threshold():
    """The JAX package's case: a 21-token header's pow2 bucket (32)
    overshoots moe_dense_decode_tokens where the concatenated prompt's
    count sits under it; the suffix chunk must take the dense path, as
    the plain path does. The port's prefix path, its plain path and
    both JAX paths give the same text."""
    tok = ByteTokenizer()
    over = dict(moe_capacity_factor=1.0, moe_dense_decode_tokens=64)
    jcfg, tcfg, jparams, tparams = _weights("test-tiny-moe", **over)
    ec = dict(max_new_tokens=6, seq_buckets=(8, 32), batch_buckets=(1, 2, 4))
    prefix, prompts = "Shared header text. ", ["2+2=", "3+3="]
    p = len(tok.encode(prefix))
    assert tcfg.moe_dense_at(2 * (p + 8)) and not tcfg.moe_dense_at(2 * (32 + 8))
    jeng = JInferenceEngine(jcfg, jparams, engine_config=JEngineConfig(**ec))
    teng = InferenceEngine(tcfg, tparams, engine_config=EngineConfig(**ec), device="cpu")
    kw = dict(temperatures=[0.0, 0.0], seed=7)
    got = teng.generate_texts(prompts, prefix=prefix, **kw)
    assert teng.prefix_cache.stats.misses == 1
    _same_results(got, jeng.generate_texts(prompts, prefix=prefix, **kw))
    concat = [prefix + q for q in prompts]
    _same_results(got, teng.generate_texts(concat, **kw))
    _same_results(got, jeng.generate_texts(concat, **kw))
    dense = InferenceEngine(tcfg.with_moe_dense_up_to(tcfg.max_seq_len ** 2), tparams,
                            engine_config=teng.config, device="cpu")
    want = dense.generate_texts(prompts, prefix=prefix, **kw)
    np.testing.assert_allclose([r.logprob for r in got], [r.logprob for r in want], atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "prefix", "kv_quant"])
def test_multi_token_stop_text_and_accounting_equal_jax(engines, case):
    jeng, teng = engines[case == "kv_quant"]
    kw = dict(temperatures=[0.0, 0.0])
    if case == "prefix":
        kw["prefix"] = "Header text: "
    base = teng.generate_texts(PROMPTS, **kw)
    stop = [base[0].text[4:6], "\n\n"]  # a two-byte stop the first row hits
    ref = jeng.generate_texts(PROMPTS, stop=stop, **kw)
    got = teng.generate_texts(PROMPTS, stop=stop, **kw)
    _same_results(got, ref)
    np.testing.assert_allclose([r.logprob for r in got], [r.logprob for r in ref], atol=1e-3)
    assert got[0].num_tokens < base[0].num_tokens
    assert all(s not in r.text for s in stop for r in got)


def test_multi_token_stop_accounting_equals_the_single_token_path(engines):
    """The stop's tokens count like EOS's: a stop of one byte (device
    path) and the same stop preceded by the byte before it (chunked path)
    end at the same token."""
    _, teng = engines[False]
    base = teng.generate_texts(PROMPTS[:1], temperatures=[0.0])[0]
    one = teng.generate_texts(PROMPTS[:1], temperatures=[0.0], stop=[base.text[5]])[0]
    two = teng.generate_texts(PROMPTS[:1], temperatures=[0.0], stop=[base.text[4:6]])[0]
    assert base.text.find(base.text[5]) == 5 and base.text.find(base.text[4:6]) == 4
    assert (one.num_tokens, one.token_ids) == (two.num_tokens, two.token_ids)
    np.testing.assert_allclose(one.logprob, two.logprob, rtol=1e-5)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_generate_stream_equals_jax_and_generate_texts(engines, kv_quant):
    jeng, teng = engines[kv_quant]
    for prompt in PROMPTS:
        pieces = list(teng.generate_stream(prompt, chunk=3))
        assert "".join(pieces) == "".join(jeng.generate_stream(prompt, chunk=3))
        assert "".join(pieces) == teng.generate_texts([prompt], temperatures=[0.0])[0].text
        assert len(pieces) > 1
    stop = [teng.generate_texts(PROMPTS[:1], temperatures=[0.0])[0].text[3:5]]
    got = "".join(teng.generate_stream(PROMPTS[0], chunk=2, stop=stop))
    assert got == "".join(jeng.generate_stream(PROMPTS[0], chunk=2, stop=stop))
    assert got == teng.generate_texts(PROMPTS[:1], temperatures=[0.0], stop=stop)[0].text


def test_score_texts_equal_jax_in_any_order(engines):
    jeng, teng = engines[False]
    comps = ["abc", "hello there", "a much longer completion here"]
    got = teng.score_texts("Q: hi", comps)
    np.testing.assert_allclose(got, jeng.score_texts("Q: hi", comps), **TOL)
    rev = teng.score_texts("Q: hi", comps[::-1])
    np.testing.assert_array_equal(rev[::-1], got)
    assert all(np.isfinite(got))
    norm = teng.score_texts("Q: hi", comps, normalize=True)
    np.testing.assert_allclose(norm, jeng.score_texts("Q: hi", comps, normalize=True), **TOL)
    many = teng.score_texts("Q: hi", comps * 2)  # past the largest batch bucket: chunks
    np.testing.assert_allclose(many, got * 2, **TOL)
    with pytest.raises(ValueError, match="empty"):
        teng.score_texts("Q: hi", ["ok", ""])
    assert teng.score_texts("Q: hi", []) == []


def test_engine_stats_count_api_calls_like_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    jeng = JInferenceEngine(jcfg, jparams, engine_config=JEngineConfig(**EC))
    teng = InferenceEngine(tcfg, tparams, engine_config=EngineConfig(**EC), device="cpu")
    for eng in (jeng, teng):
        eng.generate_texts(["a"] * 5, max_new_tokens=2)  # one call, two chunks
        eng.generate_texts(["b"], prefix="Header: ", max_new_tokens=2)
        list(eng.generate_stream("c", max_new_tokens=3))
        eng.score_texts("d", ["e"] * 5)
    got, ref = teng.stats(), jeng.stats()
    assert got["calls"] == {k: ref["calls"][k] for k in got["calls"]}
    assert got["calls"] == {"generate": 2, "stream": 1, "score": 1}
    assert got["tokens_generated"] == ref["tokens_generated"]
    pc, jpc = got["prefix_cache"], ref["prefix_cache"]
    assert {k: pc[k] for k in ("hits", "misses", "evictions", "entries")} == {
        k: jpc[k] for k in ("hits", "misses", "evictions", "entries")}
    assert pc["bytes"] == sum(t.numel() * 4 for t in teng.prefix_cache.get(
        tuple(teng.tokenizer.encode("Header: "))))
