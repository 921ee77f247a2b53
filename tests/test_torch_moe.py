"""The port's MoE model (Mixtral's layout) against the JAX package's, on
the same weights (JAX ``init_params``, carried over with
``params_from_jax``) and the same numpy inputs, in float32 on the CPU.

- the dense all-experts path and the capacity-bounded dispatch (pinned
  with ``moe_dense_decode_tokens=0`` and a capacity factor that binds)
  give the JAX package's prefill, decode, chunk and forward logits within
  1e-4, and its router aux losses;
- the int8 and int4 expert leaves are bit-equal to JAX's ``q`` and
  scales, and the quantized model's logits agree within 1e-4;
- the router's top-k keeps ``jax.lax.top_k``'s order on ties;
- greedy text is identical;
- ``plan_memory`` for mixtral-8x7b equals the JAX package's bytes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_consensus_tpu.engine.engine import InferenceEngine as JInferenceEngine
from llm_consensus_tpu.engine.engine import plan_memory as j_plan_memory
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.cache import KVCache as JKVCache
from llm_consensus_tpu.models.cache import QuantKVCache as JQuantKVCache
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu.ops import quant as j_quant
from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine, plan_memory
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.ops import quant

LOGIT_TOL = dict(rtol=0, atol=1e-4)
# "capacity": the dispatch at every shape, capacity C = T * k / E (binds
# for any routing that is not perfectly even).
PATHS = {
    "dense": {},
    "capacity": dict(moe_capacity_factor=1.0, moe_dense_decode_tokens=0),
}


@functools.lru_cache(maxsize=None)  # the path changes no shape: one draw a bits
def _weights(bits):
    jparams = jt.init_params(j_get_config("test-tiny-moe"), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
    if bits:
        jparams = j_quant.quantize_params(jparams, bits=bits)
    return jparams, tt.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _setup(path, use_pallas=True, bits=0):
    over = PATHS[path]
    jcfg = j_get_config("test-tiny-moe").with_(use_pallas=use_pallas, **over)
    tcfg = get_config("test-tiny-moe").with_(use_pallas=use_pallas, **over)
    return (jcfg, tcfg, *_weights(bits))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)


# The port takes the kernels' twins either way on the CPU; both settings
# on the capacity path, whose dispatch JAX's use_pallas does not change.
@pytest.mark.parametrize("path, use_pallas",
                         [("dense", True), ("capacity", False), ("capacity", True)])
def test_moe_prefill_decode_chunk_logits_match_jax(path, use_pallas):
    jcfg, tcfg, jparams, tparams = _setup(path, use_pallas)
    rng = np.random.default_rng(0)
    b, s = 3, 24
    tokens = rng.integers(3, 250, (b, s)).astype(np.int32)
    lengths = np.array([24, 13, 5], np.int32)
    jl, jc = jt.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                        JKVCache.create(jcfg, b, s + 12, jnp.float32))
    tl, tc = tt.prefill(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
                        KVCache.create(tcfg, b, s + 12, torch.float32))
    _close(tl, jl)
    for _ in range(3):
        nxt = rng.integers(3, 250, (b, 1)).astype(np.int32)
        jl, jc = jt.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        tl, tc = tt.decode_step(tcfg, tparams, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    chunk = rng.integers(3, 250, (b, 5)).astype(np.int32)
    jl, jc = jt.decode_chunk(jcfg, jparams, jnp.asarray(chunk), jc)
    tl, tc = tt.decode_chunk(tcfg, tparams, torch.from_numpy(chunk), tc)
    _close(tl, jl)
    _close(tc.k, jc.k)


@pytest.mark.parametrize("path", list(PATHS))
def test_moe_forward_and_router_aux_match_jax(path):
    jcfg, tcfg, jparams, tparams = _setup(path, use_pallas=False)
    tokens = np.random.default_rng(1).integers(3, 250, (2, 20)).astype(np.int32)
    jl, jaux = jt.forward(jcfg, jparams, jnp.asarray(tokens), return_moe_aux=True)
    tl, taux = tt.forward(tcfg, tparams, torch.from_numpy(tokens), return_moe_aux=True)
    _close(tl, jl)
    for k in ("load_balance", "z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)
    # Dense models report zeros, as the JAX package's.
    dense = get_config("test-tiny")
    _, aux = tt.forward(dense, tt.init_params(dense, 0, dtype=torch.float32, device="cpu"),
                        torch.from_numpy(tokens), return_moe_aux=True)
    assert float(aux["load_balance"]) == 0.0 and float(aux["z_loss"]) == 0.0


def test_moe_router_aux_matches_jax_on_given_logits():
    cfg, jcfg = get_config("test-tiny-moe"), j_get_config("test-tiny-moe")
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, cfg.n_experts)).astype(np.float32) * 3
    idx = np.argsort(-logits, axis=-1)[..., :2].astype(np.int32)
    ref = jt.moe_router_aux(jcfg, jnp.asarray(logits), jnp.asarray(idx))
    got = tt.moe_router_aux(cfg, torch.from_numpy(logits), torch.from_numpy(idx))
    for k in ("load_balance", "z_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)


def test_router_top_k_takes_the_lower_index_on_ties():
    logits = np.array([[0.5, 2.0, 2.0, 2.0], [1.0, 1.0, 1.0, 1.0], [3.0, -1.0, 3.0, 0.0]],
                      np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 2)
    tv, ti = tt._top_k(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_moe_expert_leaves_quantize_bit_equal_to_jax(bits, dtype):
    jcfg = j_get_config("test-tiny-moe")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(3), dtype=getattr(jnp, dtype))
    ref = jax.tree.map(np.asarray, j_quant.quantize_params(jparams, bits=bits))
    got = quant.quantize_params(
        tt.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"), bits=bits)
    cls = quant.QuantizedTensor if bits == 8 else quant.Quantized4Tensor
    for name in ("w_gate", "w_up", "w_down"):
        leaf = got["blocks"][name]
        assert isinstance(leaf, cls) and leaf.q.ndim == 4
        np.testing.assert_array_equal(leaf.q.numpy(), ref["blocks"][name].q)
        np.testing.assert_array_equal(leaf.scale.numpy(), ref["blocks"][name].scale)
    # The router stays as it was, as norms and the embedding do.
    assert isinstance(got["blocks"]["router"], torch.Tensor)
    assert str(got["blocks"]["router"].dtype).endswith(dtype)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_moe_logits_match_jax(bits, kv_quant):
    jcfg, tcfg, jparams, tparams = _setup("capacity", use_pallas=False, bits=bits)
    rng = np.random.default_rng(4)
    b, s = 2, 20
    tokens = rng.integers(3, 250, (b, s)).astype(np.int32)
    lengths = np.array([20, 9], np.int32)
    if kv_quant:
        jc0, tc0 = JQuantKVCache.create(jcfg, b, s + 4), QuantKVCache.create(tcfg, b, s + 4)
    else:
        jc0 = JKVCache.create(jcfg, b, s + 4, jnp.float32)
        tc0 = KVCache.create(tcfg, b, s + 4, torch.float32)
    jl, jc = jt.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths), jc0)
    tl, tc = tt.prefill(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths), tc0)
    _close(tl, jl)
    nxt = rng.integers(3, 250, (b, 1)).astype(np.int32)
    if kv_quant:  # compare the step's arithmetic on the same cache
        for name in ("k_q", "v_q", "k_scale", "v_scale"):
            getattr(tc, name).copy_(torch.from_numpy(np.array(getattr(jc, name))))
    jl, _ = jt.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
    tl, _ = tt.decode_step(tcfg, tparams, torch.from_numpy(nxt), tc)
    _close(tl, jl)


@pytest.mark.parametrize("path", list(PATHS))
def test_moe_greedy_engine_text_equals_jax(path):
    jcfg, tcfg, jparams, tparams = _setup(path)
    ec = dict(max_new_tokens=8, seq_buckets=(32,), batch_buckets=(1, 2, 4))
    jeng = JInferenceEngine(jcfg, jparams, engine_config=JEngineConfig(**ec))
    teng = InferenceEngine(tcfg, tparams, engine_config=EngineConfig(**ec), device="cpu")
    prompts = ["What is 2+2?", "Name a color.", "x"]
    ref = jeng.generate_texts(prompts, temperatures=[0.0] * 3)
    got = teng.generate_texts(prompts, temperatures=[0.0] * 3)
    assert [r.token_ids for r in got] == [r.token_ids for r in ref]
    assert [r.text for r in got] == [r.text for r in ref], ascii([r.text for r in got])


def test_init_params_quantized_moe_tree_matches_quantize_params_layout():
    cfg = get_config("test-tiny-moe")
    for bits in (8, 4):
        direct = tt.init_params_quantized(cfg, 0, bits=bits, device="cpu")
        ref = quant.quantize_params(tt.init_params(cfg, 0, device="cpu"), bits=bits)
        assert set(direct) == set(ref) and set(direct["blocks"]) == set(ref["blocks"])
        for a, b in zip(quant.leaves(direct), quant.leaves(ref)):
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
        assert quant.quantized_bytes(direct) == quant.quantized_bytes(ref)


@pytest.mark.parametrize("qmode", ["none", "int8", "int4"])
def test_plan_memory_mixtral_equals_jax(qmode):
    kw = dict(quant=qmode, kv_quant=qmode != "none", n_candidates=8, prompt_len=300,
              new_tokens=32, hbm_bytes=85_017_493_504)
    assert plan_memory(get_config("mixtral-8x7b"), **kw) == j_plan_memory(
        j_get_config("mixtral-8x7b"), **kw)
