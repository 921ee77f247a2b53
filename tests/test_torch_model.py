"""The port's model and generate loop against the JAX package's, on the
same weights (JAX ``init_params``, carried over with ``params_from_jax``)
and the same numpy inputs, in float32 on the CPU.

- ``prefill``, ``decode_step`` and ``forward`` logits agree within 1e-4
  abs (float32, the same arithmetic in another order), with
  ``use_pallas`` False and True on both sides (the JAX Pallas kernels in
  interpret mode, the port's kernel twins);
- greedy ``generate`` tokens are identical for N in {1, 4}, with
  ``shared_prefill`` on and off, and with an EOS hit;
- decode over a shared-prefill fan-out through the shared-prefix path
  agrees with the JAX package's within 1e-4, and sampled tokens do not
  change when that path is switched off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine.generate import generate as j_generate
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.cache import KVCache as JKVCache
from llm_consensus_tpu.models.configs import RopeScaling as JRopeScaling
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu_torch.engine.generate import generate
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.cache import KVCache
from llm_consensus_tpu_torch.models.configs import RopeScaling, get_config

LOGIT_TOL = dict(rtol=0, atol=1e-4)

# name -> (preset, overrides). "g4": 2 layers, G = H / Hkv = 4.
# "bias-tied": qkv bias, tied embeddings and Llama-3.1 rope scaling.
_ROPE = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
             original_max_position_embeddings=32)
CONFIGS = {
    "test-tiny": {},
    "g4": dict(d_model=128, n_heads=8, n_kv_heads=2, n_layers=2),
    "bias-tied": dict(qkv_bias=True, tie_embeddings=True, rope_theta=500000.0),
}


def _configs(name, use_pallas):
    over = CONFIGS[name]
    jcfg = j_get_config("test-tiny").with_(use_pallas=use_pallas, **over)
    tcfg = get_config("test-tiny").with_(use_pallas=use_pallas, **over)
    if name == "bias-tied":
        jcfg = jcfg.with_(rope_scaling=JRopeScaling(**_ROPE))
        tcfg = tcfg.with_(rope_scaling=RopeScaling(**_ROPE))
    return jcfg, tcfg


def _params(jcfg, seed=0):
    """JAX float32 params with non-trivial norm weights and biases, and
    the same tree as tensors."""
    params = jt.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for name in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
        if name in tree["blocks"]:
            a = tree["blocks"][name]
            base = 1.0 if "norm" in name else 0.0
            tree["blocks"][name] = (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    tree["norm_f"] = (1.0 + 0.1 * rng.standard_normal(tree["norm_f"].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), tt.params_from_jax(tree, device="cpu")


def _prompts(rng, b, s, vocab):
    tokens = rng.integers(3, vocab, (b, s)).astype(np.int32)
    lengths = rng.integers(1, s + 1, (b,)).astype(np.int32)
    lengths[0] = s
    return tokens, lengths


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_logits_match_jax(name, use_pallas):
    jcfg, tcfg = _configs(name, use_pallas)
    jparams, tparams = _params(jcfg)
    rng = np.random.default_rng(1)
    b, s, steps = 3, 24, 4
    tokens, lengths = _prompts(rng, b, s, jcfg.vocab_size)

    jlog, jcache = jt.prefill(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
        JKVCache.create(jcfg, b, s + steps, jnp.float32),
    )
    tlog, tcache = tt.prefill(
        tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
        KVCache.create(tcfg, b, s + steps, torch.float32),
    )
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    for _ in range(steps):
        nxt = rng.integers(3, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jlog, jcache = jt.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache)
        tlog, tcache = tt.decode_step(tcfg, tparams, torch.from_numpy(nxt), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **LOGIT_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_match_jax(use_pallas):
    jcfg, tcfg = _configs("g4", use_pallas)
    jparams, tparams = _params(jcfg, seed=2)
    tokens, _ = _prompts(np.random.default_rng(2), 2, 20, jcfg.vocab_size)
    ref = np.asarray(jt.forward(jcfg, jparams, jnp.asarray(tokens)))
    got = tt.forward(tcfg, tparams, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def _greedy(jcfg, tcfg, jparams, tparams, tokens, lengths, shared, eos_id, new=8):
    kw = dict(max_new_tokens=new, eos_id=eos_id, pad_id=0, shared_prefill=shared)
    b = tokens.shape[0]
    jout = j_generate(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
        jax.random.PRNGKey(0), jnp.zeros((b,), jnp.float32), **kw,
    )
    tout = generate(
        tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.Generator().manual_seed(0), torch.zeros(b), **kw,
    )
    return jout, tout


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n", [1, 4])
def test_greedy_generate_tokens_match_jax(n, shared):
    jcfg, tcfg = _configs("g4", True)
    jparams, tparams = _params(jcfg, seed=3)
    rng = np.random.default_rng(3)
    tokens, lengths = _prompts(rng, n, 16, jcfg.vocab_size)
    if shared:
        tokens[:] = tokens[0]
        lengths[:] = lengths[0]
    jout, tout = _greedy(jcfg, tcfg, jparams, tparams, tokens, lengths, shared, eos_id=-1)
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    # EOS = the token row 0 emits third: rows stop there and pad after.
    eos = int(np.asarray(jout.tokens)[0, 2])
    jout, tout = _greedy(jcfg, tcfg, jparams, tparams, tokens, lengths, shared, eos_id=eos)
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.num_tokens.numpy(), np.asarray(jout.num_tokens))
    assert int(tout.num_tokens[0]) == 3
    np.testing.assert_allclose(
        tout.logprob_sum.numpy(), np.asarray(jout.logprob_sum), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("use_pallas", [False, True])
def test_shared_prefix_decode_step_matches_jax(use_pallas):
    """Decode over a shared-prefill fan-out with the prefix length given:
    the port's K7 twin against the JAX package's shared-prefix kernel
    (interpret mode) or its plain path."""
    jcfg, tcfg = _configs("g4", use_pallas)
    jparams, tparams = _params(jcfg, seed=4)
    rng = np.random.default_rng(4)
    b, s, plen, steps = 4, 24, 19, 3
    tokens = np.broadcast_to(rng.integers(3, jcfg.vocab_size, (1, s)), (b, s)).astype(np.int32)
    lengths = np.full((b,), plen, np.int32)
    jcache = JKVCache.create(jcfg, b, s + steps, jnp.float32)
    _, jcache = jt.prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths), jcache)
    tcache = KVCache.create(tcfg, b, s + steps, torch.float32)
    _, tcache = tt.prefill(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths), tcache)
    for _ in range(steps):
        nxt = rng.integers(3, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jlog, jcache = jt.decode_step(
            jcfg, jparams, jnp.asarray(nxt), jcache, uniform_write=True,
            shared_prefix_len=jnp.int32(plen))
        tlog, tcache = tt.decode_step(
            tcfg, tparams, torch.from_numpy(nxt), tcache, uniform_write=True,
            shared_prefix_len=plen)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


def test_shared_prefix_attention_changes_no_token():
    jcfg, tcfg = _configs("g4", True)
    _, tparams = _params(jcfg, seed=5)
    tokens = np.tile(np.random.default_rng(5).integers(3, jcfg.vocab_size, (1, 16)), (4, 1))
    outs = [
        generate(
            tcfg, tparams, torch.from_numpy(tokens), torch.full((4,), 13, dtype=torch.int32),
            torch.Generator().manual_seed(0), torch.full((4,), 0.8),
            max_new_tokens=8, shared_prefill=True, shared_prefix_attention=on,
        ).tokens
        for on in (False, True)
    ]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_bf16_params_carry_over_bit_exact():
    jcfg, _ = _configs("test-tiny", False)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))  # bf16
    tree = jax.tree.map(np.asarray, params)
    got = tt.params_from_jax(tree, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["blocks"]["wq"].float().numpy(), tree["blocks"]["wq"].astype(np.float32)
    )


def test_init_params_follows_the_jax_tree():
    jcfg, tcfg = _configs("bias-tied", False)
    jtree = jax.tree.map(np.shape, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    ttree = tt.init_params(tcfg, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in ttree["blocks"].items()} == jtree["blocks"]
    assert set(ttree) == set(jtree)
    assert tt.param_count(ttree) == jt.param_count(jt.init_params(jcfg, jax.random.PRNGKey(0)))


def test_unported_configs_raise():
    tcfg = get_config("test-tiny-moe")
    with pytest.raises(NotImplementedError):
        tt.init_params(tcfg, 0, device="cpu")
    cfg = get_config("test-tiny").with_(sliding_window=8)
    params = tt.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError):
        tt.forward(cfg, params, torch.zeros((1, 4), dtype=torch.int64))
