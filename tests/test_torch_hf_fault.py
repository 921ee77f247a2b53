"""The port's HF loader, HF tokenizer, fault-injecting backend and
logging setup against the JAX package's.

HF checkpoints and a tokenizer are built locally in ``tmp_path`` (tiny
random Llama, Mistral, Qwen2 and Mixtral models from ``transformers``;
a BPE trained offline with ``tokenizers``). The port's loader reads the
safetensors format itself: its tree equals the JAX loader's, and its
float32 logits equal the JAX model's within 1e-4 and agree with
``transformers``' own model as the JAX package's test holds them.
"""

import asyncio
import logging
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from llm_consensus_tpu.backends import FakeBackend as JFakeBackend
from llm_consensus_tpu.backends import FaultConfig as JFaultConfig
from llm_consensus_tpu.backends import FaultInjectingBackend as JFaultInjectingBackend
from llm_consensus_tpu.backends import GenerationRequest as JGenerationRequest
from llm_consensus_tpu.engine.tokenizer import load_tokenizer as j_load_tokenizer
from llm_consensus_tpu.models import hf_loader as j_hf
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.utils.logging import setup_logging as j_setup_logging
from llm_consensus_tpu_torch.backends import (
    BackendError,
    FakeBackend,
    FaultConfig,
    FaultInjectingBackend,
    GenerationRequest,
)
from llm_consensus_tpu_torch.consensus import Coordinator, CoordinatorConfig, default_panel
from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer, HFTokenizer, load_tokenizer
from llm_consensus_tpu_torch.models import hf_loader
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.utils.logging import setup_logging

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
             tie_word_embeddings=False)
FAMILIES = {
    "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM, {}),
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM,
                dict(sliding_window=4)),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM, {}),
    "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                dict(num_local_experts=4, num_experts_per_tok=2)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_loader_equals_jax_loader_and_transformers(tmp_path, family):
    config_cls, model_cls, extra = FAMILIES[family]
    torch.manual_seed(0)
    model = model_cls(config_cls(**SMALL, **extra)).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    cfg = hf_loader.config_from_hf(tmp_path, name="tiny-hf")
    jcfg = j_hf.config_from_hf(tmp_path, name="tiny-hf")
    # Every field but use_pallas, whose default differs by design (the
    # port takes the kernels, or their CPU twins, by default).
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if f != "use_pallas"} == {
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__ if f != "use_pallas"}
    assert (cfg.sliding_window, cfg.is_moe, cfg.qkv_bias) == (
        4 if family == "mistral" else 0, family == "mixtral", family == "qwen2")
    params = hf_loader.load_hf_params(cfg, tmp_path, dtype=torch.float32, device="cpu")
    jparams = j_hf.load_hf_params(jcfg, tmp_path, dtype=jnp.float32)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    for path, ref in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), ref)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    got = tt.forward(cfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.forward(jcfg, jparams, jnp.asarray(tokens))),
                               rtol=0, atol=1e-4)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.float()
    np.testing.assert_allclose(torch.softmax(got, -1).numpy(), torch.softmax(ref, -1).numpy(),
                               atol=2e-2)
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean() > 0.97


def test_hf_loader_bf16_and_refusals(tmp_path):
    torch.manual_seed(1)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**SMALL))
    model.to(torch.bfloat16).save_pretrained(tmp_path, safe_serialization=True)
    cfg = hf_loader.config_from_hf(tmp_path)
    params = hf_loader.load_hf_params(cfg, tmp_path, device="cpu")
    assert params["blocks"]["wq"].dtype == torch.bfloat16
    torch.testing.assert_close(params["blocks"]["wq"][1],
                               model.model.layers[1].self_attn.q_proj.weight.T, rtol=0, atol=0)
    with pytest.raises(KeyError, match="layers.2"):
        hf_loader.load_hf_params(cfg.with_(n_layers=3), tmp_path, device="cpu")
    with pytest.raises(ValueError, match="tie_embeddings"):
        hf_loader.load_hf_params(cfg.with_(tie_embeddings=True), tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError):
        hf_loader.load_hf_params(cfg, tmp_path / "none", device="cpu")


def test_importing_the_loader_needs_no_safetensors():
    code = ("import sys; sys.modules['safetensors'] = None; "
            "import llm_consensus_tpu_torch.models.hf_loader, llm_consensus_tpu_torch.cli")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A transformers fast tokenizer built offline (a BPE trained on a
    small corpus) and saved to a directory."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    corpus = ["Jordan buys 5 notebooks and pays with a $100 bill.",
              "How many muffins are left? Think step by step."] * 20
    tok = Tokenizer(BPE(unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator(corpus, BpeTrainer(
        vocab_size=200, special_tokens=["<pad>", "<s>", "</s>", "<unk>"]))
    path = tmp_path_factory.mktemp("tok")
    tok.save(str(path / "tokenizer.json"))
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_file=str(path / "tokenizer.json"), bos_token="<s>", eos_token="</s>",
        pad_token="<pad>", unk_token="<unk>")
    fast.save_pretrained(path)
    return path


def test_hf_tokenizer_equals_jax_and_drives_the_engine(tokenizer_dir):
    tok, jtok = load_tokenizer(str(tokenizer_dir)), j_load_tokenizer(str(tokenizer_dir))
    assert isinstance(tok, HFTokenizer)
    assert (tok.vocab_size, tok.bos_id, tok.eos_id, tok.pad_id) == (
        jtok.vocab_size, jtok.bos_id, jtok.eos_id, jtok.pad_id)
    for text in ("Jordan buys 5 notebooks.", "muffins left step"):
        ids = tok.encode(text)
        assert ids == jtok.encode(text) and ids[0] == tok.bos_id
        assert tok.encode(text, add_bos=False) == ids[1:]
        assert tok.decode(ids) == jtok.decode(ids)
    cfg = get_config("test-tiny")
    eng = InferenceEngine(cfg, tt.init_params(cfg, 0, dtype=torch.float32, device="cpu"),
                          tokenizer=tok, engine_config=EngineConfig(
                              max_new_tokens=4, seq_buckets=(32,)), device="cpu")
    out = eng.generate_texts(["Jordan buys"], temperatures=[0.0])[0]
    assert all(0 <= i < cfg.vocab_size for i in out.token_ids)


def test_load_tokenizer_falls_back_to_bytes(tmp_path):
    assert isinstance(load_tokenizer(None), ByteTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path / "missing")), ByteTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path)), ByteTokenizer)  # empty dir


def test_fault_config_validation():
    for name in ("error_rate", "delay_rate", "garbage_rate"):
        with pytest.raises(ValueError, match=name):
            FaultConfig(**{name: 1.5})


def test_faults_are_seeded_counted_and_equal_jax():
    async def probe(backend_cls, request_cls, fake_cls, cfg_cls, seed):
        fb = backend_cls(fake_cls(), cfg_cls(error_rate=0.5, garbage_rate=0.5, seed=seed))
        out = []
        for _ in range(20):
            try:
                out.append((await fb.generate_batch([request_cls(prompt="q")]))[0].text)
            except Exception as e:  # noqa: BLE001 - both packages' BackendError
                out.append(type(e).__name__)
        return out, fb.stats

    a, sa = asyncio.run(probe(FaultInjectingBackend, GenerationRequest, FakeBackend,
                              FaultConfig, 7))
    b, _ = asyncio.run(probe(FaultInjectingBackend, GenerationRequest, FakeBackend,
                             FaultConfig, 7))
    c, _ = asyncio.run(probe(FaultInjectingBackend, GenerationRequest, FakeBackend,
                             FaultConfig, 8))
    j, sj = asyncio.run(probe(JFaultInjectingBackend, JGenerationRequest, JFakeBackend,
                              JFaultConfig, 7))
    assert a == b and a != c
    assert [x == "BackendError" for x in a] == [x == "BackendError" for x in j]
    assert (sa.calls, sa.errors_injected, sa.garbage_injected) == (
        sj.calls, sj.errors_injected, sj.garbage_injected)
    assert sa.errors_injected > 0 and sa.garbage_injected > 0


@pytest.mark.parametrize("faults,seeds,coord", [
    (dict(error_rate=0.3), (0, 1, 2), dict(retries=4, max_rounds=3)),
    (dict(garbage_rate=0.7), (1,), dict(retries=2, max_rounds=3)),
    (dict(delay_rate=0.5, delay_s=0.2), (3,), dict(retries=5, max_rounds=2, call_timeout=0.05)),
], ids=["errors", "garbage", "delays"])
def test_protocol_survives_injected_faults(faults, seeds, coord):
    """The JAX package's chaos cases (tests/test_fault.py): retries
    absorb transient errors, garbled verdicts parse as dissent and the
    round cap still ends the run, and delays past the call timeout are
    retried."""
    for seed in seeds:
        backend = FaultInjectingBackend(FakeBackend(), FaultConfig(seed=seed, **faults))
        result = asyncio.run(Coordinator(default_panel(), backend,
                                         CoordinatorConfig(seed=0, **coord)).run("What is 2+2?"))
        assert isinstance(result.answer, str) and result.rounds <= coord["max_rounds"]
        if "error_rate" not in faults:
            assert backend.stats.garbage_injected + backend.stats.delays_injected > 0


def test_fault_backend_raises_backend_error():
    backend = FaultInjectingBackend(FakeBackend(), FaultConfig(error_rate=1.0))
    with pytest.raises(BackendError, match="injected"):
        asyncio.run(backend.generate_batch([GenerationRequest(prompt="q")]))


def test_setup_logging_parses_specs_like_jax():
    for spec in ("debug", "warning,llm_consensus_tpu_torch.consensus=debug,x=bogus", ""):
        j_setup_logging(spec)
        want = (logging.getLogger().level,
                logging.getLogger("llm_consensus_tpu_torch.consensus").level)
        logging.getLogger("llm_consensus_tpu_torch.consensus").setLevel(logging.NOTSET)
        setup_logging(spec)
        got = (logging.getLogger().level,
               logging.getLogger("llm_consensus_tpu_torch.consensus").level)
        logging.getLogger("llm_consensus_tpu_torch.consensus").setLevel(logging.NOTSET)
        assert got == want
    setup_logging("warning")


def test_cli_answers_from_an_hf_checkpoint_and_tokenizer(tmp_path, tokenizer_dir, capsys):
    from llm_consensus_tpu_torch import cli

    torch.manual_seed(2)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**{**SMALL, "vocab_size": 256}))
    model.save_pretrained(tmp_path, safe_serialization=True)
    assert cli.main(["--backend", "local", "--cpu", "--hf-checkpoint", str(tmp_path),
                     "--tokenizer", str(tokenizer_dir), "--question", "hi",
                     "--max-new-tokens", "4", "--max-rounds", "1"]) == 0
    assert "RANDOM" not in capsys.readouterr().err
