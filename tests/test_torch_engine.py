"""The port's engine, sampler, tokenizer, backends, protocol and vote
against the JAX package's, plus the port's package rules.

Greedy float32 runs must give the JAX package's text exactly; the
sampler's filter must match exactly. Random-weight text may hold lone
surrogates, so assertion messages show it with ``ascii()`` only.
"""

import ast
import asyncio
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.backends.fake import FakeBackend as JFakeBackend
from llm_consensus_tpu.backends.local import LocalBackend as JLocalBackend
from llm_consensus_tpu.consensus import voting as j_voting
from llm_consensus_tpu.consensus.coordinator import Coordinator as JCoordinator
from llm_consensus_tpu.consensus.coordinator import CoordinatorConfig as JCoordinatorConfig
from llm_consensus_tpu.consensus.personas import default_panel as j_default_panel
from llm_consensus_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_consensus_tpu.engine.engine import InferenceEngine as JInferenceEngine
from llm_consensus_tpu.engine.sampler import filter_scaled_logits as j_filter
from llm_consensus_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu_torch import cli
from llm_consensus_tpu_torch.backends.base import BackendError, SamplingParams
from llm_consensus_tpu_torch.backends.fake import FakeBackend, ScriptedBackend
from llm_consensus_tpu_torch.backends.local import LocalBackend
from llm_consensus_tpu_torch.consensus import voting
from llm_consensus_tpu_torch.consensus.coordinator import Coordinator, CoordinatorConfig
from llm_consensus_tpu_torch.consensus.messages import Feedback
from llm_consensus_tpu_torch.consensus.personas import default_panel
from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_consensus_tpu_torch.engine.sampler import (
    SamplerConfig,
    filter_scaled_logits,
    sample_token,
)
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.models.transformer import init_params, params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = ["What is 2+2?", "Name a color.", "x", "été \U0001f600"]


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def engines():
    """The same float32 test-tiny weights in a JAX engine and a port engine."""
    cfg = j_get_config("test-tiny")
    params = jt.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ec = dict(max_new_tokens=6, seq_buckets=(32,), batch_buckets=(1, 2, 4, 8))
    jeng = JInferenceEngine(cfg, params, engine_config=JEngineConfig(**ec))
    teng = InferenceEngine(
        get_config("test-tiny"),
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu"),
        engine_config=EngineConfig(**ec),
        device="cpu",
    )
    return jeng, teng


# ---------------------------------------------------------------------------
# Tokenizer and sampler
# ---------------------------------------------------------------------------


def test_byte_tokenizer_ids_match_jax_including_invalid_utf8():
    jt_, tt_ = JByteTokenizer(), ByteTokenizer()
    raw = bytes([0x61, 0xFF, 0xC3, 0x28, 0xE2, 0x82]) + "ok é".encode()
    ids = [b + 3 for b in raw]
    text = tt_.decode(ids)
    assert text == jt_.decode(ids)
    assert tt_.encode(text) == jt_.encode(text) and tt_.encode(text)[1:] == ids
    for p in PROMPTS:
        assert tt_.encode(p, add_bos=False) == jt_.encode(p, add_bos=False)
    assert (tt_.pad_id, tt_.bos_id, tt_.eos_id, tt_.vocab_size) == (0, 1, 2, 259)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_scaled_logits_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    scaled = (rng.standard_normal((6, 50)) * 3).astype(np.float32)
    scaled[0, :5] = scaled[0, 5]  # ties at the kth logit
    top_k = np.array([0, 5, 1, 50, 7, 0], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.3, 1.0, 0.8], np.float32)
    ref = np.asarray(j_filter(jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = filter_scaled_logits(
        torch.from_numpy(scaled), torch.from_numpy(top_k), torch.from_numpy(top_p)
    ).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sample_token_greedy_rows_and_filtered_support():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((64, 30)).astype(np.float32))
    temp = torch.tensor([0.0, 1.0] * 32)
    g = torch.Generator().manual_seed(0)
    tok, lp = sample_token(logits, g, temp, SamplerConfig(top_k=3))
    top3 = logits.topk(3, dim=-1).indices
    assert bool((tok[::2] == logits[::2].argmax(-1)).all())
    assert all(int(t) in top3[i].tolist() for i, t in enumerate(tok))
    expect = torch.log_softmax(logits / torch.where(temp > 0, temp, 1.0)[:, None], -1)
    torch.testing.assert_close(lp, expect.gather(-1, tok[:, None].long())[:, 0])
    # The same generator seed reproduces the draw; another seed varies it.
    tok2, _ = sample_token(logits, torch.Generator().manual_seed(0), temp, SamplerConfig(top_k=3))
    tok3, _ = sample_token(logits, torch.Generator().manual_seed(1), temp, SamplerConfig(top_k=3))
    assert bool((tok2 == tok).all()) and not bool((tok3 == tok).all())


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "prompts",
    [PROMPTS, PROMPTS[:1], ["Same prompt"] * 4],  # mixed, single, shared prefill
    ids=["mixed", "single", "shared"],
)
def test_greedy_generate_texts_equal_jax(engines, prompts):
    jeng, teng = engines
    ref = jeng.generate_texts(prompts, temperatures=[0.0] * len(prompts))
    got = teng.generate_texts(prompts, temperatures=[0.0] * len(prompts))
    assert [r.token_ids for r in got] == [r.token_ids for r in ref]
    assert [r.text for r in got] == [r.text for r in ref], ascii([r.text for r in got])
    assert [r.num_tokens for r in got] == [r.num_tokens for r in ref]
    np.testing.assert_allclose(
        [r.logprob for r in got], [r.logprob for r in ref], rtol=1e-4, atol=1e-4
    )


def test_single_token_stop_ends_rows_and_trims_like_jax(engines):
    jeng, teng = engines
    base = jeng.generate_texts(PROMPTS, temperatures=[0.0] * 4)
    stop_id = base[0].token_ids[1]
    stop = [ByteTokenizer().decode([stop_id])]
    ref = jeng.generate_texts(PROMPTS, temperatures=[0.0] * 4, stop=stop)
    got = teng.generate_texts(PROMPTS, temperatures=[0.0] * 4, stop=stop)
    assert [(r.text, r.num_tokens) for r in got] == [(r.text, r.num_tokens) for r in ref]
    assert got[0].num_tokens == 2


def test_multi_token_stops_and_quant_are_not_ported(engines):
    """Multi-token stops and int4 weights (its kernel, K10) are not
    ported yet and raise; int8 is ported (tests/test_torch_quant.py)."""
    _, teng = engines
    with pytest.raises(NotImplementedError):
        teng.generate_texts(["hi"], stop=["\n\n"])
    with pytest.raises(NotImplementedError, match="K10"):
        InferenceEngine(teng.cfg, teng.params, engine_config=EngineConfig(quant="int4"),
                        device="cpu")


def test_engine_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("test-tiny")
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)


# ---------------------------------------------------------------------------
# Protocol over the port's FakeBackend (the scenarios of test_coordinator.py)
# ---------------------------------------------------------------------------


def _dissent_once():
    state = {"n": 0}

    def evaluator(prompt):
        state["n"] += 1
        return "NeedsRefinement\nToo terse." if state["n"] in (1, 4) else "Good\nFine now."

    return evaluator


def _malformed_second():
    state = {"n": 0}

    def evaluator(prompt):
        state["n"] += 1
        return "Absolutely fantastic!" if state["n"] == 2 else "Good\nOk."

    return evaluator


# name -> (FakeBackend factories, CoordinatorConfig kwargs,
#          expected (rounds, endorsed, backend calls)).
SCENARIOS = {
    "unanimous": (dict(), dict(), (1, True, 5)),
    "one_dissent": (dict(evaluator=_dissent_once), dict(), (2, True, 10)),
    "round_cap": (
        dict(evaluator=lambda: lambda p: "NeedsRefinement\nNever satisfied."),
        dict(max_rounds=5), (5, False, 26),
    ),
    "cap_2": (dict(evaluator=lambda: lambda p: "NeedsRefinement\nNope."),
              dict(max_rounds=2), (2, False, 11)),
    "malformed": (dict(evaluator=_malformed_second), dict(), (2, True, 10)),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_coordinator_scenarios_match_jax(scenario):
    fake_kw, cfg_kw, (rounds, endorsed, calls) = SCENARIOS[scenario]
    results = []
    for Coord, Config, Fake, panel in (
        (Coordinator, CoordinatorConfig, FakeBackend, default_panel),
        (JCoordinator, JCoordinatorConfig, JFakeBackend, j_default_panel),
    ):
        backend = Fake(**{k: f() for k, f in fake_kw.items()})
        coord = Coord(panel(), backend, Config(seed=0, **cfg_kw))
        res = run(coord.run("What is 2+2?"))
        results.append((res, len(backend.calls), coord.answer_ready()))
    (res, n_calls, ready), (jres, j_calls, j_ready) = results
    assert (res.rounds, res.endorsed, n_calls) == (rounds, endorsed, calls)
    assert (res.rounds, res.endorsed, n_calls, ready) == (jres.rounds, jres.endorsed, j_calls, j_ready)
    assert res.answer == jres.answer and res.author == jres.author
    assert [(e.kind, e.round, e.payload) for e in res.transcript] == [
        (e.kind, e.round, e.payload) for e in jres.transcript
    ]
    assert {k: v.value for k, v in res.feedback.items()} == {
        k: v.value for k, v in jres.feedback.items()
    }


def test_coordinator_repl_surface_and_failures():
    async def go():
        coord = Coordinator(default_panel(), FakeBackend(), CoordinatorConfig(seed=0))
        assert coord.get_answer().startswith("System error")
        assert await coord.ask_question("Q")
        assert await coord.wait_for_answer() == "Echo: Q"
        assert coord.answer_ready()
        coord.reset()
        assert not coord.answer_ready()

    run(go())
    with pytest.raises(ValueError):
        p = default_panel()
        Coordinator(p + [p[0]], FakeBackend())

    class Failing(FakeBackend):
        async def generate_batch(self, requests):
            raise BackendError("injected fault")

    with pytest.raises(BackendError):
        run(Coordinator(default_panel(), Failing(), CoordinatorConfig(seed=0)).run("Q"))
    scripted = ScriptedBackend(["The answer is 4."] + ["Good\nok"] * 4)
    res = run(Coordinator(default_panel(), scripted, CoordinatorConfig(seed=0)).run("Q"))
    assert res.answer == "The answer is 4." and scripted.script == []
    assert all(f is Feedback.GOOD for f in res.feedback.values())


# ---------------------------------------------------------------------------
# Protocol over the port's LocalBackend, and the vote
# ---------------------------------------------------------------------------


def test_coordinator_over_local_backend_matches_jax_at_temperature_0(engines):
    jeng, teng = engines
    transcripts = []
    for Coord, Config, Local, panel, eng in (
        (Coordinator, CoordinatorConfig, LocalBackend, default_panel, teng),
        (JCoordinator, JCoordinatorConfig, JLocalBackend, j_default_panel, jeng),
    ):
        from llm_consensus_tpu.backends.base import SamplingParams as JSamplingParams

        Params = SamplingParams if Coord is Coordinator else JSamplingParams
        coord = Coord(panel(), Local(eng), Config(
            seed=0, max_rounds=2, sampling=Params(max_new_tokens=6, temperature=0.0)))
        res = run(coord.run("What is 2+2?"))
        transcripts.append(
            (res.answer, res.rounds, res.endorsed,
             [(e.kind, e.round, e.payload) for e in res.transcript])
        )
    assert transcripts[0] == transcripts[1], ascii(transcripts[0])


def test_votes_match_jax(engines):
    jeng, teng = engines
    answers = ["The answer is 42.", "42", "#### 41", "forty", " Forty ", "$42.0"]
    for fn in ("majority_vote",):
        a, b = getattr(voting, fn)(answers), getattr(j_voting, fn)(answers)
        assert (a.winner, a.text, a.tally) == (b.winner, b.text, b.tally)
    w = [1.0, 0.5, 3.0, 1.0, 1.0, 0.2]
    a, b = voting.weighted_vote(answers, w), j_voting.weighted_vote(answers, w)
    assert (a.winner, a.tally) == (b.winner, b.tally)
    lps = [-1.0, -2.0, -0.5, -3.0, -0.1, -1.5]
    a, b = voting.logit_pool(answers, lps), j_voting.logit_pool(answers, lps)
    assert a.winner == b.winner
    assert a.tally == pytest.approx(b.tally)
    for method in ("majority", "logit_pool"):
        got = voting.self_consistency(teng, "Q: 2+3? A:", 4, temperature=0.0, method=method)
        ref = j_voting.self_consistency(jeng, "Q: 2+3? A:", 4, temperature=0.0, method=method)
        assert (got.vote.winner, got.candidates, got.total_tokens) == (
            ref.vote.winner, ref.candidates, ref.total_tokens
        ), ascii(got.candidates)
    sampled = voting.self_consistency(teng, "Q: 2+3? A:", 8, temperature=1.0, seed=3)
    assert len(sampled.candidates) == 8 and sampled.vote.n_candidates == 8


# ---------------------------------------------------------------------------
# CLI and package rules
# ---------------------------------------------------------------------------


def test_cli_one_shot_question(capsys):
    assert cli.main(["--backend", "fake", "--question", "What is 2+2?"]) == 0
    assert capsys.readouterr().out.strip().endswith("Echo: What is 2+2?")
    assert cli.main(["--backend", "local", "--cpu", "--model", "test-tiny",
                     "--max-new-tokens", "4", "--max-rounds", "1", "--seed", "1",
                     "--question", "hi"]) == 0


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, llm_consensus_tpu_torch, llm_consensus_tpu_torch.cli, "
        "llm_consensus_tpu_torch.backends.local, llm_consensus_tpu_torch.consensus, "
        "llm_consensus_tpu_torch.ops.kernels, llm_consensus_tpu_torch.models; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'llm_consensus_tpu' or m.startswith('llm_consensus_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_the_port_or_chip_smoke():
    files = [*sorted((ROOT / "llm_consensus_tpu_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "llm_consensus_tpu", "flax"), (f, mod)
