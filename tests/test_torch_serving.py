"""The port's continuous batcher against the JAX package's, on test-tiny.

- Greedy float32 text of a mixed shared-prefix burst (a header shared by
  three prompts, a boundary-page copy, an unrelated prompt, a stop that
  lands mid-flight) is byte-identical to the JAX ``ContinuousBatcher``'s
  at pipeline depth 1 and 2, with the fused step on and off. The JAX side
  runs its XLA reference (``use_pallas=False``, which its own tests hold
  equal to its kernel); the port runs ``use_pallas=True``, so the K8 twin
  with its group decomposition carries the run.
- The JAX tests' admission rules: pool exhaustion recovers, zero-token,
  oversized and never-fitting requests are rejected.
- A sampled request's text does not depend on its batch neighbours.
- The Coordinator over the port's ``ContinuousBackend`` at temperature 0
  gives the JAX transcript.
- Unported settings raise at construction; ``import
  llm_consensus_tpu_torch.serving`` loads no JAX.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.backends.base import SamplingParams as JSamplingParams
from llm_consensus_tpu.consensus import Coordinator as JCoordinator
from llm_consensus_tpu.consensus import CoordinatorConfig as JCoordinatorConfig
from llm_consensus_tpu.consensus import default_panel as j_default_panel
from llm_consensus_tpu.engine.sampler import sample_token_per_request as j_sample
from llm_consensus_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu.serving.continuous import ContinuousBackend as JBackend
from llm_consensus_tpu.serving.continuous import ContinuousBatcher as JBatcher
from llm_consensus_tpu.serving.continuous import ContinuousConfig as JConfig
from llm_consensus_tpu.utils import stops as j_stops
from llm_consensus_tpu_torch import cli
from llm_consensus_tpu_torch.backends.base import SamplingParams
from llm_consensus_tpu_torch.consensus import Coordinator, CoordinatorConfig, default_panel
from llm_consensus_tpu_torch.engine.sampler import (
    request_generator,
    sample_token_per_request,
)
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.ops import kernels
from llm_consensus_tpu_torch.ops.quant import quantize_params
from llm_consensus_tpu_torch.parallel.mesh import Mesh, MeshConfig
from llm_consensus_tpu_torch.serving import (
    ContinuousBackend,
    ContinuousBatcher,
    ContinuousConfig,
)
from llm_consensus_tpu_torch.utils import stops

ROOT = Path(__file__).resolve().parents[1]

HEADER = "You are a careful panelist. Question: why is the sky blue? " * 2
PROMPTS = [
    HEADER + "Answer briefly.",
    HEADER + "Answer at length, please.",
    HEADER + "Give one word.",
    "an unrelated short prompt",
    HEADER[:70] + "xyz",  # diverges inside a page: the boundary copy
]
BURST = dict(max_slots=4, page_size=16, n_pages=64, pages_per_seq=16,
             seq_buckets=(32, 64, 128, 192), prefill_chunk=16, max_new_tokens=12)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("test-tiny")
    params = jt.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return (jcfg.with_(use_pallas=False), params,
            get_config("test-tiny").with_(use_pallas=True), tparams)


def _serve(batcher, prompts, stop_of=None, **kw):
    try:
        futs = [batcher.submit(p, stop=(stop_of or {}).get(i), **kw)
                for i, p in enumerate(prompts)]
        return [f.result(timeout=300).text for f in futs], batcher.stats()
    finally:
        batcher.close()


@pytest.fixture(scope="module")
def jax_burst(tiny):
    """The JAX batcher's greedy texts for the burst, with a stop taken from
    request 1's own unstopped text so that it lands mid-flight."""
    jcfg, params, _, _ = tiny
    plain, _ = _serve(JBatcher(jcfg, params, config=JConfig(**BURST)), PROMPTS)
    stop_of = {1: (plain[1][3:5],)}
    texts, _ = _serve(JBatcher(jcfg, params, config=JConfig(**BURST)), PROMPTS, stop_of)
    assert texts[1] == plain[1][:3] and texts[1] != plain[1]
    return stop_of, texts


@pytest.fixture(scope="module")
def batcher(tiny):
    _, _, tcfg, tparams = tiny
    b = ContinuousBatcher(tcfg, tparams, config=ContinuousConfig(
        max_slots=4, page_size=16, n_pages=64, pages_per_seq=8,
        max_new_tokens=8, seq_buckets=(16, 32, 64)), device="cpu")
    yield b
    b.close()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("ragged", [True, False])
def test_greedy_burst_text_equals_jax(tiny, jax_burst, depth, ragged):
    _, _, tcfg, tparams = tiny
    stop_of, want = jax_burst
    kernels.reset_launch_counts()
    got, st = _serve(
        ContinuousBatcher(tcfg, tparams, config=ContinuousConfig(
            **BURST, pipeline_depth=depth, ragged_attention=ragged), device="cpu"),
        PROMPTS, stop_of)
    assert got == want, ascii((got, want))
    assert st["completed_requests"] == len(PROMPTS) and st["active_slots"] == 0
    assert st["prefix_pages_shared"] > 0 and st["prefix_pages_copied"] == 1
    assert st["decode_group_peak"] >= 2 and st["shared_kv_bytes_saved"] > 0
    assert st["free_pages"] == 63  # every page back (registry pages reclaimable)
    fused = st["device_programs_fused"]
    assert (fused > 0) if ragged else (fused == 0)
    assert st["device_programs_prefill"] > 0 and st["device_programs_decode"] > 0
    # On CPU tensors the wrapper runs the twin and counts no launch.
    assert kernels.ragged_paged_attention.launches == 0


def test_pool_exhaustion_recovers(tiny):
    """More requests than pool pages: later ones wait, all complete."""
    _, _, tcfg, tparams = tiny
    b = ContinuousBatcher(tcfg, tparams, config=ContinuousConfig(
        max_slots=2, page_size=16, n_pages=5, pages_per_seq=4, max_new_tokens=4,
        seq_buckets=(16,)), device="cpu")
    outs, st = _serve(b, [f"q{i}" for i in range(5)], max_new_tokens=4)
    assert len(outs) == 5 and all(isinstance(o, str) for o in outs)
    assert st["completed_requests"] == 5


@pytest.mark.parametrize("n_pages,pages_per_seq,match", [(4, 8, "pool"), (32, 2, "pages")])
def test_never_fitting_request_fails_fast(tiny, n_pages, pages_per_seq, match):
    """The pool can never hold it, or the table cannot (tests/test_paged.py's
    impossible-pool and oversized cases)."""
    _, _, tcfg, tparams = tiny
    b = ContinuousBatcher(tcfg, tparams, config=ContinuousConfig(
        max_slots=2, page_size=16, n_pages=n_pages, pages_per_seq=pages_per_seq,
        max_new_tokens=64, seq_buckets=(16,)), device="cpu")
    try:
        with pytest.raises(ValueError, match=match):
            b.submit("hi", max_new_tokens=64).result(timeout=60)
    finally:
        b.close()


def test_zero_max_new_tokens_rejected_and_stats(batcher):
    with pytest.raises(ValueError, match="max_new_tokens"):
        batcher.submit("hi", max_new_tokens=0)
    before = batcher.stats()
    assert before["total_pages"] == 63 and before["max_slots"] == 4
    batcher.submit("count me", max_new_tokens=4).result(timeout=120)
    after = batcher.stats()
    assert after["completed_requests"] == before["completed_requests"] + 1
    assert after["free_pages"] == before["free_pages"]  # pages returned
    assert after["active_slots"] == 0
    hb = batcher.heartbeat()
    assert hb["alive"] and hb["state"] == "serving" and hb["last_tick_age_s"] < 5


def test_sampled_text_does_not_depend_on_batch_neighbours(batcher):
    alone = batcher.submit("xyz", temperature=1.0, seed=7).result(timeout=120)
    futs = [batcher.submit(p, temperature=1.0, seed=7 + i)
            for i, p in enumerate(["aaa", "xyz", "bbb"])]
    crowd = batcher.submit("xyz", temperature=1.0, seed=7)
    [f.result(timeout=120) for f in futs]
    assert crowd.result(timeout=120) == alone
    other = batcher.submit("xyz", temperature=1.0, seed=8).result(timeout=120)
    assert other != alone


def test_coordinator_over_continuous_backend_matches_jax(tiny):
    jcfg, params, tcfg, tparams = tiny
    cfg_kw = dict(max_slots=8, page_size=16, n_pages=256, pages_per_seq=48,
                  seq_buckets=(64, 128, 256, 512, 752), prefill_chunk=64)
    transcripts = []
    for Coord, Config, Params, panel, backend in (
        (Coordinator, CoordinatorConfig, SamplingParams, default_panel,
         ContinuousBackend(ContinuousBatcher(tcfg, tparams, config=ContinuousConfig(**cfg_kw),
                                             device="cpu"))),
        (JCoordinator, JCoordinatorConfig, JSamplingParams, j_default_panel,
         JBackend(JBatcher(jcfg, params, config=JConfig(**cfg_kw)))),
    ):
        coord = Coord(panel(), backend, Config(
            seed=0, max_rounds=2, sampling=Params(max_new_tokens=6, temperature=0.0)))
        try:
            res = asyncio.run(coord.run("What is 2+2?"))
        finally:
            asyncio.run(backend.close())
        transcripts.append((res.answer, res.rounds, res.endorsed,
                            [(e.kind, e.round, e.payload) for e in res.transcript]))
    assert transcripts[0] == transcripts[1], ascii(transcripts[0])


def test_cli_continuous_backend():
    assert cli.main(["--backend", "continuous", "--cpu", "--model", "test-tiny",
                     "--max-new-tokens", "4", "--max-rounds", "1", "--seed", "1",
                     "--serve-slots", "4", "--pipeline-depth", "1",
                     "--question", "hi"]) == 0


@pytest.mark.parametrize("knob", [
    dict(host_cache_bytes=1 << 20), dict(spec_k=2), dict(decode_rounds=2),
    dict(steps_per_sync=2), dict(prefill_chunk=0), dict(hbm_gbps=1000.0),
    "mesh", "draft", "controller", "host_store",
])
def test_unported_settings_raise_before_device_work(tiny, knob):
    _, _, tcfg, tparams = tiny
    config, extra = ContinuousConfig(), {}
    if isinstance(knob, dict):
        config = ContinuousConfig(**knob)
    elif knob == "mesh":
        # Meshes are served now; int4 weights split over model are not.
        tparams = quantize_params(tparams, bits=4)
        extra = {"mesh": Mesh(MeshConfig(model=2), "cuda:0")}
    else:
        extra = {knob: object()}
    # device="cuda" would raise RuntimeError here (no card): the check
    # comes first.
    with pytest.raises(NotImplementedError, match="slice"):
        ContinuousBatcher(tcfg, tparams, config=config, device="cuda", **extra)


def test_refused_model_configs_raise(tiny):
    _, _, _, tparams = tiny
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(get_config("test-tiny-moe"), tparams, device="cpu")


def test_serving_import_loads_no_jax():
    code = (
        "import sys, llm_consensus_tpu_torch.serving, llm_consensus_tpu_torch.backends; "
        "from llm_consensus_tpu_torch.backends import ContinuousBackend; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'llm_consensus_tpu' or m.startswith('llm_consensus_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# The batcher's helpers against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stop_set", [(), ("ab",), ("\n\n---", "x"), ("\udcff\udcfe",)])
def test_stop_helpers_match_jax(stop_set):
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    assert stops.stop_tail_window(tok, stop_set) == j_stops.stop_tail_window(jtok, stop_set)
    rng = np.random.default_rng(len(stop_set))
    ids = [int(t) for t in rng.integers(0, 260, 120)]
    for window in (0, 3, 12):
        f = stops.VisibleIdFilter(tok, skip_ids=(tok.eos_id,))
        jf = j_stops.VisibleIdFilter(jtok, skip_ids=(jtok.eos_id,))
        assert f.visible_tail(ids, window) == jf.visible_tail(ids, window)
        for cut in range(1, len(ids), 7):
            text = tok.decode([t for t in ids[:cut] if t != tok.eos_id])
            got = f.confirmed_stop_hit(ids[:cut], stop_set, window, lambda: text)
            assert got == jf.confirmed_stop_hit(ids[:cut], stop_set, window, lambda: text)


def test_sample_token_per_request_greedy_rows_match_jax_and_streams_are_per_request():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 97)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 0.0, 1.3], np.float32)
    topk = np.array([0, 5, 3, 0], np.int32)
    topp = np.array([1.0, 0.9, 1.0, 0.8], np.float32)
    keys = [request_generator(11, 4, "cpu") if t > 0 else None for t in temps]
    tok, lp = sample_token_per_request(
        torch.from_numpy(logits), keys, torch.from_numpy(temps), torch.from_numpy(topk),
        torch.from_numpy(topp))
    jk = jax.vmap(lambda s: jax.random.PRNGKey(s))(jnp.arange(4))
    jtok, jlp = j_sample(jnp.asarray(logits), jk, jnp.asarray(temps), jnp.asarray(topk),
                         jnp.asarray(topp))
    greedy = temps == 0
    np.testing.assert_array_equal(tok.numpy()[greedy], np.asarray(jtok)[greedy])
    np.testing.assert_allclose(lp.numpy()[greedy], np.asarray(jlp)[greedy], rtol=1e-6)
    # Sampled rows stay in their filtered support, and a row's draw is a
    # function of (seed, index) and its own logits alone.
    assert tok[1] in torch.topk(torch.from_numpy(logits[1]), 5).indices
    alone, _ = sample_token_per_request(
        torch.from_numpy(logits[3:4]), [request_generator(11, 4, "cpu")],
        torch.from_numpy(temps[3:4]), torch.from_numpy(topk[3:4]), torch.from_numpy(topp[3:4]))
    assert int(alone[0]) == int(tok[3])


# ---------------------------------------------------------------------------
# On the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batcher_kernels_path_equals_plain_path_on_card(cuda, tiny):
    _, _, tcfg, tparams = tiny
    texts = []
    for use_pallas in (True, False):
        kernels.reset_launch_counts()
        b = ContinuousBatcher(tcfg.with_(use_pallas=use_pallas), tparams,
                              config=ContinuousConfig(**BURST), device=cuda)
        got, _ = _serve(b, PROMPTS)
        texts.append(got)
        launched = kernels.ragged_paged_attention.launches
        assert (launched > 0) if use_pallas else (launched == 0)
    assert texts[0] == texts[1], ascii(texts)
