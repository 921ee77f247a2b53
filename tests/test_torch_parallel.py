"""The port's dp x mp serving path against the JAX package, on the CPU.

Worlds of 2 or 4 ``gloo`` ranks started by the port's launcher
(``llm_consensus_tpu_torch.parallel.launch``) with a file store under
``tmp_path`` and a deadline, so a deadlock fails a test instead of hanging
it. The JAX oracles are computed here and handed to the ranks as numpy
arrays; the ranks (``tests/torch_parallel_ranks.py``) import only the
port.

- Partitioning: the rules equal JAX's ``param_pspecs`` leaf for leaf
  (bf16 and int8 trees), each leaf's shards concatenate to the leaf, and
  ``sharded_param_bytes`` and the mesh plans equal JAX's.
- K9's twin on a dp2 x mp2 world equals JAX's
  ``ragged_paged_attention_reference`` on the inputs of JAX's own K9 test
  (``tests/test_mesh_serving.py``): decode rows, the chunk lane on its
  owner shard, shard-local groups, ``window=9``, the NQ-query verify lane.
- The paged steps under tensor parallelism (dp1 x mp2, and dp2 x mp2 with
  rows on both shards) give JAX's single-device logits.
- The mesh batcher's greedy float32 text on the JAX mesh tests' prompts
  equals the JAX single-device batcher's, at dp2 x mp2, dp2 x mp1 and
  dp1 x mp2 and at pipeline depth 1 and 2; the CLI serves a question on a
  mesh.
- A mesh that does not divide, and int4 weights over ``model``, raise;
  ``import llm_consensus_tpu_torch.parallel`` loads no JAX.

The card test (K9's kernel against its twin on every rank) is marked
``cuda`` and skips here; ``chip_smoke.py`` phase 6 runs it on the card.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine.engine import plan_memory as j_plan_memory
from llm_consensus_tpu.models import paged_cache as jpc
from llm_consensus_tpu.models import transformer as jt
from llm_consensus_tpu.models.configs import get_config as j_get_config
from llm_consensus_tpu.ops.attention import ragged_paged_attention_reference
from llm_consensus_tpu.ops.quant import quantize_params as j_quantize_params
from llm_consensus_tpu.parallel import partitioning as jpart
from llm_consensus_tpu.serving.continuous import ContinuousBatcher as JBatcher
from llm_consensus_tpu.serving.continuous import ContinuousConfig as JConfig
from llm_consensus_tpu_torch import cli
from llm_consensus_tpu_torch.engine.engine import plan_memory
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.models.paged_cache import PagedKVCache
from llm_consensus_tpu_torch.ops import quant
from llm_consensus_tpu_torch.parallel import (
    Mesh,
    MeshConfig,
    launch,
    make_mesh,
    param_pspecs,
    shard_params,
    sharded_param_bytes,
)
from llm_consensus_tpu_torch.serving import ContinuousBatcher, ContinuousConfig

ROOT = Path(__file__).resolve().parents[1]
RANKS = str(ROOT / "tests" / "torch_parallel_ranks.py")
DEADLINE_S = 300.0
F32_TOL = dict(rtol=1e-5, atol=1e-5)

# The JAX mesh tests' burst (tests/test_mesh_serving.py:48-55) and batcher
# config (:67-78).
_HEADER_A = "shared mesh panel header alpha!!"
_HEADER_B = "other shared panel header beta!!"
PROMPTS = [
    _HEADER_A + "one?",
    _HEADER_A + "two?",
    "a unique short prompt",
    _HEADER_B + "three?",
    _HEADER_B + "four?",
    "another unique tail prompt?",
]
CCFG = dict(max_slots=4, page_size=16, n_pages=64, pages_per_seq=8, max_new_tokens=8,
            seq_buckets=(16, 32, 64))
MESHES = {"dp2xmp2": {"data": 2, "model": 2}, "dp2xmp1": {"data": 2},
          "dp1xmp2": {"model": 2}}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# Parameter seeds of the batcher parity: 0 is the JAX mesh tests' fixture
# (most of its requests end at once with EOS), 1 decodes all 8 tokens of
# every request.
SEEDS = (0, 1)


def _jparams(seed: int):
    return jt.init_params(j_get_config("test-tiny"), jax.random.PRNGKey(seed),
                          dtype=jnp.float32)


@pytest.fixture(scope="module")
def jparams():
    return _jparams(0)


def _world(tmp_path_factory, shape: dict, tasks: list, n: int) -> dict:
    """Run ``tasks`` on a fresh world of ``n`` ranks; every rank must end
    cleanly. Returns rank 0's {task: result}."""
    work = tmp_path_factory.mktemp("world")
    results = launch(f"{RANKS}:run", n, (shape, tasks), backend="gloo", workdir=work,
                     deadline_s=DEADLINE_S, timeout_s=60.0)
    bad = [(r.rank, r.exitcode, r.error, r.log[-3000:]) for r in results if not r.ok]
    assert not bad, bad
    return results[0].result


# ---------------------------------------------------------------------------
# Partitioning (no world needed)
# ---------------------------------------------------------------------------


def _j_specs(tree) -> dict:
    """JAX's specs by leaf path ("blocks/wq/q"), as tuples."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jpart.param_pspecs(tree), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        names = [getattr(k, "key", None) or getattr(k, "name", None) for k in path]
        out["/".join(str(n) for n in names)] = tuple(spec)
    return out


def _t_specs(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_t_specs(v, f"{prefix}{k}/"))
        elif isinstance(v, (quant.QuantizedTensor, quant.Quantized4Tensor)):
            out[f"{prefix}{k}/q"] = v.q
            out[f"{prefix}{k}/scale"] = v.scale
        else:
            out[f"{prefix}{k}"] = v
    return out


def _trees(bits: int):
    jcfg = j_get_config("test-tiny").with_(qkv_bias=True)
    jtree = jt.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    if bits:
        jtree = j_quantize_params(jtree, bits=bits)
    return jtree, tt.params_from_jax(_np_tree(jtree), device="cpu")


@pytest.mark.parametrize("bits", [0, 8])
def test_partition_rules_equal_jax(bits):
    jtree, ttree = _trees(bits)
    want = _j_specs(jtree)
    got = _t_specs(param_pspecs(ttree))
    assert got == want
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_shards_concatenate_to_the_leaf(bits, shape):
    """Each leaf's shards, concatenated along the axes its spec names in
    rank order, give the leaf back; replicated leaves are whole on every
    rank."""
    _, ttree = _trees(bits)
    cfg = MeshConfig(**MESHES[shape])
    shards = [shard_params(ttree, Mesh(cfg, "cpu", rank=r)) for r in range(cfg.size)]
    specs = _t_specs(param_pspecs(ttree))
    full = _t_specs(ttree)
    per_rank = [_t_specs(s) for s in shards]
    for name, leaf in full.items():
        spec = specs[name]
        blocks = {}
        for r, sh in enumerate(per_rank):
            c = Mesh(cfg, "cpu", rank=r).coords
            key = tuple(c[ax] if ax else 0 for ax in spec)
            assert sh[name].is_contiguous(), name
            if key in blocks:  # a replica: equal to the first copy
                assert torch.equal(blocks[key], sh[name]), name
            blocks[key] = sh[name]
        rebuilt = None
        for dim, ax in enumerate(spec):
            if ax and cfg.axis_sizes()[ax] > 1:
                # Concatenate along ``dim`` for every fixed choice of the rest.
                groups = {}
                for key, t in sorted(blocks.items()):
                    rest = key[:dim] + key[dim + 1:]
                    groups.setdefault(rest, []).append(t)
                blocks = {rest: torch.cat(ts, dim) for rest, ts in groups.items()}
                blocks = {k[:dim] + (0,) + k[dim:]: v for k, v in blocks.items()}
        (rebuilt,) = blocks.values()
        assert torch.equal(rebuilt, leaf), name


@pytest.mark.parametrize("model", ["test-tiny", "llama-1b"])
def test_sharded_param_bytes_equal_jax(model):
    """Port on the meta device, JAX on eval_shape, bf16 and int8 trees on
    every dp x mp mesh of up to 4 ranks; int4 on meshes without model."""
    tree = tt.init_params(get_config(model), dtype=torch.bfloat16, device="meta")
    jcfg = j_get_config(model)
    jtree = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0),
                                                  dtype=jnp.bfloat16))
    shapes = [{"data": 2, "model": 2}, {"model": 2}, {"model": 4}, {"data": 4}]
    for bits in (0, 8, 4):
        t = quant.quantize_params(tree, bits=bits) if bits else tree
        j = jax.eval_shape(lambda x: j_quantize_params(x, bits=bits), jtree) if bits else jtree
        for shape in shapes:
            if bits == 4 and shape.get("model", 1) > 1:
                with pytest.raises(NotImplementedError, match="int4"):
                    sharded_param_bytes(t, shape)
                continue
            assert sharded_param_bytes(t, shape) == jpart.sharded_param_bytes(j, shape)


@pytest.mark.parametrize("quant_mode", ["none", "int8"])
def test_plan_memory_on_a_mesh_equals_jax(quant_mode):
    for shape in ({"data": 2, "model": 2}, {"data": 4}, {"model": 2}):
        kw = dict(quant=quant_mode, kv_quant=quant_mode == "int8", n_candidates=64,
                  prompt_len=1900, new_tokens=128, mesh_shape=shape, hbm_bytes=16 << 30)
        for model in ("llama-1b", "llama3-8b"):
            assert plan_memory(get_config(model), **kw) == j_plan_memory(
                j_get_config(model), **kw)


def test_indivisible_mesh_and_int4_over_model_raise(jparams):
    tparams = tt.params_from_jax(_np_tree(jparams), device="cpu")
    tiny = get_config("test-tiny")
    for cfg, shape, config, what in (
        (get_config("test-tiny-draft"), {"model": 2}, CCFG, "n_kv_heads % model = 1 % 2"),
        (tiny, {"data": 2}, dict(CCFG, max_slots=3), "max_slots % data = 3 % 2"),
        (tiny, {"data": 2}, dict(CCFG, n_pages=63), "n_pages % data = 63 % 2"),
    ):
        # Raised at construction, before any collective (this mesh has none).
        with pytest.raises(ValueError, match="cannot shard") as e:
            ContinuousBatcher(cfg, tparams, config=ContinuousConfig(**config),
                              mesh=Mesh(MeshConfig(**shape), "cpu"))
        assert what in str(e.value)
    p4 = quant.quantize_params(tparams, bits=4)
    with pytest.raises(NotImplementedError, match="int4"):
        shard_params(p4, Mesh(MeshConfig(model=2), "cpu"))
    with pytest.raises(NotImplementedError, match="int4"):
        ContinuousBatcher(tiny, p4, config=ContinuousConfig(**CCFG),
                          mesh=Mesh(MeshConfig(model=2), "cpu"))
    # int4 splits over data alone (replicated weights).
    assert shard_params(p4, Mesh(MeshConfig(data=2), "cpu"))["blocks"]["wo"].q.shape == p4[
        "blocks"]["wo"].q.shape
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        MeshConfig(pipe=2)


def test_mesh_device_defaults_to_the_card(jparams):
    """make_mesh, like every entry point of the port, runs on the card
    unless the caller asks for the CPU; a batcher or cache given a device
    that disagrees with its mesh's raises."""
    if torch.cuda.is_available():
        assert make_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    mesh = make_mesh(device="cpu")
    assert mesh.device == torch.device("cpu") and mesh.device_for(None) == mesh.device
    assert mesh.device_for("cpu") == mesh.device
    tparams = tt.params_from_jax(_np_tree(jparams), device="cpu")
    tiny = get_config("test-tiny")
    with pytest.raises(ValueError, match="disagrees with the mesh's device cpu"):
        ContinuousBatcher(tiny, tparams, config=ContinuousConfig(**CCFG), mesh=mesh,
                          device="cuda")
    with pytest.raises(ValueError, match="disagrees"):
        PagedKVCache.create(tiny, 8, 4, 2, 2, device="cuda", mesh=mesh)


def test_parallel_import_loads_no_jax():
    code = ("import sys, llm_consensus_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('llm_consensus_tpu.') or m == 'llm_consensus_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------------


def _k9_inputs() -> tuple[dict, dict]:
    """tests/test_mesh_serving.py's K9 inputs and JAX's reference outputs."""
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    b, h, hkv, d = 4, 4, 2, 128
    n_pages, pg, p_per = 16, 8, 4
    q = jax.random.normal(ks[0], (b, h, d), jnp.float32)
    k_pool = jax.random.normal(ks[1], (n_pages, pg, hkv, d), jnp.float32)
    v_pool = jax.random.normal(ks[2], (n_pages, pg, hkv, d), jnp.float32)
    table = np.zeros((b, p_per), np.int32)
    table[0] = [1, 2, 3, 0]
    table[1] = [1, 4, 0, 0]
    table[2] = [8, 9, 0, 0]
    table[3] = [8, 10, 11, 0]
    valid = np.asarray([22, 13, 11, 23], np.int32)
    q_chunk = jax.random.normal(ks[3], (4, h, d), jnp.float32)
    chunk_table = np.zeros((p_per,), np.int32)
    chunk_table[:2] = [12, 13]  # owner: shard 1
    qv = jax.random.normal(ks[4], (b, 3, h, d), jnp.float32)
    ref_dec, ref_ch = ragged_paged_attention_reference(
        q, k_pool, v_pool, jnp.asarray(table), jnp.asarray(valid), q_chunk=q_chunk,
        chunk_table=jnp.asarray(chunk_table), chunk_start=jnp.int32(8))
    want = {
        "dec": ref_dec, "chunk": ref_ch,
        "window": ragged_paged_attention_reference(
            q, k_pool, v_pool, jnp.asarray(table), jnp.asarray(valid), window=9),
        "verify": ragged_paged_attention_reference(
            qv, k_pool, v_pool, jnp.asarray(table), jnp.asarray(valid)),
    }
    inputs = dict(
        q=q, k_pool=k_pool, v_pool=v_pool, table=table, valid=valid, q_chunk=q_chunk,
        chunk_table=chunk_table, chunk_start=8, qv=qv,
        gid=np.asarray([0, 0, 1, 1], np.int32), rep=np.asarray([0, 2], np.int32),
        gend=np.asarray([8, 8], np.int32), sstart=np.asarray([8, 8, 8, 8], np.int32),
    )
    return {k: np.asarray(v) for k, v in inputs.items()}, _np_tree(want)


# Paged-step script: rows 0 and 1 on data shard 0 (pages 1-11), rows 2 and
# 3 on shard 1 (pages 13-23); each pair shares its first page (a group);
# the fused step's chunk lives on shard 1.
_GEOMETRY = (8, 24, 4, 6)  # page, pages, slots, table width


def _steps_script():
    pg, n_pages, slots, p_per = _GEOMETRY
    rng = np.random.default_rng(0)

    def table(*pages):
        return np.array(list(pages) + [0] * (p_per - len(pages)), np.int32)

    p0 = rng.integers(3, 259, 13).astype(np.int32)
    p1 = np.concatenate([p0[:8], rng.integers(3, 259, 12)]).astype(np.int32)
    p2 = rng.integers(3, 259, 10).astype(np.int32)
    p3 = np.concatenate([p2[:8], rng.integers(3, 259, 6)]).astype(np.int32)
    # Row 1 ends on shard 0's last page (11): a write of shard 1's chunk
    # lane that shard 0 clamped instead of dropping would land there.
    tables = [table(1, 2, 3, 4), table(1, 5, 11), table(13, 14, 15), table(13, 16, 17)]
    chunks = []
    for ids, starts, tbl in ((p0, (0, 8), tables[0]), (p1, (8, 16), tables[1]),
                             (p2, (0, 8), tables[2]), (p3, (8,), tables[3])):
        for start in starts:
            toks = np.zeros((1, 8), np.int32)
            seg = ids[start:start + 8]
            toks[0, :len(seg)] = seg
            chunks.append((toks, start, tbl))
    lengths = (13, 20, 10, 14)
    jg = jpc.GroupTracker(slots, pg)
    for row, (tbl, n) in enumerate(zip(tables, lengths)):
        jg.add(row, tbl[: n // pg])
    groups = tuple(np.asarray(a) for a in (
        jg.arrays().group_id, jg.arrays().group_rep, jg.arrays().group_pages,
        jg.arrays().shared_start))
    return dict(
        geometry=_GEOMETRY, chunks=chunks,
        installs={r: (tables[r], lengths[r]) for r in range(4)},
        groups=groups, first_tokens=rng.integers(3, 259, (slots, 1)).astype(np.int32),
        fused=(rng.integers(3, 259, (1, 8)).astype(np.int32), table(18, 19)),
    )


def _jax_steps(jparams, script) -> dict:
    """The same script through JAX's single-device paged steps."""
    jcfg = j_get_config("test-tiny").with_(use_pallas=False)
    pg, n_pages, slots, p_per = script["geometry"]
    cache = jpc.PagedKVCache.create(jcfg, n_pages, pg, slots, p_per, jnp.float32)
    out = {"hidden": [], "logits": []}
    for toks, start, tbl in script["chunks"]:
        h, cache = jt.prefill_chunk_paged(jcfg, jparams, jnp.asarray(toks), jnp.asarray(tbl),
                                          jnp.int32(start), cache)
        out["hidden"].append(np.asarray(h))
    for row, (tbl, n) in script["installs"].items():
        cache = jpc.install_seq(cache, jnp.int32(row), jnp.asarray(tbl), jnp.int32(n))
    groups = jpc.DecodeGroupArrays(*(jnp.asarray(a) for a in script["groups"]))
    toks = script["first_tokens"]
    for _ in range(2):
        logits, cache = jt.decode_step_paged(jcfg, jparams, jnp.asarray(toks), cache,
                                             groups=groups)
        out["logits"].append(np.asarray(logits))
        toks = np.asarray(logits).argmax(-1).astype(np.int32)[:, None]
    ids, tbl = script["fused"]
    logits, hidden, cache = jt.fused_step_paged(
        jcfg, jparams, jnp.asarray(toks), cache, jnp.asarray(ids), jnp.asarray(tbl),
        jnp.int32(0), groups=groups)
    out["logits"].append(np.asarray(logits))
    out["hidden"].append(np.asarray(hidden))
    return out


@pytest.fixture(scope="module")
def jax_texts():
    """The JAX single-device batcher's greedy (texts, token counts) per
    parameter seed: the byte-parity oracle of every mesh and depth (JAX's
    own mesh tests use one reference)."""
    jcfg = j_get_config("test-tiny").with_(use_pallas=False)
    out = {}
    for seed in SEEDS:
        b = JBatcher(jcfg, _jparams(seed), config=JConfig(**CCFG))
        try:
            res = [f.result(timeout=300) for f in [b.submit(p) for p in PROMPTS]]
        finally:
            b.close()
        out[seed] = ([r.text for r in res], [r.num_tokens for r in res])
    return out


@pytest.fixture(scope="module")
def steps_script():
    return _steps_script()


_WORLDS: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jparams, steps_script):
    """Each mesh's world, run once for the module: dp2 x mp2 runs the
    collectives, K9's cases, the paged steps and the batcher; dp1 x mp2
    the paged steps and the batcher; dp2 x mp1 the batcher."""
    params = _np_tree(jparams)
    k9_inputs, _ = _k9_inputs()
    plans = {
        "dp2xmp2": [("collectives", ()), ("k9_cases", (k9_inputs,)),
                    ("paged_steps", (params, steps_script))],
        "dp1xmp2": [("paged_steps", (params, steps_script))],
        "dp2xmp1": [],
    }

    def get(name):
        if name not in _WORLDS:
            shape = MESHES[name]
            trees = {seed: _np_tree(_jparams(seed)) for seed in SEEDS}
            tasks = plans[name] + [("serve", (trees, CCFG, PROMPTS, [1, 2]))]
            n = MeshConfig(**shape).size
            _WORLDS[name] = _world(tmp_path_factory, shape, tasks, n)
        return _WORLDS[name]

    return get


def test_mesh_collectives_are_exact(world):
    got = world("dp2xmp2")["collectives"]
    assert got["coords"] == (0, 0)
    assert got["sum_model"] == [1.0] * 3  # ranks 0 + 1
    assert got["sum_data"] == [2, 2]  # ranks 0 + 2
    assert got["gather_model"] == [[0.0, 0.0, 1.0, 1.0]]
    assert got["gather_data"] == [0, 0, 1, 1]
    assert got["gather_bf16"] == [1.5, 1.5, 2.5, 2.5]
    assert got["broadcast"] == {"from": 0}
    assert got["batch_slice"] == (2, 0)  # rank 0 of 4: rows [0, 2) of 8


def test_launcher_reports_a_failing_rank(tmp_path):
    """A rank that raises exits 1 with its traceback; its peer, stuck in a
    collective, is killed after the grace instead of hanging the world."""
    res = launch(f"{RANKS}:run", 2, ({"data": 2}, [("fail_on_rank", (1,))]), backend="gloo",
                 workdir=tmp_path, deadline_s=DEADLINE_S, timeout_s=60.0)
    assert res[1].exitcode == 1 and "fails on purpose" in res[1].error
    assert not res[0].ok


def test_k9_twin_matches_jax_reference(world):
    _, want = _k9_inputs()
    got = world("dp2xmp2")["k9_cases"]
    for name in ("dec", "chunk", "window", "verify"):
        np.testing.assert_allclose(got[name], want[name], **F32_TOL, err_msg=name)


@pytest.mark.parametrize("shape", ["dp1xmp2", "dp2xmp2"])
def test_tp_paged_steps_match_jax(world, jparams, steps_script, shape):
    want = _jax_steps(jparams, steps_script)
    got = world(shape)["paged_steps"]
    for kind in ("hidden", "logits"):
        assert len(got[kind]) == len(want[kind])
        for i, (g, w) in enumerate(zip(got[kind], want[kind])):
            np.testing.assert_allclose(g, w, **F32_TOL, err_msg=f"{kind} {i}")


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_mesh_batcher_text_equals_jax(world, jax_texts, shape, depth):
    for seed in SEEDS:
        out = world(shape)["serve"][seed, depth]
        assert (out["texts"], out["tokens"]) == jax_texts[seed], ascii(out["texts"])
    assert jax_texts[1][1] == [CCFG["max_new_tokens"]] * len(PROMPTS)
    st = out["stats"]
    dp, mp = MeshConfig(**MESHES[shape]).data, MeshConfig(**MESHES[shape]).model
    assert (st["mesh_data_shards"], st["mesh_model_shards"]) == (dp, mp)
    assert st["completed_requests"] == len(PROMPTS)
    assert st["device_programs_fused"] > 0
    # Both headers share their pages, each inside its own data shard.
    assert st["prefix_pages_shared"] > 0
    assert len(st["prefix_pages_shared_per_shard"]) == dp


def test_cli_serves_a_question_on_a_mesh(tmp_path):
    """The CLI's ``--mesh`` rank body on a dp2 x mp2 world (what the CLI
    runs under torchrun or its own launcher, here under a deadline): rank 0
    answers through the mesh batcher, the others serve until it closes."""
    argv = ["--backend", "continuous", "--cpu", "--model", "test-tiny",
            "--mesh", "data=2,model=2", "--dist-backend", "gloo",
            "--max-new-tokens", "4", "--max-rounds", "1", "--seed", "1",
            "--serve-slots", "4", "--question", "hi"]
    res = launch("llm_consensus_tpu_torch.cli:mesh_rank", 4, (argv,), backend="gloo",
                 workdir=tmp_path, deadline_s=DEADLINE_S, timeout_s=60.0)
    assert all(r.ok and r.result == 0 for r in res), [(r.rank, r.error) for r in res]
    assert "Final answer" in res[0].log
    with pytest.raises(SystemExit, match="dist-backend"):
        cli.main(argv[:7] + argv[9:])  # --mesh without --dist-backend


# ---------------------------------------------------------------------------
# On the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K9 launches K8's kernel, which has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k9_kernel_matches_twin_on_card(cuda, tmp_path):
    """K9 on a dp2 x mp2 world of 4 ranks on one card over gloo, against
    its twin on every rank (chip_smoke.py phase 6 runs the llama-1b cases)."""
    from llm_consensus_tpu_torch.ops.kernels import build

    build.load_library()  # once, before the ranks start
    inputs, want = _k9_inputs()
    res = launch(f"{RANKS}:run", 4, ({"data": 2, "model": 2}, [("k9_cases", (inputs,))],
                                     "cuda"),
                 backend="gloo", workdir=tmp_path, deadline_s=DEADLINE_S)
    assert all(r.ok for r in res), [(r.rank, r.error) for r in res]
    got = res[0].result["k9_cases"]
    for name in ("dec", "chunk", "window", "verify"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4, err_msg=name)
