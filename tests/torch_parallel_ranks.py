"""Rank bodies of tests/test_torch_parallel.py, run by the port's launcher.

:func:`run` is the rank body: one ``gloo`` world on the CPU, one mesh,
then each named task in order (every rank runs the same tasks, so their
collectives pair up). The module imports only the port (and numpy): the
JAX oracles are computed in the test's own process and arrive here as
numpy arrays, and what a rank returns goes back as numpy. Rank 0's result
carries the whole answer (outputs gathered over the mesh); the other
ranks return their own small checks or None.
"""

from __future__ import annotations

import numpy as np
import torch

from llm_consensus_tpu_torch.models import paged_cache as pc
from llm_consensus_tpu_torch.models import transformer as tt
from llm_consensus_tpu_torch.models.configs import get_config
from llm_consensus_tpu_torch.ops.kernels import ragged_attention as kr
from llm_consensus_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llm_consensus_tpu_torch.parallel.multihost import local_batch_slice
from llm_consensus_tpu_torch.parallel.partitioning import shard_params
from llm_consensus_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    ContinuousConfig,
    serve_worker,
)


def run(shape: dict, tasks: list, device: str = "cpu") -> dict:
    """Build the mesh of ``shape`` on ``device`` and run ``tasks``
    ([(name, args)]) in order; returns {name: result}."""
    torch.set_num_threads(1)  # several ranks share the box's cores
    mesh = make_mesh(MeshConfig(**shape), device=device)
    return {name: globals()[name](mesh, *args) for name, args in tasks}


def _t(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _full(mesh, x: torch.Tensor, row_axis: str | None, row_dim: int, head_dim: int | None):
    """This rank's block of an output, gathered into the global array."""
    if row_axis is not None:
        x = mesh.gather(x.contiguous(), row_axis, dim=row_dim)
    if head_dim is not None:
        x = mesh.gather(x.contiguous(), "model", dim=head_dim)
    return x.cpu().numpy()


def collectives(mesh) -> dict:
    """Sum, gather and broadcast on each axis, exact values expected."""
    d, m = mesh.index("data"), mesh.index("model")
    got = {
        "coords": (d, m),
        "sum_model": mesh.sum(torch.full((3,), float(mesh.rank)), "model").tolist(),
        "sum_data": mesh.sum(torch.full((2,), mesh.rank, dtype=torch.int32), "data").tolist(),
        "gather_model": mesh.gather(torch.full((1, 2), float(m)), "model", dim=1).tolist(),
        "gather_data": mesh.gather(
            torch.full((2,), d, dtype=torch.int32), "data", dim=0).tolist(),
        "gather_bf16": mesh.gather(
            torch.full((2,), 1.5 + d, dtype=torch.bfloat16), "data", dim=0).float().tolist(),
        "broadcast": mesh.broadcast_object({"from": mesh.rank} if mesh.rank == 0 else None),
        "batch_slice": local_batch_slice(8),
    }
    mesh.barrier()
    return got


def fail_on_rank(mesh, bad: int) -> int:
    """Rank ``bad`` raises; the others wait in a collective it never joins."""
    if mesh.rank == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    mesh.barrier()
    return mesh.rank


def k9_cases(mesh, inputs: dict) -> dict | None:
    """K9's twin on this rank's shard of ``inputs`` (the global arrays of
    the JAX K9 test), every case; rank 0 returns the gathered outputs."""
    dp, mp = mesh.size("data"), mesh.size("model")
    d, m = mesh.index("data"), mesh.index("model")
    b, h = inputs["q"].shape[0], inputs["q"].shape[1]
    n_pages, hkv = inputs["k_pool"].shape[0], inputs["k_pool"].shape[2]
    bl, hl, pl, kl = b // dp, h // mp, n_pages // dp, hkv // mp
    rows = slice(d * bl, (d + 1) * bl)
    heads = slice(m * hl, (m + 1) * hl)
    kv_heads = slice(m * kl, (m + 1) * kl)
    pages = slice(d * pl, (d + 1) * pl)

    def t(a):
        return _t(a, device=mesh.device)

    kp = t(inputs["k_pool"][pages, :, kv_heads])
    vp = t(inputs["v_pool"][pages, :, kv_heads])
    tbl = t(inputs["table"][rows])
    val = t(inputs["valid"][rows])
    q = t(inputs["q"][rows, heads])
    groups = (t(inputs["gid"][rows]), t(inputs["rep"]), t(inputs["gend"]),
              t(inputs["sstart"][rows]))
    out_dec, out_ch = kr.ragged_paged_attention_sharded(
        mesh, q, kp, vp, tbl, val, q_chunk=t(inputs["q_chunk"][:, heads]),
        chunk_table=t(inputs["chunk_table"]), chunk_start=int(inputs["chunk_start"]),
        groups=groups,
    )
    out_w = kr.ragged_paged_attention_sharded(mesh, q, kp, vp, tbl, val, window=9)
    out_v = kr.ragged_paged_attention_sharded(
        mesh, t(inputs["qv"][rows, :, heads]), kp, vp, tbl, val)
    res = {
        "dec": _full(mesh, out_dec, "data", 0, 1),
        "chunk": _full(mesh, out_ch, None, 0, 1),
        "window": _full(mesh, out_w, "data", 0, 1),
        "verify": _full(mesh, out_v, "data", 0, 2),
    }
    return res if mesh.rank == 0 else None


def paged_steps(mesh, params: dict, script: dict) -> dict | None:
    """The paged steps of tests/test_torch_paged.py's JAX parity test on
    this rank's shard (float32 weights and pool): two prompts' chunks, a
    grouped decode step twice, a fused step with a third prompt's chunk.
    Rank 0 returns the chunk hidden states and the logits, gathered."""
    cfg = get_config("test-tiny").with_(use_pallas=True)
    sp = shard_params(tt.params_from_jax(params, device="cpu"), mesh)
    pg, n_pages, slots, p_per = script["geometry"]
    cache = pc.PagedKVCache.create(cfg, n_pages, pg, slots, p_per, torch.float32, mesh=mesh)
    out: dict = {"hidden": [], "logits": []}
    for ids, start, table in script["chunks"]:
        h, _ = tt.prefill_chunk_paged(cfg, sp, _t(ids, torch.int64), _t(table), start,
                                      cache, mesh=mesh)
        out["hidden"].append(h.numpy())
    for row, (table, length) in script["installs"].items():
        pc.install_seq(cache, row, table, length)
    lo, hi = cache.row_offset, cache.row_offset + cache.max_seqs
    groups = pc.DecodeGroupArrays.from_host(script["groups"], mesh.device, slice(lo, hi))
    toks = script["first_tokens"]
    for _ in range(2):
        logits, _ = tt.decode_step_paged(cfg, sp, _t(toks[lo:hi]), cache, groups=groups,
                                         mesh=mesh)
        full = mesh.gather(logits, "data", dim=0)
        out["logits"].append(full.numpy())
        toks = full.argmax(-1).to(torch.int32)[:, None].numpy()
    ids, table = script["fused"]
    logits, hidden, _ = tt.fused_step_paged(cfg, sp, _t(toks[lo:hi]), cache,
                                            _t(ids, torch.int64), _t(table), 0,
                                            groups=groups, mesh=mesh)
    out["logits"].append(mesh.gather(logits, "data", dim=0).numpy())
    out["hidden"].append(hidden.numpy())
    return out if mesh.rank == 0 else None


def serve(mesh, trees: dict, config: dict, prompts: list, depths: list) -> dict | None:
    """The mesh batcher's greedy float32 results for ``prompts``, for each
    parameter tree of ``trees`` ({seed: tree}) at each pipeline depth (one
    batcher each, every rank in step); rank 0 returns {(seed, depth):
    texts, token counts and stats}."""
    cfg = get_config("test-tiny").with_(use_pallas=True)
    out = {}
    for seed, tree in trees.items():
        full = tt.params_from_jax(tree, device="cpu")
        for depth in depths:
            c = ContinuousConfig(**config, pipeline_depth=depth)
            if mesh.rank != 0:
                serve_worker(cfg, full, c, mesh)
                continue
            batcher = ContinuousBatcher(cfg, full, config=c, mesh=mesh)
            try:
                res = [f.result(timeout=300) for f in [batcher.submit(p) for p in prompts]]
                stats = batcher.stats()
            finally:
                batcher.close()
            out[seed, depth] = {"texts": [r.text for r in res],
                                "tokens": [r.num_tokens for r in res], "stats": stats}
    return out if mesh.rank == 0 else None
