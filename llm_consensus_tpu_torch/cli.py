"""CLI / REPL entry point of the PyTorch port.

``python -m llm_consensus_tpu_torch --backend {fake,local,continuous}
--model llama-1b --question "..." [--quant {none,int8,int4}]
[--max-new-tokens N] [--temperature T] [--seed S] [--cpu]
[--hf-checkpoint DIR] [--tokenizer DIR]``

``python -m llm_consensus_tpu_torch --plan --model llama3-8b [--plan-n 64]
[--plan-context 2048] [--plan-quant {none,int8,int4}] [--plan-kv
{none,int8}] [--plan-hbm-gib G]``: the config-only device-memory plan
(nothing is allocated, no card needed) as the JAX package's JSON; exit 1
when it does not fit.

The flags are the JAX package's (``llm_consensus_tpu/cli.py``) for the
surfaces ported so far. Without ``--question`` it runs the reference's REPL
(``src/main.rs:428-471``): prompt ``"Enter a question: "``, ``exit``
terminates. The local and continuous backends run on the card unless
``--cpu`` is given. Their weights come from ``--hf-checkpoint`` (an HF
safetensors directory whose ``config.json`` gives the model config) or
are random, made from ``--seed``; ``--tokenizer`` names a local HF
tokenizer directory (the byte tokenizer otherwise). ``--quant int8``
quantizes the weights to int8
(the W8A16 kernel), ``--quant int4`` to packed int4 (the W4A16 kernel).
``--backend continuous`` serves the panel through the continuous batcher
(``--serve-slots``, ``--prefill-chunk``, ``--no-share-prefix``,
``--no-ragged-attention``, ``--pipeline-depth``); the HTTP ``serve``
subcommand comes with the gateway slice.

``--backend continuous --mesh data=2,model=2 --dist-backend gloo`` serves
on a dp x mp mesh over ``torch.distributed``: rank 0 runs the question or
the REPL, the other ranks the batcher's worker loop. Under ``torchrun
--nproc-per-node 4`` the world comes from its environment; without it the
CLI starts the ranks itself (the port's launcher), rank 0's output on this
terminal. Each rank drives ``cuda:(LOCAL_RANK % card count)``: ``nccl``
with one card per rank, ``gloo`` for several ranks on one card (or
``--cpu``).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys

from llm_consensus_tpu_torch.backends.base import SamplingParams
from llm_consensus_tpu_torch.backends.fake import FakeBackend
from llm_consensus_tpu_torch.consensus.coordinator import (
    Coordinator,
    CoordinatorConfig,
)
from llm_consensus_tpu_torch.consensus.personas import default_panel, load_panel

from llm_consensus_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("llm_consensus_tpu_torch")

# ``--plan-hbm-gib``'s default: the device memory of one NVIDIA H100 80GB
# HBM3, torch.cuda.get_device_properties(0).total_memory as chip_smoke.py
# prints it there.
H100_TOTAL_MEMORY = 85_017_493_504


def _printable(text: str) -> str:
    """Model output for stdout: lone surrogates (the ByteTokenizer's
    reversible stand-ins for invalid bytes) render as U+FFFD."""
    return "".join(
        "\ufffd" if 0xD800 <= ord(ch) <= 0xDFFF else ch for ch in text
    )


def _model(args, device):
    """(config, params): from ``--hf-checkpoint``, or random weights of
    the ``--model`` preset from ``--seed`` (with ``--quant``, drawn and
    quantized a matrix at a time on the device: mixtral-8x7b's bf16 tree
    would not fit one card)."""
    if args.hf_checkpoint:
        from llm_consensus_tpu_torch.models.hf_loader import (
            config_from_hf,
            load_hf_params,
        )

        cfg = config_from_hf(args.hf_checkpoint, name=args.model)
        return cfg, load_hf_params(cfg, args.hf_checkpoint, device=device)
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.models.transformer import (
        init_params,
        init_params_quantized,
    )

    cfg = get_config(args.model)
    log.warning(
        "Using RANDOM weights for %s (protocol/e2e plumbing only; text "
        "will be gibberish).",
        cfg.name,
    )
    if args.quant == "none":
        return cfg, init_params(cfg, args.seed or 0, device=device)
    return cfg, init_params_quantized(
        cfg, args.seed or 0, bits=8 if args.quant == "int8" else 4, device=device)


def _build_backend(args):
    if args.backend == "fake":
        return FakeBackend()
    from llm_consensus_tpu_torch.backends.local import LocalBackend
    from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_consensus_tpu_torch.engine.tokenizer import load_tokenizer

    device = "cpu" if args.cpu else None
    cfg, params = _model(args, device)
    tokenizer = load_tokenizer(args.tokenizer)
    if args.backend == "continuous":
        from llm_consensus_tpu_torch.serving.continuous import (
            ContinuousBackend,
            ContinuousBatcher,
        )

        return ContinuousBackend(
            ContinuousBatcher(
                cfg, _serving_params(args, params), tokenizer=tokenizer,
                config=_serving_config(args), device=device,
            )
        )
    engine = InferenceEngine(
        cfg,
        params,
        tokenizer=tokenizer,
        engine_config=EngineConfig(
            max_new_tokens=args.max_new_tokens, quant=args.quant
        ),
        device=device,
    )
    return LocalBackend(engine)


def _serving_params(args, params):
    """The engine path's weight-only quantization: the paged steps read
    quantized leaves through ops.quant.matmul as well."""
    if args.quant == "none":
        return params
    from llm_consensus_tpu_torch.ops.quant import quantize_params

    return quantize_params(params, bits=8 if args.quant == "int8" else 4)


def _serving_config(args):
    from llm_consensus_tpu_torch.serving.continuous import ContinuousConfig

    return ContinuousConfig(
        max_slots=args.serve_slots,
        max_new_tokens=args.max_new_tokens,
        prefill_chunk=args.prefill_chunk,
        share_prefix=not args.no_share_prefix,
        pipeline_depth=args.pipeline_depth,
        ragged_attention=not args.no_ragged_attention,
    )


def mesh_rank(argv: list[str]) -> int:
    """One rank of ``--mesh`` serving, in a world already joined: rank 0
    answers the question or runs the REPL through the mesh batcher; the
    other ranks run its worker loop until rank 0 closes it."""
    import torch

    from llm_consensus_tpu_torch.engine.tokenizer import load_tokenizer
    from llm_consensus_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llm_consensus_tpu_torch.serving.continuous import (
        ContinuousBackend,
        ContinuousBatcher,
        serve_worker,
    )

    setup_logging()
    args = build_parser().parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    else:
        from llm_consensus_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_mesh(MeshConfig(**_parse_axes(args.mesh)), device=device)
    # Every rank loads (or makes from the seed) the same full tree; each
    # keeps its shard.
    cfg, params = _model(args, device)
    params = _serving_params(args, params)
    if mesh.rank != 0:
        serve_worker(cfg, params, _serving_config(args), mesh)
        return 0
    log.info("serving %s on a %s mesh over %s", cfg.name, args.mesh, args.dist_backend)
    backend = ContinuousBackend(ContinuousBatcher(
        cfg, params, tokenizer=load_tokenizer(args.tokenizer),
        config=_serving_config(args), mesh=mesh,
    ))
    try:
        return _run_coordinator(args, backend)
    finally:
        asyncio.run(backend.close())


def _run_mesh(args, argv: list[str]) -> int:
    """``--mesh``: join torchrun's world, or start one with the port's
    launcher (rank 0's output here, stdin to rank 0)."""
    from llm_consensus_tpu_torch.parallel.mesh import MeshConfig
    from llm_consensus_tpu_torch.parallel.multihost import initialize_distributed

    if args.backend != "continuous":
        raise SystemExit("--mesh serves through --backend continuous")
    if args.dist_backend is None:
        raise SystemExit("--mesh needs --dist-backend {nccl,gloo}")
    size = MeshConfig(**_parse_axes(args.mesh)).size
    if "WORLD_SIZE" in os.environ:
        initialize_distributed(args.dist_backend)
        return mesh_rank(argv)
    import tempfile

    from llm_consensus_tpu_torch.parallel.launch import launch

    with tempfile.TemporaryDirectory(prefix="lct-mesh-") as work:
        results = launch(
            "llm_consensus_tpu_torch.cli:mesh_rank", size, (argv,),
            backend=args.dist_backend, workdir=work, deadline_s=None,
            rank0_inherits_stdio=True,
        )
    failed = [r for r in results if not r.ok]
    for r in failed:
        log.error("mesh rank %d failed: %s\n%s", r.rank, r.error, r.log)
    return 1 if failed else int(results[0].result or 0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="llm_consensus_tpu_torch",
        description="Multi-persona LLM consensus on local PyTorch inference.",
    )
    p.add_argument(
        "--backend", choices=["fake", "local", "continuous"], default="fake"
    )
    p.add_argument(
        "--cpu",
        action="store_true",
        help="run the local or continuous backend on the CPU instead of "
        "the card",
    )
    p.add_argument(
        "--serve-slots",
        type=int,
        default=8,
        help="continuous backend: decode slots (batch width of the decode "
        "program)",
    )
    p.add_argument(
        "--prefill-chunk",
        type=int,
        default=64,
        help="continuous backend: prefill-chunk tokens interleaved between "
        "decode steps",
    )
    p.add_argument(
        "--no-share-prefix",
        action="store_true",
        help="continuous backend: disable copy-on-write shared-prefix page "
        "dedup",
    )
    p.add_argument(
        "--no-ragged-attention",
        action="store_true",
        help="continuous backend: disable the fused scheduler step — "
        "prefill chunks run as standalone programs between decode steps "
        "(outputs are identical either way)",
    )
    p.add_argument(
        "--pipeline-depth",
        type=int,
        default=2,
        help="continuous backend: decode programs in flight at once (1 = "
        "the serialized loop; outputs are identical either way)",
    )
    p.add_argument(
        "--mesh",
        default=None,
        metavar="AXIS=N[,AXIS=N...]",
        help="continuous backend: serve on a data x model mesh, e.g. "
        "'data=2,model=2' (one rank per mesh device; needs --dist-backend)",
    )
    p.add_argument(
        "--dist-backend",
        choices=["nccl", "gloo"],
        default=None,
        help="--mesh: the torch.distributed backend — nccl with one card "
        "per rank, gloo for several ranks on one card or on the CPU",
    )
    p.add_argument("--model", default="llama-1b", help="model preset name")
    p.add_argument(
        "--hf-checkpoint",
        default=None,
        help="HF safetensors checkpoint dir (config.json derives the "
        "model config; overrides --model's preset)",
    )
    p.add_argument("--tokenizer", default=None, help="local HF tokenizer dir")
    p.add_argument("--panel", default=None, help="panel JSON file")
    p.add_argument(
        "--quant",
        choices=["none", "int8", "int4"],
        default="none",
        help="weight-only quantization for the local engine",
    )
    p.add_argument(
        "--max-rounds",
        type=int,
        default=5,
        help="evaluation-round cap (the reference hard-codes 5, "
        "src/main.rs:299-300)",
    )
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--question", default=None, help="answer one question and exit"
    )
    p.add_argument(
        "--plan",
        action="store_true",
        help="print the device-memory plan for --model at --plan-n/"
        "--plan-context (config-only, nothing is allocated, no card "
        "needed): does the config fit one card? Honors --plan-quant/"
        "--plan-kv/--plan-hbm-gib.",
    )
    p.add_argument("--plan-n", type=int, default=64)
    p.add_argument("--plan-context", type=int, default=2048)
    p.add_argument(
        "--plan-quant", default="int8", choices=("none", "int8", "int4")
    )
    p.add_argument(
        "--plan-kv",
        default="int8",
        choices=("none", "int8"),
        help="KV-cache quantization the plan assumes (bf16 doubles the "
        "cache term)",
    )
    p.add_argument(
        "--plan-mesh",
        default="",
        metavar="AXIS=N,...",
        help="plan per rank of a mesh, e.g. 'data=4,model=2' (pipe, "
        "expert and seq > 1 are not ported and raise)",
    )
    p.add_argument(
        "--plan-hbm-gib",
        type=float,
        default=H100_TOTAL_MEMORY / (1 << 30),
        help="device memory per card (default: one NVIDIA H100 80GB HBM3's)",
    )
    return p


def _parse_axes(spec: str) -> dict[str, int]:
    """``"data=4,model=2"`` -> ``{"data": 4, "model": 2}``."""
    sizes: dict[str, int] = {}
    for part in spec.split(","):
        axis, sep, n = part.partition("=")
        if not sep or not axis.strip() or not n.strip():
            raise SystemExit(f"bad mesh axis spec {part!r} (want AXIS=N,...)")
        sizes[axis.strip()] = int(n)
    return sizes


def _run_plan(args) -> int:
    """Capacity planning without touching a device (``--plan``)."""
    import json

    from llm_consensus_tpu_torch.engine.engine import plan_memory
    from llm_consensus_tpu_torch.models.configs import get_config

    mesh_shape = _parse_axes(args.plan_mesh) if args.plan_mesh else {}
    plan = plan_memory(
        get_config(args.model),
        quant=args.plan_quant,
        kv_quant=args.plan_kv == "int8",
        n_candidates=args.plan_n,
        prompt_len=max(1, args.plan_context - args.max_new_tokens),
        new_tokens=args.max_new_tokens,
        mesh_shape=mesh_shape or None,
        hbm_bytes=int(args.plan_hbm_gib * (1 << 30)),
    )
    gib = 1 << 30
    out = {
        "model": args.model,
        "quant": args.plan_quant,
        "kv_quant": args.plan_kv,
        "n_candidates": args.plan_n,
        "context": args.plan_context,
        "mesh": mesh_shape or "single chip",
        "params_gib": round(plan["params_bytes"] / gib, 2),
        "kv_cache_gib": round(plan["kv_cache_bytes"] / gib, 2),
        "total_gib": round(plan["total_bytes"] / gib, 2),
        "hbm_gib": args.plan_hbm_gib,
        "fits": plan["fits"],
    }
    print(json.dumps(out, indent=2))
    return 0 if plan["fits"] else 1


async def repl(coord: Coordinator, stream=None) -> None:
    """Interactive loop with reference UX parity (``src/main.rs:428-471``)."""
    out = stream or sys.stdout
    while True:
        out.write("Enter a question: ")
        out.flush()
        line = await asyncio.to_thread(sys.stdin.readline)
        if not line:
            break
        question = line.strip()
        if question == "exit":
            break
        if not question:
            continue
        await coord.ask_question(question)
        answer = await coord.wait_for_answer()
        log.info("Final answer: %s", _printable(answer))
        out.write(f"\n{_printable(answer)}\n\n")
        coord.reset()


def main(argv: list[str] | None = None) -> int:
    setup_logging()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.plan:
        return _run_plan(args)
    if args.mesh:
        return _run_mesh(args, argv)
    return _run_coordinator(args, _build_backend(args))


def _run_coordinator(args, backend) -> int:
    """Answer ``--question`` or run the REPL over ``backend``."""
    panel = load_panel(args.panel) if args.panel else default_panel()
    coord = Coordinator(
        panel,
        backend,
        CoordinatorConfig(
            max_rounds=args.max_rounds,
            seed=args.seed,
            sampling=SamplingParams(
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature,
            ),
        ),
    )
    if args.question is not None:
        result = asyncio.run(coord.run(args.question))
        print(_printable(result.answer))
        return 0
    asyncio.run(repl(coord))
    return 0
