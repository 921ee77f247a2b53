"""CLI / REPL entry point of the PyTorch port.

``python -m llm_consensus_tpu_torch --backend {fake,local} --model llama-1b
--question "..." [--quant {none,int8,int4}] [--max-new-tokens N]
[--temperature T] [--seed S] [--cpu]``

The flags are the JAX package's (``llm_consensus_tpu/cli.py``) for the
surfaces ported so far. Without ``--question`` it runs the reference's REPL
(``src/main.rs:428-471``): prompt ``"Enter a question: "``, ``exit``
terminates. The local backend runs on the card unless ``--cpu`` is given;
without a checkpoint loader ported yet, its weights are random, made from
``--seed``. ``--quant int8`` quantizes them to int8 at engine init (the
W8A16 kernel); ``int4`` raises until its kernel is ported.
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

log = logging.getLogger("llm_consensus_tpu_torch")


def _init_logging() -> None:
    """Level from the ``LLM_CONSENSUS_LOG`` env var (default info)."""
    level = os.environ.get("LLM_CONSENSUS_LOG", "info").upper()
    logging.basicConfig(
        level=getattr(logging, level, logging.INFO),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )


def _printable(text: str) -> str:
    """Model output for stdout: lone surrogates (the ByteTokenizer's
    reversible stand-ins for invalid bytes) render as U+FFFD."""
    return "".join(
        "\ufffd" if 0xD800 <= ord(ch) <= 0xDFFF else ch for ch in text
    )


def _build_backend(args):
    if args.backend == "fake":
        return FakeBackend()
    from llm_consensus_tpu_torch.backends.local import LocalBackend
    from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params

    device = "cpu" if args.cpu else None
    cfg = get_config(args.model)
    log.warning(
        "Using RANDOM weights for %s (protocol/e2e plumbing only; text "
        "will be gibberish).",
        cfg.name,
    )
    params = init_params(cfg, args.seed or 0, device=device)
    engine = InferenceEngine(
        cfg,
        params,
        engine_config=EngineConfig(
            max_new_tokens=args.max_new_tokens, quant=args.quant
        ),
        device=device,
    )
    return LocalBackend(engine)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="llm_consensus_tpu_torch",
        description="Multi-persona LLM consensus on local PyTorch inference.",
    )
    p.add_argument("--backend", choices=["fake", "local"], default="fake")
    p.add_argument(
        "--cpu",
        action="store_true",
        help="run the local backend on the CPU instead of the card",
    )
    p.add_argument("--model", default="llama-1b", help="model preset name")
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
    return p


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
    _init_logging()
    args = build_parser().parse_args(argv)
    panel = load_panel(args.panel) if args.panel else default_panel()
    coord = Coordinator(
        panel,
        _build_backend(args),
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
