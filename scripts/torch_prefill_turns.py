#!/usr/bin/env python3
"""Prefill wall time of the port's engine, in turns between source trees.

    python3 scripts/torch_prefill_turns.py TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` is the current one).
For each tree, in the order given, a fresh process puts that tree first
on ``sys.path``, builds its kernels, makes llama-1b in bf16 with random
weights from seed 0 (``chip_smoke.build_engine``) and times
``generate_texts`` with one new token on the panel's evaluation shape:
4 prompts cut to the 2048-token bucket, so one prefill and one decode
step. One warm-up call, then ``REPEATS`` timed calls (host clock around
the call, the card synchronised). Then one consensus question on the same
engine (``chip_smoke.run_consensus``: default panel, cap 2, 64 new
tokens), timed likewise; its text, and so its calls' lengths, may differ
between trees where their kernels round differently. Prints one JSON
line per tree (median and every prefill wall time, K2's launches per
prefill call, the question's seconds and K2 launches), then the card's
name and power limit. Give two trees as A B B A to compare them in one call: the
host's speed moves between calls. Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPEATS = 5
N_PROMPTS = 4


def child(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke
    from llm_consensus_tpu_torch.backends.local import LocalBackend
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.ops import kernels

    cfg = get_config("llama-1b")
    engine = chip_smoke.build_engine(torch, cfg)
    words = " ".join(chip_smoke._WORDS * 30)
    prompts = [f"{i}: {words}" for i in range(N_PROMPTS)]

    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate_texts(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()
    kernels.reset_launch_counts()
    walls = [call() for _ in range(REPEATS)]
    k2_per_call = kernels.flash_causal_attention.launches / REPEATS
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chip_smoke.run_consensus(LocalBackend(engine))
    torch.cuda.synchronize()
    question_s = time.perf_counter() - t0
    print(json.dumps({
        "tree": tree, "median_s": statistics.median(walls), "walls_s": walls,
        "k2_launches_per_call": k2_per_call, "question_s": question_s,
        "question_k2_launches": kernels.flash_causal_attention.launches,
        "card": torch.cuda.get_device_name(0),
    }), flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    trees = sys.argv[1:] or ["."]
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--child", tree], check=True)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
