#!/usr/bin/env python3
"""Where the port's generate time goes on the card: device busy share and
device time by kernel, for llama-1b (random weights, seed 0) in bf16, or
with ``--int8`` on the int8 path (weights quantized at engine init, int8
KV cache).

    python3 scripts/torch_decode_profile.py [--n 64] [--new-tokens 32] [--int8]

Runs ``InferenceEngine.generate_texts`` on N copies of
``chip_smoke.SC_PROMPT`` (the self-consistency fan-out of
``chip_smoke.py``, on the engine ``chip_smoke.build_engine`` makes) three
times: to warm up, timed without the profiler, and under
``torch.profiler``. Prints one JSON object: both wall times, the summed
duration of every device event of the profiled run (kernels, copies,
sets), milliseconds per decode step, the device time of the 12 most
expensive kernels (names cut to 90 characters; kernels whose cut names
agree are summed), and two idle shares:

- ``profiled_device_idle_share``: busy time and wall of the one profiled
  run. The profiler adds host time to every launch, so this overstates
  the idle share of a normal run.
- ``idle_share_two_runs``: the profiled run's busy time over the
  unprofiled run's wall. The two runs do the same work, but the share
  combines two runs.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and an int8 KV cache")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SC_PROMPT, build_engine
    from llm_consensus_tpu_torch.models.configs import get_config

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    quant = dict(quant="int8", kv_quant=True) if args.int8 else {}
    engine = build_engine(torch, get_config("llama-1b"), args.new_tokens, **quant)
    prompts = [SC_PROMPT] * args.n
    temps = [0.7] * args.n

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate_texts(prompts, temperatures=temps, seed=0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    run()  # warm up (cuBLAS handles, the kernel library)
    plain_wall, _ = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, out = run()
    by_name: dict[str, float] = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name[:90]] += evt.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    steps = args.new_tokens  # one prefill + (new_tokens - 1) decode steps
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "path": "int8" if args.int8 else "bf16",
        "n": args.n,
        "new_tokens": args.new_tokens,
        "generated_tokens": sum(r.num_tokens for r in out),
        "wall_ms": plain_wall * 1e3,
        "wall_ms_per_step": plain_wall * 1e3 / steps,
        "device_busy_ms": busy_ms,
        "profiled_wall_ms": wall * 1e3,
        "profiled_device_idle_share": 1 - busy_ms / (wall * 1e3),
        "idle_share_two_runs": 1 - busy_ms / (plain_wall * 1e3),
        "top_kernels_ms": {name: us / 1e3 for name, us in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
