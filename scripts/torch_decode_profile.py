#!/usr/bin/env python3
"""Where the port's generate time goes on the card: device busy share and
device time by kernel, for llama-1b (random weights, seed 0) in bf16, or
with ``--int8`` / ``--int4`` on the int8 / int4 path (weights quantized
at engine init, int8 KV cache; K6 / K10 carry the projections).

    python3 scripts/torch_decode_profile.py [--n 64] [--new-tokens 32] [--int8 | --int4]
    python3 scripts/torch_decode_profile.py --serve [--low-load] [--int8 | --int4]
    python3 scripts/torch_decode_profile.py --model mixtral-8x7b --int8 --n 8 --new-tokens 8

``--model mixtral-8x7b`` (with ``--int8``: its bf16 weights do not fit one
card) profiles the same fan-out on mixtral-8x7b, int8 weights drawn on
the card a matrix at a time (``init_params_quantized``) and the int8 KV
cache, the engine of ``chip_smoke.py``'s phase 4m.

``--serve`` profiles the serving path instead: ``chip_smoke.py``'s
32-request burst (``chip_smoke.serving_burst``, another seed each run)
through a ``ContinuousBatcher`` with ``max_slots=chip_smoke.SERVE_SLOTS``
on the same weights (device time of the batcher's worker thread: the
profiler traces the card, not a thread). ``--low-load``: a server past
its busy hour instead. Every slot serves once, then one long request
decodes alone while the other slots idle (``IDLE_STEPS`` steps); each
run is then one request (300-token header, 128 new tokens) among slots
that have idled that long. ``idle_slot_length_max`` in the output is
the longest cache length of a slot at the end (idle slots' lengths grow
by one each step).

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

# --low-load: decode steps the other slots idle for before the measured
# requests (a slot's table holds 32 pages of 64 tokens).
IDLE_STEPS = 1800


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    bits = ap.add_mutually_exclusive_group()
    bits.add_argument("--int8", action="store_true",
                      help="int8 weights and an int8 KV cache")
    bits.add_argument("--int4", action="store_true",
                      help="packed int4 weights and an int8 KV cache")
    ap.add_argument("--serve", action="store_true",
                    help="the serving burst through the continuous batcher")
    ap.add_argument("--low-load", action="store_true",
                    help="with --serve: one request at a time among idle slots")
    ap.add_argument("--model", choices=("llama-1b", "mixtral-8x7b"), default="llama-1b")
    args = ap.parse_args()
    if args.model == "mixtral-8x7b" and (args.serve or not args.int8):
        ap.error("--model mixtral-8x7b profiles the engine's fan-out on int8 weights (--int8)")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SC_PROMPT, build_engine
    from llm_consensus_tpu_torch.models.configs import get_config

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    weights = "int8" if args.int8 else "int4" if args.int4 else "bf16"
    quant = {} if weights == "bf16" else dict(quant=weights, kv_quant=True)
    if args.serve:
        from chip_smoke import SERVE_SLOTS, serving_burst
        from llm_consensus_tpu_torch.models.transformer import init_params
        from llm_consensus_tpu_torch.serving import ContinuousBatcher, ContinuousConfig

        cfg = get_config("llama-1b")
        params = init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
        if quant:  # quantized weights; the serving pool stays bf16
            from llm_consensus_tpu_torch.ops.quant import quantize_params

            params = quantize_params(params, bits=8 if args.int8 else 4)
        batcher = ContinuousBatcher(cfg, params, config=ContinuousConfig(max_slots=SERVE_SLOTS))
        seeds = iter(range(3))
        burst_kw = {}
        if args.low_load:
            burst_kw = dict(n_groups=1, per_group=1, new_tokens=(128, 128))
            for f in [batcher.submit(p, **kw) for p, kw in serving_burst(
                    n_groups=1, per_group=SERVE_SLOTS, new_tokens=(8, 8), seed=10)]:
                f.result(timeout=600)
            batcher.submit("idle " * 10, max_new_tokens=IDLE_STEPS).result(timeout=600)
        st0 = batcher.stats()

        def run():
            # Each run its own burst: a repeat would find its prompts in
            # the prefix registry.
            burst = serving_burst(seed=next(seeds), **burst_kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [f.result(timeout=600) for f in
                   [batcher.submit(p, **kw) for p, kw in burst]]
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out
    elif args.model == "mixtral-8x7b":
        from llm_consensus_tpu_torch.engine.engine import EngineConfig, InferenceEngine
        from llm_consensus_tpu_torch.models.transformer import init_params_quantized

        cfg = get_config(args.model)
        engine = InferenceEngine(
            cfg, init_params_quantized(cfg, 0, bits=8, device="cuda"),
            engine_config=EngineConfig(max_new_tokens=args.new_tokens, **quant))
    else:
        engine = build_engine(torch, get_config("llama-1b"), args.new_tokens, **quant)
    if not args.serve:
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
    serve = {}
    if args.serve:
        stats = batcher.stats()
        idle_len = int(batcher.cache.length.max())
        batcher.close()
        serve = {k: stats[k] - st0[k] for k in (
            "work_iterations", "device_programs_fused", "device_programs_decode",
            "device_programs_prefill")}
        steps = serve["work_iterations"] / 3  # three bursts ran
        if args.low_load:
            serve["idle_slot_length_max"] = idle_len
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "model": args.model,
        "path": ("serve " if args.serve else "") + ("low load " if args.low_load else "")
        + weights,
        "n": len(out) if args.serve else args.n,
        "new_tokens": None if args.serve else args.new_tokens,
        **serve,
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
