#!/usr/bin/env python3
"""Decode-side kernel time and wall of the port's engine, in turns between
source trees.

    python3 scripts/torch_decode_turns.py TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` is the current one; a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists works too). For each tree, in the order given, a fresh
process puts that tree first on ``sys.path``, builds its kernels and makes
llama-1b with random weights from seed 0 (``chip_smoke.build_engine``):

- on int4 weights with an int8 KV cache, the N = 64 self-consistency
  fan-out (``chip_smoke.SC_PROMPT``, ``NEW_TOKENS`` new tokens): one
  warm-up call, one timed call (wall and wall per step), one call under
  ``torch.profiler``: device ms per call of K10 (the int4 matmul; its
  kernels and, in a tree that has it, the split-K reduce) and K7-q8's
  device ms per launch (the fan-out decodes through it), each the kernels'
  summed device time over the wrapper's launch count;
- the same fan-out on int8 weights with the int8 KV cache: its wall, K6's
  device ms per call (the int8 matmul's kernels, and the older
  tensor-core form's split-K reduce in a tree that has it) and K7-q8's
  device ms per launch;
- the same fan-out on bf16 weights with the bf16 cache: its wall and K7's
  device ms per launch;
- the 32-request serving burst (``chip_smoke.serving_burst``) through a
  ``ContinuousBatcher`` with ``max_slots=chip_smoke.SERVE_SLOTS`` on bf16
  weights, after a warm-up burst: its wall and generated tokens/s, then
  K8's device ms per call from a profiled repeat;
- for K7, K7-q8 and K8 also ``*_busy_ms_*``: the union of their kernels'
  intervals over the launches (their kernels are chained as programmatic
  dependents, whose durations overlap; the ``*_device_ms_*`` sums count
  the overlap twice), and ``*_kernels_ms``, each of their kernels' summed
  device ms;
- on int8 weights with the int8 KV cache, one consensus question
  (``chip_smoke.run_consensus``: default panel, cap 2, 64 new tokens), where
  K4 decodes: its seconds unprofiled, then K4's device ms per launch from a
  profiled repeat;
- the same question on bf16 weights with the bf16 cache, where K3 decodes:
  its seconds, then K3's device ms per launch from a profiled repeat;
- the host's cost of one wrapper call, enqueue only (the card is not
  waited on inside the timed loop, and runs behind the host): K3 and K4 on
  the panel's decode (q [4, 1, 16, 128], cache [4, 2176, 8, 128] bf16 and
  [4, 8, 2176, 128] int8), K7 and K7-q8 on the same caches with a
  1000-token prefix, K6 and K10 on llama-1b's w_gate at M = 64,
  ``HOST_CALLS`` calls each.

K7 and K7-q8 share their kernels' names with K3 and K4 (the same split-KV
pass), and K8's merge with both: each leg's sums are over kernels that only
the wrapper it reports launches there (its other decode wrappers' launch
counts are printed beside, and are 0).

Prints one JSON line per tree, then the card's name and power limit. Give
two trees as A B B A to compare them in one call: the host's speed moves
between calls. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

N = 64
NEW_TOKENS = 32
HOST_CALLS = 200
# Kernel names (substrings) by role, the names of earlier trees kept so that
# a parent is still counted. K10: the wgmma kernel on packed weights (named
# quant4_wgmma_kernel before K6 shared it), the older tensor-core kernel and
# its split-K reduce (K6 is not launched on int4 weights). K6: the wgmma
# kernel on int8 weights, or the older mma.sync kernel and its split-K
# reduce (K10 is not launched on int8 weights). K4: the split-KV pass on the
# int8 cache and its merge (named decode_q8_* before K3 shared them), or the
# older row kernel on the int8 cache, which K7-q8's row pass shares (its
# launches are printed beside). K3: the split-KV pass on the dense cache and
# its merge, or the older row kernel on the dense cache (the bf16 question
# runs no K4 and no K7, so the shared names count K3 alone there). K7-q8
# and K7 (in the fan-outs, which launch no K4 and no K3): the tile pass
# over the prefix and the split-KV pass and its merge, or the older prefix
# and row kernels. K8 (in the serving burst): the tile pass and the
# split-KV pass on the page pool and the merge, or the older row and tile
# kernels.
K10_NAMES = ("quant_wgmma_kernel<true", "quant4_wgmma_kernel", "quant4_matmul_tc_kernel",
             "split_reduce_kernel")
K6_NAMES = ("quant_wgmma_kernel<false", "quant_matmul_tc_kernel", "split_reduce_kernel")
K4_NAMES = ("decode_split_kernel<(anonymous namespace)::kv_split::Q8", "decode_merge_kernel",
            "decode_q8_split_kernel", "decode_q8_merge_kernel",
            "decode_row_kernel<(anonymous namespace)::Q8")
K3_NAMES = ("decode_split_kernel<(anonymous namespace)::kv_split::Dense", "decode_merge_kernel",
            "decode_row_kernel<(anonymous namespace)::Dense")
K7Q8_NAMES = ("tile_mma_kernel<(anonymous namespace)::kv_split::Q8",
              "tile_cc_kernel<(anonymous namespace)::kv_split::Q8",
              "decode_split_kernel<(anonymous namespace)::kv_split::Q8", "decode_merge_kernel",
              "prefix_kernel<(anonymous namespace)::Q8",
              "decode_row_kernel<(anonymous namespace)::Q8")
K7_NAMES = ("tile_mma_kernel<(anonymous namespace)::kv_split::Dense",
            "tile_cc_kernel<(anonymous namespace)::kv_split::Dense",
            "decode_split_kernel<(anonymous namespace)::kv_split::Dense", "decode_merge_kernel",
            "prefix_kernel<(anonymous namespace)::Dense",
            "decode_row_kernel<(anonymous namespace)::Dense")
K8_NAMES = ("kv_split::Paged", "decode_merge_kernel",
            "(anonymous namespace)::row_kernel<", "(anonymous namespace)::tile_kernel<")


def device_ms(torch, fn) -> tuple[float, dict]:
    """Run fn under the profiler; return (wall s, device ms by kernel name).
    The kernels' intervals, (name, start us, end us), are kept in
    ``by_name["__intervals__"]`` for :func:`busy`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = defaultdict(float)
    intervals = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            intervals.append((evt.name, evt.time_range.start, evt.time_range.end))
    by_name["__intervals__"] = intervals
    return wall, by_name


def busy(by_name: dict, names) -> float:
    """Device ms during which any kernel of ``names`` ran: the union of their
    intervals. Where a wrapper chains its kernels as programmatic dependents
    (a later one starts, and waits, while an earlier one runs), the sum of
    their durations counts the overlap twice; the union does not."""
    spans = sorted((s, e) for n, s, e in by_name["__intervals__"] if any(k in n for k in names))
    total, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def host_us_per_call(torch, fn) -> float:
    """Microseconds of host time per call, enqueue only."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
    torch.cuda.synchronize()
    return us


def wrapper_host_costs(torch, cfg) -> dict:
    """K3 and K4 at the panel's decode, K7 and K7-q8 on the same caches
    with a 1000-token prefix, K6 and K10 at w_gate, M = 64 (random data)."""
    from llm_consensus_tpu_torch.models.cache import quantize_kv
    from llm_consensus_tpu_torch.ops.kernels import attention as ka
    from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq
    from llm_consensus_tpu_torch.ops.quant import quantize_tensor, quantize_tensor4

    g = torch.Generator(device="cuda").manual_seed(0)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn(4, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
    (kq_, ks), (vq_, vs) = (quantize_kv(torch.randn(4, hkv, 2176, d, generator=g, device="cuda"))
                            for _ in range(2))
    kc, vc = (torch.randn(4, 2176, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    vl = torch.full((4,), 2100, dtype=torch.int32, device="cuda")
    x = torch.randn(64, cfg.d_model, generator=g, device="cuda").to(torch.bfloat16)
    w_gate = torch.randn(cfg.d_model, cfg.d_ff, generator=g, device="cuda") * 0.02
    w4, w8 = quantize_tensor4(w_gate, 0), quantize_tensor(w_gate, 0)
    return {
        "k3_host_us_per_call": host_us_per_call(
            torch, lambda: ka.flash_decode_attention(q, kc, vc, vl)),
        "k4_host_us_per_call": host_us_per_call(
            torch, lambda: ka.flash_decode_attention_q8(q, kq_, ks, vq_, vs, vl)),
        "k7_host_us_per_call": host_us_per_call(
            torch, lambda: ka.flash_decode_attention_shared_prefix(q, kc, vc, vl, 1000)),
        "k7q8_host_us_per_call": host_us_per_call(
            torch, lambda: ka.flash_decode_attention_shared_prefix_q8(
                q, kq_, ks, vq_, vs, vl, 1000)),
        "k6_host_us_per_call": host_us_per_call(
            torch, lambda: kq.quant_matmul_2d(x, w8.q, w8.scale)),
        "k10_host_us_per_call": host_us_per_call(
            torch, lambda: kq.quant4_matmul_2d(x, w4.q, w4.scale)),
    }


def by_kernel(by_name: dict, names) -> dict:
    """Device ms of each kernel of ``names`` (its name up to the template
    arguments)."""
    out: dict = defaultdict(float)
    for name, ms in by_name.items():
        if name != "__intervals__" and any(k in name for k in names):
            out[name.split("<")[0].split("::")[-1]] += ms
    return dict(out)


def summed(by_name: dict, names) -> float:
    return sum(ms for name, ms in by_name.items()
               if name != "__intervals__" and any(k in name for k in names))


def serving_leg(torch, cfg, chip_smoke, kernels) -> dict:
    """The 32-request burst on bf16 weights: wall and tokens/s after a
    warm-up burst, then K8's device ms per call from a profiled repeat."""
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.serving import ContinuousBatcher, ContinuousConfig

    params = init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    batcher = ContinuousBatcher(cfg, params,
                                config=ContinuousConfig(max_slots=chip_smoke.SERVE_SLOTS))
    burst = chip_smoke.serving_burst()

    def run():
        futs = [batcher.submit(p, **kw) for p, kw in burst]
        return sum(f.result(timeout=600).num_tokens for f in futs)

    try:
        run()  # warm-up: the kernel library, the batcher's programs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels.reset_launch_counts()
        _, by_name = device_ms(torch, run)
        k8 = kernels.ragged_paged_attention.launches
    finally:
        batcher.close()
    return {
        "requests": len(burst), "wall_s": wall, "generated_tokens": tokens,
        "generated_tokens_per_s": tokens / wall, "k8_launches": k8,
        "k8_device_ms_per_call": summed(by_name, K8_NAMES) / max(k8, 1),
        "k8_device_busy_ms_per_call": busy(by_name, K8_NAMES) / max(k8, 1),
        "k8_kernels_ms": by_kernel(by_name, K8_NAMES),
        "device_busy_ms": summed(by_name, ("",)),
    }


def child(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke
    from llm_consensus_tpu_torch.backends.local import LocalBackend
    from llm_consensus_tpu_torch.models.configs import get_config
    from llm_consensus_tpu_torch.ops import kernels

    cfg = get_config("llama-1b")
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}
    out["host"] = wrapper_host_costs(torch, cfg)

    engine = chip_smoke.build_engine(torch, cfg, NEW_TOKENS, quant="int4", kv_quant=True)
    prompts, temps = [chip_smoke.SC_PROMPT] * N, [0.7] * N

    def fan_out():
        engine.generate_texts(prompts, temperatures=temps, seed=0)

    fan_out()  # warm-up: the kernel library, cuBLAS handles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fan_out()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels.reset_launch_counts()
    _, by_name = device_ms(torch, fan_out)
    k10 = kernels.quant4_matmul_2d.launches
    k4 = kernels.flash_decode_attention_q8.launches
    k7q8 = kernels.flash_decode_attention_shared_prefix_q8.launches
    out["int4_fan_out"] = {
        "n": N, "new_tokens": NEW_TOKENS, "wall_s": wall, "wall_ms_per_step": wall * 1e3 / NEW_TOKENS,
        "k10_launches": k10, "k10_device_ms_per_call": summed(by_name, K10_NAMES) / max(k10, 1),
        "k4_launches": k4, "k7q8_launches": k7q8,
        "k7q8_device_ms_per_launch": summed(by_name, K7Q8_NAMES) / max(k7q8, 1),
        "k7q8_device_busy_ms_per_launch": busy(by_name, K7Q8_NAMES) / max(k7q8, 1),
        "device_busy_ms": summed(by_name, ("",)),
    }
    del engine
    torch.cuda.empty_cache()

    engine = chip_smoke.build_engine(torch, cfg, NEW_TOKENS, quant="int8", kv_quant=True)
    fan_out()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fan_out()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels.reset_launch_counts()
    _, by_name = device_ms(torch, fan_out)
    k6 = kernels.quant_matmul_2d.launches
    k7q8 = kernels.flash_decode_attention_shared_prefix_q8.launches
    out["int8_fan_out"] = {
        "n": N, "new_tokens": NEW_TOKENS, "wall_s": wall, "wall_ms_per_step": wall * 1e3 / NEW_TOKENS,
        "k6_launches": k6, "k6_device_ms_per_call": summed(by_name, K6_NAMES) / max(k6, 1),
        "k4_launches": kernels.flash_decode_attention_q8.launches, "k7q8_launches": k7q8,
        "k7q8_device_ms_per_launch": summed(by_name, K7Q8_NAMES) / max(k7q8, 1),
        "k7q8_device_busy_ms_per_launch": busy(by_name, K7Q8_NAMES) / max(k7q8, 1),
        "device_busy_ms": summed(by_name, ("",)),
    }
    del engine
    torch.cuda.empty_cache()

    engine = chip_smoke.build_engine(torch, cfg, NEW_TOKENS)
    fan_out()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fan_out()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels.reset_launch_counts()
    _, by_name = device_ms(torch, fan_out)
    k7 = kernels.flash_decode_attention_shared_prefix.launches
    out["bf16_fan_out"] = {
        "n": N, "new_tokens": NEW_TOKENS, "wall_s": wall, "wall_ms_per_step": wall * 1e3 / NEW_TOKENS,
        "k3_launches": kernels.flash_decode_attention.launches, "k7_launches": k7,
        "k7_device_ms_per_launch": summed(by_name, K7_NAMES) / max(k7, 1),
        "k7_device_busy_ms_per_launch": busy(by_name, K7_NAMES) / max(k7, 1),
        "k7_kernels_ms": by_kernel(by_name, K7_NAMES),
        "device_busy_ms": summed(by_name, ("",)),
    }
    del engine
    torch.cuda.empty_cache()

    out["serving_burst"] = serving_leg(torch, cfg, chip_smoke, kernels)

    for label, quant, kv_quant, wrapper, names in (
            ("int8_question", "int8", True, kernels.flash_decode_attention_q8, K4_NAMES),
            ("bf16_question", "none", False, kernels.flash_decode_attention, K3_NAMES)):
        engine = chip_smoke.build_engine(torch, cfg, quant=quant, kv_quant=kv_quant)
        engine.generate_texts(["warm-up"], max_new_tokens=4)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chip_smoke.run_consensus(LocalBackend(engine))
        torch.cuda.synchronize()
        question_s = time.perf_counter() - t0
        launches = wrapper.launches
        kernels.reset_launch_counts()
        _, by_name = device_ms(torch, lambda: chip_smoke.run_consensus(LocalBackend(engine)))
        key = "k4" if wrapper is kernels.flash_decode_attention_q8 else "k3"
        out[label] = {
            "seconds": question_s, f"{key}_launches": launches,
            f"{key}_device_ms_per_call": summed(by_name, names) / max(wrapper.launches, 1),
            f"profiled_{key}_launches": wrapper.launches,
            "profiled_k7_launches": kernels.flash_decode_attention_shared_prefix.launches,
            "profiled_k7q8_launches": kernels.flash_decode_attention_shared_prefix_q8.launches,
        }
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


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
