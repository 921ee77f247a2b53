#!/usr/bin/env python3
"""K10 and K6 device time in turns between source trees, at fixed shapes.

    python3 scripts/torch_matmul_turns.py TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` is the current one; a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists works too). For each tree, in the order given, a fresh
process puts that tree first on ``sys.path``, builds its kernels and times
the K10 and K6 wrappers (``chip_smoke.Timer``: CUDA events, L2 flushed, a
spin kernel queued first) on random bf16 x and random int8 / packed int4
weight bytes from a fixed seed at ``SHAPES``: llama-1b's w_gate at M = 64
and 16 and its lm_head at M = 64, llama3-8b's lm_head at M = 64. For the
tree ``.`` it also holds K6 against its twin over the engine's and the
serving path's M at llama-1b's projections, both x types, and launches it
twice (the same bits). Prints one line per tree, then the card's name and
power limit. Give two trees as A B B A to compare them in one call. Needs
a CUDA card.
"""
import subprocess
import sys
from pathlib import Path

SHAPES = ((64, 2048, 5632, None, "llama-1b"), (64, 2048, 32000, "float32", "llama-1b"),
          (64, 4096, 128256, "float32", "llama3-8b"), (16, 2048, 5632, None, "llama-1b"))


def child(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke
    from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq
    from llm_consensus_tpu_torch.ops.quant import quantize_tensor

    timer = chip_smoke.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(5)
    res = []
    for m, k, n, out, model in SHAPES:
        od = getattr(torch, out) if out else None
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w4 = torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda", dtype=torch.int8)
        w8 = torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
        sc = torch.rand(1, n, generator=g, device="cuda") * 0.001
        k10 = timer.ms(lambda: kq.quant4_matmul_2d(x, w4, sc, od))
        k6 = timer.ms(lambda: kq.quant_matmul_2d(x, w8, sc, od))
        res.append(f"{model} x[{m},{k}] n={n}: k10={k10:.4f} k6={k6:.4f}")
    print(tree, "; ".join(res), flush=True)
    if tree != ".":
        return
    fails = 0
    for dtype in (torch.bfloat16, torch.float32):
        for m in (1, 4, 16, 64, 80, 128, 150, 256):
            for k, n, out in ((2048, 2048, None), (2048, 512, None), (2048, 5632, None),
                              (5632, 2048, None), (2048, 32000, "float32"), (256, 384, None)):
                if dtype == torch.float32 and m not in (1, 64):
                    continue
                od = getattr(torch, out) if out else None
                x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
                w = quantize_tensor(torch.randn(k, n, generator=g, device="cuda") * 0.02, 0)
                got = kq.quant_matmul_2d(x, w.q, w.scale, od)
                err, ratio = chip_smoke.compare(od or dtype, got, kq.quant_matmul_2d_plain(x, w.q, w.scale, od))
                bit = bool(torch.equal(got, kq.quant_matmul_2d(x, w.q, w.scale, od)))
                if ratio > 1 or not bit:
                    fails += 1
                    print(f"FAIL K6 {dtype} m{m} k{k} n{n} {out} ratio={ratio:.3f} bitwise={bit}")
    print(f"K6 correctness fails: {fails}", flush=True)


if len(sys.argv) > 2 and sys.argv[1] == "--child":
    child(sys.argv[2])
else:
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--child", tree], check=True)
    sys.path.insert(0, ".")
    import chip_smoke
    print(chip_smoke.nvidia_smi_line())
