#!/usr/bin/env python3
"""K10's launch on the card: device ms of the wgmma kernel for every split
count (and the padded M, where the rule's differs from the power of two
above M), with bf16 ``x @ w`` (cuBLAS) beside and the rule's choice.

    python3 scripts/torch_k10_sweep.py

Random packed int4 weights and bf16 x from a fixed seed, at llama-1b's
projection shapes for the engine's and the serving path's M, and one M
between 128 and 256. Times with ``chip_smoke.Timer`` (CUDA events, L2
flushed, a spin kernel queued first). Calls the C entry point directly
with the launch under test, so a new rule for ``quant4_tile`` can be
read off one run. Prints one line per shape, then the card's name and
power limit. Needs a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = ((1, 2048, 2048), (16, 2048, 2048), (16, 2048, 5632), (64, 2048, 5632), (64, 2048, 2048),
          (64, 5632, 2048), (64, 2048, 32000), (80, 2048, 2048), (80, 2048, 5632),
          (128, 2048, 2048), (128, 5632, 2048), (256, 2048, 5632), (150, 2048, 2048))


def main() -> int:
    import torch

    import chip_smoke
    from llm_consensus_tpu_torch.ops.kernels import build
    from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    lib = build.load_library()
    timer = chip_smoke.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    for m, k, n in SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda", dtype=torch.int8)
        scale = torch.rand(1, n, generator=g, device="cuda")
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        w_lib = kq.unpack4(w, torch.bfloat16)
        rule = kq.quant4_tile(m, k, n)
        res = []
        for mp in sorted({rule["mp"], next(p for p in (8, 16, 32, 64, 128, 256) if p >= m)}):
            for splits in (1, 2, 4, 8):
                if (k // 2) % (64 * splits):
                    continue
                stages = max(3, min(8, 96 * 1024 // (64 * 128 + 2 * mp * 128)))  # quant4_tile's

                def call(mp=mp, splits=splits, stages=stages):
                    return lib.lct_quant4_matmul_wg(
                        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        m, k, n, 1, mp, splits, stages, stream)

                rc = call()
                res.append((mp, splits, "rc", rc) if rc else (mp, splits, round(timer.ms(call), 4)))
        lib_ms = timer.ms(lambda: x @ w_lib)
        print(f"m={m} k={k} n={n} rule=(mp {rule['mp']}, splits {rule['splits']}) "
              f"cublas_ms={lib_ms:.4f} (mp, splits, ms): {res}", flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
