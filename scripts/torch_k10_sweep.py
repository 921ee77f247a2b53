#!/usr/bin/env python3
"""Launch sweeps on the card. The wgmma launch of K10 (``int4`` weights) and
K6 (``int8``): device ms of the kernel for every split count (and the
padded M, where the rule's differs from the power of two above M), with
bf16 ``x @ w`` (cuBLAS) beside and the rule's choice. The split-KV grid of
K3 (``k3``, bf16 dense cache): device ms for each span, with
``scaled_dot_product_attention`` beside and the rule's choice. The split-KV
grid of K8's decode rows (``k8``, bf16 page pool of llama-1b's serving
shapes: page 64, 32 pages a table): device ms of the whole K8 call for
each span, with the rule's choice. The suffix's split-KV grid of K7 and
K7-q8 (``k7``, bf16 queries over the bf16 and the int8 cache): device ms
of the whole call for each span of the suffix, with the rule's choice.

    python3 scripts/torch_k10_sweep.py [int4|int8|k3|k8|k7 ...]

Random weights, caches and bf16 inputs from a fixed seed: the matmuls at
llama-1b's projection shapes for the engine's and the serving path's M,
and one M between 128 and 256; K3 at llama-1b's heads (16 / 8 / 128) on
the panel's decode (4 rows, 2176 slots), the reported case (8 rows, 384),
one row over 2176 and 64 rows over 256; K8 on 16 decode rows of lengths
70-1500 (``chip_smoke``'s case), on the serving burst's rows (16 rows of
300-556 slots in 4 groups sharing a 256-token run) and on one row of the
whole 2048-slot table; K7 and K7-q8 at the reported case (8 rows, a
384-slot cache, a 243-token prefix, 64 tokens into the answer) and the
N = 64 fan-out's (64 rows, 256 slots, prefix 115). All five unless named.
Times with
``chip_smoke.Timer`` (CUDA events, L2 flushed, a spin kernel queued
first). Calls the C entry points directly with the launch under test, so
a new rule for ``wgmma_tile``, ``decode_splits``, ``ragged_splits`` or
``suffix_splits`` can be read off one
run. Prints one line per (kind, shape), then the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

K3_CASES = ((4, 2176, (2049, 2176, 2100, 2150)), (8, 384, None), (1, 2176, (2100,)), (64, 256, None))
SHAPES = ((1, 2048, 2048), (16, 2048, 2048), (16, 2048, 5632), (64, 2048, 5632), (64, 2048, 2048),
          (64, 5632, 2048), (64, 2048, 32000), (80, 2048, 2048), (80, 2048, 5632),
          (128, 2048, 2048), (128, 5632, 2048), (256, 2048, 5632), (150, 2048, 2048))


def k3_sweep(torch, chip_smoke, lib, timer, g, stream) -> None:
    from llm_consensus_tpu_torch.ops.kernels import attention as ka

    h, hkv, d = 16, 8, 128
    for b, s, valid in K3_CASES:
        q, kc, vc = (torch.randn(b, n, hd, d, generator=g, device="cuda").to(torch.bfloat16)
                     for n, hd in ((1, h), (s, hkv), (s, hkv)))
        vl = (torch.tensor(valid, dtype=torch.int32, device="cuda") if valid else
              torch.randint(s // 2, s + 1, (b,), generator=g, device="cuda", dtype=torch.int32))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
        mask = (torch.arange(s, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
        sdpa = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        rule = ka.decode_splits(b, hkv, s, ka.decode_blocks_per_sm(2, d, h // hkv))
        out = torch.empty_like(q)
        res = []
        for span in sorted({rule[1], 128, 160, 192, 224, 256, 288, 320, 384, 448, 544, 768}):
            n = -(-s // span)
            if (n - 1) * span >= s:
                continue
            ws = torch.empty(max(1, ka.decode_workspace(b, h, d, n)), device="cuda")

            def call(n=n, span=span, ws=ws):
                return lib.lct_decode_attention(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                                vl.data_ptr(), out.data_ptr(), ws.data_ptr(), b, s,
                                                h, hkv, d, n, span, d ** -0.5, 1, stream)

            rc = call()
            res.append((n, span, "rc", rc) if rc else (n, span, round(timer.ms(call), 4)))
        print(f"k3 b={b} s_max={s} rule=(n_split {rule[0]}, span {rule[1]}) sdpa_ms={sdpa:.4f} "
              f"(n_split, span, ms): {res}", flush=True)


def k8_sweep(torch, lib, timer, g, stream) -> None:
    from llm_consensus_tpu_torch.ops.kernels import ragged_attention as kr

    h, hkv, d, pg, p_per = 16, 8, 128, 64, 32
    slots = pg * p_per
    for label, b, lo, hi, groups in (("16 rows 70-1500", 16, 70, 1500, 0),
                                     ("burst: 16 rows 300-556, 4 groups", 16, 300, 556, 4),
                                     ("one row of 2048", 1, slots, slots, 0)):
        n_pages = 1 + b * p_per
        kp, vp = (torch.randn(n_pages, pg, hkv, d, generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        tbl = (1 + torch.randperm(b * p_per, generator=g, device="cuda")).int().reshape(b, p_per)
        vl = torch.randint(lo, hi + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
        q = torch.randn(b, h, d, generator=g, device="cuda").to(torch.bfloat16)
        gid = rep = gend = sst = None
        if groups:
            per, run = b // groups, 256
            for gi in range(groups):
                tbl[gi * per:(gi + 1) * per, :run // pg] = tbl[gi * per, :run // pg]
            gid = (torch.arange(b, device="cuda") // per).int()
            rep = (torch.arange(groups, device="cuda") * per).int()
            gend = torch.full((groups,), run, dtype=torch.int32, device="cuda")
            sst = torch.full((b,), run, dtype=torch.int32, device="cuda")
        rule = kr.ragged_splits(slots)
        out = torch.empty_like(q)
        res = []
        for span in sorted({rule[1], 128, 256, 384, 512, 704, 1024, 2048}):
            n = -(-slots // span)
            if (n - 1) * span >= slots:
                continue
            ws = torch.empty(max(1, kr.ragged_workspace(b, 1, h, d, slots, bool(groups), n)),
                             device="cuda")

            def ptr(t):
                return None if t is None else t.data_ptr()

            def call(n=n, span=span, ws=ws):
                return lib.lct_ragged_paged_attention(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tbl.data_ptr(), vl.data_ptr(),
                    None, None, ptr(gid), ptr(rep), ptr(gend), ptr(sst), out.data_ptr(), None,
                    ws.data_ptr(), b, 1, h, hkv, d, pg, p_per, 0, 0, groups, 0, n, span,
                    d ** -0.5, 1, 1, stream)

            rc = call()
            res.append((n, span, "rc", rc) if rc else (n, span, round(timer.ms(call), 4)))
        print(f"k8 {label}: rule=(n_split {rule[0]}, span {rule[1]}) (n_split, span, ms): {res}",
              flush=True)


def k7_sweep(torch, lib, timer, g, stream) -> None:
    from llm_consensus_tpu_torch.models.cache import quantize_kv
    from llm_consensus_tpu_torch.ops.kernels import attention as ka

    h, hkv, d = 16, 8, 128
    for b, s, plen in ((8, 384, 243), (64, 256, 115)):
        q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
        vl = torch.full((b,), plen + 64, dtype=torch.int32, device="cuda")
        dense = [torch.randn(b, s, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
                 for _ in range(2)]
        q8 = [t for _ in range(2)
              for t in quantize_kv(torch.randn(b, hkv, s, d, generator=g, device="cuda"))]
        n_pre, pre_span = ka.prefix_splits(b, h, hkv, plen)
        out = torch.empty_like(q)
        for kind, entry, cache, elem in (
                ("k7", lib.lct_shared_prefix_attention, dense, 2),
                ("k7q8", lib.lct_shared_prefix_attention_q8, q8, 1)):
            rule = ka.suffix_splits(b, hkv, s - plen, ka.decode_blocks_per_sm(elem, d, h // hkv))
            res = []
            for span in sorted({rule[1], 128, 160, 192, 256}):
                n = -(-(s - plen) // span)
                if (n - 1) * span >= s - plen:
                    continue
                ws = torch.empty(ka.shared_prefix_workspace(b, h, d, n_pre, n), device="cuda")

                def call(n=n, span=span, ws=ws, entry=entry, cache=cache):
                    return entry(q.data_ptr(), *(t.data_ptr() for t in cache), vl.data_ptr(),
                                 out.data_ptr(), ws.data_ptr(), b, s, h, hkv, d, plen, n_pre,
                                 pre_span, n, span, d ** -0.5, 1, stream)

                rc = call()
                res.append((n, span, "rc", rc) if rc else (n, span, round(timer.ms(call), 4)))
            print(f"{kind} b={b} s_max={s} prefix={plen} rule=(n_split {rule[0]}, span "
                  f"{rule[1]}) (n_split, span, ms): {res}", flush=True)


def main() -> int:
    import torch

    import chip_smoke
    from llm_consensus_tpu_torch.ops.kernels import build
    from llm_consensus_tpu_torch.ops.kernels import quant_matmul as kq

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    kinds = sys.argv[1:] or ["int4", "int8", "k3", "k8", "k7"]
    lib = build.load_library()
    timer = chip_smoke.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    if "k3" in kinds:
        k3_sweep(torch, chip_smoke, lib, timer, g, stream)
    if "k8" in kinds:
        k8_sweep(torch, lib, timer, g, stream)
    if "k7" in kinds:
        k7_sweep(torch, lib, timer, g, stream)
    for fmt in (k for k in kinds if k not in ("k3", "k8", "k7")):
        packed = fmt == "int4"
        entry = lib.lct_quant4_matmul_wg if packed else lib.lct_quant_matmul_wg
        for m, k, n in SHAPES:
            x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            rows = k // 2 if packed else k
            w = torch.randint(-128, 128, (rows, n), generator=g, device="cuda", dtype=torch.int8)
            scale = torch.rand(1, n, generator=g, device="cuda")
            out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            w_lib = kq.unpack4(w, torch.bfloat16) if packed else w.to(torch.bfloat16)
            rule = kq.wgmma_tile(m, k, n, packed)
            res = []
            for mp in sorted({rule["mp"], next(p for p in (8, 16, 32, 64, 128, 256) if p >= m)}):
                stages = kq.wgmma_tile(mp, k, n, packed)["stages"]  # the rule's depth at mp
                for splits in (1, 2, 4, 8):
                    if (k // 128) % splits:
                        continue

                    def call(mp=mp, splits=splits, stages=stages):
                        return entry(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                     m, k, n, 1, mp, splits, stages, stream)

                    rc = call()
                    res.append((mp, splits, "rc", rc) if rc else
                               (mp, splits, round(timer.ms(call), 4)))
            lib_ms = timer.ms(lambda: x @ w_lib)
            print(f"{fmt} m={m} k={k} n={n} rule=(mp {rule['mp']}, splits {rule['splits']}) "
                  f"cublas_ms={lib_ms:.4f} (mp, splits, ms): {res}", flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
