#!/usr/bin/env python3
"""Decode attention device time in turns between source trees, at fixed
shapes: K7, K7-q8, K8 (and K3 and K4 beside them).

    python3 scripts/torch_attention_turns.py TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` is the current one; a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists works too). For each tree, in the order given, a fresh
process puts that tree first on ``sys.path``, builds its kernels and times
the wrappers (``chip_smoke.Timer``: CUDA events, L2 flushed, a spin kernel
queued first) on bf16 inputs made from a fixed seed, at llama-1b's heads
(16 / 8 / 128):

- K7 and K7-q8 (and K3 and K4 on the same cache) at ``chip_smoke``'s
  reported case (8 rows, a 384-slot cache, a 243-token prefix, 64 tokens
  into the answer) and at the N = 64 fan-out's (64 rows, 256 slots, prefix
  115);
- K8 on the page pool of the serving path (page 64, 32 pages a table):
  ``chip_smoke``'s reported fused case (8 decode rows in 2 groups sharing a
  256-token run, a 64-token chunk at 256), its 16 decode rows of lengths
  70-1500, the serving burst's rows (16 rows of 300-556 slots in 4 groups
  sharing a 256-token run), and one data shard of K9's mesh (8 rows, 8
  heads over 4 kv heads, a 64-token chunk, 2 groups).

Prints one JSON line per tree, then the card's name and power limit. Give
two trees as A B B A to compare them in one call. Needs a CUDA card.
"""
import json
import subprocess
import sys
from pathlib import Path

H, HKV, D, PG, P = 16, 8, 128, 64, 32


def k8_inputs(torch, g, b, lo, hi, groups, chunk, heads=(H, HKV)):
    """A bf16 pool, tables, lengths, q and K8's keyword arguments."""
    h, hkv = heads
    n_pages = 1 + b * P + P
    kp, vp = (torch.randn(n_pages, PG, hkv, D, generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    perm = (1 + torch.randperm(n_pages - 1, generator=g, device="cuda")).int()
    tbl = perm[:b * P].reshape(b, P).contiguous()
    ctbl = perm[b * P:b * P + P].contiguous()
    vl = torch.randint(lo, hi + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
    q = torch.randn(b, h, D, generator=g, device="cuda").to(torch.bfloat16)
    kw = {}
    if groups:
        per, run = b // groups, 256
        for gi in range(groups):
            tbl[gi * per:(gi + 1) * per, :run // PG] = tbl[gi * per, :run // PG]
        vl = torch.clamp(vl, min=run + 1)
        kw["groups"] = ((torch.arange(b, device="cuda") // per).int(),
                        (torch.arange(groups, device="cuda") * per).int(),
                        torch.full((groups,), run, dtype=torch.int32, device="cuda"),
                        torch.full((b,), run, dtype=torch.int32, device="cuda"))
    if chunk:
        kw.update(q_chunk=torch.randn(chunk, h, D, generator=g, device="cuda").to(torch.bfloat16),
                  chunk_table=ctbl, chunk_start=256)
    return (q, kp, vp, tbl, vl), kw


def child(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke
    from llm_consensus_tpu_torch.models.cache import quantize_kv
    from llm_consensus_tpu_torch.ops.kernels import attention as ka
    from llm_consensus_tpu_torch.ops.kernels import ragged_attention as kr

    timer = chip_smoke.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {"tree": tree}
    for label, b, s, plen in (("reported", 8, 384, 243), ("fan_out_64", 64, 256, 115)):
        q = torch.randn(b, 1, H, D, generator=g, device="cuda").to(torch.bfloat16)
        kc, vc = (torch.randn(b, s, HKV, D, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        kc[:, :plen], vc[:, :plen] = kc[:1, :plen].clone(), vc[:1, :plen].clone()
        x = [torch.randn(b, HKV, s, D, generator=g, device="cuda") for _ in range(2)]
        for t in x:
            t[:, :, :plen] = t[:1, :, :plen].clone()
        (kq_, ks), (vq_, vs) = (quantize_kv(t) for t in x)
        vl = torch.full((b,), plen + 64, dtype=torch.int32, device="cuda")
        out[f"k7_{label}"] = timer.ms(
            lambda: ka.flash_decode_attention_shared_prefix(q, kc, vc, vl, plen))
        out[f"k3_{label}"] = timer.ms(lambda: ka.flash_decode_attention(q, kc, vc, vl))
        out[f"k7q8_{label}"] = timer.ms(
            lambda: ka.flash_decode_attention_shared_prefix_q8(q, kq_, ks, vq_, vs, vl, plen))
        out[f"k4_{label}"] = timer.ms(
            lambda: ka.flash_decode_attention_q8(q, kq_, ks, vq_, vs, vl))
    for label, b, lo, hi, groups, chunk, heads in (
            ("k8_fused_reported", 8, 70, 1500, 2, 64, (H, HKV)),
            ("k8_16_decode_rows", 16, 70, 1500, 0, 0, (H, HKV)),
            ("k8_burst_rows", 16, 300, 556, 4, 0, (H, HKV)),
            ("k8_k9_shard", 8, 70, 1500, 2, 64, (H // 2, HKV // 2))):
        args, kw = k8_inputs(torch, g, b, lo, hi, groups, chunk, heads)
        out[label] = timer.ms(lambda: kr.ragged_paged_attention(*args, **kw))
    print(json.dumps(out), flush=True)


if len(sys.argv) > 2 and sys.argv[1] == "--child":
    child(sys.argv[2])
else:
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--child", tree], check=True)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    print(chip_smoke.nvidia_smi_line())
