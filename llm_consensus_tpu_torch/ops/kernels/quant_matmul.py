"""K6, the W8A16 matmul, and K10, the W4A16 matmul: the wrappers of
``csrc/quant_matmul.cu`` and ``csrc/quant4_matmul.cu`` and their twins.

Replaces ``llm_consensus_tpu/ops/pallas/quant_matmul.py``'s
``quant_matmul_2d`` (``_qmm_kernel``) and ``quant_matmul_stacked``
(``_qmm_stacked_kernel``): ``x [M, K] @ int8 w_q [K, N]``, accumulated in
float32, times the per-column ``scale [1, N]``, cast to ``out_dtype``. The
stacked form exists in the JAX package because a Pallas operand must be a
whole buffer; here ``w_q[layer]`` is a zero-copy view, so it is the same
kernel on that view. The source note of ``csrc/quant_matmul.cu`` says what
bounds it on the card and what its design does about that.

``x`` may be bfloat16 or float32. For bf16 the kernel computes what
``_qmm_kernel`` computes, on the tensor cores: the wgmma kernel of
``csrc/quant_wgmma.cuh`` (its launch from :func:`wgmma_tile`; split-K
reduced inside a thread-block cluster, no workspace). Pallas casts every
``x`` to bf16 first; a float32 ``x`` stays float32 here, on the CUDA
cores, which is what the JAX package computes wherever its kernel is off
(every CPU run included).

K10 replaces ``quant_matmul.py``'s ``quant4_matmul_2d`` (``_q4mm_kernel``):
``x [M, K]`` times the packed int4 ``w_q [K/2, N]`` (int8 bytes; the low
nibble holds logical row ``r``, the high nibble row ``r + K/2``, both
sign-extended), the same float32 sums, scale and cast. bf16 ``x`` takes
the same wgmma kernel on the packed format, float32 ``x`` the CUDA-core
form of ``csrc/quant_matmul.cu``. Each takes every product that its shape
rule (:func:`quant_matmul_supported`, :func:`quant4_matmul_supported`)
accepts with bf16 ``x``; a bf16 ``x`` that is not 16-byte aligned takes
the CUDA-core form.
"""

from __future__ import annotations

import functools

import torch

from llm_consensus_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_N = 32  # csrc/quant_matmul.cu: kTileN, the CUDA-core forms' columns a block
_SMS = 132  # the H100's SMs

# The JAX package's shape rule (ops/pallas/quant_matmul.py), kept as it is
# so that both packages send the same products to the kernel: small M (the
# decode / GEMV regime), K and N multiples of 128.
_MAX_M = 256
_MAX_X_BYTES = 4 * 1024 * 1024
_MAX_W_TILE_BYTES = 4 * 1024 * 1024


def _pick_block(n: int, target: int = 512, align: int = 128) -> int | None:
    """Largest divisor of n that is a multiple of ``align`` and <= target."""
    best = None
    blk = align
    while blk <= min(n, target):
        if n % blk == 0:
            best = blk
        blk += align
    return best


def _blk_target(k: int) -> int:
    by_vmem = (_MAX_W_TILE_BYTES // max(k, 1)) // 128 * 128
    return max(128, min(512, by_vmem))


def _blk4_target(k: int) -> int:
    """blk_n budget for int4: the unpacked bf16 tile (K x blk_n x 2B) is
    4x the packed bytes, so budget against THAT."""
    by_vmem = (_MAX_W_TILE_BYTES // max(2 * k, 1)) // 128 * 128
    return max(128, min(512, by_vmem))


def quant_matmul_supported(m: int, k: int, n: int) -> bool:
    """Whether ``ops.quant.matmul`` sends an ``[m, k] @ [k, n]`` product
    to the kernel (else it dequantizes and calls ``torch.matmul``)."""
    return (
        m <= _MAX_M
        and m * k * 2 <= _MAX_X_BYTES
        and n % 128 == 0
        and k % 128 == 0
        and k * 128 <= _MAX_W_TILE_BYTES
        and _pick_block(n, target=_blk_target(k)) is not None
    )


def quant4_matmul_supported(m: int, k: int, n: int) -> bool:
    """Whether ``ops.quant.matmul`` sends an ``[m, k] @ [k, n]`` product
    with packed int4 weights (``k`` the logical contraction dim) to K10."""
    return (
        m <= _MAX_M
        and m * k * 2 <= _MAX_X_BYTES
        and k % 2 == 0
        and n % 128 == 0
        and (k // 2) % 8 == 0  # packed sublane tiling
        and k % 128 == 0
        and 2 * k * 128 <= _MAX_W_TILE_BYTES  # smallest unpacked tile
        and _pick_block(n, target=_blk4_target(k)) is not None
    )


# csrc/quant_wgmma.cuh, the wgmma form of K6 and K10 for bf16 x.
_WG_MPS = (8, 16, 32, 64, 96, 128, 192, 256)  # x's rows padded to wgmma's N
_WG_BOX_ROWS = 64  # kRows: rows of a w box (64 x 128 bytes)
_WG_STAGE_K = 128  # logical rows of K a stage: one int4 box, two int8 boxes
_WG_BN = 128  # kBN: columns a block
_WG_MAX_CLUSTER = 8  # the portable cluster size
_WG_MAX_STAGES = 8  # kMaxStages
_WG_RING_TARGET = 96 * 1024  # bytes of ring the stage count aims at: two blocks an SM
_WG_WIDE_BLOCKS = 64  # the grid's block target above mp = 32
_MAX_BLOCK_SMEM = 232448  # the H100's dynamic shared memory a block: 227 KB


def _wg_stage_bytes(mp: int, packed: bool) -> int:
    """A stage: its 64-row x 128-column boxes of w (one of packed int4
    rows, two of int8 rows) and the two x boxes they meet (mp rows x 128
    bytes each)."""
    return (1 if packed else 2) * _WG_BOX_ROWS * _WG_BN + 2 * mp * 128


def wgmma_smem_bytes(mp: int, stages: int, packed: bool) -> int:
    """csrc/quant_wgmma.cuh's smem_bytes: the ring, which the float32
    partial tile [mp, 128 + 8] reuses at the end, then 16 barriers."""
    ring = stages * _wg_stage_bytes(mp, packed)
    return max(ring, mp * (_WG_BN + 8) * 4) + 2 * _WG_MAX_STAGES * 8


@functools.lru_cache(maxsize=None)
def wgmma_tile(m: int, k: int, n: int, packed: bool) -> dict:
    """The launch of the wgmma form (bf16 x) of K10 (``packed``: ``x [m, k]
    @ w [k/2, n]``) or K6 (``x [m, k] @ w [k, n]``), ``k`` the logical
    contraction dim.

    - ``mp``: x's rows padded to wgmma's N (8, 16, 32, 64, 96, 128, 192
      or 256);
    - ``splits``: K cut into that many parts of whole 128-row stages, one
      block each, forming one thread-block cluster per 128-column tile (at
      most 8); the cluster adds the parts inside the launch. Doubled while
      the grid has fewer blocks than the H100's 132 SMs at mp <= 32, where
      a block's products are small and more blocks keep more bytes in
      flight; above, fewer than 64 blocks: each part's partial tile (mp x
      128 floats) crosses distributed shared memory, and on the H100 64
      blocks timed faster there than 128 or more (PERF.md §6);
    - ``stages``: the ring's depth (3-8, about 96 KB of ring; 2 where
      three would pass the block's 227 KB);
    - ``smem``: dynamic shared memory a block; ``grid``: (splits, n / 128).
    """
    if m < 1 or m > _WG_MPS[-1] or n % _WG_BN or k % _WG_STAGE_K:
        w = f"[{k // 2}, {n}] (packed)" if packed else f"[{k}, {n}]"
        raise ValueError(f"no wgmma tile for x [{m}, {k}] @ w {w}")
    mp = next(p for p in _WG_MPS if p >= m)
    stages_k, tiles = k // _WG_STAGE_K, n // _WG_BN
    target = _SMS if mp <= 32 else _WG_WIDE_BLOCKS
    splits = 1
    while (tiles * splits < target and splits < _WG_MAX_CLUSTER
           and stages_k % (2 * splits) == 0):
        splits *= 2
    stages = max(3, min(_WG_MAX_STAGES, _WG_RING_TARGET // _wg_stage_bytes(mp, packed)))
    while stages > 2 and wgmma_smem_bytes(mp, stages, packed) > _MAX_BLOCK_SMEM:
        stages -= 1  # int8 at mp = 256: three 80 KB stages would pass the block's limit
    return dict(mp=mp, splits=splits, stages=stages, stages_per_block=stages_k // splits,
                smem=wgmma_smem_bytes(mp, stages, packed), grid=(splits, tiles))


def quant_matmul_2d_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The plain PyTorch twin: the Pallas body's arithmetic,
    ``(x @ float(w_q)) * scale`` in float32, cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    return ((x.float() @ w_q.float()) * scale.float()).to(out_dtype)


def _launch(name: str, x, w_q, scale, out_dtype, packed: bool) -> torch.Tensor:
    """Check K6's or K10's operands (``packed``: K10, ``w_q`` holds K / 2
    rows of nibble pairs), allocate, launch. Raises on anything the kernel
    does not take."""
    m, k = x.shape
    n = w_q.shape[-1]
    rows = k // 2 if packed else k
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(
            f"{name} takes float32 or bfloat16 x and out, got {x.dtype} -> {out_dtype}"
        )
    if (
        w_q.dtype != torch.int8
        or scale.dtype != torch.float32
        or w_q.shape != (rows, n)
        or (packed and k % 2)
        or scale.shape != (1, n)
        or n % _TILE_N
    ):
        want = "[K/2, N] (K even)" if packed else "[K, N]"
        raise ValueError(
            f"{name} needs int8 w_q {want} and float32 scale [1, N] with N a "
            f"multiple of {_TILE_N}; got x {tuple(x.shape)}, w_q {w_q.dtype} "
            f"{tuple(w_q.shape)}, scale {scale.dtype} {tuple(scale.shape)}"
        )
    for t in (x, w_q, scale):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on the card")
    lib = build.load_library()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if (x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0 and m <= _MAX_M
            and k % _WG_STAGE_K == 0 and n % _WG_BN == 0):
        # The wgmma form; its TMA tensor maps need w (and x) 16-byte aligned.
        if w_q.data_ptr() % 16:
            raise ValueError(f"{name} needs w_q 16-byte aligned")
        t = wgmma_tile(m, k, n, packed)
        entry = lib.lct_quant4_matmul_wg if packed else lib.lct_quant_matmul_wg
        rc = entry(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, _DTYPES[out_dtype], t["mp"], t["splits"], t["stages"], stream,
        )
    else:  # float32 x (or a bf16 x the wgmma form does not take): the CUDA cores
        entry = lib.lct_quant4_matmul if packed else lib.lct_quant_matmul
        rc = entry(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, _DTYPES[x.dtype], _DTYPES[out_dtype], stream,
        )
    build.check(rc, name)
    return out


def quant_matmul_2d(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x [M, K]`` times int8 ``w_q [K, N]`` with per-column ``scale
    [1, N]`` (float32) -> ``[M, N]`` in ``out_dtype`` (default x's).

    CPU tensors take the plain twin; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return quant_matmul_2d_plain(x, w_q, scale, out_dtype)
    out = _launch("quant_matmul_2d", x, w_q, scale, out_dtype, packed=False)
    quant_matmul_2d.launches += 1
    return out


quant_matmul_2d.launches = 0


def quant_matmul_stacked(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    layer: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x [M, K]`` times layer ``layer`` of the stacked int8 ``w_q
    [L, K, N]`` (``scale [L, 1, N]``): :func:`quant_matmul_2d` on the
    zero-copy ``[layer]`` views."""
    return quant_matmul_2d(x, w_q[layer], scale[layer], out_dtype)


def unpack4(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Nibbles -> values in [-8, 7] in ``dtype``, the logical contraction
    dim (axis -2) restored: rows [0, K/2) from the low nibbles, [K/2, K)
    from the high ones (the JAX package's ``ops.quant.unpack4``)."""
    w32 = packed.to(torch.int32)
    low = (w32 & 0xF) - ((w32 & 0x8) << 1)
    nib = (w32 >> 4) & 0xF
    high = nib - ((nib & 0x8) << 1)
    return torch.cat([low, high], dim=-2).to(dtype)


def quant4_matmul_2d_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K10's plain twin: the Pallas body's arithmetic, ``(x @
    unpack4(w_q)) * scale`` in float32 (the scale after the sum), cast to
    ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    return ((x.float() @ unpack4(w_q, torch.float32)) * scale.float()).to(out_dtype)


def quant4_matmul_2d(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x [M, K]`` times packed int4 ``w_q [K/2, N]`` with per-column
    ``scale [1, N]`` (float32) -> ``[M, N]`` in ``out_dtype`` (default
    x's).

    CPU tensors take the plain twin; CUDA tensors launch K10, and anything
    it does not take raises (it takes every shape the rule accepts).
    """
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return quant4_matmul_2d_plain(x, w_q, scale, out_dtype)
    out = _launch("quant4_matmul_2d", x, w_q, scale, out_dtype, packed=True)
    quant4_matmul_2d.launches += 1
    return out


quant4_matmul_2d.launches = 0
