"""K6, the W8A16 matmul, and K10, the W4A16 matmul: the wrappers of
``csrc/quant_matmul.cu`` and their twins.

Replaces ``llm_consensus_tpu/ops/pallas/quant_matmul.py``'s
``quant_matmul_2d`` (``_qmm_kernel``) and ``quant_matmul_stacked``
(``_qmm_stacked_kernel``): ``x [M, K] @ int8 w_q [K, N]``, accumulated in
float32, times the per-column ``scale [1, N]``, cast to ``out_dtype``. The
stacked form exists in the JAX package because a Pallas operand must be a
whole buffer; here ``w_q[layer]`` is a zero-copy view, so it is the same
kernel on that view. The source note of ``csrc/quant_matmul.cu`` says what
bounds it on the card and what its design does about that.

``x`` may be bfloat16 or float32. For bf16 the kernel computes what
``_qmm_kernel`` computes, on the tensor cores (``mma.sync``), with K cut
into parts when the product has too few column tiles to fill the card
(:func:`tensor_core_splits`). Pallas casts every ``x`` to bf16 first; a
float32 ``x`` stays float32 here, on the CUDA cores, which is what the
JAX package computes wherever its kernel is off (every CPU run included).

K10 replaces ``quant_matmul.py``'s ``quant4_matmul_2d`` (``_q4mm_kernel``):
``x [M, K]`` times the packed int4 ``w_q [K/2, N]`` (int8 bytes; the low
nibble holds logical row ``r``, the high nibble row ``r + K/2``, both
sign-extended), the same float32 sums, scale and cast. It is built like
K6 (tensor cores for bf16 ``x``, CUDA cores for float32 ``x``) and takes
every product that :func:`quant4_matmul_supported` accepts.
"""

from __future__ import annotations

import torch

from llm_consensus_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_N = 32  # csrc/quant_matmul.cu: kTileN (and kTcBN)
_TC_BK = 128  # csrc/quant_matmul.cu: kTcBK
_MIN_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs
_MAX_SPLITS = 16

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


def tensor_core_splits(m: int, k: int, n: int) -> int:
    """How many parts the tensor-core kernel cuts K into: doubled while
    the grid holds fewer than two blocks per SM and each part stays a
    whole number of 128-row chunks (decode's narrow products would
    otherwise leave most SMs idle). ``k`` is the logical contraction dim
    for K10 too, whose chunk is 64 packed rows (128 logical rows)."""
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    blocks = -(-m // bm) * (n // _TILE_N)
    chunks = k // _TC_BK
    splits = 1
    while blocks * splits < _MIN_BLOCKS and chunks % (2 * splits) == 0 and splits < _MAX_SPLITS:
        splits *= 2
    return splits


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
    # bf16 x takes the tensor-core kernel (K in whole 128-row chunks, x
    # 16-byte aligned for its vector loads); float32 x the CUDA-core one.
    splits = 0
    ws = None
    if x.dtype == torch.bfloat16 and k % _TC_BK == 0 and x.data_ptr() % 16 == 0:
        splits = tensor_core_splits(m, k, n)
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    entry = lib.lct_quant4_matmul if packed else lib.lct_quant_matmul
    rc = entry(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(),
        m, k, n, _DTYPES[x.dtype], _DTYPES[out_dtype], splits,
        torch.cuda.current_stream(x.device).cuda_stream,
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
