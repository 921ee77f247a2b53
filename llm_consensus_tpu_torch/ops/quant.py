"""Weight-only int8 and int4 quantization (per-output-channel, symmetric).

Counterpart of ``llm_consensus_tpu.ops.quant``. Decode is bound by the
bytes it reads, and every generated token re-reads every weight, so int8
weights halve that floor and packed int4 weights halve it again. Each
large matmul weight is stored as an int8 tensor (two nibbles a byte for
int4) beside a float32 scale per output channel; the same rounding as the
JAX package (amax / 127 or amax / 7, round half to even, clip to ±127 or
[-8, 7]) gives the same bits.

:func:`matmul` routes as the JAX package does: an int8 leaf goes through
the hand-written W8A16 kernel (K6, :mod:`.kernels.quant_matmul`) whenever
``quant_matmul_supported(m, k, n)`` holds (the decode regime, M <= 256),
and is otherwise dequantized into ``x``'s type and multiplied by
``torch.matmul``, a large product (a long prefill) that the JAX package
also leaves outside any kernel. The choice is made from shapes before
anything launches. A packed int4 leaf goes the same way through the
W4A16 kernel (K10) under ``quant4_matmul_supported``.

On a dp x mp mesh each rank holds its Megatron shard of every leaf
(:func:`~llm_consensus_tpu_torch.parallel.partitioning.shard_params`), so
:func:`matmul` sees and routes the LOCAL shapes (llama-1b at model=2: wq
N 1024, wk/wv 512, wo K 1024, w_gate/w_up N 2816, w_down K 2816, lm_head
N 16000, all multiples of 128). The JAX package runs its int8 products
through a dequantized ``jnp`` product on a mesh, because a ``pallas_call``
is opaque to GSPMD; here each rank's product is a single-device product
of the same function, so K6 runs it.

The JAX package's ``StackedQuant`` is not needed: it exists because a
Pallas operand must be a whole buffer, while here the layer loop passes
``w.q[l]`` and ``w.scale[l]``, zero-copy views, straight to the kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from llm_consensus_tpu_torch.ops.kernels.quant_matmul import (
    quant4_matmul_2d,
    quant4_matmul_2d_plain,
    quant4_matmul_supported,
    quant_matmul_2d,
    quant_matmul_2d_plain,
    quant_matmul_supported,
    unpack4,
)

# Weight leaves that get quantized, with the axis of the contraction
# (input) dimension in the stacked [L, ...] layout of ``init_params``.
# Scales keep that axis as size 1.
_QUANT_AXES_DENSE = {
    "wq": 1,
    "wk": 1,
    "wv": 1,
    "wo": 1,
    "w_gate": 1,
    "w_up": 1,
    "w_down": 1,
}
# MoE expert stacks [L, E, K, N]: the contraction axis is 2. The router
# [L, D, E] stays unquantized, as norms and the embedding do.
_QUANT_AXES_MOE = {"w_gate": 2, "w_up": 2, "w_down": 2}


@dataclass
class QuantizedTensor:
    """int8 weight + float32 per-output-channel scale (keepdims layout)."""

    q: torch.Tensor  # int8, same shape as the original weight
    scale: torch.Tensor  # float32, original shape with contraction dim = 1

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer ``i`` of a stacked [L, K, N] (or MoE [L, E, K, N])
        weight, as views."""
        return QuantizedTensor(q=self.q[i], scale=self.scale[i])

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(q=self.q.to(device), scale=self.scale.to(device))


def quantize_tensor(w: torch.Tensor, axis: int) -> QuantizedTensor:
    """Symmetric per-channel int8: q = round(w / s), s = amax / 127."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight in ``dtype``: both factors cast to it, then multiplied
    (the JAX package's order of roundings)."""
    return qt.q.to(dtype) * qt.scale.to(dtype)


@dataclass
class Quantized4Tensor:
    """int4 weight (two nibbles a byte) + float32 per-output-channel scale.

    Packing contract (the JAX package's): the contraction axis is the
    second-to-last axis of the logical weight; rows [0, K/2) live in the
    low nibbles and rows [K/2, K) in the high ones, so ``q``'s
    contraction dim is K/2 and unpacking is a concatenation.
    """

    q: torch.Tensor  # int8 carrying two int4; contraction dim halved
    scale: torch.Tensor  # float32, logical shape with contraction dim = 1

    @property
    def shape(self):  # logical (unpacked) shape
        s = list(self.q.shape)
        s[-2] *= 2
        return torch.Size(s)

    @property
    def ndim(self):
        return self.q.ndim

    def layer(self, i: int) -> "Quantized4Tensor":
        """Layer ``i`` of a stacked [L, K/2, N] (or MoE [L, E, K/2, N])
        weight, as views."""
        return Quantized4Tensor(q=self.q[i], scale=self.scale[i])

    def to(self, device) -> "Quantized4Tensor":
        return Quantized4Tensor(q=self.q.to(device), scale=self.scale.to(device))


# The quantized leaf types: what the layer loops take ``.layer(i)`` of.
QUANT_LEAVES = (QuantizedTensor, Quantized4Tensor)


def quantize_tensor4(w: torch.Tensor, axis: int) -> Quantized4Tensor:
    """Symmetric per-channel int4: q = round(w / s) in [-8, 7], s = amax / 7,
    packed along ``axis``, which must be the second-to-last and even."""
    if axis % w.ndim != w.ndim - 2:
        raise ValueError(
            f"int4 packs along axis -2; got axis {axis} for rank {w.ndim}"
        )
    k = w.shape[axis]
    if k % 2:
        raise ValueError(f"contraction dim {k} must be even for int4")
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(w32 / scale), -8, 7).to(torch.int32)
    low, high = torch.split(q, k // 2, dim=axis)
    packed = ((low & 0xF) | ((high & 0xF) << 4)).to(torch.int8)
    return Quantized4Tensor(q=packed, scale=scale)


def dequantize4(qt: Quantized4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight in ``dtype``: the nibbles unpacked into it, times the
    scale cast to it (the JAX package's order of roundings)."""
    return unpack4(qt.q, dtype) * qt.scale.to(dtype)


def maybe_dequantize(leaf, dtype=torch.bfloat16):
    """Pass-through for plain tensors; dequantize quantized leaves."""
    if isinstance(leaf, QuantizedTensor):
        return dequantize(leaf, dtype)
    if isinstance(leaf, Quantized4Tensor):
        return dequantize4(leaf, dtype)
    return leaf


# Kernel switches, the JAX package's own names: None = the kernel for
# CUDA tensors at supported shapes (the twin for CPU tensors); False = the
# plain twin everywhere; True = the kernel, raising on a CPU tensor.
_FORCE_KERNEL: bool | None = None
_FORCE_KERNEL4: bool | None = None


def set_kernel_enabled(enabled: bool | None) -> None:
    """Force the int8 matmul kernel on or off; None restores the default."""
    global _FORCE_KERNEL
    _FORCE_KERNEL = enabled


def set_kernel4_enabled(enabled: bool | None) -> None:
    """Force the int4 matmul kernel (K10) on or off; None restores the
    default, the kernel for CUDA tensors.

    The JAX package keeps its int4 kernel opt-in (default off) because of
    Mosaic compile times on one TPU toolchain, a workaround for the TPU's
    compiler and not part of the semantics. Here K10 is a CUDA kernel
    built once, so int4 routes as int8 does: an int4 path that quietly
    dequantized to cuBLAS would run no kernel of its own.
    """
    global _FORCE_KERNEL4
    _FORCE_KERNEL4 = enabled


def matmul(x: torch.Tensor, leaf, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [..., K] @ leaf [K, N]``, quantization-aware.

    Plain tensors use ``torch.matmul``. A 2-D :class:`QuantizedTensor`
    goes through K6 when ``quant_matmul_supported(M, K, N)`` holds, M the
    product of x's leading dimensions, a 2-D :class:`Quantized4Tensor`
    through K10 when ``quant4_matmul_supported(M, K, N)`` holds (K the
    logical contraction dim); otherwise the leaf is dequantized into x's
    type first. ``out_dtype``: the result's type (the lm_head asks for
    float32, computed from float32 operands).
    """
    if isinstance(leaf, QUANT_LEAVES):
        int4 = isinstance(leaf, Quantized4Tensor)
        k, n = leaf.shape
        lead = x.shape[:-1]
        m = math.prod(lead)
        if (quant4_matmul_supported if int4 else quant_matmul_supported)(m, k, n):
            x2 = x.reshape(m, k).contiguous()
            force = _FORCE_KERNEL4 if int4 else _FORCE_KERNEL
            if force is False:
                plain = quant4_matmul_2d_plain if int4 else quant_matmul_2d_plain
                out = plain(x2, leaf.q, leaf.scale, out_dtype)
            else:
                if force and not x.is_cuda:
                    raise RuntimeError(
                        f"the {'int4' if int4 else 'int8'} matmul kernel is forced "
                        "on but x lies on the CPU"
                    )
                kernel = quant4_matmul_2d if int4 else quant_matmul_2d
                out = kernel(x2, leaf.q, leaf.scale, out_dtype)
            return out.reshape(*lead, n)
        w = maybe_dequantize(leaf, x.dtype)
    else:
        w = leaf
    if out_dtype is not None:
        return x.to(out_dtype) @ w.to(out_dtype)
    return x @ w


def quant_axis(name: str, ndim: int) -> int | None:
    """The contraction axis of block leaf ``name`` of rank ``ndim`` in
    the stacked layout, or None for a leaf that stays unquantized."""
    if name in _QUANT_AXES_MOE and ndim == 4:
        return _QUANT_AXES_MOE[name]
    return _QUANT_AXES_DENSE.get(name)


def quantize_params(
    params: dict, *, quantize_lm_head: bool = True, bits: int = 8
) -> dict:
    """Quantize the large matmul weights of an ``init_params`` tree.

    Norms, biases, the MoE router and the embedding gather table keep
    their type. Dense and MoE block layouts both work (an MoE expert
    stack carries an extra expert axis; its contraction axis is 2).
    ``bits``: 8 (int8, amax / 127) or 4 (packed int4, amax / 7). Leaves
    that are already quantized stay as they are.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qfn = quantize_tensor if bits == 8 else quantize_tensor4
    out = dict(params)
    blocks = dict(params["blocks"])
    for name, w in blocks.items():
        axis = quant_axis(name, w.ndim)
        if axis is not None and not isinstance(w, QUANT_LEAVES):
            blocks[name] = qfn(w, axis)
    out["blocks"] = blocks
    if (
        quantize_lm_head
        and "lm_head" in params
        and not isinstance(params["lm_head"], QUANT_LEAVES)
    ):
        out["lm_head"] = qfn(params["lm_head"], axis=0)
    return out


def leaves(node):
    """The tensors of a parameter tree, a quantized leaf's q and scale
    both counted."""
    if isinstance(node, dict):
        for v in node.values():
            yield from leaves(v)
    elif isinstance(node, QUANT_LEAVES):
        yield node.q
        yield node.scale
    else:
        yield node


def quantized_bytes(params) -> int:
    """Total parameter bytes as stored (int8, packed int4 and scales count
    as they are)."""
    return sum(t.numel() * t.element_size() for t in leaves(params))
