"""Weight-only int8 quantization (per-output-channel, symmetric).

Counterpart of ``llm_consensus_tpu.ops.quant`` for int8 weights. Decode
is bound by the bytes it reads, and every generated token re-reads every
weight, so int8 weights halve that floor. Each large matmul weight is
stored as an int8 tensor beside a float32 scale per output channel; the
same rounding as the JAX package (amax / 127, round half to even, clip to
±127) gives the same bits.

:func:`matmul` routes as the JAX package does: an int8 leaf goes through
the hand-written W8A16 kernel (K6, :mod:`.kernels.quant_matmul`) whenever
``quant_matmul_supported(m, k, n)`` holds (the decode regime, M <= 256),
and is otherwise dequantized into ``x``'s type and multiplied by
``torch.matmul``, a large product (a long prefill) that the JAX package
also leaves outside any kernel. The choice is made from shapes before
anything launches.

The JAX package's ``StackedQuant`` is not needed: it exists because a
Pallas operand must be a whole buffer, while here the layer loop passes
``w.q[l]`` and ``w.scale[l]``, zero-copy views, straight to the kernel.
Packed int4 weights (``bits=4``) wait for the port of their kernel (K10)
and raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from llm_consensus_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul_2d,
    quant_matmul_2d_plain,
    quant_matmul_supported,
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
        """Layer ``i`` of a stacked [L, K, N] weight, as views."""
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


def maybe_dequantize(leaf, dtype=torch.bfloat16):
    """Pass-through for plain tensors; dequantize quantized leaves."""
    if isinstance(leaf, QuantizedTensor):
        return dequantize(leaf, dtype)
    return leaf


# Kernel switch, the JAX package's own: None = the kernel for CUDA
# tensors at supported shapes (the twin for CPU tensors); False = the
# plain twin everywhere; True = the kernel, raising on a CPU tensor.
_FORCE_KERNEL: bool | None = None


def set_kernel_enabled(enabled: bool | None) -> None:
    """Force the int8 matmul kernel on or off; None restores the default."""
    global _FORCE_KERNEL
    _FORCE_KERNEL = enabled


def matmul(x: torch.Tensor, leaf, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [..., K] @ leaf [K, N]``, quantization-aware.

    Plain tensors use ``torch.matmul``. A 2-D :class:`QuantizedTensor`
    goes through K6 when ``quant_matmul_supported(M, K, N)`` holds, M the
    product of x's leading dimensions; otherwise it is dequantized into
    x's type first. ``out_dtype``: the result's type (the lm_head asks
    for float32, computed from float32 operands).
    """
    if isinstance(leaf, QuantizedTensor):
        k, n = leaf.q.shape
        lead = x.shape[:-1]
        m = math.prod(lead)
        if quant_matmul_supported(m, k, n):
            x2 = x.reshape(m, k).contiguous()
            if _FORCE_KERNEL is False:
                out = quant_matmul_2d_plain(x2, leaf.q, leaf.scale, out_dtype)
            else:
                if _FORCE_KERNEL and not x.is_cuda:
                    raise RuntimeError(
                        "the int8 matmul kernel is forced on but x lies on the CPU"
                    )
                out = quant_matmul_2d(x2, leaf.q, leaf.scale, out_dtype)
            return out.reshape(*lead, n)
        w = dequantize(leaf, x.dtype)
    else:
        w = leaf
    if out_dtype is not None:
        return x.to(out_dtype) @ w.to(out_dtype)
    return x @ w


def quantize_params(
    params: dict, *, quantize_lm_head: bool = True, bits: int = 8
) -> dict:
    """Quantize the large matmul weights of an ``init_params`` tree.

    Norms, biases and the embedding gather table keep their type.
    ``bits=4`` (packed int4) raises until its kernel (K10) is ported.
    """
    if bits == 4:
        raise NotImplementedError(
            "int4 weights need the packed-int4 matmul kernel (K10), which "
            "is not ported to PyTorch yet"
        )
    if bits != 8:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = dict(params)
    blocks = dict(params["blocks"])
    for name, w in blocks.items():
        if name in _QUANT_AXES_DENSE and not isinstance(w, QuantizedTensor):
            blocks[name] = quantize_tensor(w, _QUANT_AXES_DENSE[name])
    out["blocks"] = blocks
    if (
        quantize_lm_head
        and "lm_head" in params
        and not isinstance(params["lm_head"], QuantizedTensor)
    ):
        out["lm_head"] = quantize_tensor(params["lm_head"], axis=0)
    return out


def leaves(node):
    """The tensors of a parameter tree, a quantized leaf's q and scale
    both counted."""
    if isinstance(node, dict):
        for v in node.values():
            yield from leaves(v)
    elif isinstance(node, QuantizedTensor):
        yield node.q
        yield node.scale
    else:
        yield node


def quantized_bytes(params) -> int:
    """Total parameter bytes as stored (int8 + scales count as-is)."""
    return sum(t.numel() * t.element_size() for t in leaves(params))
