"""Pre-norm GQA transformer (Llama family), dense models, in PyTorch.

Counterpart of ``llm_consensus_tpu.models.transformer`` for dense models
with bf16 or int8 weights and a bf16 or int8 KV cache: the same parameter
tree (layers stacked on a leading axis, int8 leaves as
:class:`~llm_consensus_tpu_torch.ops.quant.QuantizedTensor`), the same
``[B, S, H, D]`` layouts, the same float32 norms, softmax and logits.
Differences by design:

- The layer loop is a Python loop over views of the stacked weights
  (PyTorch runs eagerly; there is no ``lax.scan`` to compile).
- The KV cache is written in place (see :mod:`.cache`).
- ``cfg.use_pallas`` routes RMSNorm and attention through the
  hand-written kernels of :mod:`llm_consensus_tpu_torch.ops.kernels`;
  int8 weights go through the W8A16 kernel by shape, as in the JAX
  package (:func:`~llm_consensus_tpu_torch.ops.quant.matmul`).

MoE, sliding windows, ring attention, the paged steps and the chunk mode
are not ported yet; the entry points raise on configs that need them.

Entry points: :func:`forward` (logits for every position),
:func:`prefill` (fill the cache from right-padded prompts, last-token
logits) and :func:`decode_step` (one token against the cache).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache, quantize_kv
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.ops import kernels
from llm_consensus_tpu_torch.ops.activations import swiglu
from llm_consensus_tpu_torch.ops.attention import (
    causal_attention,
    decode_attention,
    decode_attention_quant,
)
from llm_consensus_tpu_torch.ops.norms import rms_norm
from llm_consensus_tpu_torch.ops.quant import QuantizedTensor, leaves, quantize_params
from llm_consensus_tpu_torch.ops.quant import matmul as _qmm
from llm_consensus_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from llm_consensus_tpu_torch.utils.device import resolve_device, to_device


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_moe or cfg.sliding_window or cfg.use_ring:
        raise NotImplementedError(
            f"{cfg.name}: MoE, sliding-window and ring attention are not "
            "ported to PyTorch yet"
        )


def _rms(cfg: ModelConfig, x, w):
    if cfg.use_pallas:
        return kernels.fused_rms_norm(x, w, cfg.rms_norm_eps)
    return rms_norm(x, w, cfg.rms_norm_eps)


def _attn_causal(cfg: ModelConfig, q, k, v, positions):
    # The kernel implements index-causal masking; explicit positions use
    # the plain path.
    if cfg.use_pallas and positions is None:
        return kernels.flash_causal_attention(q, k, v)
    return causal_attention(q, k, v, positions)


def _attn_decode(cfg: ModelConfig, q, k_cache, v_cache, valid_len, shared_prefix_len=None):
    """``shared_prefix_len`` (int or None): every row's cache slots
    [0, shared_prefix_len) hold the same K/V (the shared-prefill fan-out),
    so the kernel reads that region once for the whole batch. Engages on
    the kernel path only; the plain path reads every row (same outputs)."""
    if cfg.use_pallas:
        if shared_prefix_len is not None:
            return kernels.flash_decode_attention_shared_prefix(
                q, k_cache, v_cache, valid_len, shared_prefix_len
            )
        return kernels.flash_decode_attention(q, k_cache, v_cache, valid_len)
    return decode_attention(q, k_cache, v_cache, valid_len)


_STACKED_DECODE = False


def set_stacked_decode(enabled: bool) -> None:
    """Route int8-cache decode attention through the ``_stacked`` kernel
    wrappers, which take the whole cache and the layer index (the JAX
    package's switch of the same name; off by default). Outputs are the
    same either way: here both launch the same kernels, on the same
    views."""
    global _STACKED_DECODE
    _STACKED_DECODE = enabled


def _attn_decode_quant(cfg: ModelConfig, q, k_q, k_s, v_q, v_s, valid_len,
                       shared_prefix_len=None):
    """Decode attention over one layer's int8 cache views [B, Hkv, S, D]
    (scales [B, Hkv, S]): K4, or K7-q8 for a shared prefix, on the kernel
    path; the plain path dequantizes and reads every row (same
    outputs)."""
    if cfg.use_pallas:
        if shared_prefix_len is not None:
            return kernels.flash_decode_attention_shared_prefix_q8(
                q, k_q, k_s, v_q, v_s, valid_len, shared_prefix_len
            )
        return kernels.flash_decode_attention_q8(q, k_q, k_s, v_q, v_s, valid_len)
    return decode_attention_quant(q, k_q, k_s, v_q, v_s, valid_len)


def _attn_decode_quant_stacked(cfg: ModelConfig, q, k_q, k_s, v_q, v_s, valid_len,
                               layer: int, shared_prefix_len=None):
    """As :func:`_attn_decode_quant`, given the whole stacked cache
    [L, B, Hkv, S, D] and the layer index."""
    if cfg.use_pallas:
        if shared_prefix_len is not None:
            return kernels.flash_decode_attention_shared_prefix_q8_stacked(
                q, k_q, k_s, v_q, v_s, valid_len, shared_prefix_len, layer
            )
        return kernels.flash_decode_attention_q8_stacked(
            q, k_q, k_s, v_q, v_s, valid_len, layer
        )
    return decode_attention_quant(
        q, k_q[layer], k_s[layer], v_q[layer], v_s[layer], valid_len
    )


# ---------------------------------------------------------------------------
# Init and parameter conversion
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | int = 0,
    dtype=torch.bfloat16,
    device: str | torch.device | None = None,
) -> dict:
    """Random-init parameters with the JAX package's scheme: normal(0,
    0.02), residual projections scaled by 1/sqrt(2*n_layers), norms ones,
    biases zeros, drawn in the same order. ``generator``: a
    ``torch.Generator`` on ``device``, or an int seed for one. The
    numbers differ from the JAX package's for the same seed (another
    generator); carry JAX weights over with :func:`params_from_jax`."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)

    def normal(shape, scale=0.02):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * scale).to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    L, D, H, Hkv, F, V = (
        cfg.n_layers,
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads,
        cfg.d_ff,
        cfg.vocab_size,
    )
    Dh = cfg.head_dim
    resid_scale = 0.02 / math.sqrt(2 * L)

    blocks: dict = {
        "attn_norm": full((L, D), 1.0),
        "mlp_norm": full((L, D), 1.0),
        "wq": normal((L, D, H * Dh)),
        "wk": normal((L, D, Hkv * Dh)),
        "wv": normal((L, D, Hkv * Dh)),
        "wo": normal((L, H * Dh, D), resid_scale),
    }
    if cfg.qkv_bias:
        blocks["bq"] = full((L, H * Dh), 0.0)
        blocks["bk"] = full((L, Hkv * Dh), 0.0)
        blocks["bv"] = full((L, Hkv * Dh), 0.0)
    if cfg.is_moe:
        raise NotImplementedError("MoE is not ported to PyTorch yet")
    blocks["w_gate"] = normal((L, D, F))
    blocks["w_up"] = normal((L, D, F))
    blocks["w_down"] = normal((L, F, D), resid_scale)

    params = {
        "embed": normal((V, D)),
        "blocks": blocks,
        "norm_f": full((D,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V))
    return params


def init_params_quantized(
    cfg: ModelConfig,
    generator: torch.Generator | int = 0,
    *,
    bits: int = 8,
    dtype=torch.bfloat16,
    device: str | torch.device | None = None,
) -> dict:
    """Init on the CPU, quantize there, then move to ``device``: the
    card only ever holds the int8 leaves, never the full-width ones.
    ``generator`` is a CPU generator or an int seed for one."""
    dev = resolve_device(device)
    params = quantize_params(init_params(cfg, generator, dtype, "cpu"), bits=bits)
    return to_device(params, dev)


def _leaf_to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch.bfloat16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(
    tree: dict, device: str | torch.device | None = None, dtype=None
) -> dict[str, torch.Tensor]:
    """Carry a JAX parameter tree (leaves as numpy arrays, e.g. from
    ``jax.tree.map(np.asarray, params)``) over to tensors: the same tree,
    moved to ``device`` and, when ``dtype`` is given, cast to it. A node
    with ``.q`` and ``.scale`` (the JAX package's quantized leaf) becomes
    a :class:`QuantizedTensor`, its int8 and float32 kept as they are."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QuantizedTensor(
                q=_leaf_to_tensor(node.q, dev, None),
                scale=_leaf_to_tensor(node.scale, dev, None),
            )
        return _leaf_to_tensor(node, dev, dtype)

    return conv(tree)


def param_count(params: dict) -> int:
    return sum(t.numel() for t in leaves(params))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _project_qkv(cfg: ModelConfig, p: dict, h: torch.Tensor):
    b, s, _ = h.shape
    q = _qmm(h, p["wq"])
    k = _qmm(h, p["wk"])
    v = _qmm(h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _mlp(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _block(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv_layer: tuple | None,
    mode: str,
    valid_len: torch.Tensor | None,
    positions: torch.Tensor | None,
    uniform_write: bool = False,
    shared_prefix_len: int | None = None,
    stacked: tuple | None = None,
) -> torch.Tensor:
    """One transformer block; returns the new residual stream.

    ``kv_layer``: this layer's cache views, written in place in modes
    ``prefill`` (slots [0, S)) and ``decode`` (slot ``valid_len[b]`` of
    each row): (k, v) [B, S_max, Hkv, D] for the bf16 cache, or (k_q,
    v_q, k_scale, v_scale) head-major for the int8 cache, written
    quantized per (token, kv head). ``uniform_write``: every row writes
    at the same slot (the shared-prefill fan-out), so the decode write is
    one slice copy along the slot axis instead of a scatter.
    ``shared_prefix_len`` (decode mode): see :func:`_attn_decode`.
    ``stacked`` (int8 decode under :func:`set_stacked_decode`): (the whole
    cache's four buffers, the layer index), for the ``_stacked`` wrappers.
    """
    h = _rms(cfg, x, p["attn_norm"])
    q, k, v = _project_qkv(cfg, p, h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if mode == "full":
        attn = _attn_causal(cfg, q, k, v, positions)
    elif mode == "prefill":
        attn = _attn_causal(cfg, q, k, v, positions)
        s = k.shape[1]
        if len(kv_layer) == 2:
            k_l, v_l = kv_layer
            k_l[:, :s] = k
            v_l[:, :s] = v
        else:
            kq_l, vq_l, ks_l, vs_l = kv_layer
            kq, ks = quantize_kv(k)  # [B, S, Hkv, D] / [B, S, Hkv]
            vq, vs = quantize_kv(v)
            kq_l[:, :, :s] = kq.transpose(1, 2)
            vq_l[:, :, :s] = vq.transpose(1, 2)
            ks_l[:, :, :s] = ks.transpose(1, 2)
            vs_l[:, :, :s] = vs.transpose(1, 2)
    elif mode == "decode" and len(kv_layer) == 4:
        kq_l, vq_l, ks_l, vs_l = kv_layer
        kq1, ks1 = quantize_kv(k[:, 0])  # [B, Hkv, D] / [B, Hkv]
        vq1, vs1 = quantize_kv(v[:, 0])
        if uniform_write:
            slot = valid_len[:1].long()
            kq_l.index_copy_(2, slot, kq1[:, :, None])
            vq_l.index_copy_(2, slot, vq1[:, :, None])
            ks_l.index_copy_(2, slot, ks1[:, :, None])
            vs_l.index_copy_(2, slot, vs1[:, :, None])
        else:
            rows = torch.arange(x.shape[0], device=x.device)
            pos = valid_len.long()
            kq_l[rows, :, pos] = kq1
            vq_l[rows, :, pos] = vq1
            ks_l[rows, :, pos] = ks1
            vs_l[rows, :, pos] = vs1
        if stacked is not None:
            (kq_f, vq_f, ks_f, vs_f), layer = stacked
            attn = _attn_decode_quant_stacked(
                cfg, q, kq_f, ks_f, vq_f, vs_f, valid_len + 1, layer, shared_prefix_len
            )
        else:
            attn = _attn_decode_quant(
                cfg, q, kq_l, ks_l, vq_l, vs_l, valid_len + 1, shared_prefix_len
            )
    elif mode == "decode":
        k_l, v_l = kv_layer
        if uniform_write:
            slot = valid_len[:1].long()
            k_l.index_copy_(1, slot, k.to(k_l.dtype))
            v_l.index_copy_(1, slot, v.to(v_l.dtype))
        else:
            rows = torch.arange(x.shape[0], device=x.device)
            k_l[rows, valid_len.long()] = k[:, 0].to(k_l.dtype)
            v_l[rows, valid_len.long()] = v[:, 0].to(v_l.dtype)
        attn = _attn_decode(cfg, q, k_l, v_l, valid_len + 1, shared_prefix_len)
    else:  # pragma: no cover
        raise ValueError(mode)

    x = x + _qmm(attn.reshape(*x.shape[:-1], -1), p["wo"])
    h2 = _rms(cfg, x, p["mlp_norm"])
    return x + _mlp(cfg, p, h2)


def _run_layers(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache: KVCache | QuantKVCache | None,
    mode: str,
    valid_len: torch.Tensor | None,
    positions: torch.Tensor | None,
    uniform_write: bool = False,
    shared_prefix_len: int | None = None,
) -> torch.Tensor:
    blocks = params["blocks"]
    bufs = () if cache is None else cache.leaves
    stacked_decode = _STACKED_DECODE and mode == "decode" and len(bufs) == 4
    for layer in range(cfg.n_layers):
        p = {
            name: leaf.layer(layer) if isinstance(leaf, QuantizedTensor) else leaf[layer]
            for name, leaf in blocks.items()
        }
        kv_layer = tuple(t[layer] for t in bufs) or None
        x = _block(
            cfg, p, x, cos, sin, kv_layer, mode, valid_len, positions,
            uniform_write=uniform_write, shared_prefix_len=shared_prefix_len,
            stacked=(bufs, layer) if stacked_decode else None,
        )
    return x


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and float32 logits (bf16 operands multiply exactly in
    float32, as the JAX package's preferred_element_type=float32; an int8
    lm_head goes through the W8A16 kernel with a float32 output)."""
    x = _rms(cfg, x, params["norm_f"])
    if cfg.tie_embeddings:
        return x.float() @ params["embed"].float().T
    return _qmm(x, params["lm_head"], out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


@torch.inference_mode()
def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full causal forward: tokens [B, S] -> logits [B, S, V] (float32)."""
    _check_supported(cfg)
    x = params["embed"][tokens]
    positions_arr = (
        torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        if positions is None
        else positions
    )
    cos, sin = rope_cos_sin(
        positions_arr, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    )
    x = _run_layers(cfg, params, x, cos, sin, None, "full", None, positions)
    return _unembed(cfg, params, x)


@torch.inference_mode()
def prefill(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    cache: KVCache | QuantKVCache,
) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """Prefill right-padded prompts.

    tokens: [B, S] right-padded; lengths: [B] int32 true prompt lengths.
    Returns (last-valid-token logits [B, V] float32, the cache with k/v
    written at slots [0, S) and length set to ``lengths``).

    Padded slots do write garbage k/v into the cache, but they sit at
    indices >= lengths[b] and are (a) masked out of every later decode
    step's attention (``valid_len`` masking) and (b) progressively
    overwritten by decode writes at slot ``length``.
    """
    _check_supported(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    )
    x = _run_layers(cfg, params, x, cos, sin, cache, "prefill", None, None)
    # Hidden state at the last real token of each sequence.
    last = torch.clamp(lengths.long() - 1, 0, s - 1)
    x_last = x[torch.arange(b, device=x.device), last]  # [B, D]
    logits = _unembed(cfg, params, x_last)
    return logits, cache.with_length(lengths.to(torch.int32))


@torch.inference_mode()
def decode_step(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    cache: KVCache | QuantKVCache,
    uniform_write: bool = False,
    shared_prefix_len: int | None = None,
) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """One decode step: tokens [B, 1] -> (logits [B, V] float32, cache).

    The new token's k/v is written at slot ``cache.length`` (in place) and
    the returned cache's fill length is one more. ``uniform_write``: all
    rows share one fill length (shared-prefill fan-out).
    ``shared_prefix_len``: rows hold identical K/V in cache slots
    [0, shared_prefix_len), read once per step for the whole batch.
    """
    _check_supported(cfg)
    x = params["embed"][tokens]  # [B, 1, D]
    positions = cache.length[:, None]  # [B, 1]
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    )
    x = _run_layers(
        cfg, params, x, cos, sin, cache, "decode", cache.length, None,
        uniform_write=uniform_write, shared_prefix_len=shared_prefix_len,
    )
    logits = _unembed(cfg, params, x[:, 0])
    return logits, cache.advanced(1)
