"""Pre-norm GQA transformer (Llama family), dense models, in PyTorch.

Counterpart of ``llm_consensus_tpu.models.transformer`` for dense models
with bf16, int8 or int4 weights and a bf16 or int8 KV cache: the same
parameter tree (layers stacked on a leading axis, quantized leaves as
:class:`~llm_consensus_tpu_torch.ops.quant.QuantizedTensor` or
``Quantized4Tensor``), the same
``[B, S, H, D]`` layouts, the same float32 norms, softmax and logits.
Differences by design:

- The layer loop is a Python loop over views of the stacked weights
  (PyTorch runs eagerly; there is no ``lax.scan`` to compile).
- The KV cache is written in place (see :mod:`.cache`).
- ``cfg.use_pallas`` routes RMSNorm and attention through the
  hand-written kernels of :mod:`llm_consensus_tpu_torch.ops.kernels`;
  int8 and int4 weights go through the W8A16 and W4A16 kernels by shape
  (:func:`~llm_consensus_tpu_torch.ops.quant.matmul`).

MoE, sliding windows, ring attention, the speculative verify step and
the chunk mode are not ported yet; the entry points raise on configs that
need them.

Entry points: :func:`forward` (logits for every position),
:func:`prefill` (fill the cache from right-padded prompts, last-token
logits) and :func:`decode_step` (one token against the cache); for the
continuous batcher's page pool (:mod:`.paged_cache`),
:func:`decode_step_paged`, :func:`prefill_chunk_paged`,
:func:`fused_step_paged` and :func:`unembed_one`. The paged steps write
the pool in place and return the cache they were given.

The paged steps also run on a dp x mp mesh (``mesh=``, a
:class:`~llm_consensus_tpu_torch.parallel.mesh.Mesh`), one rank's shard
each: params from :func:`~llm_consensus_tpu_torch.parallel.partitioning.
shard_params`, the cache from ``PagedKVCache.create(..., mesh=mesh)``,
the decode rows (tokens, tables, lengths) of this rank's data shard, the
chunk lane replicated. Megatron tensor parallelism over ``model``: q/k/v
and gate/up split by columns (whole heads; a contiguous split keeps GQA's
``h // G`` inside the shard), ``wo`` and ``w_down`` by rows, each followed
by a sum over ``model``; ``lm_head`` over the vocabulary, its logits
gathered over ``model``. Attention goes through K9 (the sharded ragged
paged attention). A mesh that does not divide raises
(:func:`check_mesh_shardable`): there is no fallback.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache, quantize_kv
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.models.paged_cache import NULL_PAGE, PagedKVCache
from llm_consensus_tpu_torch.ops import kernels
from llm_consensus_tpu_torch.ops.activations import swiglu
from llm_consensus_tpu_torch.ops.attention import (
    causal_attention,
    decode_attention,
    decode_attention_quant,
    ragged_paged_attention_reference,
)
from llm_consensus_tpu_torch.ops.norms import rms_norm
from llm_consensus_tpu_torch.ops.quant import (
    QUANT_LEAVES,
    Quantized4Tensor,
    QuantizedTensor,
    leaves,
    quantize_params,
)
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
    generator); carry JAX weights over with :func:`params_from_jax`.
    ``device="meta"`` gives the tree's shapes and types and allocates
    nothing (the capacity planner's use; ``generator`` is unused)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    if isinstance(generator, int) and not meta:
        generator = torch.Generator(device=dev).manual_seed(generator)

    def normal(shape, scale=0.02):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
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
    """Init on the CPU, quantize there (``bits`` 8 or 4), then move to
    ``device``: the card only ever holds the quantized leaves, never the
    full-width ones. ``generator`` is a CPU generator or an int seed for
    one."""
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
    with ``.q`` and ``.scale`` (the JAX package's quantized leaves) keeps
    its int8 and float32 as they are: a ``Quantized4Tensor`` becomes a
    :class:`Quantized4Tensor`, any other a :class:`QuantizedTensor`. The
    type's name tells them apart, not the shape: a packed ``[K/2, N]`` and
    an int8 ``[K', N]`` can look alike."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            cls = (
                Quantized4Tensor
                if type(node).__name__ == "Quantized4Tensor"
                else QuantizedTensor
            )
            return cls(
                q=_leaf_to_tensor(node.q, dev, None),
                scale=_leaf_to_tensor(node.scale, dev, None),
            )
        return _leaf_to_tensor(node, dev, dtype)

    return conv(tree)


def param_count(params: dict) -> int:
    return sum(t.numel() for t in leaves(params))


def _layer_params(blocks: dict, layer: int) -> dict:
    """Layer ``layer``'s views of the stacked block weights."""
    return {
        name: leaf.layer(layer) if isinstance(leaf, QUANT_LEAVES) else leaf[layer]
        for name, leaf in blocks.items()
    }


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
    # Heads from the widths: on a mesh each rank holds H/mp and Hkv/mp.
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
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
        p = _layer_params(blocks, layer)
        kv_layer = tuple(t[layer] for t in bufs) or None
        x = _block(
            cfg, p, x, cos, sin, kv_layer, mode, valid_len, positions,
            uniform_write=uniform_write, shared_prefix_len=shared_prefix_len,
            stacked=(bufs, layer) if stacked_decode else None,
        )
    return x


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Final norm and float32 logits (bf16 operands multiply exactly in
    float32, as the JAX package's preferred_element_type=float32; an int8
    or int4 lm_head goes through its kernel with a float32 output). On a
    mesh the vocab-split ``lm_head``'s logits are gathered over ``model``
    (the tied embedding is replicated)."""
    x = _rms(cfg, x, params["norm_f"])
    if cfg.tie_embeddings:
        return x.float() @ params["embed"].float().T
    logits = _qmm(x, params["lm_head"], out_dtype=torch.float32)
    return logits if mesh is None else mesh.gather(logits, "model", dim=-1)


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


# ---------------------------------------------------------------------------
# Paged steps (the continuous batcher's device programs)
# ---------------------------------------------------------------------------


def ragged_mesh_shardable(cfg: ModelConfig, mesh, max_slots: int,
                          n_pages: int) -> bool:
    """Whether the ragged paged attention can run sharded on this mesh:
    kv heads must split over ``model`` and the decode rows / page pool
    over ``data`` (the JAX package's predicate of the same name)."""
    if mesh is None:
        return False
    dp = int(mesh.shape.get("data", 1))
    mp = int(mesh.shape.get("model", 1))
    return (
        cfg.n_kv_heads % mp == 0
        and max_slots % dp == 0
        and n_pages % dp == 0
    )


def check_mesh_shardable(cfg: ModelConfig, mesh, max_slots: int, n_pages: int) -> None:
    """Raise, naming the shapes, when the serving path cannot shard over
    ``mesh``. The JAX package falls back to its XLA reference there; the
    port has no quiet fallback."""
    if not cfg.use_pallas:
        raise NotImplementedError(
            f"{cfg.name}: the serving path on a mesh runs K9 (use_pallas=True); "
            "the gather reference is not sharded"
        )
    if ragged_mesh_shardable(cfg, mesh, max_slots, n_pages):
        return
    dp = int(mesh.shape.get("data", 1))
    mp = int(mesh.shape.get("model", 1))
    raise ValueError(
        f"{cfg.name} cannot shard over the mesh data={dp} x model={mp}: "
        f"n_kv_heads % model = {cfg.n_kv_heads} % {mp}, "
        f"max_slots % data = {max_slots} % {dp}, "
        f"n_pages % data = {n_pages} % {dp} must all be 0"
    )


def _attn_paged(
    cfg: ModelConfig,
    q_dec,
    q_chunk,
    k_pool,
    v_pool,
    tables,
    valid,
    chunk_table=None,
    chunk_start=None,
    groups=None,
    mesh=None,
):
    """Paged attention for one layer's decode rows (+ optional prefill
    chunk row) — the kernel seam of the serving path: ``cfg.use_pallas``
    picks K8 (:func:`~llm_consensus_tpu_torch.ops.kernels.
    ragged_paged_attention`), or K9 (:func:`~llm_consensus_tpu_torch.ops.
    kernels.ragged_paged_attention_sharded`) on this rank's shard of a
    mesh (a mesh with ``use_pallas=False`` is refused where its cache and
    batcher are built, :func:`check_mesh_shardable`); anything else the
    gather reference with the same ragged semantics (which ignores
    ``groups``: outputs equal).

    q_dec: [B, H, D]; q_chunk: [C, H, D] or None; groups: K8's tuple from
    :func:`_group_args` or None; returns out_dec [B, H, D] (and out_chunk
    [C, H, D] when q_chunk is given)."""
    window = cfg.sliding_window
    if mesh is not None:
        return kernels.ragged_paged_attention_sharded(
            mesh, q_dec, k_pool, v_pool, tables, valid,
            q_chunk=q_chunk, chunk_table=chunk_table, chunk_start=chunk_start,
            groups=groups, window=window,
        )
    if cfg.use_pallas:
        return kernels.ragged_paged_attention(
            q_dec, k_pool, v_pool, tables, valid,
            q_chunk=q_chunk, chunk_table=chunk_table, chunk_start=chunk_start,
            groups=groups, window=window,
        )
    return ragged_paged_attention_reference(
        q_dec, k_pool, v_pool, tables, valid,
        q_chunk=q_chunk, chunk_table=chunk_table, chunk_start=chunk_start,
        window=window,
    )


def _group_args(cfg: ModelConfig, groups, page_size: int):
    """K8's group tuple (group_id, group_rep, group_end in tokens,
    shared_start) from :class:`DecodeGroupArrays`, built once per step;
    None without groups or on the reference path (which ignores them)."""
    if groups is None or not cfg.use_pallas:
        return None
    return (
        groups.group_id,
        groups.group_rep,
        (groups.group_pages * page_size).to(torch.int32),
        groups.shared_start,
    )


def _attn_len(cache: PagedKVCache, valid: torch.Tensor) -> torch.Tensor:
    """Tokens each decode row attends over: ``valid``, or 0 for a row
    whose table is NULL (an idle or mid-prefill slot). Such a row's
    length keeps growing while it idles; attending over it would walk up
    to ``pages_per_seq`` pages of the NULL page in every layer. Its output
    is discarded either way (zeros here, the NULL page's garbage in the
    JAX package); ``cache.length`` still advances as there."""
    return torch.where(cache.page_table[:, 0] == NULL_PAGE, 0, valid).to(torch.int32)


def _page_index(pos: torch.Tensor, cache: PagedKVCache) -> torch.Tensor:
    return torch.clamp(pos // cache.page_size, max=cache.pages_per_seq - 1)


def _write_pages(cache: PagedKVCache, pages: torch.Tensor) -> torch.Tensor:
    """Pool indices of K/V writes to global page ids ``pages``: the local
    index where this cache's shard holds the page, else the shard's
    reserved first page, which no table maps (the NULL page on shard 0).
    A write never lands on a page of another row: a mesh rank drops the
    writes of pages it does not own (an idle row's NULL page, the chunk
    lane of another shard's slot) into that page. Off a mesh every id is
    local and this is the identity."""
    local = pages - cache.page_offset
    own = (local >= 0) & (local < cache.n_pages)
    return torch.where(own, local, 0)


def _tp_sum(mesh, y: torch.Tensor) -> torch.Tensor:
    """A row-split product's partial sums, summed over ``model``."""
    return y if mesh is None else mesh.sum(y, "model")


def _paged_layers(cfg: ModelConfig, params: dict, x, cos, sin, cache, attend, mesh=None):
    """The layer loop of the paged steps. ``attend(layer, q, k, v,
    k_pool, v_pool)`` writes the layer's new K/V into its pool views and
    returns the attention output [..., H, D] shaped like q. On a mesh the
    ``wo`` and ``w_down`` products are summed over ``model``."""
    blocks = params["blocks"]
    for layer in range(cfg.n_layers):
        p = _layer_params(blocks, layer)
        h = _rms(cfg, x, p["attn_norm"])
        q, k, v = _project_qkv(cfg, p, h)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attend(q, k, v, cache.k[layer], cache.v[layer])
        x = x + _tp_sum(mesh, _qmm(attn.reshape(*x.shape[:-1], -1), p["wo"]))
        h2 = _rms(cfg, x, p["mlp_norm"])
        x = x + _tp_sum(mesh, _mlp(cfg, p, h2))
    return x


@torch.inference_mode()
def decode_step_paged(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    cache: PagedKVCache,
    groups=None,
    mesh=None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step for every cache sequence, paged layout.

    tokens: [max_seqs, 1]. Row b writes its new K/V at
    ``page_table[b, length[b] // page]`` offset ``length[b] % page`` and
    attends over its pages. Inactive rows (NULL tables) write into the
    reserved NULL page and attend over nothing (:func:`_attn_len`) —
    outputs the serving layer discards. ``groups`` (a :class:`~llm_consensus_tpu_torch.models.
    paged_cache.DecodeGroupArrays` or None): rows sharing a prefix page
    run read it once per group through K8's group pass. Returns (logits
    [max_seqs, V] float32, the cache, its lengths advanced by one).
    ``mesh``: this rank's rows and shard (module docstring); groups'
    ``group_id`` and ``shared_start`` are this rank's rows, ``group_rep``
    global row indices.
    """
    _check_supported(cfg)
    b = tokens.shape[0]
    pos = cache.length.long()  # [B] write positions
    x = params["embed"][tokens]  # [B, 1, D]
    cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    pg = cache.page_size
    rows = torch.arange(b, device=tokens.device)
    # An idle row's length keeps growing past its (NULL) table; clamp the
    # page index as the JAX package's gather does.
    pages_now = _write_pages(cache, cache.page_table[rows, _page_index(pos, cache)].long())
    offset = pos % pg
    valid = cache.length + 1
    attn_len = _attn_len(cache, valid)
    gargs = _group_args(cfg, groups, pg)

    def attend(q, k, v, k_pool, v_pool):
        k_pool[pages_now, offset] = k[:, 0].to(k_pool.dtype)
        v_pool[pages_now, offset] = v[:, 0].to(v_pool.dtype)
        return _attn_paged(
            cfg, q[:, 0], None, k_pool, v_pool, cache.page_table, attn_len,
            groups=gargs, mesh=mesh,
        )[:, None]

    x = _paged_layers(cfg, params, x, cos, sin, cache, attend, mesh)
    logits = _unembed(cfg, params, x[:, 0], mesh)
    cache.length.copy_(valid)
    return logits, cache


@torch.inference_mode()
def prefill_chunk_paged(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    table: torch.Tensor,
    start: int,
    cache: PagedKVCache,
    mesh=None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """One prompt chunk for ONE sequence, scattered into paged K/V.

    tokens: [1, C] chunk ids at absolute positions ``start + i``; table:
    [pages_per_seq] int32 page ids (position p lives in
    ``table[p // page_size]`` at offset ``p % page_size``); start: int.
    Writes each chunk token's K/V through ``table`` and attends over the
    table's content so far plus the chunk (ragged causal). The table is
    an argument, not a row of ``cache.page_table``: a mid-prefill
    sequence stays invisible to the decode rows. The attention is the
    SAME K8 call as a fused chunk's, with one dead decode row (NULL
    table, length 0), so a standalone chunk and a fused chunk write the
    same cache bytes. Returns ([1, C, D] hidden states, the cache);
    ``page_table`` and ``length`` are untouched. On a mesh every rank runs
    the chunk (the lane is replicated over ``data``): only the shard that
    owns the table's pages writes them, and the hidden states are the
    same on every rank.
    """
    _check_supported(cfg)
    c = tokens.shape[1]
    dev = tokens.device
    pos = int(start) + torch.arange(c, device=dev)
    x = params["embed"][tokens]  # [1, C, D]
    cos, sin = rope_cos_sin(pos[None], cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    pg = cache.page_size
    pages = _write_pages(cache, table.long()[pos // pg])
    offs = pos % pg
    dead_tbl = torch.zeros((1, table.shape[0]), dtype=torch.int32, device=dev)
    dead_len = torch.zeros((1,), dtype=torch.int32, device=dev)

    def attend(q, k, v, k_pool, v_pool):
        k_pool[pages, offs] = k[0].to(k_pool.dtype)
        v_pool[pages, offs] = v[0].to(v_pool.dtype)
        q_dead = torch.zeros((1, *q.shape[2:]), dtype=q.dtype, device=dev)
        return _attn_paged(
            cfg, q_dead, q[0].contiguous(), k_pool, v_pool, dead_tbl, dead_len,
            chunk_table=table, chunk_start=int(start), mesh=mesh,
        )[1][None]

    x = _paged_layers(cfg, params, x, cos, sin, cache, attend, mesh)
    return x, cache


@torch.inference_mode()
def fused_step_paged(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    cache: PagedKVCache,
    chunk_tokens: torch.Tensor,
    chunk_table: torch.Tensor,
    chunk_start: int,
    groups=None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, PagedKVCache]:
    """One decode step for every cache sequence PLUS one prefill chunk —
    one device program (the fused scheduler step).

    tokens: [B, 1]; chunk_tokens: [1, C] one sequence's prompt chunk at
    positions ``chunk_start + i`` written through ``chunk_table`` [P] as
    in :func:`prefill_chunk_paged`. Decode rows and the chunk share one
    token axis [B + C] for the embedding, RoPE, the projections and the
    MLP; attention is one K8 call with the chunk as one more row. Dense
    MLP only (MoE is refused). Returns (decode logits [B, V] float32,
    chunk hidden [1, C, D], the cache, decode lengths advanced by one).
    ``mesh``: this rank's decode rows and shard, the chunk replicated, as
    in :func:`decode_step_paged` and :func:`prefill_chunk_paged`.
    """
    _check_supported(cfg)
    b = tokens.shape[0]
    c = chunk_tokens.shape[1]
    dev = tokens.device
    pos = cache.length.long()
    chunk_pos = int(chunk_start) + torch.arange(c, device=dev)
    all_pos = torch.cat([pos, chunk_pos])
    x = params["embed"][torch.cat([tokens[:, 0], chunk_tokens[0]])][None]  # [1, B+C, D]
    cos, sin = rope_cos_sin(all_pos[None], cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    pg = cache.page_size
    rows = torch.arange(b, device=dev)
    pages_dec = _write_pages(cache, cache.page_table[rows, _page_index(pos, cache)].long())
    offs_dec = pos % pg
    pages_ch = _write_pages(cache, chunk_table.long()[chunk_pos // pg])
    offs_ch = chunk_pos % pg
    valid = cache.length + 1
    attn_len = _attn_len(cache, valid)
    gargs = _group_args(cfg, groups, pg)

    def attend(q, k, v, k_pool, v_pool):
        # Two scatters over disjoint real pages: decode rows write their
        # private pages, the chunk positions >= chunk_start of its table.
        k0 = k[0].to(k_pool.dtype)
        v0 = v[0].to(v_pool.dtype)
        k_pool[pages_dec, offs_dec] = k0[:b]
        v_pool[pages_dec, offs_dec] = v0[:b]
        k_pool[pages_ch, offs_ch] = k0[b:]
        v_pool[pages_ch, offs_ch] = v0[b:]
        attn_dec, attn_ch = _attn_paged(
            cfg, q[0, :b].contiguous(), q[0, b:].contiguous(), k_pool, v_pool,
            cache.page_table, attn_len, chunk_table=chunk_table,
            chunk_start=int(chunk_start), groups=gargs, mesh=mesh,
        )
        return torch.cat([attn_dec, attn_ch])[None]  # [1, B+C, H, D]

    x = _paged_layers(cfg, params, x, cos, sin, cache, attend, mesh)
    logits = _unembed(cfg, params, x[0, :b], mesh)
    cache.length.copy_(valid)
    return logits, x[:, b:], cache


@torch.inference_mode()
def unembed_one(cfg: ModelConfig, params: dict, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """Logits [V] float32 for ONE hidden state [D] — the final-chunk
    unembed of the chunked-prefill path (a D x V matvec, not C x V); on a
    mesh gathered over ``model``."""
    return _unembed(cfg, params, h[None], mesh)[0]
