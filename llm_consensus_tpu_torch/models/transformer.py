"""Pre-norm GQA transformer (Llama/Mistral/Qwen2/Mixtral family) in PyTorch.

Counterpart of ``llm_consensus_tpu.models.transformer`` with bf16, int8
or int4 weights and a bf16 or int8 KV cache: the same parameter tree
(layers stacked on a leading axis, MoE expert stacks on a second one,
quantized leaves as
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
- A sliding-window config (Mistral) takes the plain attention ops
  wherever the JAX package routes it around its kernels: prefill,
  decode and the shared-prefix fan-out; the paged steps pass the window
  to K8.
- MoE (Mixtral) runs the JAX package's two paths: the dense all-experts
  path (``moe_dense_at``) and the capacity-bounded GShard dispatch, the
  latter in an index form (a scatter and a gather instead of dense
  ``[T, E, C]`` masks: the same sums). Expert weights are dequantized a
  layer at a time, as the JAX package's ``_w`` does.

Ring attention and the speculative verify step are not ported yet:
:func:`_check_supported` raises on ``use_ring``, and the paged steps
refuse MoE configs (:func:`check_paged_supported`).

Entry points: :func:`forward` (logits for every position),
:func:`prefill` (fill the cache from right-padded prompts, last-token
logits), :func:`decode_step` (one token against the cache),
:func:`decode_chunk` (K tokens a row against the cache) and
:func:`prefill_chunked` (prefill in fixed-size chunks); for the
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
import torch.nn.functional as F

from llm_consensus_tpu_torch.models.cache import KVCache, QuantKVCache, quantize_kv
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.models.paged_cache import NULL_PAGE, PagedKVCache
from llm_consensus_tpu_torch.ops import kernels
from llm_consensus_tpu_torch.ops.activations import swiglu
from llm_consensus_tpu_torch.ops.attention import (
    _dequantize_kv,
    causal_attention,
    chunk_decode_attention,
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
    quant_axis,
    quantize_tensor,
    quantize_tensor4,
)
from llm_consensus_tpu_torch.ops.kernels.quant_matmul import unpack4
from llm_consensus_tpu_torch.ops.quant import matmul as _qmm
from llm_consensus_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from llm_consensus_tpu_torch.utils.device import resolve_device, to_device


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.use_ring:
        raise NotImplementedError(
            f"{cfg.name}: ring attention is not ported to PyTorch yet"
        )


def check_paged_supported(cfg: ModelConfig) -> None:
    """The paged (serving) steps' refusals: ring attention, and MoE,
    whose per-side MLP of the fused step is not ported yet."""
    _check_supported(cfg)
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE on the paged serving steps is not ported to "
            "PyTorch yet"
        )


def _rms(cfg: ModelConfig, x, w):
    if cfg.use_pallas:
        return kernels.fused_rms_norm(x, w, cfg.rms_norm_eps)
    return rms_norm(x, w, cfg.rms_norm_eps)


def _attn_causal(cfg: ModelConfig, q, k, v, positions):
    # The kernel implements index-causal masking; explicit positions and
    # sliding windows use the plain path.
    if cfg.use_pallas and positions is None and cfg.sliding_window == 0:
        return kernels.flash_causal_attention(q, k, v)
    return causal_attention(q, k, v, positions, window=cfg.sliding_window)


def _attn_decode(cfg: ModelConfig, q, k_cache, v_cache, valid_len, shared_prefix_len=None):
    """``shared_prefix_len`` (int or None): every row's cache slots
    [0, shared_prefix_len) hold the same K/V (the shared-prefill fan-out),
    so the kernel reads that region once for the whole batch. Engages on
    the kernel path of a config without a sliding window only; the plain
    path reads every row (same outputs)."""
    if cfg.use_pallas and cfg.sliding_window == 0:
        if shared_prefix_len is not None:
            return kernels.flash_decode_attention_shared_prefix(
                q, k_cache, v_cache, valid_len, shared_prefix_len
            )
        return kernels.flash_decode_attention(q, k_cache, v_cache, valid_len)
    return decode_attention(q, k_cache, v_cache, valid_len, window=cfg.sliding_window)


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
    path; the plain path (and any config with a sliding window)
    dequantizes and reads every row (same outputs)."""
    if cfg.use_pallas and cfg.sliding_window == 0:
        if shared_prefix_len is not None:
            return kernels.flash_decode_attention_shared_prefix_q8(
                q, k_q, k_s, v_q, v_s, valid_len, shared_prefix_len
            )
        return kernels.flash_decode_attention_q8(q, k_q, k_s, v_q, v_s, valid_len)
    return decode_attention_quant(
        q, k_q, k_s, v_q, v_s, valid_len, window=cfg.sliding_window
    )


def _attn_decode_quant_stacked(cfg: ModelConfig, q, k_q, k_s, v_q, v_s, valid_len,
                               layer: int, shared_prefix_len=None):
    """As :func:`_attn_decode_quant`, given the whole stacked cache
    [L, B, Hkv, S, D] and the layer index."""
    if cfg.use_pallas and cfg.sliding_window == 0:
        if shared_prefix_len is not None:
            return kernels.flash_decode_attention_shared_prefix_q8_stacked(
                q, k_q, k_s, v_q, v_s, valid_len, shared_prefix_len, layer
            )
        return kernels.flash_decode_attention_q8_stacked(
            q, k_q, k_s, v_q, v_s, valid_len, layer
        )
    return decode_attention_quant(
        q, k_q[layer], k_s[layer], v_q[layer], v_s[layer], valid_len,
        window=cfg.sliding_window,
    )


# ---------------------------------------------------------------------------
# Init and parameter conversion
# ---------------------------------------------------------------------------


def _param_layout(cfg: ModelConfig) -> list[tuple[tuple[str, ...], tuple, tuple]]:
    """(path, shape, init) of every leaf of the ``init_params`` tree, in
    the JAX package's draw order; ``init`` is ("normal", scale),
    ("ones",) or ("zeros",)."""
    L, D, H, Hkv, F_, V = (
        cfg.n_layers,
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads,
        cfg.d_ff,
        cfg.vocab_size,
    )
    Dh = cfg.head_dim
    normal, resid = ("normal", 0.02), ("normal", 0.02 / math.sqrt(2 * L))
    out = [
        (("blocks", "attn_norm"), (L, D), ("ones",)),
        (("blocks", "mlp_norm"), (L, D), ("ones",)),
        (("blocks", "wq"), (L, D, H * Dh), normal),
        (("blocks", "wk"), (L, D, Hkv * Dh), normal),
        (("blocks", "wv"), (L, D, Hkv * Dh), normal),
        (("blocks", "wo"), (L, H * Dh, D), resid),
    ]
    if cfg.qkv_bias:
        out += [
            (("blocks", "bq"), (L, H * Dh), ("zeros",)),
            (("blocks", "bk"), (L, Hkv * Dh), ("zeros",)),
            (("blocks", "bv"), (L, Hkv * Dh), ("zeros",)),
        ]
    if cfg.is_moe:
        E = cfg.n_experts
        out += [
            (("blocks", "router"), (L, D, E), normal),
            (("blocks", "w_gate"), (L, E, D, F_), normal),
            (("blocks", "w_up"), (L, E, D, F_), normal),
            (("blocks", "w_down"), (L, E, F_, D), resid),
        ]
    else:
        out += [
            (("blocks", "w_gate"), (L, D, F_), normal),
            (("blocks", "w_up"), (L, D, F_), normal),
            (("blocks", "w_down"), (L, F_, D), resid),
        ]
    out += [(("embed",), (V, D), normal), (("norm_f",), (D,), ("ones",))]
    if not cfg.tie_embeddings:
        out.append((("lm_head",), (D, V), normal))
    return out


def _put(tree: dict, path: tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _generator(generator, dev: torch.device):
    if isinstance(generator, int):
        return torch.Generator(device=dev).manual_seed(generator)
    return generator


def _draw_leaf(shape, init, generator, dev: torch.device, dtype) -> torch.Tensor:
    """One leaf by its ``init`` rule (see :func:`_param_layout`): a
    float32 normal draw scaled and cast to ``dtype``, or ones/zeros."""
    if init[0] == "normal":
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * init[1]).to(dtype)
    return torch.full(shape, 1.0 if init[0] == "ones" else 0.0, dtype=dtype, device=dev)


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | int = 0,
    dtype=torch.bfloat16,
    device: str | torch.device | None = None,
) -> dict:
    """Random-init parameters with the JAX package's scheme: normal(0,
    0.02), residual projections scaled by 1/sqrt(2*n_layers), norms ones,
    biases zeros, drawn in the same order (MoE: a router and expert
    stacks [L, E, ...] in place of the dense MLP). ``generator``: a
    ``torch.Generator`` on ``device``, or an int seed for one. The
    numbers differ from the JAX package's for the same seed (another
    generator); carry JAX weights over with :func:`params_from_jax`.
    ``device="meta"`` gives the tree's shapes and types and allocates
    nothing (the capacity planner's use; ``generator`` is unused)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    if not meta:
        generator = _generator(generator, dev)
    params: dict = {}
    for path, shape, init in _param_layout(cfg):
        if meta:
            leaf = torch.empty(shape, dtype=dtype, device=dev)
        else:
            leaf = _draw_leaf(shape, init, generator, dev, dtype)
        _put(params, path, leaf)
    return params


def init_params_quantized(
    cfg: ModelConfig,
    generator: torch.Generator | int = 0,
    *,
    bits: int = 8,
    dtype=torch.bfloat16,
    device: str | torch.device | None = None,
) -> dict:
    """Random init straight into quantized leaves (``bits`` 8 or 4) on
    ``device``: every leaf that :func:`~llm_consensus_tpu_torch.ops.quant.
    quantize_params` quantizes is drawn one matrix at a time (one layer's
    ``[K, N]``, or one expert's of an MoE stack), cast to ``dtype`` and
    quantized there, so the device holds the quantized tree plus one
    matrix in flight, never the full-width tree (mixtral-8x7b's
    ``w_gate`` alone is 60 GB as a float32 draw). The other leaves are
    drawn as :func:`init_params` draws them. ``generator``: a generator
    on ``device`` or an int seed for one. The values differ from
    quantizing an :func:`init_params` tree of the same seed (another
    draw order); parity tests carry JAX weights over with
    :func:`params_from_jax` instead."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    dev = resolve_device(device)
    generator = _generator(generator, dev)
    qfn = quantize_tensor if bits == 8 else quantize_tensor4
    params: dict = {}
    for path, shape, init in _param_layout(cfg):
        if path == ("lm_head",):
            axis = 0
        elif path[0] == "blocks":
            axis = quant_axis(path[1], len(shape))
        else:
            axis = None
        if axis is None:
            _put(params, path, _draw_leaf(shape, init, generator, dev, dtype))
            continue
        # Matrices [..., K, N]; the contraction axis is always -2.
        lead, (k, n) = shape[:-2], shape[-2:]
        q_rows = k if bits == 8 else k // 2
        q = torch.empty((*lead, q_rows, n), dtype=torch.int8, device=dev)
        scale = torch.empty((*lead, 1, n), dtype=torch.float32, device=dev)
        for idx in np.ndindex(*lead):
            leaf = qfn(_draw_leaf((k, n), init, generator, dev, dtype), 0)
            q[idx] = leaf.q
            scale[idx] = leaf.scale
            del leaf
        cls = QuantizedTensor if bits == 8 else Quantized4Tensor
        _put(params, path, cls(q=q, scale=scale))
    return params


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


def moe_router_aux(
    cfg: ModelConfig, router_logits: torch.Tensor, top_idx: torch.Tensor
) -> dict:
    """Router auxiliary losses for MoE training (the JAX package's).

    router_logits: [..., E] pre-softmax; top_idx: [..., k] chosen experts.
    Returns {"load_balance", "z_loss"} float32 scalars: load_balance is
    ``E * sum_e f_e * P_e`` (f_e the fraction of (token, choice)
    assignments routed to expert e, P_e its mean router probability; 1.0
    under uniform routing), z_loss is ``mean(logsumexp(logits)^2)``.
    """
    e = cfg.n_experts
    logits2 = router_logits.reshape(-1, e).float()
    p_e = torch.softmax(logits2, dim=-1).mean(dim=0)
    f_e = F.one_hot(top_idx.reshape(-1).long(), e).float().mean(dim=0)
    return {
        "load_balance": e * torch.sum(f_e * p_e),
        "z_loss": torch.mean(torch.logsumexp(logits2, dim=-1) ** 2),
    }


def _zero_aux(device) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": zero, "z_loss": zero}


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``'s choice and order: the k largest, descending,
    the lower index first among equal values (``torch.topk`` promises no
    order on ties; a stable sort keeps the index order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Router logits [T, E] float32, top-k experts [T, k] and their
    softmax weights [T, k] for tokens x [T, D]."""
    router_logits = (x @ p["router"]).float()
    top_vals, top_idx = _top_k(router_logits, cfg.n_experts_per_token)
    return router_logits, top_idx, torch.softmax(top_vals, dim=-1)


def _expert_weight(leaf, dtype):
    """An expert stack in the activations' ``dtype``: the JAX package's
    ``_w``, which dequantizes a quantized leaf into bf16 (q times the
    scale, both cast to bf16). For float32 activations that bf16 weight is
    promoted, and XLA's compiled program drops the product's bf16 rounding
    (q times the bf16 scale, in float32); that is what the float32 model
    computes here, so it matches the JAX package as it runs."""
    if not isinstance(leaf, QUANT_LEAVES):
        return leaf.to(dtype)
    q = leaf.q if isinstance(leaf, QuantizedTensor) else unpack4(leaf.q, torch.int8)
    if dtype == torch.bfloat16:
        # One pass: int8 times the bf16 scale, rounded once to bf16 (the
        # bits of bf16(q) * bf16(scale): q is exact in bf16).
        return q * leaf.scale.to(torch.bfloat16)
    return (q.float() * leaf.scale.to(torch.bfloat16).float()).to(dtype)


def _experts(p: dict, dtype):
    """A layer's expert stacks [E, D, F] / [E, F, D] (see
    :func:`_expert_weight`)."""
    return tuple(_expert_weight(p[name], dtype) for name in ("w_gate", "w_up", "w_down"))


def _mlp(cfg: ModelConfig, p: dict, h: torch.Tensor, collect_aux: bool = False):
    """The block's MLP: SwiGLU, or for an MoE config the dense
    all-experts path (at most ``moe_dense_decode_tokens`` tokens, or no
    capacity factor: every expert on every token, combined with the top-k
    router weights) or :func:`_moe_dispatch`. ``collect_aux``: also
    return the router's :func:`moe_router_aux` (zeros for a dense
    model)."""
    if not cfg.is_moe:
        y = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        return (y, _zero_aux(h.device)) if collect_aux else y
    d = h.shape[-1]
    if not cfg.moe_dense_at(h.numel() // d):
        return _moe_dispatch(cfg, p, h, collect_aux=collect_aux)
    x = h.reshape(-1, d)
    router_logits, top_idx, top_w = _route(cfg, p, x)
    # Combine weights scattered back over the expert axis: [T, E].
    combine = (F.one_hot(top_idx, cfg.n_experts).float() * top_w[..., None]).sum(dim=-2)
    w_gate, w_up, w_down = _experts(p, h.dtype)
    gate = F.silu(torch.matmul(x, w_gate))  # [E, T, F]
    up = torch.matmul(x, w_up)
    expert_out = torch.matmul(gate * up, w_down)  # [E, T, D]
    y = torch.einsum("etd,te->td", expert_out, combine.to(expert_out.dtype))
    y = y.reshape(h.shape)
    if collect_aux:
        return y, moe_router_aux(cfg, router_logits, top_idx)
    return y


def _moe_dispatch(cfg: ModelConfig, p: dict, h: torch.Tensor, collect_aux: bool = False):
    """GShard/Switch capacity-bounded expert dispatch (the JAX package's
    ``_moe_dispatch``): each expert computes only the tokens routed to
    it, packed into a fixed-capacity [E, C, D] buffer, C = ceil(T * k /
    E * capacity_factor). A (choice rank, token) pair's queue position in
    its expert is rank-major and first-come (first choices take priority
    when capacity binds); pairs past an expert's capacity are dropped
    (that expert contributes nothing to the token).

    The JAX package builds dense [T, E, C] float32 masks and contracts
    them; here the same sums run as an index scatter into the buffer (each
    slot receives one token row, exactly) and a gather of each token's k
    outputs, weighted and summed in float32 in rank order (k terms, the
    same as the masks' contraction up to the order of a float32 sum).
    """
    shape = h.shape
    d = shape[-1]
    x = h.reshape(-1, d)
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_per_token
    cap = -(-t * k * cfg.moe_capacity_factor // e)
    cap = int(min(max(cap, 1), t * k))
    router_logits, top_idx, top_w = _route(cfg, p, x)

    counts = torch.zeros((e,), dtype=torch.int64, device=x.device)
    slots, keep = [], []
    for r in range(k):
        oh = F.one_hot(top_idx[:, r], e)  # [T, E]
        pos = (torch.cumsum(oh, dim=0) - oh + counts).gather(1, top_idx[:, r:r + 1])[:, 0]
        keep.append(pos < cap)
        slots.append(top_idx[:, r] * cap + torch.clamp(pos, max=cap - 1))
        counts = counts + oh.sum(dim=0)
    slots = torch.stack(slots, dim=1)  # [T, k] flat (expert, position)
    keep = torch.stack(keep, dim=1)  # [T, k]

    # Dropped pairs write into one spare row past the buffer's end.
    dest = torch.where(keep, slots, e * cap)
    xin = torch.zeros((e * cap + 1, d), dtype=h.dtype, device=x.device)
    xin.index_put_((dest.reshape(-1),), x[:, None].expand(t, k, d).reshape(-1, d))
    xin = xin[: e * cap].reshape(e, cap, d)
    w_gate, w_up, w_down = _experts(p, h.dtype)
    gate = F.silu(torch.bmm(xin, w_gate))
    up = torch.bmm(xin, w_up)
    out_e = torch.bmm(gate * up, w_down).reshape(e * cap, d).float()
    weight = torch.where(keep, top_w, 0.0)  # [T, k]
    y = out_e[slots[:, 0]] * weight[:, :1]
    for r in range(1, k):
        y = y + out_e[slots[:, r]] * weight[:, r:r + 1]
    y = y.to(h.dtype).reshape(shape)
    if collect_aux:
        return y, moe_router_aux(cfg, router_logits, top_idx)
    return y


def _write_chunk(buf: torch.Tensor, vals: torch.Tensor, valid_len: torch.Tensor,
                 head_major: bool) -> None:
    """Write K tokens a row, vals [B, K, Hkv, ...], at cache slots
    [valid_len, valid_len + K) of buf ([B, S, Hkv, ...] token-major or
    [B, Hkv, S, ...] head-major). Slots past the cache are dropped, as
    the JAX package's scatter drops them (a chunk padded past the
    cache's end)."""
    b, kq = vals.shape[:2]
    s = buf.shape[2] if head_major else buf.shape[1]
    pos = valid_len.long()[:, None] + torch.arange(kq, device=vals.device)[None, :]
    ok = pos < s
    rows = torch.arange(b, device=vals.device)[:, None].expand(b, kq)[ok]
    if head_major:
        buf[rows, :, pos[ok]] = vals[ok].to(buf.dtype)
    else:
        buf[rows, pos[ok]] = vals[ok].to(buf.dtype)


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
    collect_aux: bool = False,
):
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
    Mode ``chunk`` (K tokens a row, :func:`decode_chunk`): writes them at
    slots [valid_len, valid_len + K) and attends ragged-causally over the
    cache through the plain ``chunk_decode_attention`` (the int8 cache
    written quantized, read through a dequantized copy), as the JAX
    package does. ``collect_aux`` (mode ``full``): also return the MLP's
    router aux losses.
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
    elif mode == "chunk":
        window = cfg.sliding_window
        if len(kv_layer) == 2:
            k_l, v_l = kv_layer
            _write_chunk(k_l, k, valid_len, head_major=False)
            _write_chunk(v_l, v, valid_len, head_major=False)
            attn = chunk_decode_attention(q, k_l, v_l, valid_len, window=window)
        else:
            kq_l, vq_l, ks_l, vs_l = kv_layer
            kqn, ksn = quantize_kv(k)  # [B, K, Hkv, D] / [B, K, Hkv]
            vqn, vsn = quantize_kv(v)
            _write_chunk(kq_l, kqn, valid_len, head_major=True)
            _write_chunk(vq_l, vqn, valid_len, head_major=True)
            _write_chunk(ks_l, ksn, valid_len, head_major=True)
            _write_chunk(vs_l, vsn, valid_len, head_major=True)
            attn = chunk_decode_attention(
                q, _dequantize_kv(kq_l, ks_l, q.dtype),
                _dequantize_kv(vq_l, vs_l, q.dtype), valid_len, window=window,
            )
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
    if collect_aux:
        y, aux = _mlp(cfg, p, h2, collect_aux=True)
        return x + y, aux
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
    collect_aux: bool = False,
):
    """The layer loop; ``collect_aux`` (mode ``full``): returns (x, the
    MLPs' router aux losses averaged over layers)."""
    blocks = params["blocks"]
    bufs = () if cache is None else cache.leaves
    stacked_decode = _STACKED_DECODE and mode == "decode" and len(bufs) == 4
    auxes = []
    for layer in range(cfg.n_layers):
        p = _layer_params(blocks, layer)
        kv_layer = tuple(t[layer] for t in bufs) or None
        x = _block(
            cfg, p, x, cos, sin, kv_layer, mode, valid_len, positions,
            uniform_write=uniform_write, shared_prefix_len=shared_prefix_len,
            stacked=(bufs, layer) if stacked_decode else None,
            collect_aux=collect_aux,
        )
        if collect_aux:
            x, aux = x
            auxes.append(aux)
    if collect_aux:
        return x, {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
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
    return_moe_aux: bool = False,
):
    """Full causal forward: tokens [B, S] -> logits [B, S, V] (float32).
    ``return_moe_aux``: also return the layer-averaged MoE router aux
    losses ({"load_balance", "z_loss"}, zeros for a dense model)."""
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
    out = _run_layers(cfg, params, x, cos, sin, None, "full", None, positions,
                      collect_aux=return_moe_aux)
    if return_moe_aux:
        x, aux = out
        return _unembed(cfg, params, x), aux
    return _unembed(cfg, params, out)


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


@torch.inference_mode()
def decode_chunk(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    cache: KVCache | QuantKVCache,
) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """Score K tokens a row against the cache in one forward.

    tokens: [B, K]. Token (b, i) sits at position ``cache.length[b] + i``
    and attends everything before it plus the chunk before it (ragged
    causal; a sliding window masks as :func:`decode_step` does). Returns
    (logits [B, K, V] float32, the cache with the K tokens' K/V written in
    place). ``cache.length`` is not advanced: the caller sets it (the
    tokens past what it keeps stay as masked-out slots, like prefill
    padding).
    """
    x, cache = _chunk_hidden(cfg, params, tokens, cache)
    return _unembed(cfg, params, x), cache


def _chunk_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache):
    """:func:`decode_chunk` without the unembed: ([B, K, D] hidden, cache),
    for callers that keep only a few positions' logits."""
    _check_supported(cfg)
    kq = tokens.shape[1]
    x = params["embed"][tokens]  # [B, K, D]
    positions = cache.length[:, None] + torch.arange(
        kq, dtype=cache.length.dtype, device=tokens.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    x = _run_layers(cfg, params, x, cos, sin, cache, "chunk", cache.length, None)
    return x, cache


@torch.inference_mode()
def prefill_chunked(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    cache: KVCache | QuantKVCache,
    chunk: int = 512,
) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """Prefill in fixed-size chunks: bounded activation memory.

    The prompt [B, S] runs as ``ceil(S / chunk)`` :func:`decode_chunk`
    passes (each chunk attends the cache so far plus itself), writing the
    same cache as :func:`prefill`; the contract is :func:`prefill`'s
    (last-valid-token logits [B, V] float32, the cache with length
    ``lengths``). An MoE config's dispatch path is pinned to the one a
    one-shot prefill of the whole prompt takes (``moe_pin_for``), as in
    the JAX package.
    """
    b, s = tokens.shape
    cfg = cfg.moe_pin_for(b * s, b * chunk)
    if s % chunk:
        pad = chunk - s % chunk
        tokens = F.pad(tokens, (0, pad))
        s += pad
    cache = cache.with_length(torch.zeros((b,), dtype=torch.int32, device=tokens.device))
    last = torch.clamp(lengths.long() - 1, 0, s - 1)
    rows = torch.arange(b, device=tokens.device)
    x_last = torch.zeros((b, cfg.d_model), dtype=torch.float32, device=tokens.device)
    for c0 in range(0, s, chunk):
        hidden, cache = _chunk_hidden(cfg, params, tokens[:, c0:c0 + chunk], cache)
        cache = cache.with_length(cache.length + chunk)
        # Keep each row's last valid hidden state; one unembed at the end.
        in_chunk = (last >= c0) & (last < c0 + chunk)
        got = hidden[rows, torch.clamp(last - c0, 0, chunk - 1)]
        x_last = torch.where(in_chunk[:, None], got.float(), x_last)
    logits = _unembed(cfg, params, x_last.to(hidden.dtype))
    return logits, cache.with_length(lengths.to(torch.int32))


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
    check_paged_supported(cfg)
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
    check_paged_supported(cfg)
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
    check_paged_supported(cfg)
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
