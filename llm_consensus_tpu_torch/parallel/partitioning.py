"""How every parameter and cache array maps onto the mesh.

Counterpart of ``llm_consensus_tpu.parallel.partitioning``, with the same
rules (copied verbatim below). JAX places a whole tree with
``device_put`` and lets GSPMD insert the collectives; here each rank
holds its own contiguous slice of every leaf (:func:`shard_params`) and
the model code makes the collectives explicit
(:mod:`llm_consensus_tpu_torch.models.transformer`).

Tensor-parallel layout (Megatron): q/k/v projections and their biases
column-split over ``model`` (a contiguous split of heads keeps GQA's
``h // G`` mapping inside each shard); ``wo`` row-split (followed by a
sum over ``model``); MLP gate/up column-split, down row-split (a sum);
``lm_head`` split over the vocabulary (logits gathered over ``model``).
The paged KV pool splits its pages over ``data`` and its kv heads over
``model``; decode rows and their tables split over ``data``.

A spec is a tuple with one entry per dimension: an axis name or None
(replicated), as a ``PartitionSpec``'s entries. int8
:class:`~llm_consensus_tpu_torch.ops.quant.QuantizedTensor` leaves shard
``q`` by the rule; their ``scale`` [L, 1, N] follows it on N and
replicates its size-1 axis (the size-1 rule). Packed int4 leaves cannot
be split over ``model`` yet: the packed layout holds logical rows r and
r + K/2 in one byte (``ops/quant.py``), so a row split of ``wo`` or
``w_down`` is not a split of the packed rows and needs a repack per
shard, a later slice's work. MoE trees have their specs (the JAX
package's, experts over ``expert``) for capacity planning
(:func:`sharded_param_bytes`); :func:`shard_params` refuses them: MoE on a
mesh is a later slice's work.
"""

from __future__ import annotations

import math

from llm_consensus_tpu_torch.ops.quant import Quantized4Tensor, QuantizedTensor

# Rules keyed by param-leaf name, for the ``init_params`` tree
# (llm_consensus_tpu_torch.models.transformer). Dense block weights:
_DENSE_RULES: dict[str, tuple] = {
    "embed": (None, None),  # gather table; replicate (V small vs FLOPs)
    "norm_f": (None,),
    "lm_head": (None, "model"),  # vocab-sharded logits
    "attn_norm": (None, None),
    "mlp_norm": (None, None),
    "wq": (None, None, "model"),
    "wk": (None, None, "model"),
    "wv": (None, None, "model"),
    "wo": (None, "model", None),
    "bq": (None, "model"),
    "bk": (None, "model"),
    "bv": (None, "model"),
    "w_gate": (None, None, "model"),
    "w_up": (None, None, "model"),
    "w_down": (None, "model", None),
}
# MoE block weights override (leading expert axis after the layer axis).
_MOE_RULES: dict[str, tuple] = {
    "router": (None, None, None),
    "w_gate": (None, "expert", None, "model"),
    "w_up": (None, "expert", None, "model"),
    "w_down": (None, "expert", "model", None),
}


def _rule(name: str, shape) -> tuple:
    ndim = len(shape)
    if name in _MOE_RULES and ndim == len(_MOE_RULES[name]):
        spec = _MOE_RULES[name]
    elif name in _DENSE_RULES:
        spec = _DENSE_RULES[name]
    else:
        raise ValueError(f"no sharding rule for param {name!r}")
    if ndim != len(spec):
        raise ValueError(f"param {name!r} rank {ndim} != rule rank {len(spec)}")
    # Size-1 axes replicate: int8 scale tensors (ops/quant.py) keep
    # the contraction dim as size 1 and would otherwise inherit a
    # sharded spec on an unsplittable axis.
    return tuple(None if shape[i] == 1 else spec[i] for i in range(len(spec)))


def _map(fn, node, name=None):
    """``fn(name, leaf)`` over a parameter tree; a quantized leaf maps its
    ``q`` and ``scale`` under the leaf's name, into the same type."""
    if isinstance(node, dict):
        return {k: _map(fn, v, k) for k, v in node.items()}
    if isinstance(node, (QuantizedTensor, Quantized4Tensor)):
        return type(node)(q=fn(name, node.q), scale=fn(name, node.scale))
    return fn(name, node)


def param_pspecs(params) -> dict:
    """The spec tree mirroring an ``init_params`` tree, leaf for leaf (a
    quantized leaf's ``q`` and ``scale`` each get their own)."""
    return _map(lambda name, leaf: _rule(name, tuple(leaf.shape)), params)


def _refuse_int4(params, mesh_shape: dict) -> None:
    if mesh_shape.get("model", 1) <= 1:
        return

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, Quantized4Tensor):
            raise NotImplementedError(
                "int4 weights on a mesh with model > 1: the packed layout "
                "holds logical rows r and r + K/2 in one byte, so a row split "
                "of wo/w_down over model needs a repack per shard (a later "
                "slice)"
            )

    walk(params)


def _divisor(spec: tuple, mesh_shape: dict) -> int:
    return math.prod(int(mesh_shape.get(ax, 1)) for ax in spec if ax is not None)


def shard_params(params, mesh):
    """This rank's shard of a parameter tree: each leaf cut to the
    contiguous block its spec and ``mesh.coords`` name (replicated axes
    keep their full size), made contiguous, on ``mesh.device``. Raises
    on a dimension the axis does not divide, on int4 leaves when
    ``model`` > 1, and on MoE trees."""
    shape = mesh.shape
    _refuse_int4(params, shape)
    if "router" in params["blocks"]:
        raise NotImplementedError("MoE trees on a mesh are not ported to PyTorch yet")
    coords = mesh.coords

    def cut(name, leaf):
        spec = _rule(name, tuple(leaf.shape))
        out = leaf
        for dim, ax in enumerate(spec):
            n = int(shape.get(ax, 1)) if ax is not None else 1
            if n == 1:
                continue
            size = leaf.shape[dim]
            if size % n:
                raise ValueError(
                    f"param {name!r} dim {dim} of size {size} does not split "
                    f"over {ax}={n}"
                )
            width = size // n
            out = out.narrow(dim, coords[ax] * width, width)
        return out.contiguous().to(mesh.device)

    return _map(cut, params)


def sharded_param_bytes(tree, mesh_shape: dict) -> int:
    """Per-rank resident bytes of a param tree under these rules: each
    leaf's bytes divided by the product of the mesh-axis sizes its spec
    names (replicated leaves count in full). Takes real or ``meta``
    tensors (capacity planning without allocation). int4 on ``model`` > 1
    raises, as :func:`shard_params` does."""
    _refuse_int4(tree, mesh_shape)
    total = 0

    def add(name, leaf):
        nonlocal total
        spec = _rule(name, tuple(leaf.shape))
        total += leaf.numel() * leaf.element_size() // max(_divisor(spec, mesh_shape), 1)
        return leaf

    _map(add, tree)
    return total


def cache_pspecs() -> dict:
    """Specs of the paged KV pool: pages over ``data``, kv heads over
    ``model``; tables and lengths row-split over ``data``."""
    return {
        "k": (None, "data", None, "model", None),
        "v": (None, "data", None, "model", None),
        "page_table": ("data", None),
        "length": ("data",),
    }


def batch_pspec() -> tuple:
    """Token/length batches split their leading axis over ``data``."""
    return ("data",)
