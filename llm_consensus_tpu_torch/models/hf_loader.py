"""Load HuggingFace safetensors checkpoints into the stacked param tree.

Counterpart of ``llm_consensus_tpu.models.hf_loader``: Llama, Mistral,
Qwen2 and Mixtral layouts into :mod:`llm_consensus_tpu_torch.models.
transformer`'s tree.

- HF stores one ``[out, in]`` Linear weight per layer and projection; the
  tree holds ``[in, out]`` matmul weights stacked on a leading layer axis
  (Mixtral's experts on a second one), so each projection is transposed
  and the per-layer tensors stacked.
- HF RoPE uses the rotate-half convention, as :mod:`llm_consensus_tpu_torch.
  ops.rope` does: the weights map 1:1.
- The safetensors format is read directly (an 8-byte little-endian header
  length, a JSON header of names, dtypes, shapes and byte offsets, then
  the raw little-endian bytes), through a read-only memory map per shard:
  neither importing this module nor loading needs the ``safetensors``
  package. Each stacked leaf is assembled on the host, cast to the target
  type and moved to the device before the next, so the host holds about
  one leaf at a time besides the mapped shards.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from llm_consensus_tpu_torch.models.configs import ModelConfig, RopeScaling
from llm_consensus_tpu_torch.utils.device import resolve_device

# name templates: ours -> HF (dense). {i} = layer index.
_DENSE_MAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "bq": "model.layers.{i}.self_attn.q_proj.bias",
    "bk": "model.layers.{i}.self_attn.k_proj.bias",
    "bv": "model.layers.{i}.self_attn.v_proj.bias",
    "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
    "w_up": "model.layers.{i}.mlp.up_proj.weight",
    "w_down": "model.layers.{i}.mlp.down_proj.weight",
}
_MOE_MAP = {
    "router": "model.layers.{i}.block_sparse_moe.gate.weight",
    # experts get an extra {e} axis; HF w1 = gate, w3 = up, w2 = down.
    "w_gate": "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
    "w_up": "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
    "w_down": "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
}
# Linear weights stored [out, in]; transposed to [in, out].
_TRANSPOSED = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router", "lm_head",
}
# safetensors dtype names -> torch types.
_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


class _SafetensorsFile:
    """One .safetensors file: its header, and tensors read through a
    read-only memory map."""

    def __init__(self, path: Path):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header: dict = header
        self._base = 8 + n
        self._map = None

    def get(self, name: str) -> torch.Tensor:
        if self._map is None:
            self._map = np.memmap(self.path, dtype=np.uint8, mode="r")
        info = self.header[name]
        begin, end = info["data_offsets"]
        raw = np.array(self._map[self._base + begin : self._base + end])
        return torch.from_numpy(raw).view(_DTYPES[info["dtype"]]).reshape(info["shape"])

    def close(self) -> None:
        self._map = None


class _ShardedCheckpoint:
    """Random access over the .safetensors files of a directory."""

    def __init__(self, path: Path):
        files = sorted(path.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors under {path}")
        self._files = [_SafetensorsFile(f) for f in files]
        self._name_to_file = {
            name: f for f in self._files for name in f.header
        }

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_file

    def get(self, name: str) -> torch.Tensor:
        return self._name_to_file[name].get(name)

    def close(self) -> None:
        for f in self._files:
            f.close()


def load_hf_params(
    cfg: ModelConfig,
    path: str | Path,
    dtype=torch.bfloat16,
    device: str | torch.device | None = None,
) -> dict:
    """An ``init_params``-shaped tree from the HF checkpoint directory
    ``path``, in ``dtype`` on ``device`` (the card unless the caller asks
    for the CPU). ``cfg`` must match the checkpoint (layer count, widths,
    MoE, qkv bias); a missing tensor raises ``KeyError`` naming it, a
    shape that disagrees raises ``ValueError``."""
    dev = resolve_device(device)
    ckpt = _ShardedCheckpoint(Path(path))
    try:
        return _load_hf_params(cfg, ckpt, dtype, dev)
    finally:
        ckpt.close()


def _load_hf_params(cfg: ModelConfig, ckpt: _ShardedCheckpoint, dtype, dev) -> dict:
    def fetch(name: str, ours: str) -> torch.Tensor:
        if name not in ckpt:
            raise KeyError(f"checkpoint missing {name!r} (for param {ours!r})")
        t = ckpt.get(name).to(dtype)
        return t.T if ours in _TRANSPOSED else t

    def leaf(ours: str, template: str, experts: bool = False) -> torch.Tensor:
        layers = []
        for i in range(cfg.n_layers):
            if experts:
                layers.append(torch.stack([
                    fetch(template.format(i=i, e=e), ours) for e in range(cfg.n_experts)
                ]))
            else:
                layers.append(fetch(template.format(i=i), ours))
        return torch.stack(layers).to(dev)

    blocks: dict = {}
    for ours in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo"):
        blocks[ours] = leaf(ours, _DENSE_MAP[ours])
    if cfg.qkv_bias:
        for ours in ("bq", "bk", "bv"):
            blocks[ours] = leaf(ours, _DENSE_MAP[ours])
    if cfg.is_moe:
        blocks["router"] = leaf("router", _MOE_MAP["router"])
        for ours in ("w_gate", "w_up", "w_down"):
            blocks[ours] = leaf(ours, _MOE_MAP[ours], experts=True)
    else:
        for ours in ("w_gate", "w_up", "w_down"):
            blocks[ours] = leaf(ours, _DENSE_MAP[ours])

    params: dict = {
        "embed": fetch("model.embed_tokens.weight", "embed").to(dev),
        "blocks": blocks,
        "norm_f": fetch("model.norm.weight", "norm_f").to(dev),
    }
    if "lm_head.weight" in ckpt:
        if cfg.tie_embeddings:
            raise ValueError("checkpoint has lm_head.weight but cfg.tie_embeddings=True")
        params["lm_head"] = fetch("lm_head.weight", "lm_head").contiguous().to(dev)
    elif not cfg.tie_embeddings:
        raise ValueError("checkpoint has no lm_head.weight; set cfg.tie_embeddings=True")
    for name, t in blocks.items():
        blocks[name] = t.contiguous()
    _validate_shapes(cfg, params)
    return params


def _validate_shapes(cfg: ModelConfig, params: dict) -> None:
    L, D, Dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    expect = {
        ("blocks", "wq"): (L, D, cfg.n_heads * Dh),
        ("blocks", "wk"): (L, D, cfg.n_kv_heads * Dh),
        ("blocks", "wo"): (L, cfg.n_heads * Dh, D),
        ("embed",): (cfg.vocab_size, D),
    }
    for keys, shape in expect.items():
        node = params
        for k in keys:
            node = node[k]
        if tuple(node.shape) != shape:
            raise ValueError(
                f"{'.'.join(keys)}: checkpoint shape {tuple(node.shape)} != "
                f"config {shape}; wrong ModelConfig for this checkpoint?"
            )


def config_from_hf(path: str | Path, name: str = "hf") -> ModelConfig:
    """A ModelConfig from an HF ``config.json``. Raises on a rope_scaling
    type other than Llama-3.1's ``llama3`` (it would be mis-computed)."""
    hf = json.loads((Path(path) / "config.json").read_text())
    arch = (hf.get("architectures") or [""])[0]
    is_moe = "Mixtral" in arch or "num_local_experts" in hf

    rope_scaling = None
    rs = hf.get("rope_scaling")
    if rs:
        rs_type = rs.get("rope_type") or rs.get("type")
        if rs_type != "llama3":
            raise ValueError(
                f"unsupported rope_scaling type {rs_type!r}: only 'llama3' "
                "(Llama-3.1) frequency rescaling is implemented"
            )
        rope_scaling = RopeScaling(
            factor=float(rs["factor"]),
            low_freq_factor=float(rs["low_freq_factor"]),
            high_freq_factor=float(rs["high_freq_factor"]),
            original_max_position_embeddings=int(rs["original_max_position_embeddings"]),
        )

    # Mistral: sliding_window set => windowed attention. Qwen2 ships a
    # sliding_window value but gates it off with use_sliding_window.
    sliding_window = int(hf.get("sliding_window") or 0)
    if "Qwen2" in arch and not hf.get("use_sliding_window", False):
        sliding_window = 0

    return ModelConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_ff=hf.get("moe_intermediate_size") or hf["intermediate_size"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        max_seq_len=int(hf.get("max_position_embeddings", 8192)),
        sliding_window=sliding_window,
        qkv_bias="Qwen2" in arch,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        n_experts=int(hf.get("num_local_experts", 0)) if is_moe else 0,
        n_experts_per_token=int(hf.get("num_experts_per_tok", 2)),
    )
