"""InferenceEngine: text-in/text-out over the generate loop.

Counterpart of ``llm_consensus_tpu.engine.engine.InferenceEngine`` on the
dense path: tokenization, right-padding, shape bucketing (dummy rows pad
the batch up to a bucket), per-call generators and detokenization. It
stands where the reference's ``call_gemini`` stood (``src/main.rs:82-86``),
but batched.

Weights may be quantized to int8 or packed int4 at init (``quant``) and
the KV cache kept in int8 (``kv_quant``), as in the JAX package.
:meth:`InferenceEngine.memory_estimate` and :func:`plan_memory` are the
JAX package's capacity planner for one card. Not ported yet: chunked
prefill, the prefix cache, multi-token stop sequences, streaming,
scoring, speculative decoding, meshes and the native batch encoder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from llm_consensus_tpu_torch.engine.generate import GenerateOutput, generate
from llm_consensus_tpu_torch.engine.sampler import SamplerConfig
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer, Tokenizer
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.ops.quant import quantize_params
from llm_consensus_tpu_torch.utils.device import resolve_device, to_device
from llm_consensus_tpu_torch.utils.stops import (
    earliest_stop_cut,
    single_token_stop_ids,
)


def _next_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _kv_cache_bytes(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    quant: bool,
    slack: int = 0,
    shared_len: int = 0,
) -> int:
    """KV-cache bytes for a generate call: the one copy of the cache
    capacity formula (``memory_estimate`` and ``plan_memory`` both call
    it).

    ``shared_len``: prompt-prefix tokens stored once for the whole batch
    instead of once per row (the paged serving path's shared pages: an
    N-way fan-out holds prefix + N * suffix). 0 (the default) models the
    engine's dense per-row cache, which duplicates the prefix.
    """
    shared_len = max(0, min(shared_len, cache_len))
    tokens = batch * (cache_len + slack) - (batch - 1) * shared_len
    slots = cfg.n_layers * tokens * cfg.n_kv_heads
    if quant:
        # int8 k+v + one f32 scale each per (slot, head)
        return slots * (2 * cfg.head_dim + 2 * 4)
    return slots * 2 * cfg.head_dim * 2  # bf16 k+v


def _logits_bytes(cfg: ModelConfig, batch: int) -> int:
    return batch * cfg.vocab_size * 4


def _memory_plan(
    cfg: ModelConfig,
    params_bytes: int,
    *,
    seq_buckets: tuple[int, ...],
    batch_buckets: tuple[int, ...],
    n_candidates: int,
    prompt_len: int,
    new_tokens: int,
    kv_quant: bool,
    shared_prefix_len: int,
    hbm_bytes: int | None,
    mesh_shape: dict | None = None,
) -> dict:
    """The terms of ``memory_estimate`` and ``plan_memory``: the engine's
    bucketing of the batch and the prompt, the KV cache and logits of one
    generate call at those shapes, and their total with the params. On a
    mesh (``mesh_shape``) the terms are per rank: ``params_bytes`` comes
    in already sharded, and the KV cache and the logits divide by
    ``data`` x ``model`` (the cache's batch over data, its kv heads over
    model; the JAX package's division)."""
    s = min(_next_bucket(prompt_len, seq_buckets), cfg.max_seq_len)
    b = _next_bucket(n_candidates, batch_buckets)
    cache_len = s + max(1, min(new_tokens, cfg.max_seq_len - s))
    kv = _kv_cache_bytes(
        cfg, b, cache_len, kv_quant, shared_len=min(shared_prefix_len, s)
    )
    logits = _logits_bytes(cfg, b)
    shape = mesh_shape or {}
    c_div = shape.get("data", 1) * shape.get("model", 1)
    kv //= c_div
    logits //= max(1, c_div)
    out = {
        "params_bytes": params_bytes,
        "kv_cache_bytes": kv,
        "logits_bytes": logits,
        "total_bytes": params_bytes + kv + logits,
        "batch": b,
        "cache_len": cache_len,
    }
    if hbm_bytes is not None:
        out["fits"] = out["total_bytes"] <= hbm_bytes
    return out


_QUANT_BITS = {"int8": 8, "int4": 4}


@dataclass
class EngineConfig:
    max_new_tokens: int = 256
    # Prompt-length buckets (right-padded up; keeps the set of shapes small).
    seq_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    # Batch-size buckets (padded up with dummy rows).
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    # Weight-only per-channel quantization at engine init (ops/quant.py):
    # "int8" halves the weight bytes every decode step reads, "int4"
    # (packed nibbles) halves them again at reduced precision.
    quant: str = "none"
    # int8 KV cache (models/cache.QuantKVCache): halves the cache bytes
    # every decode step reads.
    kv_quant: bool = False


@dataclass
class EngineResult:
    text: str
    num_tokens: int
    logprob: float
    token_ids: list[int]


class InferenceEngine:
    """Batched local text generation on one model's weights.

    ``device``: where the weights live and the model runs; the card
    (``"cuda"``) unless the caller asks for ``"cpu"``. Without a card and
    without ``device="cpu"`` the constructor raises.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        tokenizer: Tokenizer | None = None,
        engine_config: EngineConfig | None = None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.tokenizer = tokenizer or ByteTokenizer()
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds model "
                f"vocab {cfg.vocab_size}"
            )
        self.config = engine_config or EngineConfig()
        if self.config.quant in _QUANT_BITS:
            self.params = quantize_params(
                self.params, bits=_QUANT_BITS[self.config.quant]
            )
        elif self.config.quant != "none":
            raise ValueError(f"unknown quant mode {self.config.quant!r}")
        self._tokens_generated = 0

    # ------------------------------------------------------------------

    def _prepare(
        self, prompts: list[str], add_bos: bool = True
    ) -> tuple[np.ndarray, np.ndarray, int]:
        tok = self.tokenizer
        # Left-truncate over-long prompts (keep the question tail); the cap
        # is the model context, not just the largest bucket.
        max_prompt = min(self.config.seq_buckets[-1], self.cfg.max_seq_len - 1)
        encoded = [tok.encode(p, add_bos=add_bos)[-max_prompt:] for p in prompts]
        enc_lengths = np.array([len(ids) for ids in encoded], np.int32)
        longest = int(enc_lengths.max())
        s = _next_bucket(longest, self.config.seq_buckets)
        s = min(s, self.cfg.max_seq_len)
        b = _next_bucket(len(prompts), self.config.batch_buckets)
        tokens = np.full((b, s), tok.pad_id, np.int32)
        for i, ids in enumerate(encoded):
            tokens[i, : len(ids)] = ids
        lengths = np.zeros((b,), np.int32)
        lengths[: len(prompts)] = enc_lengths
        # Dummy pad rows get length 1 so gather/clip stay in range.
        lengths[len(prompts) :] = 1
        return tokens, lengths, len(prompts)

    def generate_texts(
        self,
        prompts: list[str],
        temperatures: list[float] | None = None,
        seed: int = 0,
        max_new_tokens: int | None = None,
        sampler: SamplerConfig | None = None,
        stop: list[str] | None = None,
    ) -> list[EngineResult]:
        """Generate one completion per prompt.

        One batch per chunk of ``batch_buckets[-1]`` prompts; most calls
        fit a single chunk. ``sampler`` overrides the engine's default
        top-k/top-p config for this call.

        ``stop``: stop sequences. Text is trimmed at the earliest
        occurrence of any stop string (the stop itself is removed); stops
        that tokenize to a single id also end their row's decoding, like
        EOS. Multi-token stops need the chunked host-check path of the
        JAX package, which is not ported yet: they raise.
        """
        if not prompts:
            return []
        chunk = self.config.batch_buckets[-1]
        if len(prompts) > chunk:
            out: list[EngineResult] = []
            for i in range(0, len(prompts), chunk):
                out.extend(
                    self.generate_texts(
                        prompts[i : i + chunk],
                        temperatures=(
                            temperatures[i : i + chunk]
                            if temperatures is not None
                            else None
                        ),
                        seed=seed + i,
                        max_new_tokens=max_new_tokens,
                        sampler=sampler,
                        stop=stop,
                    )
                )
            return out
        if stop and any(
            len(self.tokenizer.encode(x, add_bos=False)) > 1 for x in stop
        ):
            raise NotImplementedError(
                "multi-token stop sequences are not ported to PyTorch yet"
            )
        tokens, lengths, n_real = self._prepare(prompts)
        b = tokens.shape[0]
        temps = np.zeros((b,), np.float32)
        if temperatures is not None:
            temps[:n_real] = np.asarray(temperatures, np.float32)
        mnt = max_new_tokens or self.config.max_new_tokens
        # Clamp so prompt + generation fits the model context.
        mnt = max(1, min(mnt, self.cfg.max_seq_len - tokens.shape[1]))
        # Identical prompts (self-consistency fan-out) prefill once and
        # copy the cache instead of prefilling B copies.
        shared = n_real == b and len(set(prompts)) == 1 and b > 1
        dev = self.device
        out: GenerateOutput = generate(
            self.cfg,
            self.params,
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.Generator(device=dev).manual_seed(seed),
            torch.from_numpy(temps).to(dev),
            max_new_tokens=mnt,
            sampler=sampler if sampler is not None else self.config.sampler,
            eos_id=self.tokenizer.eos_id,
            pad_id=self.tokenizer.pad_id,
            shared_prefill=shared,
            stop_ids=single_token_stop_ids(self.tokenizer, stop or ()),
            kv_quant=self.config.kv_quant,
        )
        return self._trim_stops(self._collect(out, n_real), stop)

    def memory_estimate(
        self,
        n_candidates: int = 1,
        prompt_len: int = 128,
        new_tokens: int | None = None,
        hbm_bytes: int | None = None,
        shared_prefix_len: int = 0,
        mesh_shape: dict | None = None,
    ) -> dict:
        """Device-memory estimate for a generate call at these shapes.

        Bytes of the resident params (as stored, quantized leaves
        included), of the KV cache the call would allocate (after the
        engine's bucketing, honouring ``kv_quant``), of the float32
        logits, and their total; ``fits`` when ``hbm_bytes`` is given.
        ``shared_prefix_len``: prompt-prefix tokens stored once for every
        candidate (the paged serving path); 0 models the engine's dense
        per-row cache. ``mesh_shape`` (e.g. ``{"data": 2, "model": 2}``):
        the per-rank terms of the same call sharded over that mesh —
        params per :func:`~llm_consensus_tpu_torch.parallel.partitioning.
        sharded_param_bytes`, KV and logits divided by data x model. The
        JAX package's draft term does not arise: the port's engine has no
        draft model.
        """
        from llm_consensus_tpu_torch.parallel.partitioning import sharded_param_bytes

        c = self.config
        return _memory_plan(
            self.cfg,
            sharded_param_bytes(self.params, mesh_shape or {}),
            seq_buckets=c.seq_buckets,
            batch_buckets=c.batch_buckets,
            n_candidates=n_candidates,
            prompt_len=prompt_len,
            new_tokens=new_tokens or c.max_new_tokens,
            kv_quant=c.kv_quant,
            shared_prefix_len=shared_prefix_len,
            hbm_bytes=hbm_bytes,
            mesh_shape=mesh_shape,
        )

    @staticmethod
    def _trim_stops(results: list[EngineResult], stop: list[str] | None):
        """Cut each text at the earliest stop occurrence (stop removed);
        ``num_tokens``/``logprob`` keep the decode loop's accounting."""
        if not stop:
            return results
        for r in results:
            cut = earliest_stop_cut(r.text, stop)
            if cut >= 0:
                r.text = r.text[:cut]
        return results

    def _collect(self, out: GenerateOutput, n_real: int) -> list[EngineResult]:
        toks = out.tokens.cpu().numpy()
        nums = out.num_tokens.cpu().numpy()
        lps = out.logprob_sum.float().cpu().numpy()
        self._tokens_generated += int(nums[:n_real].sum())
        results = []
        for i in range(n_real):
            n = int(nums[i])
            ids = [int(t) for t in toks[i, :n] if t != self.tokenizer.eos_id]
            results.append(
                EngineResult(
                    text=self.tokenizer.decode(ids),
                    num_tokens=n,
                    logprob=float(lps[i]),
                    token_ids=ids,
                )
            )
        return results


def plan_memory(
    cfg: ModelConfig,
    *,
    quant: str = "none",
    kv_quant: bool = False,
    n_candidates: int = 1,
    prompt_len: int = 128,
    new_tokens: int = 256,
    mesh_shape: dict | None = None,
    hbm_bytes: int | None = None,
    seq_buckets: tuple[int, ...] | None = None,
    batch_buckets: tuple[int, ...] | None = None,
    shared_prefix_len: int = 0,
    host_cache_bytes: int = 0,
    page_size: int = 64,
) -> dict:
    """Config-only device-memory plan: no weights are allocated.

    The companion of :meth:`InferenceEngine.memory_estimate` for models
    too large to build first ("does llama3-8b at N = 64 fit one H100?").
    Param bytes come from ``init_params`` and ``quantize_params`` on the
    ``meta`` device (shapes and types only, leaf for leaf the JAX
    package's ``eval_shape``). The KV and logits terms are
    ``memory_estimate``'s, with the engine's bucketing of
    ``n_candidates`` and ``prompt_len`` (``batch_buckets`` and
    ``seq_buckets`` default to ``EngineConfig``'s).

    ``host_cache_bytes`` > 0 adds the host tier of the serving path: how
    many ``page_size``-token KV pages (this config's KV type, scales
    included) that many bytes of host memory hold, and the prefix tokens
    they buy. Host bytes never count against ``hbm_bytes``.

    ``mesh_shape`` (e.g. ``{"data": 4, "model": 2}``) gives the per-rank
    plan: each param leaf divided by the axes its spec names
    (:func:`~llm_consensus_tpu_torch.parallel.partitioning.
    sharded_param_bytes`), the KV and logits terms by data x model.
    ``pipe``, ``expert`` or ``seq`` above 1 raise (not ported), as do
    int4 weights with ``model`` > 1 and MoE configs.
    """
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.parallel.mesh import MeshConfig
    from llm_consensus_tpu_torch.parallel.partitioning import sharded_param_bytes

    shape = dict(mesh_shape or {})
    MeshConfig(**shape)  # refuses the axes that are not ported
    tree = init_params(cfg, dtype=torch.bfloat16, device="meta")
    if quant in _QUANT_BITS:
        tree = quantize_params(tree, bits=_QUANT_BITS[quant])

    dflt = EngineConfig()
    out = _memory_plan(
        cfg,
        sharded_param_bytes(tree, shape),
        seq_buckets=seq_buckets if seq_buckets is not None else dflt.seq_buckets,
        batch_buckets=batch_buckets if batch_buckets is not None else dflt.batch_buckets,
        n_candidates=n_candidates,
        prompt_len=prompt_len,
        new_tokens=new_tokens,
        kv_quant=kv_quant,
        shared_prefix_len=shared_prefix_len,
        hbm_bytes=hbm_bytes,
        mesh_shape=shape,
    )
    if host_cache_bytes > 0:
        page_bytes = _kv_cache_bytes(cfg, 1, page_size, kv_quant)
        host_pages = host_cache_bytes // max(1, page_bytes)
        out["host_cache_bytes"] = host_cache_bytes
        out["host_page_bytes"] = page_bytes
        out["host_capacity_pages"] = host_pages
        out["host_capacity_tokens"] = host_pages * page_size
    return out
