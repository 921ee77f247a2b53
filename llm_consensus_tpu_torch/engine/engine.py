"""InferenceEngine: text-in/text-out over the generate loop.

Counterpart of ``llm_consensus_tpu.engine.engine.InferenceEngine`` on the
dense path: tokenization, right-padding, shape bucketing (dummy rows pad
the batch up to a bucket), per-call generators and detokenization. It
stands where the reference's ``call_gemini`` stood (``src/main.rs:82-86``),
but batched.

Weights may be quantized to int8 at init (``quant="int8"``) and the KV
cache kept in int8 (``kv_quant``), as in the JAX package. Not ported yet:
int4 weights, chunked prefill, the prefix cache, multi-token stop
sequences, streaming, scoring, speculative decoding, meshes and the
native batch encoder.
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


@dataclass
class EngineConfig:
    max_new_tokens: int = 256
    # Prompt-length buckets (right-padded up; keeps the set of shapes small).
    seq_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    # Batch-size buckets (padded up with dummy rows).
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    # Weight-only per-channel quantization at engine init (ops/quant.py):
    # "int8" halves the weight bytes every decode step reads; "int4"
    # waits for its kernel (K10) and raises.
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
        if self.config.quant == "int4":
            raise NotImplementedError(
                "quant='int4' needs the packed-int4 matmul kernel (K10), "
                "which is not ported to PyTorch yet"
            )
        if self.config.quant == "int8":
            self.params = quantize_params(self.params)
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
