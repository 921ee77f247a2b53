"""Model configurations for the persona-panel model families.

The reference has no model code (its model is the remote Gemini API,
``src/main.rs:82-86``). The families here are the ones BASELINE.md's target
configs name: Llama-3-8B (north star), Mistral-7B and Qwen2-7B
(heterogeneous panel, config[3]), Mixtral-8x7B MoE (config[2]), plus small
test/bench presets. All are one architecture family — pre-norm transformer,
GQA attention, RoPE, SwiGLU — differing in dims and two flags (qkv bias for
Qwen2, MoE for Mixtral), so one functional implementation serves all.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1-style frequency rescaling (HF rope_scaling type
    'llama3'). Hashable, like ModelConfig."""

    factor: float
    low_freq_factor: float
    high_freq_factor: float
    original_max_position_embeddings: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None  # Llama-3.1 long-context
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    # Sliding-window attention (Mistral): 0 = full causal.
    sliding_window: int = 0
    qkv_bias: bool = False  # Qwen2 uses bias on q/k/v projections
    tie_embeddings: bool = False
    # MoE (Mixtral): 0 experts = dense MLP.
    n_experts: int = 0
    n_experts_per_token: int = 2
    # > 0 enables capacity-bounded GShard-style dispatch (compute only
    # routed tokens, capacity = ceil(T*k/E * factor)); 0 = dense
    # all-experts compute (exact, E/k x the FLOPs).
    moe_capacity_factor: float = 0.0
    # Token count at or below which an MoE layer takes the dense
    # all-experts path even when moe_capacity_factor > 0. At decode
    # shapes every expert's weights stream from HBM regardless of
    # routing (any batch of >= E tokens touches all E experts), so the
    # capacity dispatch saves no bandwidth there — it only adds the
    # [T, E, C] mask-build chain (top_k/cumsum/one_hot/scatter) to a
    # memory-bound step (measured 10x off the weight-read roofline on
    # v5e, PERF.md r5). Shapes are static under jit, so the switch is
    # trace-time Python with zero runtime cost; prefill/training token
    # counts exceed the threshold and keep the capacity path. 0 pins
    # the capacity path at every shape (tests / A-B benches). The two
    # paths differ numerically when capacity binds, so call sites that
    # promise cross-program identity pin one path for all their
    # programs (speculative_generate, prefill_chunked).
    moe_dense_decode_tokens: int = 256
    # Router auxiliary loss weights for MoE TRAINING (Switch-style
    # load-balance + router z-loss, models/transformer.moe_router_aux);
    # inference ignores them.
    moe_aux_loss_weight: float = 0.01
    moe_z_loss_weight: float = 1e-3
    # Route attention + RMSNorm through the hand-written kernels
    # (ops/kernels): the CUDA kernels for tensors on the card, their
    # plain PyTorch twins for tensors on the CPU. False = the plain ops
    # (ops/norms, ops/attention) everywhere. The name is the JAX
    # package's, so one config means the same model in both.
    use_pallas: bool = True
    # Kept for config parity with the JAX package; ring attention is not
    # ported yet and the port's model raises when it is set.
    use_ring: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # -- MoE dispatch-path selection (single source of truth) ----------
    # _mlp picks its path with moe_dense_at; call sites that promise
    # cross-program numeric identity pin one path for all their
    # programs with the two helpers below.

    def moe_dense_at(self, n_tokens: int) -> bool:
        """True when an MoE layer at this per-program token count traces
        the dense all-experts path (capacity factor 0, or at/below the
        trace-time dense-fallback threshold)."""
        return (
            self.moe_capacity_factor == 0
            or n_tokens <= self.moe_dense_decode_tokens
        )

    def with_moe_capacity_pinned(self) -> "ModelConfig":
        """Capacity dispatch at EVERY program shape (threshold 0)."""
        return self.with_(moe_dense_decode_tokens=0)

    def with_moe_dense_up_to(self, n_tokens: int) -> "ModelConfig":
        """Dense path for every program of <= n_tokens tokens (raises
        the threshold; never lowers it)."""
        return self.with_(
            moe_dense_decode_tokens=max(
                self.moe_dense_decode_tokens, n_tokens
            )
        )

    def moe_pin_for(
        self, ref_tokens: int, dense_up_to: int
    ) -> "ModelConfig":
        """Pin the dispatch path for a FAMILY of programs to the choice
        a reference program of ``ref_tokens`` tokens makes: dense for
        every program up to ``dense_up_to`` tokens when the reference
        side is dense, capacity at every shape otherwise. No-op for
        non-MoE / capacity-disabled configs.

        Pinning aligns the PATH only. When capacity genuinely binds,
        capacity dispatch remains approximate across program shapes
        (capacity C = ceil(T*k/E*factor) is per-program, so programs of
        different T can drop different tokens — GShard semantics);
        bitwise cross-program contracts hold on the dense side and at
        capacity factors generous enough that nothing drops."""
        if not (self.is_moe and self.moe_capacity_factor > 0):
            return self
        return (
            self.with_moe_dense_up_to(dense_up_to)
            if self.moe_dense_at(ref_tokens)
            else self.with_moe_capacity_pinned()
        )


PRESETS: dict[str, ModelConfig] = {
    # North-star flagship (BASELINE.json).
    "llama3-8b": ModelConfig(
        name="llama3-8b",
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=500000.0,
        max_seq_len=8192,
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b",
        vocab_size=32000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=10000.0,
        max_seq_len=8192,
        sliding_window=4096,  # Mistral-7B-v0.1 windowed attention
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b",
        vocab_size=152064,
        d_model=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        rope_theta=1000000.0,
        qkv_bias=True,
        max_seq_len=8192,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=1000000.0,
        n_experts=8,
        n_experts_per_token=2,
        # Capacity-bounded dispatch by default: the dense all-experts
        # path would spend E/k = 4x the needed FLOPs at this scale.
        moe_capacity_factor=1.25,
        max_seq_len=8192,
    ),
    # ~100M draft model sharing llama-1b's vocab — the speculative-
    # decoding draft for `bench.py --draft llama-draft-100m` (same
    # tokenizer/vocab is the only hard requirement for speculation).
    "llama-draft-100m": ModelConfig(
        name="llama-draft-100m",
        vocab_size=32000,
        d_model=768,
        n_layers=8,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        rope_theta=10000.0,
        max_seq_len=4096,
    ),
    # ~1.1B dense config for single-chip benchmarking (fits v5e HBM in bf16
    # with a large candidate batch).
    "llama-1b": ModelConfig(
        name="llama-1b",
        vocab_size=32000,
        d_model=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=8,
        d_ff=5632,
        rope_theta=10000.0,
        max_seq_len=4096,
    ),
    # ~14M byte-level model for the end-to-end accuracy loop
    # (examples/train_arith_em.py): small enough to train to high EM on
    # the synthetic arithmetic task in minutes on one chip, big enough
    # to actually learn two-step chain-of-thought arithmetic.
    "arith-14m": ModelConfig(
        name="arith-14m",
        vocab_size=384,
        d_model=384,
        n_layers=6,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        max_seq_len=512,
    ),
    # ~25M byte-level model (6 x (4*512^2 + 3*512*2048) = 25.2M
    # non-embedding) for the MULTI-STEP accuracy loop (eval/arith2.py:
    # 2-4 chained ops, 6 narrative frames, distractor quantities).
    # Bigger than arith-14m because the task is genuinely harder, and
    # max_seq_len 768 because multi-step prompts+CoT reach ~650 bytes
    # (arith-14m's 512 truncates them).
    "arith-25m": ModelConfig(
        name="arith-25m",
        vocab_size=384,
        d_model=512,
        n_layers=6,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        max_seq_len=768,
    ),
    # ~5.4M model with arith2's 768 context: the draft-scale sibling of
    # arith-25m (speculative decoding on the multi-step task needs a
    # draft whose context fits the ~650-byte prompts+CoT — arith-3m's
    # is too short). Measured 22 s/step on the 1-core host: NOT a CPU
    # training fallback; train it on chip (~1-2 min).
    "arith-6m": ModelConfig(
        name="arith-6m",
        vocab_size=384,
        d_model=256,
        n_layers=5,
        n_heads=4,
        n_kv_heads=4,
        d_ff=1024,
        max_seq_len=768,
    ),
    # ~0.94B-total-param MoE sized to run on ONE chip (VERDICT r4 item
    # 5: no MoE had ever touched real silicon — Mixtral-8x7B needs an
    # expert>=4 mesh, PERF.md). 4 experts top-2, Mixtral-style routing
    # and capacity bound; bf16 weights ~1.9 GiB, int8 ~0.95 GiB, so
    # decode at N=64 fits v5e HBM with room for the KV cache. Exercises
    # _moe_dispatch + the capacity-bounded path under REAL sampling.
    "moe-1b-4e": ModelConfig(
        name="moe-1b-4e",
        vocab_size=32000,
        d_model=1024,
        n_layers=16,
        n_heads=16,
        n_kv_heads=8,
        d_ff=4096,
        rope_theta=10000.0,
        n_experts=4,
        n_experts_per_token=2,
        moe_capacity_factor=1.25,
        max_seq_len=4096,
    ),
    # ~2.5M draft for arith-14m: trained on the same corpus it gives a
    # REAL speculative-decoding acceptance rate (examples/
    # spec_arith_demo.py) — between bench.py's --draft self ceiling and
    # random-weight floor.
    "arith-3m": ModelConfig(
        name="arith-3m",
        vocab_size=384,
        d_model=192,
        n_layers=4,
        n_heads=4,
        n_kv_heads=4,
        d_ff=768,
        max_seq_len=512,
    ),
    # Tiny configs for tests (CPU-simulated meshes). vocab 384 >= the
    # ByteTokenizer's 259 ids so end-to-end text tests can run on them.
    "test-tiny": ModelConfig(
        name="test-tiny",
        vocab_size=384,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        max_seq_len=128,
    ),
    # Draft-sized sibling of test-tiny (same vocab — the one hard
    # requirement for speculation): the continuous batcher's
    # draft/verify tests and the CPU smoke of `bench.py
    # --serve-speculative` run this as the cheap proposal model.
    "test-tiny-draft": ModelConfig(
        name="test-tiny-draft",
        vocab_size=384,
        d_model=32,
        n_layers=1,
        n_heads=2,
        n_kv_heads=1,
        d_ff=64,
        max_seq_len=128,
    ),
    "test-tiny-moe": ModelConfig(
        name="test-tiny-moe",
        vocab_size=384,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        n_experts=4,
        n_experts_per_token=2,
        max_seq_len=128,
    ),
}


def get_config(name: str) -> ModelConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown model preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
