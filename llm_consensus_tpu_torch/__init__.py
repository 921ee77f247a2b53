"""llm_consensus_tpu_torch — the PyTorch and CUDA port of ``llm_consensus_tpu``.

The multi-agent consensus framework of the JAX package, running on one
NVIDIA H100: the same consensus protocol, engine and model, in PyTorch,
with the JAX package's Pallas kernels replaced by CUDA kernels written by
hand for Hopper (``ops/kernels``). The package keeps the JAX package's
module layout and names, so each module's counterpart is easy to find.
It imports neither JAX nor the JAX package.

The port goes slice by slice (ROADMAP.md). This slice is the main path:
one consensus question answered by local bf16 weights —
``Coordinator`` → ``LocalBackend`` → ``InferenceEngine`` → ``generate`` →
``models.transformer`` with the RMSNorm, causal-prefill and decode
attention kernels — and the vote.
"""

from llm_consensus_tpu_torch.version import __version__

__all__ = ["__version__"]
