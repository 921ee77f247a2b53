"""Utilities: device placement, stop sequences and logging setup."""

from llm_consensus_tpu_torch.utils.logging import setup_logging

__all__ = ["setup_logging"]
