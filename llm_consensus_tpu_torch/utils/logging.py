"""Logging setup from a RUST_LOG-style spec.

Counterpart of ``llm_consensus_tpu.utils.logging``. The reference
initializes ``env_logger`` (``src/main.rs:352``) and takes its verbosity
from ``RUST_LOG``; here ``LLM_CONSENSUS_LOG`` plays that role, with the
same convention: a level name, optionally ``module=level`` pairs
separated by commas.
"""

from __future__ import annotations

import logging
import os

_FORMAT = "[%(asctime)s %(levelname)s %(name)s] %(message)s"


def setup_logging(spec: str | None = None) -> None:
    """Configure logging from a spec such as ``debug`` or
    ``info,llm_consensus_tpu_torch.consensus=debug``; ``spec`` defaults
    to ``$LLM_CONSENSUS_LOG``, then ``info``. Unknown level names are
    ignored. A repeat call reconfigures."""
    spec = spec if spec is not None else os.environ.get("LLM_CONSENSUS_LOG", "info")
    root_level = logging.INFO
    module_levels: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        mod, sep, lvl = part.rpartition("=")
        level = getattr(logging, lvl.strip().upper(), None)
        if not isinstance(level, int):
            continue
        if sep:
            module_levels[mod.strip()] = level
        else:
            root_level = level
    logging.basicConfig(level=root_level, format=_FORMAT, force=True)
    for mod, level in module_levels.items():
        logging.getLogger(mod).setLevel(level)
