"""Serving: token-level continuous batching over the paged KV cache.

:class:`ContinuousBatcher` admits and retires requests at decode-step
granularity on one card, or from rank 0 of a dp x mp mesh whose other
ranks run :func:`serve_worker` (the throughput-serving mode);
:class:`ContinuousBackend` puts it behind the Backend seam the
Coordinator calls. The JAX package's request-level scheduler, replica
fleet, multi-model set and host tier are not ported yet.
"""

from llm_consensus_tpu_torch.serving.continuous import (
    ContinuousBackend,
    ContinuousBatcher,
    ContinuousConfig,
    ServeResult,
    serve_worker,
)

__all__ = [
    "ContinuousBackend",
    "ContinuousBatcher",
    "ContinuousConfig",
    "ServeResult",
    "serve_worker",
]
