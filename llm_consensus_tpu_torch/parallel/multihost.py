"""Joining a ``torch.distributed`` world.

Counterpart of ``llm_consensus_tpu.parallel.multihost``. JAX is single-
controller: one ``jax.distributed.initialize`` and every program spans
the hosts. Here every rank is a process of its own, started by
``torchrun`` or by the port's launcher
(:func:`~llm_consensus_tpu_torch.parallel.launch.launch`), and joins the
world with :func:`initialize_distributed`.

The backend is the caller's choice, never probed: ``nccl`` when each rank
drives its own card, ``gloo`` for the CPU tests and for several ranks on
one card (NCCL refuses two ranks on one device; ``gloo`` carries CUDA
tensors through host memory). The JAX module's multi-slice mesh and
``host_array_to_global`` have no counterpart yet: a rank feeds its own
shard.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass

import torch.distributed as dist

log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class DistributedConfig:
    """Where the world meets and who this rank is.

    ``init_method``: ``file://<path>`` (a file store, what the launcher
    uses), ``tcp://host:port``, or None for ``env://`` (the variables
    ``torchrun`` sets: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``timeout_s``: how long a collective may wait for the other
    ranks before it fails, so that a rank that dies ends the world instead
    of hanging it.
    """

    init_method: str | None = None
    world_size: int | None = None
    rank: int | None = None
    timeout_s: float = 300.0

    @staticmethod
    def from_env() -> "DistributedConfig":
        return DistributedConfig(
            world_size=_int_env("WORLD_SIZE"), rank=_int_env("RANK")
        )


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_distributed(backend: str, config: DistributedConfig | None = None) -> bool:
    """Join the world (idempotent). Returns True when more than one rank
    takes part afterwards.

    With no ``init_method`` and no ``WORLD_SIZE`` in the environment, or a
    world of one, this is a no-op that returns False: one process needs
    no world.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    config = config or DistributedConfig.from_env()
    if (config.world_size or 1) <= 1:
        return False
    dist.init_process_group(
        backend=backend,
        init_method=config.init_method or "env://",
        world_size=config.world_size,
        rank=config.rank,
        timeout=datetime.timedelta(seconds=config.timeout_s),
    )
    log.info(
        "distributed: rank %d of %d over %s", dist.get_rank(), dist.get_world_size(), backend
    )
    return dist.get_world_size() > 1


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(per-rank batch size, this rank's row offset) for feeding a
    ``data``-sharded global batch from per-rank inputs."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes"
        )
    per = global_batch // n
    return per, per * rank
