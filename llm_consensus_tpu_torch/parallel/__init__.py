"""Parallelism over ``torch.distributed``: the dp x mp serving slice.

Counterpart of ``llm_consensus_tpu.parallel``, cut to what the sharded
serving path needs: the mesh and its collectives (:mod:`.mesh`), joining
a world (:mod:`.multihost`), starting one (:mod:`.launch`) and the
partitioning rules (:mod:`.partitioning`). The JAX package's pipeline,
ring attention, MoE expert parallelism and training loop are not ported
yet.
"""

from llm_consensus_tpu_torch.parallel.launch import RankResult, launch
from llm_consensus_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshConfig,
    best_mesh_for,
    make_mesh,
)
from llm_consensus_tpu_torch.parallel.multihost import (
    DistributedConfig,
    initialize_distributed,
    local_batch_slice,
)
from llm_consensus_tpu_torch.parallel.partitioning import (
    batch_pspec,
    cache_pspecs,
    param_pspecs,
    shard_params,
    sharded_param_bytes,
)

__all__ = [
    "AXES",
    "DistributedConfig",
    "Mesh",
    "MeshConfig",
    "RankResult",
    "batch_pspec",
    "best_mesh_for",
    "cache_pspecs",
    "initialize_distributed",
    "launch",
    "local_batch_slice",
    "make_mesh",
    "param_pspecs",
    "shard_params",
    "sharded_param_bytes",
]
