"""Device mesh over ``torch.distributed``, with the canonical axis names.

Counterpart of ``llm_consensus_tpu.parallel.mesh``. JAX's mesh is one
program over many devices (GSPMD inserts the collectives); here each rank
is one process holding its own shard, and the collectives are explicit
calls on the :class:`Mesh`.

Axes (any may be size 1): ``data`` (decode rows, page pool, candidate
fan-out; weights replicate over it) and ``model`` (tensor parallelism:
attention heads, MLP hidden, vocabulary). ``pipe``, ``expert`` and
``seq`` stay in :class:`MeshConfig` so that configs keep their shape, and
raise above 1: pipeline, expert and ring parallelism come with later
slices.

Rank layout follows the JAX axis order with ``model`` innermost: rank
``r = d * model + m``. The collectives the serving slice needs are
:meth:`Mesh.sum` (over one axis), :meth:`Mesh.gather` (an all-gather
written as a zero-padded sum, exact as JAX's psum of exact zeros is) and
:meth:`Mesh.broadcast_object` (host messages from rank 0). They use only
``all_reduce`` and ``broadcast``, the two collectives ``gloo`` takes on
CUDA tensors as well as on CPU ones, so one code runs over ``nccl`` (one
card per rank) and over ``gloo`` (the CPU tests, or several ranks on one
card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from llm_consensus_tpu_torch.utils.device import resolve_device

AXES = ("data", "pipe", "model", "expert", "seq")

# The axes this port does not shard over yet, and the slice that brings them.
_LATER_AXES = {
    "pipe": "the pipeline slice (parallel/pipeline.py)",
    "expert": "the MoE slice (expert parallelism)",
    "seq": "the ring-attention slice (parallel/ring.py)",
}


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    expert: int = 1
    seq: int = 1
    pipe: int = 1

    def __post_init__(self) -> None:
        for axis, later in _LATER_AXES.items():
            if getattr(self, axis) > 1:
                raise NotImplementedError(
                    f"mesh axis {axis}={getattr(self, axis)}: {axis} > 1 comes "
                    f"with {later}, which is not ported yet"
                )
        for axis in AXES:
            if getattr(self, axis) < 1:
                raise ValueError(f"mesh axis {axis} must be >= 1, got {getattr(self, axis)}")

    @property
    def size(self) -> int:
        return self.data * self.pipe * self.model * self.expert * self.seq

    def axis_sizes(self) -> dict[str, int]:
        return {
            "data": self.data,
            "pipe": self.pipe,
            "model": self.model,
            "expert": self.expert,
            "seq": self.seq,
        }


@dataclass
class Mesh:
    """One rank's view of a ``data`` x ``model`` mesh.

    ``coords``: this rank's ``{"data": d, "model": m}``; ``shape``: every
    axis's size, as ``jax.sharding.Mesh.shape``; ``device``: where this
    rank's shards live. ``groups`` holds the
    process group of each axis of size > 1 that this rank belongs to, and
    ``control`` a ``gloo`` group over the whole world for host messages
    (CPU tensors, whatever the world's backend). A mesh built directly,
    without :func:`make_mesh`, has no groups: it serves to shard
    parameters (:func:`~llm_consensus_tpu_torch.parallel.partitioning.
    shard_params`) but its collectives raise.

    ``collective_seconds`` sums the host's wall time inside the
    collectives (one ``time.perf_counter`` span around each call): over
    ``gloo`` on CUDA tensors a call returns once the device has reached it
    and the bytes have crossed the host, so the share says what the
    transport costs the loop.
    """

    config: MeshConfig
    device: torch.device
    rank: int = 0
    groups: dict = field(default_factory=dict)
    control: object = None
    collective_seconds: float = 0.0

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        if not 0 <= self.rank < self.config.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.config.size}")

    @property
    def shape(self) -> dict[str, int]:
        return self.config.axis_sizes()

    @property
    def coords(self) -> dict[str, int]:
        mp = self.config.model
        return {"data": self.rank // mp, "model": self.rank % mp}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def device_for(self, device=None) -> torch.device:
        """The mesh's device, for a caller given both a mesh and a
        ``device`` (None: the mesh's); raises when they disagree."""
        if device is None:
            return self.device
        want = torch.device(device)
        if want.type != self.device.type or (
            want.index is not None and self.device.index is not None
            and want.index != self.device.index
        ):
            raise ValueError(f"device={want} disagrees with the mesh's device {self.device}")
        return self.device

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def _group(self, axis: str):
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(
                f"this mesh has no process group for axis {axis!r}: build it "
                "with make_mesh after initialize_distributed"
            )
        return group

    def _timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.collective_seconds += time.perf_counter() - t0

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``x`` over ``axis`` IN PLACE (every rank of the axis ends
        with the same values) and return it; a no-op on an axis of size 1."""
        if self.size(axis) == 1:
            return x
        self._timed(dist.all_reduce, x, op=dist.ReduceOp.SUM, group=self._group(axis))
        return x

    def gather(self, x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in the axis's
        order: a zero tensor with this rank's slice written, summed over
        ``axis``. Exact: every other element adds exact zeros."""
        n = self.size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        shape = list(x.shape)
        width = shape[dim]
        shape[dim] = width * n
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, self.index(axis) * width, width).copy_(x)
        return self.sum(full, axis)

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (pickled over the ``gloo``
        control group; the other ranks pass None and get rank 0's).
        Only this program's own messages travel this way."""
        if self.config.size == 1:
            return obj
        if self.control is None:
            raise RuntimeError("this mesh has no control group: build it with make_mesh")
        box = [obj]
        self._timed(dist.broadcast_object_list, box, src=0, group=self.control)
        return box[0]

    def barrier(self) -> None:
        """Every rank waits for all (an all-reduce on the control group)."""
        if self.config.size == 1:
            return
        self._timed(dist.all_reduce, torch.zeros(1), group=self.control)


def make_mesh(config: MeshConfig | None = None, device=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized world.

    ``config`` defaults to every rank on ``data``; its size must equal
    the world's. ``device``: where this rank's shards live, the card
    unless the caller asks for the CPU (``device="cpu"``); without a card
    the default raises. Every rank builds the same process groups in the
    same order (``dist.new_group`` is collective): the ``model`` groups by
    data index, then the ``data`` groups by model index, then the control
    group.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if config is None:
        config = MeshConfig(data=world)
    if config.size != world:
        raise ValueError(f"mesh {config} needs {config.size} ranks, the world has {world}")
    mesh = Mesh(config=config, device=resolve_device(device), rank=rank)
    if world == 1:
        return mesh
    dp, mp = config.data, config.model
    layouts = {
        "model": [[d * mp + m for m in range(mp)] for d in range(dp)],
        "data": [[d * mp + m for d in range(dp)] for m in range(mp)],
    }
    for axis in ("model", "data"):
        if config.axis_sizes()[axis] == 1:
            continue
        for ranks in layouts[axis]:
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axis] = group
    mesh.control = dist.new_group(list(range(world)), backend="gloo")
    return mesh


def best_mesh_for(
    n_devices: int,
    *,
    want_model: int = 1,
    want_expert: int = 1,
    want_seq: int = 1,
    want_pipe: int = 1,
) -> MeshConfig:
    """Fill the requested inner axes, spend the remainder on ``data``."""
    inner = want_model * want_expert * want_seq * want_pipe
    if n_devices % inner != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by "
            f"pipe*model*expert*seq={inner}"
        )
    return MeshConfig(
        data=n_devices // inner,
        model=want_model,
        expert=want_expert,
        seq=want_seq,
        pipe=want_pipe,
    )
