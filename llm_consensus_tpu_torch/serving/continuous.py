"""Continuous batching: token-level request interleaving on one card.

Counterpart of ``llm_consensus_tpu.serving.continuous``, cut to the
serving slice of the port. Requests are admitted and retired at decode-
step granularity over a fixed ``max_slots``-wide paged KV cache
(:mod:`llm_consensus_tpu_torch.models.paged_cache`): admission and
retirement change page tables and lengths, never shapes.

- **Chunked prefill interleaved with decode**: prompts prefill in chunks
  of ``min(prefill_chunk, prompt bucket)`` tokens scheduled between
  decode steps (:func:`~llm_consensus_tpu_torch.models.transformer.
  prefill_chunk_paged`). A mid-prefill sequence's device table row stays
  NULL; its chunks write through a host-side table.
- **Copy-on-write shared prefixes**: admission matches the prompt's
  page-aligned prefix against the :class:`~llm_consensus_tpu_torch.
  models.paged_cache.PrefixRegistry`; full pages already resident are
  mapped by refcount, a partially matching boundary page is copied
  (never shared), and readiness flags hold a burst's later requests
  until the first request's prefill has written the pages they map.
- **Grouped shared-prefix decode**: decoding rows whose tables share a
  prefix page run read it once per step through the group pass of the
  ragged paged attention kernel (K8).
- **Pipelined dispatch** (``pipeline_depth``): program n+1 is enqueued
  before program n's tokens are read, fed from n's token output on the
  card, so the host's stop checks, retirement and admission run while
  the card works. Every host-to-device copy goes through
  :func:`~llm_consensus_tpu_torch.utils.device.h2d` (a fresh pinned
  buffer, ordered on the stream), and each program's tokens come back
  through a pinned buffer and an event recorded behind that program, so
  reading program n never waits for program n+1.
- **The fused scheduler step** (``ragged_attention``): a ready prefill
  chunk rides the decode dispatch as one more row of K8
  (:func:`~llm_consensus_tpu_torch.models.transformer.fused_step_paged`),
  one device program per scheduler iteration.

- **A dp x mp mesh** (``mesh=``, a :class:`~llm_consensus_tpu_torch.
  parallel.mesh.Mesh`): slots and the page pool split over ``data``, kv
  heads and the weights' Megatron shards over ``model``, attention through
  K9. One :class:`PagePool` and one :class:`PrefixRegistry` per data
  shard, slot s drawing from shard ``s * dp // max_slots`` (the JAX
  package's affinity), so every table, prefix share and group stays on
  one shard. Every rank must take the same steps in the same order, or a
  collective waits forever: so the scheduler runs on rank 0 alone, and
  each device operation it makes (a step with its host inputs: tokens,
  tables, chunk lane, groups and sampling rows; an install, release or
  page copy) is broadcast first; the other ranks run :func:`serve_worker`,
  which executes exactly those operations until a stop message. Each rank
  samples its own rows from logits gathered over ``model`` with the
  requests' own generators, and the tokens are gathered over ``data``, so
  every rank holds the same next tokens before the next step.

A host thread drives the loop; it sets its device and runs under
``torch.inference_mode``. Outputs are the same at every pipeline depth,
with the fused step on or off, and on a mesh (tested against the JAX
single-device batcher).

Not ported yet (each raises at construction): the host-RAM offload tier
(``host_cache_bytes``), speculative verify rows (``spec_k``, a draft),
multi-round decode (``decode_rounds``), multi-step programs
(``steps_per_sync``), the legacy dense admission (``prefill_chunk=0``),
roofline attribution (``hbm_gbps``) and the adaptive controller; int4
weights on a mesh with ``model`` > 1. The Prometheus families, the flight
recorder, request tracing and the fleet hooks come with the gateway and
fleet slices.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from llm_consensus_tpu_torch.backends import base as _backend_base
from llm_consensus_tpu_torch.engine.engine import _next_bucket
from llm_consensus_tpu_torch.engine.sampler import (
    SamplerConfig,
    request_generator,
    sample_token_per_request,
)
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer, Tokenizer
from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.models.paged_cache import (
    NULL_PAGE,
    GroupTracker,
    PagedKVCache,
    PagePool,
    PrefixRegistry,
    copy_page,
    install_seq,
    release_seq,
)
from llm_consensus_tpu_torch.models.paged_cache import DecodeGroupArrays
from llm_consensus_tpu_torch.models.transformer import (
    check_paged_supported,
    check_mesh_shardable,
    decode_step_paged,
    fused_step_paged,
    prefill_chunk_paged,
    unembed_one,
)
from llm_consensus_tpu_torch.parallel.partitioning import shard_params
from llm_consensus_tpu_torch.utils.device import h2d, resolve_device, to_device
from llm_consensus_tpu_torch.utils.stops import (
    VisibleIdFilter,
    earliest_stop_cut,
    stop_tail_window,
)

log = logging.getLogger(__name__)

_RID = itertools.count(1)


@dataclass
class ContinuousConfig:
    """The JAX package's ``ContinuousConfig``, every field, name and
    default. The fields of features this port has not reached yet must
    stay at their defaults (:class:`ContinuousBatcher` raises otherwise)."""

    max_slots: int = 8
    page_size: int = 64
    n_pages: int = 512  # pool size (page 0 is the reserved NULL page)
    pages_per_seq: int = 32  # table width = max seq len / page_size
    max_new_tokens: int = 256
    seq_buckets: tuple[int, ...] = (64, 128, 256, 512)
    sampler: SamplerConfig | None = None
    poll_interval_s: float = 0.001
    # Over-long prompts: left-truncate to the largest bucket (keeping the
    # question tail) with a warning, or reject when False.
    truncate_prompts: bool = True
    # Decode steps per device program (not ported: must be 1).
    steps_per_sync: int = 1
    # Prefill-chunk width in tokens; prompts prefill in chunks of
    # min(prefill_chunk, the prompt's bucket) between decode steps.
    # 0 is the legacy dense admission (not ported).
    prefill_chunk: int = 64
    # Map page-aligned shared prompt prefixes out of the PrefixRegistry
    # instead of re-prefilling them.
    share_prefix: bool = True
    # Grouped decode attention: rows sharing a prefix page run read it
    # once per step through K8's group pass (with cfg.use_pallas).
    prefix_attention: bool = True
    # Host-RAM offload tier budget in bytes (not ported: must be 0).
    host_cache_bytes: int = 0
    # Decode programs in flight at once; 1 = the serialized loop.
    pipeline_depth: int = 2
    # The fused scheduler step: a ready prefill chunk rides the decode
    # dispatch as one more row of the ragged kernel. Read per iteration.
    ragged_attention: bool = True
    # Speculative decoding (not ported: must be 0).
    spec_k: int = 0
    spec_decode: bool = True
    # Multi-round on-device decode (not ported: must be 1).
    decode_rounds: int = 1
    # Roofline attribution peak in GB/s (not ported: must be 0).
    hbm_gbps: float = 0.0


def _check_unported(c: ContinuousConfig, draft, host_store, controller) -> None:
    """Refuse the settings of later slices before any device work."""
    unported = (
        (c.host_cache_bytes > 0, "host_cache_bytes > 0: the host-RAM offload "
         "tier comes with the host-tier slice"),
        (c.spec_k > 0 or draft is not None, "spec_k > 0 or a draft model: "
         "speculative verify rows come with the speculative slice"),
        (c.decode_rounds > 1, "decode_rounds > 1: multi-round decode comes "
         "with the multi-round slice"),
        (c.steps_per_sync > 1, "steps_per_sync > 1: multi-step decode "
         "programs come with the multi-round slice"),
        (c.prefill_chunk <= 0, "prefill_chunk == 0: the legacy dense "
         "admission comes with the dense-admission slice"),
        (c.hbm_gbps > 0, "hbm_gbps > 0: roofline attribution comes with the "
         "metrics slice"),
        (host_store is not None, "a host_store: the host tier comes with "
         "the host-tier slice"),
        (controller is not None, "a controller: adaptive control comes "
         "with the control slice"),
    )
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"ContinuousBatcher: {what}")


@dataclass
class ServeResult:
    """What a :meth:`ContinuousBatcher.submit` future resolves to."""

    text: str
    num_tokens: int  # generated tokens incl. EOS
    # Per-request timeline (TTFT, inter-token gaps, shared header pages).
    # Excluded from equality: two identical generations never share
    # wall-clock stamps.
    timing: dict | None = field(default=None, compare=False)


@dataclass
class _Request:
    prompt_ids: np.ndarray
    max_new_tokens: int
    temperature: float
    seed: int
    future: Future
    # Per-request sampler settings ride as data, never as constants.
    top_k: int = 0
    top_p: float = 1.0
    # Stop sequences: text trims at the earliest occurrence; every
    # sampled token is host-checked, so decoding ends at once.
    stop: tuple[str, ...] = ()
    # Tail-window width of the per-token stop check, computed at submit.
    stop_window: int = 0
    rid: str = ""
    t_submit: float = 0.0


@dataclass
class _Slot:
    request: _Request
    pages: list[int]  # every table page this sequence holds one ref on
    generated: list[int]
    prompt_len: int
    # "prefill" until the last chunk lands (the device table row stays
    # NULL and the decode program ignores the row), then "decode".
    phase: str = "decode"
    table: np.ndarray | None = None  # host-side table (device sees NULL)
    next_pos: int = 0  # absolute position of the next chunk's first token
    chunk: int = 0  # this request's chunk width
    padded_ids: np.ndarray | None = None  # prompt ids padded to the chunk grid
    s_bucket: int = 0
    # Registry nodes whose page content this sequence reads (written by
    # another in-flight prefill): chunks wait until every dep is ready.
    deps: list = field(default_factory=list)
    # Nodes this sequence registered, with the prompt position whose write
    # completes each: [(node, end_pos)].
    reg_nodes: list = field(default_factory=list)
    t_first: float | None = None
    t_last_tok: float = 0.0
    gaps: list = field(default_factory=list)
    pages_shared_n: int = 0


@dataclass
class _InflightChunk:
    """A prefill chunk riding an in-flight fused program: its device work
    is queued; its host bookkeeping (chunk accounting, the final chunk's
    activation) waits for the fetch. ``slot`` is the identity guard."""

    idx: int
    slot: _Slot
    done: bool  # this program wrote the chunk covering the prompt end


@dataclass
class _Inflight:
    """One dispatched, not yet fetched decode program.

    ``rows`` snapshots the (slot index, slot) pairs decoding at dispatch:
    the fetch credits tokens only to rows whose slot object is still in
    place, so a slot retired (or retired and re-admitted) meanwhile never
    receives a stale program's output. ``host`` is a pinned buffer the
    program's sampled tokens (and, after a final fused chunk, the
    request's first token at index ``max_slots``) are copied into behind
    the program; ``event`` is recorded after that copy (None on the CPU,
    where the copy is synchronous). The program's tokens stay on the card
    as the next dispatch's input (:class:`_Programs`)."""

    host: torch.Tensor
    event: object
    t0: float
    rows: list
    chunk: _InflightChunk | None = None


# Seconds an idle mesh scheduler lets pass before it sends its ranks a
# no-op, so that their wait for the next message never reaches the
# world's collective timeout.
_MESH_IDLE_TICK_S = 1.0


class _Programs:
    """The batcher's device work on this rank: the params (this rank's
    shard on a mesh), the paged cache (its shard), and every operation
    the scheduler runs on them — a page copy, a row's install or release,
    a standalone prefill chunk, a decode step (fused with a chunk or not)
    and its sampling. Each takes host values only (numpy arrays, numbers),
    so that a mesh's scheduler can send it as one message.

    :meth:`call` runs an operation here and, on a mesh, first sends it to
    the other ranks (:func:`serve_worker` executes it there), which keeps
    every rank's collectives in the same order. The last step's sampled
    tokens stay on the device (``_prev``): the next step reads them there
    unless told to take the host's.
    """

    OPS = ("copy_page", "install", "release", "prefill", "step", "idle")

    def __init__(self, cfg: ModelConfig, params: dict, c: ContinuousConfig,
                 device: torch.device, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = device
        self.params = shard_params(params, mesh) if mesh is not None else to_device(
            params, device)
        self.cache = PagedKVCache.create(
            cfg, c.n_pages, c.page_size, c.max_slots, c.pages_per_seq,
            device=device, mesh=mesh,
        )
        self._lo = self.cache.row_offset
        self._hi = self._lo + self.cache.max_seqs
        self._prev: torch.Tensor | None = None
        self._groups_host = None
        self._groups_dev: DecodeGroupArrays | None = None
        self.last_send = time.monotonic()  # the last message to the other ranks

    @property
    def sends(self) -> bool:
        return self.mesh is not None and self.mesh.config.size > 1

    def call(self, op: str, *args):
        if self.sends:
            self.mesh.broadcast_object((op, args))
            self.last_send = time.monotonic()
        return getattr(self, "_" + op)(*args)

    # -- the operations (run on every rank, in the same order) -----------

    def _idle(self) -> None:
        pass

    def _copy_page(self, src: int, dst: int) -> None:
        copy_page(self.cache, src, dst)

    def _install(self, idx: int, table: np.ndarray, length: int) -> None:
        install_seq(self.cache, idx, table, length)

    def _release(self, idx: int) -> None:
        release_seq(self.cache, idx)

    def _prefill(self, ids: np.ndarray, table: np.ndarray, start: int, first):
        """One standalone chunk; ``first`` (the hidden row of the last
        prompt position, then :meth:`_first_token`'s sampling args) or
        None. Returns the first token [1] on the device, or None."""
        dev = self.device
        hidden, _ = prefill_chunk_paged(
            self.cfg, self.params, h2d(ids[None], dev, torch.int64),
            h2d(table, dev, torch.int32), start, self.cache, mesh=self.mesh,
        )
        return None if first is None else self._first_token(hidden[0, first[0]], *first[1:])

    def _first_token(self, h: torch.Tensor, temperature: float, top_k: int,
                     top_p: float, seed: int) -> torch.Tensor:
        """A request's first token [1] on the device, sampled from the
        hidden state of its last prompt position — the (seed, 0) draw.
        The same on every rank (the chunk's hidden states are)."""
        dev = self.device
        logits = unembed_one(self.cfg, self.params, h, mesh=self.mesh)[None]
        key = request_generator(seed, 0, dev) if temperature > 0 else None
        tok, _ = sample_token_per_request(
            logits,
            [key],
            h2d([temperature], dev, torch.float32),
            h2d([top_k], dev, torch.int32),
            h2d([top_p], dev, torch.float32),
            filters_active=(top_k != 0 or top_p != 1.0),
        )
        return tok

    def _group_arrays(self, host) -> DecodeGroupArrays | None:
        """The step's group arrays on the device: this rank's rows of
        group_id and shared_start, group_rep and group_pages whole. The
        device copy is kept while the arrays keep their values (compared
        by value: a worker rank unpickles a new tuple every step)."""
        if host is None:
            return None
        same = self._groups_host is not None and all(
            np.array_equal(a, b) for a, b in zip(host, self._groups_host)
        )
        if not same:
            self._groups_dev = DecodeGroupArrays.from_host(
                host, self.device, slice(self._lo, self._hi)
            )
            self._groups_host = host
        return self._groups_dev

    def _step(self, use_prev: bool, dirty: np.ndarray, last: np.ndarray, chunk,
              groups, sampling):
        """One decode program over every slot, with a chunk riding it when
        ``chunk`` is (ids, table, start, first) — ``first`` as in
        :meth:`_prefill`. Input tokens: the last step's output on the
        device where ``use_prev``, with the ``dirty`` rows taken from
        ``last``; else ``last``. ``sampling``: (temperature, seed, count,
        top_k, top_p) per slot and whether any filter is active. Returns
        (next tokens [max_slots] int32 on the device, the same on every
        rank; the chunk's first token [1] or None)."""
        dev = self.device
        if use_prev:
            tokens = self._prev
            if dirty.any():
                tokens = torch.where(h2d(dirty, dev), h2d(last, dev), tokens)
        else:
            tokens = h2d(last, dev)
        tokens = tokens[self._lo:self._hi, None]
        g = self._group_arrays(groups)
        first = None
        if chunk is None:
            logits, _ = decode_step_paged(
                self.cfg, self.params, tokens, self.cache, groups=g, mesh=self.mesh
            )
        else:
            ids, table, start, first_args = chunk
            logits, hidden, _ = fused_step_paged(
                self.cfg, self.params, tokens, self.cache,
                h2d(ids[None], dev, torch.int64), h2d(table, dev, torch.int32),
                start, groups=g, mesh=self.mesh,
            )
            if first_args is not None:
                first = self._first_token(hidden[0, first_args[0]], *first_args[1:])
        nxt = self._sample_rows(logits, *sampling)
        if self.mesh is not None:
            nxt = self.mesh.gather(nxt, "data", dim=0)
        self._prev = nxt
        return nxt, first

    def _sample_rows(self, logits, temps, seeds, counts, topks, topps,
                     filters_active: bool) -> torch.Tensor:
        """This rank's rows' tokens: each sampling row at its own (seed,
        count) stream; greedy rows (idle ones included) the argmax."""
        dev = self.device
        lo, hi = self._lo, self._hi
        keys = [
            request_generator(seeds[i], counts[i], dev) if temps[i] > 0 else None
            for i in range(lo, hi)
        ]
        tok, _ = sample_token_per_request(
            logits, keys, h2d(temps[lo:hi], dev), h2d(topks[lo:hi], dev),
            h2d(topps[lo:hi], dev), filters_active=filters_active,
        )
        return tok


def serve_worker(cfg: ModelConfig, params: dict, config: ContinuousConfig, mesh) -> int:
    """The loop of every mesh rank but rank 0: build this rank's shard of
    the batcher's device state, then run each operation rank 0's
    :class:`ContinuousBatcher` sends, in order, until it sends stop.
    Returns the number of operations run. ``params``: the full tree, the
    same on every rank (made from one seed); it is cut to this rank's
    shard here."""
    if mesh.rank == 0:
        raise ValueError("rank 0 runs the ContinuousBatcher, not serve_worker")
    c = config or ContinuousConfig()
    _check_unported(c, None, None, None)
    check_paged_supported(cfg)
    check_mesh_shardable(cfg, mesh, c.max_slots, c.n_pages)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    progs = _Programs(cfg, params, c, mesh.device, mesh)
    ran = 0
    with torch.inference_mode():
        while True:
            op, args = mesh.broadcast_object()
            if op == "stop":
                return ran
            if op not in _Programs.OPS:
                raise ValueError(f"serve_worker: unknown operation {op!r}")
            getattr(progs, "_" + op)(*args)
            ran += 1


class ContinuousBatcher:
    """Token-level continuous batching over one model's weights.

    ``device``: where the pool and the programs live (the card unless
    ``"cpu"``); ``params`` are moved there. The pool is bfloat16, as in
    the JAX package, whatever the weights' type. ``mesh``: serve on a dp x
    mp mesh from rank 0, on the mesh's device (a ``device`` that disagrees
    raises); ``params`` is the full tree, cut to rank 0's shard here.
    Every other rank runs :func:`serve_worker` with the same arguments
    meanwhile. A mesh that
    does not divide the model, the slots or the pool raises
    (``transformer.check_mesh_shardable``).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        tokenizer: Tokenizer | None = None,
        config: ContinuousConfig | None = None,
        mesh=None,
        draft=None,
        host_store=None,
        controller=None,
        device: str | torch.device | None = None,
    ):
        c = config or ContinuousConfig()
        _check_unported(c, draft, host_store, controller)
        check_paged_supported(cfg)
        self.cfg = cfg
        self.config = c
        self.tokenizer = tokenizer or ByteTokenizer()
        self.mesh = mesh
        self._dp = self._mp = 1
        if mesh is not None:
            if mesh.rank != 0:
                raise ValueError(
                    f"rank {mesh.rank}: the batcher's scheduler runs on rank 0; "
                    "the other ranks run serve_worker"
                )
            check_mesh_shardable(cfg, mesh, c.max_slots, c.n_pages)
            self._dp, self._mp = mesh.size("data"), mesh.size("model")
            self.device = mesh.device_for(device)
        else:
            self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The worker thread sets this device, which needs an index.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._progs = _Programs(cfg, params, c, self.device, mesh)
        # Host-side refcounted page allocators, one per data shard: slot s
        # (slots split in contiguous blocks) draws only from its shard's
        # page range, whose first page is reserved (the NULL page on shard
        # 0; see models.paged_cache), so a table only ever points at pages
        # of its own shard and prefix sharing stays inside one shard.
        per = c.n_pages // self._dp
        self._shard_of_slot = [s * self._dp // c.max_slots for s in range(c.max_slots)]
        self._pools = [PagePool(range(j * per + 1, (j + 1) * per)) for j in range(self._dp)]
        self._registries = [PrefixRegistry(pool, c.page_size) for pool in self._pools]
        self._group_decode = (
            c.prefix_attention and c.share_prefix and cfg.use_pallas
        )
        # One tracker for every shard: a group's members share their first
        # prefix page, so a group never spans shards.
        self._groups = GroupTracker(c.max_slots, c.page_size)
        # KV bytes one token costs per read across all layers (k + v).
        self._kv_token_bytes = (
            2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
            * self.cache.k.element_size()
        )
        self._kv_bytes_saved = 0
        # Rows in groups and groups, summed over grouped programs.
        self._group_rows_sum = 0
        self._groups_sum = 0
        self._slots: list[_Slot | None] = [None] * c.max_slots
        self._waiting: deque[_Request] = deque()
        self._last_tokens = np.zeros((c.max_slots,), np.int32)
        # Pipelined dispatch: programs dispatched but not yet fetched
        # (oldest first), and the rows whose next input token comes from
        # the host mirror instead of the previous program's output (rows
        # activated since the last dispatch).
        self._inflight: deque[_Inflight] = deque()
        self._tok_dirty = np.zeros((c.max_slots,), bool)
        self._pipeline_flushes = 0
        self._programs = {"fused": 0, "decode": 0, "prefill": 0}
        self._ragged_rows_sum = 0
        self._ragged_rows_count = 0
        self._work_iterations = 0
        self._last_fetch_end: float | None = None
        # CoW boundary copy staged by _admit_chunked under the lock and
        # run by _admit after it (flush first: the fetch takes the lock).
        self._pending_copy: tuple[int, int] | None = None
        # Per-slot sampling state: requests own their (seed, index)
        # streams, so sampling never depends on batch neighbours.
        self._seeds = np.zeros((c.max_slots,), np.int64)
        self._counts = np.zeros((c.max_slots,), np.int64)
        self._temps = np.zeros((c.max_slots,), np.float32)
        dflt = c.sampler or SamplerConfig()
        self._topks = np.full((c.max_slots,), dflt.top_k, np.int32)
        self._topps = np.full((c.max_slots,), dflt.top_p, np.float32)
        self._completed = 0
        self._generated_tokens = 0
        self._decode_steps = 0
        self._prefill_chunks = 0
        self._decode_step_sum = 0.0
        self._decode_step_count = 0
        self._sched_overhead_sum = 0.0
        self._sched_overhead_count = 0
        self._last_step_end: float | None = None
        self._ttft_sum = 0.0
        self._ttft_count = 0
        self._tbt_sum = 0.0
        self._tbt_count = 0
        # Liveness heartbeat: stamped at the top of every loop iteration
        # (>= 10 Hz when idle) and after each decode step's fetch.
        self._hb_tick = time.monotonic()
        self._hb_step: float | None = None
        self._vis_filter = VisibleIdFilter(
            self.tokenizer, skip_ids=(self.tokenizer.eos_id,)
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()
        self._prefill_rr = 0
        self._stopped_ranks = False
        self._thread = threading.Thread(
            target=self._run_guarded, name="continuous-batcher", daemon=True
        )
        self._thread.start()

    @property
    def cache(self) -> PagedKVCache:
        """This rank's paged cache (the whole pool off a mesh)."""
        return self._progs.cache

    @property
    def params(self) -> dict:
        return self._progs.params

    # -- public API -----------------------------------------------------

    def submit(
        self,
        prompt: str,
        *,
        max_new_tokens: int | None = None,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: int | None = None,
        top_p: float | None = None,
        stop: list[str] | tuple[str, ...] | None = None,
        prompt_ids=None,
    ) -> Future:
        """Enqueue a request; the Future resolves to a :class:`ServeResult`.

        ``top_k``/``top_p``: None inherits the config's sampler; any
        explicit value (0 / 1.0 mean disabled) is authoritative. ``stop``:
        text trimmed at the earliest stop (removed), and the row retires
        as soon as a stop appears. ``prompt_ids``: the prompt already
        encoded by this tokenizer (the largest-bucket truncation still
        applies)."""
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        c = self.config
        if max_new_tokens is None:
            max_new_tokens = c.max_new_tokens
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be > 0, got {max_new_tokens}")
        full_ids = (
            prompt_ids if prompt_ids is not None else self.tokenizer.encode(prompt)
        )
        cap = c.seq_buckets[-1]
        if len(full_ids) > cap:
            if not c.truncate_prompts:
                raise ValueError(
                    f"prompt is {len(full_ids)} tokens but the largest "
                    f"sequence bucket is {cap} (set truncate_prompts=True "
                    "to left-truncate instead)"
                )
            log.warning(
                "prompt of %d tokens left-truncated to %d (largest bucket)",
                len(full_ids), cap,
            )
        ids = np.asarray(full_ids[-cap:], np.int32)
        dflt = c.sampler or SamplerConfig()
        stop = tuple(stop or ())
        req = _Request(
            prompt_ids=ids,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            seed=seed,
            future=Future(),
            top_k=dflt.top_k if top_k is None else top_k,
            top_p=dflt.top_p if top_p is None else top_p,
            stop=stop,
            stop_window=stop_tail_window(self.tokenizer, stop),
            rid=f"req-{next(_RID)}",
            t_submit=time.perf_counter(),
        )
        with self._lock:
            self._waiting.append(req)
        self._work.set()
        return req.future

    def heartbeat(self) -> dict:
        """Host-loop liveness: seconds since the last loop tick and the
        last decode step. The loop ticks at >= 10 Hz even when idle, so a
        large ``last_tick_age_s`` means the worker is wedged."""
        now = time.monotonic()
        alive = self._thread.is_alive() and not self._stop.is_set()
        return {
            "alive": alive,
            "state": "serving" if alive else "stopped",
            "last_tick_age_s": now - self._hb_tick,
            "last_step_age_s": (
                now - self._hb_step if self._hb_step is not None else None
            ),
        }

    def stats(self) -> dict:
        """Live serving counters of the ported features — a consistent
        snapshot (the worker mutates them under the same lock).
        ``free_pages`` counts reclaimable prefix-registry pages as free."""
        with self._lock:
            regs = self._registries

            def reg_sum(attr):
                return sum(getattr(r, attr) for r in regs)

            return {
                "active_slots": self._decoding(),
                "prefilling_slots": sum(
                    s is not None and s.phase == "prefill" for s in self._slots
                ),
                "max_slots": self.config.max_slots,
                "waiting": len(self._waiting),
                "free_pages": sum(
                    p.available + r.reclaimable_pages()
                    for p, r in zip(self._pools, regs)
                ),
                "total_pages": self.config.n_pages - self._dp,
                "cached_pages": reg_sum("cached_pages"),
                "completed_requests": self._completed,
                "generated_tokens": self._generated_tokens,
                "decode_steps": self._decode_steps,
                "prefill_chunks": self._prefill_chunks,
                "prefix_lookups": reg_sum("lookups"),
                "prefix_hits": reg_sum("hits"),
                "prefix_pages_shared": reg_sum("pages_shared"),
                "prefix_pages_copied": reg_sum("pages_copied"),
                "prefix_evictions": reg_sum("evictions"),
                "prefix_pages_shared_per_shard": [r.pages_shared for r in regs],
                "shared_kv_bytes_saved": self._kv_bytes_saved,
                "decode_group_size": self._groups.largest_group,
                "decode_group_peak": self._groups.peak_group,
                "decode_group_rows_sum": self._group_rows_sum,
                "decode_groups_sum": self._groups_sum,
                "decode_step_seconds_sum": self._decode_step_sum,
                "decode_step_seconds_count": self._decode_step_count,
                "sched_overhead_seconds_sum": self._sched_overhead_sum,
                "sched_overhead_seconds_count": self._sched_overhead_count,
                "dispatch_inflight": len(self._inflight),
                "pipeline_flushes": self._pipeline_flushes,
                "device_programs_fused": self._programs["fused"],
                "device_programs_decode": self._programs["decode"],
                "device_programs_prefill": self._programs["prefill"],
                "ragged_rows_sum": self._ragged_rows_sum,
                "ragged_rows_count": self._ragged_rows_count,
                "work_iterations": self._work_iterations,
                "ttft_seconds_sum": self._ttft_sum,
                "ttft_seconds_count": self._ttft_count,
                "tbt_seconds_sum": self._tbt_sum,
                "tbt_seconds_count": self._tbt_count,
                "mesh_data_shards": self._dp,
                "mesh_model_shards": self._mp,
                "collective_seconds": (
                    self.mesh.collective_seconds if self.mesh is not None else 0.0
                ),
            }

    def close(self) -> None:
        """Stop the loop, fail what is still pending and, on a mesh, send
        the other ranks their stop (once the loop, the only other sender,
        has ended)."""
        self._stop.set()
        self._work.set()
        self._thread.join(timeout=10)
        with self._lock:
            self._fail_all(RuntimeError("batcher stopped"))
        if self._progs.sends and not self._thread.is_alive() and not self._stopped_ranks:
            self._stopped_ranks = True
            self.mesh.broadcast_object(("stop", ()))

    def _fail_all(self, exc: Exception) -> None:
        """Resolve every waiting and in-slot future with ``exc`` (caller
        holds the lock)."""
        for req in self._waiting:
            if not req.future.done():
                req.future.set_exception(exc)
        for slot in self._slots:
            if slot and not slot.request.future.done():
                slot.request.future.set_exception(exc)

    # -- host loop ------------------------------------------------------

    def _decoding(self) -> int:
        """Slots in the decode phase — THE definition of "active"."""
        return sum(s is not None and s.phase == "decode" for s in self._slots)

    def _bucket(self, n: int) -> int:
        return _next_bucket(n, self.config.seq_buckets)

    def _chunk_width(self, bucket: int) -> int:
        """The largest divisor of the prompt bucket <= ``prefill_chunk``:
        an unshared chunked prefill then covers exactly [0, bucket)."""
        chunk = min(self.config.prefill_chunk, bucket)
        while bucket % chunk:
            chunk -= 1
        return chunk

    def _pages_needed(self, req: _Request) -> int:
        """Table width in pages of an unshared admission — the admit-ever
        feasibility bound."""
        bucket = self._bucket(len(req.prompt_ids))
        return self._table_pages(bucket, bucket, req)

    def _table_pages(self, bucket: int, prefill_end: int, req: _Request) -> int:
        # + depth - 1: a finished row keeps writing K/V through the
        # programs already enqueued behind the one that finished it (their
        # tokens are discarded on the host); its pages absorb them.
        # prefill_end: a shared-prefix start off the chunk grid can pad the
        # final chunk past the bucket.
        total = (
            max(bucket, prefill_end)
            + req.max_new_tokens
            + max(1, self.config.pipeline_depth)
            - 1
        )
        return -(-total // self.config.page_size)

    def _admit(self) -> None:
        c = self.config
        while self._waiting:
            with self._lock:
                if not self._waiting:
                    return
                req = self._waiting[0]
                n_pages = self._pages_needed(req)
                usable = c.n_pages // self._dp - 1  # one shard's pool
                fits_ever = min(c.pages_per_seq, usable)
                if n_pages > fits_ever:
                    self._waiting.popleft()
                    req.future.set_exception(
                        ValueError(
                            f"request needs {n_pages} pages but the "
                            f"configuration caps a sequence at {fits_ever} "
                            f"(pages_per_seq={c.pages_per_seq}, usable "
                            f"pool={usable}"
                            + (f" per data shard of {self._dp})" if self._dp > 1 else ")")
                        )
                    )
                    continue
                if not self._admit_chunked(req):
                    return  # no slot/pages; retry after retirements
                self._waiting.popleft()
            if self._pending_copy is not None:
                self._boundary_copy_pending()

    def _admit_chunked(self, req: _Request) -> bool:
        """Claim a slot and pages for ``req`` and stage it as a
        prefilling slot (caller holds the lock). False when nothing fits.

        Per candidate slot (the first free slot of each data shard, in
        slot order): match the prompt against the shard's prefix
        registry, size the table from the true chunk coverage, evict
        registry-only pages if the free list falls short, allocate, stage
        the boundary-page copy, and register this prompt's own full pages
        for successors."""
        seen: set[int] = set()
        for i, slot in enumerate(self._slots):
            shard = self._shard_of_slot[i]
            if slot is not None or shard in seen:
                continue
            seen.add(shard)
            if self._admit_on(i, shard, req):
                return True
        return False

    def _admit_on(self, i: int, shard: int, req: _Request) -> bool:
        """:meth:`_admit_chunked` on free slot ``i`` of data shard
        ``shard``, with that shard's pool and registry."""
        c = self.config
        ids = req.prompt_ids
        L = len(ids)
        bucket = self._bucket(L)
        chunk = self._chunk_width(bucket)
        pool, registry = self._pools[shard], self._registries[shard]
        # Plan A shares the registered prefix; plan B admits unshared when
        # the shared table would overhang the page budget.
        for use_share in (True, False) if c.share_prefix else (False,):
            match = None
            shared_pages: list[int] = []
            start = 0
            boundary = 0
            if use_share:
                # A boundary copy must beat recompute: a whole-page copy
                # for a trivial overlap (every prompt shares BOS) is not.
                match = registry.match(ids, min_boundary=max(2, c.page_size // 4))
                shared_pages = match.pages
                start = match.shared_tokens
                if match.boundary_page is not None:
                    boundary = match.boundary_common
                if not shared_pages and not boundary:
                    continue  # registry miss: plan B is identical
            start += boundary
            end = start + -(-(L - start) // chunk) * chunk
            total = self._table_pages(bucket, end, req)
            need_new = total - len(shared_pages)
            if total > c.pages_per_seq:
                for p in shared_pages:
                    pool.release(p)
                continue
            if pool.available < need_new:
                registry.evict(need_new - pool.available)
            if pool.available < need_new:
                for p in shared_pages:
                    pool.release(p)
                continue
            if use_share:
                registry.record_commit(match, copied=bool(boundary))
            new_pages = pool.alloc(need_new)
            pages = shared_pages + new_pages
            table = np.full((c.pages_per_seq,), NULL_PAGE, np.int32)
            table[: len(pages)] = pages
            if boundary:
                # Copy-on-write: the donor's boundary page extends our
                # prefix mid-page; its content is copied into our first
                # private page before our first chunk (same stream, and
                # _prefill_step comes later on this thread).
                self._pending_copy = (match.boundary_page, new_pages[0])
            reg_nodes = registry.register(ids, pages) if c.share_prefix else []
            padded = np.full((end,), self.tokenizer.pad_id, np.int32)
            padded[:L] = ids
            deps = [n for n in (match.nodes if match else []) if not n.ready]
            self._slots[i] = _Slot(
                request=req,
                pages=pages,
                generated=[],
                prompt_len=L,
                phase="prefill",
                table=table,
                next_pos=start,
                chunk=chunk,
                padded_ids=padded,
                s_bucket=bucket,
                deps=deps,
                reg_nodes=reg_nodes,
                pages_shared_n=len(shared_pages),
            )
            return True
        return False

    def _boundary_copy_pending(self) -> None:
        """Run the CoW boundary copy staged by :meth:`_admit_chunked`,
        after draining the pipeline (a stable-cache operation)."""
        src, dst = self._pending_copy
        self._pending_copy = None
        self._flush_pipeline()
        self._progs.call("copy_page", int(src), int(dst))

    def _flush_pipeline(self) -> None:
        """Fetch every in-flight program (without the admission lock: the
        fetch's bookkeeping takes it). Each drain of a non-empty pipeline
        counts once in ``pipeline_flushes``."""
        if not self._inflight:
            return
        with self._lock:
            self._pipeline_flushes += 1
        while self._inflight:
            self._fetch_one()

    def _count_program(self, kind: str, rows: int | None = None) -> None:
        with self._lock:
            self._programs[kind] += 1
            if rows is not None:
                self._ragged_rows_sum += rows
                self._ragged_rows_count += 1

    def _pick_prefill_slot(self) -> int | None:
        """Next ready prefilling slot (deps ready, chunks left to run),
        round-robin; advances the pointer. None when nothing is ready."""
        n = self.config.max_slots
        for off in range(n):
            i = (self._prefill_rr + off) % n
            s = self._slots[i]
            if (
                s is not None
                and s.phase == "prefill"
                and s.next_pos < s.prompt_len
                and all(node.ready for node in s.deps)
            ):
                self._prefill_rr = (i + 1) % n
                return i
        return None

    def _chunk_args(self, slot: _Slot):
        """The slot's next chunk as :class:`_Programs` takes it — (token
        ids [C], table [P], start, first) with ``first`` the first token's
        sampling args when the chunk covers the prompt's end, else None —
        and the written end."""
        ids = slot.padded_ids[slot.next_pos : slot.next_pos + slot.chunk]
        written_end = slot.next_pos + slot.chunk
        first = None
        if written_end >= slot.prompt_len:
            req = slot.request
            # The first token from the last REAL position's hidden state.
            first = (slot.prompt_len - 1 - slot.next_pos, req.temperature,
                     req.top_k, req.top_p, req.seed)
        return (ids, slot.table, slot.next_pos, first), written_end

    def _mark_written(self, slot: _Slot, written_end: int) -> None:
        """Flip the registry nodes this slot's chunks have now written."""
        written_real = min(written_end, slot.prompt_len)
        for node, end_pos in slot.reg_nodes:
            if not node.ready and end_pos <= written_real:
                node.ready = True
        slot.next_pos = written_end

    def _prefill_step(self, idx: int) -> None:
        """Run ONE prefill chunk for slot ``idx`` as a standalone program
        (no decode batch to ride, or the fused step is off)."""
        slot = self._slots[idx]
        self._count_program("prefill")
        chunk, written_end = self._chunk_args(slot)
        first = self._progs.call("prefill", *chunk)
        if first is not None:
            first = int(first[0])  # host sync
        self._mark_written(slot, written_end)
        with self._lock:
            self._prefill_chunks += 1
        if first is not None:
            self._finish_prefill(idx, slot, first)

    def _finish_prefill(self, idx: int, slot: _Slot, first: int) -> None:
        """The final chunk landed: make the row visible to the decode
        program (table and true length) and flip it to decoding."""
        self._progs.call("install", idx, slot.table, slot.prompt_len)
        self._activate(idx, slot, first)

    def _activate(self, idx: int, slot: _Slot, first: int) -> None:
        """Flip a slot to decoding with its first sampled token."""
        req = slot.request
        slot.generated.append(first)
        slot.phase = "decode"
        slot.deps = []
        now = time.perf_counter()
        slot.t_first = now
        slot.t_last_tok = now
        if self._group_decode:
            # The row's prompt-prefix page run (full pages only: the
            # boundary page takes decode writes and must stay suffix).
            self._groups.add(idx, slot.pages[: slot.prompt_len // self.config.page_size])
        with self._lock:
            self._ttft_sum += now - req.t_submit
            self._ttft_count += 1
        self._last_tokens[idx] = first
        # The next dispatch feeds THIS row from the host mirror: its first
        # token came from prefill, not from the in-flight program's output.
        self._tok_dirty[idx] = True
        self._seeds[idx] = req.seed
        self._counts[idx] = 1  # token 0 sampled from prefill
        self._temps[idx] = req.temperature
        self._topks[idx] = req.top_k
        self._topps[idx] = req.top_p
        if (
            first == self.tokenizer.eos_id
            or req.max_new_tokens <= 1
            or self._hit_stop(slot)
        ):
            self._retire(idx)

    def _decoded_text(self, slot: _Slot) -> str:
        ids = [t for t in slot.generated if t != self.tokenizer.eos_id]
        return self.tokenizer.decode(ids)

    def _hit_stop(self, slot: _Slot) -> bool:
        """True when any stop sequence appears in the decoded text so far
        (checked after every sampled token)."""
        return self._vis_filter.confirmed_stop_hit(
            slot.generated,
            slot.request.stop,
            slot.request.stop_window,
            lambda: self._decoded_text(slot),
        )

    def _request_summary(self, slot: _Slot) -> dict:
        req = slot.request
        gaps = sorted(slot.gaps)

        def pct(q: float) -> float:
            return gaps[min(len(gaps) - 1, int(q * len(gaps)))] if gaps else 0.0

        return {
            "id": req.rid,
            "prompt_tokens": slot.prompt_len,
            "new_tokens": len(slot.generated),
            "ttft_s": (
                slot.t_first - req.t_submit if slot.t_first is not None else None
            ),
            "duration_s": time.perf_counter() - req.t_submit,
            "tbt_p50_s": pct(0.5),
            "tbt_p99_s": pct(0.99),
            "tbt_max_s": gaps[-1] if gaps else 0.0,
            "tbt_count": len(gaps),
            "header_pages_shared": slot.pages_shared_n,
        }

    def _retire(self, idx: int) -> None:
        slot = self._slots[idx]
        self._groups.remove(idx)
        self._progs.call("release", idx)
        pool = self._pools[self._shard_of_slot[idx]]
        with self._lock:
            # Refcounted release: private pages return to the free list;
            # shared pages stay for their other readers and the registry.
            for p in slot.pages:
                pool.release(p)
            self._slots[idx] = None
            self._completed += 1
            self._generated_tokens += len(slot.generated)
        text = self._decoded_text(slot)
        cut = earliest_stop_cut(text, slot.request.stop)
        if cut >= 0:
            text = text[:cut]
        if not slot.request.future.done():
            slot.request.future.set_result(
                ServeResult(
                    text=text,
                    num_tokens=len(slot.generated),
                    timing=self._request_summary(slot),
                )
            )

    def _sampling_rows(self, rows_now) -> tuple:
        """A step's sampling args for :meth:`_Programs._step`: each
        decoding row at its own (seed, count) stream, idle rows greedy
        (discarded)."""
        temps = np.zeros_like(self._temps)
        for i, _ in rows_now:
            temps[i] = self._temps[i]
        filters_active = any(
            s.request.top_k != 0 or s.request.top_p != 1.0 for _, s in rows_now
        )
        return temps, self._seeds, self._counts, self._topks, self._topps, filters_active

    def _dispatch(self, chunk_idx: int | None = None) -> None:
        """Enqueue ONE decode program for the current decode batch.

        Its input tokens are the previous program's device output (rows
        activated since then patched in from the host mirror), so the host
        does not wait for a fetch between programs. ``chunk_idx``: a ready
        prefilling slot whose next chunk rides this program (the fused
        step); its registry nodes flip ready here (every reader is a later
        program on the same stream or a flush-first operation), its
        activation waits for the fetch."""
        c = self.config
        dev = self.device
        rows_now = [
            (i, s) for i, s in enumerate(self._slots)
            if s is not None and s.phase == "decode"
        ]
        groups = self._groups.host_arrays() if self._group_decode else None
        t0 = time.perf_counter()
        overhead = None
        if self._last_step_end is not None:
            overhead = t0 - self._last_step_end
        elif self._inflight:
            overhead = 0.0
        if overhead is not None:
            with self._lock:
                self._sched_overhead_sum += overhead
                self._sched_overhead_count += 1
        self._last_step_end = None
        dirty = np.array(self._tok_dirty)
        self._tok_dirty[:] = False
        chunk = chunk_rec = None
        if chunk_idx is not None:
            slot = self._slots[chunk_idx]
            chunk, written_end = self._chunk_args(slot)
            chunk_rec = _InflightChunk(idx=chunk_idx, slot=slot, done=chunk[3] is not None)
        next_tok, first = self._progs.call(
            "step", bool(self._inflight), dirty, self._last_tokens, chunk,
            groups, self._sampling_rows(rows_now),
        )
        if chunk_rec is None:
            self._count_program("decode", rows=len(rows_now))
        else:
            self._count_program("fused", rows=len(rows_now) + 1)
            self._mark_written(chunk_rec.slot, written_end)
        for i, _ in rows_now:
            self._counts[i] += 1
        # The tokens (and a final chunk's first token) come back through a
        # pinned buffer behind this program; the event marks their arrival.
        on_card = dev.type == "cuda"
        host = torch.empty(c.max_slots + 1, dtype=torch.int32, pin_memory=on_card)
        host[: c.max_slots].copy_(next_tok, non_blocking=on_card)
        if first is not None:
            host[c.max_slots :].copy_(first, non_blocking=on_card)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        self._inflight.append(
            _Inflight(host=host, event=event, t0=t0, rows=rows_now, chunk=chunk_rec)
        )
        if groups is not None:
            saved = self._groups.saved_tokens_per_step * self._kv_token_bytes
            with self._lock:
                self._kv_bytes_saved += saved
                self._group_rows_sum += self._groups.grouped_rows
                self._groups_sum += self._groups.n_groups

    def _fetch_one(self) -> None:
        """Read the OLDEST in-flight program's tokens and run its host
        bookkeeping: stop checks, retirement, a fused chunk's activation.

        Retirement lags dispatch by the in-flight depth: a row finished in
        program n keeps decoding through the programs already enqueued;
        those tokens are discarded here (rows are credited by slot
        identity) and their K/V writes land in pages budgeted by
        :meth:`_table_pages`."""
        rec = self._inflight.popleft()
        if rec.event is not None:
            rec.event.synchronize()  # waits for THIS program only
        host = rec.host.numpy()
        step_end = time.perf_counter()
        start = rec.t0
        if self._last_fetch_end is not None:
            start = max(start, self._last_fetch_end)
        dur = step_end - start
        self._last_fetch_end = step_end
        self._last_step_end = step_end if not self._inflight else None
        self._hb_step = time.monotonic()
        alive = [(i, s) for i, s in rec.rows if self._slots[i] is s]
        with self._lock:
            self._decode_steps += 1
            self._decode_step_sum += dur
            self._decode_step_count += 1
        tbt_sum, tbt_count = 0.0, 0
        for i, slot in alive:
            tok = int(host[i])
            slot.generated.append(tok)
            self._last_tokens[i] = tok
            gap = step_end - slot.t_last_tok
            slot.t_last_tok = step_end
            slot.gaps.append(gap)
            tbt_sum += gap
            tbt_count += 1
            if (
                tok == self.tokenizer.eos_id
                or len(slot.generated) >= slot.request.max_new_tokens
                or self._hit_stop(slot)
            ):
                self._retire(i)
        if tbt_count:
            with self._lock:
                self._tbt_sum += tbt_sum
                self._tbt_count += tbt_count
        ch = rec.chunk
        if ch is not None and self._slots[ch.idx] is ch.slot:
            with self._lock:
                self._prefill_chunks += 1
            if ch.done:
                self._finish_prefill(ch.idx, ch.slot, int(host[self.config.max_slots]))

    def _run_guarded(self) -> None:
        """The worker thread: the loop on the batcher's device, under
        inference mode. A failure fails every pending request (and stops
        the batcher) instead of leaving their futures to hang."""
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._run()
        except BaseException as e:  # noqa: BLE001 - reported to every caller
            log.exception("continuous batcher loop failed")
            self._stop.set()
            with self._lock:
                self._fail_all(RuntimeError(f"batcher loop failed: {e!r}"))

    def _run(self) -> None:
        c = self.config
        while not self._stop.is_set():
            self._hb_tick = time.monotonic()
            self._admit()
            progress = False
            ran_program = False
            chunk_idx = self._pick_prefill_slot()
            fused_ok = c.ragged_attention
            fused = chunk_idx is not None and fused_ok and self._decoding()
            if chunk_idx is not None and not fused:
                self._prefill_step(chunk_idx)
                progress = True
                ran_program = True
                if fused_ok:
                    with self._lock:
                        self._work_iterations += 1
                    continue
            if self._decoding():
                self._dispatch(chunk_idx if fused else None)
                while len(self._inflight) >= max(1, c.pipeline_depth):
                    self._fetch_one()
                progress = True
                ran_program = True
            else:
                if self._inflight:
                    self._fetch_one()
                    progress = True
                if not self._decoding():
                    self._last_step_end = None
            if ran_program:
                with self._lock:
                    self._work_iterations += 1
            if not progress:
                self._last_step_end = None
                self._work.wait(timeout=0.1)
                self._work.clear()
                if self._progs.sends and time.monotonic() - self._progs.last_send > _MESH_IDLE_TICK_S:
                    self._progs.call("idle")


class ContinuousBackend(_backend_base.Backend):
    """Backend seam over a :class:`ContinuousBatcher`: the Coordinator's
    panel fan-out (``generate_batch``) rides token-level continuous
    batching, each request joining the running decode batch."""

    def __init__(self, batcher: ContinuousBatcher):
        self.batcher = batcher

    async def generate_batch(self, requests):
        import asyncio

        futs = []
        try:
            for r in requests:
                futs.append(
                    self.batcher.submit(
                        r.prompt,
                        max_new_tokens=r.params.max_new_tokens,
                        temperature=r.params.temperature,
                        seed=r.params.seed,
                        top_k=r.params.top_k,
                        top_p=r.params.top_p,
                        stop=r.params.stop,
                    )
                )
        except (RuntimeError, ValueError) as e:
            # Cancel the futures still waiting so their device work is not
            # orphaned (_retire skips done futures).
            for f in futs:
                f.cancel()
            raise _backend_base.BackendError(f"continuous submit failed: {e}") from e
        outs = await asyncio.gather(*(asyncio.wrap_future(f) for f in futs))
        return [
            _backend_base.GenerationResult(
                text=o.text, num_tokens=o.num_tokens, meta=o.timing
            )
            for o in outs
        ]

    def health(self) -> dict:
        """Readiness probe surface: the batcher heartbeat."""
        return self.batcher.heartbeat()

    @property
    def tokenizer(self):
        return self.batcher.tokenizer

    async def close(self) -> None:
        self.batcher.close()
