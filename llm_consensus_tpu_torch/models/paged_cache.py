"""Paged KV cache: fixed page pool + per-sequence page tables.

Counterpart of ``llm_consensus_tpu.models.paged_cache``: one global pool
of fixed-size pages, each sequence owning an ordered list of page ids.
Admission and retirement change data (page tables, lengths), never
shapes.

Layout (the JAX package's):
- pool k/v: ``[L, n_pages, page_size, Hkv, Dh]``
- page_table: ``[max_seqs, pages_per_seq]`` int32 page ids (unused
  entries can hold any valid id; masking is by ``length``).
- length: ``[max_seqs]`` int32 tokens written per sequence.

Page 0 is reserved as the "null" page so freshly-reset tables are valid.

Difference by design: the device functions update the cache IN PLACE
(``index_put_``, ``copy_``) and return it, where the JAX package returns
a new tree. Every update is a kernel on the cache's stream, so it lands
after every program already enqueued there and before every later one.

The host side is the JAX package's, copied: :class:`PagePool`
(refcounted page allocator, what makes copy-on-write page sharing safe),
:class:`PrefixRegistry` (radix tree of page-aligned prompt prefixes) and
:class:`GroupTracker` (which decoding sequences share a prefix page run,
for the grouped read of the ragged attention kernel). The host tier's
``install_page``/``install_pages`` are not ported yet.

On a dp x mp mesh each rank holds one shard (``create(..., mesh=)``):
the pages of its data shard (global ids ``[d * n_pages/dp, (d + 1) *
n_pages/dp)``), their Hkv/mp kv heads, and the table rows and lengths of
its data shard's slots (``[d * max_seqs/dp, (d + 1) * max_seqs/dp)``).
Tables keep GLOBAL page ids; the attention kernel (K9) rebases them.
Every device update names global ids and lands on the owner shard alone:
:func:`install_seq`/:func:`release_seq` on the slot's shard,
:func:`copy_page` on the page's shard, and the paged steps' K/V writes
(``models.transformer._write_pages``). Each shard reserves its first page
(the NULL page on shard 0): the allocator never hands it out, and writes
a shard drops land there.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

from llm_consensus_tpu_torch.models.configs import ModelConfig
from llm_consensus_tpu_torch.utils.device import h2d, resolve_device

NULL_PAGE = 0


def prefix_chain_key(
    ids: Sequence[int], page_size: int
) -> tuple[tuple[int, ...], ...]:
    """A prompt's page-aligned prefix-chain fingerprint: the tuple of
    page-sized token runs that key the :class:`PrefixRegistry` radix
    walk, capped at the USABLE full pages (at least the last prompt
    token is always recomputed — the same ``usable_full`` cap
    :meth:`PrefixRegistry.match` applies)."""
    usable_full = (len(ids) - 1) // page_size
    return tuple(
        tuple(int(t) for t in ids[k * page_size : (k + 1) * page_size])
        for k in range(usable_full)
    )


@dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, n_pages, page_size, Hkv, Dh]
    v: torch.Tensor
    page_table: torch.Tensor  # [max_seqs, pages_per_seq] int32
    length: torch.Tensor  # [max_seqs] int32
    # On a mesh: the global id of this shard's first page, the global
    # index of its first row, and the number of data shards (0, 0 and 1
    # off a mesh).
    page_offset: int = 0
    row_offset: int = 0
    data_shards: int = 1

    @staticmethod
    def create(
        cfg: ModelConfig,
        n_pages: int,
        page_size: int,
        max_seqs: int,
        pages_per_seq: int,
        dtype=torch.bfloat16,
        device: str | torch.device | None = None,
        mesh=None,
    ) -> "PagedKVCache":
        """A zeroed pool of ``n_pages`` pages and ``max_seqs`` NULL rows;
        with ``mesh``, this rank's shard of it on the mesh's device (the
        sizes must divide: ``transformer.check_mesh_shardable`` raises)."""
        hkv, off_p, off_r, dp = cfg.n_kv_heads, 0, 0, 1
        if mesh is None:
            dev = resolve_device(device)
        else:
            # Imported here: the transformer imports this module.
            from llm_consensus_tpu_torch.models.transformer import check_mesh_shardable

            check_mesh_shardable(cfg, mesh, max_seqs, n_pages)
            dev = mesh.device_for(device)
            dp, mp, d = mesh.size("data"), mesh.size("model"), mesh.index("data")
            n_pages, max_seqs, hkv = n_pages // dp, max_seqs // dp, hkv // mp
            off_p, off_r = d * n_pages, d * max_seqs
        shape = (cfg.n_layers, n_pages, page_size, hkv, cfg.head_dim)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            page_table=torch.full(
                (max_seqs, pages_per_seq), NULL_PAGE, dtype=torch.int32, device=dev
            ),
            length=torch.zeros((max_seqs,), dtype=torch.int32, device=dev),
            page_offset=off_p,
            row_offset=off_r,
            data_shards=dp,
        )

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_seqs(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    def local_row(self, seq_id: int) -> int | None:
        """The row of global slot ``seq_id`` in this shard, or None when
        another shard holds it; IndexError outside every shard."""
        return self._local(int(seq_id), self.row_offset, self.max_seqs, "slot")

    def local_page(self, page: int) -> int | None:
        """The pool index of global page ``page`` in this shard, or None
        when another shard holds it; IndexError outside every shard."""
        return self._local(int(page), self.page_offset, self.n_pages, "page")

    def _local(self, i: int, offset: int, n: int, what: str) -> int | None:
        if not 0 <= i < n * self.data_shards:
            raise IndexError(f"{what} {i} outside 0..{n * self.data_shards - 1}")
        return i - offset if 0 <= i - offset < n else None


def _on(cache: PagedKVCache, x, dtype=torch.int32) -> torch.Tensor:
    """A tensor, or a host value (int, list, numpy array), on the cache's
    device (host values through :func:`~llm_consensus_tpu_torch.utils.
    device.h2d`: copied first, ordered on the stream, no host wait)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=cache.length.device, dtype=dtype)
    return h2d(x, cache.length.device, dtype)


def gather_seq_kv(
    cache: PagedKVCache, seq_ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize contiguous [L, B, pages_per_seq*page, Hkv, Dh] K/V for
    the given sequences (the plain gather path)."""
    tables = cache.page_table[seq_ids].long()  # [B, P]
    k = cache.k[:, tables]  # [L, B, P, page, Hkv, Dh]
    v = cache.v[:, tables]
    L, b, p, pg, h, d = k.shape
    return k.reshape(L, b, p * pg, h, d), v.reshape(L, b, p * pg, h, d)


def write_decode_kv(
    cache: PagedKVCache,
    seq_ids: torch.Tensor,  # [B]
    k_new: torch.Tensor,  # [L, B, Hkv, Dh]
    v_new: torch.Tensor,
) -> PagedKVCache:
    """Write one token's K/V for each sequence at its current length
    (in place) and advance those lengths by one."""
    seq_ids = seq_ids.long()
    pos = cache.length[seq_ids].long()
    pages = cache.page_table[seq_ids, pos // cache.page_size].long()
    offset = pos % cache.page_size
    cache.k[:, pages, offset] = k_new.to(cache.k.dtype)
    cache.v[:, pages, offset] = v_new.to(cache.v.dtype)
    cache.length[seq_ids] += 1
    return cache


def write_prefill_kv(
    cache: PagedKVCache,
    seq_id: int,
    k_seq: torch.Tensor,  # [L, S, Hkv, Dh] (S = padded prompt bucket)
    v_seq: torch.Tensor,
    length: int,
) -> PagedKVCache:
    """Scatter one prefilled sequence's K/V into its assigned pages (in
    place). S must be a multiple of page_size; slots past ``length``
    hold padding garbage, masked out of attention by ``length``."""
    L, s, h, d = k_seq.shape
    pg = cache.page_size
    if s % pg:
        raise ValueError(f"prefill length {s} not a multiple of page {pg}")
    n = s // pg
    pages = cache.page_table[seq_id, :n].long()
    cache.k[:, pages] = k_seq.reshape(L, n, pg, h, d).to(cache.k.dtype)
    cache.v[:, pages] = v_seq.reshape(L, n, pg, h, d).to(cache.v.dtype)
    cache.length[seq_id] = int(length)
    return cache


def assign_pages(cache: PagedKVCache, seq_id: int, pages) -> PagedKVCache:
    """Install a page list (padded with NULL_PAGE) for one sequence."""
    cache.page_table[seq_id] = _on(cache, pages)
    return cache


def release_seq(cache: PagedKVCache, seq_id: int) -> PagedKVCache:
    """Clear a sequence's table/length (page recycling is host-side). On a
    mesh only the slot's shard holds the row."""
    row = cache.local_row(seq_id)
    if row is not None:
        cache.page_table[row] = NULL_PAGE
        cache.length[row] = 0
    return cache


def install_seq(cache: PagedKVCache, seq_id: int, pages, length: int) -> PagedKVCache:
    """Install table AND length for one sequence — the moment a
    chunk-prefilled sequence (whose pages were written through an
    explicit host-side table, invisible to the decode program) becomes a
    live decode row. On a mesh only the slot's shard holds the row."""
    row = cache.local_row(seq_id)
    if row is not None:
        cache.page_table[row] = _on(cache, pages)
        cache.length[row] = int(length)
    return cache


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy one page's K/V across all layers (``src`` -> ``dst``).

    The copy-on-write primitive: when an admission's prompt shares a
    registered prefix that ends INSIDE a page, that boundary page's
    already-computed K/V is copied into a freshly-allocated private
    page — sharing it would let this sequence's later writes corrupt
    every other reader. Stream-ordered before any later program that
    writes past the copied run. On a mesh it runs on the pages' shard
    alone (a prefix registry and its pages never span shards).
    """
    s, d = cache.local_page(src), cache.local_page(dst)
    if (s is None) != (d is None):
        raise ValueError(f"copy_page {src} -> {dst} crosses data shards")
    if s is not None:
        cache.k[:, d].copy_(cache.k[:, s])
        cache.v[:, d].copy_(cache.v[:, s])
    return cache


# ---------------------------------------------------------------------------
# Host-side allocation: refcounted pages + prefix radix tree
# ---------------------------------------------------------------------------


class PagePool:
    """Refcounted host-side page allocator over a fixed id range.

    A page is free exactly when its refcount is zero. Fresh allocations
    start at refcount 1; mapping an existing page into another sequence's
    table goes through :meth:`share`; every holder (sequences AND the
    prefix registry) pairs its hold with exactly one :meth:`release`.
    Not thread-safe — the continuous batcher's worker owns its pool.
    """

    def __init__(self, page_ids: Iterable[int]):
        self._free: deque[int] = deque(page_ids)
        self._rc: dict[int, int] = {}

    @property
    def available(self) -> int:
        """Pages allocatable right now (excludes shared/cached pages)."""
        return len(self._free)

    @property
    def held(self) -> int:
        return len(self._rc)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)}"
            )
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def share(self, page: int) -> None:
        if page not in self._rc:
            raise ValueError(f"page {page} is not allocated")
        self._rc[page] += 1

    def release(self, page: int) -> None:
        rc = self._rc.get(page)
        if rc is None:
            raise ValueError(f"page {page} is not allocated")
        if rc == 1:
            del self._rc[page]
            self._free.append(page)
        else:
            self._rc[page] = rc - 1


@dataclass
class _PrefixNode:
    """One page-sized token run in the prefix radix tree."""

    tokens: tuple[int, ...]
    page: int
    parent: "_PrefixNode | None"
    children: dict[tuple[int, ...], "_PrefixNode"] = field(default_factory=dict)
    # Content of ``page`` is fully written (the registering sequence's
    # prefill has passed this page's end). Content readers wait for it;
    # the page id itself is safe to map at once.
    ready: bool = False
    last_used: int = 0  # LRU tick for eviction


@dataclass
class PrefixMatch:
    """What an admission gets back from :meth:`PrefixRegistry.match`."""

    pages: list[int]  # full shared pages, prefix order (refs bumped)
    nodes: list[_PrefixNode]  # their nodes (readiness gates)
    shared_tokens: int  # len(pages) * page_size
    # Boundary page eligible for copy-on-write: its first
    # ``boundary_common`` tokens extend this prompt's prefix past the
    # full-page match. None when no ready partially-matching sibling
    # exists.
    boundary_page: int | None = None
    boundary_common: int = 0


class PrefixRegistry:
    """Radix tree of page-aligned prompt prefixes over one PagePool.

    Nodes are keyed by the exact token tuple of each page-sized run. The
    registry holds one refcount on every node's page; :meth:`match` bumps
    refcounts for the caller (released per page on retirement).
    Registration happens at ADMISSION (before content exists) so that a
    burst of same-prefix requests dedups against the FIRST request's
    in-flight prefill; ``_PrefixNode.ready`` gates content readers.
    """

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self._root = _PrefixNode(tokens=(), page=NULL_PAGE, parent=None)
        self._nodes = 0
        self._tick = 0
        self.lookups = 0
        self.hits = 0
        self.pages_shared = 0
        self.pages_copied = 0
        self.evictions = 0

    def __len__(self) -> int:
        return self._nodes

    @property
    def cached_pages(self) -> int:
        return self._nodes

    def reclaimable_pages(self) -> int:
        """Registry pages held by nobody else AND freeable via
        :meth:`evict` (which drops leaves only, so an interior page is
        reclaimable only when its whole subtree is)."""

        def subtree(node: _PrefixNode) -> tuple[int, bool]:
            total, children_ok = 0, True
            for child in node.children.values():
                n, ok = subtree(child)
                total += n
                children_ok = children_ok and ok
            ok = children_ok and self.pool.refcount(node.page) == 1
            return total + (1 if ok else 0), ok

        return sum(subtree(c)[0] for c in self._root.children.values())

    def _walk(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def match(self, ids: Sequence[int], min_boundary: int = 1) -> PrefixMatch:
        """Longest registered page-aligned prefix of ``ids``, capped at
        ``len(ids) - 1`` tokens (the last prompt token is always
        recomputed). Matched pages' refcounts are bumped FOR THE CALLER.
        The boundary page (a ready sibling run extending the match
        part-way, by at least ``min_boundary`` tokens) is reported for
        copy-on-write but NOT ref-bumped."""
        pg = self.page_size
        self.lookups += 1
        self._tick += 1
        node = self._root
        pages: list[int] = []
        nodes: list[_PrefixNode] = []
        usable_full = (len(ids) - 1) // pg
        k = 0
        while k < usable_full:
            key = tuple(int(t) for t in ids[k * pg : (k + 1) * pg])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            self.pool.share(child.page)
            pages.append(child.page)
            nodes.append(child)
            node = child
            k += 1
        match = PrefixMatch(pages=pages, nodes=nodes, shared_tokens=k * pg)
        rem = tuple(int(t) for t in ids[k * pg :])
        cap = len(rem) - 1  # leave >= 1 token to prefill
        if cap > 0:
            best, best_child = 0, None
            for key, child in node.children.items():
                if not child.ready:
                    continue
                common = 0
                for a, b in zip(key, rem):
                    if a != b:
                        break
                    common += 1
                if common > best:
                    best, best_child = common, child
            if best_child is not None and min(best, cap) >= min_boundary:
                best_child.last_used = self._tick
                match.boundary_page = best_child.page
                match.boundary_common = min(best, cap)
        return match

    def probe(self, ids: Sequence[int]) -> tuple[list[_PrefixNode], int]:
        """Read-only longest-prefix walk: the registered nodes covering
        this prompt's page-aligned prefix and the tokens they span. No
        refcount bumps, LRU ticks or counters. Unready nodes count."""
        pg = self.page_size
        node = self._root
        nodes: list[_PrefixNode] = []
        usable_full = (len(ids) - 1) // pg
        k = 0
        while k < usable_full:
            key = tuple(int(t) for t in ids[k * pg : (k + 1) * pg])
            child = node.children.get(key)
            if child is None:
                break
            nodes.append(child)
            node = child
            k += 1
        return nodes, k * pg

    def record_commit(self, match: PrefixMatch, copied: bool) -> None:
        """Count a match the caller actually ADMITTED on (a plan that
        rolls back never inflates hits/pages_shared)."""
        if match.pages or match.boundary_common:
            self.hits += 1
        self.pages_shared += len(match.pages)
        if copied:
            self.pages_copied += 1

    def register(
        self, ids: Sequence[int], pages: Sequence[int]
    ) -> list[tuple[_PrefixNode, int]]:
        """Offer a sequence's full prompt pages to the tree.

        ``pages[i]`` must hold tokens ``ids[i*pg : (i+1)*pg]`` (or be
        about to). Runs already present are skipped. Returns the
        [(node, end_position)] list of NEWLY created nodes the caller
        marks ready as its prefill writes past each ``end_position``.
        """
        pg = self.page_size
        self._tick += 1
        node = self._root
        created: list[tuple[_PrefixNode, int]] = []
        full = min(len(ids) // pg, len(pages))
        for k in range(full):
            key = tuple(int(t) for t in ids[k * pg : (k + 1) * pg])
            child = node.children.get(key)
            if child is None:
                self.pool.share(pages[k])  # the registry's own hold
                child = _PrefixNode(tokens=key, page=pages[k], parent=node)
                node.children[key] = child
                self._nodes += 1
                created.append((child, (k + 1) * pg))
            child.last_used = self._tick
            node = child
        return created

    @staticmethod
    def mark_ready(node: _PrefixNode) -> None:
        node.ready = True

    @staticmethod
    def chain_tokens(node: _PrefixNode) -> tuple[int, ...]:
        """Every token from the prefix root through ``node``'s page (a
        page's K/V is a function of the whole chain above it)."""
        runs: list[tuple[int, ...]] = []
        while node is not None and node.parent is not None:
            runs.append(node.tokens)
            node = node.parent
        return tuple(t for run in reversed(runs) for t in run)

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` registry-only pages, LRU leaves first
        (a parent enters the heap when its last child goes). Only leaves
        whose page nobody else holds are dropped. Returns pages freed."""
        heap = [
            (node.last_used, id(node), node)
            for node in self._walk()
            if not node.children and self.pool.refcount(node.page) == 1
        ]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_pages:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.tokens]
            self.pool.release(victim.page)
            self._nodes -= 1
            self.evictions += 1
            freed += 1
            if (
                parent is not self._root
                and not parent.children
                and self.pool.refcount(parent.page) == 1
            ):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed


# ---------------------------------------------------------------------------
# Decode groups: which resident sequences share a prefix page run
# ---------------------------------------------------------------------------


@dataclass
class DecodeGroupArrays:
    """Device-side group metadata for the ragged kernel's group pass
    (:func:`llm_consensus_tpu_torch.ops.kernels.ragged_attention.
    paged_decode_attention_grouped`).

    All int32. ``group_id`` [max_seqs]: group per row, -1 ungrouped;
    ``group_rep`` [Gm]: a member row whose page table holds the group's
    shared run; ``group_pages`` [Gm]: pages in that run (0 = padding
    slot); ``shared_start`` [max_seqs]: tokens the shared phase covers
    per row (page-aligned; 0 for ungrouped rows).
    """

    group_id: torch.Tensor
    group_rep: torch.Tensor
    group_pages: torch.Tensor
    shared_start: torch.Tensor

    @staticmethod
    def from_host(host: tuple, device: torch.device, rows: slice = slice(None)):
        """The arrays of :meth:`GroupTracker.host_arrays`'s tuple on
        ``device``; ``rows``: the rows of group_id and shared_start kept
        (a data shard's, on a mesh), group_rep and group_pages whole."""
        gid, rep, gpages, start = host
        return DecodeGroupArrays(
            h2d(gid[rows], device), h2d(rep, device), h2d(gpages, device),
            h2d(start[rows], device),
        )


class GroupTracker:
    """Host-side decode-group metadata over shared prefix page runs.

    Every decoding sequence registers its PREFIX RUN — the page ids of
    its prompt's full pages, in table order. Two runs that begin with the
    same page ids hold the same tokens by construction (pages are shared
    only through the :class:`PrefixRegistry`), so sequences are grouped
    by the longest common prefix of their runs, one level deep (per
    first-page bucket). Single-member buckets emit nothing and only the
    ``max_groups`` largest groups emit; overflow rows stay ungrouped,
    correct either way. ``device``: where :meth:`arrays` puts its
    tensors. Not thread-safe: the batcher's worker owns it.
    """

    def __init__(
        self,
        max_seqs: int,
        page_size: int,
        max_groups: int | None = None,
        device: str | torch.device = "cpu",
    ):
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.max_groups = max_groups or max(1, max_seqs // 2)
        self.device = torch.device(device)
        self._run_of_seq: dict[int, tuple[int, ...]] = {}
        self._dirty = True
        self._cached: DecodeGroupArrays | None = None
        self._cached_host: tuple[np.ndarray, ...] | None = None
        # Stats for the arrays most recently built: KV tokens the grouped
        # read dedups per decode step, the largest group's member count,
        # and the lifetime high-water mark of the latter.
        self.saved_tokens_per_step = 0
        self.largest_group = 0
        self.peak_group = 0
        # Groups emitted and the rows in them (the mean group size).
        self.n_groups = 0
        self.grouped_rows = 0

    def add(self, seq_id: int, prefix_run: Sequence[int]) -> None:
        """Register a decoding sequence's prompt prefix page run (no-op
        for an empty run — a sub-page prompt stays ungrouped)."""
        run = tuple(int(p) for p in prefix_run)
        self.remove(seq_id)
        if not run:
            return
        self._run_of_seq[seq_id] = run
        self._dirty = True

    def remove(self, seq_id: int) -> None:
        if self._run_of_seq.pop(seq_id, None) is not None:
            self._dirty = True

    def stream_buckets(self) -> list[list[int]]:
        """Registered seqs bucketed by shared FIRST prefix page; only
        buckets of >= 2 members return."""
        buckets: dict[int, list[int]] = {}
        for seq, run in self._run_of_seq.items():
            buckets.setdefault(run[0], []).append(seq)
        return [sorted(s) for s in buckets.values() if len(s) >= 2]

    @staticmethod
    def _common_prefix(runs: list[tuple[int, ...]]) -> int:
        k = 0
        for pages in zip(*runs):
            if any(p != pages[0] for p in pages[1:]):
                break
            k += 1
        return k

    def arrays(self) -> DecodeGroupArrays | None:
        """Current group metadata as tensors on ``device``, or None when
        no group has >= 2 members (the caller then runs the ungrouped
        call)."""
        if self._dirty:
            host = self.host_arrays()
            self._cached = None if host is None else DecodeGroupArrays.from_host(
                host, self.device
            )
        return self._cached

    def host_arrays(self) -> tuple[np.ndarray, ...] | None:
        """:meth:`arrays` as numpy (group_id, group_rep, group_pages,
        shared_start), or None: what a mesh's scheduler sends its ranks."""
        if not self._dirty:
            return self._cached_host
        self._dirty = False
        pg = self.page_size
        buckets: dict[int, list[int]] = {}
        for seq, run in self._run_of_seq.items():
            buckets.setdefault(run[0], []).append(seq)
        groups: list[tuple[int, list[int]]] = []  # (lcp_pages, members)
        for seqs in buckets.values():
            if len(seqs) < 2:
                continue
            lcp = self._common_prefix([self._run_of_seq[s] for s in seqs])
            if lcp > 0:
                groups.append((lcp, sorted(seqs)))
        groups.sort(key=lambda g: -(g[0] * len(g[1])))
        groups = groups[: self.max_groups]
        if not groups:
            self._cached = self._cached_host = None
            self.saved_tokens_per_step = 0
            self.largest_group = 0
            self.n_groups = self.grouped_rows = 0
            return None
        gid = np.full((self.max_seqs,), -1, np.int32)
        rep = np.zeros((self.max_groups,), np.int32)
        gpages = np.zeros((self.max_groups,), np.int32)
        start = np.zeros((self.max_seqs,), np.int32)
        saved = 0
        largest = 0
        for g, (lcp, members) in enumerate(groups):
            rep[g] = members[0]
            gpages[g] = lcp
            largest = max(largest, len(members))
            saved += (len(members) - 1) * lcp * pg
            for s in members:
                gid[s] = g
                start[s] = lcp * pg
        self.saved_tokens_per_step = saved
        self.largest_group = largest
        self.n_groups = len(groups)
        self.grouped_rows = sum(len(m) for _, m in groups)
        self.peak_group = max(self.peak_group, largest)
        self._cached_host = (gid, rep, gpages, start)
        return self._cached_host
