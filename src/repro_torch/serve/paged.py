"""Paged KV cache: block pool, page allocator, block tables — the pool and
allocator half of ``repro/serve/paged.py``, on torch tensors.

Each dense KV cache ``[L, B, Hkv, max_len, hd]`` becomes a pool
``[L, P, Hkv, page_size, hd]``: axis 1 indexes *pages* instead of slots.  A
per-slot block table ``[slots, max_len / page_size]`` maps logical page
indices to pool pages; one table serves every layer and both of k and v.
Page 0 is reserved as a scratch ("trash") page: unmapped table entries point
at it, so the fused decode's masked dummy writes land somewhere harmless
instead of on a live page.

The allocator is pure Python and comes over unchanged, refcounts, ``share``
and ``quarantine`` included (prefix sharing and integrity, ROADMAP 8g/8h,
will use them).  The prefill scatter writes the pool in place, where JAX
returned a new tree; a chunked prefill writes the pool from inside the model
(``layers.attention_prefill_chunk_paged``), so no chunk scatter is needed.

Preemption's snapshots (:func:`gather_pages`, :func:`restore_pages`) and
the budgeted host tier they spill into (:class:`HostArena`) come over too.
A snapshot is a pair of host tensors, copied off the card before the
victim's pages are freed; a restore writes the pool in place with
``index_copy_`` on the page axis and never makes a new pool tensor, since a
captured decode graph holds the pool's address.  On the card a refill is
copied up ahead of need on a side stream (:class:`StagedRefill`) and lands
in the pool when its request resumes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

TRASH_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """A page allocation found the pool empty.

    Unreachable when admission runs with ``AdmissionPolicy.growth_reserve``
    = 1.0 (every admitted request's worst-case page count is accounted
    before admission).
    """


@dataclasses.dataclass
class PageStats:
    total_pages: int                 # usable pages (scratch page excluded)
    free_pages: int
    allocated_pages: int
    high_water: int                  # max simultaneously allocated
    allocs: int
    frees: int
    quarantined: int = 0             # retired after a digest mismatch
    shared_pages: int = 0            # pages with refcount > 1 right now
    shares: int = 0                  # cumulative share() grants


class PageAllocator:
    """Free-list allocator over the global block pool, with refcounts.

    Page 0 is never handed out (the scratch page for masked writes).
    A page may be held by *several* owners at once: ``allocate`` mints a
    page with one owner, ``share`` adds an owner to an allocated page, and
    ``free`` drops one owner's reference — the page returns to the
    free-list only when its last reference goes.  Double-free, foreign-free,
    and double-share are hard errors so serving bugs surface as exceptions,
    not silent corruption.
    """

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError(
                f"need >= 2 pages (1 scratch + 1 usable), got {num_pages}"
            )
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._owners: dict[int, set[int]] = {}  # page -> owner uids
        self._quarantined: set[int] = set()     # retired (digest mismatch)
        self._refs_outstanding = 0
        self._high_water = 0
        self._allocs = 0
        self._frees = 0
        self._shares = 0

    @property
    def total_pages(self) -> int:
        # scratch page is not usable; quarantined pages left circulation
        return self.num_pages - 1 - len(self._quarantined)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return len(self._owners)

    @property
    def shared_pages(self) -> int:
        """Pages currently held by more than one owner."""
        return sum(1 for owners in self._owners.values() if len(owners) > 1)

    def allocate(self, owner: int, n: int = 1) -> list[int]:
        """Take ``n`` pages for ``owner`` (a request uid). All-or-nothing."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"requested {n} pages, {len(self._free)} free "
                f"({self.allocated_pages}/{self.total_pages} allocated) — "
                "admission overcommitted (growth_reserve < 1.0)?"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owners[p] = {owner}
        self._allocs += n
        self._refs_outstanding += n
        self._high_water = max(self._high_water, len(self._owners))
        return pages

    def share(self, page: int, owner: int) -> None:
        """Add ``owner`` as a reader of an already-allocated ``page``.

        The page must be live (allocated to at least one other owner) and
        ``owner`` must not already hold it — sharing a free, quarantined,
        or already-held page is a hard error.
        """
        if page == TRASH_PAGE:
            raise ValueError("cannot share the scratch page")
        owners = self._owners.get(page)
        if owners is None:
            state = "quarantined" if page in self._quarantined else "free"
            raise ValueError(f"cannot share {state} page {page}")
        if owner in owners:
            raise ValueError(f"request {owner} already holds page {page}")
        owners.add(owner)
        self._shares += 1
        self._refs_outstanding += 1

    def free(self, owner: int, pages: list[int]) -> list[int]:
        """Drop ``owner``'s reference on each of ``pages``; every page must
        be held by ``owner``.  Returns the pages whose *last* reference was
        dropped — the ones actually returned to the free-list.
        """
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("cannot free the scratch page")
            owners = self._owners.get(p)
            if owners is None:
                raise ValueError(f"double free of page {p}")
            if owner not in owners:
                raise ValueError(
                    f"page {p} belongs to request(s) {sorted(owners)}, "
                    f"not {owner}"
                )
        released = []
        for p in pages:
            owners = self._owners[p]
            owners.discard(owner)
            self._refs_outstanding -= 1
            if not owners:
                del self._owners[p]
                self._free.append(p)
                released.append(p)
        self._frees += len(pages)
        return released

    def pages_of(self, owner: int) -> list[int]:
        return [p for p, o in self._owners.items() if owner in o]

    def owner_of(self, page: int) -> int | None:
        """One holder uid of ``page`` (the smallest, for determinism), or
        None if free/quarantined.  Use :meth:`owners_of` for all readers."""
        owners = self._owners.get(page)
        return min(owners) if owners else None

    def owners_of(self, page: int) -> set[int]:
        """All holder uids of ``page`` (empty if free/quarantined)."""
        return set(self._owners.get(page, ()))

    def refcount(self, page: int) -> int:
        return len(self._owners.get(page, ()))

    def quarantine(self, page: int) -> None:
        """Retire ``page`` from circulation after a digest mismatch.

        The page must currently be free; it never returns to the free list,
        so the pool permanently shrinks by one page.
        """
        if page == TRASH_PAGE:
            raise ValueError("cannot quarantine the scratch page")
        owners = self._owners.get(page)
        if owners:
            raise ValueError(
                f"page {page} still belongs to request(s) {sorted(owners)}; "
                "release every reader before quarantining"
            )
        try:
            self._free.remove(page)
        except ValueError:
            raise ValueError(
                f"page {page} is not in the pool (already quarantined?)"
            ) from None
        self._quarantined.add(page)

    @property
    def quarantined_pages(self) -> int:
        return len(self._quarantined)

    def stats(self) -> PageStats:
        return PageStats(
            total_pages=self.total_pages,
            free_pages=self.free_pages,
            allocated_pages=self.allocated_pages,
            high_water=self._high_water,
            allocs=self._allocs,
            frees=self._frees,
            quarantined=len(self._quarantined),
            shared_pages=self.shared_pages,
            shares=self._shares,
        )

    def check_invariants(self) -> None:
        """free + allocated + quarantined must tile the pool, no aliasing,
        and references must conserve: every allocated page has >= 1 owner
        and the per-page owner sets sum to the outstanding-reference
        counter (allocate/share increments, free decrements)."""
        allocated = set(self._owners)
        free = set(self._free)
        assert not (allocated & free), f"aliased pages {allocated & free}"
        assert not (self._quarantined & allocated), \
            f"quarantined pages owned {self._quarantined & allocated}"
        assert not (self._quarantined & free), \
            f"quarantined pages free {self._quarantined & free}"
        assert TRASH_PAGE not in allocated and TRASH_PAGE not in free
        assert TRASH_PAGE not in self._quarantined
        union = allocated | free | self._quarantined
        expect = set(range(1, self.num_pages))
        assert union == expect, f"leaked pages {expect - union}"
        assert all(self._owners.values()), "allocated page with no owner"
        refs = sum(len(o) for o in self._owners.values())
        assert refs == self._refs_outstanding, (
            f"refcount leak: {refs} held vs {self._refs_outstanding} "
            "outstanding"
        )


# ---------------------------------------------------------------------------
# prefill scatter and row gather
# ---------------------------------------------------------------------------

KV_KEYS = ("k", "v")


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to store ``tokens`` KV rows."""
    return -(-tokens // page_size)


def scatter_prefill(pool: dict, slot_cache: dict, pages: list[int], page_size: int) -> None:
    """Write one slot's prefill cache into its freshly mapped pages, in place.

    ``slot_cache`` leaves are ``[L, 1, Hkv, T, hd]`` with T >= n·ps;
    ``pages`` are the n pool pages covering positions ``[0, n·ps)``.  Page
    tails beyond the prompt hold prefill values of pad positions — masked
    by ``length`` at attention time, then overwritten by decode.
    """
    n = len(pages)
    for key in KV_KEYS:
        one = slot_cache[key]
        L, _, H, _, hd = one.shape
        src = one[:, 0, :, : n * page_size].reshape(L, H, n, page_size, hd)
        idx = torch.as_tensor(pages, dtype=torch.long, device=one.device)
        pool[key][:, idx] = src.transpose(1, 2).to(pool[key].dtype)


def gather_rows(pool: dict, table_row, n: int, page_size: int) -> dict:
    """A dense copy of one slot's rows ``[0, n)``, read through its block
    table row: ``{"k", "v"}`` of ``[L, 1, Hkv, n, hd]``, fresh tensors."""
    pages = torch.as_tensor(table_row[: pages_for(n, page_size)], dtype=torch.long,
                            device=pool["k"].device)
    out = {}
    for key in KV_KEYS:
        L, _, H, _, hd = pool[key].shape
        rows = pool[key][:, pages].transpose(1, 2).reshape(L, H, len(pages) * page_size, hd)
        out[key] = rows[:, None, :, :n].contiguous()
    return out


def pool_token_bytes(cache: dict) -> int:
    """Bytes per cached token position across the k/v leaves of a pool
    ``[L, P, H, ps, hd]`` or a dense cache ``[L, B, H, T, hd]`` (the two
    capacity axes, 1 and -2, dropped): the figure that prices a paged
    reservation (``mapped_pages · page_size · bytes``) and a dense one
    (``slots · max_len · bytes``) alike."""
    total = 0
    for key in KV_KEYS:
        leaf = cache[key]
        total += leaf.numel() // (leaf.shape[1] * leaf.shape[-2]) * leaf.element_size()
    return total


def _leaves(tree) -> list:
    """The array leaves of a nested dict/list/tuple, in ``jax.tree.leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        # numpy has no bfloat16: digest and flip its raw 16-bit words
        return (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def tree_digest(tree) -> bytes:
    """Content digest of a whole tree of tensors (a KV snapshot or any
    payload), leaf-order dependent like the tree itself."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in _leaves(tree):
        h.update(_host(leaf).tobytes())
    return h.digest()


def flip_tree(tree):
    """Copy of ``tree``'s leaves on the host with one byte flipped in the
    first leaf — the injector's model of a DMA that completes but delivers
    wrong bytes."""
    out = [_host(leaf).copy() for leaf in _leaves(tree)]
    if out:
        out[0].view(np.uint8).reshape(-1)[0] ^= 0xFF
    return out


# ---------------------------------------------------------------------------
# page snapshot save/restore (preemption's zero-recompute resume path)
# ---------------------------------------------------------------------------


def snapshot_buffers(pool: dict, n: int, *, pin: bool = False) -> dict:
    """Empty host tensors for a snapshot of ``n`` pages of the pool:
    ``{"k", "v"}`` of ``[L, n, Hkv, page_size, hd]`` (``pin``: in
    page-locked memory, which a device-to-host copy writes at the link's
    rate)."""
    return {key: torch.empty((pool[key].shape[0], n, *pool[key].shape[2:]),
                             dtype=pool[key].dtype, pin_memory=pin) for key in KV_KEYS}


def gather_pages(pool: dict, pages, out: dict) -> dict:
    """Copy ``pages`` of the pool's k and v into ``out`` (from
    :func:`snapshot_buffers`) and return it: the victim's KV bit for bit as
    it sits in the pool.

    The copy has finished when this returns, so the caller may free the
    pages and let later launches overwrite them: the gather itself runs on
    the current stream ahead of any such launch."""
    for key in KV_KEYS:
        leaf = pool[key]
        idx = torch.as_tensor(np.asarray(pages), dtype=torch.long).to(leaf.device)
        out[key].copy_(leaf.index_select(1, idx))
    return out


def restore_pages(pool: dict, saved: dict, pages) -> None:
    """Scatter a :func:`gather_pages` snapshot back into freshly mapped
    ``pages`` of the pool, in place (the physical page ids may differ from
    the ones saved: the block table makes that invisible).  The copies are
    ordered on the current stream ahead of any later launch that reads
    the pages."""
    for key in KV_KEYS:
        leaf = pool[key]
        idx = torch.as_tensor(np.asarray(pages), dtype=torch.long).to(leaf.device)
        src = saved[key].to(leaf.device, non_blocking=saved[key].is_pinned())
        leaf.index_copy_(1, idx, src.to(leaf.dtype))


class StagedRefill:
    """A host snapshot's copy to the card, started ahead of its resume on
    ``stream`` (a side stream, so that it overlaps the launches on the
    serving stream): device tensors the copy fills, and timed events
    around it.  :meth:`land` scatters the rows into the pool once the copy
    is done; :meth:`seconds` reads the copy's time and how long the
    serving stream waited on it, after the fact.

    The host snapshot may be dropped as soon as this is made: PyTorch keeps
    a pinned block from reuse until the copies out of it are done."""

    def __init__(self, saved: dict, device, stream):
        self.nbytes = snapshot_bytes(saved)
        self.start = torch.cuda.Event(enable_timing=True)
        self.done = torch.cuda.Event(enable_timing=True)
        self.needed: torch.cuda.Event | None = None
        with torch.cuda.stream(stream):
            # allocated on the side stream: freed unread (a cancel), the
            # memory goes back to that stream's pool only
            self.tensors = {key: torch.empty(saved[key].shape, dtype=saved[key].dtype,
                                             device=device) for key in KV_KEYS}
            self.start.record(stream)          # the copy alone, not the allocation
            for key in KV_KEYS:
                self.tensors[key].copy_(saved[key], non_blocking=True)
            self.done.record(stream)

    def land(self, pool: dict, pages) -> None:
        """Make the current stream wait for the copy, then scatter the
        staged rows into ``pages`` of the pool in place."""
        serving = torch.cuda.current_stream(pool["k"].device)
        self.needed = torch.cuda.Event(enable_timing=True)
        self.needed.record(serving)
        serving.wait_event(self.done)
        restore_pages(pool, self.tensors, pages)
        for t in self.tensors.values():
            t.record_stream(serving)      # read here: not reused before this stream's reads
        self.tensors = {}

    def finished(self) -> bool:
        """Landed, and both the copy and the serving stream past its events."""
        return (self.needed is not None and self.needed.query()) and self.done.query()

    def seconds(self) -> tuple[float, float]:
        """(the copy's seconds on the card, the seconds the serving stream
        waited for it past the moment the resume needed it): waits for the
        events if the card has not reached them yet."""
        for event in (self.done, self.needed):
            if event is not None:
                event.synchronize()
        copy_s = self.start.elapsed_time(self.done) * 1e-3
        waited = (max(0.0, self.needed.elapsed_time(self.done)) * 1e-3
                  if self.needed is not None else 0.0)
        return copy_s, waited


def snapshot_bytes(saved: dict) -> int:
    """Host bytes a :func:`gather_pages` snapshot holds while parked."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(saved))


# ---------------------------------------------------------------------------
# host arena: the budgeted second tier of the page pool
# ---------------------------------------------------------------------------


class HostArenaExhausted(RuntimeError):
    """A snapshot store found the host arena past its byte budget.

    Only reachable when degradation is disabled (``SpillPolicy.allow_replay
    = False``): with replay allowed the engine demotes parked snapshots to
    re-prefill replay until the store fits, so the budget is a ceiling the
    arena never crosses rather than an error the caller sees.
    """


class HostArena:
    """Budgeted host-side tier for cold KV pages.

    The device pool (tier 0) holds hot pages; parked-request snapshots
    spill device-to-host into this arena (tier 1).  Like the device
    :class:`PageAllocator` it is an explicit free-list over fixed-size
    blocks with tracked owners, so conservation is an assertable invariant
    rather than an accounting convention.  One block holds the bytes of
    one device page (``configure`` is called lazily once the engine knows
    its per-page byte size), so N device pages spill into N host blocks.

    ``budget_bytes=None`` means unbounded: blocks are minted on demand and
    the free-list stays exact, so the conservation invariants hold either
    way.  With a budget, a store that does not fit raises
    :class:`HostArenaExhausted`; callers degrade by demoting victims (see
    ``SpillPolicy``) before retrying.

    Entries are keyed by owner uid.  ``entries()`` is store order, oldest
    first.
    """

    def __init__(self, budget_bytes: int | None = None) -> None:
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self.block_bytes: int | None = None      # set lazily by configure()
        self._total_blocks = 0
        self._free: list[int] = []
        self._owner: dict[int, int] = {}         # block -> owner uid
        self._blocks: dict[int, list[int]] = {}  # uid -> its blocks
        self._data: dict[int, Any] = {}          # uid -> snapshot
        self._nbytes: dict[int, int] = {}        # uid -> actual bytes stored
        self._order: list[int] = []              # uids in store order
        self.peak_bytes = 0
        self.stores = 0
        self.discards = 0

    # -- sizing ------------------------------------------------------------

    def configure(self, block_bytes: int) -> None:
        """Fix the block size (bytes of one device page).  Idempotent; a
        conflicting re-configure is a hard error: resizing live blocks
        would break the free-list's correspondence with the budget."""
        if self.block_bytes is not None:
            if block_bytes != self.block_bytes:
                raise ValueError(
                    f"arena already configured with block_bytes="
                    f"{self.block_bytes}, got {block_bytes}"
                )
            return
        if block_bytes < 1:
            raise ValueError(f"block_bytes must be >= 1, got {block_bytes}")
        self.block_bytes = block_bytes
        if self.budget_bytes is not None:
            self._total_blocks = self.budget_bytes // block_bytes
            self._free = list(range(self._total_blocks - 1, -1, -1))

    def blocks_for(self, nbytes: int) -> int:
        """Blocks needed to hold ``nbytes`` (at least one)."""
        if self.block_bytes is None:
            raise RuntimeError("arena not configured (block_bytes unset)")
        return max(1, -(-nbytes // self.block_bytes))

    # -- accounting --------------------------------------------------------

    @property
    def total_blocks(self) -> int:
        return self._total_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._owner)

    @property
    def used_bytes(self) -> int:
        """Actual snapshot bytes resident (<= used_blocks · block_bytes)."""
        return sum(self._nbytes.values())

    def fits(self, nbytes: int) -> bool:
        """Would a store of ``nbytes`` succeed right now?"""
        if self.budget_bytes is None:
            return True
        return self.blocks_for(nbytes) <= len(self._free)

    def can_ever_fit(self, nbytes: int) -> bool:
        """Would ``nbytes`` fit into an *empty* arena?  False means no
        amount of demotion helps: the entry must go straight to replay."""
        if self.budget_bytes is None:
            return True
        return self.blocks_for(nbytes) <= self._total_blocks

    # -- store / load / discard --------------------------------------------

    def holds(self, uid: int) -> bool:
        return uid in self._data

    def bytes_of(self, uid: int) -> int:
        return self._nbytes[uid]

    def entries(self) -> list[int]:
        """Resident uids in eviction order (oldest store first)."""
        return list(self._order)

    def store(self, uid: int, data: Any, nbytes: int) -> None:
        """Park ``data`` (a :func:`gather_pages` snapshot) under ``uid``."""
        if uid in self._data:
            raise ValueError(f"uid {uid} already holds an arena entry")
        need = self.blocks_for(nbytes)
        if self.budget_bytes is None:
            while len(self._free) < need:       # unbounded: mint blocks
                self._free.append(self._total_blocks)
                self._total_blocks += 1
        elif need > len(self._free):
            raise HostArenaExhausted(
                f"store of {nbytes} B ({need} blocks) over budget: "
                f"{len(self._free)}/{self._total_blocks} blocks free, "
                f"budget {self.budget_bytes} B"
            )
        blocks = [self._free.pop() for _ in range(need)]
        for b in blocks:
            self._owner[b] = uid
        self._blocks[uid] = blocks
        self._data[uid] = data
        self._nbytes[uid] = nbytes
        self._order.append(uid)
        self.stores += 1
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def load(self, uid: int) -> Any:
        """Peek the stored snapshot without freeing its blocks."""
        return self._data[uid]

    def discard(self, uid: int) -> int:
        """Drop ``uid``'s entry, return its blocks to the free-list; the
        bytes freed (what a demotion gives back to the budget)."""
        if uid not in self._data:
            raise ValueError(f"uid {uid} holds no arena entry")
        for b in self._blocks.pop(uid):
            del self._owner[b]
            self._free.append(b)
        del self._data[uid]
        self._order.remove(uid)
        self.discards += 1
        return self._nbytes.pop(uid)

    def take(self, uid: int) -> Any:
        """Load + discard in one step (the refill-complete path)."""
        data = self._data[uid]
        self.discard(uid)
        return data

    # -- invariants --------------------------------------------------------

    def check_invariants(self) -> None:
        """free + owned must tile [0, total_blocks) exactly; per-entry
        block counts must match the byte accounting; budget never crossed."""
        owned = set(self._owner)
        free = set(self._free)
        assert not (owned & free), f"aliased blocks {owned & free}"
        union = owned | free
        expect = set(range(self._total_blocks))
        assert union == expect, (
            f"leaked blocks {expect - union} / phantom {union - expect}"
        )
        assert set(self._data) == set(self._blocks) == set(self._nbytes)
        assert set(self._order) == set(self._data)
        assert len(self._order) == len(self._data)
        for uid, blocks in self._blocks.items():
            assert len(blocks) == self.blocks_for(self._nbytes[uid])
            assert all(self._owner[b] == uid for b in blocks)
        if self.budget_bytes is not None:
            assert self.used_blocks * (self.block_bytes or 0) \
                <= self.budget_bytes
            assert self.used_bytes <= self.budget_bytes
