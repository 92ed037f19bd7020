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
"""

from __future__ import annotations

import dataclasses
import hashlib

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
