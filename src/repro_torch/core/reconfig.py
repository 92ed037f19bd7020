"""Region manager: bounded kernel residency with prefetch-aware LRU eviction.

The FPGA in the paper exposes a fixed number of reconfigurable regions; when a
dispatched kernel's role is not loaded, the runtime reconfigures a region,
evicting the least-recently-used role if all regions are occupied.  The port
manages a bounded set of roles loaded on the card (kernel module + fixed
weight residency).  ``ensure_resident`` is the single choke point the HSA executor
calls before every kernel launch; it records reconfiguration costs in the
overhead ledger (paper Table II row 2).

Beyond plain LRU, a region slot can be in two additional states that the
lookahead scheduler (:mod:`repro_torch.core.hsa.scheduler`) drives:

  - *prefetching* — a speculative load issued ahead of demand is in flight.
    The slot is occupied but the role is not yet usable; it cannot be chosen
    as an eviction victim (you cannot reprogram a region mid-bitstream).
  - *reserved* — the role was loaded on behalf of a packet already sitting in
    a queue (refcounted).  Reserved roles are skipped by the victim search so
    a prefetched region is still hot when its packet is finally granted.

Victim selection is tiered: prefer roles that are neither pinned, reserved,
nor *protected* (referenced by a packet inside the scheduler's lookahead
window — an approximate Bélády oracle read straight off the queues); fall
back to protected, then to reserved (wasting the prefetch) under demand
pressure; pinned roles are never evicted.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import AbstractSet, Any, Callable, Iterator, Mapping

from repro_torch.core import ledger as ledger_mod
from repro_torch.core.ledger import GLOBAL_LEDGER, OverheadLedger
from repro_torch.core.roles import Role, RoleKey

# ``protect`` accepted by the eviction paths: a set of keys (all equally
# urgent) or a mapping key -> first-use distance (lower = demanded sooner),
# which lets the fallback tier evict the role needed furthest in the future.
# A zero-arg callable returning either is evaluated only if eviction is
# actually needed, so residency *hits* never pay for the window scan.
Protection = Mapping[RoleKey, int] | AbstractSet[RoleKey]

# region-slot states reported by RegionManager.state()
RESIDENT = "resident"
PREFETCHING = "prefetching"
RESERVED = "reserved"

_EMPTY: frozenset = frozenset()


@dataclasses.dataclass
class ResidencyStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    prefetch_issued: int = 0
    prefetch_hits: int = 0       # demand lookups served by a prefetched load
    prefetch_wasted: int = 0     # prefetched but evicted/flushed before use

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


@dataclasses.dataclass
class ResidencyResult:
    role: Role
    hit: bool
    evicted: RoleKey | None = None
    reconfig_s: float = 0.0


def region_image_digest(role: Role) -> bytes:
    """Digest identifying the bitstream image that *should* occupy a region
    after loading ``role`` — the reconfiguration analogue of a page digest.
    Derived from the role's identity (name, key, source): the simulation's
    stand-in for hashing the partial bitstream itself."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((role.name, role.key, role.source)).encode())
    return h.digest()


def _stale_image_digest(expected: bytes) -> bytes:
    """What a stale/corrupted load leaves in the region: definitely not
    ``expected``."""
    return hashlib.blake2b(b"stale:" + expected, digest_size=16).digest()


class RegionManager:
    """LRU-managed residency over ``num_regions`` slots.

    Pinned roles are exempt from eviction (the paper's static shell services —
    e.g. a DMA engine — correspond to pinned entries).
    """

    def __init__(
        self,
        num_regions: int,
        *,
        ledger: OverheadLedger = GLOBAL_LEDGER,
        corrupt_hook: Callable[[str], bool] | None = None,
        verify_images: bool = True,
    ) -> None:
        if num_regions < 1:
            raise ValueError("need at least one region")
        self.num_regions = num_regions
        self.ledger = ledger
        self.stats = ResidencyStats()
        # fault injection: called with the role name before every load
        # attempt; raising (FaultError) models the load aborting mid-flight
        # (see repro_torch.core.hsa.faults.FaultPlan.load_hook)
        self.fault_hook: Callable[[str], None] | None = None
        # silent-corruption injection: called with the role name after a
        # load completes; True means the region received a stale image
        # (see FaultPlan.stale_region_hook)
        self.corrupt_hook = corrupt_hook
        # verify the region-image digest after every load (and again at
        # complete_prefetch) so a stale reconfiguration is caught before
        # any packet executes against it; IntegrityPolicy.verify_regions
        # turns this off for escape-accounting experiments
        self.verify_images = verify_images
        self._image_digests: dict[RoleKey, bytes] = {}
        self._escape_reported: set[RoleKey] = set()
        self._resident: "OrderedDict[RoleKey, Role]" = OrderedDict()  # LRU: oldest first
        self._pinned: set[RoleKey] = set()
        self._prefetching: dict[RoleKey, Role] = {}   # speculative loads in flight
        self._reserved: dict[RoleKey, int] = {}       # refcount of queued demand
        self._fresh: set[RoleKey] = set()             # prefetched, not yet demanded
        # the scheduler's reconfig worker and exec path may race: one choke lock
        import threading

        self._lock = threading.RLock()

    # -- core protocol -------------------------------------------------------

    def ensure_resident(
        self,
        role: Role,
        *,
        queue: str | None = None,
        protect: "Protection | Callable[[], Protection]" = _EMPTY,
    ) -> ResidencyResult:
        """Demand path: make ``role`` usable now, evicting if necessary.

        ``protect`` keys (roles demanded by packets inside the scheduler's
        lookahead window) are only evicted when there is no other victim.
        """
        with self._lock:
            key = role.key
            if key in self._resident:
                self._resident.move_to_end(key)
                self.stats.hits += 1
                self._note_use(key)
                self._note_image_use(role)
                return ResidencyResult(role=role, hit=True)

            self.stats.misses += 1
            evicted: RoleKey | None = None
            if self._slots_used() >= self.num_regions:
                if callable(protect):
                    protect = protect()
                evicted = self._evict_one(protect=protect, speculative=False)
                if evicted is None:
                    raise RuntimeError(
                        f"all {self.num_regions} regions pinned or loading; "
                        f"cannot load {role.name}"
                    )

            dt = self._load(role, queue=queue, evicted=evicted, prefetch=False)
            self._resident[key] = role
            self._note_use(key)
            # the demanding packet executes against this image next — with
            # verification off, a stale load escapes right here
            self._note_image_use(role)
            return ResidencyResult(role=role, hit=False, evicted=evicted, reconfig_s=dt)

    def touch(self, key: RoleKey) -> bool:
        """Refresh LRU position without a stats lookup (scheduler exec path:
        the preceding stall already accounted this packet's lookup).
        Returns False when the role was evicted again in the meantime."""
        with self._lock:
            if key not in self._resident:
                return False
            self._resident.move_to_end(key)
            self._note_use(key)
            return True

    # -- prefetch state machine ------------------------------------------------

    def begin_prefetch(
        self,
        role: Role,
        *,
        queue: str | None = None,
        protect: Protection = _EMPTY,
        target_rank: int | None = None,
    ) -> ResidencyResult | None:
        """Speculatively load ``role`` ahead of demand.

        Best-effort: returns None when the role is already resident/loading or
        when making space would evict a pinned, reserved, or window-protected
        role (speculation never steals a region demand is about to use).
        ``target_rank`` is the prefetched role's own first-use distance: a
        protected victim demanded strictly *later* than that may still be
        displaced (the Bélády argument cuts both ways).  Raises RuntimeError
        only when the miss is structural — every region is pinned — so the
        caller can surface it rather than retry forever.  The loaded role is
        *reserved* (refcount) until a demand lookup consumes it, and
        *prefetching* until :meth:`complete_prefetch`.
        """
        with self._lock:
            key = role.key
            if key in self._resident or key in self._prefetching:
                return None
            evicted: RoleKey | None = None
            if self._slots_used() >= self.num_regions:
                evicted = self._evict_one(
                    protect=protect, speculative=True, target_rank=target_rank
                )
                if evicted is None:
                    if len(self._pinned & set(self._resident)) >= self.num_regions:
                        raise RuntimeError(
                            f"all {self.num_regions} regions pinned; "
                            f"cannot prefetch {role.name}"
                        )
                    return None                  # transient: reserved/loading slots

            dt = self._load(role, queue=queue, evicted=evicted, prefetch=True)
            self._prefetching[key] = role
            self._reserved[key] = self._reserved.get(key, 0) + 1
            self.stats.prefetch_issued += 1
            return ResidencyResult(role=role, hit=False, evicted=evicted, reconfig_s=dt)

    def complete_prefetch(self, key: RoleKey, *, fresh: bool = True) -> bool:
        """Transition ``prefetching`` -> ``resident`` (MRU).  ``fresh=False``
        when a demand miss already joined the in-flight load (the join counted
        the prefetch hit; don't count it again at first touch).  Returns False
        when the in-flight entry was flushed meanwhile."""
        with self._lock:
            role = self._prefetching.pop(key, None)
            if role is None:
                return False
            if self.verify_images:
                # re-check the image that sat in the region while the
                # prefetch was in flight — a stale image is dropped like an
                # aborted prefetch (demand reloads, and re-verifies)
                expected = region_image_digest(role)
                if self._image_digests.get(key, expected) != expected:
                    role.unload()
                    self._release(key)
                    self._image_digests.pop(key, None)
                    self.stats.prefetch_wasted += 1
                    self.ledger.record_integrity_detection(via="region")
                    return False
            self._resident[key] = role
            self._resident.move_to_end(key)
            if fresh:
                self._fresh.add(key)
            return True

    def abort_prefetch(self, key: RoleKey) -> None:
        """Drop an in-flight prefetch (load failed or scheduler gave up)."""
        with self._lock:
            role = self._prefetching.pop(key, None)
            if role is not None:
                role.unload()
                self._release(key)
                self._image_digests.pop(key, None)
                self.stats.prefetch_wasted += 1

    def note_prefetch_join(self, key: RoleKey) -> None:
        """A demand miss joined an in-flight prefetch instead of double-loading."""
        with self._lock:
            self.stats.prefetch_hits += 1

    def is_prefetching(self, key: RoleKey) -> bool:
        with self._lock:
            return key in self._prefetching

    def state(self, key: RoleKey) -> str | None:
        with self._lock:
            if key in self._prefetching:
                return PREFETCHING
            if key in self._resident:
                return RESERVED if self._reserved.get(key) else RESIDENT
            return None

    # -- internals -------------------------------------------------------------

    def _slots_used(self) -> int:
        return len(self._resident) + len(self._prefetching)

    def _load(self, role: Role, *, queue, evicted, prefetch: bool) -> float:
        import time

        if self.fault_hook is not None:
            self.fault_hook(role.name)
        t0 = time.perf_counter_ns()
        role.load()
        dt = (time.perf_counter_ns() - t0) * 1e-9
        self.ledger.record(
            ledger_mod.RECONFIG, dt, role=role.name, evicted=str(evicted),
            source=role.source, queue=queue, prefetch=prefetch,
        )
        # the load returned cleanly — but did the region receive the right
        # image?  The corrupt hook models a stale/corrupted partial
        # bitstream surviving the DMA; verification catches it here, before
        # the role is ever published as resident/prefetched.
        expected = region_image_digest(role)
        loaded = expected
        if self.corrupt_hook is not None and self.corrupt_hook(role.name):
            loaded = _stale_image_digest(expected)
            self.ledger.record_corruption(kind="stale_region")
        if self.verify_images:
            self.ledger.record_verified_region()
            if loaded != expected:
                # deferred import: repro_torch.core.hsa pulls the scheduler, which
                # imports this module back — resolvable only at call time
                from repro_torch.core.hsa.faults import StaleRegionImage
                role.unload()
                self.ledger.record_integrity_detection(via="region")
                raise StaleRegionImage(
                    f"stale region image after load: {role.name}"
                )
        self._image_digests[role.key] = loaded
        self._escape_reported.discard(role.key)
        return dt

    def _note_use(self, key: RoleKey) -> None:
        if key in self._fresh:
            self._fresh.discard(key)
            self.stats.prefetch_hits += 1
        self._release(key)

    def _note_image_use(self, role: Role) -> None:
        """With verification off, a demand hit on a stale image is the
        moment corruption escapes (a packet is about to execute against
        the wrong bitstream); count it once per stale load."""
        if self.verify_images:
            return
        key = role.key
        stored = self._image_digests.get(key)
        if (stored is not None and key not in self._escape_reported
                and stored != region_image_digest(role)):
            self._escape_reported.add(key)
            self.ledger.record_escape()

    def _release(self, key: RoleKey) -> None:
        n = self._reserved.get(key, 0)
        if n > 1:
            self._reserved[key] = n - 1
        elif n:
            del self._reserved[key]

    def _evict_one(
        self,
        protect: Protection = _EMPTY,
        *,
        speculative: bool = False,
        target_rank: int | None = None,
    ) -> RoleKey | None:
        """Tiered victim search:

        (1) neither pinned, reserved, nor protected — LRU (oldest first);
        (2) protected but unreserved — the role demanded *furthest* in the
            future wins (Bélády fallback; plain LRU when ``protect`` carries
            no distances); a speculative caller only reaches this tier with a
            ``target_rank`` and may only displace roles demanded strictly
            later than its own target;
        (3) reserved (the prefetch is wasted) — LRU; demand only.

        Pinned roles are never evicted.
        """
        victim_key: RoleKey | None = None
        rank_of = protect.get if isinstance(protect, Mapping) else (
            lambda _k, _d=0: 0
        )
        for tier in (0, 1, 2):
            if speculative and (tier > 1 or (tier == 1 and target_rank is None)):
                break
            best: tuple[int, RoleKey] | None = None
            for key in self._resident:          # oldest-first iteration order
                if key in self._pinned:
                    continue
                if tier < 2 and self._reserved.get(key):
                    continue
                if tier == 0:
                    if key in protect:
                        continue
                    best = (0, key)             # LRU: first unprotected wins
                    break
                if tier == 1 and key not in protect:
                    continue                    # tier 0 already rejected it
                rank = rank_of(key, 0) if tier == 1 else 0
                if speculative and rank <= (target_rank or 0):
                    continue                    # demanded sooner than the target
                if best is None or rank > best[0]:
                    best = (rank, key)          # furthest first use; tie -> LRU
            if best is not None:
                victim_key = best[1]
                break
        if victim_key is None:
            return None
        victim = self._resident.pop(victim_key)
        victim.unload()
        self._image_digests.pop(victim_key, None)
        self._escape_reported.discard(victim_key)
        self.stats.evictions += 1
        if self._reserved.pop(victim_key, 0) or victim_key in self._fresh:
            self._fresh.discard(victim_key)
            self.stats.prefetch_wasted += 1
        return victim_key

    # -- management ------------------------------------------------------------

    def pin(self, role: Role) -> None:
        with self._lock:                 # no eviction window between load and pin
            self.ensure_resident(role)
            self._pinned.add(role.key)

    def unpin(self, key: RoleKey) -> None:
        with self._lock:
            self._pinned.discard(key)

    def flush(self) -> None:
        with self._lock:
            self.stats.prefetch_wasted += len(self._fresh) + len(self._prefetching)
            for role in self._resident.values():
                role.unload()
            for role in self._prefetching.values():
                role.unload()
            self._resident.clear()
            self._prefetching.clear()
            self._pinned.clear()
            self._reserved.clear()
            self._fresh.clear()
            self._image_digests.clear()
            self._escape_reported.clear()

    @property
    def pinned_count(self) -> int:
        with self._lock:
            return len(self._pinned)

    def resident_keys(self) -> list[RoleKey]:
        with self._lock:
            return list(self._resident.keys())

    def is_resident(self, key: RoleKey) -> bool:
        with self._lock:
            return key in self._resident

    def __len__(self) -> int:
        return self._slots_used()

    def __iter__(self) -> Iterator[Role]:
        return iter(self._resident.values())


# ---------------------------------------------------------------------------
# transfer engine: the DMA timeline between the page-pool tiers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Transfer:
    """One D2H spill or H2D refill on the transfer engine's timeline.

    ``start_t``/``ready_t`` are engine-clock stamps: the DMA begins when
    the (single) engine frees up and completes ``duration_s`` later, so
    back-to-back transfers queue exactly like region loads on the
    reconfiguration engine.  ``error`` is set instead when the fault plan
    aborted the attempt — the caller falls back (replay) rather than wait.
    """

    kind: str                  # "d2h" | "h2d"
    what: str                  # transfer tag, e.g. "kv[uid=3]"
    nbytes: int
    start_t: float = 0.0
    ready_t: float = 0.0
    duration_s: float = 0.0
    error: Exception | None = None
    waited: bool = False
    # integrity: the payload tree riding the DMA and its source digest.
    # A corrupt_transfer draw replaces ``payload`` with a byte-flipped
    # *copy* (the source tier keeps its clean bytes) and sets
    # ``corrupted`` — the engine's ground truth for escape accounting
    # when verification is off.
    payload: Any = None
    digest: bytes | None = None
    corrupted: bool = False


class TransferEngine:
    """Single-engine DMA timeline for tier spills (D2H) and refills (H2D).

    The reconfiguration engine's twin, one level down the memory
    hierarchy: region loads move *kernels* into bounded device residency,
    this engine moves *cold KV pages* between the bounded device pool and
    the budgeted host arena.  Durations are bandwidth-priced
    (``nbytes / bandwidth_bytes_s``) on the injectable clock, so on a
    ``VirtualClock`` every overlap question — did the refill hide behind
    decode, or did the resume stall on it? — is a deterministic assertion.

    Attribution mirrors the reconfig exposed/hidden split: ``wait`` charges
    the caller only the *exposed* residue (``ready_t - now``, clipped at 0)
    and books the rest as hidden — the part the ahead-of-need pump
    overlapped with compute.  A d2h spill is never waited on (the gather
    already made the host copy; the timeline cost only delays later
    refills queued behind it), so its full duration rides the SPILL
    category at issue time.

    A fault plan with ``transfer_rate`` (or forced ``"d2h"``/``"h2d"``
    faults) aborts attempts at issue: the engine is held for
    ``fault_backoff_s`` (the abort/backoff window), the ledger prices the
    fault, and the returned :class:`Transfer` carries ``error`` for the
    caller's fallback path.
    """

    def __init__(self, *, bandwidth_bytes_s: float = 8e9,
                 clock=None, ledger: OverheadLedger = GLOBAL_LEDGER,
                 faults=None, fault_backoff_s: float = 1e-3,
                 integrity=None) -> None:
        if bandwidth_bytes_s <= 0:
            raise ValueError(
                f"bandwidth_bytes_s must be > 0, got {bandwidth_bytes_s}"
            )
        if fault_backoff_s < 0:
            raise ValueError(
                f"fault_backoff_s must be >= 0, got {fault_backoff_s}"
            )
        if clock is None:
            from repro_torch.core.hsa.clock import WallClock
            clock = WallClock()
        self.bandwidth_bytes_s = bandwidth_bytes_s
        self.clock = clock
        self.ledger = ledger
        self.faults = faults
        self.fault_backoff_s = fault_backoff_s
        self.integrity = integrity   # IntegrityPolicy | None
        if faults is not None:
            faults.bind_clock(clock)
        self._free_t = clock.now()
        self.issued = 0
        self.completed = 0
        self.faulted = 0
        self.cancelled = 0
        self.bytes_moved = 0

    def issue(self, kind: str, what: str, nbytes: int, *,
              payload: Any = None, digest: bytes | None = None) -> Transfer:
        """Queue one transfer on the engine timeline; returns immediately.

        The transfer's ``ready_t`` accounts for the engine being busy with
        earlier transfers.  On an injected fault the engine backs off and
        the returned transfer carries ``error`` instead of a timeline.

        ``payload``/``digest`` ride the transfer for the integrity layer: a
        ``corrupt_transfer`` draw byte-flips a *copy* of the payload (the
        source tier stays clean), and — when ``integrity.verify_transfers``
        — a d2h payload is digest-checked here at issue (spills complete at
        issue and are never waited), an h2d payload at :meth:`wait`."""
        if kind not in ("d2h", "h2d"):
            raise ValueError(f"transfer kind must be d2h|h2d, got {kind!r}")
        if nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {nbytes}")
        now = self.clock.now()
        if self.faults is not None:
            err = self.faults.draw_transfer(kind, what)
            if err is not None:
                self.faulted += 1
                self._free_t = max(self._free_t, now) + self.fault_backoff_s
                self.ledger.record(ledger_mod.FAULT, 0.0, what=what,
                                   kind=kind)
                self.ledger.record(ledger_mod.RETRY, self.fault_backoff_s,
                                   what=what)
                self.ledger.record_fault(kind=kind)
                return Transfer(kind, what, nbytes, error=err)
        dur = nbytes / self.bandwidth_bytes_s
        start = max(now, self._free_t)
        ready = start + dur
        self._free_t = ready
        self.issued += 1
        self.bytes_moved += nbytes
        xfer = Transfer(kind, what, nbytes, start, ready, dur,
                        payload=payload, digest=digest)
        if (self.faults is not None and payload is not None
                and self.faults.draw_corruption(
                    "corrupt_transfer", [what]) is not None):
            from repro_torch.serve.paged import flip_tree
            xfer.payload = flip_tree(payload)
            xfer.corrupted = True
            self.ledger.record_corruption(kind="corrupt_transfer")
        if kind == "d2h":
            self.completed += 1          # never waited: done at ready_t
            self.ledger.record(ledger_mod.SPILL, dur, what=what)
            self.ledger.record_spill(nbytes=nbytes)
            err = self._verify_payload(xfer)
            if err is not None:
                xfer.error = err
        return xfer

    def _verify_payload(self, xfer: Transfer) -> Exception | None:
        """Digest-check a transfer's delivered payload; returns the
        :class:`CorruptPayload` to surface (None = clean or unverifiable)."""
        if (self.integrity is None or not self.integrity.verify_transfers
                or xfer.payload is None or xfer.digest is None):
            return None
        self.ledger.record_verified_transfer()
        from repro_torch.serve.paged import tree_digest
        if tree_digest(xfer.payload) == xfer.digest:
            return None
        from repro_torch.core.hsa.faults import CorruptPayload
        self.ledger.record_integrity_detection(via="transfer")
        return CorruptPayload(
            f"{xfer.kind} payload digest mismatch: {xfer.what}"
        )

    def wait(self, xfer: Transfer) -> float:
        """Block on a refill until its DMA completes; returns the *exposed*
        seconds (virtual clocks are advanced by exactly that residue).

        Records the refill's duration plus its exposed/hidden attribution;
        waiting twice on the same transfer is a hard error (the bytes were
        already consumed).  When the engine carries an
        ``IntegrityPolicy(verify_transfers=True)``, the delivered payload
        is digest-checked after the DMA completes — a mismatch raises
        :class:`CorruptPayload` (the time was spent; the bytes are not
        trusted)."""
        if xfer.error is not None:
            raise xfer.error
        if xfer.waited:
            raise ValueError(f"transfer {xfer.what} already waited on")
        xfer.waited = True
        now = self.clock.now()
        exposed = max(0.0, xfer.ready_t - now)
        if exposed and getattr(self.clock, "virtual", False):
            self.clock.advance(exposed)
        hidden = max(0.0, xfer.duration_s - exposed)
        if xfer.kind == "h2d":
            self.completed += 1
            self.ledger.record(ledger_mod.REFILL, xfer.duration_s,
                               what=xfer.what)
            self.ledger.record(ledger_mod.REFILL_EXPOSED, exposed,
                               what=xfer.what)
            self.ledger.record(ledger_mod.REFILL_HIDDEN, hidden,
                               what=xfer.what)
            self.ledger.record_refill(nbytes=xfer.nbytes)
            err = self._verify_payload(xfer)
            if err is not None:
                xfer.error = err
                raise err
        return exposed

    def cancel(self, xfer: Transfer) -> None:
        """Drop an in-flight refill (its target was demoted to replay).
        The timeline slot is already spent — cancellation only stops the
        exposed/hidden accounting from ever being charged."""
        if xfer.error is None and not xfer.waited:
            self.cancelled += 1
