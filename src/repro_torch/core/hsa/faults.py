"""Deterministic fault injection for the HSA runtime.

Real accelerator runtimes fail in three characteristic ways, and the paper's
"hide the complexity of controlling new hardware" promise only holds if the
runtime absorbs all three without user-visible effect:

  - **exec faults** — a kernel launch raises (transient: a retry succeeds;
    permanent: the packet is unrunnable no matter how often it is retried);
  - **load faults** — a partial-bitstream / region load aborts mid-flight
    (the FPGA story's reconfiguration failure);
  - **wedged launches** — the launch neither completes nor errors: its
    completion signal never fires, and only a watchdog deadline kills it;
  - **transfer faults** — a D2H/H2D DMA between the page-pool tiers aborts
    (the spill/refill analogue of a load fault).

A :class:`FaultPlan` injects all of them *deterministically*: one seeded RNG,
one draw per attempt, scheduled on the injectable clock — so every fault
trace is a reproducible virtual-clock event log and a recovery bug replays
exactly.  Tests wanting surgical faults script them with :meth:`force`
(consumed before any random draw).

The injected exceptions all derive from :class:`FaultError`, which is the
type the recovery stack gates on: a ``FaultError`` is the hardware's problem
and is absorbed by retry/quarantine/park-resume; any other exception is a
programming error and still surfaces to the caller unchanged.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any


class FaultError(RuntimeError):
    """Base class for hardware-attributable launch failures.

    Recovery layers (scheduler retry, reconfig reload, engine park/resume)
    absorb ``FaultError`` subclasses only — user code bugs propagate."""


class InjectedFault(FaultError):
    """Transient kernel-exec failure: a retry may succeed."""


class PermanentFault(InjectedFault):
    """Kernel-exec failure no retry can absorb (broken region, bad SKU)."""


class InjectedLoadFault(FaultError):
    """Region (partial-bitstream) load aborted mid-flight."""


class InjectedTransferFault(FaultError):
    """D2H spill or H2D refill DMA aborted mid-flight.

    The tiered KV pool's failure mode: a faulted spill parks its victim by
    re-prefill replay instead of snapshot; a faulted refill demotes the
    parked snapshot to replay — either way the committed token prefix is
    regenerated bitwise-identically, so the fault never reaches the user."""


class WedgedLaunch(FaultError):
    """Launch that never completes: no error, no completion signal.

    Only the scheduler's watchdog deadline converts a wedge into this
    exception; the time charged for the attempt is the full watchdog
    window, not the expected exec time."""


class SilentCorruption(FaultError):
    """Verification caught wrong bytes in trusted state.

    Raised when a content digest mismatches on a sealed device KV page or a
    host-arena block — the state the serving path would otherwise feed to
    attention unchecked.  Recovery is the engine's park path: the owning slot's
    device KV is untrusted and it resumes by re-prefill replay."""


class CorruptPayload(InjectedTransferFault):
    """A DMA completed but delivered wrong bytes (digest mismatch).

    Unlike :class:`InjectedTransferFault` the DMA *succeeded* — the
    corruption is only visible because the payload carries its source
    digest.  Handled like a transfer fault: the refill/spill is discarded
    and the request demotes to re-prefill replay."""


class StaleRegionImage(InjectedLoadFault):
    """A region load completed with the wrong (stale) bitstream image.

    The dynamic-reconfiguration failure mode the fail-stop load fault
    misses: ``role.load()`` returns cleanly but the region holds a previous
    role's image.  Subclasses :class:`InjectedLoadFault` so the scheduler's
    existing load retry (``abort_prefetch`` + reload) absorbs it before any
    packet executes against the stale image."""


#: silent-corruption kinds (drawn from the independent corruption stream)
CORRUPTION_KINDS = ("flip_page", "flip_block", "corrupt_transfer",
                    "stale_region")

_FAILSTOP_KINDS = ("exec", "load", "wedge", "d2h", "h2d")


@dataclasses.dataclass
class FaultEvent:
    """One injected fault, stamped on the plan's clock."""

    t: float
    kind: str                  # _FAILSTOP_KINDS | CORRUPTION_KINDS
    what: str                  # packet .what / role name / transfer tag
    queue: str | None = None
    permanent: bool = False
    forced: bool = False


@dataclasses.dataclass
class FaultPlan:
    """Seeded fault schedule over launch/load/DMA attempts.

    **Draw order** (the contract scripted tests rely on):

    - *Forced first.*  Every draw site consumes matching :meth:`force`
      entries before any random draw, scanning the forced list in
      :meth:`force` insertion order and taking the first entry whose kind
      matches the site and whose ``what`` is ``None`` or a substring of the
      attempt's tag.  An entry with ``count=N`` is consumed once per
      matching attempt and removed after its N-th hit, so interleaved
      forced kinds fire independently: ``force("exec", count=2)`` +
      ``force("h2d")`` injects the next two exec attempts and the next
      H2D refill, whichever order the runtime reaches them.
    - *Fail-stop stream.*  One ``random.Random(seed)`` draw per exec
      attempt, compared against cumulative ``wedge_rate`` /
      ``permanent_rate`` / ``exec_rate`` bands (first band wins); one draw
      per load attempt against ``load_rate``; one draw per DMA attempt
      against ``transfer_rate``.  A given seed therefore produces the same
      fail-stop trace regardless of which faults a test cares about.
    - *Corruption stream.*  Silent-corruption draws
      (:data:`CORRUPTION_KINDS`) come from an **independent** seeded RNG:
      one draw per opportunity against ``corrupt_rate``, plus one target
      draw per hit.  Enabling corruption never perturbs the fail-stop
      schedule (and vice versa), so fail-stop benchmark floors survive a
      corruption sweep with the same seed.

    ``trace`` accumulates every injected fault as a clock-stamped
    :class:`FaultEvent`.
    """

    seed: int = 0
    exec_rate: float = 0.0        # transient exec exception
    load_rate: float = 0.0        # region load abort
    wedge_rate: float = 0.0       # completion never fires
    permanent_rate: float = 0.0   # unretryable exec failure
    transfer_rate: float = 0.0    # D2H/H2D DMA abort (spill/refill tier)
    corrupt_rate: float = 0.0     # silent corruption (per opportunity)
    clock: Any = None             # bound by the scheduler (bind_clock)

    def __post_init__(self) -> None:
        for name in ("exec_rate", "load_rate", "wedge_rate", "permanent_rate",
                     "transfer_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.exec_rate + self.wedge_rate + self.permanent_rate > 1.0:
            raise ValueError("exec_rate + wedge_rate + permanent_rate > 1")
        self._rng = random.Random(self.seed)
        # str seeding hashes via sha512 (process-independent), and a
        # distinct stream keeps corruption draws from perturbing the
        # fail-stop schedule above.
        self._crng = random.Random(f"corruption-{self.seed}")
        self.trace: list[FaultEvent] = []
        self._forced: list[dict[str, Any]] = []

    # -- wiring ------------------------------------------------------------

    def bind_clock(self, clock: Any) -> None:
        """Attach the runtime's clock so trace events are stamped in the
        same timeline as the scheduler's event log.  First binding wins
        (a plan shared by scheduler + region manager keeps one timeline)."""
        if self.clock is None:
            self.clock = clock

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    # -- scripted faults ---------------------------------------------------

    def force(self, kind: str, what: str | None = None, *,
              permanent: bool = False, count: int = 1) -> None:
        """Script ``count`` faults of ``kind`` ("exec" | "load" | "wedge" |
        "d2h" | "h2d") against the next matching attempts (``what`` is a
        substring match on the packet's ``.what`` / role name / transfer
        tag; None matches any).  Corruption kinds ("flip_page" |
        "flip_block" | "corrupt_transfer" | "stale_region") are scripted
        the same way.  Forced faults are consumed before any random draw,
        so a test can hit one specific launch without touching the seeded
        schedule."""
        if kind not in _FAILSTOP_KINDS + CORRUPTION_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self._forced.append(
            {"kind": kind, "what": what, "permanent": permanent,
             "count": count}
        )

    def _take_forced(self, kinds: tuple[str, ...], what: str) -> dict | None:
        for entry in self._forced:
            if entry["kind"] in kinds and (
                entry["what"] is None or entry["what"] in what
            ):
                entry["count"] -= 1
                if entry["count"] == 0:
                    self._forced.remove(entry)
                return entry
        return None

    # -- draws -------------------------------------------------------------

    def _log(self, kind: str, what: str, queue: str | None,
             permanent: bool, forced: bool) -> None:
        self.trace.append(FaultEvent(
            t=self._now(), kind=kind, what=what, queue=queue,
            permanent=permanent, forced=forced,
        ))

    def draw_exec(self, what: str, *,
                  queue: str | None = None) -> FaultError | None:
        """Fault (or None) for one kernel-exec attempt of ``what``."""
        forced = self._take_forced(("exec", "wedge"), what)
        if forced is not None:
            kind = forced["kind"]
            permanent = bool(forced["permanent"])
            self._log(kind, what, queue, permanent, forced=True)
            if kind == "wedge":
                return WedgedLaunch(f"wedged launch (forced): {what}")
            if permanent:
                return PermanentFault(f"permanent exec fault (forced): {what}")
            return InjectedFault(f"exec fault (forced): {what}")
        r = self._rng.random()
        if r < self.wedge_rate:
            self._log("wedge", what, queue, False, forced=False)
            return WedgedLaunch(f"wedged launch: {what}")
        r -= self.wedge_rate
        if r < self.permanent_rate:
            self._log("exec", what, queue, True, forced=False)
            return PermanentFault(f"permanent exec fault: {what}")
        r -= self.permanent_rate
        if r < self.exec_rate:
            self._log("exec", what, queue, False, forced=False)
            return InjectedFault(f"exec fault: {what}")
        return None

    def draw_load(self, role: str, *,
                  queue: str | None = None) -> FaultError | None:
        """Fault (or None) for one region-load attempt of ``role``."""
        forced = self._take_forced(("load",), role)
        if forced is not None:
            self._log("load", role, queue, bool(forced["permanent"]),
                      forced=True)
            return InjectedLoadFault(f"load fault (forced): {role}")
        if self._rng.random() < self.load_rate:
            self._log("load", role, queue, False, forced=False)
            return InjectedLoadFault(f"load fault: {role}")
        return None

    def draw_transfer(self, kind: str, what: str, *,
                      queue: str | None = None) -> FaultError | None:
        """Fault (or None) for one DMA attempt of ``kind`` ("d2h" | "h2d")
        moving ``what`` between the pool tiers."""
        if kind not in ("d2h", "h2d"):
            raise ValueError(f"transfer kind must be d2h|h2d, got {kind!r}")
        forced = self._take_forced((kind,), what)
        if forced is not None:
            self._log(kind, what, queue, False, forced=True)
            return InjectedTransferFault(
                f"{kind} transfer fault (forced): {what}"
            )
        if self._rng.random() < self.transfer_rate:
            self._log(kind, what, queue, False, forced=False)
            return InjectedTransferFault(f"{kind} transfer fault: {what}")
        return None

    def draw_corruption(self, kind: str, targets: list[str], *,
                        queue: str | None = None) -> int | None:
        """Index of the corrupted target (or None) for one silent-corruption
        opportunity of ``kind`` over ``targets`` (display tags).

        Forced entries are consumed first (matched against each target tag
        in order); otherwise one draw from the corruption stream against
        ``corrupt_rate`` decides whether to corrupt, and a second draw
        picks the target uniformly.  Returns the index into ``targets``."""
        if kind not in CORRUPTION_KINDS:
            raise ValueError(f"corruption kind must be one of "
                             f"{CORRUPTION_KINDS}, got {kind!r}")
        if not targets:
            return None
        for i, what in enumerate(targets):
            if self._take_forced((kind,), what) is not None:
                self._log(kind, what, queue, False, forced=True)
                return i
        if self._crng.random() < self.corrupt_rate:
            i = self._crng.randrange(len(targets))
            self._log(kind, targets[i], queue, False, forced=False)
            return i
        return None

    def stale_region_hook(self, role: str) -> bool:
        """RegionManager ``corrupt_hook`` adapter: True when this load
        should deliver a stale (wrong) region image."""
        return self.draw_corruption("stale_region", [role]) is not None

    def load_hook(self, role: str) -> None:
        """RegionManager ``fault_hook`` adapter: raise instead of return,
        matching the real failure mode (``role.load()`` raising)."""
        err = self.draw_load(role)
        if err is not None:
            raise err

    def __repr__(self) -> str:
        return (
            f"FaultPlan(seed={self.seed}, exec={self.exec_rate}, "
            f"load={self.load_rate}, wedge={self.wedge_rate}, "
            f"permanent={self.permanent_rate}, "
            f"transfer={self.transfer_rate}, corrupt={self.corrupt_rate}, "
            f"injected={len(self.trace)})"
        )
