"""Async multi-queue packet scheduler — the runtime half of transparent dispatch.

The paper's FPGA is shared dynamically at runtime: kernels arrive on HSA
user-level queues from several producers at once (the TensorFlow engine,
OpenCL/OpenMP clients), and the device reconfigures regions on demand.  This
scheduler is that sharing layer:

  - N *soft queues* per agent; AQL packets carry completion signals, and
    kernel packets / barrier-AND packets carry dependency signals.
  - A doorbell-driven loop round-robins (or weight-round-robins) *ready*
    packets across queues: a packet is ready when its queue is not stalled
    and every dependency signal reads 0.
  - Reconfiguration stalls only the queue that missed residency.  The
    reconfiguration engine (the FPGA's ICAP; here a role's load: its weight
    uploaded to the card and a warm-up launch) is
    modeled separately from the compute engine, so an independent queue keeps
    executing while another queue's region loads.  ``overlap_reconfig=False``
    recovers the synchronous baseline where reconfiguration occupies the
    device — the comparison benchmarks/table4 measures.
  - **Lookahead reconfiguration prefetch** (``lookahead=N``): whenever a
    queue is blocked (stalled on a load, or its head waits on dependency
    signals), the scheduler scans that queue's next N packets and issues
    speculative loads on the reconfiguration engine for roles that would
    miss — by the time the packet is granted its region is hot (ICAP
    pipelining).  A demand miss that finds its role already in flight *joins*
    the prefetch instead of double-loading; the victim search skips roles
    referenced inside any lookahead window (an approximate Bélády oracle read
    straight off the queues).  ``lookahead=0`` recovers the purely reactive
    scheduler.
  - Per-queue wait / exec / reconfig time lands in the overhead ledger
    (``queue=`` meta → ``OverheadLedger.queue_breakdown()``), with
    reconfiguration split into *exposed* (queue sat stalled) and *hidden*
    (overlapped by prefetch) — paper Table II row 2, prefetch-refined.

Determinism: the scheduler takes an injectable clock.  With a
:class:`~repro_torch.core.hsa.clock.VirtualClock` the whole schedule is a
discrete-event simulation — no threads, no sleeps — and the event log is
bit-for-bit reproducible, which is what the interleaving tests assert.
Durations on the virtual timeline come from ``cost_model(kind, what,
measured_s)``; by default the actually-measured execution time is used.
With a :class:`WallClock` the same code path runs threaded (``start()``)
with reconfigurations offloaded to a background worker.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable

import torch

from repro_torch.core import ledger as ledger_mod
from repro_torch.core.ledger import GLOBAL_LEDGER, OverheadLedger
from repro_torch.core.hsa.clock import Clock, VirtualClock, WallClock
from repro_torch.core.hsa.faults import (
    FaultError, FaultPlan, InjectedLoadFault, PermanentFault, WedgedLaunch,
)
from repro_torch.core.hsa.queue import BarrierAndPacket, KernelDispatchPacket, Packet, Queue
from repro_torch.core.policy import PrefetchPolicy, RetryPolicy
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary

ROUND_ROBIN = "round_robin"
WEIGHTED = "weighted"
RANDOM = "random"
POLICIES = (ROUND_ROBIN, WEIGHTED, RANDOM)


def sync_outputs(out: Any) -> None:
    """Wait until the device has finished the work behind ``out``: the
    current stream of every CUDA device its tensors lie on is synchronised
    (the launch ran on that stream), so the ledger's EXEC is the card's time.
    CPU tensors and other values need no wait."""
    seen: set[torch.device] = set()
    stack = [out]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda" and v.device not in seen:
                seen.add(v.device)
                torch.cuda.current_stream(v.device).synchronize()
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())


class SchedulerDeadlock(RuntimeError):
    """No packet can ever become ready (unsatisfiable dependency)."""


@dataclasses.dataclass(frozen=True)
class SchedEvent:
    """One entry of the deterministic event log."""

    t: float
    kind: str  # exec_start | exec_end | reconfig_start | reconfig_end |
    #            prefetch_start | prefetch_end | prefetch_hit | barrier | error
    queue: str
    what: str
    seq: int = 0

    def brief(self) -> tuple[str, str, str]:
        return (self.kind, self.queue, self.what)


@dataclasses.dataclass
class QueueStats:
    wait_s: float = 0.0
    exec_s: float = 0.0
    reconfig_s: float = 0.0           # exposed: time this queue sat stalled
    reconfig_hidden_s: float = 0.0    # prefetched load time hidden behind compute
    dispatched: int = 0
    barriers: int = 0
    reconfigs: int = 0
    prefetches: int = 0               # speculative loads issued for this queue
    prefetch_hits: int = 0            # packets that found their role prefetched


@dataclasses.dataclass
class _Stall:
    """An in-progress reconfiguration attributed to one queue."""

    role_name: str
    start_t: float
    end_t: float                      # virtual end (cooperative) / inf (threaded)
    future: Future | None = None      # threaded mode only
    error: BaseException | None = None  # load failed: fail the head packet at retire
    role_key: Any = None
    joined: bool = False              # riding an in-flight prefetch, not a load
    exposed_s: float = 0.0            # joined stalls: residual wait past compute


@dataclasses.dataclass
class _Prefetch:
    """A speculative region load in flight on the reconfiguration engine."""

    role: Any
    role_key: Any
    queue: str                        # beneficiary queue (whose window demanded it)
    start_t: float
    end_t: float                      # virtual end (cooperative) / inf (threaded)
    future: Future | None = None
    error: BaseException | None = None
    started: bool = True              # begin_prefetch actually took a region
    joined: bool = False              # a demand miss is riding this load
    exposed_s: float = 0.0            # residual stall time claimed by joiners


def _default_cost(kind: str, what: str, measured_s: float) -> float:
    del kind, what
    return measured_s


class Scheduler:
    """Doorbell-driven multi-queue packet scheduler over one agent's engines."""

    def __init__(
        self,
        regions: RegionManager,
        library: RoleLibrary,
        *,
        ledger: OverheadLedger = GLOBAL_LEDGER,
        clock: Clock | None = None,
        policy: str = ROUND_ROBIN,
        seed: int = 0,
        cost_model: Callable[[str, str, float], float] | None = None,
        overlap_reconfig: bool = True,
        lookahead: "PrefetchPolicy | int" = 0,
        burst_grants: bool = True,
        keep_events: int = 100_000,
        retry: "RetryPolicy | int | None" = None,
        faults: "FaultPlan | None" = None,
        expected_exec_s: float | Callable[[str], float] | None = None,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; choose from {POLICIES}")
        self.regions = regions
        self.library = library
        self.ledger = ledger
        self.clock: Clock = clock if clock is not None else WallClock()
        # honor the Clock protocol's `virtual` flag so user-supplied
        # deterministic clocks get virtual-time semantics too
        self._virtual = bool(getattr(self.clock, "virtual", False))
        self.policy = policy
        self.cost_model = cost_model or _default_cost
        self.overlap_reconfig = overlap_reconfig
        self.lookahead = PrefetchPolicy.of(lookahead).lookahead
        self.burst_grants = burst_grants
        self.keep_events = keep_events
        # fault tolerance: retry=None keeps the legacy fail-fast semantics
        # (one error kills the packet); a RetryPolicy turns on per-packet
        # retry/backoff, the wedge watchdog, and queue quarantine.  A
        # FaultPlan deterministically injects the faults the policy absorbs.
        self.retry = RetryPolicy.of(retry)
        self.faults = faults
        # expected exec duration (seconds, or a fn of packet .what) the
        # watchdog deadline is derived from — callers with a step_time_model
        # thread it here so wedge kills track the workload's real tempo
        self.expected_exec_s = expected_exec_s
        if faults is not None:
            faults.bind_clock(self.clock)
            if regions.fault_hook is None:
                regions.fault_hook = faults.load_hook
            if regions.corrupt_hook is None:
                regions.corrupt_hook = faults.stale_region_hook

        self.queues: list[Queue] = []
        self.stats: dict[str, QueueStats] = {}
        self.events: list[SchedEvent] = []
        self.dropped_events = 0

        self._rng = random.Random(seed)
        self._grant_order: list[int] = []
        self._grant_ptr = 0
        self._stalls: dict[str, _Stall] = {}       # queue name -> reconfig in flight
        self._prefetches: dict[Any, _Prefetch] = {}  # role key -> speculative load
        self._backoff_until: dict[str, float] = {}   # queue -> no grants before t
        self._consecutive_faults: dict[str, int] = {}
        self._quarantined: set[str] = set()
        self._migrated_counts: dict[str, int] = {}   # origin queue -> in flight
        self._seq = 0
        self._t0 = self.clock.now()
        self._compute_free_t = self._t0
        self._reconfig_free_t = self._t0
        self._busy_s = 0.0
        self._completed = 0

        self._refill_sources: list[Callable[[], Any]] = []

        self._doorbell_counter = 0
        self._work = threading.Condition()
        # serializes consumers: the worker thread and a legacy synchronous
        # drain() may step concurrently; peek-then-pop must stay atomic
        self._step_lock = threading.RLock()
        self._worker: threading.Thread | None = None
        self.worker_error: BaseException | None = None   # what ended the worker loop
        self._stop = threading.Event()
        self._reconfig_pool: ThreadPoolExecutor | None = None

    # -- refill sources (tiered-pool ahead-of-need pump) -----------------------

    def register_refill_source(self, pump: Callable[[], Any]) -> None:
        """Register a tiered-pool refill pump, called once per scheduling
        step right after speculative region prefetches are issued.

        The pump (e.g. ``ServeEngine._pump_refills_external``) issues H2D
        arena refills for parked requests nearing resume — the memory-tier
        twin of ``_issue_prefetches``.  Pumps must never block on the
        caller: a pump that cannot take its own lock should return and try
        again next step.
        """
        self._refill_sources.append(pump)

    # -- queue management -----------------------------------------------------

    def add_queue(self, queue: Queue) -> Queue:
        if any(q.name == queue.name for q in self.queues):
            raise ValueError(f"duplicate queue name {queue.name!r}")
        queue.clock = self.clock
        queue.ledger = self.ledger                 # dispatch_submit attribution
        queue._notify = self._ring                 # doorbell fan-in
        self.queues.append(queue)
        self.stats[queue.name] = QueueStats()
        self._rebuild_grants()
        return queue

    def create_queue(
        self, agent: Any = None, *, name: str | None = None, size: int = 256,
        weight: int = 1,
    ) -> Queue:
        return self.add_queue(Queue(agent, size, name=name, weight=weight))

    def _rebuild_grants(self) -> None:
        order: list[int] = []
        for i, q in enumerate(self.queues):
            order.extend([i] * (q.weight if self.policy == WEIGHTED else 1))
        self._grant_order = order
        self._grant_ptr = self._grant_ptr % max(1, len(order))

    def _ring(self) -> None:
        with self._work:
            self._doorbell_counter += 1
            self._work.notify_all()

    # -- readiness ------------------------------------------------------------

    def _deps_zero(self, deps: Iterable[Any]) -> bool:
        return all(d.load() == 0 for d in deps)

    def _deps_time(self, deps: Iterable[Any], now: float) -> float:
        # completion times ride on the signal objects themselves: lifetime is
        # exactly the signal's, so no unbounded id-keyed map / stale-id reuse
        return max([now] + [getattr(d, "_complete_t", now) for d in deps])

    def _deps_error(self, deps: Iterable[Any]) -> BaseException | None:
        # like _complete_t, upstream errors ride on the signal objects: a
        # failed packet's completion still reaches 0 (waiters wake) but
        # carries the error, so barrier-AND chains propagate failure instead
        # of reporting success over a dead dependency
        for d in deps:
            err = getattr(d, "_error", None)
            if err is not None:
                return err
        return None

    def _complete(self, sig: Any, t: float,
                  error: BaseException | None = None) -> None:
        if sig is not None:
            sig._complete_t = t
            if error is not None:
                sig._error = error
            sig.store(0)

    def _note_done(self, pkt: Packet) -> None:
        self._completed += 1
        src = getattr(pkt, "_migrated_from", None)
        if src is not None:
            pkt._migrated_from = None
            c = self._migrated_counts.get(src, 0) - 1
            if c > 0:
                self._migrated_counts[src] = c
            else:
                self._migrated_counts.pop(src, None)

    def _log(self, t: float, kind: str, queue: str, what: str) -> SchedEvent:
        ev = SchedEvent(t=t, kind=kind, queue=queue, what=what, seq=self._seq)
        self._seq += 1
        if len(self.events) < self.keep_events:
            self.events.append(ev)
        else:
            self.dropped_events += 1
        return ev

    # -- the scheduling step ----------------------------------------------------

    def step(self) -> SchedEvent | None:
        """Process at most one packet (or retire one stall); None when idle.

        Cooperative core shared by ``run_until_idle`` (virtual clock,
        deterministic) and the background worker (wall clock).
        """
        with self._step_lock:
            return self._step_locked()

    def _step_locked(self) -> SchedEvent | None:
        now = self.clock.now()
        n = len(self.queues)
        if n == 0:
            return None

        # expire elapsed retry backoffs; move late submissions off
        # quarantined queues before anything can grant from them
        for qname, until in list(self._backoff_until.items()):
            if until <= now:
                del self._backoff_until[qname]
        if self._quarantined:
            for q in self.queues:
                if q.name in self._quarantined and q.pending():
                    self._migrate_pending(q)

        # retire finished prefetches before stalls: a joined stall's packet
        # must find its role resident when the grant loop re-reaches it
        self._retire_prefetches(now)

        # retire finished stalls so their queues become eligible
        for qname, stall in list(self._stalls.items()):
            if stall.future is not None:
                if not stall.future.done():
                    continue
                end = self.clock.now()
                stall.error = stall.future.result()[1]
            elif stall.end_t <= now:
                end = stall.end_t
            else:
                continue
            del self._stalls[qname]
            st = self.stats[qname]
            if stall.joined:
                # riding a prefetch: only the residual wait past compute
                # availability is exposed; the load itself retires with the
                # prefetch (reconfig_hidden).  No reconfig_end — the paired
                # prefetch_end marks the load's completion on the timeline.
                exposed = (
                    stall.exposed_s if stall.future is None
                    else max(0.0, end - stall.start_t)
                )
                st.reconfig_s += exposed
                if exposed > 0.0:
                    self.ledger.record(
                        ledger_mod.RECONFIG_EXPOSED, exposed, queue=qname,
                        role=stall.role_name, joined=True,
                    )
            else:
                st.reconfigs += 1
                st.reconfig_s += end - stall.start_t
                self.ledger.record(
                    ledger_mod.RECONFIG_EXPOSED, end - stall.start_t,
                    queue=qname, role=stall.role_name,
                )
                self._log(end, "reconfig_end", qname, stall.role_name)
            if stall.error is not None:
                q = next(qq for qq in self.queues if qq.name == qname)
                pkt = q.peek()
                if isinstance(pkt, KernelDispatchPacket):
                    if isinstance(stall.error, FaultError) and self.retry is not None:
                        # transient load fault: clean up through the
                        # abort_prefetch path and retry the load with
                        # backoff instead of failing the head packet
                        ev = self._load_fault(q, pkt, stall, end)
                        if ev is not None:
                            return ev
                    # the load can never succeed (e.g. all regions pinned,
                    # or the retry budget ran out): surface it to the
                    # waiter instead of re-stalling forever
                    return self._fail(q, pkt, stall.error, end)

        # speculate for blocked queues before granting: a prefetch issued at
        # the same virtual instant never delays this step's grants, and the
        # reconfiguration engine ordering still favors demand because flowing
        # queues contribute no candidates
        ev = self._issue_prefetches(now)
        if ev is not None:
            return ev

        # pump registered refill sources at the same point in the step: a
        # parked request scheduled for resume is a "role named in a
        # lookahead window" one tier down, and its H2D refill is issued on
        # the transfer engine ahead of the resume that would stall on it
        for pump in self._refill_sources:
            pump()

        order = self._grant_order
        width = len(order)
        if self.policy == RANDOM:
            probes = list(range(width))
            self._rng.shuffle(probes)          # seeded: reproducible schedules
        else:
            probes = [(self._grant_ptr + k) % width for k in range(width)]
        for gi in probes:
            qi = order[gi]
            q = self.queues[qi]
            if q.name in self._stalls or q.name in self._quarantined:
                continue
            if self._backoff_until.get(q.name, 0.0) > now:
                continue
            pkt = q.peek()
            if pkt is None:
                continue
            if not self._deps_zero(pkt.deps):
                continue
            if self.policy != RANDOM:
                self._grant_ptr = (gi + 1) % width
            return self._grant(q, pkt, now)

        # nothing ready now: on a virtual clock, jump to the next retire
        # (stall, in-flight prefetch, or retry-backoff expiry — whichever
        # completes first)
        if self._virtual:
            targets = (
                [s.end_t for s in self._stalls.values()]
                + [p.end_t for p in self._prefetches.values()]
                + [b for b in self._backoff_until.values() if b > now]
            )
            if targets:
                self.clock.advance_to(min(targets))
                return self._step_locked()

        if (
            self._virtual
            and not self._stalls
            and not self._prefetches
            and any(q.pending() for q in self.queues)
        ):
            # on the virtual clock every producer has already run: a non-ready
            # head can never become ready.  On a wall clock another producer
            # thread may still satisfy the dependency — just report no progress.
            heads = [
                f"{q.name}:{q.peek().__class__.__name__}"
                for q in self.queues if q.pending()
            ]
            raise SchedulerDeadlock(
                f"pending packets can never become ready: {heads} "
                "(dependency signal never reaches 0)"
            )
        return None

    def _grant(self, q: Queue, pkt: Packet, now: float) -> SchedEvent:
        """Process one granted packet — and, when it opened a burst, keep
        draining that burst in the same wakeup (burst AQL submission: one
        doorbell delivered N packets, so one grant pass retires up to N).

        The drain stops at the first packet that cannot flow — stalled on a
        reconfiguration, or deps unsatisfied — and never crosses a burst
        boundary, so round-robin fairness is preserved at burst granularity
        (a tenant's turn covers its burst, not its whole queue).
        """
        ev = self._process(q, pkt, now)
        bid = getattr(pkt, "burst_id", None)
        if not self.burst_grants or bid is None:
            return ev
        while (
            q.name not in self._stalls
            and self._backoff_until.get(q.name, 0.0) <= self.clock.now()
        ):
            nxt = q.peek()
            if nxt is None or getattr(nxt, "burst_id", None) != bid:
                break
            if not self._deps_zero(nxt.deps):
                break
            ev = self._process(q, nxt, self.clock.now())
        return ev

    # -- reconfiguration prefetch (the lookahead pipeline) -----------------------

    #: raw packets peeked per distinct-role window slot: consecutive
    #: same-role packets collapse into one *group* (they share a stall, so
    #: depth counts role switches, not packets), and the raw peek must be a
    #: multiple of the group window to see past a burst of repeats
    SCAN_BURST_FACTOR = 4

    def _scan_windows(self) -> tuple[dict, list]:
        """One pass over the stalls and every queue's lookahead window.

        Returns ``(ranks, candidates)``: roles demanded by in-flight stalls
        (rank -1) or queued packets, ranked by first-use distance (lower =
        sooner) — the victim search avoids these, and when it can't, evicts
        the one needed furthest in the future (approximate Bélády, the future
        read straight off the queues) — plus the ``(queue, role_key)``
        prefetch candidates from *blocked* queues (stalled, or head waiting
        on dependency signals; a stalled head itself is excluded — its stall
        already owns the load).

        Distance is measured in *distinct-role groups*, not raw packets:
        a burst of same-role packets is one reconfiguration however long it
        is, so ``lookahead=1`` means "the immediately-next role switch" —
        indexing by raw position would let any burst longer than the window
        hide the next role from shallow depths entirely.
        """
        ranks: dict = {
            s.role_key: -1 for s in self._stalls.values() if s.role_key is not None
        }
        candidates: list[tuple[Queue, Any]] = []
        if self.lookahead > 0:
            depth = self.lookahead + 1
            for q in self.queues:
                pkts = q.peek_window(self.SCAN_BURST_FACTOR * depth)
                if not pkts:
                    continue
                stalled = q.name in self._stalls
                blocked = stalled or not self._deps_zero(pkts[0].deps)
                d = -1                     # distinct-role group index
                prev: Any = object()       # sentinel: != every role key
                for pkt in pkts:
                    rk = getattr(pkt, "role_key", None)
                    if rk is None:
                        continue
                    if rk != prev:
                        d += 1
                        prev = rk
                        if d >= depth:
                            break
                        if ranks.get(rk, d + 1) > d:
                            ranks[rk] = d
                        if blocked and not (d == 0 and stalled):
                            candidates.append((q, rk))
        return ranks, candidates

    def _protected_keys(self) -> dict:
        return self._scan_windows()[0]

    def _issue_prefetches(self, now: float) -> SchedEvent | None:
        """Issue at most one speculative load for a blocked queue's window.

        Only queues that cannot grant right now (stalled, or head waiting on
        dependency signals) contribute candidates: a flowing queue's next miss
        is imminent demand, and speculation must not steal the reconfiguration
        engine from it.  In-flight speculation is capped strictly below the
        region count so a demand miss always finds an evictable slot (a
        single-region device therefore never speculates).  The synchronous
        baseline (``overlap_reconfig=False``) models a device with no
        separate reconfiguration engine, so it never prefetches either.
        """
        la = self.lookahead
        if la <= 0 or not self.queues or not self.overlap_reconfig:
            return None
        # the cap counts pinned slots too: slots that are pinned or mid-load
        # can never be eviction victims, so leaving one evictable slot for
        # demand requires in-flight < regions - pinned - 1
        cap = self.regions.num_regions - self.regions.pinned_count - 1
        if len(self._prefetches) >= cap:
            return None
        stalled_keys = {
            s.role_key for s in self._stalls.values() if s.role_key is not None
        }
        protect, candidates = self._scan_windows()

        for q, key in candidates:
            if key in self._prefetches or key in stalled_keys:
                continue
            if self.regions.is_resident(key) or self.regions.is_prefetching(key):
                continue
            try:
                role = self.library.get(key)
            except KeyError:
                continue                       # demand path surfaces unknown roles
            start = max(now, self._reconfig_free_t)
            if self._reconfig_pool is not None and not self._virtual:
                fut = self._reconfig_pool.submit(
                    self._do_prefetch, role, q.name, protect, protect.get(key)
                )
                self._prefetches[key] = _Prefetch(
                    role=role, role_key=key, queue=q.name,
                    start_t=start, end_t=float("inf"), future=fut,
                )
                self.stats[q.name].prefetches += 1
                return self._log(start, "prefetch_start", q.name, role.name)
            try:
                res = self.regions.begin_prefetch(
                    role, queue=q.name, protect=protect,
                    target_rank=protect.get(key),
                )
            except FaultError:
                # injected load fault on a *speculative* load: account it
                # (it is a real fault of the reconfig engine) but don't
                # punish the beneficiary queue — demand will retry properly
                self.ledger.record(
                    ledger_mod.FAULT, 0.0, queue=q.name, what=role.name,
                    kind="load",
                )
                self.ledger.record_fault(kind="load")
                self._log(start, "fault", q.name, f"{role.name}!load")
                continue
            except RuntimeError:
                continue    # structural (all pinned): the demand path fails it
            if res is None:
                continue    # no evictable region right now: best effort only
            dur = self.cost_model("reconfig", role.name, res.reconfig_s)
            end = start + dur
            self._reconfig_free_t = end
            self._prefetches[key] = _Prefetch(
                role=role, role_key=key, queue=q.name, start_t=start, end_t=end,
            )
            self.stats[q.name].prefetches += 1
            return self._log(start, "prefetch_start", q.name, role.name)
        return None

    def _do_prefetch(
        self, role: Any, qname: str, protect: dict, target_rank: int | None = None
    ) -> tuple[float, BaseException | None, bool]:
        """Threaded speculative load; (measured seconds, error, started)."""
        try:
            res = self.regions.begin_prefetch(
                role, queue=qname, protect=protect, target_rank=target_rank
            )
            if res is None:
                return 0.0, None, False
            return res.reconfig_s, None, True
        except BaseException as e:
            return 0.0, e, False

    def _retire_prefetches(self, now: float) -> None:
        for key, pf in list(self._prefetches.items()):
            if pf.future is not None:
                if not pf.future.done():
                    continue
                end = self.clock.now()
                _, pf.error, pf.started = pf.future.result()
            elif pf.end_t <= now:
                end = pf.end_t
            else:
                continue
            del self._prefetches[key]
            self._finish_prefetch(pf, end)

    def _finish_prefetch(self, pf: _Prefetch, end: float) -> None:
        st = self.stats.get(pf.queue)
        if pf.error is not None:
            self.regions.abort_prefetch(pf.role_key)
            if isinstance(pf.error, FaultError):
                self.ledger.record(
                    ledger_mod.FAULT, 0.0, queue=pf.queue, what=pf.role.name,
                    kind="load",
                )
                self.ledger.record_fault(kind="load")
            self._log(end, "prefetch_end", pf.queue, f"{pf.role.name}!error")
            return
        if not pf.started:
            if st is not None:
                st.prefetches -= 1         # the worker declined: never issued
            self._log(end, "prefetch_end", pf.queue, f"{pf.role.name}!skipped")
            return
        if not self.regions.complete_prefetch(pf.role_key, fresh=not pf.joined):
            # the in-flight entry was flushed meanwhile: the load produced no
            # resident role, so there is no hidden time to credit (flush
            # already counted it as wasted)
            self._log(end, "prefetch_end", pf.queue, f"{pf.role.name}!flushed")
            return
        if pf.future is not None:
            # threaded joins can't precompute their exposure (the load's end
            # is unknown at join time): claim it now from the live joined
            # stalls so the overlap window isn't double-counted as both
            # exposed and hidden
            for stall in self._stalls.values():
                if stall.joined and stall.role_key == pf.role_key:
                    pf.exposed_s = max(pf.exposed_s, end - stall.start_t)
        hidden = max(0.0, (end - pf.start_t) - pf.exposed_s)
        self.ledger.record(
            ledger_mod.RECONFIG_HIDDEN, hidden, queue=pf.queue, role=pf.role.name,
        )
        if st is not None:
            st.reconfig_hidden_s += hidden
        self._log(end, "prefetch_end", pf.queue, pf.role.name)

    def _join_prefetch(
        self, q: Queue, pkt: KernelDispatchPacket, role: Any, pf: _Prefetch,
        now: float,
    ) -> SchedEvent:
        """A demand miss found its role already in flight: ride the prefetch
        instead of double-loading (the lookahead pipeline's payoff)."""
        pkt._reconfigured = True
        self.stats[q.name].prefetch_hits += 1
        start = max(now, self._deps_time(pkt.deps, now))
        if pf.future is None and pf.end_t <= max(start, self._compute_free_t):
            # load finishes before this packet could execute anyway: fully
            # hidden.  Retire the prefetch (its end is in the causal past)
            # and execute without stalling the queue.  First-touch accounting
            # in the exec path counts the prefetch hit.
            del self._prefetches[role.key]
            self._finish_prefetch(pf, pf.end_t)
            self._log(start, "prefetch_hit", q.name, role.name)
            return self._exec(q, pkt, role, now)
        pf.joined = True
        self.regions.note_prefetch_join(role.key)
        exposed = (
            max(0.0, pf.end_t - max(start, self._compute_free_t))
            if pf.future is None else 0.0
        )
        # every joiner's exposure window ends at pf.end_t, so overlapping
        # joins nest: the union (max), not the sum, is what the load hid
        pf.exposed_s = max(pf.exposed_s, exposed)
        self._stalls[q.name] = _Stall(
            role.name, start, pf.end_t, future=pf.future, role_key=role.key,
            joined=True, exposed_s=exposed,
        )
        return self._log(start, "prefetch_hit", q.name, role.name)

    # -- packet processing -------------------------------------------------------

    def _process(self, q: Queue, pkt: Packet, now: float) -> SchedEvent:
        if isinstance(pkt, BarrierAndPacket):
            q.pop()
            t = self._deps_time(pkt.deps, now)
            err = self._deps_error(pkt.deps)
            self.stats[q.name].barriers += 1
            self._note_done(pkt)
            what = f"and[{len(pkt.deps)}]" + ("!error" if err is not None else "")
            ev = self._log(t, "barrier", q.name, what)
            self._complete(pkt.completion, t, error=err)
            return ev

        assert isinstance(pkt, KernelDispatchPacket)
        dep_err = self._deps_error(pkt.deps)
        if dep_err is not None:
            # an upstream dependency failed: this packet must not run on its
            # (missing) result — fail it with the propagated error, which its
            # own completion signal carries onward through the chain
            return self._fail(q, pkt, dep_err, now)
        role = None
        if pkt.role_key is not None:
            try:
                role = self.library.get(pkt.role_key)
            except KeyError as e:
                return self._fail(q, pkt, e, now)
            if not self.regions.is_resident(role.key):
                pf = self._prefetches.get(role.key)
                if pf is not None and pf.error is None:
                    return self._join_prefetch(q, pkt, role, pf, now)
                # not resident — even if a prior stall loaded it and another
                # tenant evicted it since: stall (again) with full accounting
                # rather than reloading invisibly at exec time
                return self._begin_reconfig(q, pkt, role, now)
        return self._exec(q, pkt, role, now)

    def _fail(self, q: Queue, pkt: KernelDispatchPacket, err: BaseException,
              now: float) -> SchedEvent:
        q.pop()
        pkt.out.error = err
        self._note_done(pkt)
        ev = self._log(now, "error", q.name, pkt.what)
        self._complete(pkt.completion, now, error=err)
        return ev

    # -- fault handling (retry / backoff / watchdog / quarantine) ---------------

    _WATCHDOG_FALLBACK = RetryPolicy()

    def _watchdog_s(self, what: str) -> float:
        """Watchdog window for one launch of ``what`` — how long a wedged
        launch occupies the compute engine before being killed."""
        e = self.expected_exec_s
        expected = 0.0 if e is None else (e(what) if callable(e) else float(e))
        policy = self.retry if self.retry is not None else self._WATCHDOG_FALLBACK
        return policy.watchdog_deadline(expected)

    def _handle_fault(self, q: Queue, pkt: KernelDispatchPacket,
                      err: BaseException, *, kind: str, seconds: float,
                      t: float) -> SchedEvent:
        """A launch attempt died to a hardware-class fault (already popped):
        account it, then retry in place with backoff or fail the packet."""
        permanent = isinstance(err, PermanentFault)
        self.ledger.record(
            ledger_mod.FAULT, seconds, queue=q.name, what=pkt.what, kind=kind,
        )
        self.ledger.record_fault(kind=kind, permanent=permanent)
        self._log(t, "fault", q.name, f"{pkt.what}!{kind}")
        k = self._consecutive_faults.get(q.name, 0) + 1
        self._consecutive_faults[q.name] = k

        attempts = getattr(pkt, "_attempts", 1)
        retryable = (
            self.retry is not None
            and not permanent
            and attempts <= self.retry.max_retries
        )
        if retryable:
            pkt._attempts = attempts + 1
            pkt.out.error = None
            q.requeue_head(pkt)
            backoff = self.retry.backoff(attempts)
            self._backoff_until[q.name] = max(
                self._backoff_until.get(q.name, 0.0), t + backoff
            )
            self.ledger.record(
                ledger_mod.RETRY, backoff, queue=q.name, what=pkt.what,
            )
            self.ledger.record_retry()
            ev = self._log(t, "retry", q.name, f"{pkt.what}#{attempts}")
        else:
            pkt.out.error = err
            self._note_done(pkt)
            ev = self._log(t, "error", q.name, pkt.what)
            self._complete(pkt.completion, t, error=err)
        self._maybe_quarantine(q, k, t)
        return ev

    def _load_fault(self, q: Queue, pkt: KernelDispatchPacket, stall: _Stall,
                    t: float) -> SchedEvent | None:
        """A demand region load died to a transient fault.  Clean up through
        the abort_prefetch path and retry the load (the head packet stays
        queued; the grant loop re-stalls it after the backoff).  Returns None
        when the retry budget is exhausted — the caller fails the packet."""
        attempts = getattr(pkt, "_attempts", 1)
        self.ledger.record(
            ledger_mod.FAULT, max(0.0, t - stall.start_t), queue=q.name,
            what=stall.role_name, kind="load",
        )
        self.ledger.record_fault(kind="load")
        self._log(t, "fault", q.name, f"{stall.role_name}!load")
        k = self._consecutive_faults.get(q.name, 0) + 1
        self._consecutive_faults[q.name] = k
        if attempts > self.retry.max_retries:
            self._maybe_quarantine(q, k, t)
            return None
        if stall.role_key is not None:
            self.regions.abort_prefetch(stall.role_key)
        pkt._attempts = attempts + 1
        backoff = self.retry.backoff(attempts)
        self._backoff_until[q.name] = max(
            self._backoff_until.get(q.name, 0.0), t + backoff
        )
        self.ledger.record(
            ledger_mod.RETRY, backoff, queue=q.name, what=stall.role_name,
        )
        self.ledger.record_retry()
        ev = self._log(t, "retry", q.name, f"{stall.role_name}#{attempts}")
        self._maybe_quarantine(q, k, t)
        return ev

    def _maybe_quarantine(self, q: Queue, consecutive: int, t: float) -> None:
        if (
            self.retry is None
            or self.retry.quarantine_after <= 0
            or consecutive < self.retry.quarantine_after
            or q.name in self._quarantined
        ):
            return
        siblings = [
            qq for qq in self.queues
            if qq.name != q.name and qq.name not in self._quarantined
        ]
        if not siblings:
            # a lone queue has nowhere to send its packets: keep serving it
            # (resetting the streak so the check doesn't fire every fault)
            self._consecutive_faults[q.name] = 0
            return
        self._quarantined.add(q.name)
        self._backoff_until.pop(q.name, None)
        n = self._migrate_pending(q)
        self.ledger.record_quarantine(migrated=n)
        self._log(t, "quarantine", q.name, f"migrated[{n}]")

    def _migrate_pending(self, q: Queue) -> int:
        """Round-robin every pending packet of ``q`` onto non-quarantined
        sibling queues.  Packets keep their enqueue_t (WAIT accounting spans
        the migration) and are tagged with their origin so ``drain(q)`` still
        waits for them."""
        siblings = [
            qq for qq in self.queues
            if qq.name != q.name and qq.name not in self._quarantined
        ]
        if not siblings:
            return 0
        n = 0
        while True:
            pkt = q.pop()
            if pkt is None:
                break
            if getattr(pkt, "_migrated_from", None) is None:
                pkt._migrated_from = q.name
                self._migrated_counts[q.name] = (
                    self._migrated_counts.get(q.name, 0) + 1
                )
            siblings[n % len(siblings)].submit(pkt)
            n += 1
        return n

    def reinstate(self, name: str) -> None:
        """Lift a queue's quarantine (operator action / sibling recovered)."""
        self._quarantined.discard(name)
        self._consecutive_faults.pop(name, None)

    @property
    def quarantined_queues(self) -> frozenset[str]:
        return frozenset(self._quarantined)

    def _begin_reconfig(self, q: Queue, pkt: KernelDispatchPacket, role: Any,
                        now: float) -> SchedEvent:
        """Stall *this queue only* while the role loads into a region."""
        pkt._reconfigured = True
        engine_free = (
            self._reconfig_free_t if self.overlap_reconfig else self._compute_free_t
        )
        # deps gate the grant in *virtual* time too: eligibility is checked on
        # live signal state, which runs ahead of the simulated timeline
        start = max(now, engine_free, self._deps_time(pkt.deps, now))
        protect = self._protected_keys()

        if self._reconfig_pool is not None and not self._virtual:
            fut = self._reconfig_pool.submit(self._do_reconfig, role, q.name, protect)
            self._stalls[q.name] = _Stall(
                role.name, start, float("inf"), future=fut, role_key=role.key,
            )
            return self._log(start, "reconfig_start", q.name, role.name)

        measured, err, _ = self._do_reconfig(role, q.name, protect)
        dur = self.cost_model("reconfig", role.name, measured)
        end = start + dur
        if self.overlap_reconfig:
            self._reconfig_free_t = end
        else:
            self._compute_free_t = end        # sync baseline: device does the load
        self._stalls[q.name] = _Stall(
            role.name, start, end, error=err, role_key=role.key,
        )
        return self._log(start, "reconfig_start", q.name, role.name)

    def _do_reconfig(
        self, role: Any, qname: str, protect: dict | frozenset = frozenset()
    ) -> tuple[float, BaseException | None, bool]:
        """Load the role; returns (measured seconds, error-or-None, started)."""
        try:
            res = self.regions.ensure_resident(role, queue=qname, protect=protect)
            return res.reconfig_s, None, True
        except BaseException as e:
            return 0.0, e, False

    def _exec(self, q: Queue, pkt: KernelDispatchPacket, role: Any,
              now: float) -> SchedEvent:
        g0 = time.perf_counter_ns()        # grant leg: pick-up -> launch returned
        start = max(now, self._compute_free_t, self._deps_time(pkt.deps, now))
        q.pop()
        st = self.stats[q.name]
        if getattr(pkt, "_attempts", 1) == 1:
            # retries keep the original enqueue_t; WAIT is the first attempt's
            # (the retry delay is priced separately as RETRY backoff)
            wait = max(
                0.0,
                start - (pkt.enqueue_t if pkt.enqueue_t is not None else start),
            )
            st.wait_s += wait
            self.ledger.record(
                ledger_mod.WAIT, wait, queue=q.name, what=pkt.what,
                producer=pkt.producer,
            )
        self._log(start, "exec_start", q.name, pkt.what)

        fault = (
            self.faults.draw_exec(pkt.what, queue=q.name)
            if self.faults is not None else None
        )
        wedged = isinstance(fault, WedgedLaunch)
        measured = 0.0
        if fault is not None:
            pkt.out.error = fault
        else:
            try:
                t0 = time.perf_counter_ns()
                if role is not None:
                    if getattr(pkt, "_reconfigured", False):
                        # stall already accounted this packet's lookup; if the role
                        # was evicted meanwhile (or its reconfig failed), re-load
                        # properly instead of executing outside region management
                        if not self.regions.touch(role.key):
                            # lazy protect: the window scan only runs if this
                            # lookup actually misses and must evict
                            self.regions.ensure_resident(
                                role, queue=q.name, protect=self._protected_keys
                            )
                    else:
                        self.regions.ensure_resident(
                            role, queue=q.name, protect=self._protected_keys
                        )
                    out = role(*pkt.args)
                else:
                    out = pkt.fn(*pkt.args)
                t1 = time.perf_counter_ns()
                self.ledger.record(
                    ledger_mod.DISPATCH, (t1 - t0) * 1e-9,
                    role=pkt.what, producer=pkt.producer, queue=q.name,
                )
                self.ledger.record(
                    ledger_mod.DISPATCH_GRANT, (t1 - g0) * 1e-9,
                    role=pkt.what, producer=pkt.producer, queue=q.name,
                    burst=pkt.burst_n,
                )
                sync_outputs(out)
                t2 = time.perf_counter_ns()
                self.ledger.record(
                    ledger_mod.EXEC, (t2 - t1) * 1e-9, role=pkt.what, queue=q.name
                )
                measured = (t2 - t0) * 1e-9
                pkt.out.value = out
            except BaseException as e:      # surface to waiter, don't kill the loop
                pkt.out.error = e

        if wedged:
            # the launch never completes: only the watchdog ends it, and the
            # attempt is charged its full deadline window on the timeline
            dur = self._watchdog_s(pkt.what)
        else:
            # keyed by role.name to match the reconfig path (calibration dicts
            # use role names, not shape-specialized key strings)
            dur = self.cost_model(
                "exec", role.name if role is not None else pkt.what, measured
            )
        end = start + dur
        self._compute_free_t = end
        self._busy_s += dur

        err = pkt.out.error
        if isinstance(err, FaultError):
            kind = ("wedge" if wedged
                    else "load" if isinstance(err, InjectedLoadFault)
                    else "exec")
            return self._handle_fault(q, pkt, err, kind=kind, seconds=dur, t=end)
        self._consecutive_faults.pop(q.name, None)
        st.exec_s += dur
        st.dispatched += 1
        self._note_done(pkt)
        ev = self._log(end, "exec_end", q.name, pkt.what)
        self._complete(pkt.completion, end, error=err)
        return ev

    # -- cooperative driving -------------------------------------------------------

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive the loop until every queue is empty; returns packets completed."""
        before = self._completed
        for _ in range(max_steps):
            ev = self.step()
            if ev is None:
                if self._await_stall():
                    continue
                if any(q.pending() for q in self.queues):
                    # wall clock: a dependency owned by another producer thread
                    # may clear any moment (legacy drain blocked here too)
                    self.clock.sleep(0.0002)
                    continue
                break
        else:
            raise RuntimeError(f"scheduler did not go idle in {max_steps} steps")
        return self._completed - before

    def _await_stall(self) -> bool:
        """Block on an in-flight threaded reconfig or prefetch (lock-safe peek)."""
        with self._step_lock:
            fut = next(
                (s.future for s in self._stalls.values() if s.future is not None),
                None,
            ) or next(
                (p.future for p in self._prefetches.values() if p.future is not None),
                None,
            )
        if fut is None:
            return False
        fut.result()
        return True

    def drain(self, queue: Queue | None = None, max_steps: int = 1_000_000) -> int:
        """Synchronously run until ``queue`` is empty (all queues when None).

        Unlike ``run_until_idle`` this does not insist the *other* tenants'
        queues go idle: a dep-blocked packet on someone else's queue must not
        wedge this producer's drain.  Returns packets completed meanwhile
        (other queues' packets may ride along — one compute engine).
        """
        if queue is None:
            return self.run_until_idle(max_steps)
        if all(q is not queue for q in self.queues):
            self.add_queue(queue)
        before = self._completed
        for _ in range(max_steps):
            if (
                queue.pending() == 0
                and queue.name not in self._stalls
                and not self._migrated_counts.get(queue.name)
            ):
                break
            ev = self.step()
            if ev is None and not self._await_stall():
                self.clock.sleep(0.0002)      # wall clock: await foreign producer
        else:
            raise RuntimeError(f"queue {queue.name} did not drain in {max_steps} steps")
        return self._completed - before

    @property
    def running(self) -> bool:
        """True while the threaded worker owns the consume side."""
        return self._worker is not None

    # -- threaded driving ----------------------------------------------------------

    def start(self, poll_s: float = 0.0005, reconfig_workers: int = 1) -> None:
        if self._worker is not None:
            raise RuntimeError("scheduler already running")
        if self._virtual:
            raise RuntimeError("threaded mode requires a wall clock")
        self._stop.clear()
        self._reconfig_pool = ThreadPoolExecutor(
            max_workers=reconfig_workers, thread_name_prefix="hsa-reconfig"
        )

        self.worker_error = None

        def loop() -> None:
            last = -1
            while not self._stop.is_set():
                try:
                    progressed = self.step() is not None
                except SchedulerDeadlock:
                    progressed = False        # producers may still unblock us
                except BaseException as e:    # a fault of the loop itself, not of a packet:
                    self.worker_error = e     # kept for waiters and re-raised by stop()
                    self._stop.set()
                    raise
                if progressed:
                    continue
                with self._work:
                    if self._doorbell_counter == last:
                        self._work.wait(timeout=poll_s)
                    last = self._doorbell_counter

        self._worker = threading.Thread(target=loop, name="hsa-scheduler", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        """Stop the worker thread; re-raises an error that ended its loop
        (a packet's own error is its waiter's, in ``pkt.out.error``)."""
        if self._worker is not None:
            self._stop.set()
            self._ring()
            self._worker.join(timeout=5.0)
            self._worker = None
        if self._reconfig_pool is not None:
            self._reconfig_pool.shutdown(wait=True)
            self._reconfig_pool = None
        err, self.worker_error = self.worker_error, None
        if err is not None:
            raise RuntimeError("the HSA scheduler's worker thread died") from err

    # -- reporting ------------------------------------------------------------------

    def event_log(self) -> list[SchedEvent]:
        """Events in timeline order (stable on simultaneous timestamps)."""
        return sorted(self.events, key=lambda e: (e.t, e.seq))

    def timeline(self) -> dict[str, float]:
        """Makespan / busy / idle accounting for the device's compute engine."""
        end = max(
            [self._compute_free_t, self.clock.now()]
            + [s.end_t for s in self._stalls.values() if s.end_t != float("inf")]
        )
        makespan = max(0.0, end - self._t0)
        busy = self._busy_s
        return {
            "makespan_s": makespan,
            "busy_s": busy,
            "idle_s": max(0.0, makespan - busy),
            "idle_fraction": (max(0.0, makespan - busy) / makespan) if makespan else 0.0,
        }

    def queue_report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "wait_s": st.wait_s,
                "exec_s": st.exec_s,
                "reconfig_s": st.reconfig_s,
                "reconfig_hidden_s": st.reconfig_hidden_s,
                "dispatched": float(st.dispatched),
                "barriers": float(st.barriers),
                "reconfigs": float(st.reconfigs),
                "prefetches": float(st.prefetches),
                "prefetch_hits": float(st.prefetch_hits),
            }
            for name, st in self.stats.items()
        }

    def exposed_reconfig_s(self) -> float:
        """Total queue-stalling (exposed) reconfiguration time — the quantity
        the lookahead prefetcher drives toward zero (paper Table II row 2)."""
        return sum(st.reconfig_s for st in self.stats.values())
