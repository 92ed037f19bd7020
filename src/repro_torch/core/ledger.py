"""Overhead ledger — reproduces the accounting structure of paper Table II.

The paper decomposes the cost of transparent acceleration into exactly three
categories:

  ===================  =====================  =============================
  category             occurrence             FPGA meaning -> GPU meaning
  ===================  =====================  =============================
  device/kernel setup  once                   runtime+driver init, kernel
                                              registration -> hsa_init(),
                                              registry build, nvcc build
  reconfiguration      if not configured      partial bitstream load ->
                                              role residency miss (weight
                                              upload, warm-up launch)
  dispatch latency     every dispatch         AQL packet -> kernel launch
  ===================  =====================  =============================

All entries are *measured* wall times (perf_counter_ns), never simulated
constants.  ``table()`` renders the Table II layout.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Iterator

import contextlib

SETUP = "setup"
RECONFIG = "reconfig"
DISPATCH = "dispatch"
EXEC = "exec"                 # kernel execution proper (not in Table II, kept for Table III)
WAIT = "wait"                 # queue residency: submit -> launch grant (scheduler)

# Table II row 3 ("dispatch latency"), split along the packet round trip.
# One kernel invocation through the HSA layer costs the producer a full
# submit -> doorbell -> grant -> completion-wait cycle; fused multi-token
# decode and burst AQL submission amortize exactly these three host-side
# legs, so they are ledgered separately (DISPATCH keeps the legacy
# launch-call measurement for Table II continuity):
#
#   dispatch_submit  producer writes the packet(s) + rings the doorbell
#                    (one doorbell per *burst*: submit_burst divides the
#                    measured cost over its N packets)
#   dispatch_grant   scheduler host time from picking the packet up to the
#                    launch call returning (the grant leg of the round trip)
#   dispatch_wait    producer blocks on the completion signal(s) (one
#                    wait_all over a burst divides over its N packets)
DISPATCH_SUBMIT = "dispatch_submit"
DISPATCH_GRANT = "dispatch_grant"
DISPATCH_WAIT = "dispatch_wait"

# Table II row 2, split by whether the load stalled a queue.  RECONFIG keeps
# the *measured* load time (recorded by RegionManager at the choke point);
# the scheduler additionally attributes each load's schedule time as
# *exposed* (the issuing queue sat stalled) or *hidden* (overlapped with
# compute by the lookahead prefetcher).  exposed + hidden reconstructs the
# scheduler-clock reconfiguration total; driving exposed toward zero is the
# prefetch pipeline's whole point.
RECONFIG_EXPOSED = "reconfig_exposed"
RECONFIG_HIDDEN = "reconfig_hidden"

# Overcommitted paged serving (Table I "overcommit" row): the host time spent
# reclaiming a victim's KV pages (park, incl. the optional snapshot gather)
# and bringing a parked request back (resume: snapshot restore, or the
# re-prefill's extra prefill — the *replayed decode* rides the normal decode
# categories and is accounted as recompute_tokens, not time, because it is
# indistinguishable from useful work at the launch level).
PREEMPT_PARK = "preempt_park"
PREEMPT_RESUME = "preempt_resume"

# Serving latency under live traffic (the table9 SLO metrics).  One TTFT
# sample per request (arrival -> first generated token, engine clock) and one
# TPOT sample per request (mean inter-token time over its decode phase).
# Both ride the same bounded quantile windows as dispatch_wait, so
# ``quantile()`` gives the recent p50/p99 a feeder-facing SLO check wants —
# not an all-time mean that a warmup spike poisons forever.
TTFT = "ttft"
TPOT = "tpot"

# Fault tolerance (the self-healing runtime's availability accounting).
# FAULT is the schedule time an attempt lost to an injected/real failure
# (a wedged launch charges its whole watchdog window); RETRY is backoff
# delay spent between attempts; RECOVER is engine-clock time from a
# request's fault-park to its successful resume (MTTR samples).
FAULT = "fault"
RETRY = "retry"
RECOVER = "recover"

# Tiered KV page pool (the host-arena second tier).  SPILL is the D2H DMA
# time parking a snapshot into the arena (engine-timeline: it never stalls
# compute — the gather already happened, only later refills queue behind
# it).  REFILL is the H2D DMA duration bringing a snapshot back; like
# reconfiguration it splits into *exposed* (the resume step sat stalled on
# the transfer) vs *hidden* (the ahead-of-need pump issued it early enough
# to overlap decode) — driving exposed toward zero is what the refill
# lookahead exists for.
SPILL = "spill"
REFILL = "refill"
REFILL_EXPOSED = "refill_exposed"
REFILL_HIDDEN = "refill_hidden"

# Data integrity (silent-corruption detection).  SCRUB is host time the
# step-driven background audit spends re-hashing cold device pages and
# parked arena blocks — the audit-overhead numerator integrity_split()
# grades against total step time.
SCRUB = "scrub"

CATEGORIES = (SETUP, RECONFIG, RECONFIG_EXPOSED, RECONFIG_HIDDEN, DISPATCH,
              DISPATCH_SUBMIT, DISPATCH_GRANT, DISPATCH_WAIT, EXEC, WAIT,
              PREEMPT_PARK, PREEMPT_RESUME, TTFT, TPOT,
              FAULT, RETRY, RECOVER,
              SPILL, REFILL, REFILL_EXPOSED, REFILL_HIDDEN,
              SCRUB)

OCCURRENCE = {
    SETUP: "once",
    RECONFIG: "if not configured",
    RECONFIG_EXPOSED: "if not configured",
    RECONFIG_HIDDEN: "if not configured",
    DISPATCH: "every dispatch",
    DISPATCH_SUBMIT: "every dispatch",
    DISPATCH_GRANT: "every dispatch",
    DISPATCH_WAIT: "every dispatch",
    EXEC: "every dispatch",
    WAIT: "every dispatch",
    PREEMPT_PARK: "on pool pressure",
    PREEMPT_RESUME: "per resume",
    TTFT: "per request",
    TPOT: "per request",
    FAULT: "on fault",
    RETRY: "per retry",
    RECOVER: "per recovery",
    SPILL: "on spill",
    REFILL: "per refill",
    REFILL_EXPOSED: "per refill",
    REFILL_HIDDEN: "per refill",
    SCRUB: "per scrub pass",
}


@dataclasses.dataclass
class Entry:
    category: str
    seconds: float
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Stat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = math.inf
    max_s: float = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    @property
    def mean_us(self) -> float:
        return (self.total_s / self.count) * 1e6 if self.count else 0.0


#: bounded per-(producer, category) sample window backing ``quantile()`` —
#: large enough for a stable p99, small enough to track regime changes
#: (the feedback FusionPolicy wants "recent contention", not all-time).
QUANTILE_WINDOW = 256


class OverheadLedger:
    """Thread-safe accumulator of measured runtime overheads."""

    _PREEMPT_ZERO = {
        "preemptions": 0.0, "resumes": 0.0, "pages_reclaimed": 0.0,
        "recompute_tokens": 0.0, "snapshot_resumes": 0.0,
        "reprefill_resumes": 0.0, "snapshot_bytes": 0.0,
    }

    _FAULT_ZERO = {
        "faults": 0.0, "exec_faults": 0.0, "load_faults": 0.0,
        "wedges": 0.0, "permanent_faults": 0.0, "transfer_faults": 0.0,
        "retries": 0.0,
        "quarantines": 0.0, "migrated_packets": 0.0,
        "recoveries": 0.0, "failed_requests": 0.0,
        "recovery_recompute_tokens": 0.0, "mttr_total_s": 0.0,
    }

    _SPILL_ZERO = {
        "spills": 0.0, "refills": 0.0, "spill_bytes": 0.0,
        "refill_bytes": 0.0, "demotions": 0.0, "demoted_bytes": 0.0,
        "replay_fallback_tokens": 0.0,
        "host_used_bytes": 0.0, "host_peak_bytes": 0.0,
        "host_budget_bytes": math.inf,   # inf = unbounded / no budget set
    }

    _INTEGRITY_ZERO = {
        "corruptions": 0.0,
        "corrupt_pages": 0.0, "corrupt_blocks": 0.0,
        "corrupt_transfers": 0.0, "stale_regions": 0.0,
        "detected": 0.0,
        "detected_scrub": 0.0, "detected_read": 0.0,
        "detected_transfer": 0.0, "detected_region": 0.0,
        "integrity_recoveries": 0.0,
        "scrubbed_pages": 0.0, "scrubbed_blocks": 0.0,
        "scrub_targets": 0.0,
        "quarantined_pages": 0.0,
        "verified_transfers": 0.0, "verified_regions": 0.0,
        "escaped": 0.0,   # corruption that influenced a sampled token
    }

    _CORRUPTION_KEY = {
        "flip_page": "corrupt_pages", "flip_block": "corrupt_blocks",
        "corrupt_transfer": "corrupt_transfers",
        "stale_region": "stale_regions",
    }

    _PREFIX_ZERO = {
        "prefix_lookups": 0.0, "prefix_hits": 0.0,
        "shared_pages": 0.0,        # gauge: pages with refcount > 1 now
        "peak_shared_pages": 0.0,
        "pages_saved": 0.0,         # private prompt-page allocations avoided
        "cow_copies": 0.0,          # re-prefills forced by the CoW paths
    }

    def __init__(self, keep_entries: bool = False) -> None:
        self._lock = threading.Lock()
        self._stats: dict[str, Stat] = {c: Stat() for c in CATEGORIES}
        self._entries: list[Entry] | None = [] if keep_entries else None
        self._by_queue: dict[str, dict[str, Stat]] = {}
        self._by_producer: dict[str, dict[str, Stat]] = {}
        # (producer|None, category) -> ring of recent samples
        self._recent: dict[tuple[str | None, str], deque[float]] = {}
        self._memory: dict[str, dict[str, float]] = {}
        self._preempt: dict[str, float] = dict(self._PREEMPT_ZERO)
        self._fault: dict[str, float] = dict(self._FAULT_ZERO)
        self._spill: dict[str, float] = dict(self._SPILL_ZERO)
        self._integrity: dict[str, float] = dict(self._INTEGRITY_ZERO)
        self._prefix: dict[str, float] = dict(self._PREFIX_ZERO)

    def record(self, category: str, seconds: float, **meta: Any) -> None:
        if category not in self._stats:
            raise ValueError(f"unknown ledger category {category!r}")
        with self._lock:
            self._stats[category].add(seconds)
            self._recent.setdefault(
                (None, category), deque(maxlen=QUANTILE_WINDOW)
            ).append(seconds)
            if "queue" in meta and meta["queue"] is not None:
                per_q = self._by_queue.setdefault(str(meta["queue"]), {})
                per_q.setdefault(category, Stat()).add(seconds)
            if "producer" in meta and meta["producer"] is not None:
                producer = str(meta["producer"])
                per_p = self._by_producer.setdefault(producer, {})
                per_p.setdefault(category, Stat()).add(seconds)
                self._recent.setdefault(
                    (producer, category), deque(maxlen=QUANTILE_WINDOW)
                ).append(seconds)
            if self._entries is not None:
                self._entries.append(Entry(category, seconds, meta))

    def quantile(self, category: str, q: float,
                 producer: str | None = None) -> float | None:
        """Empirical quantile over the recent sample window (None if empty).

        ``producer=`` restricts to that producer's samples — the feedback
        :class:`~repro_torch.core.policy.FusionPolicy` reads the p99 of *foreign*
        producers' ``dispatch_wait`` here to decide how hard serving may
        lean on the shared device.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            window = self._recent.get((producer, category))
            if not window:
                return None
            ordered = sorted(window)
        idx = min(len(ordered) - 1, int(math.ceil(q * len(ordered))) - 1)
        return ordered[max(0, idx)]

    def producers(self) -> list[str]:
        with self._lock:
            return sorted(self._by_producer)

    @contextlib.contextmanager
    def timed(self, category: str, **meta: Any) -> Iterator[None]:
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.record(category, (time.perf_counter_ns() - t0) * 1e-9, **meta)

    def stat(self, category: str) -> Stat:
        with self._lock:
            return dataclasses.replace(self._stats[category])

    def entries(self) -> list[Entry]:
        with self._lock:
            return list(self._entries or ())

    def queue_breakdown(self) -> dict[str, dict[str, Stat]]:
        """Per-queue stats for entries recorded with ``queue=`` meta
        (the scheduler's wait/exec/reconfig attribution)."""
        with self._lock:
            return {
                q: {c: dataclasses.replace(s) for c, s in per_q.items()}
                for q, per_q in self._by_queue.items()
            }

    def producer_breakdown(self) -> dict[str, dict[str, Stat]]:
        """Per-producer stats for entries recorded with ``producer=`` meta —
        the dispatch_submit/grant/wait split Table II's invocation row
        decomposes into, attributed to whoever pays it (the TF serving
        engine, an OpenCL-style tenant, ...)."""
        with self._lock:
            return {
                p: {c: dataclasses.replace(s) for c, s in per_p.items()}
                for p, per_p in self._by_producer.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._stats = {c: Stat() for c in CATEGORIES}
            self._by_queue = {}
            self._by_producer = {}
            self._recent = {}
            self._memory = {}
            self._preempt = dict(self._PREEMPT_ZERO)
            self._fault = dict(self._FAULT_ZERO)
            self._spill = dict(self._SPILL_ZERO)
            self._integrity = dict(self._INTEGRITY_ZERO)
            self._prefix = dict(self._PREFIX_ZERO)
            if self._entries is not None:
                self._entries = []

    # -- memory accounting (Table I utilization) -----------------------------

    def record_memory(self, *, reserved_bytes: float, used_bytes: float,
                      label: str = "kv_cache") -> None:
        """Record a point-in-time memory split for ``label``.

        ``reserved_bytes`` is the capacity held against *admitted* requests
        (dense: live slots × max_len rows; paged: mapped pages) —
        reservation, not physical allocation: an idle slot or free page is
        available capacity, not stranded.  ``used_bytes`` is the portion
        actually carrying cached tokens.  The difference is **stranded** —
        reserved capacity no other request can use, the quantity the paged
        cache exists to crush.  Latest values and peaks are kept per label.
        """
        if used_bytes > reserved_bytes + 1e-9:
            raise ValueError(
                f"used {used_bytes} > reserved {reserved_bytes} for {label!r}"
            )
        with self._lock:
            m = self._memory.setdefault(label, {
                "reserved_bytes": 0.0, "used_bytes": 0.0,
                "stranded_bytes": 0.0, "peak_reserved_bytes": 0.0,
                "peak_stranded_bytes": 0.0, "samples": 0.0,
            })
            m["reserved_bytes"] = float(reserved_bytes)
            m["used_bytes"] = float(used_bytes)
            m["stranded_bytes"] = float(reserved_bytes - used_bytes)
            m["peak_reserved_bytes"] = max(m["peak_reserved_bytes"],
                                           float(reserved_bytes))
            m["peak_stranded_bytes"] = max(m["peak_stranded_bytes"],
                                           float(reserved_bytes - used_bytes))
            m["samples"] += 1.0

    def record_host_memory(self, *, used_bytes: float,
                           budget_bytes: float | None = None) -> None:
        """Record a point-in-time host-arena occupancy sample (the page
        pool's second tier).  ``budget_bytes=None`` means unbounded and is
        reported as ``inf`` — distinguishable from a genuine zero budget
        (a valid configuration: every park demotes to replay)."""
        budget = math.inf if budget_bytes is None else float(budget_bytes)
        if used_bytes > budget + 1e-9:
            raise ValueError(
                f"host used {used_bytes} > budget {budget} — the arena "
                "crossed its hard ceiling"
            )
        with self._lock:
            self._spill["host_used_bytes"] = float(used_bytes)
            self._spill["host_peak_bytes"] = max(
                self._spill["host_peak_bytes"], float(used_bytes)
            )
            self._spill["host_budget_bytes"] = budget

    def memory_split(self, label: str = "kv_cache") -> dict[str, float]:
        """Reserved vs used vs stranded bytes for ``label`` (Table I row).

        ``utilization`` = used / reserved of the latest sample (1.0 when
        nothing is reserved: an empty pool strands nothing).  The host-tier
        rows (``host_used_bytes`` / ``host_peak_bytes`` /
        ``host_budget_bytes``) ride along so one call prices both tiers of
        the page pool.
        """
        with self._lock:
            m = dict(self._memory.get(label, {}))
            host = {k: self._spill[k] for k in
                    ("host_used_bytes", "host_peak_bytes",
                     "host_budget_bytes")}
        if not m:
            m = {"reserved_bytes": 0.0, "used_bytes": 0.0,
                 "stranded_bytes": 0.0, "peak_reserved_bytes": 0.0,
                 "peak_stranded_bytes": 0.0, "samples": 0.0}
        m["utilization"] = (
            m["used_bytes"] / m["reserved_bytes"] if m["reserved_bytes"] else 1.0
        )
        m.update(host)
        return m

    # -- overcommit accounting (Table I "overcommit" row) --------------------

    def record_preemption(self, *, pages_reclaimed: int,
                          snapshot_bytes: int = 0) -> None:
        """One victim parked: its pages went back to the pool; a snapshot
        park additionally copied ``snapshot_bytes`` of KV to the host."""
        with self._lock:
            self._preempt["preemptions"] += 1.0
            self._preempt["pages_reclaimed"] += float(pages_reclaimed)
            self._preempt["snapshot_bytes"] += float(snapshot_bytes)

    def record_resume(self, *, mode: str, recompute_tokens: int = 0) -> None:
        """One parked request resumed.  ``recompute_tokens`` is the wasted
        work of the re-prefill path (prompt recompute + generated-token
        replay); a snapshot resume wastes none."""
        with self._lock:
            self._preempt["resumes"] += 1.0
            self._preempt["recompute_tokens"] += float(recompute_tokens)
            key = ("snapshot_resumes" if mode == "snapshot"
                   else "reprefill_resumes")
            self._preempt[key] += 1.0

    def overcommit_split(self) -> dict[str, float]:
        """Preemption counters + timings for the Table I "overcommit" row.

        ``preemption_rate`` is preemptions per recorded launch
        (``dispatch_wait`` samples — only populated when serving routes
        through an HSA queue).  ``launches`` is exposed alongside so a rate
        of 0.0 from an unwired ledger is distinguishable from a genuinely
        preemption-free run; consumers wanting the raw count read
        ``preemptions``.  ``snapshot_bytes`` is *net* of demotions: a
        snapshot demoted to replay gives its bytes back (see
        :meth:`record_demotion`), so a demote-then-re-park cycle does not
        double-count."""
        with self._lock:
            out = dict(self._preempt)
            out["park_s"] = self._stats[PREEMPT_PARK].total_s
            out["resume_s"] = self._stats[PREEMPT_RESUME].total_s
            launches = self._stats[DISPATCH_WAIT].count
        out["launches"] = float(launches)
        out["preemption_rate"] = (
            out["preemptions"] / launches if launches else 0.0
        )
        return out

    # -- tiered-pool accounting (host arena spill/refill) --------------------

    def record_spill(self, *, nbytes: int) -> None:
        """One snapshot spilled D2H into the host arena (DMA seconds ride
        the SPILL category via ``record``)."""
        with self._lock:
            self._spill["spills"] += 1.0
            self._spill["spill_bytes"] += float(nbytes)

    def record_refill(self, *, nbytes: int) -> None:
        """One snapshot refilled H2D out of the arena (duration and its
        exposed/hidden split ride REFILL / REFILL_EXPOSED / REFILL_HIDDEN)."""
        with self._lock:
            self._spill["refills"] += 1.0
            self._spill["refill_bytes"] += float(nbytes)

    def record_demotion(self, *, bytes_freed: int,
                        replay_tokens: int) -> None:
        """One parked snapshot demoted to re-prefill replay: its arena bytes
        went back to the budget and ``replay_tokens`` of recompute were
        accepted in exchange.  The freed bytes also come *off* the
        overcommit ``snapshot_bytes`` counter — a demoted snapshot no longer
        holds host memory, and a later re-park of the same request must not
        count its bytes twice."""
        with self._lock:
            self._spill["demotions"] += 1.0
            self._spill["demoted_bytes"] += float(bytes_freed)
            self._spill["replay_fallback_tokens"] += float(replay_tokens)
            self._preempt["snapshot_bytes"] = max(
                0.0, self._preempt["snapshot_bytes"] - float(bytes_freed)
            )

    def spill_split(self) -> dict[str, float]:
        """Tiered-pool counters + timings (the table11 view).

        Byte flows (spill/refill/demoted), host occupancy vs budget, the
        replay tokens demotions cost, and the refill time split into exposed
        (a resume stalled on the DMA) vs hidden (the lookahead pump issued
        it early enough to overlap decode).  ``refill_hidden_frac`` is
        hidden / (hidden + exposed), 0.0 when no refills ran."""
        with self._lock:
            out = dict(self._spill)
            out["spill_s"] = self._stats[SPILL].total_s
            out["refill_s"] = self._stats[REFILL].total_s
            out["refill_exposed_s"] = self._stats[REFILL_EXPOSED].total_s
            out["refill_hidden_s"] = self._stats[REFILL_HIDDEN].total_s
            out["transfer_faults"] = self._fault["transfer_faults"]
        split = out["refill_exposed_s"] + out["refill_hidden_s"]
        out["refill_hidden_frac"] = (
            out["refill_hidden_s"] / split if split else 0.0
        )
        return out

    # -- availability accounting (fault injection + self-healing) ------------

    def record_fault(self, *, kind: str, permanent: bool = False) -> None:
        """One failed attempt.  ``kind`` is ``"exec"``, ``"load"``,
        ``"wedge"``, or a tier-transfer kind ``"d2h"`` / ``"h2d"`` (a wedge
        is counted as an exec-class fault too — it is a launch that never
        completed).  ``permanent`` marks faults the retry policy is
        forbidden to absorb."""
        if kind not in ("exec", "load", "wedge", "d2h", "h2d"):
            raise ValueError(f"unknown fault kind {kind!r}")
        with self._lock:
            self._fault["faults"] += 1.0
            if kind == "load":
                self._fault["load_faults"] += 1.0
            elif kind in ("d2h", "h2d"):
                self._fault["transfer_faults"] += 1.0
            else:
                self._fault["exec_faults"] += 1.0
                if kind == "wedge":
                    self._fault["wedges"] += 1.0
            if permanent:
                self._fault["permanent_faults"] += 1.0

    def record_retry(self) -> None:
        """One retry attempt issued after a fault (backoff seconds ride the
        RETRY category via ``record``)."""
        with self._lock:
            self._fault["retries"] += 1.0

    def record_quarantine(self, *, migrated: int) -> None:
        """One queue quarantined; ``migrated`` pending packets moved to
        sibling queues."""
        with self._lock:
            self._fault["quarantines"] += 1.0
            self._fault["migrated_packets"] += float(migrated)

    def record_recovery(self, *, mttr_s: float = 0.0,
                        recompute_tokens: int = 0,
                        failed: bool = False) -> None:
        """One request-level recovery outcome.  A successful recovery samples
        ``mttr_s`` (engine clock, fault-park -> resumed) and the re-prefill
        replay's wasted ``recompute_tokens``; ``failed=True`` counts a
        request whose recovery budget ran out instead."""
        with self._lock:
            if failed:
                self._fault["failed_requests"] += 1.0
            else:
                self._fault["recoveries"] += 1.0
                self._fault["mttr_total_s"] += float(mttr_s)
                self._fault["recovery_recompute_tokens"] += float(
                    recompute_tokens)

    def availability_split(self) -> dict[str, float]:
        """Fault/retry/recovery counters + timings (the table10 view).

        ``fault_rate`` is faults per attempt, where attempts = successful
        execs + faulted attempts (so a fault-free ledger reads 0.0 and a
        ledger that never executed reads 0.0 with ``attempts`` = 0 —
        distinguishable).  ``mttr_s`` is the mean engine-clock time from a
        request's fault-park to its resume."""
        with self._lock:
            out = dict(self._fault)
            out["fault_s"] = self._stats[FAULT].total_s
            out["retry_backoff_s"] = self._stats[RETRY].total_s
            out["recover_s"] = self._stats[RECOVER].total_s
            execs = self._stats[EXEC].count
        out["attempts"] = float(execs) + out["faults"]
        out["fault_rate"] = (
            out["faults"] / out["attempts"] if out["attempts"] else 0.0
        )
        out["mttr_s"] = (
            out["mttr_total_s"] / out["recoveries"] if out["recoveries"]
            else 0.0
        )
        return out

    # -- integrity accounting (silent-corruption detection) ------------------

    def record_corruption(self, *, kind: str) -> None:
        """One silent corruption injected (or observed).  ``kind`` is
        ``"flip_page"`` | ``"flip_block"`` | ``"corrupt_transfer"`` |
        ``"stale_region"`` — the four state tiers."""
        key = self._CORRUPTION_KEY.get(kind)
        if key is None:
            raise ValueError(f"unknown corruption kind {kind!r}")
        with self._lock:
            self._integrity["corruptions"] += 1.0
            self._integrity[key] += 1.0

    def record_integrity_detection(self, *, via: str,
                                   recovered: bool = False) -> None:
        """One corruption caught by verification.  ``via`` names the
        detection site: ``"scrub"`` (background audit), ``"read"``
        (pre-commit page verification after a decode launch),
        ``"transfer"`` (DMA payload digest), ``"region"`` (region-image
        digest).  ``recovered=True`` additionally counts the park/demote
        that healed it."""
        if via not in ("scrub", "read", "transfer", "region"):
            raise ValueError(f"unknown detection site {via!r}")
        with self._lock:
            self._integrity["detected"] += 1.0
            self._integrity[f"detected_{via}"] += 1.0
            if recovered:
                self._integrity["integrity_recoveries"] += 1.0

    def record_scrub(self, *, pages: int = 0, blocks: int = 0,
                     targets: int = 0) -> None:
        """One scrub pass: ``pages`` device pages and ``blocks`` arena
        blocks re-hashed out of ``targets`` total auditable targets (the
        coverage denominator; audit seconds ride the SCRUB category)."""
        with self._lock:
            self._integrity["scrubbed_pages"] += float(pages)
            self._integrity["scrubbed_blocks"] += float(blocks)
            self._integrity["scrub_targets"] += float(targets)

    def record_page_quarantine(self) -> None:
        """One device page retired from circulation after a digest
        mismatch (the pool shrinks by one page)."""
        with self._lock:
            self._integrity["quarantined_pages"] += 1.0

    def record_verified_transfer(self) -> None:
        """One DMA payload digest-checked (clean or not)."""
        with self._lock:
            self._integrity["verified_transfers"] += 1.0

    def record_verified_region(self) -> None:
        """One region image digest-checked after a load (clean or not)."""
        with self._lock:
            self._integrity["verified_regions"] += 1.0

    def record_escape(self) -> None:
        """One corruption whose bytes influenced a sampled token before
        any verification caught it — the number every integrity
        configuration worth shipping holds at zero."""
        with self._lock:
            self._integrity["escaped"] += 1.0

    def integrity_split(self) -> dict[str, float]:
        """Silent-corruption counters + audit timing (the table12 view).

        ``detection_rate`` is detected / injected (0.0 on a corruption-free
        ledger, not a ZeroDivisionError — latent corruption whose page was
        freed before any read keeps it below 1.0 without an escape).
        ``scrub_coverage`` is targets re-hashed per pass averaged over
        passes, 0.0 when nothing was auditable.  ``audit_s`` is SCRUB time;
        callers grade it against their own step-time denominator."""
        with self._lock:
            out = dict(self._integrity)
            out["audit_s"] = self._stats[SCRUB].total_s
            out["scrub_passes"] = float(self._stats[SCRUB].count)
        scanned = out["scrubbed_pages"] + out["scrubbed_blocks"]
        out["scrub_coverage"] = (
            scanned / out["scrub_targets"] if out["scrub_targets"] else 0.0
        )
        out["detection_rate"] = (
            out["detected"] / out["corruptions"] if out["corruptions"]
            else 0.0
        )
        return out

    # -- prefix-sharing accounting (the KV hit-rate view) --------------------

    def record_prefix_lookup(self, *, hit: bool, pages_saved: int = 0) -> None:
        """One admission-time prefix probe.  ``hit=True`` means the request
        attached to at least ``PrefixPolicy.min_prefix_pages`` resident
        pages; ``pages_saved`` is the private prompt-page allocations (and
        their prefill rows) the attach avoided."""
        with self._lock:
            self._prefix["prefix_lookups"] += 1.0
            if hit:
                self._prefix["prefix_hits"] += 1.0
                self._prefix["pages_saved"] += float(pages_saved)

    def record_prefix_sharing(self, *, shared_pages: int) -> None:
        """Gauge update: pages currently held by more than one reader."""
        with self._lock:
            self._prefix["shared_pages"] = float(shared_pages)
            self._prefix["peak_shared_pages"] = max(
                self._prefix["peak_shared_pages"], float(shared_pages)
            )

    def record_prefix_cow(self, n: int = 1) -> None:
        """``n`` copy-on-write re-prefills: readers that lost their shared
        pages (quarantine of the page, or a parked snapshot whose prefix
        evaporated before resume) and rebuilt them privately."""
        with self._lock:
            self._prefix["cow_copies"] += float(n)

    def prefix_split(self) -> dict[str, float]:
        """Prefix-sharing counters (the table13 view).  ``hit_rate`` is
        hits / lookups — the KV analogue of Table II's
        ``if_not_configured`` fraction — 0.0 on an empty ledger."""
        with self._lock:
            out = dict(self._prefix)
        out["hit_rate"] = (
            out["prefix_hits"] / out["prefix_lookups"]
            if out["prefix_lookups"] else 0.0
        )
        return out

    def reconfig_split(self) -> dict[str, float]:
        """Exposed vs hidden reconfiguration time (scheduler-clock seconds).

        ``measured_s`` is the RegionManager's real load total; ``exposed_s``
        is schedule time during which a queue sat stalled on the load;
        ``hidden_s`` ran on the reconfiguration engine behind compute."""
        with self._lock:
            exposed = self._stats[RECONFIG_EXPOSED]
            hidden = self._stats[RECONFIG_HIDDEN]
            measured = self._stats[RECONFIG]
            return {
                "measured_s": measured.total_s,
                "exposed_s": exposed.total_s,
                "hidden_s": hidden.total_s,
                "exposed_n": float(exposed.count),
                "hidden_n": float(hidden.count),
            }

    def traffic_split(self) -> dict[str, float]:
        """Serving-latency quantiles under live traffic (table9's SLO view).

        For each of TTFT and TPOT: sample count, mean, and the p50/p99 of
        the recent quantile window.  Quantiles are 0.0 when no samples
        exist — callers grading SLOs should check ``*_n`` first so an
        unwired ledger is distinguishable from a perfectly fast one.
        """
        out: dict[str, float] = {}
        for cat in (TTFT, TPOT):
            s = self.stat(cat)
            out[f"{cat}_n"] = float(s.count)
            out[f"{cat}_mean_s"] = s.total_s / s.count if s.count else 0.0
            for q, name in ((0.5, "p50"), (0.99, "p99")):
                v = self.quantile(cat, q)
                out[f"{cat}_{name}_s"] = v if v is not None else 0.0
        return out

    def dispatch_split(self) -> dict[str, float]:
        """Invocation-overhead round trip, split per leg (Table II row 3).

        Totals and counts for dispatch_submit / dispatch_grant /
        dispatch_wait, plus ``per_packet_us`` (sum of the three legs divided
        by the submit count — the per-packet invocation cost fused decode and
        burst submission amortize)."""
        with self._lock:
            sub = self._stats[DISPATCH_SUBMIT]
            grant = self._stats[DISPATCH_GRANT]
            wait = self._stats[DISPATCH_WAIT]
            total = sub.total_s + grant.total_s + wait.total_s
            n = max(sub.count, grant.count, wait.count)
            return {
                "submit_s": sub.total_s,
                "grant_s": grant.total_s,
                "wait_s": wait.total_s,
                "submit_n": float(sub.count),
                "grant_n": float(grant.count),
                "wait_n": float(wait.count),
                "total_s": total,
                "per_packet_us": (total / n) * 1e6 if n else 0.0,
            }

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                c: {
                    "count": float(s.count),
                    "mean_us": s.mean_us,
                    "total_us": s.total_s * 1e6,
                }
                for c, s in self._stats.items()
            }

    def table(self) -> str:
        """Paper Table II layout: operation | occurrence | mean microseconds."""
        rows = [("Operation", "Occurrence", "Mean [us]", "n")]
        split_rows = (RECONFIG_EXPOSED, RECONFIG_HIDDEN,
                      DISPATCH_SUBMIT, DISPATCH_GRANT, DISPATCH_WAIT)
        for cat in (SETUP, RECONFIG, RECONFIG_EXPOSED, RECONFIG_HIDDEN,
                    DISPATCH, DISPATCH_SUBMIT, DISPATCH_GRANT, DISPATCH_WAIT):
            s = self.stat(cat)
            label = {
                SETUP: "device/kernel setup",
                RECONFIG: "reconfiguration",
                RECONFIG_EXPOSED: "  - exposed (queue stalled)",
                RECONFIG_HIDDEN: "  - hidden (prefetched)",
                DISPATCH: "dispatch latency",
                DISPATCH_SUBMIT: "  - submit (packet + doorbell)",
                DISPATCH_GRANT: "  - grant (scheduler launch)",
                DISPATCH_WAIT: "  - wait (completion signal)",
            }[cat]
            if cat in split_rows and s.count == 0:
                continue                   # keep the paper's 3-row layout unless split
            rows.append((label, OCCURRENCE[cat], f"{s.mean_us:.1f}", str(s.count)))
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        return "\n".join(lines)


GLOBAL_LEDGER = OverheadLedger(keep_entries=False)
