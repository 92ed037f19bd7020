"""Policies of ``repro/core/policy.py`` that the port's slices read, copied
as they are (pure dataclasses and functions).

- :class:`AdmissionPolicy`: the paged engine admits a request against free
  pages minus the projected growth of the requests already running.
- :class:`FusionPolicy`: the serving engine's decode fusion depth K a launch,
  from foreign queue depth, the remaining request length and, in feedback
  mode, the observed foreign ``dispatch_wait``.
- :class:`ChunkPolicy`: the serving engine's prefill chunk a request, fixed
  at its prefill's start, tapered by the live decode slots and the last
  launch's fusion depth.
- :class:`PreemptionPolicy` (with :class:`PreemptionCandidate` and the
  resume modes :data:`RESUME_REPREFILL`, :data:`RESUME_SNAPSHOT`): which
  running requests an overcommitted paged engine parks when its pool runs
  dry, and whether each comes back by re-prefill and replay or by restoring
  a host snapshot of its pages.
- :class:`SpillPolicy` (with :class:`SpillCandidate`): which parked
  snapshots lose their host copy when the host arena passes its budget, and
  how many refills are issued ahead of need.
- :class:`PrefetchPolicy` and :class:`RetryPolicy`: the HSA scheduler's
  lookahead depth and fault recovery (and the serving engine's recovery
  budget a request).
- :class:`IntegrityPolicy`: which boundaries the serving engine and the
  transfer engine verify content digests at, and the scrubber's budget.
- :class:`PrefixPolicy`: when a new request attaches to prompt pages
  already resident in the paged pool.
- The role planner (:class:`Invocation`, :class:`CostModel`,
  :func:`simulate_lru`, :func:`plan_roles`): the paper's generic-vs-fixed-
  weight trade-off (§IV).  A generic role (weights as operands) is shared by
  every layer that invokes the op, so it stays resident; fixing weights
  yields one role per layer — each faster, but with more roles than regions
  the LRU thrashes and every layer pays a reconfiguration.  The planner
  simulates LRU residency for each assignment of {generic, fixed_weight} per
  op type and picks the lowest predicted steady-state step time.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from collections import OrderedDict
from typing import Hashable, Sequence

from repro_torch.core.registry import FIXED_WEIGHT, GENERIC


@dataclasses.dataclass(frozen=True)
class PrefetchPolicy:
    """Lookahead-depth knob for the reconfiguration-prefetch pipeline.

    ``lookahead`` is how many queued packets (per queue, from the head) the
    scheduler scans for roles to load ahead of demand — the software ICAP
    pipeline depth.  0 recovers the purely reactive scheduler.  The same
    knob parameterizes :func:`simulate_lru`, so the role planner can predict
    *exposed* (queue-stalling) rather than total reconfiguration cost when a
    prefetching scheduler will run the plan.
    """

    lookahead: int = 0

    def __post_init__(self) -> None:
        if self.lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {self.lookahead}")

    @classmethod
    def of(cls, value: "PrefetchPolicy | int | None") -> "PrefetchPolicy":
        if value is None:
            return cls(0)
        if isinstance(value, PrefetchPolicy):
            return value
        return cls(int(value))


@dataclasses.dataclass(frozen=True)
class FusionPolicy:
    """Pick the decode fusion depth K for a serving engine.

    One fused launch generates up to K tokens per slot in a single packet
    round trip, amortizing the per-packet invocation overhead (Table II row
    3) K-fold.  The trade-offs the policy balances:

      - **mean request length** caps useful depth: scanning past every live
        slot's remaining budget burns masked (wasted) decode steps;
      - **queue depth** (packets other tenants have pending on the shared
        device) argues for *smaller* K: one fused launch occupies the compute
        engine for K tokens, so deep foreign backlogs halve K per
        ``fairness_depth`` pending packets — the batch-vs-latency knob the
        toolflow surveys frame as launch amortization vs responsiveness.

    **Feedback mode** (``feedback=True``) closes the loop the launch-time
    queue depth only approximates: instead of guessing how much a deep
    backlog *will* hurt the other tenants, it reads how much serving
    already *is* hurting them — the ledger's observed p99 foreign
    ``dispatch_wait`` (the producer-blocked leg of their packet round
    trips).  K halves once per doubling of the observed p99 over
    ``target_wait_s``, so a foreign tenant whose waits blow past the target
    pulls fusion down even when its queue happens to be shallow at launch
    time, and an idle ledger lets K ride at the amortization optimum.

    The result is rounded down to a power of two, as the JAX engine's, whose
    jitted fused-decode trace cache it keeps small (a distinct K is a
    distinct trace); the port replays one captured decode step K times, so
    there any K costs the same.
    """

    max_fusion: int = 8
    min_fusion: int = 1
    fairness_depth: int = 8
    feedback: bool = False
    target_wait_s: float = 1e-3          # foreign p99 dispatch_wait budget

    def __post_init__(self) -> None:
        if self.min_fusion < 1:
            raise ValueError(f"min_fusion must be >= 1, got {self.min_fusion}")
        if self.max_fusion < self.min_fusion:
            raise ValueError(
                f"max_fusion {self.max_fusion} < min_fusion {self.min_fusion}"
            )
        if self.fairness_depth < 0:
            raise ValueError(f"fairness_depth must be >= 0, got {self.fairness_depth}")
        if self.target_wait_s <= 0:
            raise ValueError(f"target_wait_s must be > 0, got {self.target_wait_s}")

    @classmethod
    def of(cls, value: "FusionPolicy | int | None") -> "FusionPolicy":
        if value is None:
            return cls(1, 1)
        if isinstance(value, FusionPolicy):
            return value
        k = int(value)
        return cls(max_fusion=max(1, k), min_fusion=max(1, k))

    def choose_k(self, *, queue_depth: int = 0,
                 mean_request_len: float = 0.0,
                 observed_wait_s: float | None = None) -> int:
        k = self.max_fusion
        if mean_request_len > 0:
            k = min(k, max(self.min_fusion, int(mean_request_len)))
        if self.feedback and observed_wait_s is not None:
            # measured-contention feedback: halve K per doubling of the
            # observed foreign p99 wait over target.  Takes precedence over
            # the queue-depth guess when a measurement exists.
            over = observed_wait_s / self.target_wait_s
            while over > 1.0 and k > 1:
                k >>= 1
                over /= 2.0
        elif self.fairness_depth > 0 and queue_depth > 0:
            # halve once per fairness_depth foreign packets pending (capped so
            # the shift below stays defined for absurd backlogs)
            k >>= min(queue_depth // self.fairness_depth, k.bit_length())
        k = max(self.min_fusion, min(k, self.max_fusion))
        p = 1
        while p * 2 <= k:
            p *= 2
        return max(self.min_fusion, p)     # the floor wins over pow2 rounding


@dataclasses.dataclass(frozen=True)
class ChunkPolicy:
    """Pick the prefill chunk size for continuous batching.

    Whole-prompt prefill makes one monolithic launch per admission: a long
    prompt monopolizes the compute engine for its full length, so every
    other request's first token (and every in-flight request's next token)
    waits behind it — the paper's "simultaneously from other sources" fails
    exactly at admission time.  Chunked prefill splits the prompt into
    ``chunk``-token pieces that interleave with the fused decode launches,
    bounding how long any single prefill piece can occupy the device.

    The trade-off mirrors :class:`FusionPolicy` from the other side: decode
    fusion makes decode launches *longer* to amortize packet overhead, while
    prefill chunking makes prefill launches *shorter* to bound latency — and
    the two meet in the step loop, where one step carries one chunk per
    prefilling slot plus one fused decode.  ``decode_taper`` shrinks the
    chunk as live decode slots pile up (their TPOT is what a fat chunk
    stretches); ``fusion_taper`` shrinks it under deep decode fusion (the
    step is already long, so the prefill share must not double it).

    Chunk sizes are powers of two for the same reason fusion depths are:
    every distinct (chunk, start) pair is a distinct jitted trace, and pow2
    chunks over pow2-bucketed prompts keep the trace count at
    ``log2(max_len)``-ish instead of per-prompt-length.
    """

    max_chunk: int = 64
    min_chunk: int = 16
    decode_taper: int = 0        # halve chunk per this many live decode slots
    fusion_taper: int = 0        # halve chunk per this many fused decode steps

    def __post_init__(self) -> None:
        for name in ("max_chunk", "min_chunk"):
            v = getattr(self, name)
            if v < 1 or (v & (v - 1)):
                raise ValueError(f"{name} must be a power of two >= 1, got {v}")
        if self.max_chunk < self.min_chunk:
            raise ValueError(
                f"max_chunk {self.max_chunk} < min_chunk {self.min_chunk}"
            )
        if self.decode_taper < 0 or self.fusion_taper < 0:
            raise ValueError("tapers must be >= 0")

    @classmethod
    def of(cls, value: "ChunkPolicy | int | None") -> "ChunkPolicy | None":
        if value is None or isinstance(value, ChunkPolicy):
            return value
        c = int(value)
        return cls(max_chunk=c, min_chunk=c)

    def choose_chunk(self, *, live_decode: int = 0, fusion_k: int = 1) -> int:
        """Chunk size for one request, fixed at its prefill start (a chunk
        that changed mid-prefill would fragment the trace cache for no
        latency gain — the knob reacts at admission granularity)."""
        c = self.max_chunk
        if self.decode_taper > 0 and live_decode > 0:
            c >>= min(live_decode // self.decode_taper, c.bit_length() - 1)
        if self.fusion_taper > 0 and fusion_k > 1:
            c >>= min(fusion_k // self.fusion_taper, c.bit_length() - 1)
        return max(self.min_chunk, c)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Admit a request into the paged serving engine?

    Admission reasons over **free pages minus the projected growth of the
    requests already running**: each active request will still map up to
    (projection − already-mapped) pages before it finishes, and those future
    claims must stay funded or on-demand growth starts failing mid-decode.

    ``growth_reserve`` scales the projection of a request's decode budget:
    1.0 (default) projects the worst case (``prompt + max_new_tokens``),
    which makes :class:`~repro_torch.serve.paged.PagePoolExhausted`
    unreachable; < 1.0 overcommits, which only preemption makes safe.
    ``watermark_pages`` holds back a safety floor for in-flight growth.
    """

    growth_reserve: float = 1.0
    watermark_pages: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.growth_reserve <= 1.0:
            raise ValueError(
                f"growth_reserve must be in [0, 1], got {self.growth_reserve}"
            )
        if self.watermark_pages < 0:
            raise ValueError(
                f"watermark_pages must be >= 0, got {self.watermark_pages}"
            )

    def projected_pages(self, prompt_len: int, max_new_tokens: int,
                        page_size: int) -> int:
        """Pages this request is projected to map over its life.

        Counts *written* rows: generating ``g`` tokens writes ``prompt + g
        - 1`` KV rows (the final sampled token is never fed back), so at
        ``growth_reserve=1.0`` the projection equals :meth:`worst_case_pages`
        exactly."""
        projected = prompt_len + max(
            1, int(math.ceil(self.growth_reserve * max_new_tokens))
        ) - 1
        return -(-max(1, projected) // page_size)

    def worst_case_pages(self, prompt_len: int, max_new_tokens: int,
                         page_size: int) -> int:
        """Pages the request maps if it runs its *full* budget — the
        ``growth_reserve``-independent figure that permanent rejection
        tests.  Exact: the cache tops out at ``prompt + max_new - 1`` rows."""
        return -(-(prompt_len + max(1, max_new_tokens) - 1) // page_size)

    @property
    def overcommitted(self) -> bool:
        """True when admission funds less than the full decode budget —
        the regime where mid-flight exhaustion (hence preemption) is live."""
        return self.growth_reserve < 1.0

    def admit(self, *, free_pages: int, projected_growth_pages: int,
              request_pages: int) -> bool:
        """``free_pages`` from the allocator, ``projected_growth_pages`` the
        summed unmapped remainder of already-admitted requests."""
        available = free_pages - projected_growth_pages - self.watermark_pages
        return request_pages <= available


#: resume modes a preempted request can come back through
RESUME_REPREFILL = "reprefill"    # recompute prompt + replay generated tokens
RESUME_SNAPSHOT = "snapshot"      # restore the host-side KV page snapshot


@dataclasses.dataclass(frozen=True)
class PreemptionCandidate:
    """What the :class:`PreemptionPolicy` sees of one active request.

    ``mapped_pages`` is what parking it returns to the pool; ``tokens_done``
    (prompt + generated rows in its cache) is what a re-prefill resume has to
    recompute — the wasted work the victim order tries to minimize."""

    uid: int
    mapped_pages: int
    tokens_done: int


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """Who gets parked when the page pool runs dry, and how they come back.

    The paper's fabric is shared "simultaneously from other sources": a
    region a tenant holds can be demanded back at runtime.  For overcommitted
    paged serving that means a mid-decode request's KV pages are reclaimable
    — the engine parks **victims** (pages back to the pool, generated-so-far
    tokens kept) instead of letting :class:`~repro_torch.serve.paged.PagePoolExhausted`
    escape, and resumes them when pages free up.

    ``order`` ranks victims:

      - ``"youngest"`` (default) — latest-admitted first.  The oldest request
        is never preempted while a younger one holds pages, so the head of
        the line always drains and admission order stays livelock-free.
      - ``"oldest"`` — earliest-admitted first (drain-and-restart flavor).
      - ``"most_pages"`` — largest page holding first (fewest victims per
        reclaim, at the cost of evicting the most expensive cache to rebuild).

    Resume picks the cheaper of two paths per victim, by cost at park time:

      - **re-prefill** (always available): recompute the prompt and replay
        the generated tokens through the normal decode path — costs
        ``tokens_done`` of recompute, holds no host memory;
      - **snapshot** (``allow_snapshot``): copy the victim's live KV pages to
        host at park and scatter them back at resume — zero recompute, costs
        two page-pool copies plus host bytes while parked.

    ``snapshot_threshold_tokens`` is the crossover: a victim with at least
    this many cached rows snapshots (recompute grows linearly with rows;
    the copy is bandwidth-priced), a shorter one re-prefills.
    """

    order: str = "youngest"
    allow_snapshot: bool = True
    snapshot_threshold_tokens: int = 24

    _ORDERS = ("youngest", "oldest", "most_pages")

    def __post_init__(self) -> None:
        if self.order not in self._ORDERS:
            raise ValueError(
                f"order must be one of {self._ORDERS}, got {self.order!r}"
            )
        if self.snapshot_threshold_tokens < 0:
            raise ValueError(
                "snapshot_threshold_tokens must be >= 0, got "
                f"{self.snapshot_threshold_tokens}"
            )

    def victims(self, candidates: Sequence[PreemptionCandidate],
                pages_needed: int) -> list[int]:
        """Uids to park, in order, until ``pages_needed`` pages are covered.

        Returns the shortest prefix of the ranked candidates whose summed
        ``mapped_pages`` reaches ``pages_needed`` — or every candidate when
        even that falls short (the engine then re-plans with what it got)."""
        if pages_needed <= 0:
            return []
        if self.order == "youngest":
            ranked = sorted(candidates, key=lambda c: -c.uid)
        elif self.order == "oldest":
            ranked = sorted(candidates, key=lambda c: c.uid)
        else:                                   # most_pages; uid tiebreak
            ranked = sorted(candidates, key=lambda c: (-c.mapped_pages, c.uid))
        out: list[int] = []
        covered = 0
        for c in ranked:
            if covered >= pages_needed:
                break
            out.append(c.uid)
            covered += c.mapped_pages
        return out

    def resume_mode(self, *, tokens_done: int) -> str:
        """``RESUME_SNAPSHOT`` or ``RESUME_REPREFILL`` for a victim with
        ``tokens_done`` cached rows at park time."""
        if self.allow_snapshot and tokens_done >= self.snapshot_threshold_tokens:
            return RESUME_SNAPSHOT
        return RESUME_REPREFILL


@dataclasses.dataclass(frozen=True)
class SpillCandidate:
    """What the :class:`SpillPolicy` sees of one parked snapshot.

    ``arena_bytes`` is what demoting it returns to the host budget;
    ``tokens_done`` is what the demotion costs later — the re-prefill
    replay a snapshot resume would have avoided."""

    uid: int
    arena_bytes: int
    tokens_done: int


@dataclasses.dataclass(frozen=True)
class SpillPolicy:
    """Who loses their host snapshot when the arena passes its byte budget,
    and how far ahead of need refills are issued.

    The device tier already degrades gracefully (pool pressure parks
    victims, :class:`PreemptionPolicy`); this policy is the same discipline
    one tier down.  When a new snapshot does not fit the
    ``host_budget_bytes`` arena, parked snapshots are **demoted** to
    re-prefill replay — their arena bytes are dropped and the request keeps
    only its committed token prefix, which the replay path regenerates
    bitwise-identically.  Work is rejected only when replay is disabled
    (``allow_replay=False``), in which case the over-budget store raises
    :class:`~repro_torch.serve.paged.HostArenaExhausted`.

    ``order`` ranks demotion victims:

      - ``"cheapest_replay"`` (default) — fewest ``tokens_done`` first: the
        resume-cost crossover.  A snapshot's whole value is the recompute it
        avoids, which grows linearly with cached rows, so the snapshot
        worth the least is the first to give its bytes back.
      - ``"largest"`` — most ``arena_bytes`` first (fewest victims per
        reclaim, at the cost of demoting the most valuable snapshot).
      - ``"oldest"`` — earliest-parked first (store-order eviction, the
        arena's native ``eviction_order``).

    ``refill_lookahead`` is the ahead-of-need depth: how many parked
    snapshots from the resume head get their H2D refill issued on the
    transfer engine *before* the resume step would stall on it — a parked
    request scheduled for resume is a "role named in a lookahead window",
    and this is its prefetch.  0 disables (refill on demand, fully
    exposed).
    """

    order: str = "cheapest_replay"
    refill_lookahead: int = 4
    allow_replay: bool = True

    _ORDERS = ("cheapest_replay", "largest", "oldest")

    def __post_init__(self) -> None:
        if self.order not in self._ORDERS:
            raise ValueError(
                f"order must be one of {self._ORDERS}, got {self.order!r}"
            )
        if self.refill_lookahead < 0:
            raise ValueError(
                f"refill_lookahead must be >= 0, got {self.refill_lookahead}"
            )

    @classmethod
    def of(cls, value: "SpillPolicy | None") -> "SpillPolicy":
        """``None`` means the defaults (demote cheapest replay, lookahead 4)."""
        return value if isinstance(value, SpillPolicy) else cls()

    def victims(self, candidates: Sequence[SpillCandidate],
                bytes_needed: int) -> list[int]:
        """Uids to demote, in order, until ``bytes_needed`` is covered.

        Returns the shortest prefix of the ranked candidates whose summed
        ``arena_bytes`` reaches ``bytes_needed`` — or every candidate when
        even that falls short (the caller then demotes the incoming
        snapshot itself)."""
        if bytes_needed <= 0:
            return []
        if self.order == "cheapest_replay":
            ranked = sorted(candidates, key=lambda c: (c.tokens_done, c.uid))
        elif self.order == "largest":
            ranked = sorted(candidates, key=lambda c: (-c.arena_bytes, c.uid))
        else:                                   # oldest; uid is park order
            ranked = sorted(candidates, key=lambda c: c.uid)
        out: list[int] = []
        covered = 0
        for c in ranked:
            if covered >= bytes_needed:
                break
            out.append(c.uid)
            covered += c.arena_bytes
        return out


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How the runtime absorbs faults before the user ever sees one.

    The paper's promise is a runtime that "hides the complexity of
    controlling new hardware" — and real accelerator hardware faults: kernel
    launches error, partial-bitstream loads abort, doorbells wedge.  This
    policy spans the three recovery layers:

      - **scheduler** — a faulted packet is retried in place (``requeue_head``,
        so queue order is preserved) up to ``max_retries`` times with
        exponential backoff (``backoff_s * backoff_factor**attempt``, capped
        at ``max_backoff_s``); a launch whose completion never fires is
        killed by a watchdog after :meth:`watchdog_deadline` of its expected
        duration; a queue that faults ``quarantine_after`` consecutive times
        is quarantined — its pending packets migrate to sibling queues;
      - **reconfig** — a failed region load retries through the
        ``abort_prefetch`` cleanup path instead of failing the head packet;
      - **engine** — a launch that exhausts its packet budget (or faults
        permanently) parks the affected requests via the preemption
        machinery and resumes them by re-prefill replay, at most
        ``max_request_recoveries`` times per request, keeping completed
        streams bitwise-identical to fault-free runs.
    """

    max_retries: int = 3
    backoff_s: float = 1e-3
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    watchdog_factor: float = 8.0
    watchdog_floor_s: float = 1e-3
    quarantine_after: int = 3            # K consecutive faults; 0 disables
    max_request_recoveries: int = 2      # engine-level park/replay budget

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}"
            )
        if self.max_backoff_s < self.backoff_s:
            raise ValueError(
                f"max_backoff_s {self.max_backoff_s} < backoff_s {self.backoff_s}"
            )
        if self.watchdog_factor < 1.0:
            raise ValueError(
                f"watchdog_factor must be >= 1, got {self.watchdog_factor}"
            )
        if self.watchdog_floor_s < 0:
            raise ValueError(
                f"watchdog_floor_s must be >= 0, got {self.watchdog_floor_s}"
            )
        if self.quarantine_after < 0:
            raise ValueError(
                f"quarantine_after must be >= 0, got {self.quarantine_after}"
            )
        if self.max_request_recoveries < 0:
            raise ValueError(
                "max_request_recoveries must be >= 0, got "
                f"{self.max_request_recoveries}"
            )

    @classmethod
    def of(cls, value: "RetryPolicy | int | None") -> "RetryPolicy | None":
        """``None`` keeps retries off (legacy fail-fast semantics); an int is
        a plain ``max_retries`` with the other knobs at their defaults."""
        if value is None or isinstance(value, RetryPolicy):
            return value
        return cls(max_retries=int(value))

    def backoff(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based: the delay
        between the first fault and the second try is ``backoff(1)``)."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        return min(
            self.max_backoff_s,
            self.backoff_s * self.backoff_factor ** (attempt - 1),
        )

    def watchdog_deadline(self, expected_s: float) -> float:
        """How long a launch may run before the watchdog declares it wedged.

        Derived from the caller's expected duration (the engine's
        ``step_time_model`` or a measured exec cost), floored so a
        nominally-instant launch still gets a real window."""
        return max(self.watchdog_floor_s, self.watchdog_factor * expected_s)


@dataclasses.dataclass(frozen=True)
class IntegrityPolicy:
    """When and how the serving path verifies the bytes it trusts.

    The fault layer covers *fail-stop* faults — a launch that errors
    or wedges.  This policy covers the quieter failure mode: state that is
    silently wrong.  Four tiers are verifiable — device KV pages (digest
    stamped at every write boundary), host-arena blocks (digest stamped at
    ``store()``), DMA payloads (digest carried on the transfer), and loaded
    region images.  Each knob gates one verification site:

    - ``verify_reads``: after every decode launch, re-hash the sealed pages
      the attention kernel just read and park any slot whose pages mismatch
      *before* its tokens commit.  This is the structural zero-escape
      guarantee — corruption is caught before it influences a sampled token.
    - ``verify_transfers``: check the payload digest on every H2D refill at
      ``wait()`` and every D2H spill at ``issue()`` (spills complete at
      issue; they are never waited).
    - ``verify_regions``: check the region-image digest after every
      reconfiguration load and again at ``complete_prefetch``, so a stale
      image is caught before any packet executes against it.
    - ``scrub_pages_per_step``: budgeted background audit — re-hash up to
      this many cold targets (sealed device pages + parked arena blocks,
      round-robin cursor) per engine step.  Scrubbing does not change what
      escapes (the read/transfer/region checks already bound that at zero);
      it bounds *detection latency*, so a corrupted parked snapshot is
      demoted before the engine wastes a refill on it.  0 disables.

    Passing ``integrity=None`` to the engine skips the whole layer — no
    digests, no hashing, bit-for-bit the pre-integrity hot path.
    """

    scrub_pages_per_step: int = 0
    verify_transfers: bool = True
    verify_regions: bool = True
    verify_reads: bool = True

    def __post_init__(self):
        if self.scrub_pages_per_step < 0:
            raise ValueError(
                f"scrub_pages_per_step must be >= 0, got {self.scrub_pages_per_step}")

    @classmethod
    def of(cls, value: "IntegrityPolicy | bool | None") -> "IntegrityPolicy | None":
        """Normalize an engine-constructor argument.

        ``None``/``False`` → disabled (``None``); ``True`` → all
        verification on with scrubbing off; an ``IntegrityPolicy`` passes
        through.
        """
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        raise TypeError(f"expected IntegrityPolicy, bool, or None, got {value!r}")


@dataclasses.dataclass(frozen=True)
class PrefixPolicy:
    """When a new request may attach to already-resident prompt pages.

    Prefix sharing is the Table II ``if_not_configured`` hit applied to KV
    state: a request whose prompt prefix is already paged in attaches to
    those pages at +1 refcount instead of re-prefilling them, and admission
    charges only the unshared remainder.  Two knobs bound the mechanism:

    - ``min_prefix_pages``: shortest shared prefix (in full pages) worth
      attaching.  Below this the bookkeeping (refcounts, CoW on the
      park/quarantine paths) outweighs the prefill saved.
    - ``max_refs``: cap on readers per physical page.  Bounds the blast
      radius of one quarantined page (every reader parks through the
      ``RESUME_REPREFILL`` lane) and keeps a single viral prefix from
      serializing the whole pool's fault recovery.
    """

    min_prefix_pages: int = 1
    max_refs: int = 64

    def __post_init__(self):
        if self.min_prefix_pages < 1:
            raise ValueError(
                f"min_prefix_pages must be >= 1, got {self.min_prefix_pages}")
        if self.max_refs < 2:
            raise ValueError(f"max_refs must be >= 2, got {self.max_refs}")

    @classmethod
    def of(cls, value: "PrefixPolicy | bool | None") -> "PrefixPolicy | None":
        """Normalize an engine-constructor argument: ``None``/``False`` →
        sharing off, ``True`` → defaults, a ``PrefixPolicy`` passes
        through."""
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        raise TypeError(f"expected PrefixPolicy, bool, or None, got {value!r}")


@dataclasses.dataclass(frozen=True)
class Invocation:
    """One op call site in a model step: (op type, site id e.g. layer index)."""

    op: str
    site: Hashable


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Measured per-category costs in seconds (from the overhead ledger)."""

    reconfig_s: float
    dispatch_s: float
    exec_generic_s: dict[str, float]       # op -> seconds
    exec_fixed_s: dict[str, float]         # op -> seconds (faster: weights baked)

    def exec_s(self, op: str, spec: str) -> float:
        table = self.exec_fixed_s if spec == FIXED_WEIGHT else self.exec_generic_s
        return table[op]


@dataclasses.dataclass
class SimResult:
    total_s: float
    hits: int
    misses: int
    distinct_roles: int
    exposed_s: float = 0.0      # reconfig time the compute timeline waited on
    hidden_s: float = 0.0       # reconfig time overlapped by lookahead prefetch

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


def role_sequence(
    trace: Sequence[Invocation], assignment: dict[str, str]
) -> list[Hashable]:
    """Map invocations to role identities under an assignment.

    Generic ops share one role per op type; fixed-weight ops get one role per
    call site.
    """
    seq: list[Hashable] = []
    for inv in trace:
        spec = assignment.get(inv.op, GENERIC)
        seq.append((inv.op, GENERIC) if spec == GENERIC else (inv.op, inv.site))
    return seq


def simulate_lru(
    roles: Sequence[Hashable],
    budget: int,
    cost: CostModel,
    spec_of: dict[Hashable, str],
    op_of: dict[Hashable, str],
    *,
    repeats: int = 2,
    lookahead: "PrefetchPolicy | int" = 0,
) -> SimResult:
    """Steady-state LRU simulation over ``repeats`` passes of the role sequence.

    The first pass is compulsory-miss dominated; reporting the *last* pass
    gives the steady-state step cost the planner optimizes.

    With ``lookahead`` L > 0 the simulation models the prefetching scheduler's
    two engines: a miss's load may start on the reconfiguration engine as soon
    as the access entered the L-deep lookahead window, so only the part of the
    load not overlapped by earlier compute is *exposed* on the compute
    timeline, and the LRU victim search skips roles needed within the next L
    accesses (the approximate Bélády oracle).  L = 0 reduces exactly to the
    serial reactive model.
    """
    depth = PrefetchPolicy.of(lookahead).lookahead
    resident: "OrderedDict[Hashable, None]" = OrderedDict()
    last = SimResult(0.0, 0, 0, len(set(roles)))
    for _ in range(max(1, repeats)):
        compute_t = reconfig_free = 0.0
        exposed = hidden = 0.0
        hits, misses = 0, 0
        starts: list[float] = []          # compute time when access i began
        for i, r in enumerate(roles):
            starts.append(compute_t)
            if r in resident:
                resident.move_to_end(r)
                hits += 1
            else:
                misses += 1
                if len(resident) >= budget:
                    upcoming = roles[i + 1 : i + 1 + depth] if depth else ()
                    window: dict[Hashable, int] = {}
                    for j, rr in enumerate(upcoming):
                        window.setdefault(rr, j)
                    victim = next((k for k in resident if k not in window), None)
                    if victim is None:
                        # every region demanded soon: evict the one needed
                        # furthest in the future (Bélády, as the scheduler does)
                        victim = max(resident, key=lambda k: window[k])
                    resident.pop(victim)
                visible_t = starts[max(0, i - depth)]
                load_start = max(reconfig_free, visible_t)
                ready = load_start + cost.reconfig_s
                exp = max(0.0, ready - compute_t)
                exposed += exp
                hidden += max(0.0, cost.reconfig_s - exp)
                compute_t = max(compute_t, ready)
                reconfig_free = ready
                resident[r] = None
            compute_t += cost.dispatch_s + cost.exec_s(op_of[r], spec_of[r])
        last = SimResult(compute_t, hits, misses, len(set(roles)), exposed, hidden)
    return last


@dataclasses.dataclass
class Plan:
    assignment: dict[str, str]             # op -> GENERIC | FIXED_WEIGHT
    predicted: SimResult
    alternatives: list[tuple[dict[str, str], float]] = dataclasses.field(
        default_factory=list
    )


def _evaluate(
    trace: Sequence[Invocation],
    assignment: dict[str, str],
    budget: int,
    cost: CostModel,
    repeats: int,
    lookahead: "PrefetchPolicy | int" = 0,
) -> SimResult:
    roles = role_sequence(trace, assignment)
    spec_of = {}
    op_of = {}
    for inv, r in zip(trace, roles):
        spec_of[r] = assignment.get(inv.op, GENERIC)
        op_of[r] = inv.op
    return simulate_lru(
        roles, budget, cost, spec_of, op_of, repeats=repeats, lookahead=lookahead
    )


def plan_roles(
    trace: Sequence[Invocation],
    budget: int,
    cost: CostModel,
    *,
    repeats: int = 2,
    exhaustive_limit: int = 12,
    lookahead: "PrefetchPolicy | int" = 0,
) -> Plan:
    """Choose generic vs fixed-weight per op type to minimize step latency.

    ``lookahead`` predicts the plan under a prefetching scheduler of that
    depth (exposed reconfiguration only) instead of the reactive one."""
    ops = sorted({inv.op for inv in trace})
    best: tuple[float, dict[str, str], SimResult] | None = None
    alts: list[tuple[dict[str, str], float]] = []

    if len(ops) <= exhaustive_limit:
        choices = itertools.product((GENERIC, FIXED_WEIGHT), repeat=len(ops))
        for combo in choices:
            assignment = dict(zip(ops, combo))
            sim = _evaluate(trace, assignment, budget, cost, repeats, lookahead)
            alts.append((assignment, sim.total_s))
            if best is None or sim.total_s < best[0]:
                best = (sim.total_s, assignment, sim)
    else:
        # Greedy: start all-generic, flip the op with the best marginal gain.
        assignment = {op: GENERIC for op in ops}
        sim = _evaluate(trace, assignment, budget, cost, repeats, lookahead)
        best = (sim.total_s, dict(assignment), sim)
        improved = True
        while improved:
            improved = False
            for op in ops:
                trial = dict(assignment)
                trial[op] = FIXED_WEIGHT if trial[op] == GENERIC else GENERIC
                s = _evaluate(trace, trial, budget, cost, repeats, lookahead)
                if s.total_s < best[0]:
                    best = (s.total_s, trial, s)
                    assignment = trial
                    improved = True

    assert best is not None
    alts.sort(key=lambda p: p[1])
    return Plan(assignment=best[1], predicted=best[2], alternatives=alts[:8])
