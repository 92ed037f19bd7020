"""User-mode queues with AQL-style packets.

HSA dispatch works by writing an Architected Queuing Language packet into a
user-mode ring buffer and ringing a doorbell signal.  The packet types the
paper's runtime needs are kernel-dispatch and barrier-AND (dependency
fences) — both modeled here.  A kernel-dispatch packet may additionally
carry its own dependency signals (AQL header barrier bit + implicit fence):
the scheduler will not launch it until every dep reads 0.

Multiple producers (the training engine, the serving engine, ad-hoc
OpenCL/OpenMP-style user code) may submit to the same queue, and one agent
may own many *soft queues* — the multi-tenancy substrate the async scheduler
(:mod:`repro_torch.core.hsa.scheduler`) round-robins across.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Sequence

from repro_torch.core import ledger as ledger_mod
from repro_torch.core.hsa.signal import Signal
from repro_torch.core.roles import RoleKey

_QUEUE_IDS = itertools.count()
_BURST_IDS = itertools.count(1)


class Box:
    """Mutable result slot for a dispatch packet."""

    __slots__ = ("value", "error")

    def __init__(self) -> None:
        self.value: Any = None
        self.error: BaseException | None = None


@dataclasses.dataclass
class KernelDispatchPacket:
    """AQL kernel dispatch.

    Either ``role_key`` (region-managed role, participates in reconfiguration)
    or ``fn`` (pinned-shell service: executed directly, e.g. the serving
    engine's decode step) must be set.
    """

    role_key: RoleKey | None = None
    args: tuple[Any, ...] = ()
    fn: Callable[..., Any] | None = None
    deps: tuple[Signal, ...] = ()       # AQL barrier-bit dependencies
    completion: Signal | None = None
    out: Box = dataclasses.field(default_factory=Box)
    producer: str = "tf"                # who enqueued: "tf" | "opencl" | "openmp" | ...
    enqueue_t: float | None = None      # stamped by Queue.submit when a clock is attached
    burst_id: int | None = None         # set by submit_burst: shared by the whole burst
    burst_n: int = 1                    # packets in that burst (1 = plain submit)

    def __post_init__(self) -> None:
        if (self.role_key is None) == (self.fn is None):
            raise ValueError("exactly one of role_key / fn required")

    @property
    def what(self) -> str:
        return str(self.role_key) if self.role_key is not None else getattr(
            self.fn, "__name__", "fn"
        )


@dataclasses.dataclass
class BarrierAndPacket:
    deps: tuple[Signal, ...]
    completion: Signal | None = None
    enqueue_t: float | None = None
    burst_id: int | None = None
    burst_n: int = 1


Packet = KernelDispatchPacket | BarrierAndPacket


class QueueFullError(RuntimeError):
    pass


def dispatch_packet(
    role_key: RoleKey, *args: Any, producer: str = "tf",
    deps: Sequence[Signal] = (),
) -> KernelDispatchPacket:
    """Build (don't submit) a region-managed dispatch packet — the unit a
    burst is assembled from before one :meth:`Queue.submit_burst`."""
    return KernelDispatchPacket(
        role_key=role_key, args=args, deps=tuple(deps),
        completion=Signal(1, name=f"done:{role_key}"), producer=producer,
    )


def call_packet(
    fn: Callable[..., Any], *args: Any, producer: str = "tf",
    deps: Sequence[Signal] = (),
) -> KernelDispatchPacket:
    """Build (don't submit) a pinned-shell dispatch packet."""
    return KernelDispatchPacket(
        fn=fn, args=args, deps=tuple(deps),
        completion=Signal(1, name=f"done:{getattr(fn, '__name__', 'fn')}"),
        producer=producer,
    )


class Queue:
    """Bounded ring buffer with a doorbell signal (single consumer).

    ``name`` identifies the queue in scheduler event logs and the per-queue
    ledger breakdown; ``weight`` is consumed by weighted scheduling policies
    (a weight-2 queue gets two grants per round).
    """

    def __init__(
        self,
        agent: Any,
        size: int = 256,
        *,
        name: str | None = None,
        weight: int = 1,
        clock: Any = None,
    ) -> None:
        if size < 1:
            raise ValueError("queue size must be >= 1")
        if weight < 1:
            raise ValueError("queue weight must be >= 1")
        self.agent = agent
        self.size = size
        self.name = name if name is not None else f"q{next(_QUEUE_IDS)}"
        self.weight = weight
        self.clock = clock                 # optional: stamps packet enqueue times
        self.ledger = None                 # optional: records dispatch_submit (set on add_queue)
        self._ring: list[Packet | None] = [None] * size
        self._write = 0
        self._read = 0
        self._lock = threading.Lock()
        self.doorbell = Signal(0, name=f"doorbell:{self.name}")
        self._notify: Any = None           # scheduler doorbell fan-in (set on add_queue)

    # -- producer side -----------------------------------------------------------

    def _write_packets(self, packets: Sequence[Packet]) -> int:
        """Ring-write + one doorbell store + one scheduler notify; returns the
        first packet's index.  The shared tail of submit/submit_burst."""
        now = self.clock.now() if self.clock is not None else None
        for packet in packets:
            if now is not None and packet.enqueue_t is None:
                packet.enqueue_t = now
            # Completion waits inherit the queue's time source so timed waits
            # (engine launch waits, watchdog probes) are deterministic under a
            # VirtualClock without the producer having to plumb it per packet.
            completion = packet.completion
            if (
                self.clock is not None
                and completion is not None
                and getattr(completion, "clock", None) is None
            ):
                completion.clock = self.clock
        with self._lock:
            if self._write - self._read + len(packets) > self.size:
                raise QueueFullError(f"queue {self.name} full ({self.size} packets)")
            idx = self._write
            for packet in packets:
                self._ring[self._write % self.size] = packet
                self._write += 1
        self.doorbell.store(self._write)      # ring the doorbell (once per burst)
        if self._notify is not None:
            self._notify()
        return idx

    def _record_submit(self, packets: Sequence[Packet], seconds: float) -> None:
        if self.ledger is None:
            return
        per_pkt = seconds / len(packets)
        for packet in packets:
            self.ledger.record(
                ledger_mod.DISPATCH_SUBMIT, per_pkt, queue=self.name,
                producer=getattr(packet, "producer", None),
                burst=len(packets),
            )

    def submit(self, packet: Packet) -> int:
        t0 = time.perf_counter_ns()
        idx = self._write_packets((packet,))
        self._record_submit((packet,), (time.perf_counter_ns() - t0) * 1e-9)
        return idx

    def submit_burst(self, packets: Sequence[Packet]) -> int:
        """Write N packets and ring the doorbell **once** (burst AQL submission).

        The whole burst shares one ``burst_id`` (the scheduler's grant loop
        uses it to drain the burst in a single wakeup) and the measured
        submit cost is divided over the N packets in the ledger — the
        amortization Table II's invocation row is split to expose.  Packets
        may carry dependency signals on each other (a chained decode burst);
        in-order consumption guarantees a packet's intra-burst deps precede
        it.  Returns the first packet's ring index.
        """
        packets = list(packets)
        if not packets:
            raise ValueError("submit_burst needs at least one packet")
        t0 = time.perf_counter_ns()
        bid = next(_BURST_IDS)
        unstamped = [p for p in packets if p.enqueue_t is None]
        for packet in packets:
            packet.burst_id = bid
            packet.burst_n = len(packets)
        try:
            idx = self._write_packets(packets)
        except QueueFullError:
            # nothing was written: revert the burst stamps so a caller that
            # falls back to individual submits doesn't carry a dead burst_id
            # (which would fuse its retries into one grant pass) or a stale
            # enqueue_t (which would inflate WAIT on retry)
            for packet in packets:
                packet.burst_id = None
                packet.burst_n = 1
            for packet in unstamped:
                packet.enqueue_t = None
            raise
        self._record_submit(packets, (time.perf_counter_ns() - t0) * 1e-9)
        return idx

    def dispatch(
        self,
        role_key: RoleKey,
        *args: Any,
        producer: str = "tf",
        deps: Sequence[Signal] = (),
    ) -> KernelDispatchPacket:
        pkt = dispatch_packet(role_key, *args, producer=producer, deps=deps)
        self.submit(pkt)
        return pkt

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        producer: str = "tf",
        deps: Sequence[Signal] = (),
    ) -> KernelDispatchPacket:
        """Dispatch a pinned-shell callable (no region management)."""
        pkt = call_packet(fn, *args, producer=producer, deps=deps)
        self.submit(pkt)
        return pkt

    def barrier(self, deps: Sequence[Signal]) -> BarrierAndPacket:
        pkt = BarrierAndPacket(deps=tuple(deps), completion=Signal(1, name="barrier"))
        self.submit(pkt)
        return pkt

    # -- consumer side -----------------------------------------------------------

    def peek(self) -> Packet | None:
        """Head packet without consuming it (in-order queues never skip)."""
        with self._lock:
            if self._read >= self._write:
                return None
            return self._ring[self._read % self.size]

    def peek_window(self, n: int) -> list[Packet]:
        """First ``n`` packets without consuming them — the scheduler's
        lookahead window for reconfiguration prefetch.  Like ``peek`` this
        never reorders: in-order queues expose, not skip, their future."""
        with self._lock:
            depth = min(n, self._write - self._read)
            return [
                self._ring[(self._read + i) % self.size]  # type: ignore[misc]
                for i in range(max(0, depth))
            ]

    def pop(self) -> Packet | None:
        with self._lock:
            if self._read >= self._write:
                return None
            pkt = self._ring[self._read % self.size]
            self._ring[self._read % self.size] = None
            self._read += 1
            return pkt

    def requeue_head(self, packet: Packet) -> None:
        """Consumer-side undo: push a just-popped packet back into the head
        slot so the grant loop re-presents it without reordering it behind
        later submissions.  Used by the scheduler's fault-retry path; the
        packet keeps its original ``enqueue_t`` so WAIT accounting spans the
        whole retried lifetime."""
        with self._lock:
            if self._write - self._read + 1 > self.size:
                raise QueueFullError(f"queue {self.name} full ({self.size} packets)")
            self._read -= 1
            self._ring[self._read % self.size] = packet

    def pending(self) -> int:
        with self._lock:
            return self._write - self._read

    def __len__(self) -> int:
        return self.pending()

    def __repr__(self) -> str:
        return f"Queue({self.name}, pending={self.pending()}, weight={self.weight})"
