"""Legacy single-queue executor, now a façade over the async scheduler.

The synchronous ``Executor`` API (drain / start / stop) is kept for existing
callers and benchmarks, but all packet processing lives in one place:
:class:`repro_torch.core.hsa.scheduler.Scheduler`.  ``drain`` is the cooperative
single-consumer mode; ``start`` runs the scheduler's doorbell-driven worker
thread so multiple producers can share the agent, per the paper's
multi-tenancy claim.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.ledger import GLOBAL_LEDGER, OverheadLedger
from repro_torch.core.hsa.queue import KernelDispatchPacket, Queue
from repro_torch.core.hsa.scheduler import Scheduler
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary


class Executor:
    def __init__(
        self,
        regions: RegionManager,
        library: RoleLibrary,
        *,
        ledger: OverheadLedger = GLOBAL_LEDGER,
        scheduler: Scheduler | None = None,
    ) -> None:
        self.regions = regions
        self.library = library
        self.ledger = ledger
        self.scheduler = scheduler or Scheduler(regions, library, ledger=ledger)
        self._running = False

    def drain(self, queue: Queue) -> int:
        """Synchronously process everything currently submitted."""
        return self.scheduler.drain(queue)

    # -- background mode ------------------------------------------------------------

    def start(self, queue: Queue, poll_s: float = 0.0005) -> None:
        if self._running:
            raise RuntimeError("executor already running")
        if all(q is not queue for q in self.scheduler.queues):
            self.scheduler.add_queue(queue)
        self.scheduler.start(poll_s=poll_s)
        self._running = True

    def stop(self) -> None:
        if self._running:
            self.scheduler.stop()
            self._running = False


def run_packet_sync(executor: Executor, queue: Queue, pkt: KernelDispatchPacket) -> Any:
    """Helper: drain until this packet completes and return (or raise) its result."""
    executor.drain(queue)
    assert pkt.completion is not None
    pkt.completion.wait_eq(0)
    if pkt.out.error is not None:
        raise pkt.out.error
    return pkt.out.value
