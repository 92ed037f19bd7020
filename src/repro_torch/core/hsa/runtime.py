"""hsa_init / hsa_shut_down: system bring-up.

One-time device/kernel setup (paper Table II row 1): enumerate agents (the
CUDA cards by default, or the one device given as ``device=``), build the
role library, and create per kernel-dispatch agent:

  - ``num_queues`` user-level soft queues (the paper's multi-producer story:
    TensorFlow, OpenCL, OpenMP clients each get their own queue),
  - one async multi-queue :class:`Scheduler` plus a legacy ``Executor``
    façade over it,
  - one :class:`RegionManager` (bounded residency, LRU).

The measured setup time lands in the ledger's SETUP category.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from repro_torch.core import ledger as ledger_mod
from repro_torch.core.ledger import GLOBAL_LEDGER, OverheadLedger
from repro_torch.core.hsa.agent import Agent
from repro_torch.core.hsa.executor import Executor
from repro_torch.core.hsa.queue import Queue
from repro_torch.core.hsa.scheduler import Scheduler
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary


class HsaSystem:
    def __init__(
        self,
        *,
        num_regions: int = 4,
        num_queues: int = 1,
        ledger: OverheadLedger = GLOBAL_LEDGER,
        queue_size: int = 1024,
        scheduler_policy: str = "round_robin",
        device: "str | torch.device" = "cuda",
    ) -> None:
        self.ledger = ledger
        with ledger.timed(ledger_mod.SETUP, what="hsa_init"):
            self.agents = Agent.discover(num_reconfig_regions=num_regions, device=device)
            self.library = RoleLibrary(ledger=ledger)
            self.queues: dict[str, Queue] = {}             # default queue per agent
            self.soft_queues: dict[str, list[Queue]] = {}  # all soft queues per agent
            self.executors: dict[str, Executor] = {}
            self.schedulers: dict[str, Scheduler] = {}
            self.regions: dict[str, RegionManager] = {}
            for agent in self.agents:
                rm = RegionManager(agent.num_reconfig_regions, ledger=ledger)
                sched = Scheduler(
                    rm, self.library, ledger=ledger, policy=scheduler_policy
                )
                qs = [
                    sched.add_queue(
                        agent.create_queue(queue_size, name=f"{agent.name}/q{i}")
                    )
                    for i in range(max(1, num_queues))
                ]
                self.queues[agent.name] = qs[0]
                self.soft_queues[agent.name] = qs
                self.regions[agent.name] = rm
                self.schedulers[agent.name] = sched
                self.executors[agent.name] = Executor(
                    rm, self.library, ledger=ledger, scheduler=sched
                )

    @property
    def default_agent(self) -> Agent:
        # Prefer a real accelerator when present; else the first agent.
        for a in self.agents:
            if a.kind != "cpu":
                return a
        return self.agents[0]

    def queue_of(self, agent: Agent) -> Queue:
        return self.queues[agent.name]

    def queues_of(self, agent: Agent) -> list[Queue]:
        return list(self.soft_queues[agent.name])

    def executor_of(self, agent: Agent) -> Executor:
        return self.executors[agent.name]

    def scheduler_of(self, agent: Agent) -> Scheduler:
        return self.schedulers[agent.name]

    def regions_of(self, agent: Agent) -> RegionManager:
        return self.regions[agent.name]

    def create_queue(
        self, agent: Agent, *, name: str | None = None, size: int = 256,
        weight: int = 1,
    ) -> Queue:
        """Open an extra soft queue on ``agent`` (a new tenant)."""
        q = agent.create_queue(size, name=name, weight=weight)
        self.schedulers[agent.name].add_queue(q)
        self.soft_queues[agent.name].append(q)
        return q

    def shutdown(self) -> None:
        for ex in self.executors.values():
            ex.stop()
        for sched in self.schedulers.values():
            sched.stop()                 # idempotent; covers direct .start() users
        for rm in self.regions.values():
            rm.flush()


_SYSTEM: HsaSystem | None = None
_LOCK = threading.Lock()


def hsa_init(**kw: Any) -> HsaSystem:
    global _SYSTEM
    with _LOCK:
        if _SYSTEM is None:
            _SYSTEM = HsaSystem(**kw)
        return _SYSTEM


def hsa_system() -> HsaSystem:
    if _SYSTEM is None:
        raise RuntimeError("hsa_init() has not been called")
    return _SYSTEM


def hsa_shut_down() -> None:
    global _SYSTEM
    with _LOCK:
        if _SYSTEM is not None:
            _SYSTEM.shutdown()
            _SYSTEM = None
