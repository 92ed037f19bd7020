"""HSA-style runtime layer (agents, queues, signals, scheduler, executor)."""

from repro_torch.core.hsa.agent import Agent, MemoryRegion
from repro_torch.core.hsa.clock import Clock, VirtualClock, WallClock
from repro_torch.core.hsa.executor import Executor, run_packet_sync
from repro_torch.core.hsa.faults import (
    FaultError,
    FaultEvent,
    FaultPlan,
    InjectedFault,
    InjectedLoadFault,
    PermanentFault,
    WedgedLaunch,
)
from repro_torch.core.hsa.queue import (
    BarrierAndPacket,
    Box,
    KernelDispatchPacket,
    Queue,
    QueueFullError,
    call_packet,
    dispatch_packet,
)
from repro_torch.core.hsa.runtime import HsaSystem, hsa_init, hsa_shut_down, hsa_system
from repro_torch.core.hsa.scheduler import (
    SchedEvent,
    Scheduler,
    SchedulerDeadlock,
    QueueStats,
)
from repro_torch.core.hsa.signal import CompositeSignal, Signal, wait_all

__all__ = [
    "Agent",
    "MemoryRegion",
    "Clock",
    "VirtualClock",
    "WallClock",
    "Executor",
    "run_packet_sync",
    "FaultError",
    "FaultEvent",
    "FaultPlan",
    "InjectedFault",
    "InjectedLoadFault",
    "PermanentFault",
    "WedgedLaunch",
    "BarrierAndPacket",
    "Box",
    "KernelDispatchPacket",
    "Queue",
    "QueueFullError",
    "call_packet",
    "dispatch_packet",
    "HsaSystem",
    "hsa_init",
    "hsa_shut_down",
    "hsa_system",
    "SchedEvent",
    "Scheduler",
    "SchedulerDeadlock",
    "QueueStats",
    "CompositeSignal",
    "Signal",
    "wait_all",
]
