"""HSA agents: devices as the runtime sees them.

An agent wraps one ``torch.device`` plus the memory-region descriptors the
HSA standard exposes: for a CUDA card its device memory ("global") and the
shared memory one block may use ("group"), read from
``torch.cuda.get_device_properties``; for the CPU, host RAM.  Discovery
enumerates every visible CUDA card — the paper's "detects and manages all
the accessible HSA devices visible to the framework" — or the CPU when the
caller asks for it.  Bandwidths stay 0.0: nothing here measures them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MemoryRegion:
    name: str
    size_bytes: int
    kind: str                     # "global" (device memory/RAM) | "group" (shared memory)
    bandwidth_bps: float = 0.0


def _host_ram_bytes() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return 0


class Agent:
    """One kernel-dispatch-capable device."""

    def __init__(self, device: "str | torch.device", *, num_reconfig_regions: int = 4) -> None:
        self.device = torch.device(device)
        self.kind = "gpu" if self.device.type == "cuda" else self.device.type
        index = self.device.index if self.device.index is not None else 0
        self.name = f"{self.kind}:{index}"
        self.num_reconfig_regions = num_reconfig_regions
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            self.regions = (
                MemoryRegion("HBM", int(props.total_memory), "global"),
                MemoryRegion("SMEM", int(getattr(props, "shared_memory_per_block", 0)), "group"),
            )
        else:
            self.regions = (MemoryRegion("RAM", _host_ram_bytes(), "global"),)
        self._queues: list[Any] = []

    # -- queues --------------------------------------------------------------

    def create_queue(
        self, size: int = 256, *, name: str | None = None, weight: int = 1
    ) -> "Any":
        from repro_torch.core.hsa.queue import Queue

        q = Queue(agent=self, size=size, name=name, weight=weight)
        self._queues.append(q)
        return q

    @property
    def queues(self) -> list[Any]:
        return list(self._queues)

    # -- discovery -------------------------------------------------------------

    @staticmethod
    def discover(*, num_reconfig_regions: int = 4,
                 device: "str | torch.device" = "cuda") -> list["Agent"]:
        """One agent per visible CUDA card (``device="cuda"``, the default;
        raises when there is none), or the one device asked for
        (``"cpu"``, ``"cuda:1"``)."""
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device visible; pass device='cpu' to run the "
                                   "HSA runtime on the host")
            if device.index is None:
                return [Agent(torch.device("cuda", i), num_reconfig_regions=num_reconfig_regions)
                        for i in range(torch.cuda.device_count())]
        return [Agent(device, num_reconfig_regions=num_reconfig_regions)]

    def __repr__(self) -> str:
        return f"Agent({self.name}, regions={len(self.regions)}, queues={len(self._queues)})"
