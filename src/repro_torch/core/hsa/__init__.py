"""HSA-style runtime pieces the port has so far: the injectable clocks."""

from repro_torch.core.hsa.clock import Clock, VirtualClock, WallClock

__all__ = ["Clock", "VirtualClock", "WallClock"]
