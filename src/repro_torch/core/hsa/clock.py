"""Injectable time sources for the HSA scheduler.

The scheduler never calls ``time.*`` directly: it asks its clock.  Two
implementations:

  - :class:`WallClock` — monotonic wall time (production / threaded mode).
  - :class:`VirtualClock` — a discrete-event clock that only moves when the
    scheduler advances it.  Deterministic: tests assert exact event
    timestamps and interleavings with zero wall-clock sleeps and zero flakes.

This is the paper's runtime made testable under load: the same scheduler
code path runs against either clock, so every interleaving exercised in CI
is an interleaving the production path can produce.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    def now(self) -> float: ...
    def sleep(self, seconds: float) -> None: ...


class WallClock:
    """Monotonic wall time."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def __repr__(self) -> str:
        return "WallClock()"


class VirtualClock:
    """Deterministic simulated time.

    ``advance``/``advance_to`` are the only ways time moves; ``sleep`` is an
    advance (never a wall-clock wait).  Monotonicity is enforced so event
    logs are always well ordered.
    """

    virtual = True

    def __init__(self, start: float = 0.0) -> None:
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance virtual time by {dt}")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        if t > self._t:
            self._t = float(t)
        return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, seconds))

    def __repr__(self) -> str:
        return f"VirtualClock(t={self._t:.9g})"
