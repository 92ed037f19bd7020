"""HSA signals: the synchronization primitive of the runtime.

HSA 1.2 signals are 64-bit values with atomic ops and blocking waits; producers
decrement/store, consumers wait on a condition.  Used here for queue doorbells,
packet completion, and barrier-AND dependencies — same roles as in the paper's
runtime.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable


class Signal:
    def __init__(self, initial: int = 1, name: str = "", clock: Any = None) -> None:
        self._value = int(initial)
        self._cond = threading.Condition()
        self.name = name
        self.clock = clock  # optional injectable time source for timed waits

    # -- atomics ---------------------------------------------------------------

    def load(self) -> int:
        with self._cond:
            return self._value

    def store(self, value: int) -> None:
        with self._cond:
            self._value = int(value)
            self._cond.notify_all()

    def add(self, delta: int) -> int:
        with self._cond:
            self._value += int(delta)
            self._cond.notify_all()
            return self._value

    def subtract(self, delta: int) -> int:
        return self.add(-delta)

    def decrement(self) -> int:
        return self.add(-1)

    def exchange(self, value: int) -> int:
        with self._cond:
            old = self._value
            self._value = int(value)
            self._cond.notify_all()
            return old

    # -- waits -------------------------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() if self.clock is None else self.clock.now()

    def _wait(self, pred: Callable[[int], bool], timeout: float | None) -> bool:
        clk = self.clock
        if timeout is not None and clk is not None and getattr(clk, "virtual", False):
            # Virtual time never moves inside a blocking wait, so a timed wait
            # is modeled as a deterministic advance-and-recheck: either the
            # value is already there, or the timeout window elapses on the
            # virtual clock and the wait reports whatever the value then is.
            with self._cond:
                if pred(self._value):
                    return True
            clk.sleep(max(0.0, timeout))
            with self._cond:
                return pred(self._value)
        deadline = None if timeout is None else self._now() + timeout
        with self._cond:
            while not pred(self._value):
                remaining = None if deadline is None else deadline - self._now()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def wait_eq(self, target: int = 0, timeout: float | None = None) -> bool:
        return self._wait(lambda v: v == target, timeout)

    def wait_ne(self, target: int, timeout: float | None = None) -> bool:
        return self._wait(lambda v: v != target, timeout)

    def wait_lt(self, target: int, timeout: float | None = None) -> bool:
        return self._wait(lambda v: v < target, timeout)

    def wait_ge(self, target: int, timeout: float | None = None) -> bool:
        return self._wait(lambda v: v >= target, timeout)

    def __repr__(self) -> str:
        return f"Signal({self.load()}, name={self.name!r})"


def wait_all(
    signals: Iterable["Signal"],
    target: int = 0,
    timeout: float | None = None,
    clock: Any = None,
) -> bool:
    """Block until every signal reads ``target``; one wait covers a burst.

    The sequential component waits share a single deadline, so the total
    blocking time is bounded by ``timeout`` regardless of completion order
    (waiting on an already-satisfied signal returns immediately, so order
    only affects which signal eats the remaining budget on timeout).
    Returns False as soon as the deadline expires with any signal unmet.

    The deadline is tracked on ``clock`` when given, else on the first
    component signal that carries one, else on ``time.monotonic`` — so a
    burst wait under :class:`VirtualClock` stays deterministic end to end.
    """
    signals = tuple(signals)
    clk = clock
    if clk is None:
        for sig in signals:
            if getattr(sig, "clock", None) is not None:
                clk = sig.clock
                break
    now = time.monotonic if clk is None else clk.now
    deadline = None if timeout is None else now() + timeout
    for sig in signals:
        remaining = None if deadline is None else deadline - now()
        if not sig.wait_eq(target, remaining):
            return False
    return True


class CompositeSignal:
    """Aggregate read/wait view over a burst's completion signals.

    HSA has no N-way completion object; the idiom is one barrier-AND packet
    or a host-side wait over all signals.  This is the host-side form: it
    quacks like a :class:`Signal` for the read/wait subset (``load`` returns
    the number of components not yet at 0; ``wait_eq(0)`` blocks until every
    component reads 0), so producer code that waits one packet's completion
    can wait a whole burst through the same call site.
    """

    def __init__(self, signals: Iterable[Signal], name: str = "") -> None:
        self.signals = tuple(signals)
        self.name = name or f"composite[{len(self.signals)}]"

    def load(self) -> int:
        return sum(1 for s in self.signals if s.load() != 0)

    def wait_eq(self, target: int = 0, timeout: float | None = None) -> bool:
        if target != 0:
            raise ValueError("CompositeSignal only supports waiting to 0")
        return wait_all(self.signals, 0, timeout)

    def __len__(self) -> int:
        return len(self.signals)

    def __repr__(self) -> str:
        return f"CompositeSignal(pending={self.load()}/{len(self.signals)}, name={self.name!r})"
