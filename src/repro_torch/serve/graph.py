"""The decode step as a CUDA graph: captured once, replayed K times a launch.

The JAX engine runs a fused decode launch as one jitted ``lax.scan`` of K
steps.  A CUDA graph is the port's counterpart: :class:`StepGraph` captures
one decode step — every kernel of the model, the sampler and the updates of
the engine's static buffers — and replays it, so a step costs one graph
launch on the host instead of hundreds of kernel calls through Python.

- **Warm-up.** The first step of a launch with no graph runs eagerly on
  the graph's own stream, then the same step is captured.  So the kernels'
  counter buffers (one per CUDA stream, ``kernels/native.py``) and plans
  exist outside the graph's memory pool, and the step runs on the card.
- **Addresses.** Kernels take tensor maps and pointers by address, and the
  graph freezes them: every tensor the step reads or writes (the cache or
  page pool, the weights, the static buffers) must keep its address.
  :meth:`StepGraph.run` checks them before it replays and raises if one
  moved.
- **Counts.** Capture launches nothing on the card, but runs the kernels'
  Python wrappers: their launches go to the capture's own tally
  (``native.graph_scope``, on the capturing thread only) and the dispatch
  ops to a trace of its own.  Each replay adds both, so a counter still
  counts launches on the card, whatever other threads launch meanwhile.
- **Counter buffers.** The kernels that split work across blocks keep
  zeroed counters on the card, one buffer per stream
  (``native.tile_counters``).  A graph freezes the buffers it captured, so
  each graph gets its own, made by the warm-up step: two graphs, or a graph
  and eager launches, never share one.
- **Threads.** The capture runs in ``thread_local`` mode: another thread may
  use the card meanwhile (the HSA scheduler's worker captures while the
  main thread serves another tenant).
- **Garbage.** Freeing a CUDA graph on the capturing thread invalidates
  the capture, and a dropped engine's graph is freed by the cycle
  collector: it runs just before the capture and is off during it.
- **Policy.** The graph holds the kernels the dispatch policy chose at
  capture: a launch under another policy captures anew.

There is no fallback: a capture that fails raises.  The CPU has no graphs;
the engine calls its step function there.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Iterable

import torch

from repro_torch.core import dispatch
from repro_torch.kernels import native


def _policy_key() -> tuple:
    ctx = dispatch.current()
    return ctx.device_kind, ctx.prefer, id(ctx.registry), ctx.registry.version


class StepGraph:
    """One step (``step``, a function of no arguments that reads and writes
    only tensors that keep their addresses) captured as a CUDA graph on
    ``device``.  ``held`` lists those tensors."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 held: Callable[[], Iterable[torch.Tensor]]):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self._step = step
        self._held = held
        self.device = device
        self._stream: torch.cuda.Stream | None = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._key: tuple | None = None
        self._addresses: tuple[int, ...] = ()
        self._tile_counters: dict = {}
        self._counts: dict[tuple[str, str], int] = {}
        self._events: list = []
        self.captures = 0          # graphs captured
        self.replays = 0           # steps replayed
        self.captured_on: str | None = None     # the thread of the last capture

    def run(self, n: int) -> None:
        """``n`` steps: the first eagerly and then captured where this policy
        has no graph yet, the rest (or all) as replays."""
        left = n
        if self._graph is None or self._key != _policy_key():
            self._capture()
            left -= 1
        if left <= 0:
            return
        self._check_addresses()
        trace = dispatch.current().trace
        for _ in range(left):
            self._graph.replay()
            native.add_launches(self._counts)
            if trace is not None:
                trace.events.extend(self._events)
        self.replays += left

    def _check_addresses(self) -> None:
        now = tuple(t.data_ptr() for t in self._held())
        if now != self._addresses:
            moved = sum(a != b for a, b in zip(now, self._addresses)) + abs(
                len(now) - len(self._addresses))
            raise RuntimeError(
                f"{moved} tensor(s) the decode graph captured were reallocated or replaced "
                f"after capture: the graph would read and write their old memory")

    def _capture(self) -> None:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream), native.graph_scope(self._tile_counters):
            self._step()                       # the warm-up: a real step, counted
        current.wait_stream(stream)
        graph, tally, trace = torch.cuda.CUDAGraph(), {}, dispatch.DispatchTrace()
        # an engine and its graph form a reference cycle, so a dropped engine's
        # graph is freed by the cycle collector, and freeing a graph while this
        # thread captures invalidates the capture: collect now, and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with native.graph_scope(self._tile_counters, tally), dispatch.use(trace=trace), \
                    torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                self._step()
        finally:
            if collecting:
                gc.enable()
        self._counts, self._events = tally, trace.events
        self._graph, self._key = graph, _policy_key()
        self._addresses = tuple(t.data_ptr() for t in self._held())
        self.captures += 1
        self.captured_on = threading.current_thread().name
