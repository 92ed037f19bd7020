"""The bookkeeping a captured decode graph relies on, on the CPU: where the
kernels' launch counts and split counters go while a graph is warmed up or
captured on one thread (``native.graph_scope``), and the one list of
counted kernel modules (``repro_torch.kernels.MODULES``).  The capture
itself needs a card: ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import importlib
import pkgutil
import threading

import torch

import repro_torch.kernels as kernel_pkg
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import native
from repro_torch.kernels import sample as sample_k

CPU = torch.device("cpu")


def test_every_module_with_a_launch_counter_is_listed():
    """A kernel module left off MODULES would make replays miscount with no
    error: every module of the package with a ``launches`` counter is on
    it, and every listed module has one."""
    counted = set()
    for info in pkgutil.iter_modules(kernel_pkg.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}")
        if isinstance(getattr(mod, "launches", None), int):
            counted.add(info.name)
    assert counted == set(kernel_pkg.MODULES)
    counters = kernel_pkg.launch_counters()
    assert {name for name, _ in counters} == counted
    assert {attr for name, attr in counters if name == "matmul"} == {
        "launches", "fixed_launches", "edge_launches", "f32_launches"}


def test_a_capture_tallies_its_own_thread_s_launches_only():
    """While one thread captures, its launches go to the capture's tally and
    the counters do not move; another thread's launches meanwhile are
    counted as ever; adding the tally is one replay."""
    before = kernel_pkg.launch_counters()
    tally: dict = {}
    opened, counted = threading.Event(), threading.Event()

    def other_thread():
        opened.wait()
        native.count_launch(mm_k.__name__)
        native.count_launch(mm_k.__name__, "edge_launches")
        counted.set()

    t = threading.Thread(target=other_thread)
    t.start()
    with native.graph_scope({}, tally):
        opened.set()
        native.count_launch(mm_k.__name__)
        native.count_launch(sample_k.__name__)
        native.count_launch(sample_k.__name__)
        counted.wait()
    t.join()
    assert tally == {(mm_k.__name__, "launches"): 1, (sample_k.__name__, "launches"): 2}
    after = kernel_pkg.launch_counters()
    assert {k: after[k] - v for k, v in before.items() if after[k] != v} == {
        ("matmul", "launches"): 1, ("matmul", "edge_launches"): 1}
    native.add_launches(tally)
    native.add_launches(tally)
    again = kernel_pkg.launch_counters()
    assert {k: again[k] - v for k, v in after.items() if again[k] != v} == {
        ("matmul", "launches"): 2, ("sample", "launches"): 4}
    native.count_launch(sample_k.__name__)            # the scope is closed: counted
    assert sample_k.launches == again[("sample", "launches")] + 1


def test_launch_counts_from_many_threads_add_up():
    """Counters bumped from several threads at once lose no launch."""
    before = sample_k.launches

    def bump():
        for _ in range(5000):
            native.count_launch(sample_k.__name__)

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sample_k.launches - before == 20000


def test_a_graph_scope_keeps_its_own_split_counters():
    """Inside a scope, split counters come from the graph's own dict: two
    graphs captured on the same stream handle, and eager launches there,
    never share a buffer; the buffers stay for the graph's later steps."""
    eager = native.tile_counters("sample", CPU, 7, 16)
    first, second = {}, {}
    with native.graph_scope(first):
        a = native.tile_counters("sample", CPU, 7, 16)
        assert native.tile_counters("sample", CPU, 7, 8) is a
    with native.graph_scope(second, {}):
        b = native.tile_counters("sample", CPU, 7, 16)
    assert len({a.data_ptr(), b.data_ptr(), eager.data_ptr()}) == 3
    assert list(first) == list(second) == [("sample", None, 7)]
    with native.graph_scope(first):
        assert native.tile_counters("sample", CPU, 7, 16) is a
    assert native.tile_counters("sample", CPU, 7, 16) is eager
    assert not bool(a.any()) and a.dtype == torch.int32 and a.numel() >= 16
