"""Transparent op dispatch — the "no secondary toolchain" property.

Model code calls ``dispatch.op("matmul", x, w)`` instead of a concrete
implementation.  PyTorch runs eagerly, so the op resolves at every call (a
memo keeps that to one dictionary lookup); the active
:class:`DispatchContext` selects the device kind and source preference.
Flipping ``prefer=policy_from_flag("cuda")`` retargets an entire model to
the hand-written Hopper kernels without touching model code; that one-flag
switch is the paper's transparency claim.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, Sequence

from repro_torch.core.registry import GLOBAL_REGISTRY, KernelImpl, KernelRegistry


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    device_kind: str = "cuda"
    prefer: tuple[str, ...] = ("torch", "reference")
    registry: KernelRegistry = GLOBAL_REGISTRY
    trace: "DispatchTrace | None" = None
    # resolution memo: device_kind/prefer/registry are frozen per context, so
    # (op, specialization) fully determines the resolved impl.  Entries carry
    # the registry version so a late registration invalidates them.
    _resolve_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False, hash=False
    )

    def resolve(self, op: str, *, specialization: str | None = None) -> KernelImpl:
        key = (op, specialization)
        version = self.registry.version
        hit = self._resolve_cache.get(key)
        if hit is not None and hit[0] == version:
            return hit[1]
        impl = self.registry.resolve(
            op, self.device_kind, self.prefer, specialization=specialization
        )
        self._resolve_cache[key] = (version, impl)
        return impl


class DispatchTrace:
    """Records the sequence of resolved ops (role keys) during a run.

    The role planner (:mod:`repro_torch.core.policy`) consumes this to decide
    the generic-vs-fixed-weight split under a region budget.
    """

    def __init__(self) -> None:
        self.events: list[tuple[str, str]] = []   # (op, impl name)

    def record(self, op: str, impl: KernelImpl) -> None:
        self.events.append((op, impl.name))

    def op_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for op_name, _ in self.events:
            counts[op_name] = counts.get(op_name, 0) + 1
        return counts


_DEFAULT = DispatchContext()
_CTX: contextvars.ContextVar[DispatchContext] = contextvars.ContextVar(
    "repro_torch_dispatch_ctx", default=_DEFAULT
)


def current() -> DispatchContext:
    return _CTX.get()


@contextlib.contextmanager
def use(
    *,
    device_kind: str | None = None,
    prefer: Sequence[str] | None = None,
    registry: KernelRegistry | None = None,
    trace: DispatchTrace | None = None,
) -> Iterator[DispatchContext]:
    """Scoped dispatch policy, like the paper's device annotation in user code."""
    base = _CTX.get()
    ctx = DispatchContext(
        device_kind=device_kind if device_kind is not None else base.device_kind,
        prefer=tuple(prefer) if prefer is not None else base.prefer,
        registry=registry if registry is not None else base.registry,
        trace=trace if trace is not None else base.trace,
    )
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def op(name: str, *args: Any, specialization: str | None = None, **kwargs: Any) -> Any:
    """Dispatch a logical op through the active context."""
    ctx = _CTX.get()
    impl = ctx.resolve(name, specialization=specialization)
    if ctx.trace is not None:
        ctx.trace.record(name, impl)
    return impl.fn(*args, **kwargs)


def resolve(name: str, *, specialization: str | None = None) -> KernelImpl:
    return _CTX.get().resolve(name, specialization=specialization)


def policy_from_flag(policy: str) -> tuple[str, ...]:
    """Map a CLI ``--policy`` flag to a source-preference order."""
    orders = {
        "reference": ("reference",),
        "torch": ("torch", "reference"),
        "cuda": ("cuda", "triton", "torch", "reference"),
        "cuda-strict": ("cuda", "triton"),
    }
    if policy not in orders:
        raise ValueError(f"unknown policy {policy!r}; choose from {sorted(orders)}")
    return orders[policy]
