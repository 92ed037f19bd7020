"""Kernel registry: the heart of transparent acceleration.

The registry maps a logical op name (``"matmul"``, ``"flash_attention"``,
...) plus a device kind to the implementations registered for it.  Each
implementation is tagged with a *source*:

  - ``"reference"`` — torch oracle (always correct, never fast),
  - ``"torch"``     — torch eager formulation (the counterpart of the JAX
    package's ``xla`` source),
  - ``"triton"``    — a Triton kernel written by hand,
  - ``"cuda"``      — a CUDA C++ kernel written by hand for Hopper (the
    "presynthesized role").

Resolution is policy driven (see :mod:`repro_torch.core.dispatch`): a
preference order over sources.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Sequence

Sources = ("cuda", "triton", "torch", "reference")

GENERIC = "generic"
FIXED_WEIGHT = "fixed_weight"


@dataclasses.dataclass(frozen=True)
class ResourceFootprint:
    """Static resource claim of one launch of an implementation.

    ``smem_bytes`` is the shared memory a thread block claims and
    ``threads`` its threads per block — what decides how many blocks share
    an SM.  A role reports it beside its argument bytes
    (:meth:`repro_torch.core.roles.Role.footprint`).  Informational for the
    reference and torch sources.
    """

    smem_bytes: int = 0
    threads: int = 0

    def smem_fraction(self, smem_per_sm: int = 228 * 1024) -> float:
        """Share of one SM's shared memory a block claims (H100: 228 KB)."""
        return self.smem_bytes / float(smem_per_sm)


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation of a logical op."""

    op: str
    device_kind: str
    source: str                      # one of Sources
    fn: Callable[..., Any]
    name: str = ""
    specialization: str = GENERIC    # GENERIC | FIXED_WEIGHT
    priority: int = 0                # higher wins within a source
    footprint: ResourceFootprint = ResourceFootprint()

    def __post_init__(self) -> None:
        if self.source not in Sources:
            raise ValueError(f"unknown source {self.source!r}; expected one of {Sources}")
        if not self.name:
            object.__setattr__(self, "name", f"{self.op}:{self.source}:{self.specialization}")


class KernelRegistry:
    """Thread-safe registry of kernel implementations: ``register`` at
    import time, ``resolve`` at op-dispatch time.  ``snapshot``/``restore``
    support hermetic tests."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._impls: dict[tuple[str, str], list[KernelImpl]] = {}
        self._version = 0      # bumped on any mutation; resolve caches key on it

    @property
    def version(self) -> int:
        """Monotonic mutation counter.  Resolution caches (the
        DispatchContext memo) key their entries on this so a late
        registration invalidates them."""
        with self._lock:
            return self._version

    def register(self, impl: KernelImpl, *, allow_override: bool = False) -> KernelImpl:
        key = (impl.op, impl.device_kind)
        with self._lock:
            bucket = self._impls.setdefault(key, [])
            existing = [i for i in bucket if i.name == impl.name]
            if existing and not allow_override:
                raise ValueError(f"kernel {impl.name!r} already registered for {key}")
            for old in existing:
                bucket.remove(old)
            bucket.append(impl)
            bucket.sort(key=lambda i: -i.priority)
            self._version += 1
        return impl

    def define(
        self,
        op: str,
        *,
        device_kind: str = "cuda",
        source: str,
        name: str = "",
        specialization: str = GENERIC,
        priority: int = 0,
        footprint: ResourceFootprint = ResourceFootprint(),
        allow_override: bool = False,
    ) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        """Decorator form: ``@registry.define("matmul", source="cuda")``."""

        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            self.register(
                KernelImpl(op=op, device_kind=device_kind, source=source, fn=fn, name=name,
                           specialization=specialization, priority=priority,
                           footprint=footprint),
                allow_override=allow_override,
            )
            return fn

        return deco

    def resolve(
        self,
        op: str,
        device_kind: str,
        prefer: Sequence[str] = ("torch", "reference"),
        *,
        specialization: str | None = None,
        require: bool = True,
    ) -> KernelImpl | None:
        """Find the best implementation under a source-preference order.

        Falls back through ``prefer`` in order; within one source the highest
        priority impl wins.  ``specialization`` filters (e.g. a fixed-weight
        role).
        """
        with self._lock:
            bucket = list(self._impls.get((op, device_kind), ()))
            if device_kind != "any":
                bucket += list(self._impls.get((op, "any"), ()))
        if specialization is not None:
            bucket = [i for i in bucket if i.specialization == specialization]
        for source in prefer:
            matches = [i for i in bucket if i.source == source]
            if matches:
                return max(matches, key=lambda i: i.priority)
        if require:
            have = sorted({i.source for i in bucket})
            raise KeyError(
                f"no kernel for op={op!r} device_kind={device_kind!r} under "
                f"prefer={tuple(prefer)}; registered sources: {have}"
            )
        return None


    def snapshot(self) -> dict[tuple[str, str], list[KernelImpl]]:
        with self._lock:
            return {k: list(v) for k, v in self._impls.items()}

    def restore(self, snap: dict[tuple[str, str], list[KernelImpl]]) -> None:
        with self._lock:
            self._impls = {k: list(v) for k, v in snap.items()}
            self._version += 1


GLOBAL_REGISTRY = KernelRegistry()


def register(impl: KernelImpl, **kw: Any) -> KernelImpl:
    return GLOBAL_REGISTRY.register(impl, **kw)


def define(op: str, **kw: Any) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    return GLOBAL_REGISTRY.define(op, **kw)
