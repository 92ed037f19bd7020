"""Roles: shape-specialized, presynthesized accelerator programs.

Paper mapping
-------------
An FPGA *role* is a presynthesized partial bitstream implementing one kernel,
registered with TensorFlow and loaded into a reconfigurable region on demand.
The counterpart on a CUDA card:

  - *synthesis*   = resolve the role's implementation, check that its
    signature takes the role's abstract arguments, and build its kernel
    library (``nvcc``, once per process, for a ``cuda`` source on a card).
    The expensive, offline step; the ledger records it under ``SETUP``.
  - *reconfiguration / load* = put on the card what the role holds: a
    fixed-weight role's weight, uploaded once, and one warm-up launch at the
    role's shapes (the first launch of a kernel loads its module onto the
    card).  Eviction (``unload``) frees what load put there, so ``resident``
    means device memory held.
  - *dispatch*    = calling the loaded role (async, HSA-queue mediated).

Two sources, as in the paper:
  - ``presynthesized`` roles synthesize at library-build time (``synthesize()``),
  - ``online`` roles synthesize lazily on first load ("runtime synthesis").

Roles are keyed by (op, abstract arg signature, specialization): like
bitstreams, they are shape- and dtype-specialized.  Signatures use numpy's
dtype names (``"float32"``, ``"int16"``, ``"bfloat16"``), so a role's key,
name and region-image digest equal the JAX package's for the same role.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
import time
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core import ledger as ledger_mod
from repro_torch.core.ledger import GLOBAL_LEDGER, OverheadLedger
from repro_torch.core.registry import FIXED_WEIGHT, GENERIC, KernelImpl

PRESYNTHESIZED = "presynthesized"
ONLINE = "online"


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """An abstract argument: shape and dtype, no data (the counterpart of
    ``jax.ShapeDtypeStruct``).  ``torch.empty(..., device="meta")`` tensors
    are accepted wherever an ``ArgSpec`` is."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self) -> None:
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``torch.float32`` -> ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def _sig_of(arg: "ArgSpec | torch.Tensor") -> tuple[tuple[int, ...], str]:
    return (tuple(int(d) for d in arg.shape), dtype_name(arg.dtype))


@dataclasses.dataclass(frozen=True)
class RoleKey:
    op: str
    signature: tuple[tuple[tuple[int, ...], str], ...]
    specialization: str = GENERIC

    def __str__(self) -> str:
        shapes = ",".join("x".join(map(str, s)) + d for s, d in self.signature)
        return f"{self.op}[{shapes}]{'' if self.specialization == GENERIC else '#' + self.specialization}"


class Role:
    """One shape-specialized accelerator program on ``device``.

    A fixed-weight implementation (``specialization == FIXED_WEIGHT``) whose
    function has a ``bind(device)`` method (the kernels' fixed-weight
    factories return such callables) is bound at load: its weight goes to
    the card then and is dropped at unload.
    """

    def __init__(
        self,
        impl: KernelImpl,
        abstract_args: Sequence["ArgSpec | torch.Tensor"],
        *,
        static_kwargs: Mapping[str, Any] | None = None,
        source: str = PRESYNTHESIZED,
        name: str | None = None,
        device: "str | torch.device" = "cuda",
    ) -> None:
        if source not in (PRESYNTHESIZED, ONLINE):
            raise ValueError(f"bad role source {source!r}")
        self.impl = impl
        self.abstract_args = tuple(
            a if isinstance(a, ArgSpec) else ArgSpec(tuple(a.shape), a.dtype)
            for a in abstract_args
        )
        self.static_kwargs = dict(static_kwargs or {})
        self.source = source
        self.device = torch.device(device)
        self.key = RoleKey(
            op=impl.op,
            signature=tuple(_sig_of(a) for a in self.abstract_args),
            specialization=impl.specialization,
        )
        self.name = name or str(self.key)
        self._synthesized: Callable[..., Any] | None = None   # the "bitstream"
        self._executable: Callable[..., Any] | None = None    # loaded into a region
        self.synthesis_s: float | None = None
        self.load_s: float | None = None
        self.load_count = 0

    # -- lifecycle -----------------------------------------------------------

    def _check_signature(self) -> None:
        fn = self.impl.fn
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):    # a builtin without a signature
            return
        try:
            sig.bind(*self.abstract_args, **self.static_kwargs)
        except TypeError as e:
            raise TypeError(f"role {self.name}: {getattr(fn, '__name__', fn)!r} does not take "
                            f"{len(self.abstract_args)} arguments and "
                            f"{sorted(self.static_kwargs)}: {e}") from None

    def synthesize(self) -> float:
        """Resolve, check and build (the offline 'HLS' step). Idempotent;
        returns seconds."""
        if self._synthesized is None:
            t0 = time.perf_counter_ns()
            self._check_signature()
            if self.impl.source == "cuda" and self.device.type == "cuda":
                from repro_torch.kernels import native

                native.build_all()
            self._synthesized = functools.partial(self.impl.fn, **self.static_kwargs)
            self.synthesis_s = (time.perf_counter_ns() - t0) * 1e-9
        return self.synthesis_s or 0.0

    def _warmup_args(self) -> list[torch.Tensor]:
        return [torch.zeros(a.shape, dtype=a.dtype, device=self.device)
                for a in self.abstract_args]

    def load(self) -> Callable[..., Any]:
        """Put the role on the card: bind a fixed weight there, launch once
        at the role's shapes and wait for it.  Returns the executable."""
        if self._executable is None:
            if self._synthesized is None:
                # online synthesis at dispatch time (the flexible OpenCL path)
                self.synthesize()
            t0 = time.perf_counter_ns()
            fn = self.impl.fn
            if self.impl.specialization == FIXED_WEIGHT and hasattr(fn, "bind"):
                exe = functools.partial(fn.bind(self.device), **self.static_kwargs)
            else:
                exe = self._synthesized
            exe(*self._warmup_args())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._executable = exe
            self.load_count += 1
            self.load_s = (time.perf_counter_ns() - t0) * 1e-9
        return self._executable

    def unload(self) -> None:
        """Eviction: free the region (a bound weight leaves the card). The
        synthesized artifact (bitstream) survives."""
        self._executable = None

    @property
    def resident(self) -> bool:
        return self._executable is not None

    def resident_bytes(self) -> int:
        """Device bytes the loaded role holds (a fixed weight), 0 unloaded."""
        if self._executable is None:
            return 0
        w = getattr(getattr(self._executable, "func", None), "weight", None)
        return w.numel() * w.element_size() if isinstance(w, torch.Tensor) else 0

    # -- execution ------------------------------------------------------------

    def __call__(self, *args: Any) -> Any:
        exe = self.load()
        return exe(*args)

    # -- reporting (paper Table I analogue) ------------------------------------

    def footprint(self) -> dict[str, float]:
        arg_bytes = sum(
            math.prod(a.shape) * torch.empty((), dtype=a.dtype).element_size()
            for a in self.abstract_args
        )
        fp = self.impl.footprint
        return {
            "arg_bytes": float(arg_bytes),
            "smem_bytes": float(fp.smem_bytes),
            "smem_pct": 100.0 * fp.smem_fraction(),
            "threads": float(fp.threads),
            "resident_bytes": float(self.resident_bytes()),
        }


class RoleLibrary:
    """All roles known to the runtime; the paper's registered-bitstream store."""

    def __init__(self, ledger: OverheadLedger = GLOBAL_LEDGER) -> None:
        self._roles: dict[RoleKey, Role] = {}
        self.ledger = ledger

    def add(self, role: Role) -> Role:
        if role.key in self._roles:
            return self._roles[role.key]
        self._roles[role.key] = role
        return role

    def make_role(
        self,
        impl: KernelImpl,
        abstract_args: Sequence["ArgSpec | torch.Tensor"],
        **kw: Any,
    ) -> Role:
        return self.add(Role(impl, abstract_args, **kw))

    def get(self, key: RoleKey) -> Role:
        return self._roles[key]

    def __len__(self) -> int:
        return len(self._roles)

    def __iter__(self):
        return iter(self._roles.values())

    def synthesize_all(self) -> float:
        """Presynthesize every presynthesized-source role (device/kernel setup).

        Recorded under the ledger's SETUP category — the paper's one-time cost.
        """
        total = 0.0
        with self.ledger.timed(ledger_mod.SETUP, what="synthesize_all", n=len(self._roles)):
            for role in self._roles.values():
                if role.source == PRESYNTHESIZED:
                    total += role.synthesize()
        return total
