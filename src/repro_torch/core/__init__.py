"""repro_torch.core — the paper's contribution: transparent accelerator dispatch.

Public surface:

  - ``dispatch.op(name, *args)`` / ``dispatch.use(...)`` — transparent op
    dispatch with scoped policy (the TF-frontend property),
  - ``registry`` — kernel registration (reference / torch / triton / cuda
    sources),
  - ``hsa`` — agents, queues, signals, executor (the HSA runtime),
  - ``roles`` / ``reconfig`` — presynthesized programs + LRU region residency
    (the partial-reconfiguration model),
  - ``ledger`` — Table II overhead accounting,
  - ``policy`` — the generic-vs-fixed-weight role planner.
"""

from repro_torch.core import dispatch, ledger, policy, reconfig, registry, roles
from repro_torch.core.dispatch import DispatchContext, DispatchTrace, op, use
from repro_torch.core.ledger import GLOBAL_LEDGER, OverheadLedger
from repro_torch.core.reconfig import RegionManager, ResidencyResult, ResidencyStats
from repro_torch.core.registry import (
    FIXED_WEIGHT,
    GENERIC,
    GLOBAL_REGISTRY,
    KernelImpl,
    KernelRegistry,
    ResourceFootprint,
)
from repro_torch.core.roles import ONLINE, PRESYNTHESIZED, Role, RoleKey, RoleLibrary

__all__ = [
    "dispatch",
    "ledger",
    "policy",
    "reconfig",
    "registry",
    "roles",
    "DispatchContext",
    "DispatchTrace",
    "op",
    "use",
    "GLOBAL_LEDGER",
    "OverheadLedger",
    "RegionManager",
    "ResidencyResult",
    "ResidencyStats",
    "FIXED_WEIGHT",
    "GENERIC",
    "GLOBAL_REGISTRY",
    "KernelImpl",
    "KernelRegistry",
    "ResourceFootprint",
    "ONLINE",
    "PRESYNTHESIZED",
    "Role",
    "RoleKey",
    "RoleLibrary",
]
