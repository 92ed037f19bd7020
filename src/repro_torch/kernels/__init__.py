"""Kernels: torch oracles (ref), torch eager sources and hand-written Hopper
kernels, all registered by :mod:`repro_torch.kernels.ops`."""

import importlib

from repro_torch.kernels import ops  # noqa: F401  (registry population)

#: the modules that launch the hand-written kernels, each counting its
#: launches in module-level ``*launches`` counters (``native.count_launch``)
MODULES = ("matmul", "rmsnorm", "flash_attention", "decode_attention",
           "paged_decode_attention", "ssd", "conv2d", "sample")


def modules() -> list:
    """The modules of :data:`MODULES`, imported."""
    return [importlib.import_module(f"repro_torch.kernels.{name}") for name in MODULES]


def launch_counters() -> dict[tuple[str, str], int]:
    """Every kernel launch counter: ``(module name, counter) -> count``, the
    module named as :data:`MODULES` names it."""
    return {(mod.__name__.rsplit(".", 1)[1], attr): val for mod in modules()
            for attr, val in vars(mod).items()
            if attr.endswith("launches") and isinstance(val, int)}
