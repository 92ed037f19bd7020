"""Kernels: torch oracles (ref), torch eager sources and hand-written Hopper
kernels, all registered by :mod:`repro_torch.kernels.ops`."""

from repro_torch.kernels import ops  # noqa: F401  (registry population)
