"""Parameter descriptors and their initialisation.

Models declare their parameters as trees (nested dicts and lists) of
:class:`ParamSpec` — shape, dtype and init law.  :func:`init_params` makes
concrete tensors from one seeded ``torch.Generator`` with the JAX package's
laws (normal·scale drawn in f32 then cast, ones for norms); the draws differ
from ``jax.random``'s, so parity tests carry the JAX package's parameters
across with :func:`params_from_jax` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones | ssm_a
    scale: float = 0.02


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on.  A CUDA device must exist: the
    port never carries on silently on the CPU — the CPU is only ever what a
    caller asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
        return (x * spec.scale).to(spec.dtype)
    if spec.init == "ssm_a":
        # a_log of the SSD decay: -uniform(1, 16), stored negative
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=device)
        return -(1.0 + 15.0 * u).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def _with_unembed_copy(params: dict) -> dict:
    """Tied embeddings: keep one f32 copy of the table for the f32 unembed
    product, instead of casting 128256 x 2048 values on every step."""
    embed = params["embed"]
    if "unembed" not in embed:
        embed["tok_f32"] = embed["tok"].float()
    return params


def init_params(specs: Any, seed: int = 0, *, device: "str | torch.device" = "cuda") -> Any:
    """Concrete parameters for a spec tree, drawn in leaf order from one
    generator seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _with_unembed_copy(tree_map(lambda s: _init_leaf(s, gen, device), specs))


def params_from_jax(tree: dict, *, device: "str | torch.device" = "cuda") -> dict:
    """The port's parameters from the JAX ``DecoderLM``'s, given as a tree of
    numpy arrays (``jax.tree.map(np.asarray, params)``).

    JAX stacks a segment's layers as ``[L, ...]`` under
    ``tree["segments"][0]["0"]``; the port keeps one dict per layer.  Values
    travel through float32 (exact for bf16; ``torch.from_numpy`` rejects
    numpy's bf16) and are cast back to their dtype on the torch side, so a
    Mamba-2 layer's ``mamba`` sub-tree keeps ``a_log``, ``skip_d`` and
    ``dt_bias`` in f32 and the rest in bf16.
    """
    device = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        dtype = getattr(torch, str(a.dtype))
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)

    segments = tree["segments"]
    if len(segments) != 1 or set(segments[0]) != {"0"}:
        raise ValueError("params_from_jax takes a dense or SSM model: one segment of one "
                         "layer kind")
    stacked = tree_map(leaf, segments[0]["0"])
    layers = [tree_map(lambda t: t[i], stacked) for i in range(stacked["ln1"].shape[0])]
    return _with_unembed_copy({
        "embed": tree_map(leaf, tree["embed"]),
        "layers": layers,
        "ln_f": leaf(tree["ln_f"]),
    })
